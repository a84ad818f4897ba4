"""Rank side of the port's multi-process tests, and the spawner that runs them.

The tests in `tests/test_torch_{parallel,dist_ba,batch_odometry,
sharded_cg_graph,dense_lm_graph}.py` compute their JAX references in the test process and
hand the inputs to real processes, one per rank, that join a gloo group on a
file store in the test's temporary directory (never a TCP port: the suite
runs several pytest workers at once).  `tests/test_torch_cuda.py` runs its
ranks on NCCL, one card each.  This module imports no JAX, so neither do the
ranks:

    python tests/torch_dist_ranks.py <check> <world> <rank> <workdir> [gloo|nccl]

Each rank reads `<workdir>/inputs.pt`, builds the meshes named in `MESHES`
that fit the world, runs `<check>` on every mesh it belongs to, and writes
`<workdir>/out<rank>.pt`.  `spawn` starts the ranks, gives them one time limit
together and kills any rank left when it runs out or when a rank fails.  It
starts the ranks by this file's path, not as `tests.torch_dist_ranks`: on a
machine with another package named `tests` installed, that name does not
reach this directory.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

# mesh name -> ranks: the whole world of 4 (even blocks where the sizes
# allow), the first 3 ranks (uneven padding), the first rank alone (a real
# group of one, which must give the single-device bits), 2 ranks
MESHES = {"w4": 4, "w3": 3, "w2": 2, "w1": 1}


def spawn(check: str, world: int, workdir: Path, inputs: dict, timeout: float,
          backend: str = "gloo") -> list:
    """Run `check` in `world` rank processes on `inputs` -> each rank's
    output dict, in rank order.  `backend` "nccl" puts rank r on card r.
    Raises if a rank fails or the time runs out; no rank outlives the call."""
    workdir = Path(workdir)
    torch.save(inputs, workdir / "inputs.pt")
    path = os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, PYTHONPATH=path)
    logs = [open(workdir / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), check, str(world),
                               str(r), str(workdir), backend], cwd=ROOT, env=env,
                              stdout=logs[r],
                              stderr=subprocess.STDOUT)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"{check}: ranks still running after {timeout} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        tail = (workdir / f"rank{bad[0]}.log").read_text()[-3000:]
        raise RuntimeError(f"{check}: rank {bad[0]} exited {procs[bad[0]].returncode}:\n{tail}")
    return [torch.load(workdir / f"out{r}.pt", weights_only=False) for r in range(world)]


def _pg_graph(inp):
    from radarslampy_tpu_torch.models.posegraph import PoseGraph

    return PoseGraph(*inp["ring"])


def check_parallel(inp, mesh):
    """The sharded pose graph in every method, the sharded map queries and
    the sharded verification on `mesh`."""
    from radarslampy_tpu_torch.config import SlamConfig
    from radarslampy_tpu_torch.models.frontend import MapState
    from radarslampy_tpu_torch.parallel import dist_posegraph, dist_verify, sharded_map
    from radarslampy_tpu_torch.parallel.mesh import (all_gather, axis_index, axis_size, pmax,
                                                     psum, shard_along)

    me = axis_index(mesh)
    r = torch.tensor(float(me + 1))
    out = {"collectives": (psum(r, mesh), pmax(r, mesh),
                           all_gather(torch.tensor([me % 2 == 0]), mesh),
                           shard_along(torch.arange(10), mesh))}
    cfg = SlamConfig(**inp["pg_cfg"])
    g = _pg_graph(inp)
    v = torch.linspace(-1.0, 1.0, g.poses.numel()).reshape(-1, 3)
    out["hvp"] = dist_posegraph.hvp_distributed(g.poses, dist_posegraph._local_edges(g, mesh), v,
                                                1.0, mesh)
    for method in ("dense", "pcg", "gather", "auto"):
        stats = {}
        poses, cost = dist_posegraph.optimize_pose_graph_sharded(g, cfg, mesh, method, stats)
        out[f"pg_{method}"] = (poses, cost, stats["cg_sweeps"])
    toy = sharded_map.shard_map_state(MapState(*inp["toy"]), mesh)
    out["nearest"] = sharded_map.nearest_keyframes(toy, inp["query"], 5, mesh)
    out["nearest_excl"] = sharded_map.nearest_keyframes(toy, inp["query"], 5, mesh,
                                                        exclude_after=20)
    out["points"] = sharded_map.global_map_points(toy, mesh)
    app = MapState(*inp["app"])
    out["appearance"] = tuple(sharded_map.appearance_candidates_sharded(
        app, mesh, max_candidates=6, min_index_gap=10))
    loop = MapState(*inp["loop"])
    vcfg = SlamConfig(**inp["verify_cfg"])
    for name in ("cand", "app_cand"):
        c = dist_verify.pad_candidates(*inp[name], axis_size(mesh))
        out[f"verify_{name}"] = tuple(dist_verify.verify_candidates_sharded(
            loop if name == "cand" else app, *c, vcfg, mesh))
    return out


def check_dist_ba(inp, mesh):
    """The landmark-sharded BA, dense and PCG, on each problem of `inp`."""
    from radarslampy_tpu_torch.config import SlamConfig
    from radarslampy_tpu_torch.models.ba import BAProblem
    from radarslampy_tpu_torch.parallel.dist_ba import optimize_ba_sharded

    cfg = SlamConfig(**inp["cfg"])
    out = {}
    for name, p in inp["problems"].items():
        for method in ("dense", "pcg"):
            stats = {}
            out[f"{name}_{method}"] = (*optimize_ba_sharded(BAProblem(*p), cfg, mesh,
                                                            method=method, stats=stats),
                                       stats["cg_sweeps"])
    return out


def check_batch_odometry(inp, mesh):
    """`run_segments` over the segments of `inp` on `mesh`, and the poses of
    this rank's segments stepped by `make_batched_init` / `make_batched_step`."""
    from radarslampy_tpu_torch.config import SlamConfig
    from radarslampy_tpu_torch.models.frontend import build_frame_maps
    from radarslampy_tpu_torch.parallel.batch_odometry import (make_batched_init,
                                                               make_batched_step, run_segments)

    cfg = SlamConfig(**inp["cfg"])
    maps = build_frame_maps(cfg, "cpu")
    frames = inp["frames"]
    step = make_batched_step(cfg, mesh)
    states = make_batched_init(cfg, mesh)(frames[:, 0], maps)
    poses = [states.pose]
    for t in range(1, frames.shape[1]):
        states, out = step(states, frames[:, t], maps)
        poses.append(out.pose)
    return {"poses": run_segments(frames, maps, cfg, mesh),
            "block_poses": torch.stack(poses, dim=1)}


def _sharded_pcg(g, p, cfg, mesh, replay=True, **kw):
    """The sharded PCG pose graph and BA as their entry points run them
    (this rank's edge or landmark block, the mesh's hooks), with the solvers'
    own keywords -> ((poses, cost, stats), (poses, landmarks, cost, stats))."""
    from radarslampy_tpu_torch.models import ba, posegraph
    from radarslampy_tpu_torch.parallel import dist_ba, dist_posegraph
    from radarslampy_tpu_torch.parallel.mesh import all_gather, pmax, psum

    def red(x):
        return psum(x, mesh)

    st_pg, st_ba = {}, {}
    pg = posegraph._optimize_pose_graph_pcg(dist_posegraph._local_edges(g, mesh), cfg,
                                            stats=st_pg, reduce_fn=red,
                                            reduce_max_fn=lambda x: pmax(x, mesh),
                                            replay=replay, **kw)
    poses, lms, cost = ba._optimize_ba_pcg(dist_ba._local_problem(p, mesh), cfg, stats=st_ba,
                                           reduce_fn=red, replay=replay, **kw)
    return (*pg, st_pg), (poses, all_gather(lms, mesh), cost, st_ba)


def _forbidding(sweeps, seen):
    """`sweeps` (`posegraph.cg_sweeps`) run under `Forbid(SYNC_OPS +
    HOST_DATA_OPS)`, which fails on a host read; `seen` counts the ops it
    lets through and, under "sweeps", the sweeps run."""
    from tests.torch_host_reads import HOST_DATA_OPS, SYNC_OPS, Forbid

    class Counting(Forbid):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen[str(func)] += 1
            return super().__torch_dispatch__(func, types, args, kwargs)

    def wrapped(afun, pinv, state, rz0, n_cg, count):
        seen["sweeps"] += count
        with Counting(SYNC_OPS + HOST_DATA_OPS):
            return sweeps(afun, pinv, state, rz0, n_cg, count)

    return wrapped


def check_sharded_cg(inp, mesh):
    """The sharded PCG pose graph and BA at each `sweeps_per_check` of
    `inp["cadences"]` and through their entry points; on a mesh of 2, the
    solves again with the sweep body (`posegraph.cg_sweeps`) run under
    `Forbid(SYNC_OPS + HOST_DATA_OPS)`."""
    from radarslampy_tpu_torch.config import SlamConfig
    from radarslampy_tpu_torch.models import posegraph
    from radarslampy_tpu_torch.models.ba import BAProblem
    from radarslampy_tpu_torch.parallel.dist_ba import optimize_ba_sharded
    from radarslampy_tpu_torch.parallel.dist_posegraph import optimize_pose_graph_sharded
    from radarslampy_tpu_torch.parallel.mesh import axis_size

    cfg = SlamConfig(**inp["cfg"])
    g, p = _pg_graph(inp), BAProblem(*inp["ba"])
    out = {}
    for spc in inp["cadences"]:
        out["pg", spc], out["ba", spc] = _sharded_pcg(g, p, cfg, mesh, sweeps_per_check=spc)
    st_pg, st_ba = {}, {}
    out["pg", "entry"] = (*optimize_pose_graph_sharded(g, cfg, mesh, "pcg", st_pg), st_pg)
    out["ba", "entry"] = (*optimize_ba_sharded(p, cfg, mesh, method="pcg", stats=st_ba), st_ba)
    if axis_size(mesh) == 2:
        seen, sweeps = collections.Counter(), posegraph.cg_sweeps
        posegraph.cg_sweeps = _forbidding(sweeps, seen)
        try:  # every rank reads the same values, so all fail at the same op
            out["pg", "forbid"], out["ba", "forbid"] = _sharded_pcg(g, p, cfg, mesh)
        except AssertionError as e:
            seen["failed: " + str(e)] += 1
        finally:
            posegraph.cg_sweeps = sweeps
        out["forbid"] = dict(seen)
    return out


def _sharded_dense(g, p, cfg, mesh, replay=True):
    """The sharded dense pose graph and BA through their entry points ->
    ((poses, cost, stats), (poses, landmarks, cost, stats))."""
    from radarslampy_tpu_torch.parallel.dist_ba import optimize_ba_sharded
    from radarslampy_tpu_torch.parallel.dist_posegraph import optimize_pose_graph_sharded

    st_pg, st_ba = {}, {}
    pg = optimize_pose_graph_sharded(g, cfg, mesh, "dense", st_pg, replay)
    ba = optimize_ba_sharded(p, cfg, mesh, method="dense", stats=st_ba, replay=replay)
    return (*pg, st_pg), (*ba, st_ba)


def _forbidding_body(body, seen, name):
    """The LM body `body` run under `Forbid(SYNC_OPS + HOST_DATA_OPS)`;
    `seen` counts, under (name, op), the ops it lets through and, under
    (name, "bodies"), the calls."""
    from tests.torch_host_reads import HOST_DATA_OPS, SYNC_OPS, Forbid

    class Counting(Forbid):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen[name, str(func)] += 1
            return super().__torch_dispatch__(func, types, args, kwargs)

    def wrapped(*args, **kwargs):
        seen[name, "bodies"] += 1
        with Counting(SYNC_OPS + HOST_DATA_OPS):
            return body(*args, **kwargs)

    return wrapped


def check_dense_lm(inp, mesh):
    """The sharded dense pose graph and BA through their entry points, and
    as the loops before their iteration became a captured body
    (`tests/torch_dense_lm_reference.py`) with the mesh's hooks; on a mesh of
    2, the entry points again with each LM body (`posegraph.pose_graph_lm_step`,
    `ba.ba_lm_step`) run under `Forbid(SYNC_OPS + HOST_DATA_OPS)`."""
    from radarslampy_tpu_torch.config import SlamConfig
    from radarslampy_tpu_torch.models import ba, posegraph
    from radarslampy_tpu_torch.parallel import dist_ba, dist_posegraph
    from radarslampy_tpu_torch.parallel.mesh import all_gather, axis_size, pmax, psum
    from tests import torch_dense_lm_reference as ref

    cfg = SlamConfig(**inp["cfg"])
    g, p = _pg_graph(inp), ba.BAProblem(*inp["ba"])
    out = {}
    out["pg", "entry"], out["ba", "entry"] = _sharded_dense(g, p, cfg, mesh)

    def red(x):
        return psum(x, mesh)

    out["pg", "loop"] = ref.pose_graph_dense(dist_posegraph._local_edges(g, mesh), cfg, red,
                                             lambda x: pmax(x, mesh))
    poses, lms, cost = ref.ba_dense(dist_ba._local_problem(p, mesh), cfg, 8, red)
    out["ba", "loop"] = (poses, all_gather(lms, mesh), cost)
    if axis_size(mesh) == 2:
        seen = collections.Counter()
        bodies = posegraph.pose_graph_lm_step, ba.ba_lm_step
        posegraph.pose_graph_lm_step = _forbidding_body(bodies[0], seen, "pg")
        ba.ba_lm_step = _forbidding_body(bodies[1], seen, "ba")
        try:  # every rank reads the same values, so all fail at the same op
            out["pg", "forbid"], out["ba", "forbid"] = _sharded_dense(g, p, cfg, mesh)
        except AssertionError as e:
            seen["failed", str(e)] += 1
        finally:
            posegraph.pose_graph_lm_step, ba.ba_lm_step = bodies
        out["forbid"] = dict(seen)
    return out


def _on(dev, tup):
    return tuple(t.to(dev) for t in tup)


def _cpu(x):
    """`x` with every tensor in its tuples, lists and dicts moved to the CPU."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_cpu(v) for v in x)
    return x


def check_sharded_cg_card(inp, mesh):
    """On the card: the sharded PCG pose graph and BA captured (the entry
    points), eager (`replay=False`) and the single-device solves; then one
    LM iteration of each capped at 4 checks' sweeps, under torch.profiler,
    captured and eager (`utils/profiling.collective_trace`)."""
    from torch.profiler import ProfilerActivity, profile

    from radarslampy_tpu_torch.config import SlamConfig
    from radarslampy_tpu_torch.models.ba import BAProblem, optimize_ba
    from radarslampy_tpu_torch.models.posegraph import (PoseGraph, _sweeps_per_check,
                                                        optimize_pose_graph)
    from radarslampy_tpu_torch.parallel.dist_ba import optimize_ba_sharded
    from radarslampy_tpu_torch.parallel.dist_posegraph import optimize_pose_graph_sharded
    from radarslampy_tpu_torch.parallel.mesh import mesh_device
    from radarslampy_tpu_torch.utils.profiling import collective_trace

    dev = mesh_device(mesh)
    cfg = SlamConfig(**inp["cfg"])
    g, p = PoseGraph(*_on(dev, inp["ring"])), BAProblem(*_on(dev, inp["ba"]))
    out = {}
    st_pg, st_ba = {}, {}
    out["pg", "captured"] = (*optimize_pose_graph_sharded(g, cfg, mesh, "pcg", st_pg), st_pg)
    out["ba", "captured"] = (*optimize_ba_sharded(p, cfg, mesh, method="pcg", stats=st_ba),
                             st_ba)
    out["pg", "eager"], out["ba", "eager"] = _sharded_pcg(g, p, cfg, mesh, replay=False)
    st_pg, st_ba = {}, {}
    out["pg", "single"] = (*optimize_pose_graph(g, cfg, "pcg", st_pg), st_pg)
    out["ba", "single"] = (*optimize_ba(p, cfg, method="pcg", stats=st_ba), st_ba)
    short = dataclasses.replace(cfg, pg_iterations=1,
                                pg_cg_iterations=4 * _sweeps_per_check(cfg, None))
    for replay in (True, False):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pg, ba = _sharded_pcg(g, p, short, mesh, replay=replay)
            torch.cuda.synchronize()
        out["trace", replay] = (collective_trace(prof.events()), pg[2], ba[3])
    return _cpu(out)


def check_dense_lm_card(inp, mesh):
    """On the card: the sharded dense pose graph and BA captured (the entry
    points), eager (`replay=False`) and the single-device solves; then each
    of the two at `inp["trace_iterations"]` LM iterations under
    torch.profiler, captured and eager (`utils/profiling.collective_trace`,
    one window a solver)."""
    from torch.profiler import ProfilerActivity, profile

    from radarslampy_tpu_torch.config import SlamConfig
    from radarslampy_tpu_torch.models.ba import BAProblem, optimize_ba
    from radarslampy_tpu_torch.models.posegraph import PoseGraph, optimize_pose_graph
    from radarslampy_tpu_torch.parallel.dist_ba import optimize_ba_sharded
    from radarslampy_tpu_torch.parallel.dist_posegraph import optimize_pose_graph_sharded
    from radarslampy_tpu_torch.parallel.mesh import mesh_device
    from radarslampy_tpu_torch.utils.profiling import collective_trace

    dev = mesh_device(mesh)
    cfg = SlamConfig(**inp["cfg"])
    g, p = PoseGraph(*_on(dev, inp["ring"])), BAProblem(*_on(dev, inp["ba"]))
    out = {}
    out["pg", "captured"], out["ba", "captured"] = _sharded_dense(g, p, cfg, mesh)
    out["pg", "eager"], out["ba", "eager"] = _sharded_dense(g, p, cfg, mesh, replay=False)
    st_pg, st_ba = {}, {}
    out["pg", "single"] = (*optimize_pose_graph(g, cfg, "dense", st_pg), st_pg)
    out["ba", "single"] = (*optimize_ba(p, cfg, method="dense", stats=st_ba), st_ba)
    short = dataclasses.replace(cfg, pg_iterations=inp["trace_iterations"])
    solves = {"pg": lambda replay, st: optimize_pose_graph_sharded(g, short, mesh, "dense", st,
                                                                   replay),
              "ba": lambda replay, st: optimize_ba_sharded(p, short, mesh, method="dense",
                                                           stats=st, replay=replay)}
    for name, solve in solves.items():
        for replay in (True, False):
            st = {}
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                solve(replay, st)
                torch.cuda.synchronize()
            out["trace", name, replay] = (collective_trace(prof.events()), st)
    return _cpu(out)


CHECKS = {"parallel": check_parallel, "dist_ba": check_dist_ba,
          "batch_odometry": check_batch_odometry, "sharded_cg": check_sharded_cg,
          "sharded_cg_card": check_sharded_cg_card, "dense_lm": check_dense_lm,
          "dense_lm_card": check_dense_lm_card}


def main(check: str, world: int, rank: int, workdir: Path, backend: str = "gloo"):
    from radarslampy_tpu_torch.parallel.launch import initialize
    from radarslampy_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    inp = torch.load(workdir / "inputs.pt", weights_only=False)
    cpu = backend == "gloo"
    initialize(f"file://{workdir}/store", world, rank, cpu=cpu)
    try:
        # every rank builds every mesh (a mesh's groups are made collectively)
        meshes = {name: make_mesh(n, device="cpu" if cpu else "cuda")
                  for name, n in MESHES.items() if n <= world and name in inp["meshes"]}
        out = {name: CHECKS[check](inp, mesh) for name, mesh in meshes.items()
               if mesh.get_coordinate() is not None}
    finally:
        torch.distributed.destroy_process_group()
    torch.save(out, workdir / f"out{rank}.pt")


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]), *sys.argv[5:])
