"""Rank side of the port's multi-process tests, and the spawner that runs them.

The tests in `tests/test_torch_{parallel,dist_ba,batch_odometry}.py` compute
their JAX references in the test process and hand the inputs to real
processes, one per rank, that join a gloo group on a file store in the
test's temporary directory (never a TCP port: the suite runs several pytest
workers at once).  This module imports no JAX, so neither do the ranks:

    python -m tests.torch_dist_ranks <check> <world> <rank> <workdir>

Each rank reads `<workdir>/inputs.pt`, builds the meshes named in `MESHES`
that fit the world, runs `<check>` on every mesh it belongs to, and writes
`<workdir>/out<rank>.pt`.  `spawn` starts the ranks, gives them one time limit
together and kills any rank left when it runs out or when a rank fails.
"""

from __future__ import annotations

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


def spawn(check: str, world: int, workdir: Path, inputs: dict, timeout: float) -> list:
    """Run `check` in `world` rank processes on `inputs` -> each rank's
    output dict, in rank order.  Raises if a rank fails or the time runs out;
    no rank outlives the call."""
    workdir = Path(workdir)
    torch.save(inputs, workdir / "inputs.pt")
    path = os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])
    env = dict(os.environ, PYTHONPATH=path)
    logs = [open(workdir / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_dist_ranks", check, str(world),
                               str(r), str(workdir)], cwd=ROOT, env=env, stdout=logs[r],
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


CHECKS = {"parallel": check_parallel, "dist_ba": check_dist_ba,
          "batch_odometry": check_batch_odometry}


def main(check: str, world: int, rank: int, workdir: Path):
    from radarslampy_tpu_torch.parallel.launch import initialize
    from radarslampy_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    inp = torch.load(workdir / "inputs.pt", weights_only=False)
    initialize(f"file://{workdir}/store", world, rank, cpu=True)
    try:
        # every rank builds every mesh (a mesh's groups are made collectively)
        meshes = {name: make_mesh(n, device="cpu") for name, n in MESHES.items()
                  if n <= world and name in inp["meshes"]}
        out = {name: CHECKS[check](inp, mesh) for name, mesh in meshes.items()
               if mesh.get_coordinate() is not None}
    finally:
        torch.distributed.destroy_process_group()
    torch.save(out, workdir / f"out{rank}.pt")


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
