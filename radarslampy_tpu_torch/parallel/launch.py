"""Multi-process launcher of the distributed back-end on torch.distributed.

Counterpart of `radarslampy_tpu/parallel/launch.py`.  One process (rank) per
device:

  worker  -- `python -m radarslampy_tpu_torch.parallel.launch --coordinator
             H:P --nproc N --proc-id I [--cpu]`
             joins the process group (NCCL on the card; gloo with --cpu)
             through a TCP store at H:P (rank 0 hosts it) or, for a
             coordinator `file:///path`, a file store; builds the ``kf`` mesh
             over all N ranks and runs the scaling benches, or with --smoke
             one all-reduce; rank 0 prints and writes the JSON result.

  spawner -- `python -m radarslampy_tpu_torch.parallel.launch --spawn N`
             starts N workers on this host and forwards rank 0's output.
             A worker that fails stops the others.

  curve   -- `--curve 1,2,4` runs the benches at each process count and
             writes one merged artifact.

A rank owns one device, so the JAX launcher's `--local-devices` has no
counterpart and is not accepted.  On one card a world has one rank: NCCL
takes one rank per GPU.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.models.frontend import MapState, build_frame_maps
from radarslampy_tpu_torch.models.posegraph import PoseGraph
from radarslampy_tpu_torch.parallel import batch_odometry
from radarslampy_tpu_torch.parallel.dist_posegraph import optimize_pose_graph_sharded
from radarslampy_tpu_torch.parallel.dist_verify import verify_candidates_sharded
from radarslampy_tpu_torch.parallel.mesh import (KF_AXIS, axis_size, make_mesh, mesh_device,
                                                 psum, shard_along)
from radarslampy_tpu_torch.sim import fakedata

# A collective that waits longer than this raises instead of hanging.
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=600)


def backend(cpu: bool = False) -> str:
    """The process group's backend: NCCL on the card, gloo with --cpu."""
    return "gloo" if cpu else "nccl"


def initialize(coordinator: str, nproc: int, proc_id: int, cpu: bool = False) -> str:
    """Join the process group as rank `proc_id` of `nproc`; returns the
    device the rank runs on ("cuda" or "cpu").  Without a card it raises
    unless `cpu`."""
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the launcher runs NCCL on the card; pass --cpu "
                               "(cpu=True) for gloo on the CPU")
        torch.cuda.set_device(proc_id % torch.cuda.device_count())
    init = coordinator if coordinator.startswith("file://") else f"tcp://{coordinator}"
    dist.init_process_group(backend(cpu), init_method=init, world_size=nproc, rank=proc_id,
                            timeout=COLLECTIVE_TIMEOUT)
    return "cpu" if cpu else "cuda"


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, reps: int, device):
    """fn() once to warm up, then `reps` timed calls, each ending in a
    device synchronisation -> (wall seconds per call, the last result)."""
    out = fn()
    _sync(device)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        times.append(time.perf_counter() - t0)
    return times, out


def bench_verify_mp(mesh, n_cands: int = 768, reps: int = 10):
    """Loop-verify fan-out: `n_cands` multi-start ICP verifications split over
    the mesh (`dist_verify`) on a synthetic looped map -> (per-rep wall
    seconds, verifications per rep)."""
    dev = mesh_device(mesh)
    cfg = SlamConfig()
    rng = np.random.default_rng(0)
    M_cap, K, M = 256, 64, 240

    # synthetic looped map: keyframes around a circle, shared world landmarks
    th = np.linspace(0, 4 * np.pi, M)
    poses = np.stack([60 * np.cos(th), 60 * np.sin(th), th], 1).astype(np.float32)
    world = rng.uniform(-90, 90, (3000, 2)).astype(np.float32)
    d2 = ((world[None, :, :] - poses[:, None, :2]) ** 2).sum(-1)
    near = np.argsort(d2, axis=1)[:, : K // 2]
    pts = world[near] - poses[:, None, :2]
    c, s = np.cos(poses[:, 2]), np.sin(poses[:, 2])
    feat_local = np.zeros((M_cap, K, 2), np.float32)
    feat_local[:M, : K // 2, 0] = c[:, None] * pts[..., 0] + s[:, None] * pts[..., 1]
    feat_local[:M, : K // 2, 1] = -s[:, None] * pts[..., 0] + c[:, None] * pts[..., 1]
    feat_mask = np.zeros((M_cap, K), bool)
    feat_mask[:M, : K // 2] = True

    def t(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    ms = MapState(poses=t(np.pad(poses, ((0, M_cap - M), (0, 0)))),
                  feat_world=t(np.zeros((M_cap, K, 2), np.float32)), feat_local=t(feat_local),
                  feat_ids=t(np.full((M_cap, K), -1, np.int32)), feat_mask=t(feat_mask),
                  velocities=t(np.zeros((M_cap, 3), np.float32)), cursor=t(M, torch.int32),
                  descriptors=t(np.zeros((M_cap, 16, 80), np.float32)),
                  pc_local=t(np.zeros((M_cap, 8, 2), np.float32)),
                  pc_mask=t(np.zeros((M_cap, 8), bool)),
                  frame_ids=t(np.full(M_cap, -1, np.int32)))
    D = axis_size(mesh)
    C = -(-n_cands // D) * D
    ci = rng.integers(0, M - 60, C)
    cj = ci + rng.integers(20, 60, C)
    args = (t(ci), t(cj), t(np.ones(C, bool)), t(np.full(C, np.nan, np.float32)))
    times, _ = _timed(lambda: verify_candidates_sharded(ms, *args, cfg, mesh), reps, dev)
    return times, C


def _ring_graph(M: int, dev):
    """The bench's pose graph: a 2-turn ring of M poses at radius 100 m, one
    odometry edge per pose (the last closing the ring), 0.01 noise."""
    rng = np.random.default_rng(0)
    th = np.linspace(0, 4 * np.pi, M)
    gt = np.stack([100 * np.cos(th), 100 * np.sin(th), th], axis=1)
    ij = np.stack([np.arange(M), (np.arange(M) + 1) % M], axis=1)

    def rel(a, b):
        c, s = np.cos(a[2]), np.sin(a[2])
        d = b[:2] - a[:2]
        return [c * d[0] + s * d[1], -s * d[0] + c * d[1],
                (b[2] - a[2] + np.pi) % (2 * np.pi) - np.pi]

    meas = np.asarray([rel(gt[i], gt[j]) for i, j in ij], np.float32)
    meas += rng.normal(0, 0.01, meas.shape).astype(np.float32)
    return PoseGraph(poses=torch.as_tensor(gt, dtype=torch.float32, device=dev),
                     node_mask=torch.ones(M, dtype=torch.bool, device=dev),
                     edges_ij=torch.as_tensor(ij, device=dev),
                     edges_meas=torch.as_tensor(meas, device=dev),
                     edges_info=torch.ones((M, 3), device=dev),
                     edge_mask=torch.ones(M, dtype=torch.bool, device=dev))


def bench_posegraph_mp(mesh, M: int = 2048, iters: int = 5, method: str = "gather",
                       reps: int = 5):
    """Distributed pose-graph solve of the ring graph (`dist_posegraph`,
    "gather": one all-gather per solve, "pcg": one [M, 3] all-reduce per CG
    sweep) -> (per-rep wall seconds, final cost)."""
    dev = mesh_device(mesh)
    cfg = SlamConfig(pg_iterations=iters, pg_cg_iterations=256)
    g = _ring_graph(M, dev)
    times, (_, cost) = _timed(lambda: optimize_pose_graph_sharded(g, cfg, mesh, method=method),
                              reps, dev)
    return times, float(cost)


def bench_odometry_mp(mesh, frames_per_seg: int = 6, reps: int = 5):
    """Data-parallel segment odometry (`batch_odometry`), one segment per rank
    at a 512 px config -> (per-rep wall seconds, frames stepped per rep)."""
    dev = mesh_device(mesh)
    cfg = SlamConfig(cart_size=512, cart_downsample=8, n_candidates=256, anms_top_k=100,
                     k_max=128, mds_iterations=4, max_keyframes=64)
    maps = build_frame_maps(cfg, dev)
    rng = np.random.default_rng(0)
    world_pts, refl = fakedata.make_world(rng, 1200, 300.0)
    B, T = axis_size(mesh), frames_per_seg
    scans = np.zeros((B, T, cfg.num_azimuths, cfg.polar_width_padded), np.float32)
    for b in range(B):
        for k in range(T):
            pose = np.array([40.0 * b + 2.0 * k, 0.0, 0.01 * k])
            scans[b, k] = fakedata.render_polar_scan(world_pts, refl, pose, cfg, rng=rng,
                                                     noise=0.02)
    frames = torch.as_tensor(scans, device=dev)
    times, _ = _timed(lambda: batch_odometry.run_segments(frames, maps, cfg, mesh), reps, dev)
    return times, B * (T - 1)


def _stats(times):
    """median / min / max of a rep-time list (seconds, rounded)."""
    t = np.asarray(times, np.float64)
    return {"median_s": round(float(np.median(t)), 4), "min_s": round(float(t.min()), 4),
            "max_s": round(float(t.max()), 4), "reps": len(times)}


def _device_name(device: str) -> str:
    return torch.cuda.get_device_name(torch.cuda.current_device()) if device == "cuda" else "cpu"


def worker(a) -> dict | None:
    """One rank: join the group, build the ``kf`` mesh over every rank, run
    the smoke all-reduce or the benches; rank 0 prints (and with --out
    writes) the JSON result and returns it."""
    if a.pin:
        # one core per rank: the N-process curve then measures the code's
        # scaling, not the oversubscription of the host's cores
        os.sched_setaffinity(0, {a.proc_id % (os.cpu_count() or 1)})
        torch.set_num_threads(1)
    device = initialize(a.coordinator, a.nproc, a.proc_id, cpu=a.cpu)
    try:
        mesh = make_mesh(axis=KF_AXIS, device=device)
        res = {"mode": "multiprocess", "num_processes": a.nproc,
               "global_devices": dist.get_world_size(),
               "collectives": backend(a.cpu), "device": _device_name(device)}
        if a.smoke:
            # cross-process sum: one global [world] vector of ones, split over the ranks
            ones = torch.ones(dist.get_world_size(), device=device)
            res["psum"] = float(psum(shard_along(ones, mesh).sum(), mesh))
        else:
            times, n_ver = bench_verify_mp(mesh)
            res["verify"] = _stats(times)
            res["verify_n_per_rep"] = n_ver
            res["verify_per_s_median"] = round(n_ver / np.median(times), 2)
            times, cost = bench_posegraph_mp(mesh, method="gather")
            res["posegraph_gather"] = _stats(times)
            res["posegraph_cost"] = round(cost, 4)
            times, _ = bench_posegraph_mp(mesh, method="pcg")
            res["posegraph_pcg"] = _stats(times)
            times, frames = bench_odometry_mp(mesh)
            res["odometry"] = _stats(times)
            res["odometry_frames_per_rep"] = frames
            res["odometry_fps_median"] = round(frames / np.median(times), 2)
    finally:
        dist.destroy_process_group()
    if a.proc_id != 0:
        return None
    print(json.dumps(res), flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(res, f, indent=2)
    return res


def spawn(a) -> int:
    """Start a.spawn workers of this module on this host and forward rank
    0's output; returns the largest exit code.  A worker that exits with an
    error stops the rest, which would otherwise wait in a collective."""
    procs = []
    for i in range(a.spawn):
        cmd = [sys.executable, "-m", "radarslampy_tpu_torch.parallel.launch",
               "--coordinator", a.coordinator, "--nproc", str(a.spawn), "--proc-id", str(i)]
        cmd += [f for f, on in (("--smoke", a.smoke), ("--pin", a.pin), ("--cpu", a.cpu)) if on]
        if a.out and i == 0:
            cmd += ["--out", a.out]
        out = subprocess.PIPE if i == 0 else subprocess.DEVNULL
        procs.append(subprocess.Popen(cmd, stdout=out))
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    out0 = procs[0].stdout.read()
    rcs = [p.wait() for p in procs]
    sys.stdout.write(out0.decode())
    return max(rcs)


def curve(a) -> int:
    """The benches at each process count of a.curve, one merged artifact.
    All ranks share this host's cores, so on one host the curve checks the
    multi-process mechanics more than it measures speed-up."""
    counts = [int(x) for x in a.curve.split(",")]
    runs = {}
    for k, n in enumerate(counts):
        if a.coordinator.startswith("file://"):
            coord = f"{a.coordinator}.{n}"
        else:
            host, port = a.coordinator.rsplit(":", 1)
            coord = f"{host}:{int(port) + 1 + k}"
        with tempfile.NamedTemporaryFile(suffix=".json") as tf:
            rc = spawn(argparse.Namespace(spawn=n, coordinator=coord, out=tf.name, smoke=False,
                                          pin=a.pin, cpu=a.cpu))
            if rc != 0:
                print(f"nproc={n} failed rc={rc}", file=sys.stderr)
                return rc
            with open(tf.name) as f:
                runs[str(n)] = json.load(f)
    v0 = runs[str(counts[0])]["verify_per_s_median"]
    merged = {
        "benchmark": "multi-process scaling (torch.distributed, "
                     f"{backend(a.cpu)} collectives)",
        "physical_cores": os.cpu_count(),
        "runs": runs,
        "verify_per_s_median": {k: r["verify_per_s_median"] for k, r in runs.items()},
        "verify_scaling_efficiency": {
            str(n): round(runs[str(n)]["verify_per_s_median"] / (v0 * n / counts[0]), 3)
            for n in counts},
        "posegraph_gather_wall": {k: r["posegraph_gather"] for k, r in runs.items()},
        "posegraph_pcg_wall": {k: r["posegraph_pcg"] for k, r in runs.items()},
        "odometry_fps_median": {k: r["odometry_fps_median"] for k, r in runs.items()},
    }
    print(json.dumps(merged, indent=2))
    if a.out:
        with open(a.out, "w") as f:
            json.dump(merged, f, indent=2)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--coordinator", default="localhost:12377",
                    help="host:port of rank 0's TCP store, or file:///path of a file store")
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--proc-id", type=int, default=None)
    ap.add_argument("--spawn", type=int, default=0,
                    help="start N local worker processes and forward rank 0's output")
    ap.add_argument("--curve", default=None,
                    help="comma-separated process counts; runs each and writes one merged "
                         "artifact")
    ap.add_argument("--smoke", action="store_true", help="one cross-process all-reduce only")
    ap.add_argument("--pin", action="store_true",
                    help="pin each worker to one core, one intra-op thread")
    ap.add_argument("--cpu", action="store_true", help="gloo on the CPU instead of NCCL")
    ap.add_argument("--out", default=None, help="JSON artifact (rank 0)")
    a = ap.parse_args(argv)
    if a.curve:
        return curve(a)
    if a.spawn:
        return spawn(a)
    if a.proc_id is None:
        ap.error("--proc-id is required in worker mode")
    worker(a)
    return 0


if __name__ == "__main__":
    sys.exit(main())
