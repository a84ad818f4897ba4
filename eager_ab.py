#!/usr/bin/env python3
"""The port's eager step and `run_segments`, timed on one card, for one tree
of the port.

    python3 eager_ab.py [--tree DIR] [--frames 40] [--segments 4]
        [--seg-frames 11] [--out FILE]

`--tree` (default: this checkout) is put first on `sys.path`, so the same
script times an earlier commit of the port unpacked beside it:

    mkdir -p _parent && git archive HEAD radarslampy_tpu_torch | tar -x -C _parent
    for t in _parent . . _parent; do python3 eager_ab.py --tree $t; done

Workload: the bench's (`bench.make_workload(SlamConfig(), seed 0)`, float32
scans on the card before timing).
- eager: `init_state`, 4 warm-up steps, then `--frames` calls of the eager
  `slam_step`, each followed by a sync: host ms a step (p50, p95, each
  sample) and frames/s over them.
- run_segments: `parallel.batch_odometry.run_segments` in a world of one rank
  (NCCL on localhost), over `--segments` segments of `--seg-frames` scans of
  the same workload, overlapping by one scan; frames/s over the segments'
  steps, twice (the first after the eager part, so nothing is cold).
DoH launches of each part from `ops/cuda/doh_cuda.launches`.

Prints the card line (`nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`) and, last, one JSON line (also written to `--out`).
Exits 2 without CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tree", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--frames", type=int, default=40, help="timed eager steps")
    ap.add_argument("--segments", type=int, default=4)
    ap.add_argument("--seg-frames", type=int, default=11, help="scans a segment")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(a.tree))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("eager_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    import radarslampy_tpu_torch
    import torch.distributed as dist

    from radarslampy_tpu_torch import bench
    from radarslampy_tpu_torch.config import SlamConfig
    from radarslampy_tpu_torch.models import frontend as F
    from radarslampy_tpu_torch.ops.cuda import doh_cuda
    from radarslampy_tpu_torch.parallel import batch_odometry as bo
    from radarslampy_tpu_torch.parallel import launch
    from radarslampy_tpu_torch.parallel.mesh import make_mesh
    from radarslampy_tpu_torch.utils.profiling import card_line

    pkg = os.path.dirname(os.path.abspath(radarslampy_tpu_torch.__file__))
    if not pkg.startswith(os.path.abspath(a.tree) + os.sep):
        raise RuntimeError(f"imported {pkg}, not the package of --tree {a.tree}")
    card = card_line()
    print(card, flush=True)
    cfg = SlamConfig()
    dev = torch.device("cuda")
    D, T = a.segments, a.seg_frames
    n_meas = max(a.frames, D * (T - 1) + 1 - bench.N_WARM - 1)
    _, scans_np = bench.make_workload(cfg, 0, bench.N_WARM, n_meas)
    scans = torch.as_tensor(scans_np, device=dev)
    maps = F.build_frame_maps(cfg, dev)
    torch.cuda.synchronize()

    # the eager step
    state = F.init_state(scans[0], np.zeros(3), maps, cfg)
    for i in range(1, bench.N_WARM + 1):
        state, _ = F.slam_step(state, scans[i], maps, cfg)
    torch.cuda.synchronize()
    launches0 = doh_cuda.launches
    step_ms = []
    t0 = time.perf_counter()
    for scan in scans[bench.N_WARM + 1:bench.N_WARM + 1 + a.frames]:
        t = time.perf_counter()
        state, out = F.slam_step(state, scan, maps, cfg)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    eager_s = time.perf_counter() - t0
    eager_launches = doh_cuda.launches - launches0
    pose = state.pose.cpu().numpy().tolist()

    # run_segments in a world of one
    step = T - 1
    seg = torch.stack([scans[k * step:k * step + T] for k in range(D)])
    launch.initialize(f"localhost:{free_port()}", 1, 0)
    try:
        mesh = make_mesh()
        seg_fps, seg_launches = [], []
        for _ in range(2):
            launches0 = doh_cuda.launches
            torch.cuda.synchronize()
            t = time.perf_counter()
            poses = bo.run_segments(seg, maps, cfg, mesh)
            seg_fps.append(D * (T - 1) / (time.perf_counter() - t))
            seg_launches.append(doh_cuda.launches - launches0)
    finally:
        dist.destroy_process_group()

    res = {
        "tree": a.tree,
        "card": card,
        "device_kind": torch.cuda.get_device_name(0),
        "torch": torch.__version__,
        "eager_frames": a.frames,
        "eager_ms_p50": float(np.percentile(step_ms, 50)),
        "eager_ms_p95": float(np.percentile(step_ms, 95)),
        "eager_fps": a.frames / eager_s,
        "eager_ms": step_ms,
        "eager_doh_launches": eager_launches,
        "eager_final_pose": pose,
        "segments": D,
        "seg_frames": T,
        "run_segments_fps": seg_fps,
        "run_segments_doh_launches": seg_launches,
        "run_segments_final_poses": poses[:, -1].tolist(),
    }
    line = json.dumps(res)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
