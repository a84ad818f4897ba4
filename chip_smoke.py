#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (elapsed seconds in brackets):
  1. the card: `nvidia-smi` name and power limit, torch's device name;
  2. the cold nvcc build of every kernel of the port (csrc/*.cu -> _build/);
     a register spill in ptxas's report fails;
  3. each kernel's registers, shared memory and blocks per SM as the runtime
     reports them (local memory fails); each kernel against its plain
     PyTorch twin on the card, on the main
     path's input and on a ragged crop of it, and two launches of it on one
     input against each other (bit for bit).  Its device time comes from 100
     calls captured in a CUDA graph (events around each replay, median of 5),
     cross-checked by torch.profiler; its time through the wrapper, and the
     twin's, from CUDA events around single calls (median of 30); beside them
     the least time the card could take (its bound);
  4. the main path: `SlamConfig()` defaults, synthetic frames quantised to u8,
     build_frame_maps -> init_state -> slam_step per frame, then the same
     frames through slam_step_chunk; launch counts, drift against the
     rendered ground truth, chunk == per-frame; then the same step at a
     small config on the card and on the CPU, which must agree;
  5. the driver: `RadarSlamSystem(...).run()` at `SlamConfig()` over phase
     4's frames, fed through `frame_source` from a sequence directory that
     holds radar.timestamps and a GT CSV (no PNGs: the card machine may lack
     PIL); its trajectory and final state equal phase 4's loop bit for bit;
     a run checkpointed at frame 6 and resumed equals the straight run bit
     for bit; the metrics JSONL; ATE, drift and fps; then one driver step
     under torch.profiler, whose `record_function` ranges inside slam_step
     give each stage's host and device time and the step's device idle share;
  6. FMT: `SlamConfig(use_fmt=True)` at full width on a pure turn, its
     rotation against the rendered turn, one FMT step profiled; then the
     FMT step at a small config on the card and on the CPU, which must agree;
  7. the back-end: (a) `run(optimize=True, ba=True, backend_every=24)` at
     `SlamConfig()` over 49 frames of a rendered circle that returns to its
     start (40 frames a turn, 2.2 m chords), fed through `frame_source`: at
     least one loop closed online and one post hoc, the keyframe error
     against GT of the map, the pose graph and BA, fps, the post-hoc pass
     timed alone on the host, DoH launches; a second run equal to the first
     bit for bit on every RunResult array and state leaf; (b) the solvers on
     a synthetic map in `SlamConfig()`'s shapes (capacity 4096, K 256, P 512,
     16 x 80 descriptors) with 1,100 live keyframes and 12 planted revisits:
     `close_loops` ("both"), the pose graph ("auto": PCG at 1,280 rows), BA
     ("auto": PCG at 1,100 poses) and two online passes over the map grown to
     600 and then 1,100 keyframes, each timed (synchronised host ms) with its
     candidates, loops, CG sweeps and mean keyframe error before and after;
     (c) `close_loops`, the dense pose graph and dense BA on a small map on
     the card and on the CPU: candidates, loop edges and `ok` flags equal,
     poses within the CPU parity tests' bounds.
Then the card line again, one JSON line describing every kernel, and as the
last line `{"ok": true, "device": {...}}`.  Any failure raises and exits
non-zero; without a CUDA device, or without the package beside this file, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

T0 = time.time()

# H100 SXM data sheet: HBM3 bandwidth and fp32 rate of the CUDA cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
N_FRAMES = 12
CHECKPOINT_AT = 6   # the driver's mid-run checkpoint, resumed in phase 5
FMT_TURN = 0.15     # rad per frame of phase 6's pure turn
SMALL = dict(cart_size=256, cart_downsample=16, n_candidates=256, max_keyframes=16)
# Phase 6: FMT's rotation against the rendered turn.  One polar row is
# 2*pi/400 = 0.0157 rad; the parabolic refinement lands well inside it
# (CPU, this turn: within 1.5e-3 rad).
FMT_ROT_TOL = 0.01
# Card against CPU at the small config with use_fmt: the pose bound of the
# step from identical state (tests/test_torch_frontend.py), and for the FMT
# rotation the CPU bound against JAX (tests/test_torch_fmt.py): cuFFT and
# pocketfft sum in other orders, ~1e-6 on the correlation surface.
FMT_CARD_CPU_ROT = 1e-5
Frame = collections.namedtuple("Frame", "power frame_timestamp")


def log(msg):
    print(f"[{time.time() - T0:7.1f}s] {msg}", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=30, warmup=3):
    """Median per-call time of fn() on the card, CUDA events around each call:
    the device's time plus whatever host work in fn() it waits for."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def graph_ms(fn, n=100, replays=5, warmup=3):
    """Device time of one fn() call: n calls captured in a CUDA graph, events
    around each replay, median of `replays` replays over n.  No host work
    falls between the launches."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    del graph
    return statistics.median(times)


def _device_us(ev):
    """A profiler event's device time in us (`cuda_time_total` before torch 2.4)."""
    us = getattr(ev, "device_time_total", None)
    return ev.cuda_time_total if us is None else us


def profiler_ms(fn, kernel_name, n=20):
    """Mean device time of the kernel named `kernel_name` per fn() call, from
    torch.profiler's key_averages(); None when the trace shows no device time
    for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if kernel_name in ev.key:
            us = _device_us(ev)
            if us > 0 and ev.count:
                return us / 1e3 / n
    return None


def doh_bound_ms(S, radii):
    """Least time for the DoH function: each input byte read once, each output
    byte written once; separable blur (2 passes, 2 flop per tap) plus the
    14-flop Hessian stencil per pixel and sigma."""
    n = len(radii)
    bytes_moved = 4 * S * S + 4 * n * S * S + 4 * sum(2 * r + 1 for r in radii)
    flops = S * S * sum(2 * 2 * (2 * r + 1) + 14 for r in radii)
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def render_frames(cfg, n_frames, seed):
    """Synthetic scans along a gentle arc (2 m and 0.04 rad per frame), as u8."""
    import numpy as np

    from radarslampy_tpu_torch.sim import fakedata as fd

    poses = np.zeros((n_frames, 3))
    for t in range(1, n_frames):
        th = poses[t - 1, 2]
        poses[t] = poses[t - 1] + [2.0 * np.cos(th), 2.0 * np.sin(th), 0.04]
    rng = np.random.default_rng(seed)
    scans = [s for _, s in fd.render_sequence(rng, poses, cfg, n_landmarks=1200,
                                              with_distortion=True, noise=0.01)]
    frames = np.stack([np.clip(np.round(s * 255.0), 0, 255).astype(np.uint8)
                       for s in scans])
    return poses, frames


def check_doh_kernel(torch, doh_cuda, img, filters):
    """Kernel vs twin on one image; returns (max_abs_err, per-sigma tolerances,
    device_ms, wrapper_ms, plain_ms)."""
    out = doh_cuda.doh_response_cuda(img, filters)
    again = doh_cuda.doh_response_cuda(img, filters)
    ref = doh_cuda.doh_response_reference(img, filters)
    torch.cuda.synchronize()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise AssertionError(f"DoH kernel output bad: shape {tuple(out.shape)}")
    if not torch.equal(out, again):
        raise AssertionError("DoH kernel: two launches on one input differ")
    err = float((out - ref).abs().max())
    # tolerance of the port's CPU tests (tests/test_torch_doh.py): the same
    # sums in another order, amplified by sigma^4 (up to 1e4); 2e-3 * max|ref|
    # of each sigma slice, so a weak slice cannot hide under a strong one
    tol = []
    for s in range(ref.shape[0]):
        err_s = float((out[s] - ref[s]).abs().max())
        tol.append(2e-3 * float(ref[s].abs().max()))
        if not (tol[s] > 0 and err_s <= tol[s]):
            raise AssertionError(f"DoH kernel disagrees with its twin at S={img.shape[0]}, "
                                 f"sigma slice {s}: max abs err {err_s} > {tol[s]}")
    device_ms = graph_ms(lambda: doh_cuda.doh_response_cuda(img, filters))
    wrapper_ms = time_ms(lambda: doh_cuda.doh_response_cuda(img, filters))
    plain_ms = time_ms(lambda: doh_cuda.doh_response_reference(img, filters))
    return err, tol, device_ms, wrapper_ms, plain_ms


def render_turn(cfg, n_frames, seed):
    """Scans of a sensor turning in place by FMT_TURN per frame, as u8."""
    import numpy as np

    from radarslampy_tpu_torch.sim import fakedata as fd

    rng = np.random.default_rng(seed)
    world_pts, world_refl = fd.make_world(rng, 1200, 80.0)
    poses = np.stack([[0.0, 0.0, FMT_TURN * t] for t in range(n_frames)])
    return poses, np.stack([
        np.clip(np.round(fd.render_polar_scan(world_pts, world_refl, p, cfg, rng=rng,
                                              noise=0.01) * 255.0), 0, 255).astype(np.uint8)
        for p in poses])


def leaves(state):
    return list(state[:-2]) + list(state.map) + [state.frame_idx]


def states_equal(torch, a, b):
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def step_profile(prof):
    """From a trace holding one slam_step: {range: (host ms, device ms)} for
    the step and each of its `slam_step.<stage>` ranges, the step's host
    window (ms), and the device's busy time inside that window (ms).  A
    range's device time is the sum of the kernels (and copies) launched
    inside it; busy time is the union of all device activity in the window."""
    from torch.autograd import DeviceType

    events = prof.events()
    ranges = [e for e in events if e.device_type == DeviceType.CPU
              and (e.name == "slam_step" or e.name.startswith("slam_step."))]
    stages = {e.name: (e.cpu_time_total / 1e3, _device_us(e) / 1e3) for e in ranges}
    step = [e for e in ranges if e.name == "slam_step"]
    if len(step) != 1 or len(stages) != len(ranges):
        raise AssertionError(f"expected one slam_step with one range per stage, got "
                             f"{[e.name for e in ranges]}")
    t0, t1 = step[0].time_range.start, step[0].time_range.end
    spans = sorted((max(e.time_range.start, t0), min(e.time_range.end, t1)) for e in events
                   if e.device_type != DeviceType.CPU and not e.name.startswith("slam_step")
                   and not getattr(e, "is_user_annotation", False))
    busy, cur = 0.0, None
    for a, b in spans:
        if b <= a:
            continue
        if cur is None or a > cur[1]:
            busy += 0 if cur is None else cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    busy += 0 if cur is None else cur[1] - cur[0]
    return stages, (t1 - t0) / 1e3, busy / 1e3


def untraced_ms(torch, step, dev):
    """Median wall time (ms) of five synchronised calls of `step()` with no
    profiler on."""
    ms = []
    for _ in range(5):
        t = time.perf_counter()
        step()
        if dev == "cuda":
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    return statistics.median(ms)


def log_profile(label, stages, window_ms, busy_ms, unprofiled_ms):
    """The idle share of the traced window comes from the profiled step
    alone.  The profiler's own host work stretches that window, so the share
    is also given over `unprofiled_ms`: the same step (same state, same
    frame) timed untraced in this run."""
    log(f"{label}: " + ", ".join(f"{k.split('.', 1)[-1]} {h:.2f} / {d:.3f}"
                                 for k, (h, d) in stages.items())
        + " (ms on the host / ms of device activity launched in the range)")
    log(f"{label}: device busy {busy_ms:.3f} ms; idle share {1 - busy_ms / window_ms:.4f} "
        f"of the traced window ({window_ms:.2f} ms); {1 - busy_ms / unprofiled_ms:.4f} of "
        f"the same step untraced ({unprofiled_ms:.2f} ms, median of 5)")


def drive(torch, cfg, gt, frames, dev, tmp):
    """Phase 5 on `dev`: the driver over `frames` (u8 [N, A, Wpad]) of the
    sequence written for `gt`; returns what main() checks and prints."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from radarslampy_tpu_torch import RadarSlamSystem
    from radarslampy_tpu_torch.models import frontend as F
    from radarslampy_tpu_torch.ops.cuda import doh_cuda
    from radarslampy_tpu_torch.sim import oxford_files
    from radarslampy_tpu_torch.utils.checkpoint import load_state

    stamps = oxford_files.write_sequence(tmp, "synth", gt, cfg)

    def source(lo, hi):
        return [Frame(frames[i], int(stamps[i])) for i in range(lo, hi)]

    n = len(frames)
    metrics = f"{tmp}/metrics.jsonl"
    system = RadarSlamSystem("synth", tmp, cfg, device=dev)
    doh_cuda.launches = 0
    t = time.time()
    straight = system.run(frame_source=source(0, n), metrics_path=metrics)
    wall_s = time.time() - t
    launches = doh_cuda.launches
    recs = [json.loads(line) for line in open(metrics)]

    ck, snap = f"{tmp}/ck", f"{tmp}/ck_at_{CHECKPOINT_AT}"

    def snapshot(k, out):  # frame k's progress call comes after frame k-1's checkpoint
        if k == CHECKPOINT_AT + 1:
            shutil.copytree(ck, snap)

    checkpointed = RadarSlamSystem("synth", tmp, cfg, progress=snapshot, device=dev).run(
        frame_source=source(0, n), checkpoint_dir=ck, checkpoint_every=CHECKPOINT_AT)
    resumed = RadarSlamSystem("synth", tmp, cfg, device=dev).run(
        frame_source=source(CHECKPOINT_AT + 1, n), resume_from=snap)

    # the profiled step (frame CHECKPOINT_AT + 1 of a resumed run), and the
    # same step from the same checkpointed state untraced
    at_ck, _ = load_state(snap, cfg, dev)
    frame = frames[CHECKPOINT_AT + 1]
    unprofiled = untraced_ms(torch, lambda: F.slam_step(at_ck, frame, system.maps, cfg), dev)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev == "cuda" else [])
    with profile(activities=activities) as prof:
        system.run(frame_source=source(CHECKPOINT_AT + 1, CHECKPOINT_AT + 2), resume_from=snap)
    return dict(straight=straight, checkpointed=checkpointed, resumed=resumed, recs=recs,
                wall_s=wall_s, launches=launches, profile=(*step_profile(prof), unprofiled),
                est=np.asarray(straight.trajectory.as_arrays()[1]))


def fmt_turn(torch, cfg, frames, dev):
    """Phase 6's FMT step over `frames` on `dev` -> (StepOutputs, ms per
    frame, DoH launches of the run, the last step's profile and its
    untraced time).  The untraced repeats of the last step come after the
    launches are read."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from radarslampy_tpu_torch.models import frontend as F
    from radarslampy_tpu_torch.ops.cuda import doh_cuda

    maps = F.build_frame_maps(cfg, dev)
    state = F.init_state(frames[0], np.zeros(3), maps, cfg)
    outs, ms = [], []
    for f in frames[1:-1]:
        t = time.time()
        state, out = F.slam_step(state, f, maps, cfg)
        if dev == "cuda":
            torch.cuda.synchronize()
        ms.append((time.time() - t) * 1e3)
        outs.append(out)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev == "cuda" else [])
    with profile(activities=activities) as prof:
        _, out = F.slam_step(state, frames[-1], maps, cfg)
        if dev == "cuda":
            torch.cuda.synchronize()
    outs.append(out)
    launches = doh_cuda.launches
    unprofiled = untraced_ms(torch, lambda: F.slam_step(state, frames[-1], maps, cfg), dev)
    return outs, ms, launches, (*step_profile(prof), unprofiled)


def range_overhead_us():
    """Host cost of one empty record_function range with no profiler on."""
    from torch.profiler import record_function

    n = 20000
    t = time.perf_counter()
    for _ in range(n):
        with record_function("slam_step.probe"):
            pass
    return (time.perf_counter() - t) / n * 1e6


# Phase 7 (a): a circle of LOOP_PER_TURN frames a turn, LOOP_CHORD m chords
# (every frame a keyframe, clear of the 2.0 m threshold), LOOP_N frames, so
# keyframes 40-48 revisit 0-8; the online pass runs every LOOP_EVERY steps and
# its second run (step 48) closes loops.
LOOP_PER_TURN, LOOP_CHORD, LOOP_N, LOOP_EVERY = 40, 2.2, 49, 24
# Phase 7 (b): the synthetic map (SlamConfig() shapes) and its two growth
# stages; the pose graph pads 1100 live keyframes to 1280 rows and BA packs
# 1100 poses, so "auto" takes PCG for both.
SCALE_LIVE, SCALE_STAGE = 1100, 600
# Card against CPU (phase 7 (c)): the bounds of the CPU parity tests
# (tests/test_torch_posegraph.py, tests/test_torch_ba.py)
PG_M, PG_RAD, BA_M, BA_RAD = 1e-3, 1e-4, 5e-3, 5e-4


def render_loop(cfg, seed):
    """Scans of the phase-7 circle, as u8, and its poses."""
    import numpy as np

    from radarslampy_tpu_torch.sim import fakedata as fd

    radius = LOOP_CHORD / (2 * np.sin(np.pi / LOOP_PER_TURN))
    th = np.arange(LOOP_N) * 2 * np.pi / LOOP_PER_TURN
    poses = np.stack([radius * np.sin(th), radius * (1 - np.cos(th)), th], 1)
    rng = np.random.default_rng(seed)
    return poses, np.stack([
        np.clip(np.round(s * 255.0), 0, 255).astype(np.uint8)
        for _, s in fd.render_sequence(rng, poses, cfg, n_landmarks=1200,
                                       with_distortion=True, noise=0.01)])


def kf_error(kf_poses, gt_kf):
    """Mean keyframe position error (m) against the ground truth."""
    import numpy as np

    return float(np.linalg.norm(np.asarray(kf_poses)[:, :2] - gt_kf[:, :2], axis=1).mean())


def run_arrays(res):
    """Every array and number of a RunResult, in a fixed order."""
    import numpy as np

    out = [np.asarray(a) for a in res.trajectory.as_arrays()]
    out += [np.asarray(getattr(res, f)) for f in ("kf_poses_optimized", "kf_poses_ba",
                                                  "landmarks_ba")]
    out += [np.asarray([res.posegraph_cost, res.ba_cost, res.n_loop_closures,
                        res.n_online_loops, res.n_keyframes, res.frames])]
    return out + [x.cpu().numpy() for x in leaves(res.final_state)]


def backend_driver(torch, cfg, dev, tmp):
    """Phase 7 (a) on `dev`: the driver with the back-end on, over the
    rendered loop, twice; returns what main() checks and prints."""
    import numpy as np

    from radarslampy_tpu_torch import RadarSlamSystem
    from radarslampy_tpu_torch.ops.cuda import doh_cuda
    from radarslampy_tpu_torch.sim import oxford_files

    gt, frames = render_loop(cfg, seed=5)
    stamps = oxford_files.write_sequence(tmp, "loop", gt, cfg)
    source = [Frame(f, int(t)) for f, t in zip(frames, stamps)]
    kw = dict(optimize=True, ba=True, backend_every=LOOP_EVERY)
    system = RadarSlamSystem("loop", tmp, cfg, device=dev)
    doh_cuda.launches = 0
    t = time.time()
    first = system.run(frame_source=source, **kw)
    wall_s = time.time() - t
    launches = doh_cuda.launches
    second = RadarSlamSystem("loop", tmp, cfg, device=dev).run(frame_source=source, **kw)
    # the post-hoc pass alone, timed, on the final state of the first run
    torch.cuda.synchronize()
    t = time.perf_counter()
    again = system.optimize_map(first.final_state, ba=True)
    torch.cuda.synchronize()
    posthoc_ms = (time.perf_counter() - t) * 1e3
    M = first.n_keyframes
    gt_kf = gt[first.final_state.map.frame_ids[:M].cpu().numpy()]
    errors = (kf_error(first.final_state.map.poses[:M].cpu().numpy(), gt_kf),
              kf_error(first.kf_poses_optimized, gt_kf), kf_error(first.kf_poses_ba, gt_kf))
    same = all(np.array_equal(a, b) for a, b in zip(run_arrays(first), run_arrays(second)))
    same_posthoc = (np.array_equal(again[0], first.kf_poses_optimized)
                    and np.array_equal(again[3], first.kf_poses_ba)
                    and again[1] == first.n_loop_closures)
    return dict(res=first, wall_s=wall_s, launches=launches, posthoc_ms=posthoc_ms,
                errors=errors, same=same, same_posthoc=same_posthoc)


def revisit_map(torch, cfg, n_base, n_planted, dev, seed, gap=40, drift_m=4.0):
    """A synthetic map in `cfg`'s shapes (capacity, K, P, descriptors): a 2 m
    random walk over `n_base` keyframes with `n_planted` revisits of earlier
    places spread over it, drifted estimates, and per keyframe the sensor-frame
    view of its K/2 nearest world points (their indices as landmark ids), its
    P/2 nearest as the point cloud, and a ring x sector occupancy descriptor.
    Returns (MapState on `dev`, ground-truth keyframe poses)."""
    import numpy as np

    from radarslampy_tpu_torch.models.frontend import MapState

    rng = np.random.default_rng(seed)
    th = np.cumsum(rng.normal(0, 0.08, n_base))
    xy = np.cumsum(np.stack([2.0 * np.cos(th), 2.0 * np.sin(th)], 1), axis=0)
    walk = np.concatenate([xy, th[:, None]], axis=1)
    every = n_base // (n_planted + 1)
    parts, src = [], 0
    for k in range(n_planted):
        j_pos = (k + 1) * every
        parts.append(walk[src:j_pos])
        p = walk[max(0, j_pos - gap - int(rng.integers(5, 60)))].copy()
        p[:2] += rng.normal(0, 0.5, 2)
        p[2] += rng.normal(0, 0.3)
        parts.append(p[None])
        src = j_pos
    parts.append(walk[src:])
    gt = np.concatenate(parts)
    M = len(gt)
    est = gt + np.linspace(0, drift_m, M)[:, None] * np.array([1.0, 0.4, 0.0])

    cap, K, P = cfg.max_keyframes, cfg.k_max, cfg.pc_points_per_kf
    R, S = cfg.sc_rings, cfg.sc_sectors
    lo, hi = gt[:, :2].min(0) - 50, gt[:, :2].max(0) + 50
    world = rng.uniform(lo, hi, (int(2.5 * M) + 2000, 2))
    f = dict(poses=np.zeros((cap, 3), np.float32), feat_world=np.zeros((cap, K, 2), np.float32),
             feat_local=np.zeros((cap, K, 2), np.float32),
             feat_ids=np.full((cap, K), -1, np.int32), feat_mask=np.zeros((cap, K), bool),
             velocities=np.zeros((cap, 3), np.float32),
             descriptors=np.zeros((cap, R, S), np.float32),
             pc_local=np.zeros((cap, P, 2), np.float32), pc_mask=np.zeros((cap, P), bool),
             frame_ids=np.full(cap, -1, np.int32))
    f["poses"][:M] = est
    f["frame_ids"][:M] = np.arange(M)
    for m in range(M):
        near = np.argsort(np.linalg.norm(world - gt[m, :2], axis=1))[:max(K, P) // 2]
        c, s = np.cos(gt[m, 2]), np.sin(gt[m, 2])
        d = world[near] - gt[m, :2]
        local = np.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1]], 1)
        f["feat_local"][m, :K // 2] = local[:K // 2]
        f["feat_mask"][m, :K // 2] = True
        f["feat_ids"][m, :K // 2] = near[:K // 2]
        f["pc_local"][m, :P // 2] = local[:P // 2]
        f["pc_mask"][m, :P // 2] = True
        ce, se = np.cos(est[m, 2]), np.sin(est[m, 2])
        lk = local[:K // 2]
        f["feat_world"][m, :K // 2] = np.stack([ce * lk[:, 0] - se * lk[:, 1],
                                                se * lk[:, 0] + ce * lk[:, 1]], 1) + est[m, :2]
        r = np.linalg.norm(local, axis=1)
        a = np.mod(np.arctan2(local[:, 1], local[:, 0]), 2 * np.pi)
        keep = r < 60.0
        desc = np.zeros((R, S), np.float32)
        np.add.at(desc, ((r[keep] / 60.0 * R).astype(int), (a[keep] / (2 * np.pi) * S)
                         .astype(int) % S), 1.0)
        f["descriptors"][m] = desc / max(desc.max(), 1.0)
    tensors = {k: torch.from_numpy(v).to(dev) for k, v in f.items()}
    return MapState(cursor=torch.tensor(M, dtype=torch.int32, device=dev), **tensors), gt


def state_around(torch, m):
    """A SlamState holding map `m`, its running pose at the last keyframe."""
    from radarslampy_tpu_torch.models.frontend import SlamState

    dev, K = m.poses.device, m.feat_local.shape[1]
    n = int(m.cursor)
    z = torch.zeros
    return SlamState(pose=m.poses[n - 1].clone(), velocity=z(3, device=dev),
                     prev_polar=z((4, 4), device=dev), prev_cart=z((4, 4), device=dev),
                     feat_px=z((K, 2), device=dev),
                     feat_mask=z(K, dtype=torch.bool, device=dev),
                     feat_id=torch.full((K,), -1, dtype=torch.int32, device=dev),
                     next_id=torch.tensor(0, dtype=torch.int32, device=dev),
                     feat_world=z((K, 2), device=dev), kf_pose=m.poses[n - 1].clone(), map=m,
                     frame_idx=torch.tensor(n, dtype=torch.int32, device=dev))


def timed(torch, fn):
    """(fn(), synchronised host ms)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def solver_stages(torch, cfg, m, gt):
    """Phase 7 (b): close_loops, the pose graph, BA and two online passes over
    the map grown in two stages, each timed; returns one dict per stage."""
    from radarslampy_tpu_torch.models.ba import build_ba_problem, optimize_ba, reseed_map
    from radarslampy_tpu_torch.models.loopclosure import (close_loops, incremental_backend,
                                                          trim_map_state)
    from radarslampy_tpu_torch.models.posegraph import optimize_pose_graph

    M = int(m.cursor)
    before = kf_error(m.poses[:M].cpu().numpy(), gt)
    mt = trim_map_state(m)
    stats = {}
    (graph, matches), ms = timed(torch, lambda: close_loops(mt, cfg, method="both",
                                                            stats=stats))
    stages = [dict(stage="close_loops", ms=ms, candidates=stats["candidates"],
                   loops=int(matches.ok.sum()), rows=mt.poses.shape[0])]
    pg = {}
    (poses, cost), ms = timed(torch, lambda: optimize_pose_graph(graph, cfg, stats=pg))
    kf_pg = poses[:M].cpu().numpy()
    stages.append(dict(stage="pose_graph", ms=ms, rows=graph.poses.shape[0],
                       solver="pcg" if pg["cg_sweeps"] else "dense", cg_sweeps=pg["cg_sweeps"],
                       cost=float(cost), err_before=before, err_after=kf_error(kf_pg, gt)))
    problem, ms_pack = timed(torch, lambda: build_ba_problem(reseed_map(mt, kf_pg)))
    ba = {}
    (poses_b, lms, cost_b), ms = timed(torch, lambda: optimize_ba(problem, cfg, stats=ba))
    stages.append(dict(stage="ba", ms=ms, pack_ms=ms_pack, poses=problem.poses.shape[0],
                       landmarks=int(problem.lm_mask.sum()), observations=int(problem.obs_mask.sum()),
                       solver="pcg" if ba["cg_sweeps"] else "dense", cg_sweeps=ba["cg_sweeps"],
                       cost=float(cost_b), err_before=kf_error(kf_pg, gt),
                       err_after=kf_error(poses_b[:M].cpu().numpy(), gt)))

    # the online pass over the map as it grows: the first SCALE_STAGE keyframes,
    # then all of them, carrying the back-end state
    def prefix(n):
        return m._replace(cursor=torch.tensor(n, dtype=torch.int32, device=m.poses.device),
                          **{f: torch.where(_rows(torch, getattr(m, f), n), getattr(m, f),
                                            torch.zeros_like(getattr(m, f)))
                             for f in ("poses", "feat_world", "feat_local", "feat_mask",
                                       "feat_ids", "descriptors", "pc_local", "pc_mask")})

    state, bs = state_around(torch, prefix(SCALE_STAGE)), None
    for n in (SCALE_STAGE, M):
        if n > SCALE_STAGE:   # the later keyframes join the map the first pass re-anchored
            grown = prefix(n)
            state = state_around(torch, grown._replace(**{
                f: torch.where(_rows(torch, getattr(grown, f), SCALE_STAGE),
                               getattr(state.map, f), getattr(grown, f))
                for f in ("poses", "feat_world")}))
        err0 = kf_error(state.map.poses[:n].cpu().numpy(), gt[:n])
        inc = {}
        (state, n_new, cost, bs), ms = timed(
            torch, lambda: incremental_backend(state, cfg, backend_state=bs, stats=inc))
        stages.append(dict(stage=f"online_pass_{n}", ms=ms, candidates=inc["candidates"],
                           loops=n_new, edges=len(bs.edges_ij), rows=1024 * -(-n // 1024),
                           solver=("pcg" if inc.get("cg_sweeps") else "dense") if n_new else None,
                           cg_sweeps=inc.get("cg_sweeps", 0), err_before=err0,
                           err_after=kf_error(state.map.poses[:n].cpu().numpy(), gt[:n])))
    return stages


def _rows(torch, a, n):
    """Mask [rows, 1, ...] of a's first n rows, broadcastable against a."""
    idx = torch.arange(a.shape[0], device=a.device) < n
    return idx.reshape((-1,) + (1,) * (a.ndim - 1))


def backend_card_vs_cpu(torch, cfg):
    """Phase 7 (c): close_loops, the dense pose graph and dense BA on a small
    map, on the card and on the CPU."""
    import numpy as np

    from radarslampy_tpu_torch.models.ba import build_ba_problem, optimize_ba, reseed_map
    from radarslampy_tpu_torch.models.loopclosure import close_loops, trim_map_state
    from radarslampy_tpu_torch.models.posegraph import optimize_pose_graph

    out = {}
    for dev in ("cuda", "cpu"):
        m, gt = revisit_map(torch, cfg, 140, 5, dev, seed=9, gap=20, drift_m=2.0)
        mt = trim_map_state(m)
        graph, matches = close_loops(mt, cfg, method="both")
        M = int(m.cursor)
        poses, cost = optimize_pose_graph(graph, cfg, method="dense")
        kf_pg = poses[:M].cpu().numpy()
        p = build_ba_problem(reseed_map(mt, kf_pg))
        pb, lms, cb = optimize_ba(p, cfg, method="dense")
        out[dev] = dict(ij=graph.edges_ij.cpu().numpy(), ok=matches.ok.cpu().numpy(),
                        emask=graph.edge_mask.cpu().numpy(), pg=kf_pg,
                        ba=pb[:M].cpu().numpy(), lms=lms.cpu().numpy(), gt=gt)
    a, b = out["cuda"], out["cpu"]
    d_pg = np.abs(a["pg"] - b["pg"]).max(0)
    d_ba = np.abs(a["ba"] - b["ba"]).max(0)
    d_lm = float(np.abs(a["lms"] - b["lms"]).max())
    diff = dict(candidate_rows=int((a["ij"] != b["ij"]).any(1).sum()),
                ok_flags=int((a["ok"] != b["ok"]).sum()),
                edge_mask=int((a["emask"] != b["emask"]).sum()))
    equal = not any(diff.values())
    return dict(equal=equal, diff=diff, loops=int(a["ok"].sum()), d_pg=d_pg, d_ba=d_ba,
                d_lm=d_lm,
                ok=bool(equal and a["ok"].sum() >= 1 and max(d_pg[:2]) <= PG_M
                        and d_pg[2] <= PG_RAD and max(d_ba[:2]) <= BA_M and d_ba[2] <= BA_RAD
                        and d_lm <= BA_M))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run",
              file=sys.stderr)
        return 2
    try:
        import radarslampy_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the radarslampy_tpu_torch package is missing ({exc})",
              file=sys.stderr)
        return 2
    import numpy as np

    from radarslampy_tpu_torch.config import SlamConfig
    from radarslampy_tpu_torch.models import frontend as F
    from radarslampy_tpu_torch.ops.cuda import doh_cuda
    from radarslampy_tpu_torch.ops.grid import warp_polar_to_cartesian

    # 1. the card
    card = card_line()
    log(f"card: {card} | torch: {torch.cuda.get_device_name(0)} "
        f"| torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. cold build
    t = time.time()
    lib_path = doh_cuda.build_library()
    log(f"build: csrc/doh.cu -> {lib_path.name} in {time.time() - t:.2f} s")
    doh_cuda.load_library()
    spills = []
    for line in doh_cuda.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and (int(m.group(1)) or int(m.group(2))):
            spills.append(line.strip())
    if spills:
        raise AssertionError(f"doh_kernel spills registers: {spills}")

    # 3. kernel vs twin, on the main path's Cartesian image (S = cart_size)
    # and on a ragged crop of it (S = 1000: no multiple of the tile sizes)
    cfg = SlamConfig()
    t = time.time()
    gt, frames = render_frames(cfg, N_FRAMES, seed=0)
    log(f"frames: {N_FRAMES} x {frames.shape[1:]} u8 rendered in {time.time() - t:.1f} s")
    t = time.time()
    maps = F.build_frame_maps(cfg)
    torch.cuda.synchronize()
    log(f"build_frame_maps: {time.time() - t:.2f} s")
    info = doh_cuda.kernel_info(max(maps.doh.radii), len(maps.doh.radii))
    log(f"doh_kernel: {info['registers']} registers, {info['local_bytes']} B local, "
        f"{info['smem_bytes']} B shared per block, {info['blocks_per_sm']} blocks per SM")
    if info["local_bytes"]:
        raise AssertionError(f"doh_kernel uses local memory: {info}")
    cart0 = warp_polar_to_cartesian(
        F._dequantize_polar(torch.as_tensor(frames[0], device="cuda")), maps.warp)
    for img in (cart0, cart0[:1000, :1000].contiguous()):
        S = img.shape[0]
        err, tol, device_ms, wrapper_ms, plain_ms = check_doh_kernel(
            torch, doh_cuda, img, maps.doh)
        bound, bound_by = doh_bound_ms(S, maps.doh.radii)
        log(f"doh S={S} sigmas={cfg.doh_sigmas}: max_abs_err {err:.3e} "
            f"(tol per sigma {', '.join(f'{t:.3e}' for t in tol)}) "
            f"kernel {device_ms:.5f} ms on the device (graph replay), {wrapper_ms:.5f} ms "
            f"through the wrapper, twin {plain_ms:.4f} ms, bound {bound:.5f} ms "
            f"({bound_by}), {bound / device_ms:.1%} of bound")
        if S == cfg.cart_size:
            prof_ms = profiler_ms(lambda: doh_cuda.doh_response_cuda(img, maps.doh),
                                  "doh_kernel")
            log(f"doh S={S} torch.profiler: " + (
                "no device time for doh_kernel in key_averages()" if prof_ms is None
                else f"{prof_ms:.5f} ms of device time per call"))
            log("doh redundant multiply-adds per sigma (computed from the tiling, not "
                "measured): " + ", ".join(
                    f"{sg} {f:.3f}" for sg, f in
                    zip(cfg.doh_sigmas, doh_cuda.redundant_work(S, maps.doh.radii))))
            # `ms` is the time of one call through the wrapper (events around
            # it, host work included), as the port first timed the kernel;
            # `wrapper_ms` is the same reading, `device_ms` the graph timer's
            doh_row = dict(name="doh_response", route="cuda",
                           source="radarslampy_tpu_torch/csrc/doh.cu",
                           replaces="radarslampy_tpu/ops/pallas/doh_pallas.py:84",
                           max_abs_err=err, ms=wrapper_ms, device_ms=device_ms,
                           wrapper_ms=wrapper_ms, profiler_ms=prof_ms, plain_ms=plain_ms,
                           bound_ms=bound, bound_by=bound_by,
                           bound_share=bound / device_ms, library_ms=None)

    # 4. main path at the default config
    doh_cuda.launches = 0
    t = time.time()
    state0 = F.init_state(frames[0], np.zeros(3), maps, cfg)
    torch.cuda.synchronize()
    init_launches = doh_cuda.launches
    log(f"init_state: {time.time() - t:.3f} s, {int(state0.feat_mask.sum())} features, "
        f"doh launches {init_launches}")
    state, outs, step_ms = state0, [], []
    for f in frames[1:]:
        t = time.time()
        state, out = F.slam_step(state, f, maps, cfg)
        torch.cuda.synchronize()
        step_ms.append((time.time() - t) * 1e3)
        outs.append(out)
    launches = doh_cuda.launches
    poses = torch.stack([o.pose for o in outs]).cpu().numpy()
    kf = [bool(o.is_keyframe) for o in outs]
    rt = [bool(o.did_retrack) for o in outs]
    inl = [int(o.n_inliers) for o in outs]
    est = np.concatenate([state0.pose.cpu().numpy()[None], poses])
    drift = float(np.linalg.norm(est[-1, :2] - gt[-1, :2]))
    log(f"slam_step x{len(outs)}: {statistics.median(step_ms):.2f} ms/frame median, "
        f"{statistics.mean(step_ms[1:]):.2f} mean after the first; keyframes {sum(kf)}, "
        f"retracks {sum(rt)}, inliers {inl}, doh launches {launches}, "
        f"final drift {drift:.3f} m")
    if not np.isfinite(est).all():
        raise AssertionError(f"non-finite pose: {est}")
    if launches < 1 + sum(rt):
        raise AssertionError(f"doh launches {launches} < 1 + retracks {sum(rt)}")
    if not drift < 1.5:
        raise AssertionError(f"drift {drift} m >= 1.5 m over {N_FRAMES} frames")

    doh_cuda.launches = 0
    t = time.time()
    state_c, outs_c = F.slam_step_chunk(
        state0, torch.as_tensor(frames[1:], device="cuda"), maps, cfg)
    torch.cuda.synchronize()
    chunk_launches = doh_cuda.launches
    log(f"slam_step_chunk x{len(outs)}: {(time.time() - t) * 1e3 / len(outs):.2f} ms/frame, "
        f"doh launches {chunk_launches}")
    # the chunk is the per-frame loop on the same inputs: every output field
    # must be equal bit for bit, as tests/test_torch_frontend.py holds it
    per_frame = F.StepOutput(*(torch.stack(field) for field in zip(*outs)))
    unequal = [k for k in F.StepOutput._fields
               if not torch.equal(getattr(outs_c, k), getattr(per_frame, k))]
    if unequal or chunk_launches != launches - init_launches:
        raise AssertionError(f"chunk != per-frame: fields {unequal} differ, "
                             f"launches {chunk_launches} vs {launches - init_launches}")
    log("chunk == per-frame: every output field equal bit for bit")

    # the same step on the card and on the CPU (plain twins) at a small config
    small = SlamConfig(**SMALL)
    _, sframes = render_frames(small, 5, seed=1)
    res = {}
    for dev in ("cuda", "cpu"):
        m = F.build_frame_maps(small, dev)
        s = F.init_state(sframes[0], np.zeros(3), m, small)
        s, o = F.slam_step_chunk(s, torch.as_tensor(sframes[1:], device=dev), m, small)
        res[dev] = o
    d = float((res["cuda"].pose.cpu() - res["cpu"].pose).abs().max())
    flags = all(torch.equal(getattr(res["cuda"], k).cpu(), getattr(res["cpu"], k))
                for k in ("is_keyframe", "did_retrack", "n_inliers"))
    log(f"small config, card vs CPU: flags equal {flags}, max pose diff {d:.2e}")
    # the bound of the step-from-identical-state parity test
    # (tests/test_torch_frontend.py): float-order differences move sub-pixel
    # KLT results and the float32 LM by ~1e-4 m
    if not (flags and d <= 1e-3):
        raise AssertionError("card and CPU steps disagree at the small config")

    # 5. the driver at SlamConfig(), over phase 4's frames
    with tempfile.TemporaryDirectory() as tmp:
        drv = drive(torch, cfg, gt, frames, "cuda", tmp)
    straight, driver_launches = drv["straight"], drv["launches"]
    log(f"driver: run() over {straight.frames} frames in {drv['wall_s']:.2f} s, fps {straight.fps:.3f} "
        f"(from the end of the first step) on {card}; keyframes {straight.n_keyframes}, "
        f"ATE {straight.rmse_vs_gt:.4f} m, min inliers {straight.min_inliers}, fit failures "
        f"{straight.n_fit_failures}, doh launches on the straight run {driver_launches}")
    drift_d = float(np.linalg.norm(drv["est"][-1, :2] - gt[-1, :2]))
    if not np.array_equal(drv["est"], est.astype(np.float64)):
        raise AssertionError("driver trajectory != the per-frame loop of phase 4")
    if not states_equal(torch, straight.final_state, state):
        raise AssertionError("driver final state != the per-frame loop's state")
    if not (np.array_equal(drv["checkpointed"].trajectory.as_arrays()[1], drv["est"])
            and states_equal(torch, drv["checkpointed"].final_state, state)):
        raise AssertionError("checkpointing changed the run")
    res_r = drv["resumed"]
    if not (res_r.frames == N_FRAMES - CHECKPOINT_AT - 1
            and np.array_equal(res_r.trajectory.as_arrays()[0],
                               straight.trajectory.as_arrays()[0])
            and np.array_equal(res_r.trajectory.as_arrays()[1], drv["est"])
            and states_equal(torch, res_r.final_state, straight.final_state)):
        raise AssertionError(f"resume from frame {CHECKPOINT_AT} != the straight run")
    recs = drv["recs"]
    if not (len(recs) == N_FRAMES - 1
            and sum(r["is_keyframe"] for r in recs) == straight.n_keyframes - 1
            and [r["is_keyframe"] for r in recs] == kf):
        raise AssertionError(f"metrics JSONL: {len(recs)} rows, keyframes "
                             f"{sum(r['is_keyframe'] for r in recs)} vs {straight.n_keyframes}")
    if not (np.isfinite(straight.rmse_vs_gt) and drift_d < 1.5):
        raise AssertionError(f"ATE {straight.rmse_vs_gt}, drift {drift_d} m")
    if driver_launches < 1:
        raise AssertionError("the driver's run launched no DoH kernel")
    log(f"driver == per-frame loop bit for bit (trajectory, every state leaf); resume at "
        f"frame {CHECKPOINT_AT} == straight run bit for bit; metrics {len(recs)} rows; "
        f"drift {drift_d:.3f} m")
    log_profile(f"driver step {CHECKPOINT_AT + 1} profiled", *drv["profile"])
    if drv["profile"][2] <= 0:
        raise AssertionError("the profiled driver step shows no device activity")
    log(f"record_function range, profiler off: {range_overhead_us():.2f} us on the host")

    # 6. FMT at full width on a pure turn, then card vs CPU at the small config
    fcfg = SlamConfig(use_fmt=True)
    turn_gt, turn = render_turn(fcfg, 6, seed=3)
    doh_cuda.launches = 0
    fouts, fms, fmt_launches, fprof = fmt_turn(torch, fcfg, turn, "cuda")
    rot = [float(o.fmt_rotation) for o in fouts]
    head_err = abs((float(fouts[-1].pose[2]) - turn_gt[-1, 2] + np.pi) % (2 * np.pi) - np.pi)
    finl = [int(o.n_inliers) for o in fouts]
    log(f"fmt SlamConfig(use_fmt=True), turn {FMT_TURN} rad/frame: fmt_rotation {rot}, "
        f"scale {[round(float(o.fmt_scale), 5) for o in fouts]}, inliers {finl}, final "
        f"heading error {head_err:.4f} rad, {statistics.median(fms):.2f} ms/frame median, "
        f"doh launches {fmt_launches}")
    log_profile("fmt step profiled", *fprof)
    if not (max(abs(r + FMT_TURN) for r in rot) < FMT_ROT_TOL and head_err < 0.05
            and min(finl) >= 15 and fmt_launches >= 1):
        raise AssertionError("FMT at full width: rotation, heading, inliers or launches off")
    _, sturn = render_turn(small, 5, seed=4)
    sres = {dev: fmt_turn(torch, SlamConfig(use_fmt=True, **SMALL), sturn, dev)[0]
            for dev in ("cuda", "cpu")}
    dpose = max(float((a.pose.cpu() - b.pose).abs().max()) for a, b in zip(*sres.values()))
    drot = max(abs(float(a.fmt_rotation) - float(b.fmt_rotation))
               for a, b in zip(*sres.values()))
    fflags = all(getattr(a, k).item() == getattr(b, k).item() for a, b in zip(*sres.values())
                 for k in ("is_keyframe", "did_retrack", "n_inliers"))
    log(f"fmt small config, card vs CPU: flags equal {fflags}, max pose diff {dpose:.2e} m, "
        f"max fmt_rotation diff {drot:.2e} rad")
    if not (fflags and dpose <= 1e-3 and drot <= FMT_CARD_CPU_ROT):
        raise AssertionError("card and CPU FMT steps disagree at the small config")

    # 7. the back-end: (a) the driver with it on a closed loop at SlamConfig()
    with tempfile.TemporaryDirectory() as tmp:
        bk = backend_driver(torch, cfg, "cuda", tmp)
    r = bk["res"]
    log(f"backend driver: run(optimize, ba, backend_every={LOOP_EVERY}) over {r.frames} frames "
        f"in {bk['wall_s']:.2f} s, fps {r.fps:.3f} on {card}; keyframes {r.n_keyframes}, online "
        f"loops {r.n_online_loops}, post-hoc loops {r.n_loop_closures}, pose-graph cost "
        f"{r.posegraph_cost:.6g}, BA cost {r.ba_cost:.6g} over {len(r.landmarks_ba)} landmarks; "
        f"keyframe error against GT: map {bk['errors'][0]:.4f} m, pose graph "
        f"{bk['errors'][1]:.4f} m, BA {bk['errors'][2]:.4f} m; post-hoc pass alone "
        f"{bk['posthoc_ms']:.1f} ms (host, synchronised); doh launches {bk['launches']}")
    log(f"backend driver: two runs equal bit for bit on every RunResult array: {bk['same']}; "
        f"the post-hoc pass again equal: {bk['same_posthoc']}")
    if not (bk["same"] and bk["same_posthoc"]):
        raise AssertionError("the back-end driver is not deterministic on the card")
    if not (r.n_online_loops >= 1 and r.n_loop_closures >= 1 and bk["launches"] >= 1
            and all(np.isfinite(bk["errors"]))):
        raise AssertionError("the back-end driver closed no loop online or post hoc, or "
                             "launched no DoH kernel")

    # (b) the solvers at scale, on a synthetic map in SlamConfig()'s shapes
    t = time.time()
    big, big_gt = revisit_map(torch, cfg, SCALE_LIVE - 12, 12, "cuda", seed=21)
    log(f"scale map: {int(big.cursor)} live keyframes of {cfg.max_keyframes}, K {cfg.k_max}, "
        f"P {cfg.pc_points_per_kf}, built in {time.time() - t:.1f} s")
    stages = solver_stages(torch, cfg, big, big_gt)
    for st in stages:
        log("scale " + ", ".join(f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                                 for k, v in st.items()))
    by = {st["stage"]: st for st in stages}
    if not (by["close_loops"]["loops"] >= 1 and by["pose_graph"]["solver"] == "pcg"
            and by["ba"]["solver"] == "pcg" and by["pose_graph"]["cg_sweeps"] > 0
            and by[f"online_pass_{int(big.cursor)}"]["solver"] == "pcg"):
        raise AssertionError(f"scale stages did not close loops or run both PCG solvers: {stages}")

    # (c) the card against the CPU at a small config
    cvc = backend_card_vs_cpu(torch, SlamConfig(**dict(SMALL, max_keyframes=256, k_max=64,
                                                       pc_points_per_kf=64)))
    log(f"backend small config, card vs CPU: candidates, loop edges and ok flags equal "
        f"{cvc['equal']} ({cvc['loops']} loops; rows that differ {cvc['diff']}); max diff "
        f"pose graph {cvc['d_pg'].tolist()}, "
        f"BA {cvc['d_ba'].tolist()} (x, y m; theta rad), landmarks {cvc['d_lm']:.2e} m")
    if not cvc["ok"]:
        raise AssertionError("card and CPU back-ends disagree at the small config")

    doh_row["launches"] = launches + driver_launches + fmt_launches + bk["launches"]
    doh_row["launches_by_path"] = {"step": launches, "driver": driver_launches,
                                   "fmt_step": fmt_launches, "backend_driver": bk["launches"]}
    print(card_line(), flush=True)
    print(json.dumps({"kernels": [doh_row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
