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
     poses within the CPU parity tests' bounds;
  8. the evaluation harness (`evaluation.evaluate_sequence`) at `SlamConfig()`
     over two turns of phase 7's circle (81 frames, the speed ramped up over
     the first 4), scans rendered on the card in the corridor world: (a)
     chunks of 16, the online back-end every 32 frames, the post-hoc pass and
     BA, a checkpoint at frame 49: fps, ATE, RPE, heading RMSE, loops, loop
     edge error, keyframe ATE before and after the pose graph and after BA,
     health, DoH launches; (b) a resume from that checkpoint equal to (a) bit
     for bit, and a resume under another seed refused; (c) chunks of 16 and
     of 13 (a padded tail) without the back-end, equal bit for bit; (d) the
     "sum" renderer, its ATE within max(2x (c)'s, 1 m); (e) one frame of the
     renderer in each mode, timed; (f) 25 frames at a small config at noise
     0 on the card and on the CPU; (g) the CLI `evaluation.main` on a
     written GT csv, its artifact holding the JAX CLI's keys;
  9. the distributed back-end (`parallel/`) in a world of one rank joined
     through `parallel.launch.initialize` (NCCL): (a) the sharded pose graph,
     dense on phase 7's loop graph (equal bit for bit to the single-device
     solve) and "gather" and "pcg" on the 1,280-row graph of the
     1,100-keyframe map at 3 LM iterations; (b) the sharded BA, dense on the
     loop's problem and PCG on the 1,100-pose problem at 3 LM iterations,
     both within 1e-3 m and a cost rtol of 1e-3 of the single-device
     solvers; (c) the sharded map queries on the 1,100-keyframe map, equal to
     the dense ones; (d) the sharded loop verification of that map's
     candidates against serial `verify_candidate`; (e) `run_segments` at
     `SlamConfig()` over 4 segments of 8 frames of one arc, equal bit for
     bit to the segments run one after another, with its frames/s, DoH
     launches and `join_segments`; (f) the launcher's three benches (2 reps)
     and `python -m radarslampy_tpu_torch.parallel.launch --spawn 1 --smoke`.
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
    busy = device_busy_us(events, t0, t1, skip=lambda e: e.name.startswith("slam_step"))
    return stages, (t1 - t0) / 1e3, busy / 1e3


def device_busy_us(events, t0=float("-inf"), t1=float("inf"), skip=lambda e: False):
    """The union of the device activity among profiler `events` inside
    [t0, t1], in us."""
    from torch.autograd import DeviceType

    spans = sorted((max(e.time_range.start, t0), min(e.time_range.end, t1)) for e in events
                   if e.device_type != DeviceType.CPU and not skip(e)
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
    return busy + (0 if cur is None else cur[1] - cur[0])


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
    the map grown in two stages, each timed; returns one dict per stage, and
    the trimmed map, its loop graph and its BA problem (phase 9 reuses them)."""
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
    return stages, dict(map=mt, graph=graph, problem=problem)


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


# Phase 8: two turns of phase 7's circle (LOOP_PER_TURN frames a turn,
# LOOP_CHORD m chords), the speed ramped up linearly over the first EVAL_RAMP
# frames: from rest, a first 2.2 m step (8.8 m/s of motion distortion against
# the step's zero velocity prior) leaves the inlier count at the
# min_inliers_accept gate, and whether that frame coasts is a toss-up.
EVAL_N, EVAL_RAMP, EVAL_SEED = 81, 4, 11
EVAL_CHUNK, EVAL_TAIL_CHUNK, EVAL_EVERY, EVAL_CKPT = 16, 13, 32, 48
EVAL_SMALL_N = 25
# Phase 8 (f), the card against the CPU over 25 frames, each carrying its own
# state: float-order differences of KLT and the renderer flip one inlier of
# the peeling now and then, and each flip moves the pose by centimetres
# (this phase printed 4.0e-2 m on an H100); the bound of
# tests/test_torch_sequence.py for two runs that each carry their own state,
# one Cartesian pixel of SlamConfig() and 1/512 rad.
EVAL_CARD_CPU_M, EVAL_CARD_CPU_RAD = 0.1728, 1.0 / 512
# the keys of the JAX CLI's JSON artifact (radarslampy_tpu/evaluation.py, `_artifact`)
EVAL_ARTIFACT_KEYS = (
    "gt_csv", "start", "count", "path_m", "world", "seed", "noise", "cart_size",
    "max_keyframes", "loop_method", "backend_every", "chunk_frames", "renderer", "platform",
    "frames", "fps", "n_keyframes", "ate_odometry_m", "n_online_loops", "n_loop_closures",
    "ate_keyframes_before_m", "ate_keyframes_after_m", "ate_keyframes_after_ba_m",
    "n_ba_landmarks", "n_ba_observations", "loop_edge_err_median_m", "loop_edge_err_p90_m",
    "n_loop_edges_bad", "mean_inliers", "frac_fit_ok", "n_retracks", "backend_error",
    "rpe_trans_pct", "rpe_rot_deg_100m", "heading_rmse_deg", "quantize", "reference_ate_m")
# EvalResult numbers that must repeat bit for bit (fps is a time)
EVAL_NUMBERS = ("frames", "ate_odometry", "n_keyframes", "n_loop_closures", "n_online_loops",
                "ate_keyframes_before", "ate_keyframes_after", "ate_keyframes_after_ba",
                "n_ba_landmarks", "n_ba_observations", "mean_inliers", "frac_fit_ok",
                "n_retracks", "loop_edge_err_median", "loop_edge_err_p90", "n_loop_edges_bad",
                "backend_error", "rpe_trans_pct", "rpe_rot_deg_100m", "heading_rmse_deg")


def eval_circle(n):
    """The phase-8 trajectory [n, 3], starting at the origin, heading 0."""
    import numpy as np

    radius = LOOP_CHORD / (2 * np.sin(np.pi / LOOP_PER_TURN))
    dth = 2 * np.pi / LOOP_PER_TURN * np.minimum(1.0, np.arange(1, n) / EVAL_RAMP)
    th = np.concatenate([[0.0], np.cumsum(dth)])
    return np.stack([radius * np.sin(th), radius * (1 - np.cos(th)), th], 1)


def evals_equal(torch, a, b):
    """Two EvalResults equal bit for bit: per-frame estimates, GT keyframes,
    every number but fps, and every leaf of the final state."""
    import numpy as np

    return (np.array_equal(a.est_frames, b.est_frames)
            and all(getattr(a, f) == getattr(b, f) for f in EVAL_NUMBERS)
            and (a.gt_keyframes is None) == (b.gt_keyframes is None)
            and (a.gt_keyframes is None or np.array_equal(a.gt_keyframes, b.gt_keyframes))
            and states_equal(torch, a.final_state, b.final_state))


def render_times(torch, cfg, poses, n=30):
    """Phase 8 (e): one frame of the device renderer in each mode at `cfg`,
    with the eval's noise: ms per call from CUDA events around single calls
    (median of n, host work included), and the device's busy time per call
    from torch.profiler over n calls."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from radarslampy_tpu_torch import evaluation as ev
    from radarslampy_tpu_torch.sim import fakedata as fd
    from radarslampy_tpu_torch.sim.render_device import render_polar_scan_device

    wp, wr = fd.make_world_corridor(np.random.default_rng(EVAL_SEED), poses,
                                    cfg.max_range_clip_m)
    wp = torch.as_tensor(wp, dtype=torch.float32, device="cuda")
    wr = torch.as_tensor(wr, dtype=torch.float32, device="cuda")
    pose = torch.as_tensor(poses[10], dtype=torch.float32, device="cuda")
    vel = torch.tensor([8.8, 0.0, 0.63], device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(ev.frame_seed(EVAL_SEED, 10))
    out = {}
    for mode in ("max", "sum"):
        def call():
            return render_polar_scan_device(wp, wr, pose, vel, gen, cfg, noise=0.02, mode=mode)

        ms = time_ms(call, reps=n)
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                call()
            torch.cuda.synchronize()
        out[mode] = (ms, device_busy_us(prof.events()) / 1e3 / n)
    return out


def eval_phase(torch, cfg, tmp):
    """Phase 8 (a)-(d) and (f)-(g) on the card; returns what main() checks
    and prints."""
    from radarslampy_tpu_torch import evaluation as ev
    from radarslampy_tpu_torch.ops.cuda import doh_cuda
    from radarslampy_tpu_torch.sim import oxford_files
    from radarslampy_tpu_torch.utils.checkpoint import load_meta

    poses = eval_circle(EVAL_N)
    kw = dict(seed=EVAL_SEED, noise=0.02, return_state=True)
    backend = dict(run_backend=True, run_ba=True, backend_every=EVAL_EVERY)
    ck, snap = f"{tmp}/eval_ck", f"{tmp}/eval_ck_copy"
    doh_cuda.launches = 0
    t = time.time()
    full = ev.evaluate_sequence(poses, cfg, chunk_frames=EVAL_CHUNK, renderer="max",
                                ckpt_dir=ck, ckpt_every=EVAL_CKPT, **backend, **kw)
    wall_s = time.time() - t
    launches = doh_cuda.launches
    out = dict(full=full, wall_s=wall_s, launches=launches)

    # (b) resume from the checkpoint (a) left, and a refusal under another seed
    shutil.copytree(ck, snap)
    out["ckpt_meta"] = load_meta(ck)
    out["resumed"] = ev.evaluate_sequence(poses, cfg, chunk_frames=EVAL_CHUNK, renderer="max",
                                          ckpt_dir=snap, ckpt_every=EVAL_CKPT, resume=True,
                                          **backend, **kw)
    try:
        ev.evaluate_sequence(poses, cfg, chunk_frames=EVAL_CHUNK, ckpt_dir=snap, resume=True,
                             seed=EVAL_SEED + 1)
        out["refused"] = False
    except ValueError as exc:
        out["refused"] = "refusing to resume" in str(exc)

    # (c) chunk invariance without the back-end, (d) the sum renderer
    out["c16"] = ev.evaluate_sequence(poses, cfg, chunk_frames=EVAL_CHUNK, **kw)
    out["c13"] = ev.evaluate_sequence(poses, cfg, chunk_frames=EVAL_TAIL_CHUNK, **kw)
    out["sum"] = ev.evaluate_sequence(poses, cfg, chunk_frames=EVAL_CHUNK, renderer="sum", **kw)

    # (f) the card against the CPU at a small config, noise 0
    small = eval_small_config()
    out["small"] = {dev: ev.evaluate_sequence(poses[:EVAL_SMALL_N], small, seed=EVAL_SEED,
                                              noise=0.0, chunk_frames=EVAL_CHUNK,
                                              return_state=True, device=dev)
                    for dev in ("cuda", "cpu")}

    # (g) the CLI on a GT csv written for the circle's first 49 frames
    oxford_files.write_sequence(tmp, "eval", poses, cfg)
    art_path = f"{tmp}/eval.json"
    cli = ev.main(["--gt-csv", f"{tmp}/eval/gt/radar_odometry.csv", "--count", "49",
                   "--chunk-frames", str(EVAL_CHUNK), "--backend", "--ba", "--backend-every",
                   str(EVAL_EVERY), "--seed", str(EVAL_SEED), "--progress-every", "0",
                   "--matmul-precision", "highest", "--out", art_path])
    with open(art_path) as f:
        out["cli"], out["artifact"] = cli, json.load(f)
    return out


def eval_small_config():
    from radarslampy_tpu_torch.config import SlamConfig

    return SlamConfig(**dict(SMALL, max_keyframes=64))


def eval_checks(torch, cfg, card):
    """Phase 8: drives `eval_phase` and `render_times`, logs and checks what
    they return; returns the DoH launches of the eval's main run (a)."""
    import numpy as np

    with tempfile.TemporaryDirectory() as tmp:
        ev8 = eval_phase(torch, cfg, tmp)
    full, eval_launches = ev8["full"], ev8["launches"]
    log(f"eval (a): evaluate_sequence(chunk_frames={EVAL_CHUNK}, renderer='max', noise 0.02, "
        f"backend_every={EVAL_EVERY}, run_ba, ckpt_every={EVAL_CKPT}) over {full.frames} frames "
        f"in {ev8['wall_s']:.2f} s: fps {full.fps:.3f} ({1e3 / full.fps:.2f} ms/frame) on "
        f"{card}; odometry ATE {full.ate_odometry:.4f} m, RPE {full.rpe_trans_pct} % and "
        f"{full.rpe_rot_deg_100m} deg/100 m, heading RMSE {full.heading_rmse_deg:.4f} deg; "
        f"keyframes {full.n_keyframes}; loops online {full.n_online_loops}, post hoc "
        f"{full.n_loop_closures}; loop edge error median {full.loop_edge_err_median} m, p90 "
        f"{full.loop_edge_err_p90} m, {full.n_loop_edges_bad} over 1 m; keyframe ATE "
        f"{full.ate_keyframes_before} m (map), {full.ate_keyframes_after} m (pose graph), "
        f"{full.ate_keyframes_after_ba} m (BA over {full.n_ba_landmarks} landmarks, "
        f"{full.n_ba_observations} observations); health: mean inliers {full.mean_inliers:.2f}, "
        f"fit_ok {full.frac_fit_ok:.4f}, retracks {full.n_retracks}; backend_error "
        f"{full.backend_error}; doh launches {eval_launches}; checkpoint meta {ev8['ckpt_meta']}")
    if full.backend_error is not None or not (full.n_online_loops >= 1
                                              and full.n_loop_closures >= 1):
        raise AssertionError(f"eval (a): no loop closed or the back-end failed: "
                             f"{full.backend_error}")
    if not (np.isfinite(full.est_frames).all() and full.ate_odometry < 5.0
            and full.frames == EVAL_N and full.est_frames.shape == (EVAL_N, 3)
            and np.isfinite([full.ate_keyframes_before, full.ate_keyframes_after,
                             full.ate_keyframes_after_ba, full.rpe_trans_pct]).all()
            and eval_launches >= 1):
        raise AssertionError("eval (a): non-finite or lost estimates, or no DoH launch")
    res_b = ev8["resumed"]
    same_b = evals_equal(torch, res_b, full)
    log(f"eval (b): resumed at frame {ev8['ckpt_meta']['next_t']} == (a) bit for bit "
        f"(estimates, GT keyframes, every EvalResult number, every state leaf): {same_b}; "
        f"another seed refused: {ev8['refused']}")
    if not (same_b and ev8["refused"] and ev8["ckpt_meta"]["next_t"] == EVAL_CKPT + 1):
        raise AssertionError("eval (b): the resume differs from the straight run, or a "
                             "mismatched seed was not refused")
    c16, c13 = ev8["c16"], ev8["c13"]
    same_c = evals_equal(torch, c16, c13)
    log(f"eval (c): chunks of {EVAL_CHUNK} and {EVAL_TAIL_CHUNK} (padded tail), no back-end: "
        f"equal bit for bit {same_c}; ATE {c16.ate_odometry:.4f} m, fps {c16.fps:.3f} and "
        f"{c13.fps:.3f} ({1e3 / c16.fps:.2f} and {1e3 / c13.fps:.2f} ms/frame)")
    if not same_c:
        raise AssertionError("eval (c): chunk 16 and chunk 13 differ")
    rs = ev8["sum"]
    sum_bound = max(2 * c16.ate_odometry, 1.0)
    log(f"eval (d): renderer 'sum': ATE {rs.ate_odometry:.4f} m (bound {sum_bound:.4f} m), "
        f"fps {rs.fps:.3f} ({1e3 / rs.fps:.2f} ms/frame), keyframes {rs.n_keyframes}")
    if not rs.ate_odometry < sum_bound:
        raise AssertionError(f"eval (d): the sum renderer's ATE {rs.ate_odometry} m is over "
                             f"{sum_bound} m")
    rt = render_times(torch, cfg, eval_circle(EVAL_N))
    log("eval (e): one frame of render_polar_scan_device at SlamConfig() with noise: " + "; ".join(
        f"'{m}' {ms:.4f} ms per call (CUDA events, host work included), {dev_ms:.4f} ms of "
        f"device activity (torch.profiler)" for m, (ms, dev_ms) in rt.items())
        + f"; the eval's step: {1e3 / c16.fps:.2f} ms/frame (c)")
    sa, sb = ev8["small"]["cuda"], ev8["small"]["cpu"]
    d = np.abs(sa.est_frames - sb.est_frames)
    flags_f = (sa.n_keyframes == sb.n_keyframes and sa.n_retracks == sb.n_retracks
               and torch.equal(sa.final_state.map.frame_ids.cpu(), sb.final_state.map.frame_ids))
    log(f"eval (f): small config, {EVAL_SMALL_N} frames, noise 0, card vs CPU: keyframe flags "
        f"equal {flags_f}, max diff {d[:, :2].max():.2e} m, {d[:, 2].max():.2e} rad (bounds "
        f"{EVAL_CARD_CPU_M} m, {EVAL_CARD_CPU_RAD:.2e} rad)")
    if not (flags_f and d[:, :2].max() <= EVAL_CARD_CPU_M and d[:, 2].max() <= EVAL_CARD_CPU_RAD):
        raise AssertionError("eval (f): card and CPU evals disagree at the small config")
    art, cli = ev8["artifact"], ev8["cli"]
    missing = [k for k in EVAL_ARTIFACT_KEYS if k not in art]
    log(f"eval (g): CLI over {art['frames']} frames: platform {art['platform']} "
        f"({art['device_name']}), fps {art['fps']}, ATE {art['ate_odometry_m']} m, loops "
        f"{art['n_online_loops']} online / {art['n_loop_closures']}, keyframe ATE "
        f"{art['ate_keyframes_before_m']} -> {art['ate_keyframes_after_m']} -> "
        f"{art['ate_keyframes_after_ba_m']} m; JAX artifact keys missing: {missing}")
    if missing or art["platform"] != "cuda" or art["frames"] != cli.frames \
            or art["backend_error"] is not None:
        raise AssertionError(f"eval (g): artifact {art}")
    return eval_launches

# Phase 9: the distributed back-end (parallel/) on the card at world 1 (NCCL
# takes one rank per GPU), on phase 7's graphs, BA problems and map.  (a)-(b)
# run the iterative solvers at PAR_ITERS LM iterations; their bounds against
# the single-device solvers are those of the JAX package's tests/test_parallel.py
# (poses 1e-3 m, cost rtol 1e-3 / atol 1e-4).  A world of one pads nothing, so
# the dense solves must be equal bit for bit, and only a padded edge list (which
# reorders a sum) may differ, by PAR_PAD_RTOL.
PAR_ITERS = 3
PAR_M, PAR_COST_RTOL, PAR_COST_ATOL, PAR_PAD_RTOL = 1e-3, 1e-3, 1e-4, 1e-6
PAR_REL = 1e-5          # (d) rel_pose against serial verify_candidate
PAR_SEGMENTS, PAR_SEG_FRAMES, PAR_SEED = 4, 8, 6   # (e) segments overlapping by one frame
PAR_SMOKE_S = 180       # (f) the launcher subprocess's time limit


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def pose_diff(a, b):
    """Largest |a - b| over rows of poses [M, 3], as (x, y, theta)."""
    return (a - b).abs().max(0).values.tolist()


def cost_close(c, ref):
    return abs(float(c) - float(ref)) <= PAR_COST_RTOL * abs(float(ref)) + PAR_COST_ATOL


def parallel_solvers(torch, cfg, mesh, loop_map, scale):
    """Phase 9 (a)-(b): the sharded pose graph and BA against the
    single-device solvers; returns one dict per comparison."""
    import dataclasses

    from radarslampy_tpu_torch.models.ba import build_ba_problem, optimize_ba, reseed_map
    from radarslampy_tpu_torch.models.loopclosure import close_loops
    from radarslampy_tpu_torch.models.posegraph import optimize_pose_graph
    from radarslampy_tpu_torch.parallel.dist_ba import optimize_ba_sharded
    from radarslampy_tpu_torch.parallel.dist_posegraph import optimize_pose_graph_sharded
    from radarslampy_tpu_torch.parallel.mesh import axis_size

    out = []
    g_loop, _ = close_loops(loop_map, cfg)
    (rp, rc), ms_ref = timed(torch, lambda: optimize_pose_graph(g_loop, cfg, method="dense"))
    (gp, gc), ms = timed(torch, lambda: optimize_pose_graph_sharded(g_loop, cfg, mesh, "dense"))
    padded = g_loop.edges_ij.shape[0] % axis_size(mesh) != 0
    rel = float(((gp - rp).abs() / rp.abs().clamp(min=1e-30)).max())
    equal = torch.equal(gp, rp) and torch.equal(gc, rc)
    out.append(dict(part="a", solver="pose graph dense", rows=g_loop.poses.shape[0],
                    edges=g_loop.edges_ij.shape[0], padded=padded, equal=equal, max_rel=rel,
                    ms=ms, single_ms=ms_ref,
                    ok=equal or (padded and rel <= PAR_PAD_RTOL)))

    cfg3 = dataclasses.replace(cfg, pg_iterations=PAR_ITERS)
    g = scale["graph"]
    st = {}
    (rp3, rc3), ms_ref = timed(torch, lambda: optimize_pose_graph(g, cfg3, method="pcg", stats=st))
    for method in ("gather", "pcg"):
        sm = {}
        (p3, c3), ms = timed(torch, lambda: optimize_pose_graph_sharded(g, cfg3, mesh, method, sm))
        d = pose_diff(p3, rp3)
        out.append(dict(part="a", solver=f"pose graph {method}", rows=g.poses.shape[0],
                        edges=g.edges_ij.shape[0], cg_sweeps=sm["cg_sweeps"],
                        single_cg_sweeps=st["cg_sweeps"], max_diff=d, cost=float(c3),
                        single_cost=float(rc3), equal=torch.equal(p3, rp3), ms=ms,
                        single_ms=ms_ref, ms_per_sweep=ms / max(sm["cg_sweeps"], 1),
                        single_ms_per_sweep=ms_ref / max(st["cg_sweeps"], 1),
                        ok=max(d) <= PAR_M and cost_close(c3, rc3)))

    M = int(loop_map.cursor)
    p_loop = build_ba_problem(reseed_map(loop_map, rp[:M].cpu().numpy()), min_views=2)
    p_big = scale["problem"]
    for name, p, method, c in (("loop", p_loop, "dense", cfg), ("scale", p_big, "pcg", cfg3)):
        st, sm = {}, {}
        (rpo, rl, rc), ms_ref = timed(torch, lambda: optimize_ba(p, c, method=method, stats=st))
        (bpo, bl, bc), ms = timed(torch, lambda: optimize_ba_sharded(p, c, mesh, method=method,
                                                                     stats=sm))
        L = rl.shape[0]
        d = pose_diff(bpo, rpo) + [float((bl[:L] - rl).abs().max())]
        out.append(dict(part="b", solver=f"BA {method} ({name})", poses=p.poses.shape[0],
                        landmarks=int(p.lm_mask.sum()), observations=int(p.obs_mask.sum()),
                        cg_sweeps=sm["cg_sweeps"], single_cg_sweeps=st["cg_sweeps"],
                        max_diff=d, cost=float(bc), single_cost=float(rc),
                        equal=torch.equal(bpo, rpo) and torch.equal(bl[:L], rl), ms=ms,
                        single_ms=ms_ref, ok=max(d) <= PAR_M and cost_close(bc, rc)))
    return out


def parallel_queries(torch, cfg, mesh, m):
    """Phase 9 (c)-(d): the sharded map queries against the dense ones and the
    sharded verification against serial `verify_candidate`, on map `m`."""
    from radarslampy_tpu_torch.models.loopclosure import (candidate_budget, find_candidates,
                                                          verify_candidate)
    from radarslampy_tpu_torch.models.placerecog import find_candidates_appearance
    from radarslampy_tpu_torch.ops.features import top_k_stable
    from radarslampy_tpu_torch.parallel import dist_verify, sharded_map
    from radarslampy_tpu_torch.parallel.mesh import axis_size

    out = {}
    M, rows = int(m.cursor), m.poses.shape[0]
    C = candidate_budget(M)
    q = m.poses[M - 1]
    idx = torch.arange(rows, device=q.device)
    d = m.poses[:, :2] - q[:2]
    d = torch.where((idx < M) & (idx < M - 20), torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]),
                    float("inf"))
    vals, order = top_k_stable(-d, 16)
    (ni, nd, nv), ms = timed(torch, lambda: sharded_map.nearest_keyframes(
        m, q, 16, mesh, exclude_after=M - 20))
    out["nearest"] = dict(equal=torch.equal(ni, order) and torch.equal(nd, -vals)
                          and torch.equal(nv, torch.isfinite(vals)), ms=ms, found=int(nv.sum()))
    dense_a, ms_d = timed(torch, lambda: find_candidates_appearance(
        m.descriptors, m.cursor, C, min_index_gap=20, max_distance=cfg.sc_max_distance))
    got_a, ms = timed(torch, lambda: sharded_map.appearance_candidates_sharded(
        m, mesh, C, min_index_gap=20, max_distance=cfg.sc_max_distance))
    out["appearance"] = dict(equal=all(torch.equal(a, b) for a, b in zip(got_a, dense_a)),
                             ms=ms, dense_ms=ms_d, valid=int(got_a.valid.sum()))
    (pts, mask), ms = timed(torch, lambda: sharded_map.global_map_points(
        sharded_map.shard_map_state(m, mesh), mesh))
    live = ((idx < M)[:, None] & m.feat_mask).reshape(-1)
    n = live.shape[0]
    out["points"] = dict(equal=torch.equal(pts[:n], m.feat_world.reshape(-1, 2))
                         and torch.equal(mask[:n], live) and not bool(mask[n:].any()),
                         ms=ms, points=int(mask.sum()))

    c = find_candidates(m.poses, m.cursor, C, radius_m=10.0, min_index_gap=20)
    rot = torch.full((C,), float("nan"), device=q.device)
    padded = dist_verify.pad_candidates(c.i, c.j, c.valid, rot, axis_size(mesh))
    got, ms = timed(torch, lambda: dist_verify.verify_candidates_sharded(m, *padded, cfg, mesh))
    serial, ms_s = timed(torch, lambda: verify_candidate(m, c.i, c.j, cfg, rot_override=rot))
    ok_s = serial.ok & c.valid
    ok = got.ok[:C]
    rel = float((got.rel_pose[:C] - serial.rel_pose)[ok_s].abs().max()) if bool(ok_s.any()) else 0.0
    out["verify"] = dict(candidates=C, valid=int(c.valid.sum()), loops=int(ok.sum()),
                         ok_equal=torch.equal(ok, ok_s) and not bool(got.ok[C:].any()),
                         max_rel_diff=rel, ms=ms, serial_ms=ms_s)
    return out


def parallel_segments(torch, cfg, mesh, maps):
    """Phase 9 (e): `run_segments` over PAR_SEGMENTS segments of one rendered
    arc (each PAR_SEG_FRAMES frames, overlapping by one) against the
    segments run one after another by the port's step; DoH launches of
    `run_segments`, its frames/s, and `join_segments` against the arc."""
    import numpy as np

    from radarslampy_tpu_torch.models import frontend as F
    from radarslampy_tpu_torch.ops.cuda import doh_cuda
    from radarslampy_tpu_torch.parallel import batch_odometry as bo

    step = PAR_SEG_FRAMES - 1
    gt, frames = render_frames(cfg, 1 + PAR_SEGMENTS * step, seed=PAR_SEED)
    seg = torch.as_tensor(np.stack([frames[k * step:k * step + PAR_SEG_FRAMES]
                                    for k in range(PAR_SEGMENTS)]), device="cuda")
    doh_cuda.launches = 0
    poses, s_batched = timed(torch, lambda: bo.run_segments(seg, maps, cfg, mesh))
    launches = doh_cuda.launches

    def sequential():
        out = np.zeros((PAR_SEGMENTS, PAR_SEG_FRAMES, 3), np.float32)
        for d in range(PAR_SEGMENTS):
            state = F.init_state(seg[d, 0], np.zeros(3), maps, cfg)
            for t in range(1, PAR_SEG_FRAMES):
                state, o = F.slam_step(state, seg[d, t], maps, cfg)
                out[d, t] = o.pose.cpu().numpy()
        return out

    seq, s_seq = timed(torch, sequential)
    joined = bo.join_segments(list(poses))
    err = np.linalg.norm(joined[:, :2] - gt[:, :2], axis=1)
    # each segment against the arc seen from its first frame: the error after
    # its first step and at its end
    seg_err = []
    for d in range(PAR_SEGMENTS):
        g = gt[d * step:d * step + PAR_SEG_FRAMES]
        c, sn = np.cos(g[0, 2]), np.sin(g[0, 2])
        dx, dy = g[:, 0] - g[0, 0], g[:, 1] - g[0, 1]
        e = np.hypot(poses[d, :, 0] - (c * dx + sn * dy), poses[d, :, 1] - (-sn * dx + c * dy))
        seg_err.append((round(float(e[1]), 4), round(float(e[-1]), 4)))
    n_steps = PAR_SEGMENTS * step
    return dict(equal=bool(np.array_equal(poses, seq)), finite=bool(np.isfinite(poses).all()),
                launches=launches, fps=n_steps / (s_batched / 1e3),
                sequential_fps=n_steps / (s_seq / 1e3), joined=joined, ate=float(
                    np.sqrt((err ** 2).mean())), drift=float(err[-1]), frames=len(joined),
                seg_err=seg_err)


def parallel_launcher(torch, mesh):
    """Phase 9 (f): the three benches in this process (reps=2), then the
    launcher's smoke as a subprocess (its own world of one, NCCL)."""
    import os
    import signal

    import numpy as np

    from radarslampy_tpu_torch.parallel import launch

    out = {}
    times, n = launch.bench_verify_mp(mesh, reps=2)
    out["verify"] = (launch._stats(times), f"{n} verifications")
    for method in ("gather", "pcg"):
        times, cost = launch.bench_posegraph_mp(mesh, method=method, reps=2)
        out[f"posegraph_{method}"] = (launch._stats(times), f"cost {cost:.6g}")
    times, frames = launch.bench_odometry_mp(mesh, reps=2)
    out["odometry"] = (launch._stats(times), f"{frames} frames, "
                       f"{frames / np.median(times):.3f} frames/s")
    t = time.time()
    p = subprocess.Popen([sys.executable, "-m", "radarslampy_tpu_torch.parallel.launch",
                          "--spawn", "1", "--smoke", "--coordinator", f"localhost:{free_port()}"],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         start_new_session=True)
    try:
        text, _ = p.communicate(timeout=PAR_SMOKE_S)
    finally:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        p.wait()
    res = None
    for line in reversed(text.strip().splitlines()):
        if line.startswith("{"):
            res = json.loads(line)
            break
    out["smoke"] = dict(rc=p.returncode, result=res, s=time.time() - t,
                        tail=text.strip().splitlines()[-5:])
    return out


def parallel_checks(torch, cfg, card, loop_state, scale, maps):
    """Phase 9: drives the parts above in a world of one rank joined through
    `launch.initialize` (NCCL), logs and checks what they return; returns the
    DoH launches of (e)'s `run_segments`."""
    import torch.distributed as dist

    from radarslampy_tpu_torch.models.loopclosure import trim_map_state
    from radarslampy_tpu_torch.parallel import launch
    from radarslampy_tpu_torch.parallel.mesh import make_mesh

    t0 = time.time()
    launch.initialize(f"localhost:{free_port()}", 1, 0)
    try:
        mesh = make_mesh()
        log(f"parallel: world {dist.get_world_size()}, backend {dist.get_backend()}, mesh "
            f"{mesh.mesh_dim_names} {tuple(mesh.shape)} on {mesh.device_type}")
        solvers = parallel_solvers(torch, cfg, mesh, trim_map_state(loop_state.map), scale)
        queries = parallel_queries(torch, cfg, mesh, scale["map"])
        segs = parallel_segments(torch, cfg, mesh, maps)
        benches = parallel_launcher(torch, mesh)
    finally:
        dist.destroy_process_group()
    for r in solvers:
        log(f"parallel ({r['part']}) " + ", ".join(
            f"{k} {v:.4g}" if isinstance(v, float) else
            f"{k} {[float(f'{x:.3g}') for x in v]}" if isinstance(v, list) else f"{k} {v}"
            for k, v in r.items() if k != "part") + f" (ms: synchronised host ms on {card})")
    bad = [r["solver"] for r in solvers if not r["ok"]]
    if bad:
        raise AssertionError(f"parallel (a)/(b): sharded solvers off the single-device ones: {bad}")
    if not solvers[0]["equal"]:
        log(f"parallel (a): the dense solve differs from the single-device one by "
            f"{solvers[0]['max_rel']:.3g} relative: the edge list was padded to a multiple of "
            f"the mesh, which reorders the normal equations' sums")
    for k, v in queries.items():
        log(f"parallel ({'d' if k == 'verify' else 'c'}) {k}: " + ", ".join(
            f"{a} {b:.4g}" if isinstance(b, float) else f"{a} {b}" for a, b in v.items()))
    if not all(queries[k]["equal"] for k in ("nearest", "appearance", "points")):
        raise AssertionError("parallel (c): a sharded map query differs from the dense one")
    v = queries["verify"]
    if not (v["ok_equal"] and v["max_rel_diff"] <= PAR_REL and v["loops"] >= 1):
        raise AssertionError(f"parallel (d): sharded verification off serial: {v}")
    log(f"parallel (e): run_segments, {PAR_SEGMENTS} segments x {PAR_SEG_FRAMES} frames at "
        f"SlamConfig(): equal bit for bit to the segments run one after another "
        f"{segs['equal']}; {segs['fps']:.3f} frames/s (sequential {segs['sequential_fps']:.3f}) "
        f"on {card}; doh launches {segs['launches']}; join_segments: {segs['frames']} frames, "
        f"ATE {segs['ate']:.4f} m against the arc, end drift {segs['drift']:.4f} m, last pose "
        f"{[round(float(x), 4) for x in segs['joined'][-1]]}; each segment's error (m) after its "
        f"first step and at its end, against the arc from its first frame: {segs['seg_err']}")
    if not (segs["equal"] and segs["finite"] and segs["launches"] >= PAR_SEGMENTS):
        raise AssertionError("parallel (e): run_segments differs from the sequential runs or "
                             "launched fewer DoH kernels than segments")
    sm = benches.pop("smoke")
    for k, (st, what) in benches.items():
        log(f"parallel (f) bench {k}: median {st['median_s']} s (min {st['min_s']}, max "
            f"{st['max_s']}, reps {st['reps']}), {what} (on {card})")
    log(f"parallel (f) launch --spawn 1 --smoke: exit {sm['rc']} in {sm['s']:.1f} s, "
        f"{sm['result']}")
    if not (sm["rc"] == 0 and sm["result"] and sm["result"]["psum"] == 1.0
            and sm["result"]["collectives"] == "nccl"):
        raise AssertionError(f"parallel (f): the launcher's smoke failed: {sm['tail']}")
    log(f"parallel: phase 9 in {time.time() - t0:.1f} s")
    return segs["launches"]


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
    stages, scale = solver_stages(torch, cfg, big, big_gt)
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

    # 8. the evaluation harness at SlamConfig(), scans rendered on the card
    eval_launches = eval_checks(torch, cfg, card)

    # 9. the distributed back-end at world 1, on phase 7's loop and map
    batch_launches = parallel_checks(torch, cfg, card, bk["res"].final_state, scale, maps)

    doh_row["launches"] = (launches + driver_launches + fmt_launches + bk["launches"]
                           + eval_launches + batch_launches)
    doh_row["launches_by_path"] = {"step": launches, "driver": driver_launches,
                                   "fmt_step": fmt_launches, "backend_driver": bk["launches"],
                                   "eval": eval_launches, "batch_odometry": batch_launches}
    print(card_line(), flush=True)
    print(json.dumps({"kernels": [doh_row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
