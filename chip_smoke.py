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
     build_frame_maps -> init_state -> slam_step per frame (eager), then the
     same frames through slam_step_chunk (the step's CUDA graph, captured
     before the counts are reset, replayed a frame); launch counts (one DoH
     launch a frame: the step detects on every frame and selects), drift
     against the rendered ground truth, chunk == per-frame; then the chunk
     at a small config on the card and on the CPU, which must agree;
  5. the driver: `RadarSlamSystem(...).run()` at `SlamConfig()` over phase
     4's frames, fed through `frame_source` from a sequence directory that
     holds radar.timestamps and a GT CSV (phase 10 runs it over PNGs); its
     trajectory and final state (the driver replays the step's graph) equal
     phase 4's eager loop bit for bit;
     a run checkpointed at frame 6 and resumed equals the straight run bit
     for bit; the metrics JSONL; ATE, drift and fps; then the eager step
     from the checkpointed state under torch.profiler, whose
     `record_function` ranges inside slam_step give each stage's host and
     device time and the step's device idle share;
  6. FMT: `SlamConfig(use_fmt=True)` at full width on a pure turn, its
     rotation against the rendered turn, one FMT step profiled; then the
     FMT step at a small config on the card and on the CPU, which must agree;
  7. the back-end: (a) `run(optimize=True, ba=True, backend_every=24)` at
     `SlamConfig()` over 49 frames of a rendered circle that returns to its
     start (40 frames a turn, 2.2 m chords), fed through `frame_source`: at
     least one loop closed online and one post hoc, the keyframe error
     against GT of the map, the pose graph and BA, fps, the post-hoc pass
     timed alone on the host with its dense LM captured (one CUDA graph of an
     LM iteration, replayed) and eager (`replay=False`), equal bit for bit,
     DoH launches; a second run equal to the first bit for bit on every
     RunResult array and state leaf; (b) the solvers on
     a synthetic map in `SlamConfig()`'s shapes (capacity 4096, K 256, P 512,
     16 x 80 descriptors) with 1,100 live keyframes and 12 planted revisits:
     `close_loops` ("both"), the pose graph ("auto": PCG at 1,280 rows), BA
     ("auto": PCG at 1,100 poses) and two online passes over the map grown to
     600 and then 1,100 keyframes, each timed (synchronised host ms) with its
     candidates, loops, CG sweeps and mean keyframe error before and after;
     the 600-keyframe pass (a dense pose graph at 1,024 rows) runs again with
     its dense LM eager: equal bit for bit, one capture and `pg_iterations` -
     1 replays, with both ms and the capture ms;
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
     through `parallel.launch.initialize` (NCCL), with the NCCL version and
     the NCCL variables set: (a) the sharded pose graph, dense on phase 7's
     loop graph (equal bit for bit to the single-device solve; both captured
     and eager, each captured run equal bit for bit to its eager one, with
     their ms, captures, replays and capture ms) and "gather"
     and "pcg" on the 1,280-row graph of the 1,100-keyframe map at 3 LM
     iterations; (b) the sharded BA, dense on the loop's problem (captured and
     eager, single-device and sharded, as in (a)) and PCG on
     the 1,100-pose problem at 3 LM iterations, each within 1e-3 m and a
     cost rtol of 1e-3 of the single-device solvers; the sharded PCG pose
     graph and BA (their sweeps replayed from a CUDA graph holding the
     all-reduce) equal bit for bit to their eager sharded sweeps
     (`replay=False`) and to the single-device PCG, with the ms a sweep of
     all three, the sweeps, captures and capture ms; then one LM iteration
     of both, 4 checks' sweeps, traced captured and eager: every replay has
     its device events, and the replays launch as many NCCL all-reduce
     kernels a sweep as the eager window's all-reduces a call (logged with
     their names; none at one rank, where NCCL launches no kernel for an
     in-place sum); (c) the sharded map queries on the 1,100-keyframe map,
     equal to the dense ones; (d) the sharded loop verification of that map's
     candidates against serial `verify_candidate`; (e) `run_segments` at
     `SlamConfig()` over 4 segments of 8 frames of one arc, as one batch (the
     batched step's CUDA graph), equal bit for bit to the segments run one
     after another by the eager step (or within phase 13's rule), with its
     frames/s, DoH launches (one a frame for the 4) and `join_segments`; (f)
     the launcher's three benches (2 reps) and `python -m
     radarslampy_tpu_torch.parallel.launch --spawn 1 --smoke`;
 10. the PNG path at `SlamConfig()`: (a) the host's g++, libpng headers,
     native loader (with g++'s first error line where it does not build),
     PIL, matplotlib and ffmpeg; (b) phase 4's frames written as Oxford PNGs
     (`sim/oxford_files.write_sequence`); (c) each PNG decoded by the native
     decoder (where libpng exists) and by PIL, equal bit for bit to the
     written bytes and to each other, `NativeLoader`'s order, and the frames
     per second of `NativeLoader`, `_Prefetcher` and one-thread PIL over the
     same files; (d) `RadarSlamSystem(...).run()` over the PNGs, equal bit for
     bit to phase 5's run, with its decoder, fps and DoH launches; (e) the CLI
     over them in a subprocess: the JAX CLI's summary keys, (d)'s rmse; (f)
     `utils/profile_stages.profile()` with reduced counts (each stage's us,
     their sum, the fused step, the step with dispatch), a `StageTimer` over
     5 steps and a `device_trace` of one step holding CUDA kernel events;
     (g) `run(viz_dir, viz_every=3)`'s figures where matplotlib imports, else
     one line saying so;
 11. the bench (`radarslampy_tpu_torch.bench.run_bench`) in-process at
     `SlamConfig()` over 20 measured frames, one trial of each path and a
     traced window of 5 steps: its own checks (every path's final state and
     outputs equal bit for bit, equal counts, ATE under 5 m, a trace that
     lost no device events) raise on failure; its JSON object on a line of
     its own; each path's DoH launches equal to its frames;
 12. the step's CUDA graph (`frontend.StepGraph`) against the eager step,
     bit for bit (every output, the final state) over phase 4's arc with a
     scan of noise appended (a coast) and over phase 6's FMT turn, with the
     count of plain frames, keyframes, retracks and coasts among them; a
     chunk run under `torch.cuda.set_sync_debug_mode("error")`; a traced
     window of replays whose DoH kernels equal the launches counted; the
     graph's device ms a step (CUDA events around each replay, and the
     trace's busy time), host ms a replay and idle share beside the eager
     step's;
 13. the batched step (`frontend.StepGraph(maps, cfg, batch=4)`, the
     counterpart of the JAX package's `jit(vmap(slam_step))`) at
     `SlamConfig()` over 4 segments of phase 9 (e)'s arc: (a) the DoH kernel
     over [4, S, S] in one launch against four single launches (bit for
     bit), through vmap's batching rule, and against its twin; its device
     ms beside four single launches' and its bound; (b) the batched graph
     against 4 single StepGraphs stepped in turn, every packed row and
     final state bit for bit (or, where a batched library call changes
     bits, equal flags and poses within one Cartesian pixel and 1/512 rad),
     its DoH launches (one a frame for all 4), the batched state's bytes
     and the device memory it holds; (d) frames/s of the batched graph, of
     the 4 StepGraphs in turn, of the vmapped eager step and of the eager
     step in turn, warm, and a replay's ms by CUDA events; (c) a traced
     window of batched replays: DoH kernels traced == launches counted,
     busy ms a replay and idle share.
Then the card line again, one JSON line describing every kernel, and as the
last line `{"ok": true, "device": {...}}`.  Any failure raises and exits
non-zero; without a CUDA device, or without the package beside this file, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

T0 = time.time()

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


def profiler_ms(fn, kernel_name, n=20):
    """Mean device time of the kernel named `kernel_name` per fn() call, from
    torch.profiler's key_averages(); None when the trace shows no device time
    for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from radarslampy_tpu_torch.utils.profiling import device_us

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if kernel_name in ev.key:
            us = device_us(ev)
            if us > 0 and ev.count:
                return us / 1e3 / n
    return None


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
    from radarslampy_tpu_torch.utils.profiling import step_profile

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

    # the eager step from the checkpointed state (the driver replays the
    # graph, which has no ranges inside), traced and untraced
    at_ck, _ = load_state(snap, cfg, dev)
    frame = frames[CHECKPOINT_AT + 1]
    unprofiled = untraced_ms(torch, lambda: F.slam_step(at_ck, frame, system.maps, cfg), dev)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev == "cuda" else [])
    with profile(activities=activities) as prof:
        F.slam_step(at_ck, frame, system.maps, cfg)
        if dev == "cuda":
            torch.cuda.synchronize()
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
    from radarslampy_tpu_torch.utils.profiling import step_profile

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

    from radarslampy_tpu_torch.utils.checkpoint import state_leaves

    out = [np.asarray(a) for a in res.trajectory.as_arrays()]
    out += [np.asarray(getattr(res, f)) for f in ("kf_poses_optimized", "kf_poses_ba",
                                                  "landmarks_ba")]
    out += [np.asarray([res.posegraph_cost, res.ba_cost, res.n_loop_closures,
                        res.n_online_loops, res.n_keyframes, res.frames])]
    return out + [x.cpu().numpy() for x in state_leaves(res.final_state)]


@contextlib.contextmanager
def dense_lm_eager():
    """Inside: the driver's post-hoc pass (`models/system.py`) and the online
    pass (`models/loopclosure.incremental_backend`) call the pose graph and BA
    with `replay=False`, their dense LM iterations eager, for timing against
    the captured ones on the same inputs."""
    from radarslampy_tpu_torch.models import loopclosure, system

    saved = [(m, name, getattr(m, name)) for m, name in
             ((system, "optimize_pose_graph"), (system, "optimize_ba"),
              (loopclosure, "optimize_pose_graph"))]
    for m, name, fn in saved:
        setattr(m, name, functools.partial(fn, replay=False))
    try:
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def lm_stats(st, prefix=""):
    """`lm_iterations`' counts in `st`, named for a row (capture in ms)."""
    return {f"{prefix}lm_captures": st.get("lm_captures", 0),
            f"{prefix}lm_replays": st.get("lm_replays", 0),
            f"{prefix}lm_capture_ms": st.get("lm_capture_s", 0.0) * 1e3,
            f"{prefix}lm_replay_ms": st.get("lm_replay_s", 0.0) * 1e3}


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
    # the post-hoc pass alone, timed, on the final state of the first run:
    # its dense LM captured (as the driver runs it), then eager
    again, posthoc_ms = timed(torch, lambda: system.optimize_map(first.final_state, ba=True))
    with dense_lm_eager():
        eager, posthoc_eager_ms = timed(
            torch, lambda: system.optimize_map(first.final_state, ba=True))
    M = first.n_keyframes
    gt_kf = gt[first.final_state.map.frame_ids[:M].cpu().numpy()]
    errors = (kf_error(first.final_state.map.poses[:M].cpu().numpy(), gt_kf),
              kf_error(first.kf_poses_optimized, gt_kf), kf_error(first.kf_poses_ba, gt_kf))
    same = all(np.array_equal(a, b) for a, b in zip(run_arrays(first), run_arrays(second)))
    same_posthoc = (np.array_equal(again[0], first.kf_poses_optimized)
                    and np.array_equal(again[3], first.kf_poses_ba)
                    and again[1] == first.n_loop_closures)
    same_eager = all(np.array_equal(a, b) for a, b in zip(again, eager, strict=True))
    return dict(res=first, wall_s=wall_s, launches=launches, posthoc_ms=posthoc_ms,
                posthoc_eager_ms=posthoc_eager_ms, errors=errors, same=same,
                same_posthoc=same_posthoc, same_posthoc_eager=same_eager)


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

    import numpy as np

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
        state_in, bs_in = state, bs
        (state, n_new, cost, bs), ms = timed(
            torch, lambda: incremental_backend(state_in, cfg, backend_state=bs_in, stats=inc))
        row = dict(stage=f"online_pass_{n}", ms=ms, candidates=inc["candidates"],
                   loops=n_new, edges=len(bs.edges_ij), rows=1024 * -(-n // 1024),
                   solver=("pcg" if inc.get("cg_sweeps") else "dense") if n_new else None,
                   cg_sweeps=inc.get("cg_sweeps", 0), err_before=err0,
                   err_after=kf_error(state.map.poses[:n].cpu().numpy(), gt[:n]))
        if row["solver"] == "dense":   # the same pass again, its dense LM eager
            with dense_lm_eager():
                (e_state, e_new, e_cost, e_bs), row["eager_ms"] = timed(
                    torch, lambda: incremental_backend(state_in, cfg, backend_state=bs_in))
            row.update(lm_stats(inc), equal_eager=bool(
                torch.equal(e_state.map.poses, state.map.poses) and e_cost == cost
                and e_new == n_new and np.array_equal(e_bs.edges_ij, bs.edges_ij)))
        stages.append(row)
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

    from radarslampy_tpu_torch.utils.checkpoint import states_equal

    return (np.array_equal(a.est_frames, b.est_frames)
            and all(getattr(a, f) == getattr(b, f) for f in EVAL_NUMBERS)
            and (a.gt_keyframes is None) == (b.gt_keyframes is None)
            and (a.gt_keyframes is None or np.array_equal(a.gt_keyframes, b.gt_keyframes))
            and states_equal(a.final_state, b.final_state))


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
    from radarslampy_tpu_torch.utils.profiling import device_busy_us

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
# reorders a sum) may differ, by PAR_PAD_RTOL; the sharded PCG solves, captured
# and eager, must equal the single-device PCG bit for bit.  Their trace runs
# one LM iteration capped at PAR_TRACE_CHECKS checks' sweeps.
PAR_ITERS = 3
PAR_TRACE_CHECKS = 4
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


def sharded_pcg(torch, g, p, cfg, mesh, replay, stats_pg, stats_ba):
    """The sharded PCG pose graph (`g`) and BA (`p`) as their entry points run
    them (this rank's block, the mesh's hooks), with the solvers' `replay`;
    either problem may be None -> ((poses, cost), (poses, landmarks, cost))."""
    from radarslampy_tpu_torch.models.ba import _optimize_ba_pcg
    from radarslampy_tpu_torch.models.posegraph import _optimize_pose_graph_pcg
    from radarslampy_tpu_torch.parallel.dist_ba import _local_problem
    from radarslampy_tpu_torch.parallel.dist_posegraph import _local_edges
    from radarslampy_tpu_torch.parallel.mesh import all_gather, pmax, psum

    def red(x):
        return psum(x, mesh)

    pg = ba = None
    if g is not None:
        pg = _optimize_pose_graph_pcg(_local_edges(g, mesh), cfg, stats=stats_pg, reduce_fn=red,
                                      reduce_max_fn=lambda x: pmax(x, mesh), replay=replay)
    if p is not None:
        poses, lms, cost = _optimize_ba_pcg(_local_problem(p, mesh), cfg, stats=stats_ba,
                                            reduce_fn=red, replay=replay)
        ba = (poses, all_gather(lms, mesh), cost)
    return pg, ba


def cg_trace(torch, g, p, cfg, mesh):
    """Phase 9 (a)-(b): one LM iteration of the sharded PCG pose graph and BA,
    capped at PAR_TRACE_CHECKS checks' sweeps, under torch.profiler, captured
    and then eager (`replay=False`) -> (captured, eager): each
    `utils/profiling.collective_trace` of its window and the two solves'
    stats.  A lead-in of small kernels opens each window unread (a trace that
    follows others in a process can lose its first moments' device events)."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from radarslampy_tpu_torch.models.posegraph import SWEEPS_PER_CHECK
    from radarslampy_tpu_torch.utils.profiling import collective_trace

    short = dataclasses.replace(cfg, pg_iterations=1,
                                pg_cg_iterations=PAR_TRACE_CHECKS * SWEEPS_PER_CHECK)
    out = []
    for replay in (True, False):
        st_pg, st_ba = {}, {}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            lead = torch.zeros(1, device="cuda")
            for _ in range(20):
                lead.add_(1.0)
            torch.cuda.synchronize()
            sharded_pcg(torch, g, p, short, mesh, replay, st_pg, st_ba)
            torch.cuda.synchronize()
        out.append((collective_trace(prof.events()), st_pg, st_ba))
    return out


def parallel_solvers(torch, cfg, mesh, loop_map, scale):
    """Phase 9 (a)-(b): the sharded pose graph and BA against the
    single-device solvers, and the sharded PCG's captured sweeps against its
    eager ones; returns one dict per comparison, and the PCG trace."""
    import dataclasses

    from radarslampy_tpu_torch.models.ba import build_ba_problem, optimize_ba, reseed_map
    from radarslampy_tpu_torch.models.loopclosure import close_loops
    from radarslampy_tpu_torch.models.posegraph import SWEEPS_PER_CHECK, optimize_pose_graph
    from radarslampy_tpu_torch.parallel.dist_ba import optimize_ba_sharded
    from radarslampy_tpu_torch.parallel.dist_posegraph import optimize_pose_graph_sharded
    from radarslampy_tpu_torch.parallel.mesh import axis_size, psum

    # NCCL sets up its communicator at the group's first collective (about
    # half a second): here, outside the timed solves
    psum(torch.zeros(1, device=mesh.device_type), mesh)
    torch.cuda.synchronize()
    out = []

    def dense_runs(single, sharded):
        """`single(replay, stats)` and `sharded(replay, stats)` captured, then
        eager -> (their results, ms and stats, and the row's dense keys:
        each pair equal bit for bit, each captured once and replayed
        `pg_iterations` - 1 times, the eager runs never)."""
        runs = {}
        for name, solve in (("single", single), ("sharded", sharded)):
            for replay in (True, False):
                st = {}
                res, ms = timed(torch, lambda: solve(replay, st))
                runs[name, replay] = (res, ms, st)
        n = cfg.pg_iterations

        def eq(a, b):
            return all(torch.equal(x, y) for x, y in zip(a, b, strict=True))

        row = dict(ms=runs["sharded", True][1], eager_ms=runs["sharded", False][1],
                   single_ms=runs["single", True][1], single_eager_ms=runs["single", False][1],
                   **lm_stats(runs["sharded", True][2]),
                   **lm_stats(runs["single", True][2], "single_"),
                   equal_eager=eq(runs["sharded", True][0], runs["sharded", False][0]),
                   single_equal_eager=eq(runs["single", True][0], runs["single", False][0]))
        lm_ok = (row["equal_eager"] and row["single_equal_eager"]
                 and all(runs[k, True][2]["lm_captures"] == 1
                         and runs[k, True][2]["lm_replays"] == n - 1
                         and runs[k, False][2]["lm_captures"] == 0 for k in ("single", "sharded")))
        return runs["single", True][0], runs["sharded", True][0], row, lm_ok

    g_loop, _ = close_loops(loop_map, cfg)
    (rp, rc), (gp, gc), row, lm_ok = dense_runs(
        lambda replay, st: optimize_pose_graph(g_loop, cfg, "dense", st, replay),
        lambda replay, st: optimize_pose_graph_sharded(g_loop, cfg, mesh, "dense", st, replay))
    padded = g_loop.edges_ij.shape[0] % axis_size(mesh) != 0
    rel = float(((gp - rp).abs() / rp.abs().clamp(min=1e-30)).max())
    equal = torch.equal(gp, rp) and torch.equal(gc, rc)
    out.append(dict(part="a", solver="pose graph dense", rows=g_loop.poses.shape[0],
                    edges=g_loop.edges_ij.shape[0], padded=padded, equal=equal, max_rel=rel,
                    **row, ok=lm_ok and (equal or (padded and rel <= PAR_PAD_RTOL))))

    def per_sweep(ms, st):
        return ms / max(st["cg_sweeps"], 1)

    def batch_sweep(st):
        """Host ms a sweep in the batches after each first check (replays and
        checks, or eager sweeps and checks), LM work left out."""
        return st["cg_batch_s"] * 1e3 / max(st["cg_batches"] * SWEEPS_PER_CHECK, 1)

    def pcg_row(row, st, ms, eager, eager_st, eager_ms, single_st, single_ms, bits):
        """The captured solve's readings beside the eager sharded and the
        single-device solves'; all three equal bit for bit, or not ok."""
        row.update(cg_sweeps=st["cg_sweeps"], eager_cg_sweeps=eager_st["cg_sweeps"],
                   single_cg_sweeps=single_st["cg_sweeps"], captures=st["cg_captures"],
                   replays=st["cg_batches"], capture_ms=st["cg_capture_s"] * 1e3,
                   single_captures=single_st["cg_captures"],
                   single_capture_ms=single_st["cg_capture_s"] * 1e3,
                   eager_captures=eager_st["cg_captures"], equal_eager=eager,
                   ms=ms, eager_ms=eager_ms, single_ms=single_ms,
                   ms_per_sweep=per_sweep(ms, st),
                   eager_ms_per_sweep=per_sweep(eager_ms, eager_st),
                   single_ms_per_sweep=per_sweep(single_ms, single_st),
                   batch_ms_per_sweep=batch_sweep(st),
                   eager_batch_ms_per_sweep=batch_sweep(eager_st),
                   single_batch_ms_per_sweep=batch_sweep(single_st),
                   ok=bits and eager and st["cg_captures"] > 0 and eager_st["cg_captures"] == 0
                   and st["cg_sweeps"] == eager_st["cg_sweeps"] == single_st["cg_sweeps"])
        return row

    cfg3 = dataclasses.replace(cfg, pg_iterations=PAR_ITERS)
    g = scale["graph"]
    st = {}
    (rp3, rc3), ms_ref = timed(torch, lambda: optimize_pose_graph(g, cfg3, method="pcg", stats=st))
    sm = {}
    (p3, c3), ms = timed(torch, lambda: optimize_pose_graph_sharded(g, cfg3, mesh, "gather", sm))
    d = pose_diff(p3, rp3)
    out.append(dict(part="a", solver="pose graph gather", rows=g.poses.shape[0],
                    edges=g.edges_ij.shape[0], cg_sweeps=sm["cg_sweeps"],
                    single_cg_sweeps=st["cg_sweeps"], max_diff=d, cost=float(c3),
                    single_cost=float(rc3), equal=torch.equal(p3, rp3), ms=ms,
                    single_ms=ms_ref, ms_per_sweep=per_sweep(ms, sm),
                    single_ms_per_sweep=per_sweep(ms_ref, st),
                    ok=max(d) <= PAR_M and cost_close(c3, rc3)))
    sm, se = {}, {}
    (p3, c3), ms = timed(torch, lambda: optimize_pose_graph_sharded(g, cfg3, mesh, "pcg", sm))
    ((e3, ec3), _), ms_e = timed(torch, lambda: sharded_pcg(torch, g, None, cfg3, mesh, False,
                                                            se, None))
    equal = torch.equal(p3, rp3) and torch.equal(c3, rc3)
    out.append(pcg_row(dict(part="a", solver="pose graph pcg", rows=g.poses.shape[0],
                            edges=g.edges_ij.shape[0], max_diff=pose_diff(p3, rp3),
                            cost=float(c3), single_cost=float(rc3), equal=equal),
                       sm, ms, torch.equal(p3, e3) and torch.equal(c3, ec3), se, ms_e, st,
                       ms_ref, equal))

    M = int(loop_map.cursor)
    p_loop = build_ba_problem(reseed_map(loop_map, rp[:M].cpu().numpy()), min_views=2)
    (rpo, rl, rc), (bpo, bl, bc), row, lm_ok = dense_runs(
        lambda replay, st: optimize_ba(p_loop, cfg, method="dense", stats=st, replay=replay),
        lambda replay, st: optimize_ba_sharded(p_loop, cfg, mesh, method="dense", stats=st,
                                               replay=replay))
    L = rl.shape[0]
    d = pose_diff(bpo, rpo) + [float((bl[:L] - rl).abs().max())]
    out.append(dict(part="b", solver="BA dense (loop)", poses=p_loop.poses.shape[0],
                    landmarks=int(p_loop.lm_mask.sum()), observations=int(p_loop.obs_mask.sum()),
                    max_diff=d, cost=float(bc), single_cost=float(rc),
                    equal=torch.equal(bpo, rpo) and torch.equal(bl[:L], rl), **row,
                    ok=lm_ok and max(d) <= PAR_M and cost_close(bc, rc)))
    p_big = scale["problem"]
    st, sm, se = {}, {}, {}
    (rpo, rl, rc), ms_ref = timed(torch, lambda: optimize_ba(p_big, cfg3, method="pcg",
                                                             stats=st))
    (bpo, bl, bc), ms = timed(torch, lambda: optimize_ba_sharded(p_big, cfg3, mesh, method="pcg",
                                                                 stats=sm))
    (_, (epo, el, ec)), ms_e = timed(torch, lambda: sharded_pcg(torch, None, p_big, cfg3, mesh,
                                                                False, None, se))
    L = rl.shape[0]
    equal = torch.equal(bpo, rpo) and torch.equal(bl[:L], rl) and torch.equal(bc, rc)
    out.append(pcg_row(dict(part="b", solver="BA pcg (scale)", poses=p_big.poses.shape[0],
                            landmarks=int(p_big.lm_mask.sum()),
                            observations=int(p_big.obs_mask.sum()),
                            max_diff=pose_diff(bpo, rpo) + [float((bl[:L] - rl).abs().max())],
                            cost=float(bc), single_cost=float(rc), equal=equal),
                       sm, ms,
                       torch.equal(bpo, epo) and torch.equal(bl, el) and torch.equal(bc, ec),
                       se, ms_e, st, ms_ref, equal))
    return out, cg_trace(torch, g, p_big, cfg3, mesh)


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
    arc (each PAR_SEG_FRAMES frames, overlapping by one), one batch on this
    rank (the batched step's graph, captured inside the call), against the
    segments run one after another by the port's eager step; DoH launches of
    `run_segments`, its frames/s (cold: the capture inside), and
    `join_segments` against the arc."""
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
    # the rule of phase 13 where bits differ: poses within one Cartesian pixel
    # and 1/512 rad (run_segments returns poses only; phase 13 holds the flags)
    dxy = float(np.abs(poses[..., :2] - seq[..., :2]).max())
    dth = float(np.abs(poses[..., 2] - seq[..., 2]).max())
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
                dxy=dxy, dth=dth, within=dxy <= cfg.cart_resolution_m and dth <= POSE_ROT_TOL,
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


def check_cg_trace(trace, card):
    """Phase 9 (a)-(b): logs and checks `cg_trace`'s windows.  Each replay has
    its device events; the replays launch as many NCCL all-reduce kernels a
    sweep as the eager window's all-reduces launch a call (NCCL's one-rank
    path launches none for an in-place sum), and both windows launch the same
    NCCL kernels in all; the device events a replayed sweep (the graph's 5
    state copies taken off) beside an eager sweep's."""
    from radarslampy_tpu_torch.models.posegraph import SWEEPS_PER_CHECK

    (cap, cap_pg, cap_ba), (eager, *_) = trace
    replays = cap_pg["cg_batches"] + cap_ba["cg_batches"]
    swept = SWEEPS_PER_CHECK * replays
    per_call = eager["eager_nccl"] / max(eager["allreduce_calls"], 1)
    replayed_sweep = (cap["replayed_events"] - 5 * replays) / max(swept, 1)
    eager_sweep = (eager["eager_events"] - cap["eager_events"]) / max(swept, 1)
    log(f"parallel (a)-(b) trace: one LM iteration of the sharded PCG pose graph and BA, "
        f"{PAR_TRACE_CHECKS} checks' sweeps, on {card}: {cap['replays']} replays "
        f"({cap_pg['cg_batches']} + {cap_ba['cg_batches']}, {swept} sweeps replayed; "
        f"{cap_pg['cg_captures']} + {cap_ba['cg_captures']} captures), "
        f"{cap['replays_without_events']} without device events; NCCL all-reduce kernels: "
        f"{cap['replayed_nccl']} in the replays, {cap['eager_nccl']} outside them, "
        f"{eager['eager_nccl']} in the eager window for its {eager['allreduce_calls']} "
        f"all-reduce calls ({per_call:.4g} a call); names {cap['nccl_names'] or 'none'}; "
        f"device events a replayed sweep {replayed_sweep:.4g}, an eager sweep {eager_sweep:.4g}")
    if not (cap["replays"] == replays > 0 and cap["replays_without_events"] == 0
            and cap["replayed_nccl"] == per_call * swept
            and cap["eager_nccl"] + cap["replayed_nccl"] == eager["eager_nccl"]):
        raise AssertionError(f"parallel (a)-(b): the PCG trace's replays do not hold the "
                             f"eager sweeps' all-reduces: {cap} against {eager}")


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
        nccl_env = {k: v for k, v in os.environ.items() if k.startswith(("NCCL", "TORCH_NCCL"))}
        log(f"parallel: world {dist.get_world_size()}, backend {dist.get_backend()}, mesh "
            f"{mesh.mesh_dim_names} {tuple(mesh.shape)} on {mesh.device_type}; NCCL "
            f"{'.'.join(map(str, torch.cuda.nccl.version()))} in torch, NCCL and TORCH_NCCL "
            f"variables set: {nccl_env or 'none'}")
        solvers, trace = parallel_solvers(torch, cfg, mesh, trim_map_state(loop_state.map),
                                          scale)
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
        raise AssertionError(f"parallel (a)/(b): sharded solvers off the single-device ones, or "
                             f"the sharded PCG's captured sweeps off its eager ones: {bad}")
    check_cg_trace(trace, card)
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
        f"SlamConfig(), one batch (the batched graph): equal bit for bit to the segments run "
        f"one after another {segs['equal']} (max pose diff {segs['dxy']:.3e} m, "
        f"{segs['dth']:.3e} rad); {segs['fps']:.3f} frames/s cold (sequential eager "
        f"{segs['sequential_fps']:.3f}) on {card}; doh launches {segs['launches']} (the init, "
        f"the capture's warm-up, one a frame); join_segments: {segs['frames']} frames, "
        f"ATE {segs['ate']:.4f} m against the arc, end drift {segs['drift']:.4f} m, last pose "
        f"{[round(float(x), 4) for x in segs['joined'][-1]]}; each segment's error (m) after its "
        f"first step and at its end, against the arc from its first frame: {segs['seg_err']}")
    if not ((segs["equal"] or segs["within"]) and segs["finite"]
            and segs["launches"] == PAR_SEG_FRAMES + 1):
        raise AssertionError("parallel (e): run_segments differs from the sequential runs or "
                             "did not launch DoH once a frame for the batch")
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


# Phase 10: the PNG path.  The summary keys of `python -m radarslampy_tpu`
# without back-end flags (radarslampy_tpu/__main__.py, `summary`).
JAX_CLI_KEYS = ["sequence", "frames", "keyframes", "fps", "rmse_vs_gt_m"]
DECODE_REPS = 3     # timed passes over the sequence's PNGs per decoder (median)
# profile_stages at SlamConfig(): fewer calls than its CLI's 200 x 5
PROFILE_CALLS, PROFILE_TRIALS, PROFILE_ITERS = 10, 3, 10
TIMER_STEPS = 5
CLI_TIMEOUT_S = 300


def host_facts():
    """Phase 10 (a): the host's g++, libpng headers, native loader, PIL,
    matplotlib and ffmpeg."""
    import importlib

    from radarslampy_tpu_torch.io import native_loader

    gxx = shutil.which("g++")
    png_h = gxx is not None and subprocess.run(
        [gxx, "-x", "c++", "-E", "-o", "/dev/null", "-"], input="#include <png.h>\n",
        capture_output=True, text=True, timeout=60).returncode == 0
    native = native_loader.native_available()
    error = next((line.strip() for line in native_loader.build_log.splitlines()
                  if "error" in line.lower()), native_loader.build_log.strip()[:200])
    mods = {}
    for mod in ("PIL", "matplotlib"):
        try:
            mods[mod] = getattr(importlib.import_module(mod), "__version__", "?")
        except ImportError:
            mods[mod] = None
    return dict(gxx=gxx, png_h=png_h, native=native, error=error, pil=mods["PIL"],
                matplotlib=mods["matplotlib"], ffmpeg=shutil.which("ffmpeg"))


def decode_fps(decode_all, n):
    """Frames per second of decode_all() over `n` files, median of DECODE_REPS."""
    times = []
    for _ in range(DECODE_REPS):
        t = time.perf_counter()
        got = decode_all()
        times.append(time.perf_counter() - t)
        if len(got) != n:
            raise AssertionError(f"decoded {len(got)} of {n} frames")
    return n / statistics.median(times)


def check_decode(cfg, paths, frames, stamps, facts):
    """Phase 10 (c): every PNG through the native decoder (where it builds)
    and PIL against the written bytes; the decoders' frames per second."""
    import numpy as np

    from radarslampy_tpu_torch.io import native_loader, oxford
    from radarslampy_tpu_torch.models.system import _Prefetcher

    written = frames.copy()
    written[:, :, cfg.clipped_range_bins:] = 0
    az_err = 0.0
    for i, path in enumerate(paths):
        pil = oxford.decode_radar_png(path, cfg, raw_u8=True)
        if not (np.array_equal(pil.power, written[i]) and pil.frame_timestamp == stamps[i]):
            raise AssertionError(f"PIL decode of frame {i} != the written bytes")
        if facts["native"]:
            nat = native_loader.decode_radar_png_native(path, cfg, raw_u8=True)
            if not (np.array_equal(nat.power, written[i]) and nat.frame_timestamp == stamps[i]
                    and np.array_equal(nat.timestamps, pil.timestamps)
                    and np.array_equal(nat.valid, pil.valid)):
                raise AssertionError(f"native decode of frame {i} != PIL's / the written bytes")
            az_err = max(az_err, float(np.abs(nat.azimuths - pil.azimuths).max()))
    if az_err > 1e-6:
        raise AssertionError(f"native azimuths off PIL's by {az_err}")
    fps = {}
    if facts["native"]:
        pool = list(native_loader.NativeLoader(paths, cfg, raw_u8=True))
        if [f.frame_timestamp for f in pool] != list(stamps) or not all(
                np.array_equal(f.power, w) for f, w in zip(pool, written)):
            raise AssertionError("NativeLoader did not deliver every frame in order")
        fps["NativeLoader"] = decode_fps(
            lambda: list(native_loader.NativeLoader(paths, cfg, raw_u8=True)), len(paths))
    fps["_Prefetcher"] = decode_fps(lambda: list(_Prefetcher(paths, cfg, raw_u8=True)),
                                    len(paths))
    fps["PIL, one thread"] = decode_fps(
        lambda: [oxford.decode_radar_png(p, cfg, raw_u8=True) for p in paths], len(paths))
    return dict(az_err=az_err, fps=fps)


def png_driver(torch, cfg, root, dev="cuda"):
    """Phase 10 (d): `RadarSlamSystem(...).run()` over the PNGs; records which
    decoder the driver built and its DoH launches."""
    from radarslampy_tpu_torch import RadarSlamSystem
    from radarslampy_tpu_torch.models import system as S
    from radarslampy_tpu_torch.ops.cuda import doh_cuda

    used = []
    real = {name: getattr(S, name) for name in ("NativeLoader", "_Prefetcher")}

    def recording(name):
        def make(*args, **kwargs):
            used.append(name)
            return real[name](*args, **kwargs)
        return make

    try:
        for name in real:
            setattr(S, name, recording(name))
        system = RadarSlamSystem("synth", root, cfg, device=dev)
        doh_cuda.launches = 0
        t = time.time()
        res = system.run()
        wall_s = time.time() - t
        launches = doh_cuda.launches
    finally:
        for name, cls in real.items():
            setattr(S, name, cls)
    return dict(res=res, wall_s=wall_s, launches=launches, decoder=used)


def png_cli(root):
    """Phase 10 (e): `python -m radarslampy_tpu_torch synth --data-root root
    --metrics m.jsonl` in a subprocess; its summary and its DoH launches (the
    subprocess prints its wrapper's count on exit)."""
    metrics = f"{root}/cli_metrics.jsonl"
    code = ("import runpy, sys\n"
            "from radarslampy_tpu_torch.ops.cuda import doh_cuda\n"
            "sys.argv = ['radarslampy_tpu_torch'] + sys.argv[1:]\n"
            "try:\n"
            "    runpy.run_module('radarslampy_tpu_torch', run_name='__main__')\n"
            "finally:\n"
            "    print(f'doh_launches={doh_cuda.launches}', file=sys.stderr)\n")
    t = time.time()
    p = subprocess.run([sys.executable, "-c", code, "synth", "--data-root", root,
                        "--metrics", metrics], capture_output=True, text=True,
                       timeout=CLI_TIMEOUT_S, cwd=os.path.dirname(os.path.abspath(__file__)))
    if p.returncode != 0:
        raise AssertionError(f"the CLI exited {p.returncode}: {p.stderr[-2000:]}")
    summary = json.loads(p.stdout.strip().splitlines()[-1])
    launches = int(re.findall(r"doh_launches=(\d+)", p.stderr)[-1])
    rows = sum(1 for _ in open(metrics))
    return dict(summary=summary, launches=launches, rows=rows, s=time.time() - t)


def stage_profile(torch, cfg, frames, tmp):
    """Phase 10 (f): `profile_stages.profile()` at SlamConfig() with reduced
    counts; a StageTimer over TIMER_STEPS steps; a device_trace of one step."""
    import numpy as np

    from radarslampy_tpu_torch.models import frontend as F
    from radarslampy_tpu_torch.ops.cuda import doh_cuda
    from radarslampy_tpu_torch.utils import profile_stages
    from radarslampy_tpu_torch.utils.profiling import StageTimer, device_trace

    doh_cuda.launches = 0
    t = time.time()
    prof = profile_stages.profile(cfg, iters=PROFILE_ITERS, calls=PROFILE_CALLS,
                                  trials=PROFILE_TRIALS)
    prof_s, launches = time.time() - t, doh_cuda.launches

    maps = F.build_frame_maps(cfg)
    timer = StageTimer()
    state = F.init_state(frames[0], np.zeros(3), maps, cfg)
    for f in frames[1:1 + TIMER_STEPS]:
        with timer.stage("slam_step", sync=state):
            state, out = F.slam_step(state, f, maps, cfg)
    logdir = f"{tmp}/trace"
    with device_trace(logdir):
        F.slam_step(state, frames[1 + TIMER_STEPS], maps, cfg)
        torch.cuda.synchronize()
    files = os.listdir(logdir)
    events = json.load(open(f"{logdir}/{files[0]}"))["traceEvents"] if len(files) == 1 else []
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return dict(prof=prof, prof_s=prof_s, launches=launches, timer=timer.report(),
                trace_files=files, trace_kernels=len(kernels),
                trace_names=sorted({e["name"] for e in kernels})[:5])


def png_checks(torch, cfg, card, gt, frames, straight):
    """Phase 10: the PNG path at SlamConfig() over phase 4's frames; logs and
    checks (a)-(g); returns the DoH launches of the PNG driver, the CLI and
    profile_stages."""
    import numpy as np

    from radarslampy_tpu_torch.utils.checkpoint import states_equal
    from radarslampy_tpu_torch.io import oxford
    from radarslampy_tpu_torch.sim import oxford_files

    t0 = time.time()
    facts = host_facts()
    log(f"png (a) g++: {facts['gxx'] or 'not on PATH'}")
    log(f"png (a) libpng headers (#include <png.h> through g++): "
        f"{'found' if facts['png_h'] else 'not found'}")
    log(f"png (a) native loader builds and loads: {facts['native']}"
        + ("" if facts["native"] else f"; first error: {facts['error']}"))
    log(f"png (a) PIL: {facts['pil'] or 'not installed'}; matplotlib: "
        f"{facts['matplotlib'] or 'not installed'}; ffmpeg: {facts['ffmpeg'] or 'not on PATH'}")
    if facts["pil"] is None:
        raise AssertionError("PIL is missing: the PNG path cannot run")

    with tempfile.TemporaryDirectory() as tmp:
        t = time.time()
        stamps = oxford_files.write_sequence(tmp, "synth", gt, cfg, frames_u8=frames)
        sp = oxford.sequence_paths(tmp, "synth")
        paths = oxford.radar_image_paths(sp["radar"], sp["timestamps"])
        log(f"png (b) wrote {len(paths)} Oxford PNGs ({cfg.num_azimuths} x "
            f"{11 + cfg.num_range_bins} u8) of phase 4's frames in {time.time() - t:.2f} s")

        dec = check_decode(cfg, paths, frames, stamps, facts)
        if facts["native"]:
            log(f"png (c) decode_radar_png_native(raw_u8=True) == the written bytes == "
                f"io/oxford.decode_radar_png, bit for bit, on all {len(paths)} frames "
                f"(timestamps and valid flags equal; azimuths within {dec['az_err']:.2e} rad); "
                f"NativeLoader delivered every frame in order")
        else:
            log(f"png (c) native decode not run: libpng is absent here ({facts['error']}); "
                f"io/oxford.decode_radar_png (PIL) == the written bytes on all {len(paths)} "
                f"frames")
        log("png (c) decode frames/s over the same files (raw u8, median of "
            f"{DECODE_REPS} passes, on {card}'s host): " + "; ".join(
                f"{k} {v:.1f}" for k, v in dec["fps"].items())
            + ("" if facts["native"] else "; NativeLoader not available"))

        drv = png_driver(torch, cfg, tmp)
        r = drv["res"]
        ts, est = r.trajectory.as_arrays()
        ts5, est5 = straight.trajectory.as_arrays()
        if not (np.array_equal(ts, ts5) and np.array_equal(est, est5)
                and states_equal(r.final_state, straight.final_state)):
            raise AssertionError("the driver over PNGs != phase 5's frame_source run")
        expected = ["NativeLoader"] if facts["native"] else ["_Prefetcher"]
        if drv["decoder"] != expected or drv["launches"] < 1:
            raise AssertionError(f"the PNG driver decoded with {drv['decoder']} (expected "
                                 f"{expected}), doh launches {drv['launches']}")
        log(f"png (d) driver over the PNGs, decoded by {drv['decoder'][0]}"
            + ("" if facts["native"] else " (no libpng)")
            + f": {r.frames} frames in {drv['wall_s']:.2f} s, fps {r.fps:.3f} on {card}; "
            f"ATE {r.rmse_vs_gt:.4f} m; == phase 5's frame_source run bit for bit "
            f"(trajectory, every state leaf); doh launches {drv['launches']}")

        # each system captures its own graph, the CLI's as (d)'s: one
        # warm-up step's launch each
        cli = png_cli(tmp)
        s = cli["summary"]
        if not (list(s) == JAX_CLI_KEYS and s["frames"] == r.frames
                and s["rmse_vs_gt_m"] == round(r.rmse_vs_gt, 3)
                and s["keyframes"] == r.n_keyframes and cli["rows"] == r.frames - 1
                and cli["launches"] == drv["launches"]):
            raise AssertionError(f"the CLI's summary {s}, {cli['rows']} metrics rows, "
                                 f"{cli['launches']} doh launches, against (d)")
        log(f"png (e) python -m radarslampy_tpu_torch synth --metrics (subprocess, "
            f"{cli['s']:.1f} s): {json.dumps(s)}; the JAX CLI's keys, rmse == (d)'s; "
            f"{cli['rows']} metrics rows; doh launches {cli['launches']}")

        sp10 = stage_profile(torch, cfg, frames, tmp)
        p = sp10["prof"]
        log(f"png (f) profile_stages.profile(SlamConfig(), calls={PROFILE_CALLS}, "
            f"trials={PROFILE_TRIALS}, iters={PROFILE_ITERS}) in {sp10['prof_s']:.1f} s on "
            f"{p['device_name']} ({card}), us per call: " + ", ".join(
                f"{k} {v['us']}" for k, v in p["stages"].items()))
        log(f"png (f) sum of stages {p['sum_of_stages_us']} us, fused step "
            f"{p['fused_step_us']} us, step with dispatch and sync "
            f"{p['fused_step_wall_us_incl_dispatch']} us; doh launches {sp10['launches']}")
        us = [v["us"] for v in p["stages"].values()]
        if not (p["platform"] == "cuda" and all(np.isfinite(us)) and min(us) > 0
                and sp10["launches"] >= 1):
            raise AssertionError(f"profile_stages: {p}, doh launches {sp10['launches']}")
        log(f"png (f) StageTimer over {TIMER_STEPS} driver steps: {json.dumps(sp10['timer'])}")
        log(f"png (f) device_trace of one step: {sp10['trace_files']}, "
            f"{sp10['trace_kernels']} CUDA kernel events (e.g. {sp10['trace_names']})")
        if sp10["timer"]["slam_step"]["calls"] != TIMER_STEPS or sp10["trace_kernels"] < 1:
            raise AssertionError("StageTimer or device_trace recorded nothing")

        if facts["matplotlib"] is None:
            log("png (g) figures not run: matplotlib is not installed here; the CPU tests "
                "(tests/test_torch_viz.py) hold them")
        else:
            from radarslampy_tpu_torch import RadarSlamSystem

            viz = f"{tmp}/viz"
            RadarSlamSystem("synth", tmp, cfg).run(viz_dir=viz, viz_every=3)
            names = sorted(os.listdir(viz))
            want = [f"frame_{n:06d}.jpg" for n in range(3, len(paths), 3)]
            if not (set(want) | {"map.png"}) <= set(names):
                raise AssertionError(f"run(viz_dir) wrote {names}, expected {want} + map.png")
            log(f"png (g) run(viz_dir, viz_every=3) wrote {names}")
    log(f"png: phase 10 in {time.time() - t0:.1f} s")
    return drv["launches"], cli["launches"], sp10["launches"]


# Phase 11: the bench, cut to a smoke run (python -m radarslampy_tpu_torch.bench
# runs it at 200 frames and 3 trials)
BENCH_SMOKE = dict(frames=20, trials=1, trace_frames=5)


def bench_checks(torch, cfg):
    """Phase 11: the bench in-process on the card; prints its JSON object and
    returns its DoH launches."""
    import math

    from radarslampy_tpu_torch import bench
    from radarslampy_tpu_torch.ops.cuda import doh_cuda

    t = time.time()
    doh_cuda.launches = 0
    res = bench.run_bench(cfg, "cuda", seed=0, **BENCH_SMOKE)
    launches = doh_cuda.launches
    print(json.dumps(res), flush=True)
    log(f"bench {BENCH_SMOKE}: frames/s per_call_sync {res['per_call_sync_fps']:.3f}, "
        f"per_dispatch {res['per_dispatch_fps']:.3f}, chunked {res['chunked_fps']:.3f}; "
        f"per-call ms p50 {res['per_call_ms_p50']:.2f}, p95 {res['per_call_ms_p95']:.2f}; "
        f"idle share {res['device_idle_share']:.4f}; ATE {res['ate_m']:.4f} m, fit_ok "
        f"{res['fit_ok_share']:.3f}, keyframes {res['keyframes']}, retracks "
        f"{res['retracks']}; doh launches {res['doh_launches']} ({launches} in all), "
        f"{res['doh_device_ms']:.5f} ms a launch, {res['doh_bound_share']:.1%} of bound; "
        f"phase 11 in {time.time() - t:.1f} s")
    # one DoH launch a frame on every path: the step detects on every frame
    if not (launches >= 1
            and all(res["doh_launches"][p] == res["measured_frames"] for p in bench.PATHS)
            and res["device_kind"] == torch.cuda.get_device_name(0)
            and 0.0 <= res["device_idle_share"] <= 1.0
            and all(math.isfinite(res[f"{p}_fps"]) and res[f"{p}_fps"] > 0
                    for p in bench.PATHS)):
        raise AssertionError(f"bench: launches {launches}, {res['doh_launches']} against "
                             f"{res['measured_frames']} frames, device {res['device_kind']}, "
                             f"idle {res['device_idle_share']}")
    return launches


GRAPH_TRACE_STEPS = 8   # replays in phase 12's traced window


def eager_and_graph(torch, maps, cfg, frames):
    """Phase 12 on one sequence (u8 frames on the card): the eager loop and
    the graph from the same init_state -> (eager outputs, eager state, the
    graph's outputs, its state, eager host ms a step, graph host ms a
    replay, graph device ms a replay from CUDA events, DoH launches of the
    graph's run).  The graph's first step (the
    warm-up that captures it) is run, and the state loaded again, before its
    run is counted."""
    import numpy as np

    from radarslampy_tpu_torch.models import frontend as F
    from radarslampy_tpu_torch.ops.cuda import doh_cuda

    state0 = F.init_state(frames[0], np.zeros(3), maps, cfg)
    state, outs, eager_ms = state0, [], []
    for f in frames[1:]:
        t = time.perf_counter()
        state, out = F.slam_step(state, f, maps, cfg)
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t) * 1e3)
        outs.append(out)
    graph = F.StepGraph(maps, cfg)
    graph.load(state0)
    graph.step(frames[1])
    graph.load(state0)
    torch.cuda.synchronize()
    launches0 = doh_cuda.launches
    rows, host_ms, device_ms = [], [], []
    for f in frames[1:]:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        a.record()
        row = graph.step(f)
        b.record()
        b.synchronize()
        host_ms.append((time.perf_counter() - t) * 1e3)
        device_ms.append(a.elapsed_time(b))
        rows.append(row.clone())
    launches = doh_cuda.launches - launches0
    return (F.StepOutput(*(torch.stack(x) for x in zip(*outs))), state,
            F.unpack_output(torch.stack(rows)), graph.snapshot(), eager_ms, host_ms,
            device_ms, launches)


def graph_checks(torch, cfg, maps, frames, fcfg, turn):
    """Phase 12: the step's CUDA graph against the eager step; returns its
    DoH launches on the arc and the turn, and the DoH kernel's mean device
    ms inside the traced replays."""
    import numpy as np

    from radarslampy_tpu_torch import bench
    from radarslampy_tpu_torch.models import frontend as F
    from radarslampy_tpu_torch.ops.cuda import doh_cuda
    from radarslampy_tpu_torch.utils.checkpoint import states_equal

    t0 = time.time()
    noise = np.random.default_rng(12).integers(0, 40, frames.shape[1:], dtype=np.uint8)
    arc = torch.as_tensor(np.concatenate([frames, noise[None]]), device="cuda")
    seqs = {"arc": (cfg, maps, arc),
            "fmt_turn": (fcfg, F.build_frame_maps(fcfg), torch.as_tensor(turn, device="cuda"))}
    kinds = collections.Counter()
    launches = 0
    for name, (c, m, fr) in seqs.items():
        eo, es, go, gs, eager_ms, host_ms, dev_ms, n = eager_and_graph(torch, m, c, fr)
        unequal = [k for k in F.StepOutput._fields
                   if not (getattr(eo, k).dtype == getattr(go, k).dtype
                           and torch.equal(getattr(eo, k), getattr(go, k)))]
        if unequal or not states_equal(es, gs):
            raise AssertionError(f"graph != eager on the {name}: outputs {unequal}, "
                                 f"state equal {states_equal(es, gs)}")
        launches += n
        if n != len(fr) - 1:
            raise AssertionError(f"graph on the {name}: {n} DoH launches, {len(fr) - 1} frames")
        kf, rt = eo.is_keyframe.cpu(), eo.did_retrack.cpu()
        coast = (eo.n_inliers < c.min_inliers_accept).cpu()
        here = collections.Counter(plain=int((~kf).sum()), keyframe=int((kf & ~rt).sum()),
                                   retrack=int((rt & ~coast).sum()), coast=int(coast.sum()))
        kinds.update(here)
        log(f"graph {name}: {len(fr) - 1} frames equal to the eager step bit for bit "
            f"(every output, every state leaf); {dict(here)}; host ms a step: eager "
            f"{statistics.median(eager_ms):.2f} (median), graph {statistics.median(host_ms):.3f} "
            f"a replay; graph device ms a replay (events) {statistics.median(dev_ms):.3f} "
            f"median, {min(dev_ms):.3f}-{max(dev_ms):.3f}; doh launches {n}")
    log(f"graph: frame kinds over both {dict(kinds)}")
    if min(kinds[k] for k in ("plain", "keyframe", "retrack", "coast")) < 1:
        raise AssertionError(f"phase 12 lacks a kind of frame: {dict(kinds)}")

    # a chunk with every synchronising call an error, on a graph that the
    # chunk before it captured
    state0 = F.init_state(arc[0], np.zeros(3), maps, cfg)
    g = F.StepGraph(maps, cfg)
    ref_state, ref_outs = F.slam_step_chunk(state0, arc[1:], maps, cfg, g)
    torch.cuda.synchronize()
    row_b = sum(t[0].nbytes for t in g.state.map if t.dim())
    map_b = sum(t.nbytes for t in g.state.map)
    rest_b = sum(t.nbytes for name, t in zip(F.SlamState._fields, g.state) if name != "map")
    log(f"graph bytes a frame at {cfg.max_keyframes} keyframes: the masked map write reads and "
        f"writes one row, {row_b} B each way (+ the cursor), where the eager step copies the "
        f"whole map, {map_b} B each way; the rest of the state copied over, {rest_b} B each "
        f"way; the input staged, {arc[0].nbytes} B (u8)")
    before = doh_cuda.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        c_state, c_outs = F.slam_step_chunk(state0, arc[1:], maps, cfg, g)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    n = doh_cuda.launches - before
    launches += n
    if n != len(arc) - 1 or not states_equal(c_state, ref_state) or not all(
            torch.equal(a, b) for a, b in zip(c_outs, ref_outs)):
        raise AssertionError(f"the chunk under set_sync_debug_mode('error') differs or "
                             f"launched {n} DoH kernels")
    log(f"graph chunk of {len(arc) - 1} frames under set_sync_debug_mode('error'): no sync, "
        f"equal to the chunk before it bit for bit")

    # the traced windows: the graph's replays and the eager step
    gtr = bench.trace_window(arc, maps, cfg, GRAPH_TRACE_STEPS, graph=True)
    etr = bench.trace_window(arc, maps, cfg, GRAPH_TRACE_STEPS)
    launches += gtr.doh_launches
    log(f"graph traced window of {GRAPH_TRACE_STEPS} replays: {len(gtr.doh_ms)} DoH kernels "
        f"traced == {gtr.doh_launches} launches counted; device busy {gtr.busy_ms:.3f} ms a "
        f"step, window {gtr.window_ms:.3f} ms, idle share {1 - gtr.busy_ms / gtr.window_ms:.4f}; "
        f"eager: busy {etr.busy_ms:.3f} ms, window {etr.window_ms:.3f} ms, idle share "
        f"{1 - etr.busy_ms / etr.window_ms:.4f}; doh in the graph "
        f"{statistics.mean(gtr.doh_ms):.5f} ms a launch; phase 12 in {time.time() - t0:.1f} s")
    if len(gtr.doh_ms) != gtr.doh_launches or gtr.busy_ms <= 0:
        raise AssertionError("graph trace: DoH kernels != launches, or no device activity")
    return launches, statistics.mean(gtr.doh_ms)


# Phase 13: the batched step.  BATCH_D segments of phase 9 (e)'s arc at
# SlamConfig() through one StepGraph(maps, cfg, batch=BATCH_D), the
# counterpart of the JAX package's jit(vmap(slam_step)), against BATCH_D
# single StepGraphs stepped in turn.  Where bits differ, the rule of phase 8
# (f) for two runs that each carry their own state: equal keyframe and
# retrack flags, poses within one Cartesian pixel and 1/512 rad.
BATCH_D = 4
BATCH_PASSES = 3        # timed passes over the segments' frames (median)
BATCH_TRACE_STEPS = 6   # batched replays in the traced window
POSE_ROT_TOL = 1.0 / 512


def rows_agree(torch, a, b, cfg):
    """Packed rows [..., 13] of two runs -> (equal bit for bit, flags equal,
    max |dx|, |dy| in m, max |dtheta| in rad, within the rule)."""
    equal = torch.equal(a, b)
    flags = torch.equal(a[..., 6:8], b[..., 6:8])
    dxy = float((a[..., :2] - b[..., :2]).abs().max())
    dth = float((a[..., 2] - b[..., 2]).abs().max())
    return dict(equal=equal, flags=flags, dxy=dxy, dth=dth,
                ok=equal or (flags and dxy <= cfg.cart_resolution_m and dth <= POSE_ROT_TOL))


def batched_doh(torch, doh_cuda, imgs, filters):
    """Phase 13 (a): one launch over the D images [D, S, S] against D single
    launches (bit for bit), through vmap's batching rule, and each image
    against the twin with phase 3's per-sigma tolerance; its device ms
    (graph timer) beside D single launches', its ms through the wrapper, the
    twin's, the bound of D images."""
    D, S = imgs.shape[0], imgs.shape[-1]
    before = doh_cuda.launches
    out = doh_cuda.doh_response_cuda(imgs, filters)
    one_launch = doh_cuda.launches - before == 1
    vm = torch.func.vmap(lambda x: doh_cuda.doh_response(x, filters))(imgs)
    singles = [doh_cuda.doh_response_cuda(imgs[d], filters) for d in range(D)]
    refs = [doh_cuda.doh_response_reference(imgs[d], filters) for d in range(D)]
    torch.cuda.synchronize()
    equal = torch.equal(vm, out) and all(torch.equal(out[d], singles[d]) for d in range(D))
    err, worst = 0.0, 0.0
    for d in range(D):
        for s in range(out.shape[1]):
            e = float((out[d, s] - refs[d][s]).abs().max())
            tol = 2e-3 * float(refs[d][s].abs().max())
            if not (tol > 0 and e <= tol):
                raise AssertionError(f"batched DoH off its twin: image {d}, sigma slice {s}, "
                                     f"{e} > {tol}")
            err, worst = max(err, e), max(worst, e / tol)
    bound, bound_by = doh_cuda.doh_bound_ms(S, filters.radii, D)
    return dict(equal=equal, one_launch=one_launch, max_abs_err=err, worst_share_of_tol=worst,
                device_ms=graph_ms(lambda: doh_cuda.doh_response_cuda(imgs, filters)),
                singles_device_ms=graph_ms(
                    lambda: [doh_cuda.doh_response_cuda(imgs[d], filters) for d in range(D)],
                    n=25),
                wrapper_ms=time_ms(lambda: doh_cuda.doh_response_cuda(imgs, filters)),
                plain_ms=time_ms(lambda: [doh_cuda.doh_response_reference(imgs[d], filters)
                                          for d in range(D)], reps=5),
                bound_ms=bound, bound_by=bound_by)


def batched_trace(torch, F, g, s0, seg, steps):
    """Phase 13 (c): `steps` replays of the captured batched graph `g` under
    torch.profiler, each in its "step_graph.step" range and synchronised,
    then a batched init_state (one DoH launch); read from the first replay
    on -> (DoH kernels traced, launches counted, busy ms a replay, window ms
    a replay).  A batched init_state and one replay open the window unread:
    a trace that follows others in the process can lose the device events of
    its first moments (`bench.trace_window`), and this one lost one launch
    behind a lead-in of a load alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from radarslampy_tpu_torch import bench
    from radarslampy_tpu_torch.ops.cuda import doh_cuda
    from radarslampy_tpu_torch.utils.profiling import device_busy_us, lost_launches

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        g.load(F.batched_init_state(seg[:, 0], torch.zeros(seg.shape[0], 3), g.maps, g.cfg))
        g.step(seg[:, 1])
        g.load(s0)
        torch.cuda.synchronize()
        launches0 = doh_cuda.launches
        for t in range(1, steps + 1):
            g.step(seg[:, t])
            torch.cuda.synchronize()
        F.batched_init_state(seg[:, 0], torch.zeros(seg.shape[0], 3), g.maps, g.cfg)
        torch.cuda.synchronize()
    events = prof.events()
    replays = sorted((e for e in events if e.device_type == DeviceType.CPU
                      and e.name == "step_graph.step"), key=lambda e: e.time_range.start)
    if len(replays) != steps + 1:
        raise AssertionError(f"expected {steps + 1} step_graph.step ranges (the lead-in's "
                             f"and {steps} read), got {len(replays)}")
    replays = replays[1:]
    t0 = min(e.time_range.start for e in replays)
    t1 = max(e.time_range.end for e in replays)
    busy = device_busy_us(events, t0, t1, skip=lambda e: e.name.startswith("step_graph"))
    doh = sum(1 for e in events if e.device_type != DeviceType.CPU and "doh_kernel" in e.name
              and e.time_range.start >= t0)
    launches = doh_cuda.launches - launches0
    bench.check_trace(lost_launches(events, t0), doh, launches)
    return doh, launches, busy / 1e3 / steps, (t1 - t0) / 1e3 / steps


def batched_checks(torch, cfg, maps, card):
    """Phase 13: the batched DoH kernel, then the batched graph against
    single StepGraphs, the rates of four ways to step the segments, a traced
    window and the memory; returns (the DoH launches of the batched path,
    the batched kernel's readings)."""
    import numpy as np

    from radarslampy_tpu_torch.models import frontend as F
    from radarslampy_tpu_torch.ops.cuda import doh_cuda
    from radarslampy_tpu_torch.ops.grid import warp_polar_to_cartesian
    from radarslampy_tpu_torch.utils.checkpoint import state_leaves, states_equal

    t0 = time.time()
    D, T = BATCH_D, PAR_SEG_FRAMES
    step = T - 1
    _, frames = render_frames(cfg, 1 + D * step, seed=PAR_SEED)
    seg = np.stack([frames[k * step:k * step + T] for k in range(D)])
    # the last segment's last scan is noise, as in phase 12: a coast and a
    # retrack in one segment while the others track
    seg[-1, -1] = np.random.default_rng(13).integers(0, 40, seg.shape[2:], dtype=np.uint8)
    seg = torch.as_tensor(seg, device="cuda")
    n_frames = D * (T - 1)

    # (a) the batched DoH kernel on the segments' first Cartesian images
    imgs = torch.stack([warp_polar_to_cartesian(F._dequantize_polar(seg[d, 0]), maps.warp)
                        for d in range(D)]).contiguous()
    k = batched_doh(torch, doh_cuda, imgs, maps.doh)
    log(f"batched (a) doh D={D} S={cfg.cart_size}: one launch {k['one_launch']}, equal to "
        f"{D} single launches and to vmap's rule bit for bit {k['equal']}; max_abs_err "
        f"{k['max_abs_err']:.3e} against the twin ({k['worst_share_of_tol']:.3f} of the "
        f"per-sigma tolerance at worst); kernel {k['device_ms']:.5f} ms on the device (graph "
        f"replay) against {D} single launches {k['singles_device_ms']:.5f} ms; "
        f"{k['wrapper_ms']:.5f} ms through the wrapper; twin {k['plain_ms']:.4f} ms; bound "
        f"{k['bound_ms']:.5f} ms ({k['bound_by']}, {D} x one image's), "
        f"{k['bound_ms'] / k['device_ms']:.1%} of bound, on {card}")
    if not (k["equal"] and k["one_launch"]):
        raise AssertionError("the batched DoH launch differs from single launches")

    # (b) the batched graph against single StepGraphs stepped in turn; the
    # graphs are captured on the first pass, the counts taken on it
    singles, single_states, graphs1 = [], [], []
    for d in range(D):
        g1 = F.StepGraph(maps, cfg)
        g1.load(F.init_state(seg[d, 0], np.zeros(3), maps, cfg))
        singles.append(torch.stack([g1.step(seg[d, t]).clone() for t in range(1, T)]))
        single_states.append(g1.snapshot())
        graphs1.append(g1)
    mem0 = torch.cuda.memory_allocated()
    doh_cuda.launches = 0
    s0 = F.batched_init_state(seg[:, 0], torch.zeros(D, 3), maps, cfg)
    g = F.StepGraph(maps, cfg, batch=D)
    g.load(s0)
    rows = torch.stack([g.step(seg[:, t]).clone() for t in range(1, T)])
    torch.cuda.synchronize()
    launches = doh_cuda.launches
    mem_b = torch.cuda.memory_allocated() - mem0
    state_b = sum(t.nbytes for t in state_leaves(g.state))
    final = F.unstack_states(g.snapshot())
    cmp = rows_agree(torch, rows.transpose(0, 1), torch.stack(singles), cfg)
    states = all(states_equal(a, b) for a, b in zip(final, single_states))
    init_equal = all(states_equal(a, F.init_state(seg[d, 0], np.zeros(3), maps, cfg))
                     for d, a in enumerate(F.unstack_states(s0)))
    kf, rt = rows[..., 6].sum().item(), rows[..., 7].sum().item()
    coasts = (rows[..., 4] < cfg.min_inliers_accept).sum().item()
    log(f"batched (b) StepGraph(batch={D}) over {D} segments x {T} frames at SlamConfig(): "
        f"init equal to {D} init_state bit for bit {init_equal}; every packed row equal to {D} "
        f"single StepGraphs bit for bit {cmp['equal']}, final states {states}; flags equal "
        f"{cmp['flags']}, max pose diff {cmp['dxy']:.3e} m, {cmp['dth']:.3e} rad; keyframes "
        f"{int(kf)}, retracks {int(rt)}, coasts {int(coasts)} of {n_frames} segment frames; "
        f"doh launches {launches} (the init, the capture's warm-up step, one a replay); "
        f"batched state {state_b} B, "
        f"device memory held by the state, the graph and its pool {mem_b} B")
    if not (cmp["ok"] and init_equal and (states or not cmp["equal"])
            and launches == 1 + 1 + (T - 1) and rt >= 1 and coasts >= 1):
        raise AssertionError(f"the batched graph differs from the single graphs: {cmp}, states "
                             f"{states}, init {init_equal}, launches {launches}, retracks {rt}, "
                             f"coasts {coasts}")

    # (d) rates over the same frames, each path warm, BATCH_PASSES passes
    def passes(fn):
        ms = []
        for _ in range(BATCH_PASSES):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        return statistics.median(ms), min(ms), max(ms)

    def batched_graph():
        g.load(s0)
        for t in range(1, T):
            g.step(seg[:, t])

    inits = F.unstack_states(s0)

    def single_graphs():
        for d in range(D):
            graphs1[d].load(inits[d])
            for t in range(1, T):
                graphs1[d].step(seg[d, t])

    def vmapped_eager():
        s = s0
        for t in range(1, T):
            s, _ = F.batched_slam_step(s, seg[:, t], maps, cfg)

    def eager_in_turn():
        for d in range(D):
            s = inits[d]
            for t in range(1, T):
                s, _ = F.slam_step(s, seg[d, t], maps, cfg)

    rates = {}
    for name, fn in (("batched_graph", batched_graph), ("single_graphs", single_graphs),
                     ("vmapped_eager", vmapped_eager), ("eager_in_turn", eager_in_turn)):
        fn()
        med, lo, hi = passes(fn)
        rates[name] = dict(fps=n_frames / (med / 1e3), ms=med, min_ms=lo, max_ms=hi)
    ev = []
    for t in range(1, T):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.step(seg[:, t])
        b.record()
        b.synchronize()
        ev.append(a.elapsed_time(b))
    log("batched (d) frames/s over " + f"{n_frames} segment frames ({BATCH_PASSES} warm passes, "
        f"median; pass ms min-max) on {card}: " + "; ".join(
            f"{k_} {v['fps']:.3f} ({v['min_ms']:.1f}-{v['max_ms']:.1f} ms)"
            for k_, v in rates.items())
        + f"; batched replay {statistics.median(ev):.3f} ms by CUDA events (median of {T - 1}),"
        f" {statistics.median(ev) / D:.3f} ms a segment frame")

    # (c) a traced window of batched replays
    doh_traced, doh_counted, busy, window = batched_trace(torch, F, g, s0, seg,
                                                          BATCH_TRACE_STEPS)
    log(f"batched (c) traced window of {BATCH_TRACE_STEPS} replays and a batched init: "
        f"{doh_traced} DoH kernels traced == {doh_counted} launches counted (one a frame for "
        f"{D} segments); device busy {busy:.3f} ms a replay ({busy / D:.3f} a segment frame), "
        f"window {window:.3f} ms, idle share {1 - busy / window:.4f}; phase 13 in "
        f"{time.time() - t0:.1f} s")
    if doh_traced != doh_counted or doh_counted != BATCH_TRACE_STEPS + 1 or busy <= 0:
        raise AssertionError(f"batched trace: {doh_traced} DoH kernels, {doh_counted} launches")
    k.update(launches=launches, busy_ms=busy, rates=rates, state_bytes=state_b)
    return launches + doh_counted, k


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

    from radarslampy_tpu_torch.utils.checkpoint import states_equal
    from radarslampy_tpu_torch.config import SlamConfig
    from radarslampy_tpu_torch.models import frontend as F
    from radarslampy_tpu_torch.ops.cuda import doh_cuda
    from radarslampy_tpu_torch.ops.grid import warp_polar_to_cartesian
    from radarslampy_tpu_torch.utils.profiling import card_line

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
        bound, bound_by = doh_cuda.doh_bound_ms(S, maps.doh.radii)
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

    # 4. main path at the default config; the chunk's graph is captured
    # first, by one step (its warm-up launches DoH once, its replay once),
    # so the counts below hold the path's own launches
    t = time.time()
    state0 = F.init_state(frames[0], np.zeros(3), maps, cfg)
    graph = F.StepGraph(maps, cfg)
    graph.load(state0)
    graph.step(torch.as_tensor(frames[1], device="cuda"))
    torch.cuda.synchronize()
    log(f"step graph captured in {time.time() - t:.2f} s (init_state, then one step: a "
        f"warm-up step, the capture and a replay)")
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
    if launches != 1 + len(outs):
        raise AssertionError(f"doh launches {launches} != 1 + {len(outs)} frames")
    if not drift < 1.5:
        raise AssertionError(f"drift {drift} m >= 1.5 m over {N_FRAMES} frames")

    doh_cuda.launches = 0
    t = time.time()
    state_c, outs_c = F.slam_step_chunk(
        state0, torch.as_tensor(frames[1:], device="cuda"), maps, cfg, graph)
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
    if not states_equal(state_c, state):
        raise AssertionError("chunk's final state != the per-frame loop's")
    log("chunk (graph) == per-frame (eager): every output field and state leaf equal "
        "bit for bit")

    # the same chunk on the card (graph) and on the CPU (plain twins) at a
    # small config
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
    if not states_equal(straight.final_state, state):
        raise AssertionError("driver final state != the per-frame loop's state")
    if not (np.array_equal(drv["checkpointed"].trajectory.as_arrays()[1], drv["est"])
            and states_equal(drv["checkpointed"].final_state, state)):
        raise AssertionError("checkpointing changed the run")
    res_r = drv["resumed"]
    if not (res_r.frames == N_FRAMES - CHECKPOINT_AT - 1
            and np.array_equal(res_r.trajectory.as_arrays()[0],
                               straight.trajectory.as_arrays()[0])
            and np.array_equal(res_r.trajectory.as_arrays()[1], drv["est"])
            and states_equal(res_r.final_state, straight.final_state)):
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
    log_profile(f"eager step {CHECKPOINT_AT + 1} from the driver's checkpoint profiled",
                *drv["profile"])
    if drv["profile"][2] <= 0:
        raise AssertionError("the profiled step shows no device activity")
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
        f"{bk['posthoc_ms']:.1f} ms with its dense LM captured, {bk['posthoc_eager_ms']:.1f} "
        f"ms eager (host, synchronised); doh launches {bk['launches']}")
    log(f"backend driver: two runs equal bit for bit on every RunResult array: {bk['same']}; "
        f"the post-hoc pass again equal: {bk['same_posthoc']}; the post-hoc pass with its "
        f"dense LM eager equal: {bk['same_posthoc_eager']}")
    if not (bk["same"] and bk["same_posthoc"] and bk["same_posthoc_eager"]):
        raise AssertionError("the back-end driver is not deterministic on the card, or its "
                             "captured dense LM differs from the eager one")
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
    first = by[f"online_pass_{SCALE_STAGE}"]
    if not (first["solver"] == "dense" and first["equal_eager"] and first["lm_captures"] == 1
            and first["lm_replays"] == cfg.pg_iterations - 1):
        raise AssertionError(f"the {SCALE_STAGE}-keyframe online pass did not run its dense "
                             f"LM captured, or differs from the eager one: {first}")

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

    # 10. the PNG path: decode, the driver and the CLI over PNGs, the stage
    # profiler, the figures
    png_launches, cli_launches, profile_launches = png_checks(
        torch, cfg, card, gt, frames, straight)

    # 11. the bench, in-process and cut to a smoke run
    bench_launches = bench_checks(torch, cfg)

    # 12. the step's CUDA graph against the eager step
    graph_launches, doh_row["graph_device_ms"] = graph_checks(torch, cfg, maps, frames,
                                                              fcfg, turn)

    # 13. the batched step: D segments in one graph, one DoH launch a frame
    batched_launches, bk13 = batched_checks(torch, cfg, maps, card)
    doh_row.update(batched_d=BATCH_D, batched_device_ms=bk13["device_ms"],
                   batched_singles_device_ms=bk13["singles_device_ms"],
                   batched_wrapper_ms=bk13["wrapper_ms"], batched_plain_ms=bk13["plain_ms"],
                   batched_bound_ms=bk13["bound_ms"],
                   batched_bound_share=bk13["bound_ms"] / bk13["device_ms"],
                   batched_max_abs_err=bk13["max_abs_err"])

    by_path = {"step": launches, "driver": driver_launches, "fmt_step": fmt_launches,
               "backend_driver": bk["launches"], "eval": eval_launches,
               "batch_odometry": batch_launches, "png_driver": png_launches,
               "cli": cli_launches, "profile_stages": profile_launches,
               "bench": bench_launches, "graph": graph_launches,
               "batched_graph": batched_launches}
    doh_row["launches"] = sum(by_path.values())
    doh_row["launches_by_path"] = by_path
    print(card_line(), flush=True)
    print(json.dumps({"kernels": [doh_row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
