"""Benchmark of the SLAM step on the card: the port of the repo's root `bench.py`.

    python -m radarslampy_tpu_torch.bench [--cpu] [--seed 0]
        [--frames 200] [--trials 3] [--chunk 100] [--trace-frames 20] [--out FILE]

Workload (bench.py's, `make_workload`): `SlamConfig()` at full width (1024^2
grid, sigma 1, 5, 10, K 256); a curve of 2.5 m (10 m/s at 4 Hz) and 0.03 rad
a frame from the origin; a corridor world of 120 landmarks a scan; float32
polar scans with noise 0.02, rendered in bench.py's rng order from `--seed`.
4 warm-up frames, then `--frames` measured ones.  Every scan is on the device
before anything is timed.

Paths, each timed over the measured frames exactly once a trial, on the
step's CUDA graph (`frontend.StepGraph`, as bench.py times the jitted,
donated step and chunk; each trial has its own graph, captured in its
warm-up):

    per_call_sync  one replay, then torch.cuda.synchronize() after each
                   frame, a host clock per frame   (a live consumer at 4 Hz)
    per_dispatch   one replay a frame with no sync in the loop; one sync and
                   a fetch of the pose at the end  (offline, one call a frame)
    chunked        slam_step_chunk over chunks of `--chunk` frames (views of
                   the scans on the device: the graph replayed a frame, no
                   sync); one sync and a fetch at the end
                                                   (offline, a recorded sequence)

Each kept output is a copy of the graph's packed row (one device copy a
frame).  The eager step is not timed here: it is the parent commit's step,
and this bench's eager traced window reads its stages, busy time and idle
share.

Every trial of every path starts from `init_state` on scan 0 and steps the
warm-up scans 1..4 untimed.  (bench.py's chunked path starts its first chunk
at frame 5 from the state at frame 0, and feeds the 200 frames four times, so
that its later passes time a lost track; this bench does neither.)  The
`--trials` trials run the paths in turns: p1, p2, p3, p1, ...  Each rate goes
to stderr the moment it is measured.

Checks (any failure raises; no result is printed): every path and trial ends
in a final state equal bit for bit to every other, with equal outputs; their
keyframe, retrack and DoH launch counts are equal; the ATE of the measured
poses against the rendered ground truth is under 5 m (a lost track).

Read besides time, never inside a timed trial: DoH launches per trial
(`ops/cuda/doh_cuda.launches`), keyframes and retracks (`StepOutput`); and,
after the trials, torch.profiler windows over `init_state`, `--trace-frames`
per-call steps and `init_state` again: one of the eager step (`trace_window`),
from which come each `slam_step.<stage>` range's host and device ms per step
(`utils/profiling.step_profile`) and the DoH kernel's device ms per launch
against its bound (`doh_cuda.doh_bound_ms`); and one of the graph's replays
(`graph=True`).  The device's busy time and idle share come from the window
of the replays, the step the paths timed.  A trace that lost
device events raises (`check_trace`).

No whole-step bound: bench.py's FLOP floor counted the TPU's Toeplitz DoH
matmuls against TPU peaks.  The step is host-bound (the device idles most of
a step), and the port has no work model of its other stages, so
`step_bound` is null; the DoH kernel alone carries a bound.

On the CPU (`--cpu`, a rehearsal): the same run with the plain twins; every
device metric is null and named in `not_measured`.  Without `--cpu` and
without CUDA it raises; it never falls back to the CPU.

Output: the last stdout line is one JSON object (also written to `--out`):
  metric, value (median chunked frames/s), unit, vs_baseline (value / 1.0
  frames/s, the reference on an i7), per_call_sync_fps, per_dispatch_fps,
  chunked_fps (medians over trials), chunk_frames, measured_frames,
  device_kind, as bench.py; and device ("cuda" or "cpu"), card (nvidia-smi's
  name and power limit), power_limit_w, seed, trials, warm_frames, spread
  ({path: {min, max, trials}} frames/s), per_call_ms_p50, per_call_ms_p95,
  per_call_samples (per_call_sync's host ms per frame, pooled over trials),
  trace_frames, device_idle_share, device_busy_ms and trace_window_ms (per
  traced step of the timed step; the profiler stretches the host's time, so
  the window is longer than an untraced step), device_idle_share_untraced
  (1 - the traced busy ms over per_call_ms_p50), eager_window ({busy_ms,
  window_ms, idle_share} of the eager window), stages
  ({stage: {host_ms, device_ms}} per traced eager step), doh_launches
  ({path: launches per trial over the measured frames: one a frame, the step
  detects on every frame}), doh_launches_total (every launch of the run, the
  graphs' warm-up and the traced windows included), trace_lost_unread
  (launches in the windows' unread opening init_state that the trace holds no
  device event of), doh_device_ms (per launch, in the eager window),
  doh_graph_device_ms (per launch inside the traced replays), doh_bound_ms,
  doh_bound_by, doh_bound_share, ate_m, fit_ok_share, keyframes, retracks
  (per trial over the measured frames), step_bound (null) and
  step_bound_note.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from radarslampy_tpu_torch import resolve_device
from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.models import frontend as F
from radarslampy_tpu_torch.models.trajectory import compute_rmse
from radarslampy_tpu_torch.ops.cuda import doh_cuda
from radarslampy_tpu_torch.sim import fakedata as fd
from radarslampy_tpu_torch.utils.checkpoint import states_equal
from radarslampy_tpu_torch.utils.profiling import (card_line, device_busy_us, lost_launches,
                                                   step_profile, synchronize)

PATHS = ("per_call_sync", "per_dispatch", "chunked")
N_WARM = 4
SPEED_M_S = 10.0      # bench.py: ~10 m/s, 2.5 m a frame at 4 Hz
TURN_RAD = 0.03       # rad a frame
PER_SCAN = 120.0      # corridor landmarks a scan
NOISE = 0.02
ATE_LIMIT_M = 5.0     # PERF.md's lost-track limit
BASELINE_FPS = 1.0    # the reference on an i7-8650U (BASELINE.md), as bench.py
STEP_BOUND_NOTE = ("no whole-step bound: the step is host-bound and the port has no work "
                   "model of its stages beside DoH; bench.py's bound counted TPU matmuls")


def make_workload(cfg: SlamConfig, seed: int = 0, n_warm: int = N_WARM, n_meas: int = 200):
    """bench.py's sequence -> (poses [T, 3] float64, scans [T, A, Wpad]
    float32), T = n_warm + n_meas + 1, in bench.py's rng order: the world
    first, then each scan's noise."""
    rng = np.random.default_rng(seed)
    T = n_warm + n_meas + 1
    poses = np.zeros((T, 3))
    v = SPEED_M_S * cfg.scan_period_s
    for t in range(1, T):
        th = poses[t - 1, 2]
        poses[t] = poses[t - 1] + [v * np.cos(th), v * np.sin(th), TURN_RAD]
    world_pts, world_refl = fd.make_world_corridor(rng, poses, cfg.max_range_clip_m,
                                                   per_scan=PER_SCAN)
    scans = np.stack([fd.render_polar_scan(world_pts, world_refl, p, cfg, rng=rng, noise=NOISE)
                      for p in poses])
    return poses, scans


class Trial(NamedTuple):
    fps: float
    frame_ms: list          # host ms per frame (per_call_sync only)
    state: F.SlamState      # the final state
    outs: F.StepOutput      # every field stacked over the measured frames
    doh_launches: int       # over the measured frames


def run_trial(path: str, scans, maps, cfg: SlamConfig, chunk: int = 100) -> Trial:
    """One trial of `path` on its own StepGraph: init_state and the N_WARM
    warm-up steps untimed (the first captures the graph), then the measured
    scans scans[N_WARM + 1:] once, timed on the host clock."""
    if path not in PATHS:
        raise ValueError(f"unknown path {path!r}; one of {PATHS}")
    g = F.StepGraph(maps, cfg)
    g.load(F.init_state(scans[0], np.zeros(3), maps, cfg))
    for i in range(1, N_WARM + 1):
        g.step(scans[i])
    synchronize(g.state.pose)
    timed = scans[N_WARM + 1:]
    launches0 = doh_cuda.launches
    frame_ms, rows, outs = [], [], []
    t0 = time.perf_counter()
    if path == "per_call_sync":
        for scan in timed:
            t = time.perf_counter()
            row = g.step(scan)
            synchronize(row)
            frame_ms.append((time.perf_counter() - t) * 1e3)
            rows.append(row.clone())
    elif path == "per_dispatch":
        for scan in timed:
            rows.append(g.step(scan).clone())
    else:
        state = g.snapshot()
        for part in torch.split(timed, chunk):
            state, out = F.slam_step_chunk(state, part, maps, cfg, g)
            outs.append(out)
    state = state if outs else g.snapshot()
    synchronize(state.pose)
    state.pose.cpu()   # the states chain, so this fetch waits for every step
    seconds = time.perf_counter() - t0
    launches = doh_cuda.launches - launches0
    stacked = (F.StepOutput(*(torch.cat(field) for field in zip(*outs))) if outs
               else F.unpack_output(torch.stack(rows)))
    return Trial(len(timed) / seconds, frame_ms, state, stacked, launches)


class TraceReading(NamedTuple):
    stages: dict            # {stage: (host ms, device ms)} per step
    window_ms: float        # the steps' window, per step
    busy_ms: float          # device busy time inside it, per step
    doh_ms: list            # device ms of each DoH kernel from the first step on
    doh_launches: int       # DoH launches from the first step on
    lost_unread: int        # launches before the first step whose device events are lost


def trace_window(scans, maps, cfg: SlamConfig, steps: int, graph: bool = False) -> TraceReading:
    """Under torch.profiler (CUDA activity on the card): init_state on scan 0,
    `steps` per-call steps on scans 1..steps, then init_state again.  With
    `graph` the steps are replays of a StepGraph captured before the window
    (on an init_state and one step of its own, so that no capture is
    traced), each (its input's staging copy and its replay) inside one
    "step_graph.step" range, then a sync; a replay has no ranges inside it,
    so there are no stages.

    Only the steps are read, and the DoH kernels from the first step's start
    on: the second init_state puts a DoH launch there whatever the steps
    retrack.  The first init_state is not read: on an H100 a trace that
    follows others in the same process can lack the device events of launches
    made in its first moments (chip_smoke.py's phase 11 lost that
    init_state's DoH kernel; the bench alone, whose trace is its process's
    first, lost none), for a reason not known.  So the reading is checked
    (`check_trace`): a trace that lost a device event from the first step on
    raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    on_card = scans.device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    g = None
    if graph:
        g = F.StepGraph(maps, cfg)
        g.load(F.init_state(scans[0], np.zeros(3), maps, cfg))
        synchronize(g.step(scans[1]))
    with profile(activities=activities) as prof:
        state = F.init_state(scans[0], np.zeros(3), maps, cfg)
        synchronize(state.pose)
        if graph:
            g.load(state)
        launches0 = doh_cuda.launches
        for scan in scans[1:steps + 1]:
            if graph:
                synchronize(g.step(scan))
            else:
                state, _ = F.slam_step(state, scan, maps, cfg)
                synchronize(state.pose)
        synchronize(F.init_state(scans[0], np.zeros(3), maps, cfg).pose)
    events = prof.events()
    if graph:
        replays = [e for e in events
                   if e.device_type == DeviceType.CPU and e.name == "step_graph.step"]
        if len(replays) != steps:
            raise ValueError(f"expected {steps} step_graph.step ranges, got {len(replays)}")
        t0 = min(e.time_range.start for e in replays)
        t1 = max(e.time_range.end for e in replays)
        stages, window_ms = {}, (t1 - t0) / 1e3
        busy_ms = device_busy_us(events, t0, t1,
                                 skip=lambda e: e.name.startswith("step_graph")) / 1e3
    else:
        stages, window_ms, busy_ms = step_profile(prof, steps)
        t0 = min(e.time_range.start for e in events
                 if e.device_type == DeviceType.CPU and e.name == "slam_step")
    doh_ms = [e.time_range.elapsed_us() / 1e3 for e in events
              if e.device_type != DeviceType.CPU and "doh_kernel" in e.name
              and e.time_range.start >= t0]
    launches = doh_cuda.launches - launches0
    lost = lost_launches(events, t0)
    check_trace(lost, len(doh_ms), launches)
    return TraceReading(stages, window_ms / steps, busy_ms / steps, doh_ms, launches,
                        lost_launches(events) - lost)


def check_trace(lost: int, doh_kernels: int, doh_launches: int) -> None:
    """Raise RuntimeError if a trace lost device events: `lost` launches
    without their device event (`utils/profiling.lost_launches`), or DoH
    kernels that differ in number from the launches counted over the same
    span."""
    if lost:
        raise RuntimeError(f"{lost} launches from the first traced step on have no device "
                           f"event: the trace lost device events")
    if doh_kernels != doh_launches:
        raise RuntimeError(f"the trace holds {doh_kernels} DoH kernels, the counter "
                           f"{doh_launches} launches: the trace lost device events")


def _counts(trial: Trial) -> tuple:
    return (int(trial.outs.is_keyframe.sum()), int(trial.outs.did_retrack.sum()),
            trial.doh_launches)


def check_trials(trials: dict) -> None:
    """Every trial of every path ends in the same state, outputs and counts
    as the first; raises RuntimeError naming the first that does not."""
    ref = trials[PATHS[0]][0]
    for path, runs in trials.items():
        for k, r in enumerate(runs):
            what = f"{path} trial {k + 1} against {PATHS[0]} trial 1"
            if not states_equal(r.state, ref.state):
                raise RuntimeError(f"{what}: the final states differ")
            unequal = [f for f in F.StepOutput._fields
                       if not torch.equal(getattr(r.outs, f), getattr(ref.outs, f))]
            if unequal:
                raise RuntimeError(f"{what}: outputs {unequal} differ")
            if _counts(r) != _counts(ref):
                raise RuntimeError(f"{what}: (keyframes, retracks, DoH launches) "
                                   f"{_counts(r)} != {_counts(ref)}")


def _power_limit_w(card: str):
    m = re.search(r"([\d.]+)\s*W\s*$", card)
    return float(m.group(1)) if m else None


def run_bench(cfg: SlamConfig, device="cuda", seed: int = 0, frames: int = 200,
              trials: int = 3, chunk: int = 100, trace_frames: int = 20) -> dict:
    """Render the workload, run every path `trials` times in turns on the
    step's graph, check the trials, trace `trace_frames` eager steps and
    replays -> the result object."""
    dev = resolve_device(device)
    if not (frames >= 1 and trials >= 1 and chunk >= 1
            and 1 <= trace_frames <= N_WARM + frames):
        raise ValueError(f"need frames, trials, chunk >= 1 and 1 <= trace_frames <= "
                         f"{N_WARM + frames}; got {frames}, {trials}, {chunk}, {trace_frames}")
    on_card = dev.type == "cuda"
    launches_start = doh_cuda.launches
    t = time.time()
    poses, scans_np = make_workload(cfg, seed, N_WARM, frames)
    scans = torch.as_tensor(scans_np, device=dev)
    maps = F.build_frame_maps(cfg, dev)
    synchronize(scans)
    print(f"# workload: {len(scans)} scans {tuple(scans.shape[1:])} float32 on {dev}, "
          f"rendered and moved in {time.time() - t:.1f} s", file=sys.stderr, flush=True)

    runs = {p: [] for p in PATHS}
    for k in range(trials):
        for path in PATHS:
            r = run_trial(path, scans, maps, cfg, chunk)
            runs[path].append(r)
            print(f"# measured {path} trial {k + 1}/{trials}: {r.fps:.3f} frames/s",
                  file=sys.stderr, flush=True)
    check_trials(runs)
    ref = runs[PATHS[0]][0]
    est = ref.outs.pose.cpu().numpy().astype(np.float64)
    ate = compute_rmse(poses[N_WARM + 1:], est)
    if not ate < ATE_LIMIT_M:
        raise RuntimeError(f"ATE {ate} m over {frames} frames is not under {ATE_LIMIT_M} m: "
                           f"the track is lost")
    keyframes, retracks, _ = _counts(ref)

    eager_tr = trace_window(scans, maps, cfg, trace_frames)
    tr = trace_window(scans, maps, cfg, trace_frames, graph=True)
    bound, bound_by = doh_cuda.doh_bound_ms(cfg.cart_size, maps.doh.radii)
    doh_ms = statistics.mean(eager_tr.doh_ms) if eager_tr.doh_ms else None
    samples = [ms for r in runs["per_call_sync"] for ms in r.frame_ms]
    p50 = float(np.percentile(samples, 50))
    fps = {p: [r.fps for r in runs[p]] for p in PATHS}
    med = {p: statistics.median(v) for p, v in fps.items()}
    card = card_line() if on_card else None

    def on_device(x):
        return x if on_card else None

    result = {
        "metric": (f"frames/s of the SLAM step (slam_step_chunk, chunks of {chunk}) on "
                   f"bench.py's corridor: {cfg.num_azimuths}x{cfg.clipped_range_bins} polar -> "
                   f"{cfg.cart_size}^2 Cartesian at {cfg.cart_resolution_m:.4f} m/px, 2.5 m "
                   f"and {TURN_RAD} rad a frame; median of {trials} trials, one sync and a "
                   f"fetch of the chained state at the end"),
        "value": med["chunked"],
        "unit": "frames/s",
        "vs_baseline": med["chunked"] / BASELINE_FPS,
        "per_call_sync_fps": med["per_call_sync"],
        "per_dispatch_fps": med["per_dispatch"],
        "chunked_fps": med["chunked"],
        "chunk_frames": chunk,
        "measured_frames": frames,
        "device_kind": torch.cuda.get_device_name(dev) if on_card else None,
        "device": dev.type,
        "card": card,
        "power_limit_w": _power_limit_w(card) if on_card else None,
        "seed": seed,
        "trials": trials,
        "warm_frames": N_WARM,
        "spread": {p: {"min": min(v), "max": max(v), "trials": v} for p, v in fps.items()},
        "per_call_ms_p50": p50,
        "per_call_ms_p95": float(np.percentile(samples, 95)),
        "per_call_samples": len(samples),
        "trace_frames": trace_frames,
        "device_idle_share": on_device(1.0 - tr.busy_ms / tr.window_ms),
        "device_idle_share_untraced": on_device(1.0 - tr.busy_ms / p50),
        "device_busy_ms": on_device(tr.busy_ms),
        "trace_window_ms": tr.window_ms,
        "eager_window": {
            "busy_ms": on_device(eager_tr.busy_ms), "window_ms": eager_tr.window_ms,
            "idle_share": on_device(1.0 - eager_tr.busy_ms / eager_tr.window_ms)},
        "stages": {name.split(".", 1)[-1]: {"host_ms": h, "device_ms": on_device(d)}
                   for name, (h, d) in eager_tr.stages.items()},
        "doh_launches": {p: runs[p][0].doh_launches for p in PATHS},
        "doh_launches_total": doh_cuda.launches - launches_start,
        "trace_lost_unread": on_device(tr.lost_unread + eager_tr.lost_unread),
        "doh_device_ms": on_device(doh_ms),
        "doh_graph_device_ms": on_device(statistics.mean(tr.doh_ms) if tr.doh_ms else None),
        "doh_bound_ms": bound,
        "doh_bound_by": bound_by,
        "doh_bound_share": on_device(bound / doh_ms if doh_ms else None),
        "ate_m": ate,
        "fit_ok_share": float(ref.outs.fit_ok.float().mean()),
        "keyframes": keyframes,
        "retracks": retracks,
        "step_bound": None,
        "step_bound_note": STEP_BOUND_NOTE,
    }
    if not on_card:
        result["not_measured"] = {
            k: "not measured: the run was on the CPU (--cpu)"
            for k in ("device_kind", "card", "power_limit_w", "device_idle_share",
                      "device_idle_share_untraced", "device_busy_ms", "stages.device_ms",
                      "trace_lost_unread", "eager_window.busy_ms", "eager_window.idle_share",
                      "doh_device_ms", "doh_graph_device_ms", "doh_bound_share")}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU with the plain twins (device metrics null)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=200, help="measured frames")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--chunk", type=int, default=100, help="frames a chunk (chunked path)")
    ap.add_argument("--trace-frames", type=int, default=20,
                    help="per-call steps in the torch.profiler window")
    ap.add_argument("--out", default=None, help="also write the result object here")
    a = ap.parse_args(argv)
    device = resolve_device("cpu" if a.cpu else "cuda")
    result = run_bench(SlamConfig(), device, seed=a.seed, frames=a.frames, trials=a.trials,
                       chunk=a.chunk, trace_frames=a.trace_frames)
    line = json.dumps(result)
    if a.out:
        with open(a.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
