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
     rendered ground truth, chunk == per-frame; the time of each stage of
     the step; then the same step at a small config on the card and on the
     CPU, which must agree.
Then the card line again, one JSON line describing every kernel, and as the
last line `{"ok": true, "device": {...}}`.  Any failure raises and exits
non-zero; without a CUDA device, or without the package beside this file, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time

T0 = time.time()

# H100 SXM data sheet: HBM3 bandwidth and fp32 rate of the CUDA cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
N_FRAMES = 12


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
            us = next((getattr(ev, k) for k in ("device_time_total", "cuda_time_total")
                       if getattr(ev, k, 0)), 0)
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


def stage_ms(torch, cfg, maps, state, frame):
    """Host time of each stage of one slam_step, synchronised around each
    (median of 5), from `state` on `frame`; the retrack stage (DoH + ANMS +
    merge) is timed whether or not this frame needs it."""
    from radarslampy_tpu_torch.models import frontend as F
    from radarslampy_tpu_torch.ops.features import get_features, merge_features
    from radarslampy_tpu_torch.ops.grid import warp_polar_to_cartesian
    from radarslampy_tpu_torch.ops.motion import solve_motion, undistort
    from radarslampy_tpu_torch.ops.robust import reject_outliers
    from radarslampy_tpu_torch.ops.tracking import track_klt

    def timed(fn):
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        return out, statistics.median(ts)

    res = {}
    polar = F._dequantize_polar(torch.as_tensor(frame, device="cuda"))
    cart, res["warp"] = timed(lambda: warp_polar_to_cartesian(polar, maps.warp))
    tr, res["klt"] = timed(lambda: track_klt(state.prev_cart, cart, state.feat_px,
                                             state.feat_mask, cfg))
    prev = undistort(state.velocity, F._px_to_metric(state.feat_px, cfg), cfg.scan_period_s)
    curr_local = F._px_to_metric(tr.coords, cfg)
    curr = undistort(state.velocity, curr_local, cfg.scan_period_s)
    r = cfg.cart_resolution_m
    rej, res["outliers"] = timed(lambda: reject_outliers(prev / r, curr / r, tr.status, cfg))
    _, res["lm"] = timed(lambda: solve_motion(state.pose, state.feat_world, curr_local,
                                              state.pose, rej.inlier_mask, cfg))
    _, res["retrack"] = timed(lambda: merge_features(tr.coords, rej.inlier_mask,
                                                     get_features(cart, cfg, maps.doh)))
    _, res["keyframe_cloud"] = timed(lambda: F.keyframe_pointcloud(polar, state.velocity, cfg))
    _, res["step"] = timed(lambda: F.slam_step(state, frame, maps, cfg))
    return res


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
        state_before_last = state
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
    stages = stage_ms(torch, cfg, maps, state_before_last, frames[-1])
    log("stage ms (host clock, synchronised, median of 5): "
        + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))

    # the same step on the card and on the CPU (plain twins) at a small config
    small = SlamConfig(cart_size=256, cart_downsample=16, n_candidates=256,
                       max_keyframes=16)
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

    doh_row["launches"] = launches
    print(card_line(), flush=True)
    print(json.dumps({"kernels": [doh_row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
