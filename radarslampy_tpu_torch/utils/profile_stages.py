"""Per-stage profile of the SLAM step: the port of
`radarslampy_tpu/utils/profile_stages.py`.

Times each stage of `models/frontend.slam_step` as its own call, on the
intermediates of a real `init_state` and `slam_step` over two frames, and the
whole step chained over the two frames in turn, on the CUDA device (the CPU
with `--cpu` or `device="cpu"`).  The stages do not add up to the step exactly
(the step shares work and host syncs between them), but they rank where the
time goes, which is what choosing the next kernel needs.

Timing (`_pipelined_time`, the JAX package's method): `calls` calls back to
back with one sync at the end, the median over `trials`, per call.  On the
card the clock is CUDA events recorded before the first call and after the
last; on the CPU, `time.perf_counter`.  Host work that the stage does between
its launches (the port's step syncs the host inside peeling and the keyframe
decision) counts, as the JAX method counts dispatch.  `_time_fn` gives the
step's wall time with a sync after every call.

Frames: with `data_root`, the first two PNGs of its "tiny" sequence; without,
two scans rendered by `sim/fakedata` along a 2 m / 0.04 rad arc at the
config's width from a fixed seed, quantised to u8.

CLI: python -m radarslampy_tpu_torch.utils.profile_stages [--cpu] [--iters N] [--out FILE]
Prints and writes one JSON artifact: {"stages": {name: {"us": median_us}}, ...}.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import numpy as np
import torch

from radarslampy_tpu_torch import resolve_device

SEED = 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_fn(fn, *args, device: torch.device, iters: int = 50, warmup: int = 5):
    """Median wall seconds of fn(*args) with a device sync after each call
    (host dispatch included)."""
    for _ in range(warmup):
        fn(*args)
    _sync(device)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _elapsed(run, device: torch.device) -> float:
    """Seconds from before run()'s first launch to after its last, with one
    sync at the end: CUDA events on the card, perf_counter on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        run()
        return time.perf_counter() - t0
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    run()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / 1e3


def _pipelined_time(fn, args, device: torch.device, calls: int = 200, trials: int = 5):
    """Seconds per call of `calls` back-to-back calls with one sync at the
    end, the median over `trials` (after one warm-up call)."""
    fn(*args)
    _sync(device)

    def run():
        for _ in range(calls):
            fn(*args)

    return statistics.median(_elapsed(run, device) for _ in range(trials)) / calls


def _frames(cfg, data_root):
    """Two u8 polar scans [A, Wpad] (see the module docstring)."""
    if data_root is not None:
        from radarslampy_tpu_torch.io import oxford

        seq = oxford.sequence_paths(data_root, "tiny")
        paths = oxford.radar_image_paths(seq["radar"], seq["timestamps"])[:2]
        return [oxford.decode_radar_png(p, cfg, raw_u8=True).power for p in paths]
    from radarslampy_tpu_torch.sim import fakedata as fd

    poses = np.array([[0.0, 0.0, 0.0], [2.0, 0.0, 0.04]])
    scans = fd.render_sequence(np.random.default_rng(SEED), poses, cfg, n_landmarks=1200,
                               with_distortion=True, noise=0.01)
    return [np.clip(np.round(s * 255.0), 0, 255).astype(np.uint8) for _, s in scans]


def profile(cfg=None, data_root=None, iters: int = 50, device="cuda",
            calls: int = 200, trials: int = 5) -> dict:
    from radarslampy_tpu_torch.config import SlamConfig
    from radarslampy_tpu_torch.models import frontend
    from radarslampy_tpu_torch.models.placerecog import scan_context
    from radarslampy_tpu_torch.ops import geometry as geo
    from radarslampy_tpu_torch.ops.features import get_features
    from radarslampy_tpu_torch.ops.grid import warp_polar_to_cartesian
    from radarslampy_tpu_torch.ops.motion import solve_motion, undistort
    from radarslampy_tpu_torch.ops.robust import reject_outliers
    from radarslampy_tpu_torch.ops.tracking import track_klt

    dev = resolve_device(device)
    cfg = cfg or SlamConfig()
    maps = frontend.build_frame_maps(cfg, dev)
    polar0, polar1 = (torch.as_tensor(f, device=dev) for f in _frames(cfg, data_root))

    # intermediates of the real pipeline
    state = frontend.init_state(polar0, np.zeros(3), maps, cfg)
    cart0 = state.prev_cart
    state1, _ = frontend.slam_step(state, polar1, maps, cfg)
    cart1 = state1.prev_cart
    coords, mask = state.feat_px, state.feat_mask
    tr = track_klt(cart0, cart1, coords, mask, cfg)

    # the compositions of frontend._slam_step's peeling and LM stages
    def _reject(prev_px, curr_px, status, vel):
        pu = undistort(vel, frontend._px_to_metric(prev_px, cfg), cfg.scan_period_s)
        cu = undistort(vel, frontend._px_to_metric(curr_px, cfg), cfg.scan_period_s)
        return reject_outliers(pu / cfg.cart_resolution_m, cu / cfg.cart_resolution_m,
                               status, cfg)

    def _fit_and_motion(prev_px, curr_px, live, vel, pose, feat_world):
        cl = frontend._px_to_metric(curr_px, cfg)
        pu = undistort(vel, frontend._px_to_metric(prev_px, cfg), cfg.scan_period_s)
        cu = undistort(vel, cl, cfg.scan_period_s)
        R, h, ok = geo.procrustes_masked(pu, cu, live.to(cu.dtype))
        dth = torch.atan2(R[1, 0], R[0, 0])
        s0, c0 = torch.sin(pose[2]), torch.cos(pose[2])
        pose_init = torch.stack([pose[0] + c0 * h[0] - s0 * h[1],
                                 pose[1] + s0 * h[0] + c0 * h[1],
                                 pose[2] + dth])
        return solve_motion(pose, feat_world, cl, pose_init, live, cfg)

    rej = _reject(coords, tr.coords, tr.status, state.velocity)
    fpolar1 = frontend._dequantize_polar(polar1)

    def timed(fn, *args):
        return _pipelined_time(fn, args, dev, calls=calls, trials=trials)

    stages = {}
    stages["polar_to_cart_warp"] = timed(warp_polar_to_cartesian, fpolar1, maps.warp)
    stages["doh_detect_anms"] = timed(lambda c: get_features(c, cfg, maps.doh), cart1)
    stages["klt_pyramidal"] = timed(lambda a, b, co, mk: track_klt(a, b, co, mk, cfg),
                                    cart0, cart1, coords, mask)
    stages["clique_reject"] = timed(_reject, coords, tr.coords, tr.status, state.velocity)
    stages["procrustes_motion_lm"] = timed(
        _fit_and_motion, coords, tr.coords, rej.inlier_mask, state.velocity, state.pose,
        state.feat_world)
    stages["scan_context"] = timed(lambda p: scan_context(p, cfg), fpolar1)
    stages["keyframe_pointcloud"] = timed(
        lambda p, v: frontend.keyframe_pointcloud(p, v, cfg), fpolar1, state.velocity)

    # the whole step, the state chained through `calls` steps over the two
    # frames in turn (as the driver runs it), from `state` in every trial
    def chain():
        s = state
        for i in range(calls):
            s, _ = frontend.slam_step(s, polar1 if i % 2 else polar0, maps, cfg)

    frontend.slam_step(state, polar1, maps, cfg)
    _sync(dev)
    stages["fused_slam_step"] = statistics.median(
        _elapsed(chain, dev) for _ in range(trials)) / calls

    # the wall time of one step with its sync, dispatch included
    wall_step = _time_fn(lambda: frontend.slam_step(state, polar1, maps, cfg),
                         device=dev, iters=iters)

    return {
        "platform": dev.type,
        "device": str(dev),
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else None,
        "cart_size": cfg.cart_size,
        "iters": iters,
        "stages": {k: {"us": round(v * 1e6, 1)} for k, v in stages.items()},
        "sum_of_stages_us": round((sum(stages.values())
                                   - stages["fused_slam_step"]) * 1e6, 1),
        "fused_step_us": round(stages["fused_slam_step"] * 1e6, 1),
        "fused_step_wall_us_incl_dispatch": round(wall_step * 1e6, 1),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain PyTorch); default: the CUDA device")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    res = profile(iters=a.iters, device="cpu" if a.cpu else "cuda")
    print(json.dumps(res, indent=2))
    if a.out:
        with open(a.out, "w") as f:
            json.dump(res, f, indent=2)
    return res


if __name__ == "__main__":
    main()
