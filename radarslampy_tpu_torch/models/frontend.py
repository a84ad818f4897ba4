"""The per-frame SLAM step on tensors: init_state, slam_step, slam_step_chunk.

Counterpart of `radarslampy_tpu/models/frontend.py`.  One radar frame goes
through

    dequantise -> polar warp -> (use_fmt: FMT rotation seeding KLT) -> KLT ->
    consistency peeling -> Procrustes -> motion-distortion LM ->
    constant-velocity coast gate -> keyframe/retrack decision -> (keyframe:
    DoH + ANMS re-detection on retrack, feature merge, point cloud, scan
    context, map write)

with the JAX package's fixed shapes and masks and the same state containers.
Differences in form, not in result:
  * The keyframe and retrack decisions are taken on the host (one device sync
    per frame) where the JAX step uses `lax.cond`; the peeling loop in
    `ops/robust.py` syncs every few steps as well.
  * `slam_step_chunk` is a Python loop over `slam_step` (the JAX package's
    `lax.scan`).
  * State updates are functional: the map is copied on a keyframe write
    (index_copy), so a state passed in is never modified.

Each stage runs inside a `torch.profiler.record_function` range named
"slam_step.<stage>" (the whole step: "slam_step"), so a profiler trace reads
each stage's host and device time from the step itself.

Conventions: the Cartesian image has the sensor at its centre; local metric
coords are (px - centre) * cart_resolution_m; a pose [x, y, theta] maps local
to world.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.profiler import record_function

from radarslampy_tpu_torch import resolve_device
from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.models.placerecog import scan_context
from radarslampy_tpu_torch.ops import geometry as geo
from radarslampy_tpu_torch.ops.cuda.doh_cuda import DohFilters, build_doh_filters
from radarslampy_tpu_torch.ops.features import get_features, merge_features, top_k_stable
from radarslampy_tpu_torch.ops.fmt import estimate_rotation_fmt
from radarslampy_tpu_torch.ops.grid import (LogPolarMap, WarpMaps, build_logpolar_map,
                                            build_warp_maps, warp_polar_to_cartesian)
from radarslampy_tpu_torch.ops.motion import solve_motion, undistort
from radarslampy_tpu_torch.ops.pointcloud import extract_pointcloud
from radarslampy_tpu_torch.ops.robust import reject_outliers
from radarslampy_tpu_torch.ops.tracking import track_klt


class FrameMaps(NamedTuple):
    """Static per-config data of the step, on its device."""

    warp: WarpMaps          # polar -> Cartesian sample points
    doh: DohFilters         # Gaussian taps of the DoH scale space
    logpolar: LogPolarMap   # log-polar range map of FMT


def build_frame_maps(cfg: SlamConfig, device="cuda") -> FrameMaps:
    dev = resolve_device(device)
    return FrameMaps(warp=build_warp_maps(cfg, dev),
                     doh=build_doh_filters(cfg.doh_sigmas, dev),
                     logpolar=build_logpolar_map(cfg, dev))


class MapState(NamedTuple):
    """Preallocated keyframe store; `cursor` counts the live prefix."""

    poses: torch.Tensor        # [M, 3]
    feat_world: torch.Tensor   # [M, K, 2]
    feat_local: torch.Tensor   # [M, K, 2]
    feat_ids: torch.Tensor     # [M, K] int32 (-1 = none)
    feat_mask: torch.Tensor    # [M, K] bool
    velocities: torch.Tensor   # [M, 3]
    cursor: torch.Tensor       # int32
    descriptors: torch.Tensor  # [M, R, S] scan context
    pc_local: torch.Tensor     # [M, P, 2] sensor-local point cloud (m)
    pc_mask: torch.Tensor      # [M, P] bool
    frame_ids: torch.Tensor    # [M] int32 creating-frame index (-1 = empty)


class SlamState(NamedTuple):
    pose: torch.Tensor        # [3] current world pose
    velocity: torch.Tensor    # [3] body velocity (m/s, rad/s)
    prev_polar: torch.Tensor  # [A, Wp] previous polar scan
    prev_cart: torch.Tensor   # [S, S] previous Cartesian image (KLT source)
    feat_px: torch.Tensor     # [K, 2] tracked feature coords in prev_cart (x, y)
    feat_mask: torch.Tensor   # [K] bool
    feat_id: torch.Tensor     # [K] int32 landmark id per slot (-1 free)
    next_id: torch.Tensor     # int32 landmark id counter
    feat_world: torch.Tensor  # [K, 2] keyframe-anchored world positions
    kf_pose: torch.Tensor     # [3] pose of the last keyframe
    map: MapState
    frame_idx: torch.Tensor   # int32


class StepOutput(NamedTuple):
    pose: torch.Tensor          # [3]
    velocity: torch.Tensor      # [3]
    n_tracked: torch.Tensor     # int32 features surviving KLT
    n_inliers: torch.Tensor     # int32 features surviving outlier rejection
    is_keyframe: torch.Tensor   # bool
    did_retrack: torch.Tensor   # bool
    fmt_rotation: torch.Tensor  # float FMT rotation estimate (0: FMT off)
    fit_ok: torch.Tensor        # bool
    fmt_scale: torch.Tensor     # float FMT log-polar scale estimate (1: FMT off)


def _px_to_metric(px, cfg: SlamConfig):
    return (px - cfg.cart_center) * cfg.cart_resolution_m


def _i32(x, device):
    return torch.tensor(x, dtype=torch.int32, device=device)


def empty_map(cfg: SlamConfig, dtype=torch.float32, device="cuda") -> MapState:
    dev = resolve_device(device)
    M, K, P = cfg.max_keyframes, cfg.k_max, cfg.pc_points_per_kf

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    return MapState(
        poses=zeros(M, 3),
        feat_world=zeros(M, K, 2),
        feat_local=zeros(M, K, 2),
        feat_ids=torch.full((M, K), -1, dtype=torch.int32, device=dev),
        feat_mask=zeros(M, K, dt=torch.bool),
        velocities=zeros(M, 3),
        cursor=_i32(0, dev),
        descriptors=zeros(M, cfg.sc_rings, cfg.sc_sectors),
        pc_local=zeros(M, P, 2),
        pc_mask=zeros(M, P, dt=torch.bool),
        frame_ids=torch.full((M,), -1, dtype=torch.int32, device=dev),
    )


def keyframe_pointcloud(polar, velocity, cfg: SlamConfig):
    """Strongest `pc_points_per_kf` azimuth peaks as undistorted sensor-local
    metric points [P, 2] and their mask [P]."""
    pc = extract_pointcloud(polar, cfg)
    A, P = pc.range_idx.shape
    phi = (torch.arange(A, dtype=polar.dtype, device=polar.device)
           * (2.0 * math.pi / A))[:, None]
    r = pc.range_idx * cfg.range_resolution_m
    pts = torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)  # [A, P, 2]
    score = torch.where(pc.mask, pc.power, torch.full_like(pc.power, float("-inf")))
    vals, idx = top_k_stable(score.reshape(A * P), cfg.pc_points_per_kf)
    keep = torch.isfinite(vals)
    sel = undistort(velocity, pts.reshape(A * P, 2)[idx], cfg.scan_period_s)
    return torch.where(keep[:, None], sel, torch.zeros_like(sel)), keep


def assign_new_ids(old_mask, new_mask, old_ids, next_id):
    """Consecutive fresh ids from `next_id` for newly filled slots; surviving
    slots keep theirs; free slots are -1."""
    fresh = new_mask & ~old_mask
    rank = torch.cumsum(fresh.to(torch.int32), 0) - 1
    ids = torch.where(fresh, next_id + rank,
                      torch.where(new_mask, old_ids, torch.full_like(old_ids, -1)))
    return ids.to(torch.int32), (next_id + torch.sum(fresh.to(torch.int32))).to(torch.int32)


def _features_to_world(px, mask, pose, velocity, cfg: SlamConfig):
    """Pixel features -> (undistorted local metric, world positions), zero
    where masked."""
    und = undistort(velocity, _px_to_metric(px, cfg), cfg.scan_period_s)
    T = geo.pose_to_transform(pose)
    world = und @ T[:2, :2].T + T[:2, 2]
    keep = mask[:, None]
    return (torch.where(keep, und, torch.zeros_like(und)),
            torch.where(keep, world, torch.zeros_like(world)))


def _write_keyframe(m: MapState, pose, feat_world, feat_local, feat_ids, feat_mask,
                    velocity, descriptor, pc_local, pc_mask, frame_idx) -> MapState:
    M = m.poses.shape[0]
    c = torch.clamp(m.cursor, max=M - 1).to(torch.int64).reshape(1)

    def upd(buf, row):
        return buf.index_copy(0, c, row.to(buf.dtype).reshape((1,) + buf.shape[1:]))

    return MapState(
        poses=upd(m.poses, pose),
        feat_world=upd(m.feat_world, feat_world),
        feat_local=upd(m.feat_local, feat_local),
        feat_ids=upd(m.feat_ids, feat_ids),
        feat_mask=upd(m.feat_mask, feat_mask),
        velocities=upd(m.velocities, velocity),
        cursor=torch.clamp(m.cursor + 1, max=M).to(torch.int32),
        descriptors=upd(m.descriptors, descriptor),
        pc_local=upd(m.pc_local, pc_local),
        pc_mask=upd(m.pc_mask, pc_mask),
        frame_ids=upd(m.frame_ids, frame_idx),
    )


def _dequantize_polar(polar):
    """u8 power bytes -> float32 (u8/255); float scans pass through."""
    if not polar.dtype.is_floating_point:
        return polar.to(torch.float32) * (1.0 / 255.0)
    return polar


def init_state(polar0, init_pose, maps: FrameMaps, cfg: SlamConfig) -> SlamState:
    """First frame: detect features, anchor them at the initial pose, write
    keyframe 0.  Runs on the device of `maps`."""
    dev = maps.warp.idx0.device
    polar0 = _dequantize_polar(torch.as_tensor(polar0, device=dev))
    cart = warp_polar_to_cartesian(polar0, maps.warp)
    cands = get_features(cart, cfg, maps.doh)
    K = cfg.k_max
    coords, mask = merge_features(torch.zeros((K, 2), dtype=cart.dtype, device=dev),
                                  torch.zeros(K, dtype=torch.bool, device=dev), cands)
    ids, next_id = assign_new_ids(torch.zeros(K, dtype=torch.bool, device=dev), mask,
                                  torch.full((K,), -1, dtype=torch.int32, device=dev),
                                  _i32(0, dev))
    pose = torch.as_tensor(init_pose, dtype=torch.float32, device=dev)
    vel = torch.zeros(3, dtype=cart.dtype, device=dev)
    feat_local, feat_world = _features_to_world(coords, mask, pose, vel, cfg)
    pc_pts, pc_ok = keyframe_pointcloud(polar0, vel, cfg)
    m = _write_keyframe(empty_map(cfg, cart.dtype, dev), pose, feat_world, feat_local,
                        ids, mask, vel, scan_context(polar0, cfg), pc_pts, pc_ok,
                        _i32(0, dev))
    return SlamState(pose=pose, velocity=vel, prev_polar=polar0, prev_cart=cart,
                     feat_px=coords, feat_mask=mask, feat_id=ids, next_id=next_id,
                     feat_world=feat_world, kf_pose=pose, map=m, frame_idx=_i32(0, dev))


def slam_step(state: SlamState, polar, maps: FrameMaps, cfg: SlamConfig):
    """One radar frame through the pipeline -> (new state, StepOutput)."""
    with record_function("slam_step"):
        return _slam_step(state, polar, maps, cfg)


def _slam_step(state: SlamState, polar, maps: FrameMaps, cfg: SlamConfig):
    dev = state.pose.device
    with record_function("slam_step.warp"):
        polar = _dequantize_polar(torch.as_tensor(polar, device=dev))
        cart = warp_polar_to_cartesian(polar, maps.warp)

    # ---- FMT rotation + log-polar scale; the rotation about the sensor
    # pixel seeds KLT as an initial flow, so turns whose pixel motion exceeds
    # the pyramid's reach stay tracked ----
    init_flow = None
    if cfg.use_fmt:
        with record_function("slam_step.fmt"):
            fmt = estimate_rotation_fmt(state.prev_polar, polar, cfg, grid=maps.logpolar)
            fmt_rot, fmt_scale = fmt.rot_rad, fmt.scale
            sR, cR = torch.sin(fmt_rot), torch.cos(fmt_rot)
            d = state.feat_px - cfg.cart_center
            pred = torch.stack([cR * d[:, 0] - sR * d[:, 1],
                                sR * d[:, 0] + cR * d[:, 1]], dim=-1) + cfg.cart_center
            init_flow = pred - state.feat_px
    else:
        fmt_rot = torch.zeros((), dtype=cart.dtype, device=dev)
        fmt_scale = torch.ones((), dtype=cart.dtype, device=dev)

    with record_function("slam_step.klt"):
        tr = track_klt(state.prev_cart, cart, state.feat_px, state.feat_mask, cfg,
                       init_flow=init_flow)
        n_tracked = torch.sum(tr.status.to(torch.int32))

    # ---- consistency peeling on velocity-undistorted points ----
    with record_function("slam_step.peeling"):
        prev_local = _px_to_metric(state.feat_px, cfg)
        curr_local = _px_to_metric(tr.coords, cfg)
        prev_und = undistort(state.velocity, prev_local, cfg.scan_period_s)
        curr_und = undistort(state.velocity, curr_local, cfg.scan_period_s)
        rej = reject_outliers(prev_und / cfg.cart_resolution_m,
                              curr_und / cfg.cart_resolution_m, tr.status, cfg)
        live = rej.inlier_mask
        n_inliers = rej.n_inliers

    with record_function("slam_step.lm"):
        # ---- rigid fit on sensor-centred metric coords ----
        R, h, fit_ok = geo.procrustes_masked(prev_und, curr_und, live.to(cart.dtype))
        dth = torch.atan2(R[1, 0], R[0, 0])
        s0, c0 = torch.sin(state.pose[2]), torch.cos(state.pose[2])
        pose_init = torch.stack([state.pose[0] + c0 * h[0] - s0 * h[1],
                                 state.pose[1] + s0 * h[0] + c0 * h[1],
                                 state.pose[2] + dth])

        # ---- motion-distortion LM ----
        sol = solve_motion(state.pose, state.feat_world, curr_local, pose_init, live, cfg)
        use_sol = sol.ok & fit_ok
        pose_meas = torch.where(use_sol, sol.pose, pose_init)
        vel_meas = torch.where(use_sol, sol.velocity, state.velocity)

        # ---- degenerate-fit gate: coast on constant velocity ----
        Tp = cfg.scan_period_s
        v = state.velocity
        pose_cv = torch.stack([state.pose[0] + (c0 * v[0] - s0 * v[1]) * Tp,
                               state.pose[1] + (s0 * v[0] + c0 * v[1]) * Tp,
                               state.pose[2] + v[2] * Tp])
        confident = n_inliers >= cfg.min_inliers_accept
        pose = torch.where(confident, pose_meas, pose_cv)
        velocity = torch.where(confident, vel_meas, state.velocity)
        fit_ok = fit_ok & confident

    # ---- keyframe decision (taken on the host: one sync) ----
    with record_function("slam_step.decision"):
        retrack_t = n_inliers <= cfg.n_features_before_retrack
        dth_kf = torch.abs(geo.wrap_angle(pose[2] - state.kf_pose[2]))
        dtrans2 = torch.sum((pose[:2] - state.kf_pose[:2]) ** 2)
        kf_good = (dth_kf >= cfg.kf_rot_threshold_rad) | (dtrans2 >= cfg.kf_trans_threshold_m**2)
        make_kf_t = retrack_t | kf_good
        make_kf, retrack = (bool(b) for b in torch.stack([make_kf_t, retrack_t]).tolist())

    frame_idx = (state.frame_idx + 1).to(torch.int32)
    if make_kf:
        with record_function("slam_step.keyframe"):
            coords, mask = tr.coords, live
            if retrack:
                coords, mask = merge_features(coords, mask, get_features(cart, cfg, maps.doh))
            ids, next_id = assign_new_ids(live, mask, state.feat_id, state.next_id)
            feat_local, feat_world = _features_to_world(coords, mask, pose, velocity, cfg)
            pc_pts, pc_ok = keyframe_pointcloud(polar, velocity, cfg)
            new_map = _write_keyframe(state.map, pose, feat_world, feat_local, ids, mask,
                                      velocity, scan_context(polar, cfg), pc_pts, pc_ok,
                                      frame_idx)
            kf_pose = pose
    else:
        coords, mask = tr.coords, live
        ids, next_id = state.feat_id, state.next_id
        feat_world, kf_pose, new_map = state.feat_world, state.kf_pose, state.map

    new_state = SlamState(pose=pose, velocity=velocity, prev_polar=polar, prev_cart=cart,
                          feat_px=coords, feat_mask=mask, feat_id=ids, next_id=next_id,
                          feat_world=feat_world, kf_pose=kf_pose, map=new_map,
                          frame_idx=frame_idx)
    out = StepOutput(pose=pose, velocity=velocity, n_tracked=n_tracked,
                     n_inliers=n_inliers, is_keyframe=make_kf_t, did_retrack=retrack_t,
                     fmt_rotation=fmt_rot, fit_ok=fit_ok, fmt_scale=fmt_scale)
    return new_state, out


def slam_step_chunk(state: SlamState, polars, maps: FrameMaps, cfg: SlamConfig):
    """F frames [F, A, Wpad] through `slam_step` in turn -> (state, StepOutput
    with every field stacked to [F, ...])."""
    outs = []
    for f in range(len(polars)):
        state, out = slam_step(state, polars[f], maps, cfg)
        outs.append(out)
    return state, StepOutput(*(torch.stack(field) for field in zip(*outs)))
