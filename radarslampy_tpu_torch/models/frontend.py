"""The per-frame SLAM step on tensors: init_state, slam_step, slam_step_chunk,
StepGraph, the step captured as one CUDA graph, and the batched step of D
segments in lock-step (`batched_init_state`, `batched_slam_step`,
`StepGraph(..., batch=D)`).

Counterpart of `radarslampy_tpu/models/frontend.py`.  One radar frame goes
through

    dequantise -> polar warp -> (use_fmt: FMT rotation seeding KLT) -> KLT ->
    consistency peeling -> Procrustes -> motion-distortion LM ->
    constant-velocity coast gate -> keyframe/retrack decision -> (keyframe:
    DoH + ANMS re-detection on retrack, feature merge, point cloud, scan
    context, map write)

with the JAX package's fixed shapes and masks and the same state containers.
The step never waits for the device: no value goes to the host, no shape
depends on data, and no host data is copied to the device (tables such as
filter taps are made once per device).  Differences in form, not in result:
  * The keyframe and retrack decisions are selections, not branches: both
    sides run on every frame and `torch.where` takes one, as the JAX step's
    `lax.cond` does under `vmap`.  The branches run the same ops on the same
    inputs, so the selected values keep their bits.  Re-detection (DoH +
    ANMS) therefore runs on every frame, and the map write is masked: at the
    cursor, the new row where a keyframe is made and the old row elsewhere;
    the cursor advances by the flag.
  * The peeling loop of `ops/robust.py` runs its K bounded steps on the
    device (the JAX package's `lax.while_loop` stops at convergence; a step
    after it changes nothing).
  * `slam_step` is functional: the map is copied on its masked write, so a
    state passed in is never modified.
  * `StepGraph` is the counterpart of `jax.jit(slam_step,
    donate_argnums=(0,))`: on the card it captures one step on its own state
    buffers and replays it, writing the map's row in place; `slam_step_chunk`
    replays it F times with no host sync, as the JAX chunk's `lax.scan` is
    one dispatch.  On the CPU both run the eager step.  A graph holds the
    state it advances, so each caller owns its own (a driver, a harness run,
    a bench trial); nothing shares one across callers.
  * The batched step is `slam_step` under `torch.func.vmap` over a leading
    segment axis on every leaf of the state (`stack_states`), the
    counterpart of `parallel/batch_odometry.py`'s `vmap(slam_step)`: every
    op has a batching rule (vmap's per-op loop is never taken; the DoH op's
    rule makes one launch for all D), and each segment gets the bits of its
    own `slam_step` on the CPU.

Each stage of the eager step runs inside a `torch.profiler.record_function`
range named "slam_step.<stage>" (the whole step: "slam_step"), so a profiler
trace reads each stage's host and device time from the step itself.  A step
of StepGraph runs inside one range, "step_graph.step".

Conventions: the Cartesian image has the sensor at its centre; local metric
coords are (px - centre) * cart_resolution_m; a pose [x, y, theta] maps local
to world.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch.profiler import record_function

from radarslampy_tpu_torch import resolve_device
from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.models.placerecog import scan_context
from radarslampy_tpu_torch.ops import geometry as geo
from radarslampy_tpu_torch.ops.cuda import doh_cuda
from radarslampy_tpu_torch.ops.cuda.doh_cuda import DohFilters, build_doh_filters
from radarslampy_tpu_torch.ops.features import get_features, merge_features, top_k_stable
from radarslampy_tpu_torch.ops.fmt import estimate_rotation_fmt
from radarslampy_tpu_torch.ops.grid import (LogPolarMap, WarpMaps, build_logpolar_map,
                                            build_warp_maps, warp_polar_to_cartesian)
from radarslampy_tpu_torch.ops.motion import solve_motion, undistort
from radarslampy_tpu_torch.ops.pointcloud import extract_pointcloud
from radarslampy_tpu_torch.ops.robust import reject_outliers
from radarslampy_tpu_torch.ops.tables import kept_by
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
    world = geo.transform_points(geo.pose_to_transform(pose), und)
    keep = mask[:, None]
    return (torch.where(keep, und, torch.zeros_like(und)),
            torch.where(keep, world, torch.zeros_like(world)))


def _write_keyframe(m: MapState, make_kf, pose, feat_world, feat_local, feat_ids,
                    feat_mask, velocity, descriptor, pc_local, pc_mask, frame_idx,
                    in_place: bool = False) -> MapState:
    """The masked keyframe write: at the cursor (clamped to the last row),
    the new row where `make_kf` and the old row elsewhere; the cursor
    advances by `make_kf` (clamped to M).  Functional (each buffer copied)
    unless `in_place`, which writes the one row into `m`'s own buffers: the
    graph's state, whose map moves one row a frame."""
    M = m.poses.shape[0]
    c = torch.clamp(m.cursor, max=M - 1).to(torch.int64).reshape(1)

    def upd(buf, row):
        old = buf.index_select(0, c)
        new = torch.where(make_kf, row.to(buf.dtype).reshape(old.shape), old)
        # index_put_, not index_copy_: under vmap (the batched graph) it writes
        # each segment's row at its own cursor in one op, where index_copy_
        # has no batching rule and steps the segments one by one
        return buf.index_put_((c,), new) if in_place else buf.index_copy(0, c, new)

    cursor = torch.clamp(m.cursor + make_kf.to(torch.int32), max=M).to(torch.int32)
    if in_place:
        cursor = m.cursor.copy_(cursor)
    return MapState(
        poses=upd(m.poses, pose),
        feat_world=upd(m.feat_world, feat_world),
        feat_local=upd(m.feat_local, feat_local),
        feat_ids=upd(m.feat_ids, feat_ids),
        feat_mask=upd(m.feat_mask, feat_mask),
        velocities=upd(m.velocities, velocity),
        cursor=cursor,
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
    m = _write_keyframe(empty_map(cfg, cart.dtype, dev),
                        torch.ones((), dtype=torch.bool, device=dev), pose, feat_world,
                        feat_local, ids, mask, vel, scan_context(polar0, cfg), pc_pts,
                        pc_ok, _i32(0, dev))
    return SlamState(pose=pose, velocity=vel, prev_polar=polar0, prev_cart=cart,
                     feat_px=coords, feat_mask=mask, feat_id=ids, next_id=next_id,
                     feat_world=feat_world, kf_pose=pose, map=m, frame_idx=_i32(0, dev))


def slam_step(state: SlamState, polar, maps: FrameMaps, cfg: SlamConfig):
    """One radar frame through the pipeline -> (new state, StepOutput)."""
    with record_function("slam_step"):
        return _slam_step(state, polar, maps, cfg)


def _slam_step(state: SlamState, polar, maps: FrameMaps, cfg: SlamConfig,
               in_place: bool = False):
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

    # ---- keyframe and retrack decision, taken on the device ----
    with record_function("slam_step.decision"):
        retrack = n_inliers <= cfg.n_features_before_retrack
        dth_kf = torch.abs(geo.wrap_angle(pose[2] - state.kf_pose[2]))
        dtrans2 = torch.sum((pose[:2] - state.kf_pose[:2]) ** 2)
        kf_good = (dth_kf >= cfg.kf_rot_threshold_rad) | (dtrans2 >= cfg.kf_trans_threshold_m**2)
        make_kf = retrack | kf_good

    # ---- both sides of each decision on every frame, then a selection ----
    frame_idx = (state.frame_idx + 1).to(torch.int32)
    with record_function("slam_step.detect"):
        merged, merged_mask = merge_features(tr.coords, live, get_features(cart, cfg, maps.doh))
        kf_coords = torch.where(retrack, merged, tr.coords)
        kf_mask = torch.where(retrack, merged_mask, live)
    with record_function("slam_step.keyframe"):
        kf_ids, kf_next_id = assign_new_ids(live, kf_mask, state.feat_id, state.next_id)
        feat_local, kf_world = _features_to_world(kf_coords, kf_mask, pose, velocity, cfg)
        pc_pts, pc_ok = keyframe_pointcloud(polar, velocity, cfg)
        new_map = _write_keyframe(state.map, make_kf, pose, kf_world, feat_local, kf_ids,
                                  kf_mask, velocity, scan_context(polar, cfg), pc_pts, pc_ok,
                                  frame_idx, in_place)
        coords = torch.where(make_kf, kf_coords, tr.coords)
        mask = torch.where(make_kf, kf_mask, live)
        ids = torch.where(make_kf, kf_ids, state.feat_id)
        next_id = torch.where(make_kf, kf_next_id, state.next_id)
        feat_world = torch.where(make_kf, kf_world, state.feat_world)
        kf_pose = torch.where(make_kf, pose, state.kf_pose)

    new_state = SlamState(pose=pose, velocity=velocity, prev_polar=polar, prev_cart=cart,
                          feat_px=coords, feat_mask=mask, feat_id=ids, next_id=next_id,
                          feat_world=feat_world, kf_pose=kf_pose, map=new_map,
                          frame_idx=frame_idx)
    out = StepOutput(pose=pose, velocity=velocity, n_tracked=n_tracked,
                     n_inliers=n_inliers, is_keyframe=make_kf, did_retrack=retrack,
                     fmt_rotation=fmt_rot, fit_ok=fit_ok, fmt_scale=fmt_scale)
    return new_state, out


def slam_step_chunk(state: SlamState, polars, maps: FrameMaps, cfg: SlamConfig,
                    graph: Optional["StepGraph"] = None):
    """F frames [F, A, Wpad] through the step -> (state, StepOutput with every
    field stacked to [F, ...]).

    On the card: `graph` (a StepGraph on `maps` and `cfg`; a new one when
    None, which captures again) is loaded with `state` and replayed F times
    with no host sync (each scan staged into the graph's input by a device
    copy, each packed output copied into an [F, 13] buffer); the returned
    state is a clone of the graph's.  A caller that steps chunk after chunk
    passes its own graph.  On the CPU: `slam_step` in turn."""
    if graph is not None and (graph.maps is not maps or graph.cfg != cfg):
        raise ValueError("slam_step_chunk: the graph was built on other maps or config")
    if not state.pose.is_cuda:
        outs = []
        for f in range(len(polars)):
            state, out = slam_step(state, polars[f], maps, cfg)
            outs.append(out)
        return state, StepOutput(*(torch.stack(field) for field in zip(*outs)))
    if graph is None:
        graph = StepGraph(maps, cfg)
    graph.load(state)
    polars = torch.as_tensor(polars, device=state.pose.device)
    packed = torch.empty((len(polars), PACKED_WIDTH), dtype=state.pose.dtype,
                         device=state.pose.device)
    for f in range(len(polars)):
        packed[f].copy_(graph.step(polars[f]))
    return graph.snapshot(), unpack_output(packed)


# ---- the step as one CUDA graph ----

PACKED_WIDTH = 13   # see pack_output


def pack_output(out: StepOutput) -> torch.Tensor:
    """A StepOutput as one float row [13] (rows [..., 13] of a batched
    output): [x, y, theta, n_tracked, n_inliers, fit_ok, is_keyframe,
    did_retrack] (the JAX driver's per-frame row), then [vx, vy, omega,
    fmt_rotation, fmt_scale].  Counts and flags are exact in float32, so
    `unpack_output` gives the output back bit for bit."""
    f = out.pose.dtype
    return torch.cat([out.pose, torch.stack([
        out.n_tracked.to(f), out.n_inliers.to(f), out.fit_ok.to(f),
        out.is_keyframe.to(f), out.did_retrack.to(f)], dim=-1), out.velocity,
        torch.stack([out.fmt_rotation.to(f), out.fmt_scale.to(f)], dim=-1)], dim=-1)


def unpack_output(packed: torch.Tensor) -> StepOutput:
    """`pack_output`'s rows [..., 13] -> StepOutput with fields [...]; the
    float fields are views of `packed`."""
    p = packed
    return StepOutput(pose=p[..., 0:3], velocity=p[..., 8:11],
                      n_tracked=p[..., 3].to(torch.int64), n_inliers=p[..., 4].to(torch.int64),
                      is_keyframe=p[..., 6] != 0, did_retrack=p[..., 7] != 0,
                      fmt_rotation=p[..., 11], fit_ok=p[..., 5] != 0, fmt_scale=p[..., 12])


def _leaves(state: SlamState):
    return [t for x in state for t in (x if isinstance(x, MapState) else (x,))]


def _map_leaves(fn, *states):
    """A SlamState (with its MapState) of fn applied to the matching leaves."""
    return SlamState(*(MapState(*map(fn, *xs)) if isinstance(xs[0], MapState) else fn(*xs)
                       for xs in zip(*states)))


def clone_state(state: SlamState) -> SlamState:
    return _map_leaves(torch.clone, state)


def _advance(state: SlamState, polar, maps: FrameMaps, cfg: SlamConfig, packed):
    """One step that writes the next state into `state`'s own buffers (the
    map's one row in place, the rest copied over) and the packed output into
    `packed`: the body that StepGraph captures.  Every field of the step's
    new state is a new tensor (or the input scan), so no copy reads a buffer
    that an earlier copy wrote."""
    new, out = _slam_step(state, polar, maps, cfg, in_place=True)
    for name in SlamState._fields:
        if name != "map":
            getattr(state, name).copy_(getattr(new, name))
    packed.copy_(pack_output(out))


# ---- D segments in lock-step: the step under torch.func.vmap ----

def stack_states(states) -> SlamState:
    """D states -> one state with a leading segment axis D on every leaf
    (the layout of the JAX package's vmapped state)."""
    return _map_leaves(lambda *ts: torch.stack(ts), *states)


def unstack_states(state: SlamState) -> list:
    """A state with a leading segment axis -> its D states (views)."""
    return [_map_leaves(lambda t: t[d], state) for d in range(state.pose.shape[0])]


def batched_init_state(polars0, init_poses, maps: FrameMaps, cfg: SlamConfig) -> SlamState:
    """First frames [D, A, W] at poses [D, 3] -> the D first states stacked:
    `init_state` under `torch.func.vmap` (one DoH launch for all D)."""
    dev = maps.warp.idx0.device
    polars0 = torch.as_tensor(polars0, device=dev)
    init_poses = torch.as_tensor(init_poses, dtype=torch.float32, device=dev)
    return torch.func.vmap(lambda p, q: init_state(p, q, maps, cfg))(polars0, init_poses)


def batched_slam_step(states: SlamState, polars, maps: FrameMaps, cfg: SlamConfig):
    """D frames [D, A, W] through the step of D segments at once -> (states,
    StepOutput with fields [D, ...]): `slam_step` under `torch.func.vmap`,
    the counterpart of the JAX package's vmapped step.  Every segment gets
    the bits of its own `slam_step`; DoH launches once for all D."""
    polars = torch.as_tensor(polars, device=states.pose.device)
    return torch.func.vmap(lambda s, p: _slam_step(s, p, maps, cfg))(states, polars)


def _advance_batched(states: SlamState, polars, maps: FrameMaps, cfg: SlamConfig, packed):
    """`_advance` of D segments under vmap: each segment's next state into its
    slice of `states`, its map row written at its own cursor, its packed row
    into `packed` [D, 13]."""
    def one(s, p, o):
        _advance(s, p, maps, cfg, o)
        return o
    torch.func.vmap(one)(states, polars, packed)


class StepGraph:
    """The step as one CUDA graph: the port's counterpart of the JAX
    driver's `jax.jit(slam_step, donate_argnums=(0,))`, and with `batch=D`
    of `parallel/batch_odometry.py`'s `jax.jit(vmap(slam_step),
    donate_argnums=(0,))`: D segments in lock-step, their state stacked on a
    leading axis (`stack_states`), scans [D, A, W] in, rows [D, 13] out,
    one graph replay and one DoH launch a frame for all D.

    On the card, the first `step` for an input dtype and shape (u8 or
    float32 scans) runs one step eagerly on a side stream, on a clone of the
    state (it builds cuFFT plans, library handles and the DoH kernel's launch
    plan), then captures one step on the graph's own buffers: the state, a
    static input scan and a packed output row [13] (`pack_output`).  A
    replay advances the state in place, as a donated state is; the map moves
    one row a frame.  Captures of one StepGraph share a memory pool.  A
    capture reads the maps, its buffers and the small device tables of
    `ops/tables.py` by address; the StepGraph holds every one of them
    (`kept_by`), so none is freed while it can replay.  The DoH wrapper
    counts its launch once at capture, where nothing runs: the count is taken
    back there, and each replay adds the launches it captured.  A capture or
    replay that fails raises; nothing falls back to the eager step.

    The contract: `load(state)` copies a state in (after `init_state`, after
    the back-end re-anchors the map, after a resume).  `step(scan)` returns
    the packed row, which the next `step` overwrites, as it does `state`;
    whatever a caller keeps past the next step is a copy: `output()`,
    `snapshot()`, `packed.clone()`.  One StepGraph serves one caller: a
    second caller that loads its state into it takes the first one's place.

    On the CPU the same calls run `slam_step` (with `batch`,
    `batched_slam_step`; functional, so nothing needs copying); the caller
    asked for the CPU, so this is not a fallback."""

    def __init__(self, maps: FrameMaps, cfg: SlamConfig, batch: Optional[int] = None):
        self.maps, self.cfg, self.batch = maps, cfg, batch
        self._lead = () if batch is None else (batch,)
        self.device = maps.warp.idx0.device
        self.on_card = self.device.type == "cuda"
        self.state: Optional[SlamState] = None
        self.packed: Optional[torch.Tensor] = None
        self._graphs = {}   # (dtype, shape) -> (CUDAGraph, static scan, DoH launches)
        self._pool = None
        self._tables = []   # the device tables the captures read

    def load(self, state: SlamState) -> None:
        if tuple(state.pose.shape[:-1]) != self._lead:
            raise ValueError(f"a state of pose shape {tuple(state.pose.shape)} for a graph "
                             f"of batch {self.batch}")
        if not self.on_card:
            self.state = state
            return
        if self.state is None:
            self.state = clone_state(state)
            self.packed = torch.zeros((*self._lead, PACKED_WIDTH), dtype=state.pose.dtype,
                                      device=self.device)
            return
        for dst, src in zip(_leaves(self.state), _leaves(state), strict=True):
            if dst.shape != src.shape or dst.dtype != src.dtype:
                raise ValueError(f"state leaf {tuple(src.shape)} {src.dtype} does not fit "
                                 f"the graph's {tuple(dst.shape)} {dst.dtype}")
            dst.copy_(src)

    def step(self, scan) -> torch.Tensor:
        """One frame: the packed output row [13] (rows [D, 13] with `batch`;
        see the class docstring).  Runs inside one `record_function` range,
        "step_graph.step": on the card the input's staging copy and the
        replay."""
        if self.state is None:
            raise RuntimeError("StepGraph.step before load(state)")
        with record_function("step_graph.step"):
            if not self.on_card:
                step = slam_step if self.batch is None else batched_slam_step
                self.state, out = step(self.state, scan, self.maps, self.cfg)
                self.packed = pack_output(out)
                return self.packed
            scan = torch.as_tensor(scan, device=self.device)
            graph, static, launches = self._graph_for(scan)
            static.copy_(scan)
            graph.replay()
        doh_cuda.launches += launches
        return self.packed

    def output(self) -> StepOutput:
        return unpack_output(self.packed.clone())

    def snapshot(self) -> SlamState:
        return clone_state(self.state) if self.on_card else self.state

    def _graph_for(self, scan):
        key = (scan.dtype, tuple(scan.shape))
        if key not in self._graphs:
            self._graphs[key] = self._capture(scan)
        return self._graphs[key]

    def _capture(self, scan):
        if self.state is None:
            raise RuntimeError("StepGraph capture before load(state)")
        if tuple(scan.shape[:-2]) != self._lead:
            raise ValueError(f"scans {tuple(scan.shape)} for a graph of batch {self.batch}")
        advance = _advance if self.batch is None else _advance_batched
        static = scan.clone()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            advance(clone_state(self.state), static, self.maps, self.cfg,
                    torch.empty_like(self.packed))
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = doh_cuda.launches
        try:
            with kept_by(self._tables), torch.cuda.graph(graph, pool=self._pool):
                advance(self.state, static, self.maps, self.cfg, self.packed)
        finally:
            launches = doh_cuda.launches - before
            doh_cuda.launches = before
        self._pool = graph.pool()
        return graph, static, launches

