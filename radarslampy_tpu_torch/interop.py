"""Carry the JAX package's step and back-end data across to the port.

The SLAM step has no weights; what the JAX package and the port share is
their per-config maps, their state and the back-end's problems.  These
functions take the JAX package's `FrameMaps`, `SlamState` (also batched),
`PoseGraph`, `BAProblem`, `BackendState`, `LoopMatch` and
`AppearanceCandidates` (any object with those fields whose arrays
`np.asarray` can read: JAX arrays or numpy arrays) and give the port's
containers on `device`, so both packages can be fed the identical input.
Index arrays become int64 tensors.  Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from radarslampy_tpu_torch import resolve_device
from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.models.ba import BAProblem
from radarslampy_tpu_torch.models.frontend import FrameMaps, MapState, SlamState
from radarslampy_tpu_torch.models.loopclosure import BackendState, LoopMatch
from radarslampy_tpu_torch.models.placerecog import AppearanceCandidates
from radarslampy_tpu_torch.models.posegraph import PoseGraph
from radarslampy_tpu_torch.ops.cuda.doh_cuda import filters_from_taps
from radarslampy_tpu_torch.ops.grid import LogPolarMap, warp_maps_from_taps


def _routed_to_pixel_taps(routed, S: int):
    """Per-pixel (a0, r0, fa, fr, inside) from the routed warp's parked maps.

    Pass p owns the pixels of mask[p] (passes 2 and 3 in the transposed
    frame); there a pixel reads range column cb, azimuth fraction fa, and the
    azimuth row ra and range fraction fr parked at (row, cb).
    """
    ra, fr, cb, fa, mask = (np.asarray(getattr(routed, f))
                            for f in ("ra", "fr", "cb", "fa", "mask"))
    a0 = np.zeros((S, S), np.int64)
    r0 = np.zeros((S, S), np.int64)
    fa_px = np.zeros((S, S), np.float32)
    fr_px = np.zeros((S, S), np.float32)
    inside = np.zeros((S, S), bool)
    for p in range(mask.shape[0]):
        rows, cols = np.nonzero(mask[p])
        park = cb[p, rows, cols]
        v, u = (cols, rows) if p >= 2 else (rows, cols)
        a0[v, u] = ra[p, rows, park]
        r0[v, u] = park
        fa_px[v, u] = fa[p, rows, cols]
        fr_px[v, u] = fr[p, rows, park]
        inside[v, u] = True
    return a0, r0, fa_px, fr_px, inside


def _taps_from_toeplitz(mats, sigmas):
    """Centre-row band of each [S, S] blur operator (radius from sigma)."""
    taps = []
    for B, sigma in zip(np.asarray(mats), sigmas):
        r = 0 if sigma < 0.3 else max(1, int(np.ceil(3.0 * sigma)))
        S = B.shape[0]
        if 2 * r + 1 > S:
            raise ValueError(f"image size {S} is narrower than the sigma={sigma} kernel")
        i = S // 2
        taps.append(np.ascontiguousarray(B[i, i - r: i + r + 1], np.float32))
    return taps


def _tensor(x, device, dtype=None):
    arr = np.array(np.asarray(x))  # a writable host copy
    t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype or t.dtype)


def frame_maps_from_numpy(maps, cfg: SlamConfig, device="cuda") -> FrameMaps:
    """The JAX `FrameMaps` (fields `routed`, `doh`, and of `grid` the
    log-polar map) as the port's `FrameMaps`."""
    dev = resolve_device(device)
    a0, r0, fa, fr, inside = _routed_to_pixel_taps(maps.routed, cfg.cart_size)
    return FrameMaps(
        warp=warp_maps_from_taps(a0, r0, fa, fr, inside, cfg, dev),
        doh=filters_from_taps(_taps_from_toeplitz(maps.doh, cfg.doh_sigmas),
                              cfg.doh_sigmas, dev),
        logpolar=LogPolarMap(logpolar_rng=_tensor(maps.grid.logpolar_rng, dev),
                             log_base=float(maps.grid.log_base)),
    )


def map_state_from_numpy(m, device="cuda") -> MapState:
    """The JAX `MapState` as the port's (`frame_ids` -1 where the JAX map
    has none)."""
    dev = resolve_device(device)
    f32, i32 = torch.float32, torch.int32
    frame_ids = m.frame_ids if m.frame_ids is not None else \
        np.full(np.shape(m.poses)[:-1], -1, np.int32)
    return MapState(
        poses=_tensor(m.poses, dev, f32),
        feat_world=_tensor(m.feat_world, dev, f32),
        feat_local=_tensor(m.feat_local, dev, f32),
        feat_ids=_tensor(m.feat_ids, dev, i32),
        feat_mask=_tensor(m.feat_mask, dev, torch.bool),
        velocities=_tensor(m.velocities, dev, f32),
        cursor=_tensor(m.cursor, dev, i32),
        descriptors=_tensor(m.descriptors, dev, f32),
        pc_local=_tensor(m.pc_local, dev, f32),
        pc_mask=_tensor(m.pc_mask, dev, torch.bool),
        frame_ids=_tensor(frame_ids, dev, i32),
    )


def slam_state_from_numpy(state, cfg: SlamConfig, device="cuda") -> SlamState:
    """The JAX `SlamState` (with its `MapState`) as the port's `SlamState`;
    a batched one (leading axis D on every leaf) as the port's batched state."""
    dev = resolve_device(device)
    f32, i32 = torch.float32, torch.int32
    new_map = map_state_from_numpy(state.map, dev)
    return SlamState(
        pose=_tensor(state.pose, dev, f32),
        velocity=_tensor(state.velocity, dev, f32),
        prev_polar=_tensor(state.prev_polar, dev, f32),
        prev_cart=_tensor(state.prev_cart, dev, f32),
        feat_px=_tensor(state.feat_px, dev, f32),
        feat_mask=_tensor(state.feat_mask, dev, torch.bool),
        feat_id=_tensor(state.feat_id, dev, i32),
        next_id=_tensor(state.next_id, dev, i32),
        feat_world=_tensor(state.feat_world, dev, f32),
        kf_pose=_tensor(state.kf_pose, dev, f32),
        map=new_map,
        frame_idx=_tensor(state.frame_idx, dev, i32),
    )


def slam_states_from_numpy(states, cfg: SlamConfig, device="cuda") -> SlamState:
    """The JAX package's batched `SlamState` (a leading segment axis D, as
    `parallel.batch_odometry.batched_init` gives it) as the port's batched
    state, as the port's `batched_init` gives it.  `frontend.unstack_states`
    splits it into D single states."""
    if np.ndim(states.pose) != 2:
        raise ValueError(f"a batched state has poses [D, 3], got {np.shape(states.pose)}")
    return slam_state_from_numpy(states, cfg, device)


def pose_graph_from_numpy(g, device="cuda") -> PoseGraph:
    """The JAX `PoseGraph` as the port's."""
    dev = resolve_device(device)
    return PoseGraph(
        poses=_tensor(g.poses, dev, torch.float32),
        node_mask=_tensor(g.node_mask, dev, torch.bool),
        edges_ij=_tensor(g.edges_ij, dev, torch.int64),
        edges_meas=_tensor(g.edges_meas, dev, torch.float32),
        edges_info=_tensor(g.edges_info, dev, torch.float32),
        edge_mask=_tensor(g.edge_mask, dev, torch.bool),
    )


def ba_problem_from_numpy(p, device="cuda") -> BAProblem:
    """The JAX `BAProblem` as the port's."""
    dev = resolve_device(device)
    f32, i64, b = torch.float32, torch.int64, torch.bool
    return BAProblem(
        poses=_tensor(p.poses, dev, f32), pose_mask=_tensor(p.pose_mask, dev, b),
        landmarks=_tensor(p.landmarks, dev, f32), lm_mask=_tensor(p.lm_mask, dev, b),
        obs_pose=_tensor(p.obs_pose, dev, i64), obs_lm=_tensor(p.obs_lm, dev, i64),
        obs_xy=_tensor(p.obs_xy, dev, f32), obs_mask=_tensor(p.obs_mask, dev, b),
    )


def backend_state_from_numpy(bs) -> BackendState:
    """The JAX `BackendState` (host arrays) as the port's."""
    return BackendState(prev_cursor=int(bs.prev_cursor),
                        edges_ij=np.array(bs.edges_ij, np.int32).reshape(-1, 2),
                        edges_meas=np.array(bs.edges_meas, np.float32).reshape(-1, 3))


def loop_match_from_numpy(lm, device="cuda") -> LoopMatch:
    """The JAX `LoopMatch` as the port's."""
    dev = resolve_device(device)
    return LoopMatch(rel_pose=_tensor(lm.rel_pose, dev, torch.float32),
                     n_matches=_tensor(lm.n_matches, dev, torch.int32),
                     residual=_tensor(lm.residual, dev, torch.float32),
                     ok=_tensor(lm.ok, dev, torch.bool))


def appearance_candidates_from_numpy(c, device="cuda") -> AppearanceCandidates:
    """The JAX `AppearanceCandidates` as the port's."""
    dev = resolve_device(device)
    return AppearanceCandidates(i=_tensor(c.i, dev, torch.int64), j=_tensor(c.j, dev, torch.int64),
                                distance=_tensor(c.distance, dev, torch.float32),
                                rot_init=_tensor(c.rot_init, dev, torch.float32),
                                valid=_tensor(c.valid, dev, torch.bool))
