"""Sharded keyframe map: map queries split over the ranks of a mesh.

Counterpart of `radarslampy_tpu/parallel/sharded_map.py`.  The keyframe
store (`MapState`) is split along its keyframe axis over the mesh's ``kf``
ranks: each rank scores its block of keyframes, and the blocks' results are
gathered, so every rank returns the same answer as the dense query on the
whole map.

Merging keeps the dense order.  Gathered blocks come in rank order, so a
keyframe's position in the gathered array is its global index, and a stable
sort of the gathered scores breaks ties by score, then by global index, as
`ops.features.top_k_stable` does on the dense array.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from radarslampy_tpu_torch.models.frontend import MapState
from radarslampy_tpu_torch.models.placerecog import (AppearanceCandidates, _exact_and_select,
                                                     _pair_distances, ring_key)
from radarslampy_tpu_torch.ops.features import top_k_stable
from radarslampy_tpu_torch.parallel.mesh import (all_gather, axis_index, axis_size, pad_rows,
                                                 padded_len, replicated, shard_along)


def shard_map_state(m: MapState, mesh: DeviceMesh) -> MapState:
    """The map as the ranks hold it: on this rank's device, its keyframe
    axis padded with empty (zero, masked) rows to a multiple of the ``kf``
    axis size; the cursor is replicated.  Each query takes this rank's block
    of it."""
    rows = padded_len(m.poses.shape[0], axis_size(mesh))
    return MapState(*(replicated(x, mesh) if x.ndim == 0 else pad_rows(replicated(x, mesh), rows)
                      for x in m))


def _block_index(mesh: DeviceMesh, shard: int, device):
    """Global keyframe indices of this rank's block of `shard` rows."""
    return axis_index(mesh) * shard + torch.arange(shard, device=device)


def nearest_keyframes(m: MapState, query_pose, k: int, mesh: DeviceMesh,
                      min_index_gap: int = 0, exclude_after: int | None = None):
    """Top-k nearest live keyframes to `query_pose` (loop-closure candidates)
    -> (indices [k], distances [k], valid [k]).  Each rank scores its block
    of keyframes; the blocks' distances are all-gathered and ranked on every
    rank.  `min_index_gap` is accepted for the JAX signature, whose function
    does not use it either."""
    poses = shard_along(m.poses, mesh)
    gidx = _block_index(mesh, poses.shape[0], poses.device)
    live = gidx < m.cursor
    if exclude_after is not None:
        live = live & (gidx < exclude_after)
    q = torch.as_tensor(query_pose, dtype=poses.dtype, device=poses.device)
    dx, dy = poses[:, 0] - q[0], poses[:, 1] - q[1]
    d = torch.where(live, torch.sqrt(dx * dx + dy * dy), float("inf"))
    d_all, i_all = all_gather(d, mesh), all_gather(gidx, mesh)
    vals, pos = top_k_stable(-d_all, k)
    return i_all[pos], -vals, torch.isfinite(vals)


def appearance_candidates_sharded(m: MapState, mesh: DeviceMesh, max_candidates: int,
                                  min_index_gap: int = 20, max_distance: float = 0.35,
                                  prefilter: int = 4) -> AppearanceCandidates:
    """Scan-context retrieval with the descriptor store split over the mesh,
    equal to `placerecog.find_candidates_appearance` on the whole map.

      1. Each rank scores the ring keys of its block of keyframes against
         the all-gathered [M, R] key table, keeps its best
         `prefilter * max_candidates` pairs, and the blocks' pairs are
         gathered and ranked again (replicated).
      2. The exact all-shift distance runs on the merged pairs, on every
         rank: every rank holds the map's descriptors.
    """
    M = m.descriptors.shape[0]
    P = prefilter * max_candidates
    descs = shard_along(m.descriptors, mesh)
    shard = descs.shape[0]
    gidx = _block_index(mesh, shard, descs.device)
    keys_local = ring_key(descs)
    keys_all = all_gather(keys_local, mesh)[:M]
    idx_all = torch.arange(M, device=descs.device)
    ok = ((gidx < m.cursor)[:, None] & (idx_all < m.cursor)[None, :]
          & ((idx_all[None, :] - gidx[:, None]) >= min_index_gap))
    score = torch.where(ok, _pair_distances(keys_local, keys_all), float("inf"))
    vals, flat = top_k_stable(-score.reshape(-1), P)
    # a flat index of this block is row * M + column, in the dense order
    v_all = all_gather(vals, mesh)
    i_all = all_gather(axis_index(mesh) * shard + flat // M, mesh)
    j_all = all_gather(flat % M, mesh)
    v, pos = top_k_stable(v_all, P)
    return _exact_and_select(m.descriptors, i_all[pos], j_all[pos], torch.isfinite(v),
                             max_candidates, max_distance)


def global_map_points(m: MapState, mesh: DeviceMesh):
    """All live keyframes' feature world positions, all-gathered -> (points
    [M*K, 2], mask [M*K])."""
    M, K = m.feat_mask.shape
    fw, fm = shard_along(m.feat_world, mesh), shard_along(m.feat_mask, mesh)
    live = (_block_index(mesh, fm.shape[0], fm.device) < m.cursor)[:, None] & fm
    pts = all_gather(fw.reshape(-1, 2), mesh)[:M * K]
    return pts, all_gather(live.reshape(-1), mesh)[:M * K]
