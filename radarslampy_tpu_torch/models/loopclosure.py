"""Loop-closure detection and verification over the keyframe map.

Counterpart of `radarslampy_tpu/models/loopclosure.py`:

  1. candidates: keyframe pairs close in space but far apart in sequence
     (`find_candidates`, with a min-pool non-max suppression), or close in
     appearance (models/placerecog.py);
  2. verification: masked point-to-point ICP between the two keyframes'
     sensor-frame feature clouds from a fan of six starts
     (`verify_candidate`);
  3. accepted matches become pose-graph edges (`close_loops`,
     `graph_with_loop_edges`); `incremental_backend` does this mid-run over
     the keyframes added since its last pass and feeds the corrected poses
     back into the running state.

Keyframe-local features satisfy p_i = (T_i^-1 T_j) p_j, so the ICP alignment
is the relative-pose measurement the graph edge needs.  Candidate top-k keeps
`lax.top_k`'s order (lower flat index first among equal scores); the ICP is
batched over the valid candidates and the starts, in chunks of `VERIFY_CHUNK`
candidates.  Candidate distances and the ICP are computed in float64 and
rounded to float32, so the card and the CPU (whose float32 trig and sums
differ in the last bits) find and verify the same loops.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.models.frontend import MapState
from radarslampy_tpu_torch.models.placerecog import (find_candidates_appearance,
                                                     find_candidates_appearance_block,
                                                     find_candidates_m2dp, m2dp_from_map)
from radarslampy_tpu_torch.models.posegraph import (PoseGraph, odometry_graph_from_map,
                                                    optimize_pose_graph)
from radarslampy_tpu_torch.ops import geometry as geo
from radarslampy_tpu_torch.ops.features import top_k_stable

# Candidates verified together: the ICP's [chunk, 6, K, K] distances stay
# near 100 MB at K = 256.
VERIFY_CHUNK = 64

# The ICP's annealed match radii for the default (match_radius, iters): the
# float32 values of `jnp.geomspace(8.0, 2.0, 10)`, whose float32 log10/pow
# no correctly rounded formula reproduces to the last bit.
_JAX_GEOMSPACE_8_2_10 = (8.0, 6.857952117919922, 5.8789381980896, 5.039683818817139,
                         4.320239543914795, 3.7034988403320312, 3.174802303314209,
                         2.7215800285339355, 2.3330581188201904, 2.0)


def icp_radii(match_radius: float = 2.0, iters: int = 10):
    """The match radius of each ICP iteration, annealed geometrically from
    4x `match_radius` down to it (float32 values, as Python floats)."""
    if (float(np.float32(match_radius)), iters) == (2.0, 10):
        return _JAX_GEOMSPACE_8_2_10
    f = np.float32
    a, b = np.log10(f(4.0 * match_radius)), np.log10(f(match_radius))
    step = np.arange(iters - 1, dtype=f) / f(max(iters - 1, 1))
    lin = np.concatenate([a * (f(1) - step) + b * step, [b]]).astype(f)
    return tuple(float(r) for r in np.power(f(10.0), lin).astype(f))


def _trim(m: MapState, M: int, cursor: int, zero_dead: bool) -> MapState:
    def cut(a):
        if zero_dead:
            out = torch.zeros((M,) + a.shape[1:], dtype=a.dtype, device=a.device)
            n = min(cursor, a.shape[0])
            out[:n] = a[:n]
            return out
        if a.shape[0] >= M:
            return a[:M]
        return F.pad(a, [0, 0] * (a.ndim - 1) + [0, M - a.shape[0]])

    return MapState(
        poses=cut(m.poses), feat_world=cut(m.feat_world), feat_local=cut(m.feat_local),
        feat_ids=cut(m.feat_ids), feat_mask=cut(m.feat_mask),
        velocities=cut(m.velocities),
        cursor=torch.tensor(cursor, dtype=torch.int32, device=m.poses.device),
        descriptors=cut(m.descriptors), pc_local=cut(m.pc_local), pc_mask=cut(m.pc_mask),
        frame_ids=cut(m.frame_ids))


def _padded(n: int, pad_multiple: int) -> int:
    return max(pad_multiple, ((n + pad_multiple - 1) // pad_multiple) * pad_multiple)


def trim_map_state(m: MapState, pad_multiple: int = 256) -> MapState:
    """The live keyframe prefix repacked into `pad_multiple`-padded rows, zero
    past the live prefix, on the map's device.  The back-end solvers are
    O(M^2..M^3) in the rows they are given, so they get the live keyframes,
    not the map's preallocated capacity."""
    M_live = int(m.cursor)
    return _trim(m, _padded(M_live, pad_multiple), M_live, zero_dead=True)


def trim_map_state_device(m: MapState, M_live: int, pad_multiple: int = 256) -> MapState:
    """The map's first `pad_multiple`-padded rows for `M_live` live keyframes
    (sliced, or zero-padded past the capacity): rows past the cursor were
    never written, so they are the store's zeros already.  `M_live` is the
    host's copy of the cursor."""
    return _trim(m, _padded(M_live, pad_multiple), M_live, zero_dead=False)


class LoopCandidate(NamedTuple):
    i: torch.Tensor       # [C] earlier keyframe index
    j: torch.Tensor       # [C] later keyframe index
    valid: torch.Tensor   # [C] bool


class LoopMatch(NamedTuple):
    rel_pose: torch.Tensor   # [..., 3] measured T_i^-1 T_j
    n_matches: torch.Tensor  # [...] int32 matched feature pairs
    residual: torch.Tensor   # [...] mean match distance (m) after alignment
    ok: torch.Tensor         # [...] bool: passes the acceptance gates


def _distances(pa, pb):
    """Planar distances [A, B] between poses [A, 3] and [B, 3]."""
    d = pa.double()[:, None, :2] - pb.double()[None, :, :2]
    return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]).to(pa.dtype)


def _nms_top_k(score, max_candidates: int, nms_window: int):
    """Keep scores that are their (2w+1)^2 neighbourhood's minimum (inf
    padding at the border), then the `max_candidates` smallest, lower flat
    index first among equal scores -> (flat index, valid)."""
    if nms_window > 0:
        w = 2 * nms_window + 1
        pooled = -F.max_pool2d(-score[None, None], w, stride=1, padding=w // 2)[0, 0]
        score = torch.where(score <= pooled, score, float("inf"))
    vals, flat = top_k_stable(-score.reshape(-1), max_candidates)
    return flat, torch.isfinite(vals)


def find_candidates(poses, cursor, max_candidates: int, radius_m: float = 10.0,
                    min_index_gap: int = 20, nms_window: int = 3) -> LoopCandidate:
    """Top pairs (i < j) with |p_i - p_j| < radius and j - i >= gap, sorted by
    distance, after non-max suppression over index neighbourhoods (one
    revisit gives one candidate, not a cluster of (i±k, j±k)); 0 disables."""
    M = poses.shape[0]
    idx = torch.arange(M, device=poses.device)
    live = idx < cursor
    d = _distances(poses, poses)
    ok = (live[:, None] & live[None, :] & ((idx[None, :] - idx[:, None]) >= min_index_gap)
          & (d < radius_m))
    flat, valid = _nms_top_k(torch.where(ok, d, float("inf")), max_candidates, nms_window)
    return LoopCandidate(i=flat // M, j=flat % M, valid=valid)


def find_candidates_block(poses, cursor, lo, block: int, max_candidates: int,
                          radius_m: float = 10.0, min_index_gap: int = 20,
                          nms_window: int = 3) -> LoopCandidate:
    """`find_candidates` restricted to pairs whose later keyframe lies in
    [lo, lo + block): the incremental back-end's search, O(block * M)."""
    M = poses.shape[0]
    dev = poses.device
    j = lo + torch.arange(block, device=dev)
    jc = torch.clamp(j, max=M - 1)
    i = torch.arange(M, device=dev)
    d = _distances(poses[jc], poses)
    ok = ((j < cursor)[:, None] & (i < cursor)[None, :]
          & ((jc[:, None] - i[None, :]) >= min_index_gap) & (d < radius_m))
    flat, valid = _nms_top_k(torch.where(ok, d, float("inf")), max_candidates, nms_window)
    return LoopCandidate(i=flat % M, j=jc[flat // M], valid=valid)


def _procrustes_batched(src, tgt, w):
    """`geometry.procrustes_masked` over leading batch dims: (R [..., 2, 2],
    h [..., 2], ok [...]) with R tgt + h ~= src."""
    wsum = torch.sum(w, -1)
    ok = wsum > 1.5
    safe = torch.clamp(wsum, min=1e-12)[..., None]
    mu_src = torch.sum(src * w[..., None], dim=-2) / safe
    mu_tgt = torch.sum(tgt * w[..., None], dim=-2) / safe
    a = src - mu_src[..., None, :]
    b = tgt - mu_tgt[..., None, :]
    dot = torch.sum(w * (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]), -1)
    cross = torch.sum(w * (a[..., 1] * b[..., 0] - a[..., 0] * b[..., 1]), -1)
    R = geo.rotation_matrix(torch.atan2(cross, dot))
    h = mu_src - (R @ mu_tgt[..., None])[..., 0]
    eye = torch.eye(2, dtype=src.dtype, device=src.device)
    return (torch.where(ok[..., None, None], R, eye),
            torch.where(ok[..., None], h, torch.zeros_like(h)), ok)


def icp_align(pts_i, mask_i, pts_j, mask_j, init_rel, match_radius: float = 2.0,
              iters: int = 10) -> LoopMatch:
    """Fixed-iteration point-to-point ICP: rel with pts_i ~ rel(pts_j), for
    masked clouds [..., K, 2] and starts [..., 3] (batched over leading
    dims).  Nearest neighbours from dense [K, K] distances; the match radius
    anneals from 4x down to `match_radius` so a coarse start still locks on.
    Computed in float64; the pose and residual come back in pts_i's dtype."""
    dtype = pts_i.dtype
    pts_i, pts_j, rel = pts_i.double(), pts_j.double(), init_rel.double()
    for radius in icp_radii(match_radius, iters):
        T = geo.pose_to_transform(rel)
        R, t = T[..., :2, :2], T[..., :2, 2]
        pj = (pts_j @ R.transpose(-1, -2)) + t[..., None, :]
        dx = pts_i[..., :, None, 0] - pj[..., None, :, 0]
        dy = pts_i[..., :, None, 1] - pj[..., None, :, 1]
        d2 = torch.where(mask_i[..., :, None] & mask_j[..., None, :], dx * dx + dy * dy,
                         float("inf"))
        nn = torch.argmin(d2, dim=-1)   # the first minimum, as jnp.argmin
        nn_d2 = torch.gather(d2, -1, nn[..., None])[..., 0]
        w = (nn_d2 < radius ** 2).to(pts_i.dtype) * mask_i
        tgt = torch.gather(pj, -2, nn[..., None].expand(nn.shape + (2,)))
        Rc, h, ok = _procrustes_batched(pts_i, tgt, w)
        # compose the correction onto rel (the relative pose is small, so the
        # 3x3 product loses nothing)
        th = torch.atan2(Rc[..., 1, 0], Rc[..., 0, 0])
        Tn = geo.pose_to_transform(torch.stack([h[..., 0], h[..., 1], th], -1)) @ T
        rel = torch.where(ok[..., None], geo.transform_to_pose(Tn), rel)
    n = torch.sum(w.to(torch.int32), -1, dtype=torch.int32)
    mean_res = torch.sqrt(torch.sum(torch.where(w > 0, nn_d2, 0.0), -1)
                          / torch.clamp(n, min=1))
    return LoopMatch(rel_pose=rel.to(dtype), n_matches=n, residual=mean_res.to(dtype),
                     ok=n >= 3)


def verify_candidate(m: MapState, i, j, cfg: SlamConfig, min_matches: int = 12,
                     max_residual_m: float = 1.0, rot_override=None) -> LoopMatch:
    """ICP-verify candidate pairs (`i`, `j` index tensors of any shape) from a
    fan of six starts; the start with the most matches (residual
    tie-break) wins.

    The fan: the pose-derived relative pose (good under bounded drift) and
    the same with zero translation (a revisit pair is physically close, so
    this survives tens of metres of drift), each with heading offsets of
    -0.2, 0 and +0.2 rad.  `rot_override` (NaN = none) replaces the starts'
    heading, as appearance candidates supply it."""
    pi, pj = m.poses[i].double(), m.poses[j].double()
    dx, dy = pj[..., 0] - pi[..., 0], pj[..., 1] - pi[..., 1]
    s0, c0 = torch.sin(pi[..., 2]), torch.cos(pi[..., 2])
    head = geo.wrap_angle(pj[..., 2] - pi[..., 2])
    if rot_override is not None:
        rot = rot_override.double()
        head = torch.where(torch.isfinite(rot), rot, head)
    init_rel = torch.stack([c0 * dx + s0 * dy, -s0 * dx + c0 * dy, head], -1)
    fan = torch.tensor([-0.2, 0.0, 0.2], dtype=init_rel.dtype, device=init_rel.device)
    zero_t = torch.cat([torch.zeros_like(init_rel[..., :2]), init_rel[..., 2:]], -1)
    starts = torch.cat([
        torch.cat([init_rel[..., None, :2].expand(init_rel.shape[:-1] + (3, 2)),
                   init_rel[..., None, 2:] + fan[:, None]], -1),
        torch.cat([zero_t[..., None, :2].expand(init_rel.shape[:-1] + (3, 2)),
                   zero_t[..., None, 2:] + fan[:, None]], -1)], -2)    # [..., 6, 3]

    bd = init_rel.ndim - 1    # the candidates' batch dims

    def fanned(x):
        return x.unsqueeze(bd).expand(x.shape[:bd] + (6,) + x.shape[bd:])

    trials = icp_align(fanned(m.feat_local[i]), fanned(m.feat_mask[i]),
                       fanned(m.feat_local[j]), fanned(m.feat_mask[j]), starts)
    score = trials.n_matches.to(trials.residual.dtype) - 0.1 * trials.residual
    best = torch.argmax(torch.where(trials.ok, score, float("-inf")), dim=-1)

    def pick(x):
        if x.ndim == best.ndim + 1:
            return torch.gather(x, -1, best[..., None])[..., 0]
        return torch.gather(x, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]

    match = LoopMatch(*(pick(x) for x in trials))
    ok = match.ok & (match.n_matches >= min_matches) & (match.residual <= max_residual_m)
    return match._replace(ok=ok)


def _verify_all(m: MapState, ci, cj, cvalid, crot, cfg: SlamConfig) -> LoopMatch:
    """`verify_candidate` over the valid ones of [C] candidates, in chunks.
    Rows of invalid candidates are zero and not ok (the JAX package verifies
    them too and masks the result; most candidate slots are empty)."""
    C = ci.shape[0]
    dtype, dev = m.poses.dtype, m.poses.device
    out = LoopMatch(rel_pose=torch.zeros((C, 3), dtype=dtype, device=dev),
                    n_matches=torch.zeros(C, dtype=torch.int32, device=dev),
                    residual=torch.zeros(C, dtype=dtype, device=dev),
                    ok=torch.zeros(C, dtype=torch.bool, device=dev))
    idx = torch.nonzero(cvalid).flatten()
    for k in range(0, idx.shape[0], VERIFY_CHUNK):
        sel = idx[k:k + VERIFY_CHUNK]
        part = verify_candidate(m, ci[sel], cj[sel], cfg, rot_override=crot[sel])
        out = LoopMatch(*(full.index_copy(0, sel, x) for full, x in zip(out, part)))
    return out


def candidate_budget(n_keyframes: int, lo: int = 16, hi: int = 512) -> int:
    """Loop-candidate budget for a live map: one slot per ~8 keyframes,
    clamped to [lo, hi] and rounded up to a power of two."""
    want = min(max(lo, n_keyframes // 8), hi)
    return 1 << (want - 1).bit_length()


class BackendState(NamedTuple):
    """Host-side memory carried between incremental back-end passes:
    `prev_cursor` marks the keyframe prefix whose candidates were already
    retrieved and verified, and the accepted loop edges so far."""

    prev_cursor: int = 0
    edges_ij: np.ndarray = np.zeros((0, 2), np.int32)
    edges_meas: np.ndarray = np.zeros((0, 3), np.float32)


def _dedup(a_i, a_j, c: LoopCandidate):
    """Appearance pairs the pose search already has (valid)."""
    return torch.any((a_i[:, None] == c.i[None, :]) & (a_j[:, None] == c.j[None, :])
                     & c.valid[None, :], dim=1)


def _scan_block(m: MapState, lo: int, cfg: SlamConfig, block: int, per_block_budget: int,
                method: str, radius_m: float, min_index_gap: int):
    """One incremental back-end block: candidates (pose and/or appearance)
    whose later keyframe is in [lo, lo + block), ICP-verified ->
    (ci, cj, ok, rel, valid), fixed size."""
    dtype, dev = m.poses.dtype, m.poses.device
    ci, cj, cvalid, crot = [], [], [], []
    if method in ("pose", "both"):
        c = find_candidates_block(m.poses, m.cursor, lo, block, per_block_budget,
                                  radius_m=radius_m, min_index_gap=min_index_gap)
        ci.append(c.i)
        cj.append(c.j)
        cvalid.append(c.valid)
        crot.append(torch.full((per_block_budget,), float("nan"), dtype=dtype, device=dev))
    if method in ("appearance", "both"):
        a = find_candidates_appearance_block(
            m.descriptors, m.cursor, lo, block, per_block_budget,
            min_index_gap=min_index_gap, max_distance=cfg.sc_max_distance)
        valid = a.valid
        if method == "both":
            valid = valid & ~_dedup(a.i, a.j, c)
        ci.append(a.i)
        cj.append(a.j)
        cvalid.append(valid)
        crot.append(a.rot_init)
    ci, cj, cvalid = torch.cat(ci), torch.cat(cj), torch.cat(cvalid)
    matches = _verify_all(m, ci, cj, cvalid, torch.cat(crot), cfg)
    return ci, cj, matches.ok, matches.rel_pose, cvalid


def scan_new_loops(m: MapState, cfg: SlamConfig, prev_cursor: int, block: int = 128,
                   per_block_budget: int = 64, method: str | None = None,
                   radius_m: float = 10.0, min_index_gap: int = 20, stats=None):
    """Retrieve and ICP-verify loop candidates whose later keyframe is in
    [prev_cursor, cursor) -> accepted (ij [C, 2] int32, rel [C, 3] float32) on
    the host.  The map stays on its device; per block only the fixed-size
    candidate arrays come back.  `stats`, when a dict, receives
    "candidates", the number of valid candidates verified."""
    method = method or cfg.loop_method
    if method not in ("pose", "appearance", "both"):
        raise ValueError(f"incremental back-end supports pose/appearance/both, got {method}")
    M_live = int(m.cursor)
    acc_ij, acc_rel, n_valid = [], [], 0
    for lo in range(prev_cursor, M_live, block):
        ci, cj, ok, rel, valid = (t.cpu().numpy() for t in _scan_block(
            m, lo, cfg, block, per_block_budget, method, radius_m, min_index_gap))
        n_valid += int(valid.sum())
        if ok.any():
            acc_ij.append(np.stack([ci[ok], cj[ok]], axis=1).astype(np.int32))
            acc_rel.append(rel[ok].astype(np.float32))
    if stats is not None:
        stats["candidates"] = n_valid
    if not acc_ij:
        return np.zeros((0, 2), np.int32), np.zeros((0, 3), np.float32)
    return np.concatenate(acc_ij), np.concatenate(acc_rel)


def _with_loop_edges(base: PoseGraph, E0: int, ij, meas, info, mask) -> PoseGraph:
    return base._replace(
        edges_ij=torch.cat([base.edges_ij[:E0], ij]),
        edges_meas=torch.cat([base.edges_meas[:E0], meas]),
        edges_info=torch.cat([base.edges_info[:E0], info]),
        edge_mask=torch.cat([base.edge_mask[:E0], mask]))


def graph_with_loop_edges(m: MapState, edges_ij, edges_meas,
                          loop_info=(50.0, 50.0, 200.0), pad_multiple=256) -> PoseGraph:
    """Odometry-chain pose graph plus explicit, already verified loop edges
    (host arrays), their rows padded to a multiple of `pad_multiple`."""
    C = len(edges_ij)
    Cpad = _padded(C, pad_multiple)
    E0 = m.poses.shape[0]
    base = odometry_graph_from_map(m.poses, m.cursor, max_edges=E0 + Cpad)
    ij = np.zeros((Cpad, 2), np.int64)
    meas = np.zeros((Cpad, 3), np.float32)
    mask = np.zeros(Cpad, bool)
    ij[:C] = edges_ij
    meas[:C] = edges_meas
    mask[:C] = True
    dev = m.poses.device
    return _with_loop_edges(
        base, E0, torch.from_numpy(ij).to(dev), torch.from_numpy(meas).to(dev),
        torch.tensor(loop_info, dtype=base.edges_meas.dtype, device=dev).expand(Cpad, 3),
        torch.from_numpy(mask).to(dev))


def _reanchor_state(state, poses_opt, M_live: int):
    """Feed optimised keyframe poses (rows of `poses_opt`, which may be padded
    past the map's capacity) back into the running SlamState on its device:
    the live map rows take them, and everything live after the last keyframe
    moves with that keyframe's correction."""
    m = state.map
    old = m.poses
    o, nw = old[M_live - 1], poses_opt[M_live - 1]
    dth = geo.wrap_angle(nw[2] - o[2])
    s, c = torch.sin(dth), torch.cos(dth)
    R = torch.stack([torch.stack([c, -s]), torch.stack([s, c])])

    n = min(old.shape[0], poses_opt.shape[0])
    po = torch.zeros_like(old)
    po[:n] = poses_opt[:n]
    live = (torch.arange(old.shape[0], device=old.device) < M_live)[:, None]
    mp = torch.where(live, po, old)
    cp, sp = torch.cos(mp[:, 2])[:, None], torch.sin(mp[:, 2])[:, None]
    local = m.feat_local
    fw = torch.stack([cp * local[..., 0] - sp * local[..., 1] + mp[:, 0:1],
                      cp * local[..., 1] + sp * local[..., 0] + mp[:, 1:2]],
                     dim=-1) * m.feat_mask[..., None]
    pose_new = torch.cat([nw[:2] + (state.pose[:2] - o[:2]) @ R.T, state.pose[2:3] + dth])
    feat_world = ((state.feat_world - o[:2]) @ R.T + nw[:2]) * state.feat_mask[:, None]
    return state._replace(pose=pose_new, kf_pose=nw, feat_world=feat_world,
                          map=m._replace(poses=mp, feat_world=fw))


def incremental_backend(state, cfg: SlamConfig, method: str | None = None,
                        backend_state: BackendState | None = None, stats=None):
    """Mid-run loop closure and pose-graph solve, the corrections fed back
    into the running state -> (state, n_new_loops, pg_cost or None,
    backend_state).

    Verified loop edges persist in `backend_state`; each pass retrieves and
    verifies only pairs whose later keyframe was added since the last pass,
    then re-solves the pose graph ("auto": PCG past 1024 rows) from the
    current poses.  The map is padded to a multiple of 1024 rows, so the
    solver's choice moves only every ~1k keyframes.  The state is returned
    unchanged when no new loop verifies.  `stats`, when a dict, receives
    "candidates" (verified this pass) and the solver's "cg_sweeps"."""
    bs = backend_state if backend_state is not None else BackendState()
    M = int(state.map.cursor)
    if M < 3 or M <= bs.prev_cursor:
        return state, 0, None, bs
    m = trim_map_state_device(state.map, M, pad_multiple=1024)
    new_ij, new_rel = scan_new_loops(m, cfg, bs.prev_cursor, method=method, stats=stats)
    seen = set(map(tuple, bs.edges_ij.tolist()))
    keep = np.array([tuple(e) not in seen for e in new_ij.tolist()], bool)
    new_ij, new_rel = new_ij[keep], new_rel[keep]
    n_new = len(new_ij)
    bs = BackendState(prev_cursor=M,
                      edges_ij=np.concatenate([bs.edges_ij, new_ij]),
                      edges_meas=np.concatenate([bs.edges_meas, new_rel]))
    if n_new == 0:
        return state, 0, None, bs
    graph = graph_with_loop_edges(m, bs.edges_ij, bs.edges_meas)
    poses_opt, cost = optimize_pose_graph(graph, cfg, stats=stats)
    return _reanchor_state(state, poses_opt, M), n_new, float(cost), bs


def close_loops(m: MapState, cfg: SlamConfig, max_candidates: int | None = None,
                radius_m: float = 10.0, min_index_gap: int = 20,
                loop_info=(50.0, 50.0, 200.0), method: str | None = None, stats=None):
    """Full loop-closure pass: candidates -> ICP verification -> the pose graph
    of the odometry chain plus the accepted loop edges -> (graph, matches).

    `max_candidates` defaults to `candidate_budget(live keyframes)`.
    `method` (default `cfg.loop_method`): "pose" (pose proximity), "appearance"
    (scan context), "m2dp" (M2DP over the keyframe clouds) or "both" (pose and
    scan context, appearance pairs the pose search has dropped).  `stats`,
    when a dict, receives "candidates", the number of valid candidates."""
    method = method or cfg.loop_method
    if method not in ("pose", "appearance", "m2dp", "both"):
        raise ValueError(f"unknown loop method {method!r}")
    if max_candidates is None:
        max_candidates = candidate_budget(int(m.cursor))
    dtype, dev = m.poses.dtype, m.poses.device

    ci, cj, cvalid, crot = [], [], [], []
    if method in ("pose", "both"):
        c = find_candidates(m.poses, m.cursor, max_candidates, radius_m, min_index_gap)
        ci.append(c.i)
        cj.append(c.j)
        cvalid.append(c.valid)
        crot.append(torch.full((max_candidates,), float("nan"), dtype=dtype, device=dev))
    if method in ("appearance", "both"):
        a = find_candidates_appearance(m.descriptors, m.cursor, max_candidates,
                                       min_index_gap=min_index_gap,
                                       max_distance=cfg.sc_max_distance)
        valid = a.valid
        if method == "both":
            valid = valid & ~_dedup(a.i, a.j, c)
        ci.append(a.i)
        cj.append(a.j)
        cvalid.append(valid)
        crot.append(a.rot_init)
    if method == "m2dp":
        md = m2dp_from_map(m)
        a = find_candidates_m2dp(md.desc, md.angle, m.cursor, max_candidates,
                                 min_index_gap=min_index_gap,
                                 max_distance=cfg.m2dp_max_distance)
        ci.append(a.i)
        cj.append(a.j)
        cvalid.append(a.valid)
        crot.append(a.rot_init)
    ci, cj, cvalid = torch.cat(ci), torch.cat(cj), torch.cat(cvalid)
    matches = _verify_all(m, ci, cj, cvalid, torch.cat(crot), cfg)
    if stats is not None:
        stats["candidates"] = int(cvalid.sum())

    C = ci.shape[0]
    E0 = m.poses.shape[0]
    base = odometry_graph_from_map(m.poses, m.cursor, max_edges=E0 + C)
    graph = _with_loop_edges(
        base, E0, torch.stack([ci, cj], dim=1), matches.rel_pose,
        torch.tensor(loop_info, dtype=dtype, device=dev).expand(C, 3), matches.ok)
    return graph, matches
