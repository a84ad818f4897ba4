"""Bundle adjustment: SE(2) keyframe poses and 2-D landmarks, Schur complement.

Counterpart of `radarslampy_tpu/models/ba.py`.  LM over (poses, landmarks)
with the landmark 2x2 blocks marginalised in closed form, leaving a reduced
[3M, 3M] pose system:

  * "dense": the reduced system assembled (cross-pose fill-in enumerated up to
    `max_views_per_landmark` views per landmark) and solved by Cholesky; on
    the card its LM iterations after the first are replayed from a CUDA
    graph of one iteration (`posegraph.lm_iterations`);
  * "pcg": matrix-free, the reduced operator applied by per-observation
    gathers and scatter-adds and solved by block-Jacobi PCG (exact for any
    number of views);
  * "auto": dense when M <= 512, else pcg.

`build_ba_problem` packs the map on the host with numpy, as the JAX package
does, so its output order is the same by construction.  Observation model: a
keyframe at pose T sees landmark l at z = R(theta)^T (l - t); the residual
z_obs - z(T, l) is Huber-weighted.  Jacobians are analytic; scatter-adds go
through `ops/scatter.py`.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import numpy as np
import torch

from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.models.frontend import MapState
from radarslampy_tpu_torch.models.posegraph import (_identity, _lm_counts, _lm_update,
                                                    _sweeps_per_check, _wrap_heading,
                                                    cholesky_solve_pos, conjugate_gradient,
                                                    lm_iterations)
from radarslampy_tpu_torch.ops.scatter import scatter_add


class BAProblem(NamedTuple):
    poses: torch.Tensor      # [M, 3] initial keyframe poses
    pose_mask: torch.Tensor  # [M] bool
    landmarks: torch.Tensor  # [L, 2] initial landmark world positions
    lm_mask: torch.Tensor    # [L] bool
    obs_pose: torch.Tensor   # [O] int64 keyframe index per observation
    obs_lm: torch.Tensor     # [O] int64 landmark index per observation
    obs_xy: torch.Tensor     # [O, 2] observed sensor-frame coords
    obs_mask: torch.Tensor   # [O] bool


def build_ba_problem(map_state: MapState, min_views: int = 2,
                     max_landmarks: int | None = None,
                     max_obs: int | None = None) -> BAProblem:
    """Host-side packing of the map's live keyframes into masked BA tensors
    on the map's device.  A landmark id (assigned by the front end) seen from
    >= `min_views` keyframes becomes a variable, initialised at the mean of
    its per-view world estimates."""
    dev = map_state.poses.device
    M = int(map_state.cursor)

    def host(t):
        return t[:M].cpu().numpy()

    ids, mask = host(map_state.feat_ids), host(map_state.feat_mask)
    local, world = host(map_state.feat_local), host(map_state.feat_world)
    poses = host(map_state.poses)

    mm, kk = np.nonzero(mask & (ids >= 0))
    obs_id = ids[mm, kk]
    uniq, inv, counts = np.unique(obs_id, return_inverse=True, return_counts=True)
    keep_lm = counts >= min_views
    keep_obs = keep_lm[inv]
    mm, kk, inv = mm[keep_obs], kk[keep_obs], inv[keep_obs]
    remap = -np.ones(len(uniq), np.int64)
    remap[np.nonzero(keep_lm)[0]] = np.arange(keep_lm.sum())
    lm_idx = remap[inv]

    L = int(keep_lm.sum())
    lm_init = np.zeros((L, 2))
    np.add.at(lm_init, lm_idx, world[mm, kk])
    lm_init /= np.maximum(np.bincount(lm_idx, minlength=L)[:, None], 1)

    O = len(mm)
    Lpad = max_landmarks or max(L, 1)
    Opad = max_obs or max(O, 1)
    if L > Lpad or O > Opad:
        raise ValueError(f"{L} landmarks / {O} observations exceed the padding "
                         f"{Lpad} / {Opad}")

    def pad(a, n):
        out = np.zeros((n,) + a.shape[1:], a.dtype)
        out[: len(a)] = a
        return torch.from_numpy(out).to(dev)

    return BAProblem(
        poses=torch.from_numpy(poses.astype(np.float32)).to(dev),
        pose_mask=torch.ones(M, dtype=torch.bool, device=dev),
        landmarks=pad(lm_init.astype(np.float32), Lpad),
        lm_mask=torch.arange(Lpad, device=dev) < L,
        obs_pose=pad(mm.astype(np.int64), Opad),
        obs_lm=pad(lm_idx.astype(np.int64), Opad),
        obs_xy=pad(local[mm, kk].astype(np.float32), Opad),
        obs_mask=torch.arange(Opad, device=dev) < O,
    )


def reseed_map(m: MapState, kf_poses) -> MapState:
    """The map with its first len(kf_poses) keyframe poses replaced (e.g. by
    the pose graph's) and every keyframe's world features recomputed from
    its pose, on the host with numpy as the JAX driver does, so a BA seeded
    from loop-corrected poses starts from consistent landmark estimates."""
    poses = m.poses.cpu().numpy().copy()
    poses[:len(kf_poses)] = kf_poses
    c = np.cos(poses[:, 2])[:, None]
    s = np.sin(poses[:, 2])[:, None]
    local = m.feat_local.cpu().numpy()
    fw = np.stack([c * local[..., 0] - s * local[..., 1] + poses[:, 0:1],
                   s * local[..., 0] + c * local[..., 1] + poses[:, 1:2]],
                  axis=-1) * m.feat_mask.cpu().numpy()[..., None]
    dev = m.poses.device
    return m._replace(poses=torch.from_numpy(poses).to(dev),
                      feat_world=torch.from_numpy(fw.astype(local.dtype)).to(dev))


def _predict(pose, lm):
    """z(T, l) = R(theta)^T (l - t) [..., 2] and (sin, cos) of theta."""
    s, c = torch.sin(pose[..., 2]), torch.cos(pose[..., 2])
    dx, dy = lm[..., 0] - pose[..., 0], lm[..., 1] - pose[..., 1]
    return torch.stack([c * dx + s * dy, -s * dx + c * dy], -1), s, c


def obs_residual(pose, lm, z):
    """r = z - R(theta)^T (lm - t), difference form, batched."""
    return z - _predict(pose, lm)[0]


def obs_blocks(pose, lm, z, huber_delta):
    """(r [..., 2], Jp [..., 2, 3], Jl [..., 2, 2], Huber weight [...]) with
    analytic Jacobians."""
    pred, s, c = _predict(pose, lm)
    r = z - pred
    Jl = torch.stack([torch.stack([-c, -s], -1), torch.stack([s, -c], -1)], -2)
    Jp = torch.cat([-Jl, torch.stack([-pred[..., 1], pred[..., 0]], -1)[..., None]], -1)
    e = torch.sqrt(torch.sum(r * r, -1) + 1e-12)
    w = torch.where(e <= huber_delta, torch.ones_like(e), huber_delta / e)
    return r, Jp, Jl, w


def ba_cost(poses, landmarks, p: BAProblem, huber_delta):
    r = obs_residual(poses[p.obs_pose], landmarks[p.obs_lm], p.obs_xy)
    rr = torch.sum(r * r, dim=-1)
    e = torch.sqrt(rr + 1e-12)
    w = torch.where(e <= huber_delta, torch.ones_like(e), huber_delta / e)
    return torch.sum(w * p.obs_mask.to(poses.dtype) * rr)


def build_view_table(p: BAProblem, max_views: int):
    """[L, V] table of each landmark's observation indices (padded -1), in the
    order of a stable sort by landmark.

    The JAX package writes every entry past V views, and every masked
    observation, to [L-1, V-1] with -1, in sort order; the table's
    [L-1, V-1] is therefore the value of the last entry in sort order that
    lands there, which is what this reproduces."""
    L, V = p.landmarks.shape[0], max_views
    dev = p.obs_lm.device
    order = torch.argsort(p.obs_lm + (~p.obs_mask).to(torch.int64) * 10**6, stable=True)
    lm_sorted = p.obs_lm[order]
    valid_sorted = p.obs_mask[order]
    same_as_prev = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                              lm_sorted[1:] == lm_sorted[:-1]]) & valid_sorted
    k = torch.arange(order.shape[0], device=dev)
    run_start = torch.cummax(torch.where(same_as_prev, 0, k), 0).values
    ranks = k - run_start
    ok = valid_sorted & (ranks < V)
    # ok entries land on distinct cells; the rest go to a dropped extra row
    table = torch.full((L + 1, V), -1, dtype=torch.int64, device=dev)
    table[torch.where(ok, lm_sorted, L), torch.where(ok, ranks, 0)] = torch.where(ok, order, -1)
    table = table[:L]
    last = (~ok) | ((lm_sorted == L - 1) & (ranks == V - 1))
    k_last = torch.max(torch.where(last, k, -1))
    val = torch.where(ok, order, -1).index_select(0, torch.clamp(k_last, min=0).reshape(1))[0]
    table[L - 1, V - 1] = torch.where(k_last >= 0, val, table[L - 1, V - 1])
    return table


def schur_blocks(poses, landmarks, p: BAProblem, hd, lam, n_poses=None):
    """Per-LM-iteration Schur ingredients with no dense [M, M] structure:
    (Hpp [M,3,3] block-diagonal pose Hessian, bs [M,3] reduced rhs, Hinv
    [L,2,2] damped landmark-block inverses, bl [L,2], U [O,3,2] couplings)."""
    dtype, dev = poses.dtype, poses.device
    M = n_poses or poses.shape[0]
    L = landmarks.shape[0]
    r, Jp, Jl, w = obs_blocks(poses[p.obs_pose], landmarks[p.obs_lm], p.obs_xy, hd)
    w = w * p.obs_mask.to(dtype)
    wr = w[:, None] * r
    Hpp = scatter_add(torch.zeros((M, 3, 3), dtype=dtype, device=dev), p.obs_pose,
                      torch.einsum("oab,oac->obc", Jp, w[:, None, None] * Jp))
    bp = scatter_add(torch.zeros((M, 3), dtype=dtype, device=dev), p.obs_pose,
                     torch.einsum("oab,oa->ob", Jp, wr))
    Hll = scatter_add(torch.zeros((L, 2, 2), dtype=dtype, device=dev), p.obs_lm,
                      torch.einsum("oab,oac->obc", Jl, w[:, None, None] * Jl))
    bl = scatter_add(torch.zeros((L, 2), dtype=dtype, device=dev), p.obs_lm,
                     torch.einsum("oab,oa->ob", Jl, wr))
    # damped landmark blocks, closed-form 2x2 inverse
    Hll_d = Hll + (lam * ((Hll[:, 0, 0] + Hll[:, 1, 1]) * 0.5) + 1e-8)[:, None, None] \
        * torch.eye(2, dtype=dtype, device=dev)
    det = Hll_d[:, 0, 0] * Hll_d[:, 1, 1] - Hll_d[:, 0, 1] * Hll_d[:, 1, 0]
    det = torch.where(torch.abs(det) > 1e-12, det, torch.ones_like(det))
    Hinv = torch.stack([torch.stack([Hll_d[:, 1, 1], -Hll_d[:, 0, 1]], -1),
                        torch.stack([-Hll_d[:, 1, 0], Hll_d[:, 0, 0]], -1)], -2) \
        / det[:, None, None] * p.lm_mask[:, None, None].to(dtype)
    U = torch.einsum("oab,oac->obc", Jp, w[:, None, None] * Jl)
    bs = scatter_add(bp, p.obs_pose,
                     -torch.einsum("oab,obc,oc->oa", U, Hinv[p.obs_lm], bl[p.obs_lm]))
    return Hpp, bs, Hinv, bl, U


def schur_reduced_system(poses, landmarks, p: BAProblem, view_table, hd, lam,
                         n_poses=None):
    """The dense Schur-reduced pose system (cross-pose fill-in through
    `view_table`, exact for landmarks with <= V views) -> (H [3M, 3M] without
    anchor or damping, bs [M,3], Hinv, bl, U).  O(M^2) memory."""
    dtype, dev = poses.dtype, poses.device
    M = n_poses or poses.shape[0]
    V = view_table.shape[1]
    Hpp, bs, Hinv, bl, U = schur_blocks(poses, landmarks, p, hd, lam, n_poses=n_poses)
    vt_ok = view_table >= 0
    vt_safe = torch.clamp(view_table, min=0)
    U_l = U[vt_safe] * vt_ok[..., None, None].to(dtype)           # [L, V, 3, 2]
    pose_l = p.obs_pose[vt_safe]                                   # [L, V]
    A = torch.einsum("lvab,lbc->lvac", U_l, Hinv)
    C = torch.einsum("lvab,lucb->lvuac", A, U_l)                   # [L, V, V, 3, 3]
    rows = pose_l[:, :, None].expand(-1, V, V).reshape(-1)
    cols = pose_l[:, None, :].expand(-1, V, V).reshape(-1)
    Hb = scatter_add(torch.zeros((M, M, 3, 3), dtype=dtype, device=dev), (rows, cols),
                     -C.reshape(-1, 3, 3))
    diag = torch.arange(M, device=dev)
    Hb = scatter_add(Hb, (diag, diag), Hpp)
    return Hb.permute(0, 2, 1, 3).reshape(3 * M, 3 * M), bs, Hinv, bl, U


def reduced_anchor(M: int, dtype, device):
    """The [3M] diagonal that anchors pose 0 in the reduced system."""
    anchor = torch.zeros(3 * M, dtype=dtype, device=device)
    anchor[:3] = 1e8
    return anchor


def solve_reduced(H, bs, lam, anchor):
    """Anchor pose 0 (`reduced_anchor`), damp, Cholesky-solve the reduced
    pose system."""
    A = H + torch.diag(anchor + lam * (torch.diagonal(H) + 1e-9))
    return -cholesky_solve_pos(A, bs.reshape(-1)).reshape(-1, 3)


def back_substitute_landmarks(Hinv, bl, U, delta_p, p: BAProblem):
    """dl = -Hinv (bl + Hlp dp), (Hlp dp)_l = sum over l's observations o of
    U_o^T dp_m(o)."""
    Hlp_dp = scatter_add(torch.zeros_like(bl), p.obs_lm,
                         torch.einsum("oab,oa->ob", U, delta_p[p.obs_pose]))
    return -torch.einsum("lab,lb->la", Hinv, bl + Hlp_dp)


def _accept(poses, landmarks, lam, cost, delta_p, delta_l, p: BAProblem, hd, red):
    cand_p = _wrap_heading(poses + delta_p)
    cand_l = landmarks + delta_l
    new_cost = red(ba_cost(cand_p, cand_l, p, hd))
    accept = new_cost < cost
    return (torch.where(accept, cand_p, poses), torch.where(accept, cand_l, landmarks),
            _lm_update(accept, lam), torch.where(accept, new_cost, cost))


def optimize_ba(p: BAProblem, cfg: SlamConfig, max_views_per_landmark: int = 8,
                method: str = "auto", stats=None, replay: bool = True):
    """Fixed-budget LM bundle adjustment -> (poses, landmarks, cost).  On the
    card the dense LM iterations and the PCG sweeps are replayed from CUDA
    graphs; `replay` False runs them eagerly (the same bits).  `stats`, when
    a dict, receives "cg_sweeps" (0 for the dense solver) and the chosen
    solver's counts of its graphs ("lm_*" or "cg_*")."""
    if method == "auto":
        method = "dense" if p.poses.shape[0] <= 512 else "pcg"
    if method == "pcg":
        return _optimize_ba_pcg(p, cfg, stats=stats, replay=replay)
    if method != "dense":
        raise ValueError(f"method must be dense, pcg or auto, got {method!r}")
    if stats is not None:
        stats["cg_sweeps"] = 0
    return _optimize_ba_dense(p, cfg, max_views_per_landmark, stats=stats, replay=replay)


def ba_lm_step(p: BAProblem, view_table, anchor, hd, carry, reduce_fn=None):
    """One dense Schur LM iteration: carry (poses, landmarks, lam, cost) ->
    the carry after it.  `anchor` is `reduced_anchor`'s; with `p`'s landmarks
    (and their observations) split over ranks, `reduce_fn` sums the reduced
    system and the cost over them (identity by default); the landmark
    back-substitution stays local.  This is the body that
    `posegraph.lm_iterations` captures."""
    red = reduce_fn or _identity
    poses, landmarks, lam, cost = carry
    H, bs, Hinv, bl, U = schur_reduced_system(poses, landmarks, p, view_table, hd, lam)
    delta_p = solve_reduced(red(H), red(bs), lam, anchor)
    delta_l = back_substitute_landmarks(Hinv, bl, U, delta_p, p)
    return _accept(poses, landmarks, lam, cost, delta_p, delta_l, p, hd, red)


def _optimize_ba_dense(p: BAProblem, cfg: SlamConfig, max_views_per_landmark: int,
                       reduce_fn=None, replay: bool = True, stats=None):
    """Dense Schur LM: `cfg.pg_iterations` calls of `ba_lm_step` through
    `posegraph.lm_iterations` (replayed from a CUDA graph on the card unless
    `replay` is False).  With `p`'s landmarks split over ranks
    (parallel/dist_ba.py), `reduce_fn` sums the reduced system and the costs
    over them; defaults to the identity.  `stats`, when a dict, receives
    `lm_iterations`' "lm_*" keys."""
    red = reduce_fn or _identity
    hd = cfg.pg_huber_delta
    view_table = build_view_table(p, max_views_per_landmark)
    anchor = reduced_anchor(p.poses.shape[0], p.poses.dtype, p.poses.device)
    lam = torch.tensor(1e-3, dtype=p.poses.dtype, device=p.poses.device)
    counts = _lm_counts()
    carry = lm_iterations(
        lambda c: ba_lm_step(p, view_table, anchor, hd, c, reduce_fn),
        (p.poses, p.landmarks, lam, red(ba_cost(p.poses, p.landmarks, p, hd))),
        cfg.pg_iterations, replay, counts)
    if stats is not None:
        stats.update(counts)
    poses, landmarks, _, cost = carry
    return poses, landmarks, cost


def _optimize_ba_pcg(p: BAProblem, cfg: SlamConfig, sweeps_per_check=None, stats=None,
                     reduce_fn=None, replay: bool = True):
    """Matrix-free Schur BA.  The reduced operator S = Hpp - U Hll^-1 U^T is
    applied as
        S v = Hpp_m v_m - sum_{o in m} U_o Hinv_l(o) t_l(o),
        t_l = sum_{o in l} U_o^T v_m(o)
    (two scatter-adds per sweep); the preconditioner is the exact block
    diagonal of S plus the pose-0 anchor and the damping.

    `reduce_fn` sums landmark-parallel contributions over ranks when `p`
    holds only this rank's landmarks and their observations
    (parallel/dist_ba.py): only [M, 3] and [M, 3, 3] arrays cross ranks, and
    every value a branch reads is reduced.  Defaults to the identity.  On the
    card the sweeps are replayed from a CUDA graph, with or without
    `reduce_fn` (its all-reduce captured too); `replay` False runs them
    eagerly.  `stats` as in `posegraph._optimize_pose_graph_pcg`."""
    dtype, dev = p.poses.dtype, p.poses.device
    M, L = p.poses.shape[0], p.landmarks.shape[0]
    hd = cfg.pg_huber_delta
    n_cg = cfg.pg_cg_iterations or 8 * M
    spc = _sweeps_per_check(cfg, sweeps_per_check)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    fix = torch.zeros(M, dtype=dtype, device=dev)
    fix[0] = 1e8
    zeros_m3 = torch.zeros((M, 3), dtype=dtype, device=dev)
    zeros_l2 = torch.zeros((L, 2), dtype=dtype, device=dev)
    red = reduce_fn or _identity
    poses, landmarks = p.poses, p.landmarks
    lam = torch.tensor(1e-3, dtype=dtype, device=dev)
    cost = red(ba_cost(poses, landmarks, p, hd))
    counts = collections.Counter(cg_sweeps=0, cg_captures=0, cg_capture_s=0.0, cg_batches=0,
                                 cg_batch_s=0.0)
    for _ in range(cfg.pg_iterations):
        Hpp, bs, Hinv, bl, U = schur_blocks(poses, landmarks, p, hd, lam)
        Hpp, bs = red(Hpp), red(bs)
        UHU = red(scatter_add(torch.zeros((M, 3, 3), dtype=dtype, device=dev), p.obs_pose,
                              torch.einsum("oab,obc,odc->oad", U, Hinv[p.obs_lm], U)))
        S_diag = Hpp - UHU
        damp = lam * (torch.diagonal(S_diag, dim1=1, dim2=2) + 1e-9)
        pinv = torch.linalg.inv(S_diag + fix[:, None, None] * eye3 + torch.diag_embed(damp))

        def afun(v):
            t = scatter_add(zeros_l2, p.obs_lm, torch.einsum("oab,oa->ob", U, v[p.obs_pose]))
            s = torch.einsum("lab,lb->la", Hinv, t)
            Uv = red(scatter_add(zeros_m3, p.obs_pose,
                                 torch.einsum("oab,ob->oa", U, s[p.obs_lm])))
            return torch.einsum("mab,mb->ma", Hpp, v) - Uv + fix[:, None] * v + damp * v

        delta_p, sweeps = conjugate_gradient(afun, pinv, bs, n_cg, spc, replay, counts)
        counts["cg_sweeps"] += sweeps
        delta_l = back_substitute_landmarks(Hinv, bl, U, delta_p, p)
        poses, landmarks, lam, cost = _accept(poses, landmarks, lam, cost, delta_p,
                                              delta_l, p, hd, red)
    if stats is not None:
        stats.update(counts)
    return poses, landmarks, cost
