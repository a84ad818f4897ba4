"""SE(2) pose-graph optimisation: damped Gauss-Newton (LM) on tensors.

Counterpart of `radarslampy_tpu/models/posegraph.py`: fixed-capacity node and
edge tensors with validity masks, Huber-robust edges whose delta is annealed
(GNC), the gauge fixed on node 0, and two solvers of the LM step:

  * "dense": the [3M, 3M] normal matrix assembled by block scatter-add and
    solved by Cholesky (`torch.linalg.cholesky_ex` / `cholesky_solve` in place
    of `jax.scipy.linalg.solve(..., assume_a="pos")`);
  * "pcg": matrix-free block-Jacobi preconditioned conjugate gradient, with
    the iterate sequence of the JAX package's host-driven slices.
  * "auto": dense when M <= 1024, else pcg.

Differences in form, not in result: the Jacobians are analytic (the JAX
package takes `jax.jacfwd` of the residual), scatter-adds go through
`ops/scatter.py` (the same bits on every run), and the PCG loop runs on the
host with its state frozen on the device by `torch.where` once the stopping
rule holds, checking the rule on the host every few sweeps (on the card, a
CUDA graph of those sweeps is replayed between checks).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.ops import geometry as geo
from radarslampy_tpu_torch.ops.scatter import scatter_add

# Most PCG sweeps between two host checks of the stopping rule.  The sweeps
# after the rule holds are frozen by torch.where, so the check interval
# changes only how many masked sweeps run, never the iterates.
SWEEPS_PER_CHECK = 16


class PoseGraph(NamedTuple):
    poses: torch.Tensor       # [M, 3] node estimates
    node_mask: torch.Tensor   # [M] bool
    edges_ij: torch.Tensor    # [E, 2] int64 (i, j)
    edges_meas: torch.Tensor  # [E, 3] measured relative pose T_i^-1 T_j
    edges_info: torch.Tensor  # [E, 3] diagonal information (weights) per component
    edge_mask: torch.Tensor   # [E] bool


def edge_residual(pose_i, pose_j, meas):
    """r = T_meas^-1 (T_i^-1 T_j) as [..., 3] = [dx, dy, dtheta], batched over
    leading dims, in difference form (the small pose difference is taken
    first and only then rotated)."""
    dx = pose_j[..., 0] - pose_i[..., 0]
    dy = pose_j[..., 1] - pose_i[..., 1]
    si, ci = torch.sin(pose_i[..., 2]), torch.cos(pose_i[..., 2])
    rel_x = ci * dx + si * dy
    rel_y = -si * dx + ci * dy
    ex = rel_x - meas[..., 0]
    ey = rel_y - meas[..., 1]
    sm, cm = torch.sin(meas[..., 2]), torch.cos(meas[..., 2])
    return torch.stack([cm * ex + sm * ey, -sm * ex + cm * ey,
                        geo.wrap_angle(pose_j[..., 2] - pose_i[..., 2] - meas[..., 2])],
                       dim=-1)


def edge_jacobians(pose_i, pose_j, meas):
    """Analytic d r / d pose_i and d r / d pose_j, each [..., 3, 3]."""
    dx = pose_j[..., 0] - pose_i[..., 0]
    dy = pose_j[..., 1] - pose_i[..., 1]
    si, ci = torch.sin(pose_i[..., 2]), torch.cos(pose_i[..., 2])
    sm, cm = torch.sin(meas[..., 2]), torch.cos(meas[..., 2])
    rel_x = ci * dx + si * dy
    rel_y = -si * dx + ci * dy
    # d r_xy / d (dx, dy) = Rm^T Ri^T
    a00 = cm * ci - sm * si
    a01 = cm * si + sm * ci
    a10 = -sm * ci - cm * si
    a11 = -sm * si + cm * ci
    # d r_xy / d theta_i = Rm^T d rel / d theta_i = Rm^T [rel_y, -rel_x]
    t0 = cm * rel_y - sm * rel_x
    t1 = -sm * rel_y - cm * rel_x
    zero, one = torch.zeros_like(dx), torch.ones_like(dx)
    Jj = torch.stack([torch.stack([a00, a01, zero], -1),
                      torch.stack([a10, a11, zero], -1),
                      torch.stack([zero, zero, one], -1)], -2)
    Ji = torch.stack([torch.stack([-a00, -a01, t0], -1),
                      torch.stack([-a10, -a11, t1], -1),
                      torch.stack([zero, zero, -one], -1)], -2)
    return Ji, Jj


def _edge_ends(poses, g: PoseGraph):
    return poses[g.edges_ij[:, 0]], poses[g.edges_ij[:, 1]]


def edge_system(poses, g: PoseGraph, huber_delta):
    """Per-edge (r [E,3], Ji [E,3,3], Jj [E,3,3], W [E,3]): residual,
    Jacobians and the Huber-weighted information, zero on masked edges."""
    pi, pj = _edge_ends(poses, g)
    r = edge_residual(pi, pj, g.edges_meas)
    Ji, Jj = edge_jacobians(pi, pj, g.edges_meas)
    e = torch.sqrt(torch.sum(r * r * g.edges_info, dim=-1) + 1e-12)
    w = torch.where(e <= huber_delta, torch.ones_like(e), huber_delta / e)
    W = g.edges_info * w[:, None]
    m = g.edge_mask.to(poses.dtype)
    return r * m[:, None], Ji * m[:, None, None], Jj * m[:, None, None], W * m[:, None]


def _gradient(r, Ji, Jj, W, ei, ej, M):
    """b = J^T W r per node [M, 3]."""
    Wr = W * r
    return scatter_add(torch.zeros((M, 3), dtype=r.dtype, device=r.device),
                       torch.cat([ei, ej]),
                       torch.cat([torch.einsum("eab,ea->eb", Ji, Wr),
                                  torch.einsum("eab,ea->eb", Jj, Wr)]))


def assemble_normal_equations(poses, g: PoseGraph, huber_delta):
    """Dense H = J^T W J [3M, 3M] and b = J^T W r [3M] by block scatter-add."""
    M = poses.shape[0]
    r, Ji, Jj, W = edge_system(poses, g, huber_delta)
    i, j = g.edges_ij[:, 0], g.edges_ij[:, 1]
    WJi = W[:, :, None] * Ji
    WJj = W[:, :, None] * Jj
    Hii = torch.einsum("eab,eac->ebc", Ji, WJi)
    Hjj = torch.einsum("eab,eac->ebc", Jj, WJj)
    Hij = torch.einsum("eab,eac->ebc", Ji, WJj)
    Hb = scatter_add(torch.zeros((M, M, 3, 3), dtype=poses.dtype, device=poses.device),
                     (torch.cat([i, j, i, j]), torch.cat([i, j, j, i])),
                     torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2)]))
    H = Hb.permute(0, 2, 1, 3).reshape(3 * M, 3 * M)
    return H, _gradient(r, Ji, Jj, W, i, j, M).reshape(3 * M)


def _gauge_and_mask(H, b, node_mask):
    """H with a 1e8 anchor on the diagonal of node 0 and of dead nodes."""
    fix = torch.where(node_mask, 0.0, 1e8).to(H.dtype)
    fix[0] += 1e8
    return H + torch.diag(torch.repeat_interleave(fix, 3)), b


def graph_cost(poses, g: PoseGraph, huber_delta):
    r, _, _, W = edge_system(poses, g, huber_delta)
    return torch.sum(W * r * r)


def _edge_robust_err(poses, g: PoseGraph):
    """Per-edge e = sqrt(r^T diag(info) r), zero on masked edges."""
    pi, pj = _edge_ends(poses, g)
    r = edge_residual(pi, pj, g.edges_meas)
    e = torch.sqrt(torch.sum(r * r * g.edges_info, dim=1) + 1e-12)
    return e * g.edge_mask.to(poses.dtype)


def _identity(x):
    return x


def _huber_schedule(g: PoseGraph, cfg: SlamConfig, reduce_max_fn=None):
    """Per-LM-iteration Huber deltas [N]: annealed geometrically from the
    largest initial robustified edge error down to cfg.pg_huber_delta (GNC),
    constant when cfg.pg_gnc_anneal is off.  With the edges split over ranks,
    `reduce_max_fn` takes the largest error over them (a sum would count it
    once per rank)."""
    dtype, dev = g.poses.dtype, g.poses.device
    hd = torch.tensor(cfg.pg_huber_delta, dtype=dtype, device=dev)
    N = cfg.pg_iterations
    if not cfg.pg_gnc_anneal:
        return hd.expand(N).clone()
    e0 = (reduce_max_fn or _identity)(torch.max(_edge_robust_err(g.poses, g)))
    start = torch.maximum(e0, hd)
    frac = torch.arange(N, dtype=dtype, device=dev) / max(N - 1, 1)
    return torch.exp((1.0 - frac) * torch.log(start) + frac * torch.log(hd))


def _wrap_heading(p):
    return torch.cat([p[:, :2], geo.wrap_angle(p[:, 2:3])], dim=1)


def _lm_update(accept, lam):
    return torch.where(accept, torch.clamp(lam * 0.3, min=1e-9),
                       torch.clamp(lam * 8.0, max=1e7))


def cholesky_solve_pos(A, b):
    """x with A x = b for symmetric positive definite A, with no host sync;
    NaN where the factorisation fails (as the JAX solve gives), so an LM step
    built on it is rejected."""
    L, info = torch.linalg.cholesky_ex(A)
    x = torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.where(info == 0, x, torch.full_like(x, float("nan")))


def optimize_pose_graph(g: PoseGraph, cfg: SlamConfig, method: str = "auto", stats=None):
    """Fixed-budget LM over the whole graph -> (poses [M, 3], final cost).

    `stats`, when a dict, receives "cg_sweeps": the PCG sweeps summed over the
    LM iterations (0 for the dense solver)."""
    if method == "auto":
        method = "dense" if g.poses.shape[0] <= 1024 else "pcg"
    if method == "pcg":
        return _optimize_pose_graph_pcg(g, cfg, stats=stats)
    if method != "dense":
        raise ValueError(f"method must be dense, pcg or auto, got {method!r}")
    if stats is not None:
        stats["cg_sweeps"] = 0
    return _optimize_pose_graph_dense(g, cfg)


def _optimize_pose_graph_dense(g: PoseGraph, cfg: SlamConfig, reduce_fn=None,
                               reduce_max_fn=None):
    """Dense LM.  With `g`'s edges split over ranks (parallel/dist_posegraph.py),
    `reduce_fn` sums the edge-parallel H, b and costs over them and
    `reduce_max_fn` takes the GNC start; both default to the identity."""
    red = reduce_fn or _identity
    poses = g.poses
    lam = torch.tensor(1e-4, dtype=poses.dtype, device=poses.device)
    for hd_k in _huber_schedule(g, cfg, reduce_max_fn):
        # the Huber delta changes across iterations (GNC), so the acceptance
        # test recomputes the current cost under this iteration's delta
        cost = red(graph_cost(poses, g, hd_k))
        H, b = assemble_normal_equations(poses, g, hd_k)
        H, b = _gauge_and_mask(red(H), red(b), g.node_mask)
        A = H + lam * torch.diag(torch.diagonal(H) + 1e-9)
        cand = _wrap_heading(poses - cholesky_solve_pos(A, b).reshape(-1, 3))
        accept = red(graph_cost(cand, g, hd_k)) < cost
        poses = torch.where(accept, cand, poses)
        lam = _lm_update(accept, lam)
    return poses, red(graph_cost(poses, g, cfg.pg_huber_delta))


def conjugate_gradient(afun, pinv, b, n_cg: int, sweeps_per_check: int, replay: bool = True):
    """Block-Jacobi PCG for A x = -b (A applied by `afun`, the [N, 3, 3] inverse
    diagonal blocks in `pinv`), x0 = 0, up to `n_cg` sweeps, stopping when
    r.z <= 1e-10 r0.z0 or <= 1e-20 -> (x, sweeps run).

    Each sweep is computed on the device and kept only while the stopping
    rule does not hold yet, so the iterates do not depend on
    `sweeps_per_check`, the number of sweeps between two host reads of the
    rule.  On a CUDA device the sweeps after the first `sweeps_per_check` are
    replayed from a CUDA graph of that many sweeps: the same kernels on the
    same buffers, without the host's launch work for each of them.  `replay`
    False keeps every sweep eager: the sharded solvers' `afun` runs a
    collective, which is not captured."""
    def minv(v):
        return torch.einsum("mab,mb->ma", pinv, v)

    rr = -b
    z = minv(rr)
    rz0 = torch.sum(rr * z)

    def rule(it, rz):
        return (it < n_cg) & (rz > 1e-10 * rz0) & (rz > 1e-20)

    def sweeps(state):
        x, rr, p, rz, it = state
        for _ in range(sweeps_per_check):
            active = rule(it, rz)
            Ap = afun(p)
            pAp = torch.sum(p * Ap)
            ok = pAp > 1e-30
            alpha = torch.where(ok, rz / torch.where(ok, pAp, torch.ones_like(pAp)),
                                torch.zeros_like(pAp))
            rr_n = rr - alpha * Ap
            z_n = minv(rr_n)
            rz_n = torch.sum(rr_n * z_n)
            beta = torch.where(ok, rz_n / rz, torch.zeros_like(rz))
            x = torch.where(active, x + alpha * p, x)
            rr = torch.where(active, rr_n, rr)
            p = torch.where(active, z_n + beta * p, p)
            rz = torch.where(active, rz_n, rz)
            it = it + active.to(it.dtype)
        return [x, rr, p, rz, it]

    def check(state):
        more, n = torch.stack([rule(state[4], state[3]).to(torch.int64), state[4]]).tolist()
        return bool(more), n

    state = sweeps([torch.zeros_like(b), rr, z, rz0,
                    torch.zeros((), dtype=torch.int64, device=b.device)])
    more, n = check(state)
    if more and replay and b.is_cuda:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for dst, src in zip(state, sweeps(state)):
                dst.copy_(src)
        while more:
            graph.replay()
            more, n = check(state)
    while more:
        state = sweeps(state)
        more, n = check(state)
    return state[0], n


def _sweeps_per_check(cfg: SlamConfig, sweeps_per_check):
    if sweeps_per_check is not None:
        return sweeps_per_check
    return max(1, min(cfg.pg_sweeps_per_dispatch, SWEEPS_PER_CHECK))


def _optimize_pose_graph_pcg(g: PoseGraph, cfg: SlamConfig, sweeps_per_check=None,
                             stats=None, reduce_fn=None, reduce_max_fn=None):
    """Matrix-free LM: each step solves (H + lam diag(H)) delta = -b by PCG
    on the gauge-projected system (node 0 and dead nodes frozen exactly, not
    by a 1e8 penalty, which float32 CG cannot survive).  Per sweep: one
    gather, two batched [E,3,3]x[E,3] products and one scatter-add.

    `reduce_fn` sums edge-parallel contributions over ranks when `g` holds
    only this rank's edges (parallel/dist_posegraph.py): only [M, 3]-sized
    vectors and [M, 3, 3] blocks cross ranks, one [M, 3] sum per sweep, and
    every value a branch reads (the CG stopping rule, the LM acceptance) is
    reduced, so all ranks take the same branches.  `reduce_max_fn` takes the
    GNC start.  Both default to the identity; with `reduce_fn` the sweeps run
    eagerly (no CUDA graph)."""
    dtype, dev = g.poses.dtype, g.poses.device
    M = g.poses.shape[0]
    n_cg = cfg.pg_cg_iterations or 8 * M
    spc = _sweeps_per_check(cfg, sweeps_per_check)
    red = reduce_fn or _identity
    ei, ej = g.edges_ij[:, 0], g.edges_ij[:, 1]
    eij = torch.cat([ei, ej])
    free = (g.node_mask & (torch.arange(M, device=dev) > 0)).to(dtype)[:, None]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    zeros_m3 = torch.zeros((M, 3), dtype=dtype, device=dev)
    poses = g.poses
    lam = torch.tensor(1e-4, dtype=dtype, device=dev)
    total = 0
    for hd_k in _huber_schedule(g, cfg, reduce_max_fn):
        r, Ji, Jj, W = edge_system(poses, g, hd_k)
        b = red(_gradient(r, Ji, Jj, W, ei, ej, M)) * free
        D = red(scatter_add(torch.zeros((M, 3, 3), dtype=dtype, device=dev), eij,
                            torch.cat([torch.einsum("eab,eac->ebc", Ji, W[:, :, None] * Ji),
                                       torch.einsum("eab,eac->ebc", Jj, W[:, :, None] * Jj)])))
        damp = lam * (torch.diagonal(D, dim1=1, dim2=2) + 1e-9)
        P = (D + torch.diag_embed(damp)) * free[..., None] + (1.0 - free[..., None]) * eye3
        pinv = torch.linalg.inv(P)

        def afun(v):  # projected (H + lam diag) v
            vf = v * free
            u = W * (torch.einsum("eab,eb->ea", Ji, vf[ei])
                     + torch.einsum("eab,eb->ea", Jj, vf[ej]))
            Hv = red(scatter_add(zeros_m3, eij, torch.cat([torch.einsum("eab,ea->eb", Ji, u),
                                                           torch.einsum("eab,ea->eb", Jj, u)])))
            return (Hv + damp * vf) * free + (1.0 - free) * v

        delta, sweeps = conjugate_gradient(afun, pinv, b, n_cg, spc, replay=reduce_fn is None)
        total += sweeps
        cost = red(graph_cost(poses, g, hd_k))
        cand = _wrap_heading(poses + delta)
        accept = red(graph_cost(cand, g, hd_k)) < cost
        poses = torch.where(accept, cand, poses)
        lam = _lm_update(accept, lam)
    if stats is not None:
        stats["cg_sweeps"] = total
    return poses, red(graph_cost(poses, g, cfg.pg_huber_delta))


def odometry_graph_from_map(map_poses, cursor, max_edges=None,
                            info=(100.0, 100.0, 400.0)) -> PoseGraph:
    """Chain-of-keyframes odometry graph of a MapState's poses: consecutive
    live keyframes get an edge measuring their current relative pose.  Edge
    rows past the chain (up to `max_edges`) are masked; loop-closure edges
    are written there by models/loopclosure.py."""
    M = map_poses.shape[0]
    dev = map_poses.device
    E = max_edges or M
    idx = torch.arange(E, device=dev)
    i = torch.clamp(idx, max=M - 2)
    j = i + 1
    cursor = torch.as_tensor(cursor, device=dev)
    pi, pj = map_poses[i], map_poses[j]
    dx, dy = pj[:, 0] - pi[:, 0], pj[:, 1] - pi[:, 1]
    si, ci = torch.sin(pi[:, 2]), torch.cos(pi[:, 2])
    rel = torch.stack([ci * dx + si * dy, -si * dx + ci * dy,
                       geo.wrap_angle(pj[:, 2] - pi[:, 2])], dim=-1)
    return PoseGraph(
        poses=map_poses,
        node_mask=torch.arange(M, device=dev) < cursor,
        edges_ij=torch.stack([i, j], dim=1),
        edges_meas=rel,
        edges_info=torch.tensor(info, dtype=map_poses.dtype, device=dev).expand(E, 3).clone(),
        edge_mask=(idx + 1) < cursor,
    )
