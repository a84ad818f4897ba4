"""SE(2) pose-graph optimisation: damped Gauss-Newton (LM) on tensors.

Counterpart of `radarslampy_tpu/models/posegraph.py`: fixed-capacity node and
edge tensors with validity masks, Huber-robust edges whose delta is annealed
(GNC), the gauge fixed on node 0, and two solvers of the LM step:

  * "dense": the [3M, 3M] normal matrix assembled by block scatter-add and
    solved by Cholesky (`torch.linalg.cholesky_ex` / `cholesky_solve` in place
    of `jax.scipy.linalg.solve(..., assume_a="pos")`); on the card its LM
    iterations after the first are replayed from a CUDA graph of one
    iteration (`lm_iterations`), the counterpart of the JAX package's
    `lax.scan` under `jit`;
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

import collections
import time
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


def _gauge_diag(node_mask, dtype):
    """The [3M] diagonal added to H: a 1e8 anchor on node 0 and on dead nodes."""
    fix = torch.where(node_mask, 0.0, 1e8).to(dtype)
    fix[0] += 1e8
    return torch.repeat_interleave(fix, 3)


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


def optimize_pose_graph(g: PoseGraph, cfg: SlamConfig, method: str = "auto", stats=None,
                        replay: bool = True):
    """Fixed-budget LM over the whole graph -> (poses [M, 3], final cost).

    On the card the dense LM iterations and the PCG sweeps are replayed from
    CUDA graphs; `replay` False runs them eagerly (the same bits).  `stats`,
    when a dict, receives "cg_sweeps": the PCG sweeps summed over the LM
    iterations (0 for the dense solver), and the chosen solver's counts of
    its graphs (`lm_iterations`' "lm_*" keys, `conjugate_gradient`'s
    "cg_*")."""
    if method == "auto":
        method = "dense" if g.poses.shape[0] <= 1024 else "pcg"
    if method == "pcg":
        return _optimize_pose_graph_pcg(g, cfg, stats=stats, replay=replay)
    if method != "dense":
        raise ValueError(f"method must be dense, pcg or auto, got {method!r}")
    if stats is not None:
        stats["cg_sweeps"] = 0
    return _optimize_pose_graph_dense(g, cfg, stats=stats, replay=replay)


def lm_iterations(body, carry, n: int, replay: bool = True, stats=None):
    """`n` iterations of `body` (a tuple of device tensors -> the tuple after
    one iteration) from `carry` -> the carry after them: the counterpart of
    the JAX package's `lax.scan` of an LM step under `jit`.

    Iteration 0 runs eagerly; it warms up what the body's calls set up at
    their first use (cuSOLVER's handle and workspace, the caching allocator,
    a collective's communicator).  On a CUDA carry with `replay` and n > 1,
    one call of the body is then captured in a CUDA graph that writes its
    result into the carry's buffers, and the graph is replayed n - 1 times
    with no host read between replays: the same kernels on the same inputs,
    so the bits of the eager loop.  With a collective in the body (the
    sharded solvers' `reduce_fn`) the graph holds it, and every rank replays
    n - 1 times.  The body reads nothing to the host and makes no tensor from
    host data; the graph reads the other tensors the body closes over by
    address, so the caller keeps them alive until this returns, and the graph
    and its memory pool are freed when it does (after a device sync).  A
    capture that fails raises.  `replay` False, or a carry on the CPU, runs
    the n - 1 iterations eagerly.  `stats`, when a Counter, gets added to:
    "lm_captures", "lm_capture_s" (host seconds capturing), "lm_replays" and
    "lm_replay_s" (host seconds from the first replay until the device has
    run the last)."""
    stats = collections.Counter() if stats is None else stats
    if n <= 0:
        return carry
    carry = tuple(body(carry))
    if not (replay and n > 1 and carry[0].is_cuda):
        for _ in range(n - 1):
            carry = tuple(body(carry))
        return carry
    t = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for dst, src in zip(carry, body(carry), strict=True):
            dst.copy_(src)
    stats["lm_captures"] += 1
    stats["lm_capture_s"] += time.perf_counter() - t
    t = time.perf_counter()
    for _ in range(n - 1):
        graph.replay()
    torch.cuda.synchronize(carry[0].device)
    stats["lm_replays"] += n - 1
    stats["lm_replay_s"] += time.perf_counter() - t
    return carry


def _lm_counts():
    return collections.Counter(lm_captures=0, lm_capture_s=0.0, lm_replays=0, lm_replay_s=0.0)


def pose_graph_lm_step(g: PoseGraph, deltas, gauge, carry, reduce_fn=None):
    """One dense LM iteration: carry (poses [M, 3], lam, k) -> the carry
    after it.  Iteration k's Huber delta is read on the device from the GNC
    schedule `deltas` [N]; `gauge` is `_gauge_diag`'s [3M] anchor.  With
    `g`'s edges split over ranks, `reduce_fn` sums the edge-parallel costs, H
    and b over them (identity by default).  This is the body that
    `lm_iterations` captures."""
    red = reduce_fn or _identity
    poses, lam, k = carry
    hd_k = deltas.index_select(0, k).reshape(())
    # the Huber delta changes across iterations (GNC), so the acceptance
    # test recomputes the current cost under this iteration's delta
    cost = red(graph_cost(poses, g, hd_k))
    H, b = assemble_normal_equations(poses, g, hd_k)
    H = red(H) + torch.diag(gauge)
    b = red(b)
    A = H + lam * torch.diag(torch.diagonal(H) + 1e-9)
    cand = _wrap_heading(poses - cholesky_solve_pos(A, b).reshape(-1, 3))
    accept = red(graph_cost(cand, g, hd_k)) < cost
    return torch.where(accept, cand, poses), _lm_update(accept, lam), k + 1


def _optimize_pose_graph_dense(g: PoseGraph, cfg: SlamConfig, reduce_fn=None,
                               reduce_max_fn=None, replay: bool = True, stats=None):
    """Dense LM: `cfg.pg_iterations` calls of `pose_graph_lm_step` through
    `lm_iterations` (replayed from a CUDA graph on the card unless `replay`
    is False).  With `g`'s edges split over ranks (parallel/dist_posegraph.py),
    `reduce_fn` sums the edge-parallel H, b and costs over them and
    `reduce_max_fn` takes the GNC start; both default to the identity.
    `stats`, when a dict, receives `lm_iterations`' "lm_*" keys."""
    red = reduce_fn or _identity
    dev = g.poses.device
    deltas = _huber_schedule(g, cfg, reduce_max_fn)
    gauge = _gauge_diag(g.node_mask, g.poses.dtype)
    counts = _lm_counts()
    poses, _, _ = lm_iterations(
        lambda carry: pose_graph_lm_step(g, deltas, gauge, carry, reduce_fn),
        (g.poses, torch.tensor(1e-4, dtype=g.poses.dtype, device=dev),
         torch.zeros((), dtype=torch.int64, device=dev)),
        cfg.pg_iterations, replay, counts)
    if stats is not None:
        stats.update(counts)
    return poses, red(graph_cost(poses, g, cfg.pg_huber_delta))


def _cg_active(it, rz, rz0, n_cg: int):
    """The PCG's rule for going on: under `n_cg` sweeps and r.z not yet
    below 1e-10 r0.z0 or 1e-20."""
    return (it < n_cg) & (rz > 1e-10 * rz0) & (rz > 1e-20)


def cg_sweeps(afun, pinv, state, rz0, n_cg: int, count: int):
    """`count` block-Jacobi PCG sweeps from `state` = [x, r, p, r.z, sweeps
    run] -> the state after them.  Each sweep is computed on the device and
    kept only while `_cg_active` holds (a `torch.where`, no host read), so
    sweeps past the stopping rule leave the state as it was.  This is the
    body that `conjugate_gradient` captures in a CUDA graph."""
    x, rr, p, rz, it = state
    for _ in range(count):
        active = _cg_active(it, rz, rz0, n_cg)
        Ap = afun(p)
        pAp = torch.sum(p * Ap)
        ok = pAp > 1e-30
        alpha = torch.where(ok, rz / torch.where(ok, pAp, torch.ones_like(pAp)),
                            torch.zeros_like(pAp))
        rr_n = rr - alpha * Ap
        z_n = torch.einsum("mab,mb->ma", pinv, rr_n)
        rz_n = torch.sum(rr_n * z_n)
        beta = torch.where(ok, rz_n / rz, torch.zeros_like(rz))
        x = torch.where(active, x + alpha * p, x)
        rr = torch.where(active, rr_n, rr)
        p = torch.where(active, z_n + beta * p, p)
        rz = torch.where(active, rz_n, rz)
        it = it + active.to(it.dtype)
    return [x, rr, p, rz, it]


def conjugate_gradient(afun, pinv, b, n_cg: int, sweeps_per_check: int, replay: bool = True,
                       stats=None):
    """Block-Jacobi PCG for A x = -b (A applied by `afun`, the [N, 3, 3] inverse
    diagonal blocks in `pinv`), x0 = 0, up to `n_cg` sweeps, stopping when
    r.z <= 1e-10 r0.z0 or <= 1e-20 -> (x, sweeps run).

    The sweeps (`cg_sweeps`) run `sweeps_per_check` at a time between two
    host reads of the stopping rule; the iterates do not depend on that
    number.  On a CUDA device the sweeps after the first `sweeps_per_check`
    are replayed from a CUDA graph of that many sweeps: the same kernels on
    the same buffers, without the host's launch work for each of them.  This
    holds whether or not `afun` runs a collective (the sharded solvers'
    `reduce_fn`): the graph then holds its all-reduce, on the communicator
    that the eager first sweeps used.  Every rank replays the same number of
    times: the two values a check reads, r.z and the sweep count, are built
    from `b`, `pinv` and `afun`'s output, which every rank holds equal (the
    inputs replicated, the edge sums all-reduced), so every rank takes the
    same branch.  A capture that fails raises.  `replay` False runs every
    sweep eagerly.  `stats`, when a Counter, gets added to: "cg_captures"
    and "cg_capture_s" (host seconds capturing), "cg_batches" (the batches
    of `sweeps_per_check` sweeps after the first check: graph replays when
    captured) and "cg_batch_s" (their host seconds, checks included)."""
    rr = -b
    z = torch.einsum("mab,mb->ma", pinv, rr)
    rz0 = torch.sum(rr * z)

    def sweeps(state):
        return cg_sweeps(afun, pinv, state, rz0, n_cg, sweeps_per_check)

    def check(state):
        more, n = torch.stack([_cg_active(state[4], state[3], rz0, n_cg).to(torch.int64),
                               state[4]]).tolist()
        return bool(more), n

    stats = collections.Counter() if stats is None else stats
    state = sweeps([torch.zeros_like(b), rr, z, rz0,
                    torch.zeros((), dtype=torch.int64, device=b.device)])
    more, n = check(state)
    run = sweeps
    if more and replay and b.is_cuda:
        t = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for dst, src in zip(state, sweeps(state)):
                dst.copy_(src)
        stats["cg_captures"] += 1
        stats["cg_capture_s"] += time.perf_counter() - t

        def run(state):
            graph.replay()
            return state
    t = time.perf_counter()
    while more:
        state = run(state)
        stats["cg_batches"] += 1
        more, n = check(state)
    stats["cg_batch_s"] += time.perf_counter() - t
    return state[0], n


def _sweeps_per_check(cfg: SlamConfig, sweeps_per_check):
    if sweeps_per_check is not None:
        return sweeps_per_check
    return max(1, min(cfg.pg_sweeps_per_dispatch, SWEEPS_PER_CHECK))


def _optimize_pose_graph_pcg(g: PoseGraph, cfg: SlamConfig, sweeps_per_check=None,
                             stats=None, reduce_fn=None, reduce_max_fn=None,
                             replay: bool = True):
    """Matrix-free LM: each step solves (H + lam diag(H)) delta = -b by PCG
    on the gauge-projected system (node 0 and dead nodes frozen exactly, not
    by a 1e8 penalty, which float32 CG cannot survive).  Per sweep: one
    gather, two batched [E,3,3]x[E,3] products and one scatter-add.

    `reduce_fn` sums edge-parallel contributions over ranks when `g` holds
    only this rank's edges (parallel/dist_posegraph.py): only [M, 3]-sized
    vectors and [M, 3, 3] blocks cross ranks, one [M, 3] sum per sweep, and
    every value a branch reads (the CG stopping rule, the LM acceptance) is
    reduced, so all ranks take the same branches.  `reduce_max_fn` takes the
    GNC start.  Both default to the identity.  On the card the sweeps are
    replayed from a CUDA graph, with or without `reduce_fn` (its all-reduce
    captured too); `replay` False runs them eagerly.  `stats`, when a dict,
    receives "cg_sweeps" (summed over the LM iterations) and
    `conjugate_gradient`'s "cg_captures", "cg_capture_s", "cg_batches" and
    "cg_batch_s"."""
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
    counts = collections.Counter(cg_sweeps=0, cg_captures=0, cg_capture_s=0.0, cg_batches=0,
                                 cg_batch_s=0.0)
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

        delta, sweeps = conjugate_gradient(afun, pinv, b, n_cg, spc, replay, counts)
        counts["cg_sweeps"] += sweeps
        cost = red(graph_cost(poses, g, hd_k))
        cand = _wrap_heading(poses + delta)
        accept = red(graph_cost(cand, g, hd_k)) < cost
        poses = torch.where(accept, cand, poses)
        lam = _lm_update(accept, lam)
    if stats is not None:
        stats.update(counts)
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
