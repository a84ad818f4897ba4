"""The port's dense LM loops as they stood before their iteration became a
function that a CUDA graph captures: a Python loop over the GNC schedule (pose
graph) or over `pg_iterations` (BA), each iteration eager.  The tests hold the
refactored solvers to these bit for bit.  No JAX here, so the rank processes
of `tests/torch_dist_ranks.py` use it too.
"""

import torch

from radarslampy_tpu_torch.models.ba import (_accept, back_substitute_landmarks, ba_cost,
                                             build_view_table, schur_reduced_system)
from radarslampy_tpu_torch.models.posegraph import (_huber_schedule, _identity, _lm_update,
                                                    _wrap_heading, assemble_normal_equations,
                                                    cholesky_solve_pos, graph_cost)


def _gauge_and_mask(H, b, node_mask):
    """H with a 1e8 anchor on the diagonal of node 0 and of dead nodes."""
    fix = torch.where(node_mask, 0.0, 1e8).to(H.dtype)
    fix[0] += 1e8
    return H + torch.diag(torch.repeat_interleave(fix, 3)), b


def pose_graph_dense(g, cfg, reduce_fn=None, reduce_max_fn=None):
    red = reduce_fn or _identity
    poses = g.poses
    lam = torch.tensor(1e-4, dtype=poses.dtype, device=poses.device)
    for hd_k in _huber_schedule(g, cfg, reduce_max_fn):
        cost = red(graph_cost(poses, g, hd_k))
        H, b = assemble_normal_equations(poses, g, hd_k)
        H, b = _gauge_and_mask(red(H), red(b), g.node_mask)
        A = H + lam * torch.diag(torch.diagonal(H) + 1e-9)
        cand = _wrap_heading(poses - cholesky_solve_pos(A, b).reshape(-1, 3))
        accept = red(graph_cost(cand, g, hd_k)) < cost
        poses = torch.where(accept, cand, poses)
        lam = _lm_update(accept, lam)
    return poses, red(graph_cost(poses, g, cfg.pg_huber_delta))


def _solve_reduced(H, bs, lam):
    anchor = torch.zeros(H.shape[0], dtype=H.dtype, device=H.device)
    anchor[:3] = 1e8
    A = H + torch.diag(anchor + lam * (torch.diagonal(H) + 1e-9))
    return -cholesky_solve_pos(A, bs.reshape(-1)).reshape(-1, 3)


def ba_dense(p, cfg, max_views_per_landmark=8, reduce_fn=None):
    red = reduce_fn or _identity
    hd = cfg.pg_huber_delta
    view_table = build_view_table(p, max_views_per_landmark)
    poses, landmarks = p.poses, p.landmarks
    lam = torch.tensor(1e-3, dtype=poses.dtype, device=poses.device)
    cost = red(ba_cost(poses, landmarks, p, hd))
    for _ in range(cfg.pg_iterations):
        H, bs, Hinv, bl, U = schur_reduced_system(poses, landmarks, p, view_table, hd, lam)
        delta_p = _solve_reduced(red(H), red(bs), lam)
        delta_l = back_substitute_landmarks(Hinv, bl, U, delta_p, p)
        poses, landmarks, lam, cost = _accept(poses, landmarks, lam, cost, delta_p,
                                              delta_l, p, hd, red)
    return poses, landmarks, cost
