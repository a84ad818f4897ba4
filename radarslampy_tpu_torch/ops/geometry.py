"""SE(2) geometry and masked rigid registration on tensors.

Counterpart of `radarslampy_tpu/ops/geometry.py`.  Conventions are the same: a
pose is [x, y, theta]; its 3x3 transform maps local -> world;
`procrustes_masked(src, tgt)` returns (R, h) with R @ tgt_i + h ~= src_i.

Trig is native fp32 (`torch.sin/cos/atan2`): the JAX package's `ops/trig.py`
only works around the TPU's ~1e-4 transcendentals, which CPUs and GPUs do not
have.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from radarslampy_tpu_torch.ops.segments import per_segment


def wrap_angle(theta):
    """Wrap angle(s) to [-pi, pi)  (same floor-mod form as the JAX package)."""
    return torch.remainder(theta + math.pi, 2.0 * math.pi) - math.pi


def rotation_matrix(theta):
    """2x2 rotation matrix; batched over leading dims."""
    s, c = torch.sin(theta), torch.cos(theta)
    return torch.stack(
        [torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2
    )


def pose_to_transform(pose):
    """[..., 3] pose -> [..., 3, 3] homogeneous transform."""
    x, y, th = pose[..., 0], pose[..., 1], pose[..., 2]
    s, c = torch.sin(th), torch.cos(th)
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    rows = [
        torch.stack([c, -s, x], dim=-1),
        torch.stack([s, c, y], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def transform_to_pose(T):
    """[..., 3, 3] transform -> [..., 3] pose."""
    return torch.stack(
        [T[..., 0, 2], T[..., 1, 2], torch.atan2(T[..., 1, 0], T[..., 0, 0])],
        dim=-1,
    )


def invert_transform(T):
    """Closed-form SE(2) inverse, batched."""
    R = T[..., :2, :2]
    t = T[..., :2, 2:]
    Rt = R.transpose(-1, -2)
    ti = -Rt @ t
    top = torch.cat([Rt, ti], dim=-1)
    bottom = torch.zeros(T.shape[:-2] + (1, 3), dtype=T.dtype, device=T.device)
    bottom[..., 2] = 1.0
    return torch.cat([top, bottom], dim=-2)


def se2_exp(xi):
    """Exponential map R^3 -> SE(2) of a twist [vx, vy, omega]."""
    vx, vy, w = xi[..., 0], xi[..., 1], xi[..., 2]
    small = torch.abs(w) < 1e-5
    ws = torch.where(small, torch.ones_like(w), w)  # safe denominator only
    sw, cw = torch.sin(ws), torch.cos(ws)
    a = torch.where(small, 1.0 - w**2 / 6.0, sw / ws)              # sin(w)/w
    b = torch.where(small, w / 2.0 - w**3 / 24.0, (1.0 - cw) / ws)  # (1-cos(w))/w
    x = a * vx - b * vy
    y = b * vx + a * vy
    return pose_to_transform(torch.stack([x, y, w], dim=-1))


def se2_log(T):
    """Logarithm map SE(2) -> R^3 twist [vx, vy, omega]."""
    pose = transform_to_pose(T)
    x, y, w = pose[..., 0], pose[..., 1], pose[..., 2]
    small = torch.abs(w) < 1e-5
    ws = torch.where(small, torch.ones_like(w), w)
    half_safe = ws / 2.0
    # a = (w/2) * cot(w/2); series 1 - w^2/12 for small w
    a = torch.where(small, 1.0 - w**2 / 12.0,
                    half_safe * torch.cos(half_safe) / torch.sin(half_safe))
    half = w / 2.0
    vx = a * x + half * y
    vy = -half * x + a * y
    return torch.stack([vx, vy, w], dim=-1)


def transform_points(T, pts):
    """Apply a [3,3] SE(2) transform to [..., 2] points."""
    return pts @ T[:2, :2].T + T[:2, 2]


@per_segment("procrustes_masked",
             lambda src, tgt, weights: (src.new_empty((2, 2)), src.new_empty(2),
                                        torch.empty((), dtype=torch.bool, device=src.device)))
def procrustes_masked(src: torch.Tensor, tgt: torch.Tensor,
                      weights: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Weighted closed-form 2-D rigid registration.  An op of
    `ops/segments.py`: under vmap each segment is fitted on its own.

    Minimises sum_i w_i || R tgt_i + h - src_i ||^2 over (R, h); the optimal
    angle is atan2(sum w (a x b), sum w (a . b)) of the centred sets.

    Returns (R [2,2], h [2], ok) with ok False when fewer than 2 effective
    points were available (then R = I, h = 0).
    """
    w = weights.to(src.dtype)
    wsum = torch.sum(w)
    ok = wsum > 1.5
    safe = torch.clamp(wsum, min=1e-12)
    mu_src = torch.sum(src * w[:, None], dim=0) / safe
    mu_tgt = torch.sum(tgt * w[:, None], dim=0) / safe
    a = src - mu_src
    b = tgt - mu_tgt
    dot = torch.sum(w * (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]))
    cross = torch.sum(w * (a[:, 1] * b[:, 0] - a[:, 0] * b[:, 1]))
    R = rotation_matrix(torch.atan2(cross, dot))
    h = mu_src - R @ mu_tgt
    R = torch.where(ok, R, torch.eye(2, dtype=src.dtype, device=src.device))
    h = torch.where(ok, h, torch.zeros_like(h))
    return R, h, ok


def rigid_transform_pose(src, tgt, weights):
    """As `procrustes_masked`, but returns the [dx, dy, dtheta] pose vector
    and `ok`."""
    R, h, ok = procrustes_masked(src, tgt, weights)
    return torch.stack([h[0], h[1], torch.atan2(R[1, 0], R[0, 0])]), ok
