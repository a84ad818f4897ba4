"""Joint velocity/pose motion-distortion solver: fixed-budget Levenberg-Marquardt.

Counterpart of `radarslampy_tpu/ops/motion.py` with the same residual model:
  dt_i   = period * atan2(-y_i, -x_i) / (2*pi)
  undist = R(omega*dt_i) p_i + v_xy*dt_i
  e_p    = sign(e) log(e^2 / 2 + 1),  e = T_wj^-1 p_w - undist
  e_v    = n_valid * (v - relative_velocity(pose_prev, pose) )
scaled by 1/sqrt(sigma).  The JAX package takes J from `jax.jacfwd`; here J
is written out analytically (`_jacobian`), since on the card a
`torch.func.jacfwd` costs most of a frame in launch and tracing overhead.
`tests/test_torch_motion.py` holds it against both `torch.func.jacfwd` and
`jax.jacfwd`.  LM runs `mds_iterations` steps with the same accept/damping
schedule and a Cholesky solve of the 6x6 system.

The 6x6 normal equations (`lm_delta`) and the cost (`sum_squares`) are ops
of `ops/segments.py`: under vmap (the batched step's D segments) each
segment's system is solved and its cost summed on its own, with the calls of
the single step, so each segment keeps its own step's bits (a batched
product, solve or sum takes other kernels; MAGMA's batched solve cannot be
captured in a CUDA graph).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.ops import geometry as geo
from radarslampy_tpu_torch.ops.segments import per_segment
from radarslampy_tpu_torch.ops.tables import device_table


def compute_time_deltas(points, period: float):
    """Per-point scan-time offset from its scan angle."""
    angles = torch.atan2(-points[..., 1], -points[..., 0])
    return period * angles / (2.0 * math.pi)


def undistort(v, points, period: float, times=None):
    """Constant-velocity correction of [K, 2] points: R(omega dt) p + v_xy dt."""
    if times is None:
        times = compute_time_deltas(points, period)
    disp = v[None, :] * times[:, None]  # [K, 3]
    th = disp[:, 2]
    s, c = torch.sin(th), torch.cos(th)
    x = c * points[:, 0] - s * points[:, 1] + disp[:, 0]
    y = s * points[:, 0] + c * points[:, 1] + disp[:, 1]
    return torch.stack([x, y], dim=-1)


class MotionSolution(NamedTuple):
    pose: torch.Tensor      # [3] optimised world pose [x, y, theta]
    velocity: torch.Tensor  # [3] optimised body velocity [vx, vy, omega]
    cost: torch.Tensor      # final weighted squared-residual cost
    ok: torch.Tensor        # bool: enough inliers to solve


def relative_velocity(pose_prev, pose_curr, period: float):
    """Body-frame velocity implied by two consecutive poses (difference form:
    the small pose difference is rotated, the heading rate is a wrapped
    difference)."""
    dp = pose_curr[:2] - pose_prev[:2]
    s0, c0 = torch.sin(pose_prev[2]), torch.cos(pose_prev[2])
    vx = c0 * dp[0] + s0 * dp[1]
    vy = -s0 * dp[0] + c0 * dp[1]
    # a 1-element slice, not a 0-d tensor: torch.func.jacfwd (which the tests
    # hold `_jacobian` against) promotes the tangent of a 0-d remainder with a
    # python-float divisor to f64
    w = geo.wrap_angle(pose_curr[2:] - pose_prev[2:])
    return torch.cat([torch.stack([vx, vy]), w]) / period


def _residuals(params, pose_prev, p_w, p_jt, times, mask, n_valid, info_p, info_v,
               period):
    v = params[:3]
    pose = params[3:]
    und = undistort(v, p_jt, period, times)
    s, c = torch.sin(pose[2]), torch.cos(pose[2])
    d = p_w - pose[:2]
    expected = torch.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1]],
                           dim=-1)
    e = expected - und
    e_p = torch.log(e * e / 2.0 + 1.0) * torch.sign(e)
    e_p = torch.where(mask[:, None], e_p * info_p[None, :], torch.zeros_like(e_p))
    dv = v - relative_velocity(pose_prev, pose, period)
    dv = torch.cat([dv[:2], geo.wrap_angle(dv[2:])])
    e_v = dv * n_valid * info_v
    return torch.cat([e_p.reshape(-1), e_v])


def _jacobian(params, pose_prev, p_w, p_jt, times, mask, n_valid, info_p, info_v,
              period):
    """d `_residuals` / d params, [2K + 3, 6], params = [vx, vy, w, x, y, theta]."""
    v, pose = params[:3], params[3:]
    qx, qy = p_jt[:, 0], p_jt[:, 1]
    sw, cw = torch.sin(v[2] * times), torch.cos(v[2] * times)
    und_x = cw * qx - sw * qy + v[0] * times
    und_y = sw * qx + cw * qy + v[1] * times
    s, c = torch.sin(pose[2]), torch.cos(pose[2])
    d = p_w - pose[:2]
    exp_x = c * d[:, 0] + s * d[:, 1]
    exp_y = -s * d[:, 0] + c * d[:, 1]
    e = torch.stack([exp_x - und_x, exp_y - und_y], dim=-1)
    # d/de of sign(e) log(e^2/2 + 1), times the info weight; 0 where masked
    g = torch.sign(e) * e / (e * e / 2.0 + 1.0) * info_p[None, :]
    g = torch.where(mask[:, None], g, torch.zeros_like(g))
    zero, one = torch.zeros_like(times), torch.ones_like(times)
    # rows d e_x / d params and d e_y / d params, [K, 6] each
    de_x = torch.stack([-times, zero, times * (sw * qx + cw * qy), -c * one, -s * one, exp_y],
                       dim=-1)
    de_y = torch.stack([zero, -times, -times * (cw * qx - sw * qy), s * one, -c * one, -exp_x],
                       dim=-1)
    j_p = torch.stack([g[:, :1] * de_x, g[:, 1:] * de_y], dim=1).reshape(-1, 6)
    # velocity prior: e_v = (v - relative_velocity(pose_prev, pose)) n_valid info_v
    a = n_valid * info_v
    s0, c0 = torch.sin(pose_prev[2]), torch.cos(pose_prev[2])
    z = torch.zeros_like(a[0])
    j_v = torch.stack([
        torch.stack([a[0], z, z, -a[0] * c0 / period, -a[0] * s0 / period, z]),
        torch.stack([z, a[1], z, a[1] * s0 / period, -a[1] * c0 / period, z]),
        torch.stack([z, z, a[2], z, z, -a[2] / period]),
    ])
    return torch.cat([j_p, j_v])


@per_segment("lm_delta", lambda J, r, lam: J.new_empty(J.shape[-1:]))
def lm_delta(J: torch.Tensor, r: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """The LM step of one system, J [N, 6], r [N], damping lam []:
    -(JtJ + lam diag(JtJ + 1e-12))^-1 Jt r by a Cholesky solve -> [6]."""
    J, r = J.contiguous(), r.contiguous()
    JtJ = J.T @ J
    Jtr = J.T @ r
    A = JtJ + lam * torch.diag(torch.diagonal(JtJ) + 1e-12)
    L, _ = torch.linalg.cholesky_ex(A)
    return -torch.cholesky_solve(Jtr[:, None], L)[:, 0]


@per_segment("sum_squares", lambda r: r.new_empty(()))
def sum_squares(r: torch.Tensor) -> torch.Tensor:
    """sum(r * r) of one segment's residuals."""
    return torch.sum(r * r)


@device_table(maxsize=32)
def _information(sigma, dtype, device):
    """1 / sqrt(sigma) (a number or a tuple), made once per dtype and device:
    a copy from the host in every step could not be captured in a CUDA graph."""
    return 1.0 / torch.sqrt(torch.tensor(sigma, dtype=dtype, device=device))


def solve_motion(pose_prev, p_w, p_jt, pose_init, mask, cfg: SlamConfig) -> MotionSolution:
    """Fixed-budget LM over [v; x, y, theta].

    pose_prev [3], p_w [K, 2] world points, p_jt [K, 2] observed (distorted)
    sensor-centred metric points, pose_init [3], mask [K].
    """
    period = cfg.scan_period_s
    dtype, dev = p_w.dtype, p_w.device
    times = compute_time_deltas(p_jt, period)
    n_valid = torch.sum(mask.to(dtype))
    ok = n_valid >= 3.0
    info_p = _information(cfg.mds_sigma_p, dtype, dev)
    info_v = _information(cfg.mds_sigma_v, dtype, dev)

    fixed = (pose_prev, p_w, p_jt, times, mask, n_valid, info_p, info_v, period)

    def cost_of(p):
        return sum_squares(_residuals(p, *fixed))

    p = torch.cat([relative_velocity(pose_prev, pose_init, period), pose_init])
    p0 = p
    lam = torch.full((), cfg.mds_init_lambda, dtype=dtype, device=dev)
    cost = cost_of(p)
    for _ in range(cfg.mds_iterations):
        r = _residuals(p, *fixed)
        J = _jacobian(p, *fixed)  # [2K + 3, 6]
        p_new = p + lm_delta(J, r, lam)
        new_cost = cost_of(p_new)
        accept = new_cost < cost
        p = torch.where(accept, p_new, p)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, torch.clamp(lam / 3.0, min=1e-9),
                          torch.clamp(lam * 10.0, max=1e6))

    p = torch.where(ok, p, p0)
    pose = torch.cat([p[3:5], geo.wrap_angle(p[5:6])])
    return MotionSolution(pose=pose, velocity=p[:3], cost=cost, ok=ok)
