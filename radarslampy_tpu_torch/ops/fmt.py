"""Fourier-Mellin rotation (and log-polar scale) by FFT phase correlation.

Counterpart of `radarslampy_tpu/ops/fmt.py`, on `torch.fft` where the JAX
package uses `jnp.fft`.  A rotation of the scene is a pure row shift of the
polar scan, so the polar (optionally log-range resampled) scans are
phase-correlated directly, with no Cartesian round trip.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.ops.grid import LogPolarMap, polar_to_logpolar


def _hanning_2d(shape, dtype, device):
    def win(n):
        i = torch.arange(n, dtype=dtype, device=device)
        return 0.5 - 0.5 * torch.cos(2 * math.pi * i / (n - 1))

    return win(shape[0])[:, None] * win(shape[1])[None, :]


def _parabolic(cm, c0, cp):
    denom = cm - 2 * c0 + cp
    ok = torch.abs(denom) > 1e-12
    return torch.where(ok, 0.5 * (cm - cp) / torch.where(ok, denom, torch.ones_like(denom)),
                       torch.zeros_like(denom))


def phase_correlate(a, b):
    """Sub-pixel 2-D phase correlation shift of b relative to a.

    Returns (dy, dx, peak_response): the shift that aligns b to a, refined by
    a parabola through the peak and its circular neighbours.  Of several
    equal peaks the first in flat (row-major) order wins.
    """
    H, W = a.shape
    win = _hanning_2d(a.shape, a.dtype, a.device)
    fa = torch.fft.rfft2(a * win)
    fb = torch.fft.rfft2(b * win)
    cross = fa * torch.conj(fb)
    cross = cross / torch.clamp(torch.abs(cross), min=1e-12)
    corr = torch.fft.irfft2(cross, s=(H, W))

    idx = torch.argmax(corr.reshape(-1))
    py, px = idx // W, idx % W
    ym, yp = (py - 1) % H, (py + 1) % H
    xm, xp = (px - 1) % W, (px + 1) % W
    c0 = corr[py, px]
    dy_sub = _parabolic(corr[ym, px], c0, corr[yp, px])
    dx_sub = _parabolic(corr[py, xm], c0, corr[py, xp])

    dy = torch.where(py > H // 2, py - H, py).to(a.dtype) + dy_sub
    dx = torch.where(px > W // 2, px - W, px).to(a.dtype) + dx_sub
    return dy, dx, c0


class FmtResult(NamedTuple):
    rot_rad: torch.Tensor   # rotation of curr relative to prev
    scale: torch.Tensor     # log-range scale factor (1 without a grid)
    response: torch.Tensor  # correlation peak height (confidence)


def estimate_rotation_fmt(prev_polar, curr_polar, cfg: SlamConfig,
                          grid: LogPolarMap | None = None) -> FmtResult:
    """Rotation (and scale) between two polar scans [A, W].

    A scene rotation by dphi shifts polar rows by dphi / (2*pi) * A, reported
    as rot = -dy * 2*pi / A.  With `grid` both scans are first resampled to
    log-polar range spacing (`polar_to_logpolar`), where a scale change s
    shifts columns by log(s) / log(log_base), reported as
    scale = log_base ** (-dx * fmt_downsample).  Without `grid` the scans
    keep linear range spacing and scale is 1.  Range is subsampled by
    `cfg.fmt_downsample` to cut the FFT's size.
    """
    A = prev_polar.shape[0]
    ds = cfg.fmt_downsample
    if grid is not None:
        a = polar_to_logpolar(prev_polar, grid, cfg)[:, ::ds]
        b = polar_to_logpolar(curr_polar, grid, cfg)[:, ::ds]
    else:
        a = prev_polar[:, ::ds]
        b = curr_polar[:, ::ds]
    dy, dx, resp = phase_correlate(a.contiguous(), b.contiguous())
    rot = -dy * 2.0 * math.pi / A
    if grid is not None:
        scale = torch.tensor(grid.log_base, dtype=a.dtype, device=a.device) ** (-dx * ds)
    else:
        scale = torch.ones_like(dx)
    return FmtResult(rot_rad=rot, scale=scale, response=resp)
