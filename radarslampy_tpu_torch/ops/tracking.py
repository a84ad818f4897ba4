"""Pyramidal Lucas-Kanade feature tracking over a fixed feature budget.

Counterpart of `radarslampy_tpu/ops/tracking.py`: all `k_max` features advance
together through a binomial image pyramid; at each level a fixed number of
Gauss-Newton iterations updates the flow with a closed-form 2x2 solve, and
features that move less than `klt_eps` are frozen.  Plain PyTorch in this
slice (a candidate for a hand-written kernel later).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.ops.tables import device_table


@device_table(maxsize=16)
def _binomial_taps(dtype, device):
    """[1, 4, 6, 4, 1]/16, made once per dtype and device: a copy from the
    host in every step could not be captured in a CUDA graph."""
    return torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], dtype=dtype, device=device) / 16.0


def _blur_small(img):
    """5-tap binomial blur [1, 4, 6, 4, 1]/16, separable, zero padding."""
    k = _binomial_taps(img.dtype, img.device)
    x = F.conv2d(img[None, None], k.view(1, 1, 1, 5), padding=(0, 2))
    x = F.conv2d(x, k.view(1, 1, 5, 1), padding=(2, 0))
    return x[0, 0]


def build_pyramid(img, levels: int):
    """List of images, level 0 = full resolution, each next 2x downsampled."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(_blur_small(pyr[-1])[::2, ::2])
    return pyr


def _gather_patches(img, centers, window: int):
    """Bilinear [window x window] patches around [K, 2] (x, y) centers -> [K, P].

    As in the JAX package: the sample grid is axis-aligned, so each patch is a
    (window + 1)^2 block of the edge-padded image blended with the fractional
    weights.  Edge padding is done by clamping the gather indices.
    """
    w = window
    H, W = img.shape
    pad = w + 2
    r = w // 2
    x0f = centers[:, 0] - r + pad
    y0f = centers[:, 1] - r + pad
    x0 = torch.floor(x0f)
    y0 = torch.floor(y0f)
    fx = (x0f - x0)[:, None, None]
    fy = (y0f - y0)[:, None, None]
    # block origin in the padded image, as lax.dynamic_slice clamps it
    xi = torch.clamp(x0.to(torch.int64), 0, W + 2 * pad - w - 1)
    yi = torch.clamp(y0.to(torch.int64), 0, H + 2 * pad - w - 1)
    ar = torch.arange(w + 1, device=img.device)
    rows = torch.clamp(yi[:, None] + ar[None, :] - pad, 0, H - 1)  # [K, w+1]
    cols = torch.clamp(xi[:, None] + ar[None, :] - pad, 0, W - 1)
    big = img.reshape(-1)[rows[:, :, None] * W + cols[:, None, :]]  # [K, w+1, w+1]
    p00 = big[:, :w, :w]
    p01 = big[:, :w, 1:]
    p10 = big[:, 1:, :w]
    p11 = big[:, 1:, 1:]
    out = (p00 * (1 - fy) * (1 - fx) + p01 * (1 - fy) * fx
           + p10 * fy * (1 - fx) + p11 * fy * fx)
    return out.reshape(centers.shape[0], w * w)


class TrackResult(NamedTuple):
    coords: torch.Tensor  # [K, 2] tracked positions in the current frame
    status: torch.Tensor  # [K] bool: input mask, in bounds, error below gate
    error: torch.Tensor   # [K] mean abs patch residual (0..255 scale)


def track_klt(prev_img, curr_img, coords, mask, cfg: SlamConfig,
              init_flow=None) -> TrackResult:
    """Track [K, 2] (x, y) feature coords from prev_img to curr_img.

    `init_flow` [K, 2] is an optional initial displacement guess.
    """
    Wn = cfg.klt_window
    L = cfg.klt_pyramid_levels
    H = prev_img.shape[0]
    P = Wn * Wn
    pyr_prev = build_pyramid(prev_img, L)
    pyr_curr = build_pyramid(curr_img, L)
    eps2 = cfg.klt_eps**2

    flow = torch.zeros_like(coords) if init_flow is None else init_flow
    for level in range(L - 1, -1, -1):
        scale = 2.0**level
        base = coords / scale
        # template and its central-difference gradients from a 1-px apron
        big = _gather_patches(pyr_prev[level], base, Wn + 2).reshape(-1, Wn + 2, Wn + 2)
        tmpl = big[:, 1:-1, 1:-1].reshape(-1, P)
        ix = (0.5 * (big[:, 1:-1, 2:] - big[:, 1:-1, :-2])).reshape(-1, P)
        iy = (0.5 * (big[:, 2:, 1:-1] - big[:, :-2, 1:-1])).reshape(-1, P)
        gxx = torch.sum(ix * ix, dim=1)
        gxy = torch.sum(ix * iy, dim=1)
        gyy = torch.sum(iy * iy, dim=1)
        det = gxx * gyy - gxy * gxy
        trackable = det > 1e-9
        det_safe = torch.where(trackable, det, torch.ones_like(det))
        inv00 = gyy / det_safe
        inv01 = -gxy / det_safe
        inv11 = gxx / det_safe

        d = flow / scale
        c_img = pyr_curr[level]
        for _ in range(cfg.klt_iters):
            cur = _gather_patches(c_img, base + d, Wn)
            res = tmpl - cur
            bx = torch.sum(ix * res, dim=1)
            by = torch.sum(iy * res, dim=1)
            step = torch.stack([inv00 * bx + inv01 * by, inv01 * bx + inv11 * by], dim=-1)
            step = torch.where(trackable[:, None], step, torch.zeros_like(step))
            moving = torch.sum(step * step, dim=-1) > eps2
            d = d + torch.where(moving[:, None], step, torch.zeros_like(step))
        flow = d * scale

    new_coords = coords + flow
    tmpl0 = _gather_patches(pyr_prev[0], coords, Wn)
    cur0 = _gather_patches(pyr_curr[0], new_coords, Wn)
    err = torch.mean(torch.abs(tmpl0 - cur0), dim=1) * 255.0

    r = Wn // 2 + 1
    inb = ((new_coords[:, 0] >= r) & (new_coords[:, 0] < H - r)
           & (new_coords[:, 1] >= r) & (new_coords[:, 1] < H - r))
    status = mask & inb & (err < cfg.klt_err_threshold)
    return TrackResult(coords=new_coords, status=status, error=err)
