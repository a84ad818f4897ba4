"""Polar -> Cartesian and polar -> log-polar radar resampling as gathers.

Counterpart of `radarslampy_tpu/ops/grid.py` (the naive warp and its float32
maps, the log-polar resample that feeds FMT, and `bilinear_sample_image`) and
of `radarslampy_tpu/ops/routed_warp.py` (the warp the SLAM step uses).

The JAX step warps through `routed_polar_to_cartesian`, whose octant routing
exists only to put the TPU's gathers on their fast path; it computes the same
4-tap bilinear sample as the naive warp, from sample points built in float64.
`build_warp_maps` builds exactly those float64-derived sample points and
`warp_polar_to_cartesian` does the plain 4-tap gather with the routed warp's
arithmetic, so the port's step sees the same Cartesian image as the JAX step.

Geometry: Cartesian pixel (row v, col u) relative to the image centre maps to
range r_px = hypot(du, dv) * bins_per_cart_px and azimuth atan2(dv, du) wrapped
to [0, 2*pi), sampled at polar row phi / (2*pi) * num_azimuths.  Pixels beyond
the clipped max range are 0.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from radarslampy_tpu_torch import resolve_device
from radarslampy_tpu_torch.config import SlamConfig


class GridMaps(NamedTuple):
    """Float32 sample-coordinate maps of the naive warp (grid.py)."""

    cart_az: torch.Tensor       # [S, S] fractional polar row per cart pixel
    cart_rng: torch.Tensor      # [S, S] fractional range bin per cart pixel
    cart_valid: torch.Tensor    # [S, S] bool, inside max range


class LogPolarMap(NamedTuple):
    """The log-polar resample's range map (grid.py's `logpolar_rng` and
    `log_base`), the one map FMT reads."""

    logpolar_rng: torch.Tensor  # [W] fractional range bin per log-polar column
    log_base: float             # log-polar base: column w samples bin base**w


class WarpMaps(NamedTuple):
    """Per-pixel taps of the step's warp (the routed warp's sample points).

    idx0/idx1 index the flattened [A, B] polar scan at (a0, r0) and
    ((a0 + 1) % A, r0); the range neighbour is idx + 1.  Pixels outside the
    clipped range have zero indices and fractions and valid False.
    """

    idx0: torch.Tensor   # [S, S] int64 a0 * B + r0
    idx1: torch.Tensor   # [S, S] int64 a1 * B + r0
    fa: torch.Tensor     # [S, S] float32 azimuth fraction
    fr: torch.Tensor     # [S, S] float32 range fraction
    valid: torch.Tensor  # [S, S] bool inside the clipped range
    polar_width: int     # B, the polar scan's padded width


def build_grid_maps(cfg: SlamConfig, device="cuda") -> GridMaps:
    """Float32 maps of the naive warp, built on the host (numpy) once."""
    S = cfg.cart_size
    bins = cfg.clipped_range_bins
    c = (S - 1) / 2.0
    v, u = np.mgrid[0:S, 0:S].astype(np.float32)
    du = u - c
    dv = v - c
    r_px = np.hypot(du, dv) * cfg.cart_downsample
    phi = np.arctan2(dv, du)
    phi = np.where(phi < 0, phi + 2 * np.pi, phi)
    az = phi / (2 * np.pi) * cfg.num_azimuths
    valid = r_px <= (bins - 1)
    device = resolve_device(device)
    return GridMaps(
        cart_az=torch.as_tensor(np.asarray(az, np.float32), device=device),
        cart_rng=torch.as_tensor(r_px.astype(np.float32), device=device),
        cart_valid=torch.as_tensor(valid, device=device),
    )


def build_logpolar_map(cfg: SlamConfig, device="cuda") -> LogPolarMap:
    """The log-polar range map over the clipped range, as the JAX
    `build_grid_maps` builds it: column w samples range bin base**w."""
    W = cfg.polar_width_padded
    log_base = float(cfg.clipped_range_bins - 1) ** (1.0 / (W - 1))
    lp_rng = log_base ** np.arange(W, dtype=np.float32)
    return LogPolarMap(
        logpolar_rng=torch.as_tensor(lp_rng.astype(np.float32), device=resolve_device(device)),
        log_base=log_base,
    )


def _bilinear_polar_sample(polar, az, rng, *, num_azimuths, num_bins):
    """Bilinear sample of polar[az_row, range_col]: azimuth wraps, range clamps."""
    a0 = torch.floor(az)
    r0 = torch.floor(rng)
    fa = az - a0
    fr = rng - r0
    a0i = torch.remainder(a0.to(torch.int64), num_azimuths)
    a1i = torch.remainder(a0i + 1, num_azimuths)
    r0i = torch.clamp(r0.to(torch.int64), 0, num_bins - 1)
    r1i = torch.clamp(r0i + 1, 0, num_bins - 1)

    B = polar.shape[-1]
    flat = polar.reshape(-1)

    def take(ai, ri):
        return flat[(ai * B + ri).reshape(-1)].reshape(az.shape)

    top = take(a0i, r0i) * (1 - fr) + take(a0i, r1i) * fr
    bot = take(a1i, r0i) * (1 - fr) + take(a1i, r1i) * fr
    return top * (1 - fa) + bot * fa


def polar_to_cartesian(polar, maps: GridMaps, cfg: SlamConfig):
    """Naive warp of a clipped polar scan [A, Wpad] to a Cartesian image [S, S]."""
    out = _bilinear_polar_sample(
        polar, maps.cart_az, maps.cart_rng,
        num_azimuths=cfg.num_azimuths, num_bins=cfg.clipped_range_bins,
    )
    return torch.where(maps.cart_valid, out, torch.zeros_like(out))


def polar_to_logpolar(polar, maps: LogPolarMap, cfg: SlamConfig):
    """Resample a polar scan [A, Wpad] to log-polar [A, Wpad] along range
    alone: the azimuth rows stay, columns are log-spaced range bins
    (1-D linear interpolation)."""
    rng = maps.logpolar_rng
    r0 = torch.floor(rng)
    fr = rng - r0
    bins = cfg.clipped_range_bins
    r0i = torch.clamp(r0.to(torch.int64), 0, bins - 1)
    r1i = torch.clamp(r0i + 1, 0, bins - 1)
    return polar[..., r0i] * (1 - fr) + polar[..., r1i] * fr


def bilinear_sample_image(img, xy):
    """Bilinear sample a [H, W] image at [..., 2] (x, y) pixel coordinates;
    out-of-bounds coordinates clamp to the border."""
    H, W = img.shape
    x = xy[..., 0]
    y = xy[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = torch.clamp(x0.to(torch.int64), 0, W - 1)
    x1i = torch.clamp(x0i + 1, 0, W - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, H - 1)
    y1i = torch.clamp(y0i + 1, 0, H - 1)
    flat = img.reshape(-1)

    def take(yi, xi):
        return flat[(yi * W + xi).reshape(-1)].reshape(x.shape)

    top = take(y0i, x0i) * (1 - fx) + take(y0i, x1i) * fx
    bot = take(y1i, x0i) * (1 - fx) + take(y1i, x1i) * fx
    return top * (1 - fy) + bot * fy


def build_warp_maps(cfg: SlamConfig, device="cuda") -> WarpMaps:
    """Per-pixel sample points of the step's warp, built in float64 on the
    host exactly as `radarslampy_tpu/ops/routed_warp.py::build_routed_warp_maps`
    builds them (range clamped 1e-3 below the last bin, fractions cast to f32)."""
    S = cfg.cart_size
    A = cfg.num_azimuths
    B = cfg.polar_width_padded
    bins = cfg.clipped_range_bins
    c = (S - 1) / 2.0
    v, u = np.mgrid[0:S, 0:S].astype(np.float64)
    du = u - c
    dv = v - c
    rng = np.minimum(np.hypot(du, dv) * cfg.cart_downsample, bins - 1 - 1e-3)
    phi = np.arctan2(dv, du)
    phi = np.where(phi < 0, phi + 2 * np.pi, phi)
    az = phi / (2 * np.pi) * A
    a0 = np.floor(az)
    fa = (az - a0).astype(np.float32)
    a0 = a0.astype(np.int64) % A
    r0 = np.floor(rng).astype(np.int64)
    fr = (rng - r0).astype(np.float32)
    inside = np.hypot(du, dv) * cfg.cart_downsample <= (bins - 1)
    return warp_maps_from_taps(a0, r0, fa, fr, inside, cfg, device)


def warp_maps_from_taps(a0, r0, fa, fr, inside, cfg: SlamConfig,
                        device="cuda") -> WarpMaps:
    """WarpMaps from per-pixel (a0, r0, fa, fr, inside) numpy arrays."""
    device = resolve_device(device)
    A = cfg.num_azimuths
    B = cfg.polar_width_padded
    a0 = np.where(inside, a0, 0).astype(np.int64)
    r0 = np.where(inside, r0, 0).astype(np.int64)
    a1 = (a0 + 1) % A

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    return WarpMaps(
        idx0=dev(a0 * B + r0),
        idx1=dev(a1 * B + r0),
        fa=dev(np.where(inside, fa, 0).astype(np.float32)),
        fr=dev(np.where(inside, fr, 0).astype(np.float32)),
        valid=dev(inside.astype(bool)),
        polar_width=B,
    )


def warp_polar_to_cartesian(polar, maps: WarpMaps):
    """Warp a [A, B] polar scan to the [S, S] Cartesian image of the step.

    Same arithmetic as the routed warp: a range lerp at both azimuth taps,
    then an azimuth lerp, zero outside the clipped range.  (The range tap
    r0 + 1 never leaves the clipped range, so the flat index stays in its row.)
    """
    if polar.shape[-1] != maps.polar_width:
        raise ValueError(
            f"polar width {polar.shape[-1]} != warp maps' {maps.polar_width}")
    flat = polar.reshape(-1)
    fr, fa = maps.fr, maps.fa
    t0 = (1 - fr) * flat[maps.idx0] + fr * flat[maps.idx0 + 1]
    t1 = (1 - fr) * flat[maps.idx1] + fr * flat[maps.idx1 + 1]
    val = (1 - fa) * t0 + fa * t1
    return torch.where(maps.valid, val, torch.zeros_like(val))
