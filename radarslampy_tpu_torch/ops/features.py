"""Determinant-of-Hessian blob detection, ANMS and feature merging on tensors.

Counterpart of `radarslampy_tpu/ops/features.py`.  The DoH scale space is the
port's CUDA kernel (`ops/cuda/doh_cuda.py`); the rest is plain PyTorch with
the JAX package's fixed shapes and masks.

Ordering semantics are kept exact where the step depends on them:
`lax.top_k` puts the lower index first among equal values, which `top_k_stable`
reproduces with a stable descending sort; `argsort` is stable on both sides.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.ops.cuda import doh_cuda
from radarslampy_tpu_torch.ops.cuda.doh_cuda import DohFilters
from radarslampy_tpu_torch.ops.tables import device_table


class Candidates(NamedTuple):
    xy: torch.Tensor        # [N, 2] float (x, y) pixel coords
    response: torch.Tensor  # [N] float DoH response
    sigma: torch.Tensor     # [N] float blob scale
    mask: torch.Tensor      # [N] bool validity


def top_k_stable(x, k: int):
    """`lax.top_k` over the last axis: k largest, lower index first on ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@device_table(maxsize=64)
def _gaussian_taps(sigma: float, dtype, device):
    return torch.as_tensor(doh_cuda.gaussian_taps(sigma), dtype=dtype, device=device)


@device_table(maxsize=16)
def _sigma_table(sigmas: tuple, device):
    """`cfg.doh_sigmas` as a float32 tensor, made once per device: a copy
    from the host in every step could not be captured in a CUDA graph."""
    return torch.tensor(sigmas, dtype=torch.float32, device=device)


def gaussian_blur(img, sigma: float):
    """Separable Gaussian blur of a [H, W] image, zero padding (the JAX
    package's `gaussian_blur`); sigma < 0.3 returns the image."""
    if sigma < 0.3:
        return img
    k = _gaussian_taps(float(sigma), img.dtype, img.device)
    r = k.shape[0] // 2
    x = F.conv2d(img[None, None], k.view(1, 1, 1, -1), padding=(0, r))
    return F.conv2d(x, k.view(1, 1, -1, 1), padding=(r, 0))[0, 0]


def doh_response(img, cfg: SlamConfig, filters: DohFilters = None):
    """[n_sigma, H, W] scale-normalised DoH responses at `cfg.doh_sigmas`
    (`doh_cuda.doh_response`: the CUDA kernel for a CUDA tensor, its plain
    twin for a CPU tensor).  `filters` default to `cfg`'s, built on the
    image's device."""
    if filters is None:
        filters = doh_cuda.build_doh_filters(cfg.doh_sigmas, img.device)
    return doh_cuda.doh_response(img, filters)


def detect_blobs_from_response(resp, cfg: SlamConfig) -> Candidates:
    """3x3x3 local maxima above threshold, top `n_candidates` of them."""
    ns, H, W = resp.shape
    spatial_max = F.max_pool2d(resp[None], 3, stride=1, padding=1)[0]
    scale_max = spatial_max.clone()
    if ns > 1:
        scale_max[1:] = torch.maximum(scale_max[1:], spatial_max[:-1])
        scale_max[:-1] = torch.maximum(scale_max[:-1], spatial_max[1:])
    is_peak = (resp >= scale_max) & (resp > cfg.doh_threshold)
    neg_inf = torch.full_like(resp, float("-inf"))
    masked = torch.where(is_peak, resp, neg_inf)

    vals, idx = top_k_stable(masked.reshape(-1), cfg.n_candidates)
    sidx = idx // (H * W)
    rem = idx % (H * W)
    yy = (rem // W).to(torch.float32)
    xx = (rem % W).to(torch.float32)
    sig = _sigma_table(tuple(cfg.doh_sigmas), resp.device)[sidx]
    ok = torch.isfinite(vals)
    return Candidates(
        xy=torch.stack([xx, yy], dim=-1),
        response=torch.where(ok, vals, torch.zeros_like(vals)),
        sigma=sig,
        mask=ok,
    )


def detect_blobs(img, cfg: SlamConfig, filters: DohFilters) -> Candidates:
    """Fixed-budget DoH blob candidates (the DoH is the CUDA kernel on a CUDA
    tensor, its plain twin on a CPU tensor)."""
    return detect_blobs_from_response(doh_cuda.doh_response(img, filters), cfg)


def anms_cell_cover(cands: Candidates, cfg: SlamConfig, image_size: int) -> Candidates:
    """Strongest-first, one winner per grid cell, at most `anms_top_k` kept.

    The JAX package finds "first valid candidate in its cell" with a one-hot
    prefix sum; here it is the minimum rank per cell (scatter_reduce amin),
    which selects the same candidates.
    """
    N = cands.xy.shape[0]
    G = cfg.anms_grid
    cell_sz = image_size / G
    cx = torch.clamp((cands.xy[:, 0] / cell_sz).to(torch.int64), 0, G - 1)
    cy = torch.clamp((cands.xy[:, 1] / cell_sz).to(torch.int64), 0, G - 1)
    cell = cy * G + cx

    key = torch.where(cands.mask, cands.response,
                      torch.full_like(cands.response, float("-inf")))
    order = torch.argsort(-key, stable=True)
    cell_o = cell[order]
    mask_o = cands.mask[order]

    rank = torch.arange(N, device=cell.device)
    first = torch.full((G * G,), N, dtype=torch.int64, device=cell.device)
    first = first.scatter_reduce(0, cell_o, torch.where(mask_o, rank, N),
                                 reduce="amin", include_self=True)
    keep = mask_o & (first[cell_o] == rank)
    kept_rank = torch.cumsum(keep.to(torch.int32), 0) - 1
    keep = keep & (kept_rank < cfg.anms_top_k)
    return Candidates(
        xy=cands.xy[order],
        response=cands.response[order],
        sigma=cands.sigma[order],
        mask=keep,
    )


def get_features(img, cfg: SlamConfig, filters: DohFilters) -> Candidates:
    """DoH + ANMS (`radarslampy_tpu.ops.features.get_features`)."""
    return anms_cell_cover(detect_blobs(img, cfg, filters), cfg, img.shape[-1])


def merge_features(coords, mask, new_cands: Candidates, min_dist_px: float = 4.0):
    """Fill free slots of a tracked feature set with fresh detections.

    New candidates further than `min_dist_px` from every live feature go, in
    their (response) order, into the free slots in slot order.  Shapes never
    change.  Returns (coords', mask').
    """
    K = coords.shape[0]
    d2 = torch.sum((new_cands.xy[:, None, :] - coords[None, :, :]) ** 2, dim=-1)
    d2 = torch.where(mask[None, :], d2, torch.full_like(d2, float("inf")))
    far_enough = torch.amin(d2, dim=1) > min_dist_px**2
    cand_keep = new_cands.mask & far_enough

    # kept candidates first, free slots first (stable; bool keys as int8)
    cand_order = torch.argsort((~cand_keep).to(torch.int8), stable=True)
    cand_xy = new_cands.xy[cand_order]
    cand_ok = cand_keep[cand_order]
    n_keep = torch.sum(cand_keep.to(torch.int32))
    slot_order = torch.argsort(mask.to(torch.int8), stable=True)
    n_free = torch.sum((~mask).to(torch.int32))

    n_fill = torch.clamp(torch.minimum(n_keep, n_free), max=K)
    ar = torch.arange(K, device=coords.device)
    take = torch.clamp(ar, max=cand_xy.shape[0] - 1)
    fill_ok = cand_ok[take] & (ar < n_fill)

    # the outputs are made like the values written into them, so that under
    # vmap (batched candidates, unbatched empty slots) they are batched too
    tgt = torch.where(fill_ok[:, None], cand_xy[take], coords[slot_order])
    out_coords = torch.empty_like(tgt)
    out_coords[slot_order] = tgt
    tgt_mask = mask[slot_order] | fill_ok
    out_mask = torch.empty_like(tgt_mask)
    out_mask[slot_order] = tgt_mask
    return out_coords, out_mask
