"""Place recognition over keyframes: scan context and M2DP.

Counterpart of `radarslampy_tpu/models/placerecog.py`:
  * `scan_context`: a polar power scan max-pooled into rings x sectors;
  * `ring_key` / `sc_alignment` / `sc_distance`: the rotation-invariant
    retrieval key and the best circular sector shift between two descriptors;
  * `find_candidates_appearance[_block]`: ring-key prefilter over all pairs,
    then the exact all-shift distance on the best pairs;
  * `m2dp_descriptor` / `m2dp_from_map` / `find_candidates_m2dp`: the planar
    M2DP descriptor of a keyframe's cloud and its cosine retrieval.

Top-k over scores with many equal (infinite) entries keeps `lax.top_k`'s
order: lower flat index first (`ops.features.top_k_stable`); `jnp.argsort`
is stable, and so is every sort here.  The retrieval scores (ring keys and
their distances, the shift search, the M2DP Gram matrix) are summed in
float64 and rounded to float32, so the card and the CPU, whose float32 sums
run in different orders, rank candidates alike.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.ops.features import top_k_stable


def scan_context(polar, cfg: SlamConfig):
    """Polar power scan [A, Wpad] -> descriptor [R, S] (rings x sectors),
    max-pooled over range bins and azimuth rows."""
    A, R, S = cfg.num_azimuths, cfg.sc_rings, cfg.sc_sectors
    if A % S:
        raise ValueError("sc_sectors must divide num_azimuths")
    bins = (cfg.clipped_range_bins // R) * R
    p = polar[:, :bins]
    p = p.reshape(A, R, bins // R).amax(dim=2)   # [A, R]
    p = p.reshape(S, A // S, R).amax(dim=1)      # [S, R]
    return p.T.contiguous()


def ring_key(desc):
    """Rotation-invariant retrieval key [..., R]: sector mean per ring."""
    return desc.double().mean(dim=-1).to(desc.dtype)


def sc_alignment(d1, d2):
    """Best circular sector alignment of descriptors [..., R, S] -> (similarity
    in [0, 1], shift k, rotation in radians), batched over leading dims.

    sims[k] = mean_s cos(column s of d1, column (s + k) % S of d2); the
    rotation follows `estimate_rotation_fmt`'s convention (d2's scene is d1's
    rotated by it).  The first maximal shift wins, as `jnp.argmax`."""
    S = d1.shape[-1]
    eps = 1e-8
    a, b = d1.double(), d2.double()
    n1 = a / (torch.linalg.vector_norm(a, dim=-2, keepdim=True) + eps)
    n2 = b / (torch.linalg.vector_norm(b, dim=-2, keepdim=True) + eps)
    dots = n1.transpose(-1, -2) @ n2                               # [..., S, S]
    s = torch.arange(S, device=d1.device)
    cols = (s[None, :] + s[:, None]) % S                           # [k, s]
    sims = torch.gather(dots, -1, cols.T.expand(dots.shape)).mean(dim=-2).to(d1.dtype)
    k = torch.argmax(sims, dim=-1)
    sim = torch.gather(sims, -1, k[..., None])[..., 0]
    rot = k.to(d1.dtype) * (2.0 * math.pi / S)
    rot = torch.where(rot > math.pi, rot - 2.0 * math.pi, rot)
    return sim, k, rot


def sc_distance(d1, d2):
    """Scan-context distance in [0, 1]: 1 - best-shift mean column cosine."""
    return 1.0 - sc_alignment(d1, d2)[0]


class AppearanceCandidates(NamedTuple):
    i: torch.Tensor         # [C] earlier keyframe index
    j: torch.Tensor         # [C] later keyframe index
    distance: torch.Tensor  # [C] scan-context (or M2DP) distance
    rot_init: torch.Tensor  # [C] rotation initialiser for verification (rad)
    valid: torch.Tensor     # [C] bool


def _exact_and_select(descriptors, pi, pj, pre_ok, max_candidates, max_distance):
    """Exact all-shift distance on the prefiltered pairs, then the
    `max_candidates` smallest (stable order)."""
    sim, _, rot = sc_alignment(descriptors[pi], descriptors[pj])
    # sc_alignment gives the scene rotation seen from the sensor; the ICP
    # initialiser wants the relative heading theta_j - theta_i, its negation
    dist = torch.where(pre_ok, 1.0 - sim, torch.full_like(sim, float("inf")))
    best = torch.argsort(dist, stable=True)[:max_candidates]
    d = dist[best]
    return AppearanceCandidates(i=pi[best], j=pj[best], distance=d, rot_init=-rot[best],
                                valid=torch.isfinite(d) & (d <= max_distance))


def _pair_distances(keys_a, keys_b):
    """L2 distances [A, B] between ring keys [A, R] and [B, R]."""
    d = keys_a.double()[:, None, :] - keys_b.double()[None, :, :]
    return torch.sqrt(torch.sum(d * d, dim=-1)).to(keys_a.dtype)


def find_candidates_appearance(descriptors, cursor, max_candidates: int,
                               min_index_gap: int = 20, max_distance: float = 0.35,
                               prefilter: int = 4) -> AppearanceCandidates:
    """Loop candidates by appearance alone (no pose prior) over keyframe
    descriptors [M, R, S]: ring-key L2 over all pairs, then the exact
    all-shift distance on the `prefilter * max_candidates` best pairs."""
    M = descriptors.shape[0]
    keys = ring_key(descriptors)
    idx = torch.arange(M, device=descriptors.device)
    live = idx < cursor
    ok = live[:, None] & live[None, :] & ((idx[None, :] - idx[:, None]) >= min_index_gap)
    score = torch.where(ok, _pair_distances(keys, keys), float("inf"))
    vals, flat = top_k_stable(-score.reshape(-1), prefilter * max_candidates)
    return _exact_and_select(descriptors, flat // M, flat % M, torch.isfinite(vals),
                             max_candidates, max_distance)


def find_candidates_appearance_block(descriptors, cursor, lo, block: int,
                                     max_candidates: int, min_index_gap: int = 20,
                                     max_distance: float = 0.35,
                                     prefilter: int = 4) -> AppearanceCandidates:
    """`find_candidates_appearance` restricted to pairs whose later keyframe
    lies in [lo, lo + block): the incremental back-end's retrieval."""
    M = descriptors.shape[0]
    dev = descriptors.device
    keys = ring_key(descriptors)
    j = lo + torch.arange(block, device=dev)
    jc = torch.clamp(j, max=M - 1)
    i = torch.arange(M, device=dev)
    ok = ((j < cursor)[:, None] & (i < cursor)[None, :]
          & ((jc[:, None] - i[None, :]) >= min_index_gap))
    score = torch.where(ok, _pair_distances(keys[jc], keys), float("inf"))
    vals, flat = top_k_stable(-score.reshape(-1), prefilter * max_candidates)
    return _exact_and_select(descriptors, flat % M, jc[flat // M], torch.isfinite(vals),
                             max_candidates, max_distance)


class M2dpResult(NamedTuple):
    desc: torch.Tensor   # [..., n_dirs + n_bins] unit-norm signature
    angle: torch.Tensor  # [...] PCA alignment angle of the cloud (rad)


def m2dp_descriptor(points, mask, n_dirs: int = 16, n_bins: int = 24,
                    radius_m: float = 80.0, soft_px: float = 2.0) -> M2dpResult:
    """Planar M2DP of point clouds [..., P, 2] with masks [..., P]: PCA-align
    (signs by third-moment skewness), project onto `n_dirs` view lines, soft
    1-D histograms [D, B], SVD, concat(u1, v1) with the sign fixed by u[0, 0]."""
    w = mask.to(points.dtype)
    n = torch.clamp(w.sum(-1), min=1.0)
    mu = (points * w[..., None]).sum(-2) / n[..., None]
    c = (points - mu[..., None, :]) * w[..., None]
    cx, cy = c[..., 0], c[..., 1]
    sxx = torch.sum(cx * cx, -1)
    syy = torch.sum(cy * cy, -1)
    sxy = torch.sum(cx * cy, -1)
    angle = 0.5 * torch.atan2(2.0 * sxy, sxx - syy)
    ca, sa = torch.cos(-angle)[..., None], torch.sin(-angle)[..., None]
    ax = ca * cx - sa * cy
    ay = sa * cx + ca * cy
    fx = torch.where(torch.sum(ax ** 3, -1) < 0, -1.0, 1.0).to(points.dtype)
    fy = torch.where(torch.sum(ay ** 3, -1) < 0, -1.0, 1.0).to(points.dtype)
    ax = ax * fx[..., None]
    ay = ay * fy[..., None]
    angle = torch.where(fx < 0, angle + math.pi, angle)
    angle = torch.atan2(torch.sin(angle), torch.cos(angle))

    thetas = _linspace_f32(n_dirs, points.device)                 # [D]
    proj = (ax[..., None, :] * torch.cos(thetas)[:, None]
            + ay[..., None, :] * torch.sin(thetas)[:, None])       # [..., D, P]
    pos = torch.clamp((proj / radius_m + 1.0) * 0.5 * (n_bins - 1), 0.0, n_bins - 1.0)
    centers = torch.arange(n_bins, dtype=points.dtype, device=points.device)
    hat = torch.clamp(1.0 - torch.abs(pos[..., None] - centers) / soft_px, min=0.0)
    A = (hat * w[..., None, :, None]).sum(dim=-2)                  # [..., D, B]
    A = A / (torch.linalg.vector_norm(A, dim=-1, keepdim=True) + 1e-8)

    u, _, vt = torch.linalg.svd(A, full_matrices=False)
    sgn = torch.sign(u[..., 0, 0] + 1e-12)[..., None]
    d = torch.cat([u[..., :, 0] * sgn, vt[..., 0, :] * sgn], dim=-1)
    d = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-8)
    return M2dpResult(desc=d, angle=angle)


def _linspace_f32(n: int, device):
    """`jnp.linspace(0, pi, n, endpoint=False)` in float32: pi * (k / n)."""
    step = torch.arange(n, dtype=torch.float32, device=device) / n
    return torch.full((), math.pi, dtype=torch.float32, device=device) * step


def m2dp_from_map(m, n_dirs: int = 16, n_bins: int = 24, radius_m: float = 80.0,
                  source: str = "auto", chunk: int = 64) -> M2dpResult:
    """M2DP over a MapState's keyframe clouds -> [M, D + B] descriptors.

    `source`: "pointcloud" (the stored peak clouds `pc_local`), "features"
    (`feat_local`), or "auto": per keyframe the stored cloud where it has
    one, the feature cloud otherwise.  Keyframes go through in chunks of
    `chunk` to bound the [chunk, D, P, B] histogram."""
    if source == "pointcloud":
        pts, mask = m.pc_local, m.pc_mask
    elif source == "features":
        pts, mask = m.feat_local, m.feat_mask
    elif source == "auto":
        N = max(m.pc_local.shape[1], m.feat_local.shape[1])

        def padp(a):
            pad = [0, 0] * (a.ndim - 2) + [0, N - a.shape[1]]
            return torch.nn.functional.pad(a, pad)

        has_pc = torch.any(m.pc_mask, dim=1)
        pts = torch.where(has_pc[:, None, None], padp(m.pc_local), padp(m.feat_local))
        mask = torch.where(has_pc[:, None], padp(m.pc_mask), padp(m.feat_mask))
    else:
        raise ValueError(f"source must be pointcloud, features or auto, got {source!r}")
    parts = [m2dp_descriptor(pts[k:k + chunk], mask[k:k + chunk], n_dirs, n_bins, radius_m)
             for k in range(0, pts.shape[0], chunk)]
    return M2dpResult(desc=torch.cat([p.desc for p in parts]),
                      angle=torch.cat([p.angle for p in parts]))


def find_candidates_m2dp(descs, angles, cursor, max_candidates: int,
                         min_index_gap: int = 20,
                         max_distance: float = 0.25) -> AppearanceCandidates:
    """Loop candidates by M2DP cosine distance (one [M, M] Gram matrix); the
    rotation initialiser is the difference of the PCA alignment angles."""
    M = descs.shape[0]
    idx = torch.arange(M, device=descs.device)
    live = idx < cursor
    ok = live[:, None] & live[None, :] & ((idx[None, :] - idx[:, None]) >= min_index_gap)
    gram = (descs.double() @ descs.double().T).to(descs.dtype)
    dist = torch.where(ok, 1.0 - gram, float("inf"))
    vals, flat = top_k_stable(-dist.reshape(-1), max_candidates)
    ci, cj = flat // M, flat % M
    d = -vals
    rot = angles[ci] - angles[cj]
    rot = torch.atan2(torch.sin(rot), torch.cos(rot))
    return AppearanceCandidates(i=ci, j=cj, distance=d, rot_init=rot,
                                valid=torch.isfinite(d) & (d <= max_distance))
