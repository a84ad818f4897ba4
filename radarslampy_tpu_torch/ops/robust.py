"""Geometric-consistency outlier rejection by degree peeling.

Counterpart of `radarslampy_tpu/ops/robust.py::reject_outliers`.  A pair
(i, j) is compatible when its inter-point distance is preserved between frames
within the threshold; the active feature with the most violations is dropped
(ties to the lowest index) until the survivors are mutually consistent.

The JAX package runs this as an unbounded `lax.while_loop` that recounts all
violations each step.  Here the loop runs K steps on the device with no host
check, and keeps the per-node violation counts up to date incrementally
(dropping node w subtracts column w of the violation matrix), which
gives the same sequence of drops.  A step after convergence (no count above
0) changes nothing, so the K bounded steps end where the while loop does.

Each step is four launches: `max` (value and first index of the largest
count), `clamp` (1 when that count is above 0, else 0), the column of the
dropped node, and `addcmul`.  The column's diagonal entry is K + 1, so a dropped
node's count goes below 0 and stays there; nodes outside `mask` hold 0 and
are never dropped; so a count above 0 belongs to a surviving node, and the
survivors are `mask` & (count >= 0).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from radarslampy_tpu_torch.config import SlamConfig


def _pairwise_dist(pts):
    d2 = torch.sum((pts[:, None, :] - pts[None, :, :]) ** 2, dim=-1)
    return torch.sqrt(torch.clamp(d2, min=0.0))


class RejectResult(NamedTuple):
    inlier_mask: torch.Tensor  # [K] bool surviving mutually-consistent features
    n_inliers: torch.Tensor    # int32 scalar


def reject_outliers(prev_coords, new_coords, mask, cfg: SlamConfig) -> RejectResult:
    """Consistency peeling over [K, 2] pixel correspondence sets with validity
    mask, at the `clique_dist_threshold_px` of the config."""
    K = prev_coords.shape[0]
    compat = torch.abs(_pairwise_dist(prev_coords) - _pairwise_dist(new_coords)) \
        <= cfg.clique_dist_threshold_px
    eye = torch.eye(K, dtype=torch.bool, device=mask.device)
    bad = (mask[:, None] & mask[None, :] & ~eye & ~compat).to(torch.int32)
    viol = bad.sum(dim=1)        # violations among active nodes (0 if inactive)
    cols = (bad + eye.to(torch.int32) * (K + 1)).T.contiguous()   # row w: column w
    for _ in range(K):
        worst_n, worst = torch.max(viol, dim=0)
        viol = torch.addcmul(viol, cols.index_select(0, worst.reshape(1))[0],
                             torch.clamp(worst_n, 0, 1), value=-1)
    active = mask & (viol >= 0)
    return RejectResult(inlier_mask=active,
                        n_inliers=torch.sum(active.to(torch.int32)))
