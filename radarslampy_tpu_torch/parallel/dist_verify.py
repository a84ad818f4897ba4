"""Distributed loop-candidate verification: the candidates split over the ranks.

Counterpart of `radarslampy_tpu/parallel/dist_verify.py`.  Verification is
many independent multi-start ICP alignments (`models/loopclosure.py::
verify_candidate`): every rank holds the whole keyframe map, takes its block
of the candidate list along ``kf``, verifies it, and one all-gather of the
`LoopMatch` fields at the end gives every rank the whole result in the
candidates' order.  Each candidate is verified by exactly one rank with the
serial path's function.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.models.frontend import MapState
from radarslampy_tpu_torch.models.loopclosure import VERIFY_CHUNK, LoopMatch, verify_candidate
from radarslampy_tpu_torch.parallel.mesh import (all_gather, axis_size, pad_rows, padded_len,
                                                 shard_along)


def verify_candidates_sharded(m: MapState, cand_i, cand_j, cand_valid, cand_rot,
                              cfg: SlamConfig, mesh: DeviceMesh, min_matches: int = 12,
                              max_residual_m: float = 1.0) -> LoopMatch:
    """ICP-verify candidates [C] split over the mesh -> `LoopMatch` [C] on
    every rank; `ok` is false where `cand_valid` is.  C must be a multiple
    of the ``kf`` axis size (`pad_candidates`).  Each rank verifies its
    block in chunks of `VERIFY_CHUNK` candidates (memory: [chunk, 6, K, K]
    float64 distances)."""
    n = axis_size(mesh)
    C = cand_i.shape[0]
    if C % n:
        raise ValueError(f"pad the candidates to a multiple of the mesh size ({C} % {n})")
    ci, cj, cv, cr = (shard_along(x, mesh) for x in (cand_i, cand_j, cand_valid, cand_rot))
    parts = [verify_candidate(m, ci[k:k + VERIFY_CHUNK], cj[k:k + VERIFY_CHUNK], cfg,
                              min_matches=min_matches, max_residual_m=max_residual_m,
                              rot_override=cr[k:k + VERIFY_CHUNK])
             for k in range(0, ci.shape[0], VERIFY_CHUNK)]
    local = LoopMatch(*(torch.cat(field) for field in zip(*parts)))
    local = local._replace(ok=local.ok & cv)
    return LoopMatch(*(all_gather(x, mesh) for x in local))


def pad_candidates(cand_i, cand_j, cand_valid, cand_rot, multiple: int):
    """Candidate tensors padded (valid=False, rotation NaN) to a multiple of
    the mesh size."""
    C = padded_len(cand_i.shape[0], multiple)
    return (pad_rows(cand_i, C), pad_rows(cand_j, C), pad_rows(cand_valid, C),
            pad_rows(cand_rot, C, value=float("nan")))
