"""Distributed Schur-complement bundle adjustment over the ranks of a mesh.

Counterpart of `radarslampy_tpu/parallel/dist_ba.py`.  Landmarks, together
with every observation of them, are split along the ``kf`` axis.  The reduced
pose system is a sum of independent per-landmark contributions, so each rank
assembles its block's part with the port's `models/ba.py`, an `all_reduce`
sums them, the damped anchored solve runs replicated, and the landmark
back-substitution stays on the owning rank.  The landmarks are all-gathered
once at the end, so every rank returns the same (poses, landmarks, cost).

  * "dense": per LM iteration the local [3M, 3M] reduced system and its
    right-hand side, one `all_reduce` of each (O(M^2): small maps only);
  * "pcg":   matrix-free (`models/ba._optimize_ba_pcg` with `reduce_fn`):
    only [M, 3] and [M, 3, 3] arrays cross ranks; its sweeps run eagerly;
  * "auto":  dense when M <= 512, else pcg.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.models.ba import BAProblem, _optimize_ba_dense, _optimize_ba_pcg
from radarslampy_tpu_torch.parallel.mesh import (all_gather, axis_index, axis_size, psum,
                                                 shard_along)

OBS_FIELDS = ("obs_pose", "obs_lm", "obs_xy", "obs_mask")


def shard_ba_problem(p: BAProblem, n_shards: int) -> BAProblem:
    """Host-side repack: landmarks (and their observations) split into
    `n_shards` contiguous blocks, keeping global pose and landmark indices.

    The landmark arrays are padded (masked) to a multiple of n_shards.  The
    valid observations are grouped by the block of their landmark, each group
    in its input order, and padded (masked) to the largest group's length, as
    the JAX package's repack does; masked input rows are dropped.  Where
    masked rows stand matters to the dense solver: `build_view_table` drops
    the last landmark's last view slot when a masked row sorts after it, so
    this layout keeps the JAX package's blocks.
    """
    dev = p.poses.device
    obs_lm = p.obs_lm.cpu().numpy()
    obs_mask = p.obs_mask.cpu().numpy()
    L = p.landmarks.shape[0]
    per = -(-L // n_shards)
    shard = np.clip(obs_lm // per, 0, n_shards - 1)
    valid = np.nonzero(obs_mask)[0]
    valid = valid[np.argsort(shard[valid], kind="stable")]
    counts = np.bincount(shard[valid], minlength=n_shards)
    per_obs = max(int(counts.max(initial=0)), 1)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    # destination row of each valid observation: its block's start + its rank
    # within the block
    rank_in = np.arange(len(valid)) - np.repeat(starts, counts)
    dst = torch.from_numpy(shard[valid] * per_obs + rank_in).to(dev)
    src = torch.from_numpy(valid).to(dev)

    def place(x):
        out = torch.zeros((n_shards * per_obs,) + tuple(x.shape[1:]), dtype=x.dtype, device=dev)
        out[dst] = x[src]
        return out

    def pad_lm(x):
        return torch.cat([x, torch.zeros((per * n_shards - L,) + tuple(x.shape[1:]),
                                         dtype=x.dtype, device=dev)])

    return p._replace(landmarks=pad_lm(p.landmarks), lm_mask=pad_lm(p.lm_mask),
                      **{f: place(getattr(p, f)) for f in OBS_FIELDS})


def _local_problem(p: BAProblem, mesh: DeviceMesh) -> BAProblem:
    """This rank's landmark block and its observations, with the landmark
    indices made local (masked padding rows point at local landmark 0)."""
    ps = shard_ba_problem(p, axis_size(mesh))
    local = ps._replace(landmarks=shard_along(ps.landmarks, mesh),
                        lm_mask=shard_along(ps.lm_mask, mesh),
                        **{f: shard_along(getattr(ps, f), mesh) for f in OBS_FIELDS})
    offset = axis_index(mesh) * local.landmarks.shape[0]
    return local._replace(obs_lm=torch.where(local.obs_mask, local.obs_lm - offset, 0))


def optimize_ba_sharded(p: BAProblem, cfg: SlamConfig, mesh: DeviceMesh,
                        max_views_per_landmark: int = 8, method: str = "auto", stats=None):
    """LM bundle adjustment with the landmarks split over the mesh's ``kf``
    ranks -> (poses [M, 3], landmarks [Lpad, 2], cost), the same on every
    rank; `Lpad` is L padded to a multiple of the axis size (the first L rows
    are `p`'s landmarks).  `p` is the whole problem, on every rank.  `stats`,
    when a dict, receives "cg_sweeps" (0 for the dense solver)."""
    if method == "auto":
        method = "dense" if p.poses.shape[0] <= 512 else "pcg"
    local = _local_problem(p, mesh)
    red = lambda x: psum(x, mesh)  # noqa: E731
    if method == "pcg":
        poses, lms, cost = _optimize_ba_pcg(local, cfg, stats=stats, reduce_fn=red)
    elif method == "dense":
        if stats is not None:
            stats["cg_sweeps"] = 0
        poses, lms, cost = _optimize_ba_dense(local, cfg, max_views_per_landmark, reduce_fn=red)
    else:
        raise ValueError(f"method must be dense, pcg or auto, got {method!r}")
    return poses, all_gather(lms, mesh), cost
