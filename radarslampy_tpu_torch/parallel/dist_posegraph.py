"""Distributed pose-graph optimisation: the edges split over the ranks of a mesh.

Counterpart of `radarslampy_tpu/parallel/dist_posegraph.py`.  The poses are
replicated ([M, 3]); the edge arrays are padded with masked edges to a
multiple of the ``kf`` axis size and each rank keeps its block.  The solvers
are the port's own (`models/posegraph.py`) with their reduction hooks set to
the mesh's collectives:

  * "dense":  per LM iteration the local H [3M, 3M] and b [3M] of the edge
    block, one `all_reduce` of each, the damped Cholesky solve replicated;
    the costs are all-reduced, and the GNC start is a MAX over the blocks (a
    sum would count it once per rank);
  * "pcg":    matrix-free LM, one [M, 3] `all_reduce` per CG sweep (the
    `reduce_fn` hook); its sweeps run eagerly, not from a CUDA graph;
  * "gather": one all-gather of the edge blocks per solve, then the
    single-device PCG on every rank, with no further collective;
  * "auto":   dense when M <= 1024, else gather.

Every value a rank branches on (the CG stopping rule, the LM acceptance) is
reduced, so all ranks take the same branches and return the same poses.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.models.posegraph import (PoseGraph, _optimize_pose_graph_dense,
                                                    _optimize_pose_graph_pcg, edge_system)
from radarslampy_tpu_torch.ops.scatter import scatter_add
from radarslampy_tpu_torch.parallel.mesh import (KF_AXIS, all_gather, axis_size, pad_rows,
                                                 padded_len, pmax, psum, shard_along)

EDGE_FIELDS = ("edges_ij", "edges_meas", "edges_info", "edge_mask")


def _shard_edges(g: PoseGraph, n_shards: int) -> PoseGraph:
    """The edge arrays padded to a multiple of n_shards (masked padding)."""
    E = padded_len(g.edges_ij.shape[0], n_shards)
    return g._replace(**{f: pad_rows(getattr(g, f), E) for f in EDGE_FIELDS})


def _local_edges(g: PoseGraph, mesh: DeviceMesh) -> PoseGraph:
    """The graph with only this rank's block of the padded edges."""
    g = _shard_edges(g, axis_size(mesh))
    return g._replace(**{f: shard_along(getattr(g, f), mesh) for f in EDGE_FIELDS})


def optimize_pose_graph_sharded(g: PoseGraph, cfg: SlamConfig, mesh: DeviceMesh,
                                method: str = "auto", stats=None):
    """LM pose-graph solve with the edges split over the mesh's ``kf`` ranks
    -> (poses [M, 3], final cost), the same on every rank.  `g` is the whole
    graph, on every rank.  `stats`, when a dict, receives "cg_sweeps" (0 for
    the dense solver)."""
    if method == "auto":
        method = "dense" if g.poses.shape[0] <= 1024 else "gather"
    if method == "gather":
        return _optimize_pose_graph_sharded_gather(g, cfg, mesh, stats)
    local = _local_edges(g, mesh)
    red = (lambda x: psum(x, mesh), lambda x: pmax(x, mesh))
    if method == "pcg":
        return _optimize_pose_graph_pcg(local, cfg, stats=stats, reduce_fn=red[0],
                                        reduce_max_fn=red[1])
    if method != "dense":
        raise ValueError(f"method must be dense, pcg, gather or auto, got {method!r}")
    if stats is not None:
        stats["cg_sweeps"] = 0
    return _optimize_pose_graph_dense(local, cfg, reduce_fn=red[0], reduce_max_fn=red[1])


def _optimize_pose_graph_sharded_gather(g: PoseGraph, cfg: SlamConfig, mesh: DeviceMesh,
                                        stats=None):
    """Each rank's edge block all-gathered once, then the single-device
    matrix-free LM on every rank with no further collective."""
    local = _local_edges(g, mesh)
    full = local._replace(**{f: all_gather(getattr(local, f), mesh) for f in EDGE_FIELDS})
    return _optimize_pose_graph_pcg(full, cfg, stats=stats)


def hvp_distributed(poses, g: PoseGraph, v, huber_delta, mesh: DeviceMesh, axis: str = KF_AXIS):
    """Matrix-free H @ v for PCG: this rank's edges' J^T W J v, summed over
    the ranks of `axis`.  `g` holds this rank's edges; v: [M, 3]."""
    r, Ji, Jj, W = edge_system(poses, g, huber_delta)
    i, j = g.edges_ij[:, 0], g.edges_ij[:, 1]
    u = W * (torch.einsum("eab,eb->ea", Ji, v[i]) + torch.einsum("eab,eb->ea", Jj, v[j]))
    out = scatter_add(torch.zeros_like(v), torch.cat([i, j]),
                      torch.cat([torch.einsum("eab,ea->eb", Ji, u),
                                 torch.einsum("eab,ea->eb", Jj, u)]))
    return psum(out, mesh, axis)

