"""Device meshes and collectives for the distributed back-end, on torch.distributed.

Counterpart of `radarslampy_tpu/parallel/mesh.py`.  The axis conventions are
the JAX package's:

  * ``kf``    -- the keyframe/map dimension: keyframe stores, pose-graph
    edges, BA landmark blocks and loop candidates are split along it;
  * ``batch`` -- independent sequences (``make_mesh_2d``).

The JAX package runs one controller over a `Mesh` with `shard_map`; the port
runs one process per device (rank), and every rank calls the same function
with the same full inputs.  Each rank takes its own block along ``kf``, the
tensor padded with zero (masked) rows to a multiple of the axis size as the
JAX package pads, and every function returns the replicated result.  `psum`
becomes `all_reduce(SUM)` over the mesh's ``kf`` group, `pmax`
`all_reduce(MAX)`, and `all_gather(..., tiled=True)` a gather into one
tensor.  The group's backend follows the mesh's device: NCCL for "cuda",
gloo for "cpu" (`parallel/launch.py::initialize`).

A mesh needs an initialised process group.  A world of one rank is a real
group: its collectives run through the backend like any other.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from radarslampy_tpu_torch import resolve_device

KF_AXIS = "kf"
BATCH_AXIS = "batch"

# torch 2.13 renamed `all_gather_into_tensor` (same arguments) and warns on the
# old name; older releases have only the old one.
_all_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _require_group():
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a mesh needs an initialised process group: call "
                           "radarslampy_tpu_torch.parallel.launch.initialize first")


def make_mesh(n_devices: Optional[int] = None, axis: str = KF_AXIS,
              device="cuda") -> DeviceMesh:
    """1-D mesh over the first `n_devices` ranks (default: all), one device
    each.  Every rank of the process group calls it; a rank outside the mesh
    takes no part in the mesh's calls."""
    dev = resolve_device(device)
    _require_group()
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    return DeviceMesh(dev.type, torch.arange(n), mesh_dim_names=(axis,))


def make_mesh_2d(kf: int, batch: int, device="cuda") -> DeviceMesh:
    """[kf, batch] mesh over the first kf * batch ranks."""
    dev = resolve_device(device)
    _require_group()
    if kf * batch > dist.get_world_size():
        raise ValueError(f"a {kf} x {batch} mesh in a world of {dist.get_world_size()}")
    return DeviceMesh(dev.type, torch.arange(kf * batch).reshape(kf, batch),
                      mesh_dim_names=(KF_AXIS, BATCH_AXIS))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device: the current CUDA device for a "cuda" mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh: DeviceMesh, axis: str = KF_AXIS) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def axis_index(mesh: DeviceMesh, axis: str = KF_AXIS) -> int:
    """This rank's coordinate along `axis` (`lax.axis_index`)."""
    return mesh.get_local_rank(axis)


def padded_len(n: int, parts: int) -> int:
    """n rounded up to a multiple of `parts`."""
    return -(-n // parts) * parts


def pad_rows(x, n: int, dim: int = 0, value=0):
    """`x` padded along `dim` to length n with `value` (zeros: masked rows)."""
    pad = n - x.shape[dim]
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype, device=x.device)], dim)


def shard_along(x, mesh: DeviceMesh, axis: str = KF_AXIS, dim: int = 0):
    """This rank's block of `x` along `dim`: `x` padded with zero rows to a
    multiple of the axis size, then cut into equal blocks in rank order."""
    n = axis_size(mesh, axis)
    x = pad_rows(x, padded_len(x.shape[dim], n), dim)
    per = x.shape[dim] // n
    return x.narrow(dim, axis_index(mesh, axis) * per, per)


def replicated(x, mesh: DeviceMesh):
    """`x` as every rank holds it: on this rank's device."""
    return x.to(mesh_device(mesh))


def psum(x, mesh: DeviceMesh, axis: str = KF_AXIS):
    """Sum of `x` over the ranks of `axis` (a new tensor on every rank)."""
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return out


def pmax(x, mesh: DeviceMesh, axis: str = KF_AXIS):
    """Elementwise maximum of `x` over the ranks of `axis`."""
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.get_group(axis))
    return out


def all_gather(x, mesh: DeviceMesh, axis: str = KF_AXIS):
    """Every rank's `x` concatenated along dim 0 in rank order
    (`lax.all_gather(..., tiled=True)`).  Bool tensors travel as uint8."""
    n = axis_size(mesh, axis)
    src = x.contiguous()
    if src.dtype == torch.bool:
        return all_gather(src.to(torch.uint8), mesh, axis).to(torch.bool)
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    _all_gather_into(out, src, group=mesh.get_group(axis))
    return out
