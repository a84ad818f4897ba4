"""Checkpoint and resume of the whole SLAM state and trajectory.

The on-disk layout is the JAX package's (`radarslampy_tpu/utils/checkpoint.py`),
so a checkpoint written by either package resumes in the other:

  state.npz        leaf_0 ... leaf_21: the `SlamState` fields in order, with
                   the 11 `MapState` fields flattened in place at `map`
  treedef.json     {"format_version": 2, "n_leaves": 22, "meta": {...}}
  trajectory.npz   timestamps [N] int64, poses [N, 3] (optional)

`load_state` rebuilds the port's containers from that field order and `cfg`
(there is no JAX treedef to read): it checks each leaf's shape and casts to
the port's dtypes.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from radarslampy_tpu_torch import resolve_device
from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.models.frontend import MapState, SlamState, empty_map

# The JAX package's layout version: v2 is the state with MapState.frame_ids.
FORMAT_VERSION = 2
_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool


def _layout(cfg: SlamConfig):
    """(name, shape, dtype) of every leaf in checkpoint order."""
    A, Wp, S, K = cfg.num_azimuths, cfg.polar_width_padded, cfg.cart_size, cfg.k_max
    top = {
        "pose": ((3,), _F32), "velocity": ((3,), _F32),
        "prev_polar": ((A, Wp), _F32), "prev_cart": ((S, S), _F32),
        "feat_px": ((K, 2), _F32), "feat_mask": ((K,), _BOOL),
        "feat_id": ((K,), _I32), "next_id": ((), _I32),
        "feat_world": ((K, 2), _F32), "kf_pose": ((3,), _F32),
        "frame_idx": ((), _I32),
    }
    kmap = empty_map(cfg, device="meta")  # shapes and dtypes, no storage
    out = []
    for name in SlamState._fields:
        if name == "map":
            out += [(f"map.{f}", tuple(t.shape), t.dtype) for f, t in zip(MapState._fields, kmap)]
        else:
            out.append((name,) + top[name])
    return out


def _leaves(state: SlamState):
    for name in SlamState._fields:
        if name == "map":
            yield from state.map
        else:
            yield getattr(state, name)


def save_state(path: str, state: SlamState, trajectory=None,
               meta: Optional[dict] = None) -> None:
    """Write `state` (and a `Trajectory`) in the shared layout; `meta`
    (JSON-serialisable) holds resume bookkeeping such as the absolute index
    of the next frame, read back by `load_meta`."""
    os.makedirs(path, exist_ok=True)
    leaves = [t.detach().cpu().numpy() for t in _leaves(state)]
    np.savez(os.path.join(path, "state.npz"),
             **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)})
    with open(os.path.join(path, "treedef.json"), "w") as f:
        json.dump({"format_version": FORMAT_VERSION, "n_leaves": len(leaves),
                   "meta": meta or {}}, f)
    if trajectory is not None:
        ts, poses = trajectory.as_arrays()
        np.savez(os.path.join(path, "trajectory.npz"), timestamps=ts, poses=poses)


def load_state(path: str, cfg: SlamConfig,
               device="cuda") -> Tuple[SlamState, Optional[tuple]]:
    """Restore (state on `device`, (timestamps, poses) or None) from a
    checkpoint written by `save_state` here or in the JAX package."""
    dev = resolve_device(device)
    layout = _layout(cfg)
    with open(os.path.join(path, "treedef.json")) as f:
        td = json.load(f)
    n_saved = td.get("n_leaves", -1)
    version = td.get("format_version", 0)
    if version != FORMAT_VERSION or n_saved != len(layout):
        raise ValueError(
            f"incompatible checkpoint at {path}: format_version={version} "
            f"(expected {FORMAT_VERSION}), {n_saved} saved leaves vs "
            f"{len(layout)} in the current SlamState layout — it was "
            f"written by an older build; re-run from scratch or load with "
            f"that build"
        )
    fields = {}
    with np.load(os.path.join(path, "state.npz")) as data:
        for i, (name, shape, dtype) in enumerate(layout):
            arr = data[f"leaf_{i}"]
            if arr.shape != shape:
                raise ValueError(f"checkpoint at {path}: leaf {i} ({name}) has shape "
                                 f"{arr.shape}, the config gives {shape}")
            fields[name] = torch.from_numpy(np.array(arr)).to(device=dev, dtype=dtype)
    kmap = MapState(*(fields[f"map.{f}"] for f in MapState._fields))
    state = SlamState(*(kmap if name == "map" else fields[name]
                        for name in SlamState._fields))
    traj = None
    traj_path = os.path.join(path, "trajectory.npz")
    if os.path.exists(traj_path):
        with np.load(traj_path) as t:
            traj = (t["timestamps"], t["poses"])
    return state, traj


def load_meta(path: str) -> dict:
    """Resume metadata saved beside the state (empty dict if none)."""
    with open(os.path.join(path, "treedef.json")) as f:
        return json.load(f).get("meta", {})
