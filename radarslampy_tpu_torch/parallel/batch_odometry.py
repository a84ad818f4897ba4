"""Data-parallel odometry: D independent sequence segments in lock-step.

Counterpart of `radarslampy_tpu/parallel/batch_odometry.py`.  The SLAM chain
is serial per trajectory, but a long recording splits into segments: the D
segments are split over the mesh's ``kf`` ranks in contiguous blocks, every
rank advances its segments one frame at a time in lock-step, one port
`slam_step` per segment per frame, and the per-segment poses are all-gathered
at the end and joined by chaining relative poses (`join_segments`).  There is
no collective in the per-frame loop.

Difference in form: the JAX package vmaps the step over the segments, so both
`lax.cond` branches of the keyframe/retrack decision run on every frame; the
port's step takes that decision on the host and launches the DoH kernel only
on a retrack, so it runs the segments in turn.  The poses agree with the JAX
package's within the bound its own tests set for that difference.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.models import frontend
from radarslampy_tpu_torch.ops import geometry as geo
from radarslampy_tpu_torch.parallel.mesh import (all_gather, axis_index, axis_size, pad_rows,
                                                 padded_len)


def _block(D: int, mesh: DeviceMesh) -> range:
    """This rank's segments of D, a contiguous block (the last ones may be
    short or empty)."""
    per = padded_len(D, axis_size(mesh)) // axis_size(mesh)
    lo = axis_index(mesh) * per
    return range(min(lo, D), min(lo + per, D))


def batched_init(polars0, maps, cfg: SlamConfig) -> List[frontend.SlamState]:
    """[D, A, W] first frames -> one SlamState per segment, each at the origin."""
    return [frontend.init_state(p, torch.zeros(3), maps, cfg) for p in polars0]


def make_batched_init(cfg: SlamConfig, mesh: DeviceMesh):
    """init(polars0 [D, A, W], maps) -> the states of this rank's segments."""
    def init(polars0, maps):
        return batched_init([polars0[d] for d in _block(len(polars0), mesh)], maps, cfg)
    return init


def make_batched_step(cfg: SlamConfig, mesh: DeviceMesh):
    """step(states, polars [D, A, W], maps) -> (states, StepOutputs) of this
    rank's segments: each advanced by one frame, in turn."""
    def step(states, polars, maps):
        outs = [frontend.slam_step(s, polars[d], maps, cfg)
                for s, d in zip(states, _block(len(polars), mesh))]
        return [s for s, _ in outs], [o for _, o in outs]
    return step


def join_segments(segment_poses: List[np.ndarray]) -> np.ndarray:
    """Chain per-segment trajectories (each starting at the origin) into one.

    Segment k's poses are transformed by the accumulated end pose of segments
    0..k-1.  Exact when segments overlap by one frame (the next segment's
    first frame is the previous segment's last); the duplicated frame is
    dropped.  Computed in float64.
    """
    out = [np.asarray(segment_poses[0], np.float64)]
    T_acc = geo.pose_to_transform(torch.from_numpy(out[0][-1]))
    for seg in segment_poses[1:]:
        Ts = geo.pose_to_transform(torch.as_tensor(np.asarray(seg), dtype=torch.float64))
        joined = geo.transform_to_pose(T_acc @ Ts).numpy()
        out.append(joined[1:])
        T_acc = geo.pose_to_transform(torch.from_numpy(joined[-1]))
    return np.concatenate(out, axis=0)


def run_segments(frames, maps, cfg: SlamConfig, mesh: DeviceMesh) -> np.ndarray:
    """frames [D, T, A, W] (u8 or float scans) -> [D, T, 3] per-segment poses
    (each segment in its own origin frame), the same on every rank."""
    D, T = frames.shape[:2]
    init = make_batched_init(cfg, mesh)
    step = make_batched_step(cfg, mesh)
    states = init(frames[:, 0], maps)
    dev = maps.warp.idx0.device
    poses = [[torch.zeros(3, device=dev)] for _ in states]
    for t in range(1, T):
        states, outs = step(states, frames[:, t], maps)
        for log, out in zip(poses, outs):
            log.append(out.pose)
    per = padded_len(D, axis_size(mesh)) // axis_size(mesh)
    local = (torch.stack([torch.stack(p) for p in poses]) if poses
             else torch.zeros((0, T, 3), device=dev))
    return all_gather(pad_rows(local, per), mesh)[:D].cpu().numpy()
