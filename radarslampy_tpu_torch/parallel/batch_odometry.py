"""Data-parallel odometry: D independent sequence segments in lock-step.

Counterpart of `radarslampy_tpu/parallel/batch_odometry.py`.  The SLAM chain
is serial per trajectory, but a long recording splits into segments: the D
segments are split over the mesh's ``kf`` ranks in contiguous blocks, every
rank advances its block one frame at a time in lock-step, and the
per-segment poses are all-gathered at the end and joined by chaining relative
poses (`join_segments`).  There is no collective in the per-frame loop.

A rank's block is one batch, as the JAX package's `vmap(slam_step)` is: the
state carries a leading segment axis (`frontend.stack_states`), the step is
`slam_step` under `torch.func.vmap` (`frontend.batched_slam_step`), and DoH
runs once a frame over [d, S, S].  Its decision is a selection on the device,
as under the JAX package's vmap, so detection runs on every frame of every
segment.  On the card `run_segments` replays the batched step's CUDA graph
(`frontend.StepGraph(maps, cfg, batch=d)`) once a frame for the whole block,
with no host sync inside the loop; on the CPU it runs the vmapped eager step.
Every segment gets the bits of its own `slam_step`.
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


def _block(D: int, mesh: DeviceMesh) -> slice:
    """This rank's segments of D, a contiguous block (the last ones may be
    short or empty)."""
    per = padded_len(D, axis_size(mesh)) // axis_size(mesh)
    lo = axis_index(mesh) * per
    return slice(min(lo, D), min(lo + per, D))


def batched_init(polars0, maps, cfg: SlamConfig) -> frontend.SlamState:
    """[D, A, W] first frames -> the batched SlamState (a leading D axis on
    every leaf), each segment at the origin."""
    return frontend.batched_init_state(polars0, torch.zeros((len(polars0), 3)), maps, cfg)


def make_batched_init(cfg: SlamConfig, mesh: DeviceMesh):
    """init(polars0 [D, A, W], maps) -> the batched state of this rank's
    segments."""
    def init(polars0, maps):
        return batched_init(polars0[_block(len(polars0), mesh)], maps, cfg)
    return init


def make_batched_step(cfg: SlamConfig, mesh: DeviceMesh):
    """step(states, polars [D, A, W], maps) -> (states, StepOutput with
    fields [d, ...]) of this rank's d segments, all advanced by one frame in
    one vmapped step."""
    def step(states, polars, maps):
        return frontend.batched_slam_step(states, polars[_block(len(polars), mesh)], maps, cfg)
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
    (each segment in its own origin frame), the same on every rank.  This
    rank's block goes through one `StepGraph(maps, cfg, batch=d)`: on the
    card one replay a frame for all d segments, the rows kept on the device
    until the end."""
    D, T = frames.shape[:2]
    dev = maps.warp.idx0.device
    block = _block(D, mesh)
    local = torch.zeros((block.stop - block.start, T, 3), device=dev)
    if len(local):
        seg = frames[block]
        graph = frontend.StepGraph(maps, cfg, batch=len(local))
        graph.load(batched_init(seg[:, 0], maps, cfg))
        for t in range(1, T):
            local[:, t] = graph.step(seg[:, t])[:, :3]
    per = padded_len(D, axis_size(mesh)) // axis_size(mesh)
    return all_gather(pad_rows(local, per), mesh)[:D].cpu().numpy()
