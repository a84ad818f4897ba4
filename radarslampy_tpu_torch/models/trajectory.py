"""Trajectory container, time interpolation and ATE (host-side numpy).

A copy of `radarslampy_tpu/models/trajectory.py`: the driver records each
frame's pose here, interpolates between timestamps and computes the RMSE/ATE
against ground truth.  The port keeps its own copy because importing the JAX
package pulls in JAX.
"""

from __future__ import annotations

import numpy as np


class Trajectory:
    def __init__(self, timestamps=None, poses=None):
        self.timestamps = list(timestamps) if timestamps is not None else []
        self.poses = [np.asarray(p, dtype=np.float64) for p in poses] if poses is not None else []

    def append(self, timestamp: int, pose) -> None:
        self.timestamps.append(int(timestamp))
        self.poses.append(np.asarray(pose, dtype=np.float64))

    def as_arrays(self):
        return np.asarray(self.timestamps, dtype=np.int64), np.stack(self.poses)

    def pose_at_times(self, query_times):
        """Linear interpolation of poses at query timestamps, clamped to the
        nearest pose at the ends; the heading is interpolated unwrapped."""
        ts, poses = self.as_arrays()
        q = np.atleast_1d(np.asarray(query_times, dtype=np.float64))
        t = ts.astype(np.float64)
        out = np.empty((len(q), 3))
        for d in range(2):
            out[:, d] = np.interp(q, t, poses[:, d])
        unwrapped = np.unwrap(poses[:, 2])
        th = np.interp(q, t, unwrapped)
        out[:, 2] = (th + np.pi) % (2 * np.pi) - np.pi
        return out if np.ndim(query_times) else out[0]


def compute_rmse(gt_poses, est_poses):
    """Translational RMSE (ATE) over matched poses."""
    err = np.linalg.norm(gt_poses[:, :2] - est_poses[:, :2], axis=-1)
    return float(np.sqrt(np.mean(err**2)))


def align_and_rmse(gt_traj: Trajectory, est_traj: Trajectory):
    """ATE over the GT timestamps inside the overlap of both trajectories
    -> (rmse, gt poses, est poses at those times)."""
    t0 = max(gt_traj.timestamps[0], est_traj.timestamps[0])
    t1 = min(gt_traj.timestamps[-1], est_traj.timestamps[-1])
    times = [t for t in gt_traj.timestamps if t0 <= t <= t1]
    gt = gt_traj.pose_at_times(times)
    est = est_traj.pose_at_times(times)
    return compute_rmse(gt, est), gt, est
