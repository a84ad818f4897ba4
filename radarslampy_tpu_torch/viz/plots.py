"""Host-side figures of a run: a copy of `radarslampy_tpu/viz/plots.py`.

The trajectory against GT (and GPS), tracked features over a scan, the map's
points, the per-frame composite of the driver's `viz_dir`, and the mp4 made of
those frames by ffmpeg where it exists.  Every function takes numpy arrays and
draws on matplotlib's Agg backend, chosen when this module is imported (so
importing the driver does not import matplotlib); nothing here touches the
device.
"""

from __future__ import annotations

import os
import subprocess
from typing import Optional

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np


def align_xy(src_xy: np.ndarray, dst_xy: np.ndarray) -> np.ndarray:
    """Rigid 2-D alignment (rotation + translation, closed-form Procrustes)
    of src onto dst, over their first min(len) points: places the GPS track
    (its own UTM frame) over the odometry frame for the overlay plot."""
    n = min(len(src_xy), len(dst_xy))
    s = src_xy[:n] - src_xy[:n].mean(0)
    d = dst_xy[:n] - dst_xy[:n].mean(0)
    C = s.T @ d
    th = np.arctan2(C[0, 1] - C[1, 0], C[0, 0] + C[1, 1])
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    return (src_xy - src_xy[:n].mean(0)) @ R.T + dst_xy[:n].mean(0)


def plot_trajectories(gt_poses: Optional[np.ndarray], est_poses: np.ndarray,
                      title: str = "GT and EST Trajectories",
                      save_path: Optional[str] = None, rmse: Optional[float] = None,
                      gps_xy: Optional[np.ndarray] = None):
    """GT against estimate, the RMSE in the title, and optionally the GPS
    track.  Saves and returns None with `save_path`, else returns (fig, ax)."""
    fig, ax = plt.subplots(figsize=(6, 6))
    if gt_poses is not None:
        ax.plot(gt_poses[:, 0], gt_poses[:, 1], "b-", label="Ground Truth")
    if gps_xy is not None:
        ax.plot(gps_xy[:, 0], gps_xy[:, 1], "g--", alpha=0.7, label="GPS")
    ax.plot(est_poses[:, 0], est_poses[:, 1], "r-", label="Estimated")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.grid(True)
    ax.legend()
    ax.axis("square")
    if rmse is not None:
        title = f"{title}: RMSE={rmse:.2f}"
    ax.set_title(title)
    if save_path:
        fig.tight_layout()
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
        return None
    return fig, ax


def plot_tracking(prev_img: np.ndarray, curr_img: np.ndarray,
                  prev_pts: np.ndarray, curr_pts: np.ndarray,
                  mask: Optional[np.ndarray] = None,
                  save_path: Optional[str] = None, title: str = ""):
    """Previous and tracked feature positions over the current image."""
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.imshow(curr_img, cmap="gray")
    if mask is None:
        mask = np.ones(len(prev_pts), dtype=bool)
    ax.scatter(prev_pts[mask, 0], prev_pts[mask, 1], marker=".", color="yellow",
               s=12, label="previous")
    ax.scatter(curr_pts[mask, 0], curr_pts[mask, 1], marker="+", color="red",
               s=16, label="tracked")
    ax.legend()
    ax.axis("off")
    if title:
        ax.set_title(title)
    if save_path:
        fig.tight_layout()
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
        return None
    return fig, ax


def plot_map(map_points: np.ndarray, point_mask: np.ndarray,
             est_poses: Optional[np.ndarray] = None,
             subsample: int = 5, save_path: Optional[str] = None):
    """The map's points (every `subsample`-th live one) and the trajectory."""
    fig, ax = plt.subplots(figsize=(6, 6))
    pts = map_points[point_mask][::subsample]
    ax.scatter(pts[:, 0], pts[:, 1], marker="+", color="g", alpha=0.6, s=8,
               label="map points")
    if est_poses is not None:
        ax.plot(est_poses[:, 0], est_poses[:, 1], "r-", label="trajectory")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.axis("square")
    ax.legend()
    if save_path:
        fig.tight_layout()
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
        return None
    return fig, ax


def plot_frame_composite(curr_img: np.ndarray, pts: np.ndarray,
                         mask: np.ndarray,
                         gt_xy: Optional[np.ndarray],
                         est_xy: np.ndarray,
                         save_path: str, title: str = ""):
    """Per-frame side-by-side: tracked features over the current Cartesian
    scan, and the trajectory so far against GT."""
    fig, (ax0, ax1) = plt.subplots(1, 2, figsize=(10, 5))
    ax0.imshow(curr_img, cmap="gray")
    ax0.scatter(pts[mask, 0], pts[mask, 1], marker="+", color="red", s=14)
    ax0.axis("off")
    ax0.set_title(title or "tracked features")
    if gt_xy is not None:
        ax1.plot(gt_xy[:, 0], gt_xy[:, 1], "b-", label="GT")
    ax1.plot(est_xy[:, 0], est_xy[:, 1], "r-", label="est")
    ax1.axis("square")
    ax1.grid(True)
    ax1.legend()
    fig.tight_layout()
    fig.savefig(save_path, dpi=100)
    plt.close(fig)


def frames_to_mp4(frame_dir: str, out_path: str, fps: int = 10) -> bool:
    """Assemble the .jpg frames of `frame_dir` into an mp4 with ffmpeg.
    Returns False when ffmpeg is absent or fails."""
    try:
        subprocess.run(
            ["ffmpeg", "-y", "-framerate", str(fps), "-pattern_type", "glob",
             "-i", os.path.join(frame_dir, "*.jpg"), "-pix_fmt", "yuv420p",
             out_path],
            check=True, capture_output=True,
        )
        return True
    except (OSError, subprocess.CalledProcessError):
        return False
