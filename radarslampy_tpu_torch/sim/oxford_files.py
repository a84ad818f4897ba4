"""Write a synthetic sequence in the Oxford Radar RobotCar layout that
`io/oxford.py` reads (see `sequence_paths`):

  <root>/<sequence>/radar.timestamps          "<timestamp> 1" per frame
  <root>/<sequence>/gt/radar_odometry.csv     per-frame (dx, dy, dyaw) that
                                              chain to the given poses
  <root>/<sequence>/radar/<timestamp>.png     400 rows x (11 + clipped range
                                              bins) u8, with `png=True`

Timestamps are microseconds, one scan period apart.  Writing PNGs needs PIL,
imported only then.
"""

from __future__ import annotations

import os

import numpy as np

from radarslampy_tpu_torch.config import SlamConfig

T0_US = 1_547_131_046_000_000


def frame_timestamps(n: int, cfg: SlamConfig) -> np.ndarray:
    return T0_US + np.arange(n, dtype=np.int64) * int(round(cfg.scan_period_s * 1e6))


def _relative_motion(poses):
    """(dx, dy, dyaw) of each pose in the frame of the one before it; the
    first row is zero, so the chained GT starts at poses[0] = 0."""
    d = np.zeros_like(poses, dtype=np.float64)
    for i in range(1, len(poses)):
        th = poses[i - 1, 2]
        dxw, dyw = poses[i, :2] - poses[i - 1, :2]
        d[i] = (np.cos(th) * dxw + np.sin(th) * dyw,
                -np.sin(th) * dxw + np.cos(th) * dyw,
                poses[i, 2] - th)
    return d


def _png_rows(power_u8, stamp: int, cfg: SlamConfig) -> np.ndarray:
    A, bins = cfg.num_azimuths, cfg.clipped_range_bins
    raw = np.zeros((A, 11 + bins), np.uint8)
    az_us = stamp + np.arange(A, dtype=np.int64) * int(cfg.scan_period_s * 1e6) // A
    raw[:, :8] = az_us.astype("<i8").view(np.uint8).reshape(A, 8)
    enc = (np.arange(A) * cfg.encoder_size // A).astype("<u2")
    raw[:, 8:10] = enc.view(np.uint8).reshape(A, 2)
    raw[:, 10] = 255
    raw[:, 11:] = power_u8[:, :bins]
    return raw


def write_sequence(root: str, sequence: str, poses, cfg: SlamConfig,
                   frames_u8=None) -> np.ndarray:
    """Write the sequence's files; PNGs too when `frames_u8` ([N, A, Wpad]
    u8 scans) is given.  `poses` [N, 3] starts at the origin.  Returns the
    frame timestamps."""
    poses = np.asarray(poses, np.float64)
    stamps = frame_timestamps(len(poses), cfg)
    base = os.path.join(root, sequence)
    os.makedirs(os.path.join(base, "gt"), exist_ok=True)
    os.makedirs(os.path.join(base, "radar"), exist_ok=True)
    with open(os.path.join(base, "radar.timestamps"), "w") as f:
        f.writelines(f"{t} 1\n" for t in stamps)
    with open(os.path.join(base, "gt", "radar_odometry.csv"), "w") as f:
        f.write("source_radar_timestamp,destination_radar_timestamp,x,y,z,roll,pitch,"
                "yaw,source_timestamp,destination_timestamp\n")
        for i, (dx, dy, dyaw) in enumerate(_relative_motion(poses)):
            src = stamps[max(i - 1, 0)]
            f.write(f"{src},{stamps[i]},{dx:.17g},{dy:.17g},0,0,0,{dyaw:.17g},{src},{stamps[i]}\n")
    if frames_u8 is not None:
        from PIL import Image

        for stamp, power in zip(stamps, frames_u8):
            Image.fromarray(_png_rows(np.asarray(power), int(stamp), cfg)).save(
                os.path.join(base, "radar", f"{stamp}.png"))
    return stamps
