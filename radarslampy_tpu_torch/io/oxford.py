"""Oxford Radar RobotCar decoding, host-side: a copy of
`radarslampy_tpu/io/oxford.py`.

PNGs are decoded with PIL into numpy, metadata fields are sliced per the
Oxford format, and the clipped power matrix is zero-padded to the step's
static width.  PIL is imported inside `decode_radar_png`, so the driver
imports on a machine without it when frames come from `frame_source`.

Raw PNG layout (400 rows, uint8):
  cols 0-7   int64 little-endian UNIX timestamp per azimuth
  cols 8-9   uint16 encoder azimuth (ticks / encoder_size * 2*pi radians)
  col  10    valid flag (255 = raw return, else interpolated)
  cols 11+   power readings / 255.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple

import numpy as np

from radarslampy_tpu_torch.config import SlamConfig


class RadarFrame(NamedTuple):
    power: np.ndarray       # [A, Wpad] float32 power in [0, 1] (u8 with raw_u8), zero-padded
    azimuths: np.ndarray    # [A] float32 encoder azimuth (radians)
    valid: np.ndarray       # [A] bool raw-return flag
    timestamps: np.ndarray  # [A] int64 per-azimuth UNIX timestamps
    frame_timestamp: int    # scan timestamp (from the filename)


def decode_radar_png(path: str, cfg: SlamConfig, raw_u8: bool = False) -> RadarFrame:
    """Decode one Oxford radar PNG into a padded polar power matrix.

    `raw_u8=True` keeps power as the raw PNG bytes; the step dequantises
    them on its device after a 4x smaller host->device copy."""
    from PIL import Image

    raw = np.asarray(Image.open(path))
    if raw.ndim == 3:  # tolerate RGB-saved PNGs
        raw = raw[..., 0]
    timestamps = raw[:, :8].copy().view(np.int64).reshape(-1)
    azimuths = (
        raw[:, 8:10].copy().view(np.uint16).reshape(-1).astype(np.float32)
        / float(cfg.encoder_size)
        * 2.0
        * np.pi
    )
    valid = raw[:, 10] == 255
    bins = cfg.clipped_range_bins
    dtype = np.uint8 if raw_u8 else np.float32
    power = raw[:, 11 : 11 + bins]
    if not raw_u8:
        power = power.astype(np.float32) / 255.0
    padded = np.zeros((cfg.num_azimuths, cfg.polar_width_padded), dtype=dtype)
    padded[:, : power.shape[1]] = power
    stamp = int(os.path.basename(path)[:-4])
    return RadarFrame(padded, azimuths, valid, timestamps, stamp)


def radar_image_paths(data_dir: str, timestamp_file: str) -> List[str]:
    """Radar PNG paths listed by a radar.timestamps file."""
    paths = []
    with open(timestamp_file) as f:
        for line in f:
            parts = line.strip().split(" ")
            if len(parts) >= 2 and parts[1]:
                paths.append(os.path.join(data_dir, parts[0] + ".png"))
    return paths


def sequence_paths(root: str, sequence: str) -> dict:
    """Standard layout: <root>/<sequence>/{radar/, radar.timestamps, gt/, gps/}."""
    base = os.path.join(root, sequence)
    return {
        "radar": os.path.join(base, "radar"),
        "timestamps": os.path.join(base, "radar.timestamps"),
        "gt": os.path.join(base, "gt", "radar_odometry.csv"),
        "gps": os.path.join(base, "gps", "gps.csv"),
    }


def load_gt_trajectory(csv_path: str):
    """Integrate the GT odometry CSV into absolute poses.

    Per row reads (dx, dy, dyaw) at columns (2, 3, 7), keyed by the
    destination radar timestamp (column 9), chains them as planar motions and
    wraps the heading; roll and pitch are ignored.

    Returns (timestamps [N] int64, poses [N, 3] float64, deltas [N, 3] float64).
    """
    rows = np.genfromtxt(csv_path, delimiter=",", skip_header=1)
    dx, dy, dyaw = rows[:, 2], rows[:, 3], rows[:, 7]
    stamps = rows[:, 9].astype(np.int64)
    n = len(stamps)
    poses = np.zeros((n, 3))
    x = y = th = 0.0
    for i in range(n):
        x += dx[i] * np.cos(th) - dy[i] * np.sin(th)
        y += dx[i] * np.sin(th) + dy[i] * np.cos(th)
        th += dyaw[i]
        th = (th + np.pi) % (2 * np.pi) - np.pi
        poses[i] = (x, y, th)
    deltas = np.stack([dx, dy, dyaw], axis=1)
    return stamps, poses, deltas


def load_gps_trajectory(csv_path: str):
    """GPS csv -> (timestamps [N], xy [N, 2] metres anchored at the first fix).

    Metric positions are the UTM northing/easting at columns 8/9 of the
    Oxford gps.csv (easting -> x, northing -> y)."""
    rows = np.genfromtxt(csv_path, delimiter=",", skip_header=1,
                         usecols=(0, 8, 9))
    rows = np.atleast_2d(rows)
    stamps = rows[:, 0].astype(np.int64)
    xy = np.stack([rows[:, 2], rows[:, 1]], axis=1)
    return stamps, xy - xy[0]
