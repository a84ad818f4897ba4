"""Synthetic point sets and radar scans for the port's tests and card runs.

The port's copy of `radarslampy_tpu/sim/fakedata.py`, which cannot be
imported without JAX: the point-set generators (`random_points`,
`random_pose`, `apply_pose`, `make_correspondences`, `add_noise`,
`make_outliers`, `distort`) and the scan renderer (`make_world`,
`make_world_corridor`, `render_polar_scan`, `render_sequence`): a world of
point landmarks, each rendered as a Gaussian blob in (azimuth, range) with
optional constant-velocity motion distortion and Rayleigh noise.  Host-side
numpy with a `numpy.random.Generator`, never on the device path; the tests
hold the two copies to identical output.
"""

from __future__ import annotations

import numpy as np

from radarslampy_tpu_torch.config import SlamConfig


def random_points(rng, n, spread=50.0):
    """[N,2] points uniform in a centred square (metres or px as caller wishes)."""
    return rng.uniform(-spread, spread, size=(n, 2))


def random_pose(rng, max_trans=3.0, max_rot=0.3):
    th = rng.uniform(-max_rot, max_rot)
    return np.array([rng.uniform(-max_trans, max_trans),
                     rng.uniform(-max_trans, max_trans), th])


def apply_pose(pose, pts):
    c, s = np.cos(pose[2]), np.sin(pose[2])
    R = np.array([[c, -s], [s, c]])
    return pts @ R.T + pose[:2]


def make_correspondences(rng, n=100, spread=50.0, max_trans=3.0, max_rot=0.3):
    """Ground-truth correspondence pair: new = T(old).

    Returns (old_pts, new_pts, pose) with new_i = R old_i + t.
    """
    old = random_points(rng, n, spread)
    pose = random_pose(rng, max_trans, max_rot)
    new = apply_pose(pose, old)
    return old, new, pose


def add_noise(rng, pts, sigma=0.1):
    return pts + rng.normal(0.0, sigma, size=pts.shape)


def make_outliers(rng, pts, n_outliers, magnitude=10.0):
    """Displace `n_outliers` random points by a large offset; returns (pts, idx)."""
    out = pts.copy()
    idx = rng.choice(len(pts), size=n_outliers, replace=False)
    offs = rng.uniform(magnitude * 0.5, magnitude, size=(n_outliers, 2))
    offs *= rng.choice([-1.0, 1.0], size=(n_outliers, 2))
    out[idx] += offs
    return out, idx


def distort(points, velocity, period=0.25):
    """Ground-truth motion-distortion *forward* model.

    Given ideal instantaneous points (sensor frame at scan time t=0) and a body
    velocity twist, produce what the spinning radar actually records: each point
    is observed at its scan-time offset dt, i.e. moved by the *inverse* of the
    correction `motion.undistort` applies.  Round-tripping through
    `undistort(velocity, distort(p, velocity))` recovers p (to first order in the
    dt re-estimation, exact when dt is computed from the distorted points —
    tests verify the achievable tolerance).
    """
    angles = np.arctan2(-points[:, 1], -points[:, 0])
    dt = period * angles / (2 * np.pi)
    disp = velocity[None, :] * dt[:, None]
    th = disp[:, 2]
    c, s = np.cos(th), np.sin(th)
    # inverse of p' = R(th) p + v dt  ->  p = R(-th) (p' - v dt)
    px = points[:, 0] - disp[:, 0]
    py = points[:, 1] - disp[:, 1]
    x = c * px + s * py
    y = -s * px + c * py
    return np.stack([x, y], axis=1)


def make_world(rng, n_landmarks=400, extent_m=400.0):
    """Random world landmark map: [N,2] positions + [N] reflectivities."""
    pts = rng.uniform(-extent_m, extent_m, size=(n_landmarks, 2))
    refl = rng.uniform(0.4, 1.0, size=n_landmarks)
    return pts, refl


def make_world_corridor(rng, poses, radius_m, per_scan=80.0):
    """Landmarks sampled in a corridor of `radius_m` around a trajectory, so
    a scan sees ~`per_scan` landmarks however long and thin the route: each
    landmark picks a path vertex (weighted by the length of its adjacent
    segments) and a uniform point in the disc around it.

    Returns ([N,2] positions, [N] reflectivities).
    """
    poses = np.asarray(poses, dtype=np.float64)
    seg = np.diff(poses[:, :2], axis=0)
    seg_len = np.linalg.norm(seg, axis=1)
    path_len = float(seg_len.sum())
    # half the length of each adjacent segment, plus a floor so a stationary
    # trajectory still gets samples
    w = np.zeros(len(poses))
    w[:-1] += seg_len / 2
    w[1:] += seg_len / 2
    w += max(path_len, 1.0) * 1e-6
    w /= w.sum()

    corridor_area = path_len * 2 * radius_m + np.pi * radius_m**2
    density = per_scan / (np.pi * radius_m**2)
    n = max(400, int(corridor_area * density))

    centers = poses[rng.choice(len(poses), size=n, p=w), :2]
    r = radius_m * np.sqrt(rng.uniform(0, 1, size=n))
    th = rng.uniform(0, 2 * np.pi, size=n)
    pts = centers + np.stack([r * np.cos(th), r * np.sin(th)], axis=1)
    refl = rng.uniform(0.4, 1.0, size=n)
    return pts.astype(np.float64), refl


def render_polar_scan(world_pts, world_refl, pose, cfg: SlamConfig,
                      velocity=None, noise=0.02, rng=None,
                      blob_sigma_px=2.0, az_sigma=0.6, mode="max"):
    """Render a synthetic polar scan [A, Wpad] of the world from `pose`.

    Each landmark inside the clip range becomes a Gaussian blob in (azimuth,
    range) space: a 9 x 9 patch composed by maximum (`mode="max"`), or an
    untruncated separable Gaussian composed by sum (`mode="sum"`, the host
    mirror of `sim/render_device.py`'s matmul mode).  If `velocity` is
    given, landmarks are shifted by the constant-velocity motion model at
    their scan-time offset — true motion distortion for end-to-end solver
    validation.
    """
    A = cfg.num_azimuths
    Wp = cfg.polar_width_padded
    bins = cfg.clipped_range_bins
    img = np.zeros((A, Wp), dtype=np.float32)

    c, s = np.cos(pose[2]), np.sin(pose[2])
    R_inv = np.array([[c, s], [-s, c]])
    local = (world_pts - pose[:2]) @ R_inv.T  # sensor frame

    if velocity is not None:
        angles = np.arctan2(-local[:, 1], -local[:, 0])
        dt = cfg.scan_period_s * angles / (2 * np.pi)
        disp = velocity[None, :] * dt[:, None]
        th = disp[:, 2]
        cth, sth = np.cos(th), np.sin(th)
        px = local[:, 0] - disp[:, 0]
        py = local[:, 1] - disp[:, 1]
        local = np.stack([cth * px + sth * py, -sth * px + cth * py], axis=1)

    r = np.hypot(local[:, 0], local[:, 1]) / cfg.range_resolution_m
    phi = np.arctan2(local[:, 1], local[:, 0])
    phi = np.where(phi < 0, phi + 2 * np.pi, phi)
    az = phi / (2 * np.pi) * A

    inside = (r > 8) & (r < bins - 8)
    if mode == "sum":
        azs, rs, refls = az[inside], r[inside], world_refl[inside]
        aa = np.arange(A, dtype=np.float64)
        dang = np.abs(aa[None, :] - azs[:, None])
        dang = np.minimum(dang, A - dang)
        Ga = np.exp(-0.5 * (dang / az_sigma) ** 2) * refls[:, None]
        ww = np.arange(Wp, dtype=np.float64)
        Gr = np.exp(-0.5 * ((ww[None, :] - rs[:, None]) / blob_sigma_px) ** 2)
        img = (Ga.T @ Gr).astype(np.float32)
    else:
        half = 4
        offs = np.arange(-half, half + 1)
        for ri, ai, refl in zip(r[inside], az[inside], world_refl[inside]):
            a0 = int(round(ai))
            r0 = int(round(ri))
            da = (a0 + offs) % A
            dr = r0 + offs
            ga = np.exp(-0.5 * ((a0 + offs - ai) / az_sigma) ** 2)
            gr = np.exp(-0.5 * ((r0 + offs - ri) / blob_sigma_px) ** 2)
            patch = refl * ga[:, None] * gr[None, :]
            np.maximum.at(img, (da[:, None], dr[None, :].repeat(len(offs), 0)), patch)

    if noise > 0 and rng is not None:
        img[:, :bins] += rng.rayleigh(noise, size=(A, bins)).astype(np.float32)
    np.clip(img, 0.0, 1.0, out=img)
    img[:, bins:] = 0.0
    return img


def render_sequence(rng, poses, cfg: SlamConfig, n_landmarks=2500,
                    extent_m=None, with_distortion=True, noise=0.02):
    """Render a synthetic scan per pose [T,3]; yields (pose, scan) tuples."""
    if extent_m is None:
        span = np.abs(poses[:, :2]).max() + cfg.max_range_clip_m
        extent_m = float(span)
    world_pts, world_refl = make_world(rng, n_landmarks, extent_m)
    period = cfg.scan_period_s
    for t in range(len(poses)):
        if with_distortion and t > 0:
            dp = poses[t] - poses[t - 1]
            c, s = np.cos(poses[t][2]), np.sin(poses[t][2])
            vel = np.array(
                [c * dp[0] + s * dp[1], -s * dp[0] + c * dp[1], dp[2]]
            ) / period
        else:
            vel = np.zeros(3)
        yield poses[t], render_polar_scan(
            world_pts, world_refl, poses[t], cfg, velocity=vel if with_distortion else None,
            rng=rng, noise=noise,
        )
