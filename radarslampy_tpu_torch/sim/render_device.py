"""Synthetic polar scans rendered on the tensors' device.

Counterpart of `radarslampy_tpu/sim/render_device.py`: the math of the host
renderer `sim.fakedata.render_polar_scan` (a Gaussian blob per landmark in
(azimuth, range), true constant-velocity motion distortion, Rayleigh speckle)
as plain tensor operations, so the evaluation harness (`evaluation.py`)
renders each frame where its step runs and ships only poses to the device.

Differences in form, not in result:
  * Native fp32 trig and exp (the JAX renderer uses `ops/trig.py`'s
    polynomials, which exist for the TPU's ~1e-4 transcendentals).
  * Noise comes from a `torch.Generator` on the device that the caller seeds
    per frame (`evaluation.frame_seed`), where the JAX renderer takes a
    `jax.random` key; the two streams differ, so the renderers agree only at
    `noise=0`.
  * `"max"` composes the 9 x 9 patches by a scatter-max into the flat image
    (`scatter_reduce_(..., "amax")`); max is order-free, so the result does
    not depend on the order of the device's atomics.
"""

from __future__ import annotations

import math

import torch

from radarslampy_tpu_torch.config import SlamConfig

# Gaussian blob footprint: the host renderer's `half = 4`
# (fakedata.render_polar_scan), so the two renderers are comparable.
_HALF = 4


def render_polar_scan_device(world_pts, world_refl, pose, velocity, generator,
                             cfg: SlamConfig, noise: float = 0.02, k_vis: int = 512,
                             blob_sigma_px: float = 2.0, az_sigma: float = 0.6,
                             mode: str = "max"):
    """Render one synthetic polar scan [A, Wpad] float32 in [0, 1] on the
    device of `world_pts`.

    `world_pts` [N, 2] / `world_refl` [N] are the run's landmarks; `pose` and
    `velocity` [3] the sensor's; `generator` a `torch.Generator` on that
    device (read only when `noise > 0`).  `k_vis` bounds the landmarks
    splatted per scan, selected nearest-first among those inside the clip
    range.

    `mode`:
      * "max" — 9 x 9 truncated Gaussian patches composed by maximum;
      * "sum" — untruncated separable Gaussians composed by sum: the whole
        image is one [A, K] x [K, Wp] matmul in fp32.
    """
    if mode not in ("max", "sum"):
        raise ValueError(f"mode must be 'max' or 'sum', got {mode!r}")
    A = cfg.num_azimuths
    Wp = cfg.polar_width_padded
    bins = cfg.clipped_range_bins
    f32 = torch.float32
    dev = world_pts.device
    two_pi = 2.0 * math.pi

    pose = torch.as_tensor(pose, dtype=f32, device=dev)
    velocity = torch.as_tensor(velocity, dtype=f32, device=dev)
    s, c = torch.sin(pose[2]), torch.cos(pose[2])
    d = world_pts.to(f32) - pose[:2]
    # sensor frame: R(-theta) (world - t)
    local = torch.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1]], dim=1)

    # true motion distortion: the inverse of ops.motion.undistort
    angles = torch.atan2(-local[:, 1], -local[:, 0])
    dt = cfg.scan_period_s * angles / two_pi
    disp = velocity[None, :] * dt[:, None]
    th = disp[:, 2]
    sth, cth = torch.sin(th), torch.cos(th)
    px = local[:, 0] - disp[:, 0]
    py = local[:, 1] - disp[:, 1]
    local = torch.stack([cth * px + sth * py, -sth * px + cth * py], dim=1)

    r = torch.hypot(local[:, 0], local[:, 1]) / cfg.range_resolution_m
    phi = torch.atan2(local[:, 1], local[:, 0])
    phi = torch.where(phi < 0, phi + two_pi, phi)
    az = phi / two_pi * A

    inside = (r > 8) & (r < bins - 8)
    # nearest-first selection of up to k_vis visible landmarks (fixed shape)
    score = torch.where(inside, -r, torch.full_like(r, float("-inf")))
    sel = torch.topk(score, min(k_vis, score.shape[0])).indices
    ok = inside[sel]
    r_s, az_s, refl_s = r[sel], az[sel], world_refl.to(f32)[sel]

    if mode == "sum":
        aa = torch.arange(A, dtype=f32, device=dev)
        da = torch.abs(aa[None, :] - az_s[:, None])
        da = torch.minimum(da, A - da)                                  # azimuth wrap
        Ga = torch.exp(-0.5 * (da / az_sigma) ** 2)                     # [K, A]
        Ga = Ga * torch.where(ok, refl_s, torch.zeros_like(refl_s))[:, None]
        ww = torch.arange(Wp, dtype=f32, device=dev)
        dw = ww[None, :] - torch.clamp(r_s, -1e6, 1e6)[:, None]
        Gr = torch.exp(-0.5 * (dw / blob_sigma_px) ** 2)                # [K, Wp]
        img = Ga.T @ Gr
    else:
        offs = torch.arange(-_HALF, _HALF + 1, dtype=f32, device=dev)   # [9]
        a0 = torch.round(az_s)
        r0 = torch.round(r_s)
        ga = torch.exp(-0.5 * ((a0[:, None] + offs - az_s[:, None]) / az_sigma) ** 2)
        gr = torch.exp(-0.5 * ((r0[:, None] + offs - r_s[:, None]) / blob_sigma_px) ** 2)
        patch = refl_s[:, None, None] * ga[:, :, None] * gr[:, None, :]  # [K, 9, 9]
        patch = torch.where(ok[:, None, None], patch, torch.zeros_like(patch))

        rows = torch.remainder(a0[:, None] + offs, A).to(torch.int64)    # [K, 9]
        cols = r0[:, None] + offs                                        # [K, 9]
        keep = ok[:, None, None] & ((cols >= 0) & (cols < Wp))[:, None, :]
        flat = rows[:, :, None] * Wp + cols.to(torch.int64)[:, None, :]
        # masked landmarks and columns outside [0, Wp) land in one spare
        # cell past the image, dropped below (JAX: mode="drop")
        flat = torch.where(keep, flat, torch.full_like(flat, A * Wp))
        img = torch.zeros(A * Wp + 1, dtype=f32, device=dev)
        img.scatter_reduce_(0, flat.reshape(-1), patch.reshape(-1), reduce="amax")
        img = img[:A * Wp].reshape(A, Wp)

    if noise > 0:
        u = torch.rand((A, bins), generator=generator, dtype=f32, device=dev) * (1.0 - 1e-7)
        rayleigh = noise * torch.sqrt(-2.0 * torch.log1p(-u))
        img[:, :bins] += rayleigh

    img = torch.clamp(img, 0.0, 1.0)
    img[:, bins:] = 0.0
    return img


def quantize_u8(img):
    """The PNG path's u8 quantisation (power decoded as u8/255; the step's
    `_dequantize_polar` inverts it on the device)."""
    return torch.round(torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)
