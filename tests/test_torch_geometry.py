"""SE(2) geometry and the polar->Cartesian warps of the PyTorch port against
the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radarslampy_tpu.config import SlamConfig as JaxConfig
from radarslampy_tpu.models.frontend import build_frame_maps as jax_build_frame_maps
from radarslampy_tpu.ops import geometry as jgeo
from radarslampy_tpu.ops import grid as jgrid
from radarslampy_tpu.ops.routed_warp import build_routed_warp_maps, routed_polar_to_cartesian
from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.interop import frame_maps_from_numpy
from radarslampy_tpu_torch.models.frontend import build_frame_maps
from radarslampy_tpu_torch.ops import geometry as geo
from radarslampy_tpu_torch.ops import grid

# The suite runs in several pytest-xdist worker processes on one host; one
# intra-op thread per worker keeps torch from oversubscribing its cores.
torch.set_num_threads(1)

# The JAX package evaluates trig with accurate f32 polynomials (ops/trig.py,
# ~1-2 ulp); the port uses native f32 trig.  Both are within a few ulp of the
# true value, so results agree to a few f32 ulp of O(1..100) quantities.
ATOL = 2e-5
KW = dict(cart_size=256, cart_downsample=16)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=0)


@pytest.fixture(scope="module")
def poses():
    rng = np.random.default_rng(0)
    p = rng.uniform(-50, 50, size=(64, 3)).astype(np.float32)
    p[:, 2] = rng.uniform(-3.1, 3.1, size=64)
    p[:8, 2] = rng.uniform(-1e-6, 1e-6, size=8)  # small-angle series branch
    return p


def test_wrap_rotation_transform(poses):
    th = np.linspace(-20, 20, 101, dtype=np.float32)
    _close(geo.wrap_angle(_t(th)), jgeo.wrap_angle(jnp.asarray(th)))
    _close(geo.rotation_matrix(_t(poses[:, 2])), jgeo.rotation_matrix(jnp.asarray(poses[:, 2])))
    T = geo.pose_to_transform(_t(poses))
    jT = jgeo.pose_to_transform(jnp.asarray(poses))
    _close(T, jT)
    _close(geo.transform_to_pose(T), jgeo.transform_to_pose(jT))
    _close(geo.invert_transform(T), jgeo.invert_transform(jT), atol=1e-4)


def test_se2_exp_log(poses):
    xi = poses / np.array([10.0, 10.0, 1.0], np.float32)
    _close(geo.se2_exp(_t(xi)), jgeo.se2_exp(jnp.asarray(xi)))
    T = geo.pose_to_transform(_t(poses))
    _close(geo.se2_log(T), jgeo.se2_log(jnp.asarray(T.numpy())), atol=1e-4)


@pytest.mark.parametrize("n_live", [0, 1, 40])
def test_procrustes_masked(n_live):
    rng = np.random.default_rng(n_live)
    src = rng.uniform(-60, 60, (64, 2)).astype(np.float32)
    th = 0.3
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]], np.float32)
    tgt = (src - [1.0, -2.0]) @ R + rng.normal(0, 0.05, (64, 2)).astype(np.float32)
    w = np.zeros(64, np.float32)
    w[:n_live] = 1.0
    a = geo.procrustes_masked(_t(src), _t(tgt), _t(w))
    b = jgeo.procrustes_masked(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(w))
    _close(a[0], b[0], atol=1e-5)
    _close(a[1], b[1], atol=1e-4)
    assert bool(a[2]) == bool(b[2])


def test_grid_maps_and_naive_warp(rng):
    cfg, jcfg = SlamConfig(**KW), JaxConfig(**KW)
    maps, jmaps = grid.build_grid_maps(cfg, "cpu"), jgrid.build_grid_maps(jcfg)
    for f in ("cart_az", "cart_rng", "cart_valid"):
        np.testing.assert_array_equal(getattr(maps, f).numpy(), np.asarray(getattr(jmaps, f)))
    polar = rng.random((cfg.num_azimuths, cfg.polar_width_padded)).astype(np.float32)
    # same gathers and lerps; only the float association may differ
    _close(grid.polar_to_cartesian(_t(polar), maps, cfg),
           jgrid.polar_to_cartesian(jnp.asarray(polar), jmaps, jcfg), atol=1e-6)


def test_bilinear_sample_image(rng):
    img = rng.random((40, 56)).astype(np.float32)
    xy = rng.uniform(-3, 60, (7, 9, 2)).astype(np.float32)  # incl. out of bounds
    _close(grid.bilinear_sample_image(_t(img), _t(xy)),
           jgrid.bilinear_sample_image(jnp.asarray(img), jnp.asarray(xy)), atol=1e-6)


@pytest.mark.parametrize("kw", [KW, dict(cart_size=200, cart_downsample=20)])
def test_step_warp_matches_routed_warp(rng, kw):
    cfg, jcfg = SlamConfig(**kw), JaxConfig(**kw)
    polar = rng.random((cfg.num_azimuths, cfg.polar_width_padded)).astype(np.float32)
    ref = np.asarray(routed_polar_to_cartesian(jnp.asarray(polar),
                                               build_routed_warp_maps(jcfg)))
    out = grid.warp_polar_to_cartesian(_t(polar), grid.build_warp_maps(cfg, "cpu")).numpy()
    # identical sample points and lerp order; XLA may fuse multiply-adds
    _close(out, ref, atol=1e-6)
    # and the naive warp, whose sample points are float32: rounding r_px
    # (<= 2^-24 * 2025 bins, ~1.2e-4 bins) and the azimuth likewise moves a
    # sample of this random image (|gradient| <= 1 per bin) by up to ~2.4e-4
    naive = np.asarray(jgrid.polar_to_cartesian(jnp.asarray(polar), jgrid.build_grid_maps(jcfg),
                                                jcfg))
    _close(out, naive, atol=3e-4)


def test_frame_maps_carried_from_jax_equal_the_ports_own():
    cfg, jcfg = SlamConfig(**KW), JaxConfig(**KW)
    own = build_frame_maps(cfg, "cpu")
    carried = frame_maps_from_numpy(jax_build_frame_maps(jcfg), cfg, "cpu")
    for a, b in zip(own.warp, carried.warp):
        if torch.is_tensor(a):
            assert torch.equal(a, b)
    assert torch.equal(own.doh.taps, carried.doh.taps)
    assert own.doh.radii == carried.doh.radii
    assert own.doh.scales == carried.doh.scales
    assert torch.equal(own.logpolar.logpolar_rng, carried.logpolar.logpolar_rng)
    assert own.logpolar.log_base == carried.logpolar.log_base
