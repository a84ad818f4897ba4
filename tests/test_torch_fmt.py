"""FMT (`ops/fmt.py`), the log-polar resample and the step with
`use_fmt=True` on the port, held against the JAX package.

Tolerances, measured on these scans: the port's FFT (pocketfft through
torch) and XLA's agree to ~1e-6 on the correlation surface, so the peak is
the same pixel and the sub-pixel shifts differ by ~1e-6 px.  Bounds:
shifts 1e-4 px, rotation 1e-5 rad, scale and peak response 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radarslampy_tpu.config import SlamConfig as JaxConfig
from radarslampy_tpu.models import frontend as JF
from radarslampy_tpu.ops import fmt as jfmt
from radarslampy_tpu.ops import grid as jgrid
from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.interop import frame_maps_from_numpy, slam_state_from_numpy
from radarslampy_tpu_torch.models import frontend as TF
from radarslampy_tpu_torch.ops import fmt, grid
from radarslampy_tpu_torch.sim import fakedata as fd

# The suite runs in several pytest-xdist worker processes on one host; one
# intra-op thread per worker keeps torch from oversubscribing its cores.
torch.set_num_threads(1)

KW = dict(cart_size=256, cart_downsample=16, n_candidates=256, max_keyframes=16)
SHIFT_PX, ROT_RAD, REL = 1e-4, 1e-5, 1e-5


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture(scope="module")
def scans():
    """Scan pairs (prev, curr) of one world: the sensor turned by each angle
    and moved 0.5 m."""
    cfg = SlamConfig(**KW)
    rng = np.random.default_rng(0)
    wp, wr = fd.make_world(rng, 600, 80.0)
    return [(fd.render_polar_scan(wp, wr, np.zeros(3), cfg, rng=rng, noise=0.01),
             fd.render_polar_scan(wp, wr, np.array([0.5, 0.2, rot]), cfg, rng=rng, noise=0.01))
            for rot in (0.0, 0.05, 0.15, -0.3)]


@pytest.mark.parametrize("kw", [KW, {}])
def test_logpolar_maps_and_resample_match_jax(kw, rng):
    cfg, jcfg = SlamConfig(**kw), JaxConfig(**kw)
    maps, jmaps = grid.build_logpolar_map(cfg, "cpu"), jgrid.build_grid_maps(jcfg)
    np.testing.assert_array_equal(maps.logpolar_rng.numpy(), np.asarray(jmaps.logpolar_rng))
    assert maps.log_base == jmaps.log_base
    polar = rng.random((cfg.num_azimuths, cfg.polar_width_padded)).astype(np.float32)
    out = grid.polar_to_logpolar(_t(polar), maps, cfg).numpy()
    ref = np.asarray(jgrid.polar_to_logpolar(jnp.asarray(polar), jmaps, jcfg))
    assert out.shape == ref.shape
    # the same two-tap lerp; XLA may fuse a multiply-add
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


def test_phase_correlate_matches_jax(scans):
    for a, b in scans:
        out = [float(x) for x in fmt.phase_correlate(_t(a), _t(b))]
        ref = [float(x) for x in jfmt.phase_correlate(jnp.asarray(a), jnp.asarray(b))]
        np.testing.assert_allclose(out[:2], ref[:2], atol=SHIFT_PX, rtol=0)
        np.testing.assert_allclose(out[2], ref[2], rtol=REL)


@pytest.mark.parametrize("with_grid", [False, True])
def test_estimate_rotation_fmt_matches_jax(scans, with_grid):
    cfg, jcfg = SlamConfig(**KW), JaxConfig(**KW)
    g = grid.build_logpolar_map(cfg, "cpu") if with_grid else None
    jg = jgrid.build_grid_maps(jcfg) if with_grid else None
    for a, b in scans:
        out = fmt.estimate_rotation_fmt(_t(a), _t(b), cfg, grid=g)
        ref = jfmt.estimate_rotation_fmt(jnp.asarray(a), jnp.asarray(b), jcfg, grid=jg)
        assert abs(float(out.rot_rad) - float(ref.rot_rad)) <= ROT_RAD
        np.testing.assert_allclose(float(out.scale), float(ref.scale), rtol=REL)
        np.testing.assert_allclose(float(out.response), float(ref.response), rtol=REL)
        if not with_grid:
            assert float(out.scale) == 1.0


def test_phase_correlate_recovers_shift(rng):
    """tests/test_fmt_pointcloud.py::test_phase_correlate_recovers_shift on the port."""
    img = rng.random((128, 256)).astype(np.float32)
    shifted = np.roll(img, (5, -9), axis=(0, 1))
    dy, dx, _ = fmt.phase_correlate(_t(img), _t(shifted))
    assert abs(float(dy) - (-5)) < 0.5
    assert abs(float(dx) - 9) < 0.5


def test_phase_correlate_takes_the_first_of_equal_peaks():
    """A zero image correlates to a flat surface: every pixel ties, and the
    first in flat order, (0, 0), must win as jnp.argmax picks it."""
    z = torch.zeros((16, 32))
    dy, dx, _ = fmt.phase_correlate(z, z)
    jdy, jdx, _ = jfmt.phase_correlate(jnp.zeros((16, 32)), jnp.zeros((16, 32)))
    assert (float(dy), float(dx)) == (float(jdy), float(jdx)) == (0.0, 0.0)


def test_fmt_rotation_on_rendered_scans(rng):
    """tests/test_fmt_pointcloud.py::test_fmt_rotation_on_rendered_scans on the port."""
    cfg = SlamConfig()
    world_pts, world_refl = fd.make_world(rng, 600, 80.0)
    rot = 0.15
    a = fd.render_polar_scan(world_pts, world_refl, np.zeros(3), cfg, rng=rng, noise=0.01)
    b = fd.render_polar_scan(world_pts, world_refl, np.array([0.0, 0.0, rot]), cfg,
                             rng=rng, noise=0.01)
    res = fmt.estimate_rotation_fmt(_t(a), _t(b), cfg)
    assert abs(abs(float(res.rot_rad)) - rot) < 0.02


def _u8(scan):
    return np.clip(np.round(scan * 255.0), 0, 255).astype(np.uint8)


def test_fmt_step_from_carried_state():
    """use_fmt=True: both steps start from the JAX state of the frame before.
    1.8 m and 0.1 rad per frame keep the keyframe decisions off their
    thresholds (see tests/test_torch_frontend.py)."""
    kw = dict(KW, use_fmt=True)
    cfg, jcfg = SlamConfig(**kw), JaxConfig(**kw)
    poses = np.zeros((6, 3))
    for t in range(1, 6):
        th = poses[t - 1, 2]
        poses[t] = poses[t - 1] + [1.8 * np.cos(th), 1.8 * np.sin(th), 0.1]
    frames = [_u8(s) for _, s in fd.render_sequence(np.random.default_rng(5), poses, cfg,
                                                    n_landmarks=1200, noise=0.01)]
    jmaps = JF.build_frame_maps(jcfg)
    maps = frame_maps_from_numpy(jmaps, cfg, "cpu")
    jstate = jax.jit(lambda p, m: JF.init_state(p, jnp.zeros(3), m, jcfg))(
        jnp.asarray(frames[0]), jmaps)
    jstep = jax.jit(lambda s, p, m: JF.slam_step(s, p, m, jcfg))
    kinds = set()
    for frame in frames[1:]:
        ts, to = TF.slam_step(slam_state_from_numpy(jstate, cfg, "cpu"), frame, maps, cfg)
        jstate, jo = jstep(jstate, jnp.asarray(frame), jmaps)
        for f in ("is_keyframe", "did_retrack", "n_inliers", "n_tracked", "fit_ok"):
            assert getattr(to, f).item() == np.asarray(getattr(jo, f)).item(), f
        kinds.add((bool(to.is_keyframe), bool(to.did_retrack)))
        assert abs(float(to.fmt_rotation) - float(jo.fmt_rotation)) <= ROT_RAD
        np.testing.assert_allclose(float(to.fmt_scale), float(jo.fmt_scale), rtol=REL)
        # the bound of the step from identical state (test_torch_frontend)
        dp = np.abs(to.pose.numpy() - np.asarray(jo.pose))
        assert dp[:2].max() < 1e-3 and dp[2] < 1e-4, dp
        np.testing.assert_array_equal(ts.feat_mask.numpy(), np.asarray(jstate.feat_mask))
    assert (True, False) in kinds or (True, True) in kinds


def test_fmt_rotation_prior_rescues_fast_turns(rng):
    """tests/test_tracking.py::test_fmt_rotation_prior_rescues_fast_turns on
    the port: at 0.35 rad a frame, the FMT rotation seeding KLT keeps the track
    that the bare pyramid loses."""
    base = SlamConfig(cart_size=512, cart_downsample=8, n_candidates=256,
                      anms_top_k=100, k_max=128, mds_iterations=8)
    turn = 0.35
    poses = np.stack([np.array([0.0, 0.0, turn * t]) for t in range(4)])
    world_pts, world_refl = fd.make_world(rng, 700, 60.0)
    frames = [fd.render_polar_scan(world_pts, world_refl, p, base, rng=rng, noise=0.01)
              for p in poses]

    def run(cfg):
        maps = TF.build_frame_maps(cfg, "cpu")
        state = TF.init_state(frames[0], np.zeros(3), maps, cfg)
        inliers = []
        for f in frames[1:]:
            state, out = TF.slam_step(state, f, maps, cfg)
            inliers.append(int(out.n_inliers))
        return min(inliers), out.pose.numpy()

    inl_off, _ = run(base)
    inl_on, pose_on = run(dataclasses.replace(base, use_fmt=True))
    err_on = abs((pose_on[2] - poses[-1][2] + np.pi) % (2 * np.pi) - np.pi)
    assert inl_on >= 15, f"FMT prior failed to hold the track: {inl_on}"
    assert err_on < 0.05, f"heading error {err_on:.3f} rad with FMT prior"
    assert inl_on >= 3 * max(inl_off, 1), (inl_off, inl_on)
