"""The port's device renderer (`sim/render_device.py`) and its evaluation
chunk (`evaluation.make_eval_chunk`, the device-render path of
`evaluate_sequence`), on the CPU.

The renderer is held against the JAX package's `render_polar_scan_device` at
`noise=0` (the two draw noise from different generators): "sum" has no
rounding, so within 1e-4; "max" rounds each blob centre, and a sub-ulp
difference can move one 9 x 9 patch by a cell, so it is held as
tests/test_render_device.py holds JAX's two renderers (99.5% of pixels
within 1e-3, mean difference under 1e-4); after `quantize_u8` at most 0.5%
of the pixels differ.  The eval's device-render path must give the same
bits for any chunking and after a resume.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radarslampy_tpu.config import SlamConfig as JaxConfig
from radarslampy_tpu.sim import render_device as jrd
from radarslampy_tpu_torch import evaluation
from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.models import frontend as TF
from radarslampy_tpu_torch.sim import fakedata as fd
from radarslampy_tpu_torch.sim.render_device import quantize_u8, render_polar_scan_device
from radarslampy_tpu_torch.utils.checkpoint import load_meta

# The suite runs in several pytest-xdist worker processes on one host; one
# intra-op thread per worker keeps torch from oversubscribing its cores.
torch.set_num_threads(1)

KW = dict(cart_size=512, cart_downsample=8, n_candidates=256, anms_top_k=100, k_max=128,
          max_keyframes=128)
POSE = np.array([5.0, -3.0, 0.4])
VEL = np.array([8.0, 0.5, 0.05])


def _world(seed=3):
    return fd.make_world(np.random.default_rng(seed), 300, 120.0)


def _port(world, pose, vel, cfg, mode, noise=0.0, gen=None):
    wp, wr = world
    return render_polar_scan_device(torch.as_tensor(wp, dtype=torch.float32),
                                    torch.as_tensor(wr, dtype=torch.float32),
                                    torch.as_tensor(pose, dtype=torch.float32),
                                    torch.as_tensor(vel, dtype=torch.float32), gen, cfg,
                                    noise=noise, k_vis=256, mode=mode)


def _jax(world, pose, vel, jcfg, mode):
    wp, wr = world
    return np.asarray(jrd.render_polar_scan_device(
        jnp.asarray(wp, jnp.float32), jnp.asarray(wr, jnp.float32),
        jnp.asarray(pose, jnp.float32), jnp.asarray(vel, jnp.float32),
        jax.random.PRNGKey(0), jcfg, noise=0.0, k_vis=256, mode=mode))


def _assert_renders_agree(a, b, mode):
    d = np.abs(a - b)
    if mode == "sum":
        assert d.max() <= 1e-4, float(d.max())
    else:
        assert np.quantile(d, 0.995) < 1e-3, float(np.quantile(d, 0.995))
        assert d.mean() < 1e-4, float(d.mean())


@pytest.mark.parametrize("mode", ["max", "sum"])
@pytest.mark.parametrize("pose,vel", [(POSE, VEL), (np.zeros(3), np.zeros(3)),
                                      (np.array([-20.0, 7.0, 3.0]), np.array([4.0, -1.0, -0.3]))])
def test_renderer_matches_jax(mode, pose, vel):
    cfg, jcfg = SlamConfig(**KW), JaxConfig(**KW)
    world = _world()
    port = _port(world, pose, vel, cfg, mode).numpy()
    ref = _jax(world, pose, vel, jcfg, mode)
    assert port.shape == ref.shape == (cfg.num_azimuths, cfg.polar_width_padded)
    assert port.dtype == np.float32
    assert (port > 0.1).sum() > 100   # blobs were drawn
    _assert_renders_agree(port, ref, mode)
    q = quantize_u8(torch.from_numpy(port)).numpy()
    qref = np.asarray(jrd.quantize_u8(jnp.asarray(ref)))
    assert (q != qref).mean() <= 5e-3


@pytest.mark.parametrize("mode", ["max", "sum"])
def test_renderer_matches_the_host_renderer(mode):
    """The port's two renderers, as tests/test_render_device.py holds JAX's
    ("sum" there within 2e-3: float32 against float64)."""
    cfg = SlamConfig(**KW)
    world = _world()
    host = fd.render_polar_scan(*world, POSE, cfg, velocity=VEL, noise=0.0, rng=None, mode=mode)
    port = _port(world, POSE, VEL, cfg, mode).numpy()
    d = np.abs(port - host)
    if mode == "sum":
        assert d.max() < 2e-3, float(d.max())
    else:
        _assert_renders_agree(port, host, mode)


def test_renderer_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        _port(_world(), POSE, VEL, SlamConfig(**KW), "mean")


def _generator(seed, fid):
    g = torch.Generator()
    g.manual_seed(evaluation.frame_seed(seed, fid))
    return g


def test_noise_is_rayleigh_and_deterministic_per_frame():
    """Rayleigh(0.02) noise on the clipped bins only, the same for the same
    (seed, frame), another for another frame; its mean within 2% of
    0.02 * sqrt(pi / 2).  The world lies out of range, so the image is the
    noise alone."""
    cfg = SlamConfig(**KW)
    far = (np.full((10, 2), 1e4), np.full(10, 0.5))
    a = _port(far, np.zeros(3), np.zeros(3), cfg, "max", 0.02, _generator(7, 5))
    b = _port(far, np.zeros(3), np.zeros(3), cfg, "max", 0.02, _generator(7, 5))
    c = _port(far, np.zeros(3), np.zeros(3), cfg, "max", 0.02, _generator(7, 6))
    bins = cfg.clipped_range_bins
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert torch.all(a[:, bins:] == 0)
    assert torch.all(a[:, :bins] > 0)
    mean = float(a[:, :bins].double().mean())
    assert abs(mean / (0.02 * np.sqrt(np.pi / 2)) - 1) < 0.02, mean
    assert evaluation.frame_seed(7, 5) != evaluation.frame_seed(8, 5)


def test_quantize_roundtrip():
    cfg = SlamConfig(**KW)
    img = _port(_world(0), np.zeros(3), np.zeros(3), cfg, "max", 0.02, _generator(1, 1))
    q = quantize_u8(img)
    assert q.dtype == torch.uint8
    assert float((q.float() / 255.0 - img).abs().max()) <= 0.5 / 255.0 + 1e-6


def _init(cfg, world):
    maps = TF.build_frame_maps(cfg, "cpu")
    scan0 = fd.render_polar_scan(*world, np.zeros(3), cfg, rng=np.random.default_rng(0),
                                 noise=0.02)
    return maps, TF.init_state(scan0, np.zeros(3), maps, cfg)


def _leaves(state):
    return list(state[:-2]) + list(state.map) + [state.frame_idx]


def test_eval_chunk_padded_tail_leaves_the_state_unchanged():
    """Frames with valid=False neither render nor step: a chunk of two real
    frames and two pads ends in the state of the two frames alone, and the
    pads' rows echo that state's pose with zeros for [n_inliers, fit_ok,
    did_retrack]; a chunk of pads only leaves the state as it was."""
    cfg = SlamConfig(**KW)
    world = _world(0)
    maps, state = _init(cfg, world)
    wp = torch.as_tensor(world[0], dtype=torch.float32)
    wr = torch.as_tensor(world[1], dtype=torch.float32)
    chunk = evaluation.make_eval_chunk(cfg, noise=0.02)
    poses = np.array([[1.5, 0.1, 0.02], [3.0, 0.3, 0.04], [0, 0, 0], [0, 0, 0]], np.float32)
    vels = np.array([[6.0, 0.4, 0.08]] * 2 + [[0, 0, 0]] * 2, np.float32)
    fids = np.array([1, 2, 2, 2], np.int32)

    s2, rows2 = chunk(state, poses[:2], vels[:2], fids[:2], np.ones(2, bool), 0, wp, wr, maps)
    s4, rows4 = chunk(state, poses, vels, fids, np.array([1, 1, 0, 0], bool), 0, wp, wr, maps)
    assert rows4.shape == (4, 6) and rows4.dtype == torch.float32
    assert torch.equal(rows4[:2], rows2)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(s4), _leaves(s2)))
    assert torch.equal(rows4[2:, :3], s2.pose.expand(2, 3))
    assert torch.all(rows4[2:, 3:] == 0)

    s0, rows0 = chunk(state, poses, vels, fids, np.zeros(4, bool), 0, wp, wr, maps)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(s0), _leaves(state)))
    assert torch.equal(rows0[:, :3], state.pose.expand(4, 3))
    assert torch.all(rows0[:, 3:] == 0)


# ---- the device-render eval: chunking and resume ----
# 17 frames of a circle of 40 frames a turn with 2.2 m chords, the speed
# ramped up over the first 4 frames: from rest, a first step of 2.2 m (8.8
# m/s of motion distortion against a zero velocity prior) leaves the step's
# inlier count at the min_inliers_accept gate, so whether it coasts is a
# toss-up; the ramp keeps that step clear of it.
N_EVAL = 17


def ramp_circle(n, per_turn=40, chord=2.2, ramp=4):
    radius = chord / (2 * np.sin(np.pi / per_turn))
    dth = 2 * np.pi / per_turn * np.minimum(1.0, np.arange(1, n) / ramp)
    th = np.concatenate([[0.0], np.cumsum(dth)])
    return np.stack([radius * np.sin(th), radius * (1 - np.cos(th)), th], 1)


def _eval(chunk_frames, **kw):
    return evaluation.evaluate_sequence(ramp_circle(N_EVAL), SlamConfig(**KW), seed=4,
                                        noise=0.02, chunk_frames=chunk_frames,
                                        return_state=True, device="cpu", **kw)


def _same(a, b):
    assert np.array_equal(a.est_frames, b.est_frames)
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a.final_state),
                                                 _leaves(b.final_state)))
    for f in ("frames", "n_keyframes", "ate_odometry", "mean_inliers", "frac_fit_ok",
              "n_retracks", "rpe_trans_pct", "rpe_rot_deg_100m", "heading_rmse_deg"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.fixture(scope="module")
def chunked(tmp_path_factory):
    """Chunks of 16 (one chunk), 8 (a checkpoint after the first of two) and
    13 (a padded tail of 10), and a copy of the chunk-8 run's checkpoint."""
    ck = str(tmp_path_factory.mktemp("eval_ck") / "ck")
    runs = {16: _eval(16), 8: _eval(8, ckpt_dir=ck, ckpt_every=8), 13: _eval(13)}
    return runs, ck


def test_device_render_eval_is_chunk_invariant(chunked):
    runs, _ = chunked
    r = runs[16]
    assert r.frames == N_EVAL and r.n_keyframes >= 3
    assert np.isfinite(r.est_frames).all() and r.ate_odometry < 1.5
    assert r.frac_fit_ok == 1.0
    _same(runs[8], r)
    _same(runs[13], r)


def test_device_render_eval_resumes_bit_for_bit(chunked, tmp_path):
    runs, ck = chunked
    snap = str(tmp_path / "snap")
    shutil.copytree(ck, snap)
    meta = load_meta(snap)
    assert meta["next_t"] == 9 and meta["chunk_frames"] == 8 and meta["seed"] == 4
    with np.load(os.path.join(snap, "eval_results.npz")) as rz:
        assert rz["blocks"].shape == (1, 8, 6) and list(rz["valid"]) == [8]
    resumed = _eval(8, ckpt_dir=snap, resume=True)
    _same(resumed, runs[8])
    with pytest.raises(ValueError, match="refusing to resume"):
        evaluation.evaluate_sequence(ramp_circle(N_EVAL), SlamConfig(**KW), seed=5,
                                     chunk_frames=8, ckpt_dir=snap, resume=True,
                                     device="cpu")
