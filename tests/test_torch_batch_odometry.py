"""The port's data-parallel segment odometry (`radarslampy_tpu_torch/parallel/
batch_odometry.py`) against the port's sequential step and the JAX package's
`run_segments`.

D = 4 straight segments of T = 4 frames at the 512 px config of
`tests/test_batch_odometry.py`, rendered by that file's `_render_frames`, run
by one spawn of 2 gloo ranks (`tests/torch_dist_ranks.py`): each rank steps
its 2 segments in lock-step and the poses are all-gathered.

Bounds: equal bit for bit to the port's sequential runs (init_state, then
slam_step per frame, one segment after another); within 0.05 m (and rad) of
the JAX package's `run_segments`, the bound JAX's own test sets for the
difference of form (its vmapped step runs both branches of the keyframe
decision, `tests/test_batch_odometry.py`); `join_segments` within 1e-5 of
JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radarslampy_tpu.models.frontend import build_frame_maps as jax_build_frame_maps
from radarslampy_tpu.parallel import batch_odometry as jbo
from radarslampy_tpu.parallel.mesh import make_mesh as jax_make_mesh
from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.interop import slam_states_from_numpy
from radarslampy_tpu_torch.models import frontend
from radarslampy_tpu_torch.parallel.batch_odometry import batched_init, join_segments
from tests.test_batch_odometry import CFG as JAX_CFG
from tests.test_batch_odometry import _render_frames
from tests.torch_dist_ranks import spawn

# The suite runs in several pytest-xdist worker processes on one host; one
# intra-op thread per worker keeps torch from oversubscribing its cores.
torch.set_num_threads(1)

D, T = 4, 4
CFG_KW = dict(cart_size=512, cart_downsample=8, n_candidates=256, anms_top_k=100, k_max=128,
              mds_iterations=6, max_keyframes=64)
SPAWN_S = 240


@pytest.fixture(scope="module")
def frames():
    return _render_frames(None, D, T)


@pytest.fixture(scope="module")
def jax_maps():
    return jax_build_frame_maps(JAX_CFG)


@pytest.fixture(scope="module")
def ranks(frames, tmp_path_factory):
    inputs = dict(cfg=CFG_KW, meshes=("w2",), frames=torch.from_numpy(frames))
    return spawn("batch_odometry", 2, tmp_path_factory.mktemp("batch_odometry"), inputs, SPAWN_S)


@pytest.fixture(scope="module")
def sequential(frames):
    """Each segment through the port's step on its own, one after another."""
    cfg = SlamConfig(**CFG_KW)
    maps = frontend.build_frame_maps(cfg, "cpu")
    out = np.zeros((D, T, 3), np.float32)
    for d in range(D):
        state = frontend.init_state(frames[d, 0], np.zeros(3), maps, cfg)
        for t in range(1, T):
            state, o = frontend.slam_step(state, frames[d, t], maps, cfg)
            out[d, t] = o.pose.numpy()
    return out


def test_config_is_the_jax_tests():
    assert SlamConfig(**CFG_KW) == SlamConfig(**{k: getattr(JAX_CFG, k) for k in CFG_KW})


def test_batched_equals_sequential_bit_for_bit(ranks, sequential):
    for out in ranks:
        assert out["w2"]["poses"].shape == (D, T, 3)
        np.testing.assert_array_equal(out["w2"]["poses"], sequential)


def test_batched_init_matches_jax(frames, jax_maps):
    """The JAX package's batched first states, carried across as a list, and
    the port's `batched_init` on the same frames: the checks of
    tests/test_torch_frontend.py::test_init_state_matches, per segment."""
    cfg = SlamConfig(**CFG_KW)
    carried = slam_states_from_numpy(
        jax.device_get(jbo.batched_init(jnp.asarray(frames[:, 0]), jax_maps, JAX_CFG)), cfg, "cpu")
    ported = batched_init(frames[:, 0], frontend.build_frame_maps(cfg, "cpu"), cfg)
    assert len(carried) == len(ported) == D
    for js, ts in zip(carried, ported):
        np.testing.assert_allclose(ts.prev_cart.numpy(), js.prev_cart.numpy(), atol=1e-6)
        for f in ("feat_mask", "feat_id", "next_id", "frame_idx"):
            assert torch.equal(getattr(ts, f), getattr(js, f)), f
        mask = ts.feat_mask
        assert int(mask.sum()) >= 50   # anms_top_k = 100 at this config
        assert torch.equal(ts.feat_px[mask], js.feat_px[mask])
        np.testing.assert_allclose(ts.feat_world.numpy(), js.feat_world.numpy(), atol=1e-5)
        for f in ("feat_ids", "feat_mask", "cursor", "frame_ids", "pc_mask", "descriptors"):
            assert torch.equal(getattr(ts.map, f), getattr(js.map, f)), f


def test_batched_matches_jax_run_segments(ranks, frames, jax_maps):
    jposes = jbo.run_segments(frames, jax_maps, JAX_CFG, jax_make_mesh(D))
    np.testing.assert_allclose(ranks[0]["w2"]["poses"], jposes, atol=0.05, rtol=0)
    # the segments moved: 2 m a frame along x
    assert np.all(np.diff(ranks[0]["w2"]["poses"][:, :, 0], axis=1) > 1.5)


def test_join_segments_chains_poses():
    a = np.array([[0, 0, 0], [1, 0, 0], [2, 0, np.pi / 2]], np.float64)
    b = np.array([[0, 0, 0], [1, 0, 0]], np.float64)  # forward in its frame
    joined = join_segments([a, b])
    assert joined.shape == (4, 3)
    np.testing.assert_allclose(joined[-1][:2], [2, 1], atol=1e-12)
    np.testing.assert_allclose(joined[-1][2], np.pi / 2, atol=1e-12)


def test_join_segments_matches_jax():
    rng = np.random.default_rng(3)
    segs = [np.cumsum(rng.normal(0, [2.0, 0.5, 0.05], (n, 3)), axis=0) for n in (5, 7, 4)]
    segs = [(s - s[0]).astype(np.float32) for s in segs]
    got = join_segments(segs)
    want = jbo.join_segments(segs)
    assert got.shape == want.shape == (14, 3)
    np.testing.assert_allclose(got, np.asarray(jax.device_get(want)), atol=1e-5, rtol=0)
