"""The port's public helpers that the step does not call, held against the
JAX package's on the same seeded inputs: `ops/geometry.transform_points` and
`rigid_transform_pose`, `ops/features.gaussian_blur` and `doh_response`, and
the point-set generators of `sim/fakedata.py`.

Bounds: the generators equal (both are numpy on one `numpy.random.Generator`
stream); float32 geometry within 1e-4 m on points 50 m out and 1e-6 rad
(the JAX package's Newton-refined atan2 against native atan2); the blur
within 1e-6 (float32 sums in another order over unit-sum taps); DoH within
2e-3 * max|ref| per sigma (tests/test_torch_doh.py: sigma^4 amplifies the
blur's rounding up to 1e4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radarslampy_tpu.config import SlamConfig as JaxConfig
from radarslampy_tpu.ops import features as jfeat
from radarslampy_tpu.ops import geometry as jgeo
from radarslampy_tpu.sim import fakedata as jfd
from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.ops import features, geometry
from radarslampy_tpu_torch.ops.cuda import doh_cuda
from radarslampy_tpu_torch.sim import fakedata as fd
from tests.test_torch_doh import _assert_doh_close, _img

torch.set_num_threads(1)

GENERATORS = {
    "random_points": lambda m, rng: m.random_points(rng, 30, spread=20.0),
    "random_pose": lambda m, rng: m.random_pose(rng, max_trans=2.0, max_rot=0.5),
    "apply_pose": lambda m, rng: m.apply_pose(np.array([1.0, -2.0, 0.3]),
                                              rng.normal(0, 10, (12, 2))),
    "make_correspondences": lambda m, rng: m.make_correspondences(rng, n=40),
    "add_noise": lambda m, rng: m.add_noise(rng, np.ones((8, 2)), sigma=0.2),
    "make_outliers": lambda m, rng: m.make_outliers(rng, np.zeros((20, 2)), 5),
    "distort": lambda m, rng: m.distort(rng.normal(0, 30, (25, 2)),
                                        np.array([8.0, 0.5, 0.2])),
}


@pytest.mark.parametrize("name", list(GENERATORS))
def test_fakedata_generators_equal_jax(name):
    got = GENERATORS[name](fd, np.random.default_rng(42))
    ref = GENERATORS[name](jfd, np.random.default_rng(42))
    got, ref = (x if isinstance(x, tuple) else (x,) for x in (got, ref))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transform_points_matches_jax(seed):
    rng = np.random.default_rng(seed)
    pose = jfd.random_pose(rng, max_trans=30.0, max_rot=3.0).astype(np.float32)
    pts = rng.uniform(-50, 50, (4, 16, 2)).astype(np.float32)
    T = geometry.pose_to_transform(torch.as_tensor(pose))
    got = geometry.transform_points(T, torch.as_tensor(pts)).numpy()
    ref = np.asarray(jgeo.transform_points(jgeo.pose_to_transform(jnp.asarray(pose)),
                                           jnp.asarray(pts)))
    assert got.shape == ref.shape == pts.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, jfd.apply_pose(pose.astype(np.float64), pts),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("case", ["clean", "noisy_outliers_weighted", "degenerate"])
def test_rigid_transform_pose_matches_jax(case):
    rng = np.random.default_rng(3)
    old, new, pose = fd.make_correspondences(rng, n=64, spread=50.0)
    w = np.ones(64, np.float32)
    if case == "noisy_outliers_weighted":
        new = fd.add_noise(rng, new, 0.05)
        new, idx = fd.make_outliers(rng, new, 8)
        w[idx] = 0.0
    elif case == "degenerate":
        w[:] = 0.0
        w[5] = 1.0
    src, tgt = old.astype(np.float32), new.astype(np.float32)
    got, ok = geometry.rigid_transform_pose(*(torch.as_tensor(x) for x in (src, tgt, w)))
    ref, jok = jgeo.rigid_transform_pose(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(w))
    assert bool(ok) == bool(jok) == (case != "degenerate")
    got, ref = got.numpy(), np.asarray(ref)
    np.testing.assert_allclose(got[:2], ref[:2], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[2], ref[2], atol=1e-6, rtol=0)
    if case == "clean":
        # (R, h) maps the new frame onto the old: the inverse of `pose`
        np.testing.assert_allclose(got[2], -pose[2], atol=1e-6)


@pytest.mark.parametrize("sigma", [0.1, 1.0, 2.5, 5.0])
def test_gaussian_blur_matches_jax(sigma):
    img = np.random.default_rng(9).random((48, 64)).astype(np.float32)
    got = features.gaussian_blur(torch.as_tensor(img), sigma).numpy()
    ref = np.asarray(jfeat.gaussian_blur(jnp.asarray(img), sigma))
    assert got.shape == ref.shape == img.shape
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    if sigma < 0.3:
        np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("sigmas", [(1.0, 5.0, 10.0), (0.1, 2.0)])
def test_doh_response_matches_jax(sigmas):
    img = _img(np.random.default_rng(4), 96)
    cfg, jcfg = SlamConfig(doh_sigmas=sigmas), JaxConfig(doh_sigmas=sigmas)
    got = features.doh_response(torch.as_tensor(img), cfg)
    ref = np.asarray(jfeat.doh_response(jnp.asarray(img), jcfg))
    _assert_doh_close(got.numpy(), ref)
    # the same dispatch as doh_cuda.doh_response: the plain twin on the CPU
    filters = doh_cuda.build_doh_filters(sigmas, "cpu")
    before = doh_cuda.launches
    again = features.doh_response(torch.as_tensor(img), cfg, filters)
    assert torch.equal(again, doh_cuda.doh_response(torch.as_tensor(img), filters))
    assert torch.equal(again, got) and doh_cuda.launches == before
