"""The port's place recognition (`radarslampy_tpu_torch/models/placerecog.py`)
against the JAX package's, on seeded numpy descriptors and clouds.

Bounds: ring keys within 1e-6; the best circular shift equal and its
similarity within 1e-6; appearance candidates (full and block) with `i`, `j`
and `valid` equal, distance and `rot_init` within 1e-6, including planted
exact ties (duplicate keyframes) broken the same way; the M2DP descriptor and
angle within 1e-5; M2DP retrieval indices and flags equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radarslampy_tpu.models import placerecog as jpr
from radarslampy_tpu_torch.models import placerecog as tpr
from radarslampy_tpu_torch.models.frontend import MapState
from tests.test_placerecog import _cloud

# The suite runs in several pytest-xdist worker processes on one host; one
# intra-op thread per worker keeps torch from oversubscribing its cores.
torch.set_num_threads(1)

R, S = 16, 80


def _t(x):
    return torch.from_numpy(np.array(x))


def _descriptors(seed=3, M=48, live=44):
    """Random scan-context descriptors with planted revisits (a rolled and
    slightly noisy copy of an earlier keyframe) and exact duplicates (two
    keyframes with the same descriptor, so their pair scores tie)."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0, 1, (M, R, S)).astype(np.float32) ** 3
    for i, j, shift in ((2, 30, 7), (5, 36, -12), (9, 41, 33)):
        d[j] = np.roll(d[i], shift, axis=1) + rng.normal(0, 0.01, (R, S)).astype(np.float32)
    d[31] = d[30]      # duplicates: (2, 30) and (2, 31) tie exactly
    d[12] = d[11]
    d[live:] = 0.0
    return np.clip(d, 0, None), live


def test_ring_key_and_alignment_match_jax():
    d, _ = _descriptors()
    np.testing.assert_allclose(tpr.ring_key(_t(d)).numpy(), np.asarray(jpr.ring_key(d)),
                               atol=1e-6, rtol=0)
    for a, b in ((2, 30), (5, 36), (9, 41), (0, 1), (11, 12)):
        sim, k, rot = tpr.sc_alignment(_t(d[a]), _t(d[b]))
        jsim, jk, jrot = jpr.sc_alignment(d[a], d[b])
        assert int(k) == int(jk)
        assert float(sim) == pytest.approx(float(jsim), abs=1e-6)
        assert float(rot) == pytest.approx(float(jrot), abs=1e-6)
        assert float(tpr.sc_distance(_t(d[a]), _t(d[b]))) == pytest.approx(
            float(jpr.sc_distance(d[a], d[b])), abs=1e-6)
    # batched over pairs, as the candidate search calls it
    sims, ks, _ = tpr.sc_alignment(_t(d[[2, 5, 9]]), _t(d[[30, 36, 41]]))
    assert ks.tolist() == [int(jpr.sc_alignment(d[a], d[b])[1])
                           for a, b in ((2, 30), (5, 36), (9, 41))]


def _same(a, b):
    for f in ("i", "j", "valid"):
        np.testing.assert_array_equal(getattr(a, f).numpy(), np.asarray(getattr(b, f)), f)
    fin = np.isfinite(np.asarray(b.distance))
    np.testing.assert_array_equal(np.isfinite(a.distance.numpy()), fin)
    np.testing.assert_allclose(a.distance.numpy()[fin], np.asarray(b.distance)[fin],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(a.rot_init.numpy(), np.asarray(b.rot_init), atol=1e-6, rtol=0)


@pytest.mark.parametrize("prefilter", [4, 1])
def test_appearance_candidates_match_jax(prefilter):
    d, live = _descriptors()
    kw = dict(max_candidates=8, min_index_gap=10, max_distance=0.35, prefilter=prefilter)
    a = tpr.find_candidates_appearance(_t(d), torch.tensor(live), **kw)
    b = jpr.find_candidates_appearance(jnp.asarray(d), jnp.int32(live), **kw)
    _same(a, b)
    found = {(int(i), int(j)) for i, j, v in zip(a.i, a.j, a.valid) if v}
    assert {(2, 30), (2, 31), (5, 36), (9, 41)} <= found, found


@pytest.mark.parametrize("lo", [0, 24, 40])
def test_appearance_block_matches_jax(lo):
    d, live = _descriptors()
    kw = dict(block=16, max_candidates=4, min_index_gap=10, max_distance=0.35)
    a = tpr.find_candidates_appearance_block(_t(d), torch.tensor(live), lo, **kw)
    b = jpr.find_candidates_appearance_block(jnp.asarray(d), jnp.int32(live), jnp.int32(lo),
                                             **kw)
    _same(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_m2dp_descriptor_matches_jax(seed):
    rng = np.random.default_rng(seed)
    pts, mask = _cloud(rng, n=150)
    mask[rng.random(150) < 0.2] = False
    a = tpr.m2dp_descriptor(_t(pts), _t(mask))
    b = jpr.m2dp_descriptor(jnp.asarray(pts), jnp.asarray(mask))
    np.testing.assert_allclose(a.desc.numpy(), np.asarray(b.desc), atol=1e-5, rtol=0)
    assert float(a.angle) == pytest.approx(float(b.angle), abs=1e-5)


def _cloud_map(rng, M=12, K=64, P=96):
    """A map whose keyframes hold a point cloud (even rows) or only a feature
    cloud (odd rows: the 'auto' source falls back to the features)."""
    pc = rng.normal(0, 20, (M, P, 2)).astype(np.float32) * [2.5, 1.0]
    feat = rng.normal(0, 15, (M, K, 2)).astype(np.float32) * [1.0, 2.0]
    pc_mask = np.zeros((M, P), bool)
    pc_mask[::2, :70] = True
    feat_mask = rng.random((M, K)) < 0.8
    z = np.zeros
    return dict(poses=z((M, 3), np.float32), feat_world=z((M, K, 2), np.float32),
                feat_local=feat.astype(np.float32), feat_ids=np.full((M, K), -1, np.int32),
                feat_mask=feat_mask, velocities=z((M, 3), np.float32), cursor=np.int32(M),
                descriptors=z((M, R, S), np.float32), pc_local=pc.astype(np.float32),
                pc_mask=pc_mask, frame_ids=np.arange(M, dtype=np.int32))


@pytest.mark.parametrize("source", ["auto", "pointcloud", "features"])
def test_m2dp_from_map_matches_jax(source):
    from radarslampy_tpu.models.frontend import MapState as JaxMapState

    fields = _cloud_map(np.random.default_rng(4))
    a = tpr.m2dp_from_map(MapState(**{k: _t(v) for k, v in fields.items()}),
                          source=source, chunk=5)
    b = jpr.m2dp_from_map(JaxMapState(**{k: jnp.asarray(v) for k, v in fields.items()}),
                          source=source)
    keep = fields["pc_mask"].any(1) | (source != "pointcloud")   # empty clouds: no signal
    np.testing.assert_allclose(a.desc.numpy()[keep], np.asarray(b.desc)[keep], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(a.angle.numpy()[keep], np.asarray(b.angle)[keep], atol=1e-5,
                               rtol=0)


def test_m2dp_retrieval_matches_jax():
    """30 scenes, scene 25 revisits scene 2 rotated, scene 27 duplicates
    scene 14 exactly (a tie)."""
    rng = np.random.default_rng(11)
    clouds = [_cloud(rng)[0] for _ in range(30)]
    th = 0.7
    c, s = np.cos(th), np.sin(th)
    clouds[25] = (clouds[2] + rng.normal(0, 0.3, clouds[2].shape).astype(np.float32)) \
        @ np.array([[c, s], [-s, c]], np.float32)
    clouds[27] = clouds[14]
    pts = np.stack(clouds).astype(np.float32)
    mask = np.ones(pts.shape[:2], bool)
    r = tpr.m2dp_descriptor(_t(pts), _t(mask))
    jr = jnp.stack([jpr.m2dp_descriptor(jnp.asarray(p), jnp.asarray(m)).desc
                    for p, m in zip(pts, mask)])
    jang = jnp.stack([jpr.m2dp_descriptor(jnp.asarray(p), jnp.asarray(m)).angle
                      for p, m in zip(pts, mask)])
    np.testing.assert_allclose(r.desc.numpy(), np.asarray(jr), atol=1e-5, rtol=0)
    # retrieval on the same descriptors, so a tie is a tie on both sides
    kw = dict(max_candidates=6, min_index_gap=5)
    a = tpr.find_candidates_m2dp(_t(np.asarray(jr)), _t(np.asarray(jang)), torch.tensor(30),
                                 **kw)
    b = jpr.find_candidates_m2dp(jr, jang, jnp.int32(30), **kw)
    _same(a, b)
    pairs = {(int(i), int(j)) for i, j, v in zip(a.i, a.j, a.valid) if v}
    assert {(2, 25), (14, 27)} <= pairs, pairs
