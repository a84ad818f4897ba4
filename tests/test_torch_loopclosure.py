"""The port's loop closure (`radarslampy_tpu_torch/models/loopclosure.py`)
against the JAX package's, on a seeded synthetic map: a square loop of
keyframes whose last leg returns to the start, drifted pose estimates, and
per keyframe the sensor-frame features, point cloud and scan-context-style
descriptor of the world points around its true pose.

Bounds: trimmed maps, candidates (with a planted exact tie), loop `ok` flags,
match counts and graph edges equal; ICP relative poses within 1e-4 m and
1e-5 rad; the ICP radii equal to `jnp.geomspace`'s float32 values; the
re-anchored state of `incremental_backend` within 1e-4 (m and rad).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radarslampy_tpu.config import SlamConfig as JaxConfig
from radarslampy_tpu.models import loopclosure as jlc
from radarslampy_tpu.models.frontend import MapState as JaxMapState
from radarslampy_tpu.models.frontend import SlamState as JaxSlamState
from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.interop import backend_state_from_numpy, slam_state_from_numpy
from radarslampy_tpu_torch.models import loopclosure as tlc
from radarslampy_tpu_torch.models.frontend import MapState
from tests.test_loopclosure import _local_view

# The suite runs in several pytest-xdist worker processes on one host; one
# intra-op thread per worker keeps torch from oversubscribing its cores.
torch.set_num_threads(1)

M_CAP, K, P, N_KF = 64, 64, 96, 38
REL_M, REL_RAD = 1e-4, 1e-5
KW = dict(max_keyframes=M_CAP, k_max=K, pc_points_per_kf=P, pg_iterations=20)


def _descriptor(local, R=16, S=80, max_range=40.0):
    """Ring x sector occupancy of sensor-frame points, max-normalised."""
    r = np.linalg.norm(local, axis=1)
    a = np.mod(np.arctan2(local[:, 1], local[:, 0]), 2 * np.pi)
    keep = r < max_range
    d = np.zeros((R, S), np.float32)
    np.add.at(d, ((r[keep] / max_range * R).astype(int),
                  (a[keep] / (2 * np.pi) * S).astype(int) % S), 1.0)
    return d / max(d.max(), 1.0)


def _square_loop_map(seed=0, drift=0.8):
    """N_KF keyframes on a square loop (4 m steps, 9 a side) that returns to
    its start (keyframe 36 at keyframe 0's place, one turn later); estimates
    drift linearly; keyframe 37 sits exactly on keyframe 36 (a duplicate, so
    their candidate scores tie)."""
    rng = np.random.default_rng(seed)
    gt, pose = [], np.zeros(3)
    for leg in range(4):
        for _ in range(9):
            gt.append(pose.copy())
            pose[:2] += np.array([np.cos(pose[2]), np.sin(pose[2])]) * 4.0
        pose[2] += np.pi / 2
    gt = np.array(gt + [pose.copy(), pose.copy()])
    est = gt.copy()
    est[:, 0] += np.linspace(0, drift, N_KF)
    est[:, 1] += np.linspace(0, drift * 0.5, N_KF)
    est[-1] = est[-2]
    world = rng.uniform(-30, 60, (600, 2))
    f = dict(poses=np.zeros((M_CAP, 3), np.float32),
             feat_world=np.zeros((M_CAP, K, 2), np.float32),
             feat_local=np.zeros((M_CAP, K, 2), np.float32),
             feat_ids=np.full((M_CAP, K), -1, np.int32),
             feat_mask=np.zeros((M_CAP, K), bool),
             velocities=np.zeros((M_CAP, 3), np.float32), cursor=np.int32(N_KF),
             descriptors=np.zeros((M_CAP, 16, 80), np.float32),
             pc_local=np.zeros((M_CAP, P, 2), np.float32),
             pc_mask=np.zeros((M_CAP, P), bool),
             frame_ids=np.full(M_CAP, -1, np.int32))
    f["poses"][:N_KF] = est
    f["frame_ids"][:N_KF] = np.arange(N_KF)
    for m in range(N_KF):
        d = np.linalg.norm(world - gt[m, :2], axis=1)
        near = np.argsort(d)
        f["feat_local"][m, :K // 2] = _local_view(gt[m], world[near[:K // 2]])
        f["feat_mask"][m, :K // 2] = True
        f["feat_ids"][m, :K // 2] = near[:K // 2]
        f["pc_local"][m, :P - 16] = _local_view(gt[m], world[near[:P - 16]])
        f["pc_mask"][m, :P - 16] = True
        f["descriptors"][m] = _descriptor(_local_view(gt[m], world[near[:200]]))
        c, s = np.cos(est[m, 2]), np.sin(est[m, 2])
        loc = f["feat_local"][m]
        f["feat_world"][m] = (np.stack([c * loc[:, 0] - s * loc[:, 1], s * loc[:, 0]
                                        + c * loc[:, 1]], 1) + est[m, :2]) \
            * f["feat_mask"][m][:, None]
    return f, gt


@pytest.fixture(scope="module")
def maps():
    f, gt = _square_loop_map()
    return (MapState(**{k: torch.from_numpy(np.array(v)) for k, v in f.items()}),
            JaxMapState(**{k: jnp.asarray(v) for k, v in f.items()}), gt)


def test_icp_radii_equal_jax_geomspace():
    for r, it in ((2.0, 10), (1.5, 7)):
        jr = np.asarray(jnp.geomspace(4.0 * r, r, it).astype(jnp.float32))
        mine = np.array(tlc.icp_radii(r, it), np.float32)
        if (r, it) == (2.0, 10):
            np.testing.assert_array_equal(mine, jr)      # the default, used by verify
        else:
            np.testing.assert_allclose(mine, jr, rtol=1e-6)


def test_trim_map_state_equal(maps):
    tm, jm, _ = maps
    a = tlc.trim_map_state(tm, pad_multiple=16)
    b = jlc.trim_map_state(jm, pad_multiple=16)
    for f in MapState._fields:
        np.testing.assert_array_equal(getattr(a, f).numpy(), np.asarray(getattr(b, f)), f)
    a = tlc.trim_map_state_device(tm, N_KF, pad_multiple=128)
    b = jlc.trim_map_state_device(jm, N_KF, pad_multiple=128)
    for f in MapState._fields:
        np.testing.assert_array_equal(getattr(a, f).numpy(), np.asarray(getattr(b, f)), f)


def _same_candidates(a, b):
    for f in ("i", "j", "valid"):
        np.testing.assert_array_equal(getattr(a, f).numpy(), np.asarray(getattr(b, f)), f)


@pytest.mark.parametrize("nms", [3, 0])
def test_find_candidates_equal(maps, nms):
    tm, jm, _ = maps
    kw = dict(radius_m=8.0, min_index_gap=20, nms_window=nms)
    a = tlc.find_candidates(tm.poses, tm.cursor, 16, **kw)
    b = jlc.find_candidates(jm.poses, jm.cursor, 16, **kw)
    _same_candidates(a, b)
    pairs = [(int(i), int(j)) for i, j, v in zip(a.i, a.j, a.valid) if v]
    if nms == 0:   # the duplicate keyframes 36 and 37 tie with every partner
        assert (0, 36) in pairs and (0, 37) in pairs
        assert pairs.index((0, 36)) == pairs.index((0, 37)) - 1


@pytest.mark.parametrize("lo", [0, 24, 30])
def test_find_candidates_block_equal(maps, lo):
    tm, jm, _ = maps
    kw = dict(radius_m=8.0, min_index_gap=20)
    a = tlc.find_candidates_block(tm.poses, tm.cursor, lo, 8, 8, **kw)
    b = jlc.find_candidates_block(jm.poses, jm.cursor, jnp.int32(lo), 8, 8, **kw)
    _same_candidates(a, b)


def _same_match(a, b):
    np.testing.assert_array_equal(a.n_matches.numpy(), np.asarray(b.n_matches))
    np.testing.assert_array_equal(a.ok.numpy(), np.asarray(b.ok))
    rel, jrel = a.rel_pose.numpy(), np.asarray(b.rel_pose)
    np.testing.assert_allclose(rel[..., :2], jrel[..., :2], atol=REL_M, rtol=0)
    np.testing.assert_allclose(rel[..., 2], jrel[..., 2], atol=REL_RAD, rtol=0)
    np.testing.assert_allclose(a.residual.numpy(), np.asarray(b.residual), atol=REL_M, rtol=0)


def test_icp_align_equal(rng):
    pts_j = rng.uniform(-30, 30, (K, 2)).astype(np.float32)
    rel = np.array([2.0, -1.0, 0.2], np.float32)
    c, s = np.cos(rel[2]), np.sin(rel[2])
    pts_i = (pts_j @ np.array([[c, -s], [s, c]]).T + rel[:2]).astype(np.float32)
    pts_i[40:] = rng.uniform(-80, -50, (K - 40, 2))
    mask_i = np.ones(K, bool)
    mask_j = rng.random(K) < 0.9
    for init in (rel + [0.5, 0.5, 0.05], rel + [-1.5, 1.0, -0.15]):
        init = init.astype(np.float32)
        a = tlc.icp_align(*(torch.from_numpy(x) for x in (pts_i, mask_i, pts_j, mask_j, init)))
        b = jlc.icp_align(pts_i, mask_i, pts_j, mask_j, init)
        _same_match(a, b)
        assert bool(a.ok)


@pytest.mark.parametrize("rot", [None, 0.03])
def test_verify_candidate_equal(maps, rot):
    """The loop pairs (start vs end) and a non-revisit pair, one at a time
    and batched."""
    tm, jm, _ = maps
    cfg, jcfg = SlamConfig(**KW), JaxConfig(**KW)
    pairs = [(0, 36), (1, 37), (0, 35), (3, 20)]
    singles = []
    for i, j in pairs:
        ro = None if rot is None else torch.tensor(rot)
        a = tlc.verify_candidate(tm, torch.tensor(i), torch.tensor(j), cfg, rot_override=ro)
        b = jlc.verify_candidate(jm, jnp.int32(i), jnp.int32(j), jcfg,
                                 rot_override=None if rot is None else jnp.float32(rot))
        _same_match(a, b)
        singles.append(a)
    ci, cj = (torch.tensor(x) for x in zip(*pairs))
    batched = tlc.verify_candidate(tm, ci, cj, cfg, rot_override=None if rot is None
                                   else torch.full((len(pairs),), rot))
    for f, x in zip(tlc.LoopMatch._fields, batched):   # batching reorders float sums only
        torch.testing.assert_close(x, torch.stack([getattr(a, f) for a in singles]),
                                   atol=1e-6, rtol=0, msg=f)
    # the revisits verify; the pair 17 keyframes apart on another leg does not
    # (with the rotation prior only (0, 36) and (1, 37) keep their heading)
    assert batched.ok[:2].all() and not batched.ok[3]
    assert bool(batched.ok[2]) == (rot is None)


@pytest.fixture(scope="module")
def closed(maps):
    tm, jm, _ = maps
    cfg, jcfg = SlamConfig(**KW), JaxConfig(**KW)
    out = {}
    for method in ("pose", "appearance", "m2dp", "both"):
        a = tlc.close_loops(tm, cfg, max_candidates=8, radius_m=8.0, method=method)
        b = jlc.close_loops(jm, jcfg, max_candidates=8, radius_m=8.0, method=method)
        out[method] = (a, b)
    return out


@pytest.mark.parametrize("method", ["pose", "appearance", "m2dp", "both"])
def test_close_loops_equal(closed, method):
    (g, matches), (jg, jmatches) = closed[method]
    np.testing.assert_array_equal(matches.ok.numpy(), np.asarray(jmatches.ok))
    ok = matches.ok.numpy()
    assert ok.sum() >= 1, method
    for f in ("edges_ij", "edge_mask", "node_mask", "edges_info"):
        np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(jg, f)), f)
    meas, jmeas = g.edges_meas.numpy(), np.asarray(jg.edges_meas)
    live = g.edge_mask.numpy()
    np.testing.assert_allclose(meas[live, :2], jmeas[live, :2], atol=REL_M, rtol=0)
    np.testing.assert_allclose(meas[live, 2], jmeas[live, 2], atol=REL_RAD, rtol=0)


@pytest.mark.parametrize("method", ["pose", "appearance", "both"])
def test_scan_new_loops_over_a_growing_cursor(maps, method):
    tm, jm, _ = maps
    cfg, jcfg = SlamConfig(**KW), JaxConfig(**KW)
    kw = dict(block=8, per_block_budget=8, method=method, radius_m=8.0)
    prev, total = 0, 0
    for cur in (12, 26, 37, N_KF):
        a = tlc.scan_new_loops(tlc.trim_map_state(tm._replace(cursor=torch.tensor(cur)),
                                                  pad_multiple=64), cfg, prev, **kw)
        b = jlc.scan_new_loops(jlc.trim_map_state(jm._replace(cursor=jnp.int32(cur)),
                                                  pad_multiple=64), jcfg, prev, **kw)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[0].dtype == np.int32 and a[1].dtype == np.float32
        np.testing.assert_allclose(a[1][:, :2], b[1][:, :2], atol=REL_M, rtol=0)
        np.testing.assert_allclose(a[1][:, 2], b[1][:, 2], atol=REL_RAD, rtol=0)
        prev, total = cur, total + len(a[0])
    assert total >= 1


def _slam_state(m):
    """A JAX SlamState around map `m`, its running pose at the last keyframe
    and a few live features."""
    n = int(m.cursor)
    feat = np.zeros((K, 2), np.float32)
    feat[:5] = np.arange(10, dtype=np.float32).reshape(5, 2)
    mask = np.zeros(K, bool)
    mask[:5] = True
    pose = np.asarray(m.poses[n - 1]) + np.float32([0.7, -0.2, 0.05])
    return JaxSlamState(
        pose=jnp.asarray(pose), velocity=jnp.zeros(3), prev_polar=jnp.zeros((4, 4)),
        prev_cart=jnp.zeros((4, 4)), feat_px=jnp.zeros((K, 2)),
        feat_mask=jnp.asarray(mask), feat_id=jnp.full(K, -1, jnp.int32),
        next_id=jnp.int32(0), feat_world=jnp.asarray(feat), kf_pose=m.poses[n - 1],
        map=m, frame_idx=jnp.int32(n))


def test_incremental_backend_equal_and_state_round_trip(maps):
    """Two passes over a growing map, each from the carried JAX backend
    state: the same new edges; the re-anchored state within 1e-4; a pass
    with no new keyframe returns the state unchanged."""
    tm, jm, gt = maps
    # the pass pads the map to 1024 rows, so each LM iteration is a dense
    # 3072 x 3072 solve in both packages: 5 iterations keep the test short
    kw = dict(KW, loop_method="pose", pg_iterations=5)
    cfg, jcfg = SlamConfig(**kw), JaxConfig(**kw)
    bs, jbs = tlc.BackendState(), jlc.BackendState()
    for cur in (37, N_KF):
        jstate = _slam_state(jm._replace(cursor=jnp.int32(cur)))
        state = slam_state_from_numpy(jax.device_get(jstate), cfg, "cpu")
        st2, n, cost, bs2 = tlc.incremental_backend(state, cfg,
                                                    backend_state=backend_state_from_numpy(jbs))
        jst2, jn, jcost, jbs2 = jlc.incremental_backend(jstate, jcfg, backend_state=jbs)
        assert n == jn and bs2.prev_cursor == jbs2.prev_cursor == cur
        np.testing.assert_array_equal(bs2.edges_ij, jbs2.edges_ij)
        np.testing.assert_allclose(bs2.edges_meas, jbs2.edges_meas, atol=REL_M, rtol=0)
        if jcost is None:
            assert cost is None
        else:
            assert cost == pytest.approx(jcost, rel=1e-4, abs=1e-6)
        for f in ("pose", "kf_pose", "feat_world"):
            np.testing.assert_allclose(getattr(st2, f).numpy(), np.asarray(getattr(jst2, f)),
                                       atol=1e-4, rtol=0, err_msg=f)
        for f in ("poses", "feat_world"):
            np.testing.assert_allclose(getattr(st2.map, f).numpy(),
                                       np.asarray(getattr(jst2.map, f)), atol=1e-4, rtol=0,
                                       err_msg=f)
        jbs = jbs2
    assert len(jbs.edges_ij) >= 1
    err = np.linalg.norm(st2.map.poses.numpy()[:N_KF, :2] - gt[:, :2], axis=1).mean()
    err0 = np.linalg.norm(tm.poses.numpy()[:N_KF, :2] - gt[:, :2], axis=1).mean()
    assert err < err0
    st3, n3, cost3, bs3 = tlc.incremental_backend(st2, cfg, backend_state=bs2)
    assert (n3, cost3, bs3.prev_cursor) == (0, None, N_KF)
    for a, b in zip(st3, st2):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
