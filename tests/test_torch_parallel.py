"""The port's distributed back-end (`radarslampy_tpu_torch/parallel/`: mesh,
sharded pose graph, sharded map queries, sharded verification) against the
port's single-device functions and the JAX package's sharded functions.

One spawn of 4 gloo ranks (`tests/torch_dist_ranks.py`, no JAX in the ranks,
a file store in the test's temporary directory) runs every sharded function
on three meshes: all 4 ranks, the first 3 (uneven padding: 25 edges, 66 map
rows, 12 candidates padded to 12 and 16) and the first rank alone.  The JAX
references run here, on the 8-device virtual CPU mesh of `tests/conftest.py`.

Bounds: a mesh of one rank gives the single-device bits; 3 and 4 ranks the
JAX package's own (`tests/test_parallel.py`): poses 1e-3 m, cost rtol 1e-3 /
atol 1e-4; map queries equal to the dense ones (the merge keeps the dense
order); verification `ok` equal and `rel_pose` within 1e-5 of serial
`verify_candidate`; against the JAX sharded functions the port's parity
bounds (loop edges: 1e-4 m / 1e-5 rad, `tests/test_torch_loopclosure.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radarslampy_tpu.config import SlamConfig as JaxConfig
from radarslampy_tpu.models.loopclosure import find_candidates as jax_find_candidates
from radarslampy_tpu.models.placerecog import find_candidates_appearance as jax_appearance
from radarslampy_tpu.parallel import dist_posegraph as jdp
from radarslampy_tpu.parallel import dist_verify as jdv
from radarslampy_tpu.parallel import sharded_map as jsm
from radarslampy_tpu.parallel.mesh import make_mesh as jax_make_mesh
from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.interop import (appearance_candidates_from_numpy,
                                           loop_match_from_numpy, map_state_from_numpy,
                                           pose_graph_from_numpy)
from radarslampy_tpu_torch.models import loopclosure as tlc
from radarslampy_tpu_torch.models import posegraph as tpg
from radarslampy_tpu_torch.models.loopclosure import LoopMatch
from radarslampy_tpu_torch.models.placerecog import find_candidates_appearance
from tests.test_loopclosure import _loop_map
from tests.test_parallel import _toy_map
from tests.test_posegraph import _ring_graph
from tests.torch_dist_ranks import spawn

# The suite runs in several pytest-xdist worker processes on one host; one
# intra-op thread per worker keeps torch from oversubscribing its cores.
torch.set_num_threads(1)

PG_KW = dict(pg_iterations=15)
VERIFY_KW = dict(pg_iterations=10)
POSE_M, COST_RTOL, COST_ATOL = 1e-3, 1e-3, 1e-4
METHODS = ("dense", "pcg", "gather")
MESHES = ("w4", "w3", "w1")
# The ranks' time limit: the spawn takes ~10-20 s on one core per rank.
SPAWN_S = 240


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for item in x for leaf in _leaves(item)]
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)]


def _appearance_map():
    """`_toy_map` with a planted revisit: keyframe 40 sees keyframe 5's scene
    rotated by 13 sectors (the map of `tests/test_parallel.py`)."""
    rng = np.random.default_rng(11)
    descs = rng.uniform(0.0, 1.0, (64, 16, 80)).astype(np.float32)
    descs[40] = np.roll(descs[5], 13, axis=1) + rng.normal(0, 0.01, (16, 80))
    return _toy_map()._replace(descriptors=jnp.asarray(descs), cursor=jnp.int32(50))


def _ring_with_a_masked_edge():
    """The 24-pose ring of `tests/test_parallel.py` with one masked edge
    appended: 25 edges, which 3 and 4 ranks (and JAX's 8 devices) split
    unevenly."""
    g, _, _ = _ring_graph(np.random.default_rng(1234))
    return g._replace(edges_ij=jnp.concatenate([g.edges_ij, jnp.zeros((1, 2), jnp.int32)]),
                      edges_meas=jnp.concatenate([g.edges_meas, jnp.zeros((1, 3))]),
                      edges_info=jnp.concatenate([g.edges_info, jnp.ones((1, 3))]),
                      edge_mask=jnp.concatenate([g.edge_mask, jnp.zeros(1, bool)]))


def _padded_loop_map():
    ms, _ = _loop_map(np.random.default_rng(1234), drift=0.5)
    return ms._replace(poses=jnp.asarray(np.pad(
        np.asarray(ms.poses), ((0, ms.feat_local.shape[0] - int(ms.poses.shape[0])), (0, 0)))))


@pytest.fixture(scope="module")
def problem():
    g = _ring_with_a_masked_edge()
    loop = _padded_loop_map()
    c = jax_find_candidates(loop.poses, loop.cursor, max_candidates=12, radius_m=8.0,
                            min_index_gap=20)
    app = _appearance_map()
    a = jax_appearance(app.descriptors, app.cursor, max_candidates=6, min_index_gap=10)
    t = torch.from_numpy
    return dict(
        jax=dict(g=g, toy=_toy_map(), app=app, loop=loop, cand=c, app_cand=a),
        ring=tuple(pose_graph_from_numpy(g, "cpu")),
        toy=tuple(map_state_from_numpy(_toy_map(), "cpu")),
        query=torch.tensor([5.0, -3.0, 0.0]),
        app=tuple(map_state_from_numpy(app, "cpu")),
        loop=tuple(map_state_from_numpy(loop, "cpu")),
        cand=(t(np.array(c.i, np.int64)), t(np.array(c.j, np.int64)), t(np.array(c.valid)),
              torch.full((12,), float("nan"))),
        app_cand=tuple(appearance_candidates_from_numpy(a, "cpu")[k] for k in (0, 1, 4, 3)),
        pg_cfg=PG_KW, verify_cfg=VERIFY_KW, meshes=MESHES)


@pytest.fixture(scope="module")
def ranks(problem, tmp_path_factory):
    """Every rank's outputs, one dict per mesh it belongs to."""
    inputs = {k: v for k, v in problem.items() if k != "jax"}
    return spawn("parallel", 4, tmp_path_factory.mktemp("parallel"), inputs, SPAWN_S)


@pytest.fixture(scope="module")
def single(problem):
    """The port's single-device results on the same inputs."""
    g = tpg.PoseGraph(*problem["ring"])
    cfg = SlamConfig(**PG_KW)
    out = {m: tpg.optimize_pose_graph(g, cfg, method=m) for m in ("dense", "pcg")}
    toy = tlc.MapState(*problem["toy"])
    M = toy.poses.shape[0]
    out["points"] = (toy.feat_world.reshape(-1, 2),
                     ((torch.arange(M) < toy.cursor)[:, None] & toy.feat_mask).reshape(-1))
    app = tlc.MapState(*problem["app"])
    out["appearance"] = find_candidates_appearance(app.descriptors, app.cursor, 6,
                                                   min_index_gap=10)
    vcfg = SlamConfig(**VERIFY_KW)
    for name, m in (("cand", tlc.MapState(*problem["loop"])), ("app_cand", app)):
        ci, cj, cv, cr = problem[name]
        match = tlc.verify_candidate(m, ci, cj, vcfg, rot_override=cr)
        out[f"verify_{name}"] = match._replace(ok=match.ok & cv)
    return out


@pytest.fixture(scope="module")
def jax_ref(problem):
    """The JAX package's sharded functions on the 8-device virtual mesh."""
    j = problem["jax"]
    mesh = jax_make_mesh(8)
    cfg = JaxConfig(**PG_KW)
    out = {m: jdp.optimize_pose_graph_sharded(j["g"], cfg, mesh, method=m) for m in METHODS}
    toy = jsm.shard_map_state(j["toy"], mesh)
    out["nearest"] = jsm.nearest_keyframes(toy, np.asarray([5.0, -3.0, 0.0], np.float32), 5, mesh)
    out["points"] = jsm.global_map_points(toy, mesh)
    out["appearance"] = jsm.appearance_candidates_sharded(jsm.shard_map_state(j["app"], mesh),
                                                          mesh, max_candidates=6,
                                                          min_index_gap=10)
    c = j["cand"]
    padded = jdv.pad_candidates(c.i, c.j, c.valid, jnp.full(12, jnp.nan, jnp.float32), 8)
    out["verify_cand"] = jdv.verify_candidates_sharded(j["loop"], *padded,
                                                       JaxConfig(**VERIFY_KW), mesh)
    return jax.device_get(out)


def _dense_nearest(toy, q, k=5, exclude_after=None):
    """The dense query: every live keyframe's distance, stable top-k."""
    M = toy.poses.shape[0]
    idx = torch.arange(M)
    live = idx < toy.cursor
    if exclude_after is not None:
        live &= idx < exclude_after
    d = toy.poses[:, :2] - q[:2]
    d = torch.where(live, torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]), float("inf"))
    order = torch.sort(d, stable=True).indices[:k]
    return order, d[order]


def test_collectives_and_blocks(ranks):
    """psum / pmax / all_gather over each mesh, and the padded blocks."""
    for rank, out in enumerate(ranks):
        for mesh, res in out.items():
            n = {"w4": 4, "w3": 3, "w1": 1}[mesh]
            s, mx, gathered, block = res["collectives"]
            assert float(s) == n * (n + 1) / 2 and float(mx) == n
            assert gathered.tolist() == [r % 2 == 0 for r in range(n)]
            per = -(-10 // n)
            expect = [v if v < 10 else 0 for v in range(rank * per, rank * per + per)]
            assert block.tolist() == expect


def test_every_rank_returns_the_same_bits(ranks):
    for mesh in MESHES:
        members = [out[mesh] for out in ranks if mesh in out]
        assert len(members) == {"w4": 4, "w3": 3, "w1": 1}[mesh]
        for other in members[1:]:
            for key, val in members[0].items():
                if key == "collectives":
                    continue
                for a, b in zip(_leaves(val), _leaves(other[key]), strict=True):
                    assert np.array_equal(a, b), (mesh, key)


@pytest.mark.parametrize("method", METHODS + ("auto",))
def test_sharded_posegraph_one_rank_is_single_device(ranks, single, method):
    """A world of one runs its collectives and gives the single-device bits
    ("gather" and "auto" are the single-device PCG and dense solves)."""
    poses, cost, _ = ranks[0]["w1"][f"pg_{method}"]
    ref = single[{"gather": "pcg", "auto": "dense"}.get(method, method)]
    assert torch.equal(poses, ref[0]) and torch.equal(cost, ref[1])


@pytest.mark.parametrize("mesh", MESHES)
def test_hvp_distributed_is_the_dense_product(ranks, problem, mesh):
    """The edge blocks' J^T W J v summed over the ranks equals H v with the
    single-device H (within float32 sums in another order)."""
    g = tpg.PoseGraph(*problem["ring"])
    v = torch.linspace(-1.0, 1.0, g.poses.numel()).reshape(-1, 3)
    H, _ = tpg.assemble_normal_equations(g.poses, g, 1.0)
    want = (H @ v.reshape(-1)).reshape(-1, 3)
    got = ranks[0][mesh]["hvp"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4 * float(want.abs().max()),
                               rtol=0)


@pytest.mark.parametrize("mesh", ["w4", "w3"])
@pytest.mark.parametrize("method", METHODS)
def test_sharded_posegraph_matches_single_device(ranks, single, mesh, method):
    poses, cost, sweeps = ranks[0][mesh][f"pg_{method}"]
    ref = single["pcg" if method == "gather" else method]
    np.testing.assert_allclose(poses.numpy(), ref[0].numpy(), atol=POSE_M, rtol=0)
    np.testing.assert_allclose(float(cost), float(ref[1]), rtol=COST_RTOL, atol=COST_ATOL)
    assert (sweeps > 0) == (method != "dense")


@pytest.mark.parametrize("method", METHODS)
def test_sharded_posegraph_matches_jax_sharded(ranks, jax_ref, method):
    poses, cost, _ = ranks[0]["w4"][f"pg_{method}"]
    jposes, jcost = jax_ref[method]
    np.testing.assert_allclose(poses.numpy(), np.asarray(jposes), atol=POSE_M, rtol=0)
    np.testing.assert_allclose(float(cost), float(jcost), rtol=COST_RTOL, atol=COST_ATOL)


@pytest.mark.parametrize("mesh", MESHES)
def test_nearest_keyframes_equal_the_dense_query(ranks, problem, mesh):
    toy = tlc.MapState(*problem["toy"])
    for key, excl in (("nearest", None), ("nearest_excl", 20)):
        idx, dist, valid = ranks[0][mesh][key]
        order, d = _dense_nearest(toy, problem["query"], exclude_after=excl)
        assert torch.equal(idx, order) and torch.equal(dist, d)
        assert torch.equal(valid, torch.isfinite(d))


def test_nearest_keyframes_match_jax_and_numpy(ranks, jax_ref, problem):
    idx, dist, valid = ranks[0]["w4"]["nearest"]
    jidx, jdist, jvalid = jax_ref["nearest"]
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), rtol=1e-6)
    poses = problem["toy"][0].numpy()[:40]
    d = np.linalg.norm(poses[:, :2] - np.array([5.0, -3.0]), axis=1)
    np.testing.assert_allclose(np.sort(dist.numpy()), np.sort(d)[:5], rtol=1e-5)


@pytest.mark.parametrize("mesh", MESHES)
def test_global_map_points_equal_the_dense_gather(ranks, single, jax_ref, mesh):
    """The map's 64 rows padded to a multiple of the mesh: the first 64 * K
    points are the dense gather's, the padded rows are masked."""
    pts, mask = ranks[0][mesh]["points"]
    n = single["points"][1].shape[0]
    assert torch.equal(pts[:n], single["points"][0]) and torch.equal(mask[:n], single["points"][1])
    assert not mask[n:].any()
    np.testing.assert_array_equal(mask[:n].numpy(), np.asarray(jax_ref["points"][1]))
    np.testing.assert_array_equal(pts[:n].numpy(), np.asarray(jax_ref["points"][0]))


@pytest.mark.parametrize("mesh", MESHES)
def test_appearance_candidates_equal_the_dense_search(ranks, single, mesh):
    got = ranks[0][mesh]["appearance"]
    for a, b in zip(got, single["appearance"]):
        assert torch.equal(a, b)


def test_appearance_candidates_match_jax_sharded(ranks, jax_ref):
    """The same pairs (sets to 1e-5 of distance), the planted revisit found
    with its rotation (tests/test_parallel.py)."""
    def as_set(c):
        return {(int(i), int(j), round(float(d), 5))
                for i, j, d, v in zip(c[0], c[1], c[2], c[4]) if bool(v)}

    got = ranks[0]["w4"]["appearance"]
    assert as_set(got) == as_set(jax_ref["appearance"]) and as_set(got)
    pairs = [(int(i), int(j)) for i, j in zip(got[0], got[1])]
    expect = -(13 * 2 * np.pi / 80)
    assert abs(float(got[3][pairs.index((5, 40))]) - expect) < 1e-5


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("cands", ["cand", "app_cand"])
def test_sharded_verify_matches_serial(ranks, single, mesh, cands):
    got = ranks[0][mesh][f"verify_{cands}"]
    ref = single[f"verify_{cands}"]
    C = ref.ok.shape[0]
    ok = got[3][:C]
    assert torch.equal(ok, ref.ok) and not got[3][C:].any()
    assert torch.equal(got[1][:C][ok], ref.n_matches[ok])
    np.testing.assert_allclose(got[0][:C][ok].numpy(), ref.rel_pose[ok].numpy(), atol=1e-5,
                               rtol=0)
    if cands == "cand":
        assert bool(ok.any())


def test_sharded_verify_matches_jax_sharded(ranks, jax_ref):
    got = ranks[0]["w4"]["verify_cand"]
    ref = LoopMatch(*(x[:12] for x in loop_match_from_numpy(jax_ref["verify_cand"], "cpu")))
    assert torch.equal(got[3], ref.ok) and torch.equal(got[1][got[3]], ref.n_matches[ref.ok])
    d = (got[0] - ref.rel_pose)[ref.ok].abs()
    assert float(d[:, :2].max()) <= 1e-4 and float(d[:, 2].max()) <= 1e-5
