"""The port's landmark-sharded bundle adjustment (`radarslampy_tpu_torch/
parallel/dist_ba.py`) against the port's single-device BA and the JAX
package's sharded BA.

Problems: the two of `tests/test_dist_ba.py` (6 poses, 40 landmarks seen 3
times each; exact and 0.02 m observations) and the loop map of
`tests/test_torch_ba.py` packed with a masked observation tail.  One spawn
of 4 gloo ranks (`tests/torch_dist_ranks.py`) solves each, dense and PCG, on
all 4 ranks, on the first 3 (40 landmarks: uneven blocks) and on the first
rank alone; the JAX references run here on the 8-device virtual mesh.

Bounds: one rank gives the single-device bits on the same observations (the
repack drops masked rows, as the JAX package's does); 3 and 4 ranks the
single-device result within 1e-3 m (and rad) and a cost rtol of 1e-3 /
atol 1e-4; the JAX sharded BA within the port's BA parity bounds
(`tests/test_torch_ba.py`: 5e-3 m, 5e-4 rad, cost rtol 1e-3).
"""

import jax
import numpy as np
import pytest
import torch

from radarslampy_tpu.config import SlamConfig as JaxConfig
from radarslampy_tpu.models import ba as jba
from radarslampy_tpu.parallel import dist_ba as jdb
from radarslampy_tpu.parallel.mesh import make_mesh as jax_make_mesh
from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.interop import ba_problem_from_numpy
from radarslampy_tpu_torch.models import ba as tba
from radarslampy_tpu_torch.parallel.dist_ba import shard_ba_problem
from tests.test_ba import _make_problem
from tests.test_torch_ba import _maps
from tests.torch_dist_ranks import spawn

# The suite runs in several pytest-xdist worker processes on one host; one
# intra-op thread per worker keeps torch from oversubscribing its cores.
torch.set_num_threads(1)

CFG_KW = dict(pg_iterations=12)
POSE_M, COST_RTOL, COST_ATOL = 1e-3, 1e-3, 1e-4
XY_M, HEAD_RAD = 5e-3, 5e-4
MESHES = ("w4", "w3", "w1")
NAMES = ("line", "noisy", "loop_map")
JAX_CASES = (("line", "dense"), ("noisy", "pcg"), ("loop_map", "pcg"))
SPAWN_S = 240


@pytest.fixture(scope="module")
def problems():
    """name -> (JAX problem, the port's problem)."""
    _, jm = _maps()
    jp = {"line": _make_problem(np.random.default_rng(1234), M=6, L=40, pose_noise=0.3)[0],
          "noisy": _make_problem(np.random.default_rng(1234), M=6, L=40, noise=0.02,
                                 pose_noise=0.3)[0],
          "loop_map": jba.build_ba_problem(jm, min_views=2, max_obs=1500)}
    return {k: (p, ba_problem_from_numpy(p, "cpu")) for k, p in jp.items()}


@pytest.fixture(scope="module")
def ranks(problems, tmp_path_factory):
    inputs = dict(cfg=CFG_KW, meshes=MESHES,
                  problems={k: tuple(tp) for k, (_, tp) in problems.items()})
    return spawn("dist_ba", 4, tmp_path_factory.mktemp("dist_ba"), inputs, SPAWN_S)


@pytest.fixture(scope="module")
def single(problems):
    """The single-device BA on each problem, and ("valid", ...) on its valid
    observation rows: the repack of one rank."""
    cfg = SlamConfig(**CFG_KW)
    out = {}
    for k, (_, tp) in problems.items():
        for m in ("dense", "pcg"):
            out[k, m] = tba.optimize_ba(tp, cfg, method=m)
            out["valid", k, m] = tba.optimize_ba(_valid_rows(tp), cfg, method=m)
    return out


@pytest.fixture(scope="module")
def jax_ref(problems):
    mesh = jax_make_mesh(8)
    return {(k, m): jax.device_get(jdb.optimize_ba_sharded(problems[k][0], JaxConfig(**CFG_KW),
                                                           mesh, method=m))
            for k, m in JAX_CASES}


def _valid_rows(p):
    """`p` without its masked observation rows (the repack drops them)."""
    return p._replace(**{f: getattr(p, f)[p.obs_mask]
                         for f in ("obs_pose", "obs_lm", "obs_xy", "obs_mask")})


def _triples(p):
    m = p.obs_mask.numpy()
    return sorted(zip(p.obs_pose.numpy()[m].tolist(), p.obs_lm.numpy()[m].tolist(),
                      map(tuple, p.obs_xy.numpy()[m].tolist())))


@pytest.mark.parametrize("n", [1, 3, 4, 8])
@pytest.mark.parametrize("name", NAMES)
def test_shard_ba_problem_keeps_every_observation_in_its_landmarks_block(problems, name, n):
    jp, tp = problems[name]
    ps = shard_ba_problem(tp, n)
    L, Lpad = tp.landmarks.shape[0], ps.landmarks.shape[0]
    assert Lpad % n == 0 and ps.obs_mask.shape[0] % n == 0
    assert torch.equal(ps.landmarks[:L], tp.landmarks) and not ps.lm_mask[L:].any()
    assert _triples(ps) == _triples(tp)
    # each block of observations holds only its landmark block's observations
    per_obs, per_lm = ps.obs_mask.shape[0] // n, Lpad // n
    block = torch.arange(ps.obs_mask.shape[0]) // per_obs
    assert torch.equal((ps.obs_lm // per_lm)[ps.obs_mask], block[ps.obs_mask])
    # the same observations as the JAX package's repack
    js = jdb.shard_ba_problem(jp, n)
    jm = np.asarray(js.obs_mask)
    assert sorted(zip(np.asarray(js.obs_pose)[jm].tolist(), np.asarray(js.obs_lm)[jm].tolist(),
                      map(tuple, np.asarray(js.obs_xy)[jm].tolist()))) == _triples(ps)
    np.testing.assert_array_equal(ps.landmarks.numpy(), np.asarray(js.landmarks))
    if n == 1:
        # one block: the input's valid rows in their order
        for a, b in zip(ps, _valid_rows(tp)):
            assert torch.equal(a, b)


def test_every_rank_returns_the_same_bits(ranks):
    for mesh in MESHES:
        members = [out[mesh] for out in ranks if mesh in out]
        for other in members[1:]:
            for key, val in members[0].items():
                for a, b in zip(val[:3], other[key][:3]):
                    assert torch.equal(a, b), (mesh, key)


@pytest.mark.parametrize("method", ["dense", "pcg"])
@pytest.mark.parametrize("name", NAMES)
def test_one_rank_is_single_device(ranks, single, name, method):
    """Bit for bit on the same observations; the loop map's masked tail
    (which the repack drops) changes no solver here either."""
    got = ranks[0]["w1"][f"{name}_{method}"]
    for a, b in zip(got[:3], single["valid", name, method]):
        assert torch.equal(a, b)
    for a, b in zip(got[:2], single[name, method][:2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("mesh", ["w4", "w3"])
@pytest.mark.parametrize("method", ["dense", "pcg"])
@pytest.mark.parametrize("name", NAMES)
def test_sharded_ba_matches_single_device(ranks, single, problems, name, method, mesh):
    poses, lms, cost, sweeps = ranks[0][mesh][f"{name}_{method}"]
    sp, sl, sc = single[name, method]
    L = sl.shape[0]
    np.testing.assert_allclose(poses.numpy(), sp.numpy(), atol=POSE_M, rtol=0)
    np.testing.assert_allclose(lms[:L].numpy(), sl.numpy(), atol=POSE_M, rtol=0)
    np.testing.assert_allclose(float(cost), float(sc), rtol=COST_RTOL, atol=COST_ATOL)
    assert lms.shape[0] % {"w4": 4, "w3": 3}[mesh] == 0 and not lms[L:].any()
    assert (sweeps > 0) == (method == "pcg")
    # and the LM moved downhill from the start
    p = problems[name][1]
    assert float(cost) < float(tba.ba_cost(p.poses, p.landmarks, p, 1.0))


@pytest.mark.parametrize("name, method", JAX_CASES)
def test_sharded_ba_matches_jax_sharded(ranks, jax_ref, name, method):
    poses, lms, cost, _ = ranks[0]["w4"][f"{name}_{method}"]
    jp, jl, jc = jax_ref[name, method]
    np.testing.assert_allclose(poses[:, :2].numpy(), jp[:, :2], atol=XY_M, rtol=0)
    np.testing.assert_allclose(poses[:, 2].numpy(), jp[:, 2], atol=HEAD_RAD, rtol=0)
    L = min(lms.shape[0], jl.shape[0])
    np.testing.assert_allclose(lms[:L].numpy(), jl[:L], atol=XY_M, rtol=0)
    assert float(cost) == pytest.approx(float(jc), rel=COST_RTOL, abs=1e-6)
