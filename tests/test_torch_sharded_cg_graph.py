"""The sharded PCG's compile boundary on the CPU: the sweeps of the sharded
pose graph and BA (`reduce_fn` = the mesh's `psum`), which the card replays
from a CUDA graph with their all-reduce, between host checks of the
stopping rule.

One spawn of 4 gloo ranks (`tests/torch_dist_ranks.py`, no JAX in the ranks)
solves the 24-pose ring with a masked edge of `tests/test_torch_parallel.py`
and the noisy 6-pose BA problem of `tests/test_torch_dist_ba.py` by PCG on
meshes of 4, 3, 2 and 1 ranks, with `sweeps_per_check` 1, 16 and 4,096 (the
cadence the capture sets: one graph of that many sweeps, replayed between
checks) and through the entry points.  The cadence must not move a bit: the
sweeps past the stopping rule are masked on the device.  On the mesh of 2 the
sweep body runs under a dispatch mode that fails on any host read, with the
psum inside it.  The JAX sharded solvers run here, on the 8-device virtual
CPU mesh of `tests/conftest.py`, bounded as in `tests/test_torch_parallel.py`
and `tests/test_torch_dist_ba.py`.
"""

import jax
import numpy as np
import pytest
import torch

from radarslampy_tpu.config import SlamConfig as JaxConfig
from radarslampy_tpu.parallel import dist_ba as jdb
from radarslampy_tpu.parallel import dist_posegraph as jdp
from radarslampy_tpu.parallel.mesh import make_mesh as jax_make_mesh
from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.interop import ba_problem_from_numpy, pose_graph_from_numpy
from radarslampy_tpu_torch.models import ba as tba
from radarslampy_tpu_torch.models import posegraph as tpg
from tests.test_ba import _make_problem
from tests.test_torch_parallel import _ring_with_a_masked_edge
from tests.torch_dist_ranks import spawn

# The suite runs in several pytest-xdist worker processes on one host; one
# intra-op thread per worker keeps torch from oversubscribing its cores.
torch.set_num_threads(1)

CFG_KW = dict(pg_iterations=1)
CADENCES = (1, 16, 4096)
MESHES = ("w4", "w3", "w2", "w1")
SIZES = {"w4": 4, "w3": 3, "w2": 2, "w1": 1}
POSE_M, COST_RTOL, COST_ATOL = 1e-3, 1e-3, 1e-4   # tests/test_torch_parallel.py
XY_M, HEAD_RAD = 5e-3, 5e-4                       # tests/test_torch_dist_ba.py
SPAWN_S = 240


@pytest.fixture(scope="module")
def problems():
    g = _ring_with_a_masked_edge()
    p = _make_problem(np.random.default_rng(1234), M=6, L=40, noise=0.02, pose_noise=0.3)[0]
    return dict(jax=(g, p), ring=tuple(pose_graph_from_numpy(g, "cpu")),
                ba=tuple(ba_problem_from_numpy(p, "cpu")))


@pytest.fixture(scope="module")
def ranks(problems, tmp_path_factory):
    inputs = dict(cfg=CFG_KW, meshes=MESHES, cadences=CADENCES, ring=problems["ring"],
                  ba=problems["ba"])
    return spawn("sharded_cg", 4, tmp_path_factory.mktemp("sharded_cg"), inputs, SPAWN_S)


@pytest.fixture(scope="module")
def single(problems):
    cfg = SlamConfig(**CFG_KW)
    return (tpg.optimize_pose_graph(tpg.PoseGraph(*problems["ring"]), cfg, "pcg"),
            tba.optimize_ba(tba.BAProblem(*problems["ba"]), cfg, method="pcg"))


@pytest.fixture(scope="module")
def jax_ref(problems):
    g, p = problems["jax"]
    mesh, cfg = jax_make_mesh(8), JaxConfig(**CFG_KW)
    return (jax.device_get(jdp.optimize_pose_graph_sharded(g, cfg, mesh, method="pcg")),
            jax.device_get(jdb.optimize_ba_sharded(p, cfg, mesh, method="pcg")))


def _tensors(res):
    """The solve's tensors (poses, cost; poses, landmarks, cost), not its stats."""
    return [x for x in res if isinstance(x, torch.Tensor)]


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(_tensors(a), _tensors(b), strict=True))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("solver", ["pg", "ba"])
def test_check_cadence_moves_no_bit(ranks, mesh, solver):
    """`sweeps_per_check` 1, 16 and 4,096 give the same bits and the same
    sweep count; the entry point (16 between checks) gives them too."""
    out = ranks[0][mesh]
    ref = out[solver, CADENCES[0]]
    assert ref[-1]["cg_sweeps"] > 0
    for key in CADENCES[1:] + ("entry",):
        assert _equal(out[solver, key], ref), key
        assert out[solver, key][-1]["cg_sweeps"] == ref[-1]["cg_sweeps"], key


@pytest.mark.parametrize("mesh", MESHES)
def test_every_rank_returns_the_same_bits(ranks, mesh):
    members = [out[mesh] for out in ranks if mesh in out]
    assert len(members) == SIZES[mesh]
    for other in members[1:]:
        for key, val in members[0].items():
            if key != "forbid":
                assert _equal(other[key], val), key


@pytest.mark.parametrize("solver", ["pg", "ba"])
def test_one_rank_is_single_device(ranks, single, solver):
    got = ranks[0]["w1"][solver, 16]
    assert _equal(got, single[solver == "ba"])


def test_sweep_body_reads_nothing_from_the_host(ranks):
    """At 2 ranks, both solvers' sweeps ran under `Forbid(SYNC_OPS +
    HOST_DATA_OPS)` with one all-reduce a sweep inside it, and gave the bits
    of the unchecked solves."""
    for rank in (0, 1):
        out = ranks[rank]["w2"]
        seen = out["forbid"]
        assert not [k for k in seen if k.startswith("failed")], seen
        assert seen["sweeps"] > 0 and seen["c10d.allreduce_.default"] == seen["sweeps"]
        for solver in ("pg", "ba"):
            assert _equal(out[solver, "forbid"], out[solver, 16])


@pytest.mark.parametrize("mesh", ["w4", "w3", "w2"])
@pytest.mark.parametrize("cadence", CADENCES)
def test_sharded_pcg_matches_jax_sharded(ranks, jax_ref, mesh, cadence):
    """Every cadence on 2-4 ranks against the JAX sharded PCG (8 devices),
    within the bounds of the existing parity tests."""
    (pg_poses, pg_cost, _), (ba_poses, ba_lms, ba_cost, _) = (ranks[0][mesh]["pg", cadence],
                                                               ranks[0][mesh]["ba", cadence])
    (jp, jc), (jbp, jbl, jbc) = jax_ref
    np.testing.assert_allclose(pg_poses.numpy(), np.asarray(jp), atol=POSE_M, rtol=0)
    np.testing.assert_allclose(float(pg_cost), float(jc), rtol=COST_RTOL, atol=COST_ATOL)
    np.testing.assert_allclose(ba_poses[:, :2].numpy(), jbp[:, :2], atol=XY_M, rtol=0)
    np.testing.assert_allclose(ba_poses[:, 2].numpy(), jbp[:, 2], atol=HEAD_RAD, rtol=0)
    L = min(ba_lms.shape[0], jbl.shape[0])
    np.testing.assert_allclose(ba_lms[:L].numpy(), jbl[:L], atol=XY_M, rtol=0)
    assert float(ba_cost) == pytest.approx(float(jbc), rel=COST_RTOL, abs=1e-6)
