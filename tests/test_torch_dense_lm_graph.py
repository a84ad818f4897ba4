"""The dense LM loops' compile boundary on the CPU: one LM iteration of the
dense pose graph (`posegraph.pose_graph_lm_step`) and of dense BA
(`ba.ba_lm_step`) as a function of a carry of tensors, driven
`pg_iterations` times by `posegraph.lm_iterations`, which the card replays
from a CUDA graph of one iteration (the counterpart of the JAX package's
`lax.scan` under `jit`, and of `jit(shard_map(scan))` with the all-reduce
inside when sharded).

On the CPU the driver calls the body eagerly, so the refactored solvers must
give the bits of the loops they replaced (`tests/torch_dense_lm_reference.py`)
at 0, 1, 2 and 50 iterations, single-device and with the sharded solvers'
hooks; the bodies must run under a dispatch mode that fails on any host read
(`tests/torch_host_reads.py`).  One spawn of 2 gloo ranks
(`tests/torch_dist_ranks.py`) runs the sharded dense solvers on meshes of 2
and 1 ranks, against the same loops with the mesh's hooks and, at 2 ranks,
with each body under that mode and its all-reduces inside it.  Against the
JAX package the bounds are those of the existing parity tests: the pose graph
within 1e-3 m, 1e-4 rad and a cost rtol of 1e-4 (`tests/test_torch_posegraph.py`),
BA within 5e-3 m, 5e-4 rad and a cost rtol of 1e-3 (`tests/test_torch_ba.py`);
the sharded solvers against the JAX sharded ones on the 8-device virtual CPU
mesh of `tests/conftest.py` within the bounds of `tests/test_torch_parallel.py`
(1e-3 m, cost rtol 1e-3 / atol 1e-4) and `tests/test_torch_dist_ba.py`.
"""

import collections

import jax
import numpy as np
import pytest
import torch

from radarslampy_tpu.config import SlamConfig as JaxConfig
from radarslampy_tpu.models import ba as jba
from radarslampy_tpu.models import posegraph as jpg
from radarslampy_tpu.parallel import dist_ba as jdb
from radarslampy_tpu.parallel import dist_posegraph as jdp
from radarslampy_tpu.parallel.mesh import make_mesh as jax_make_mesh
from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.interop import ba_problem_from_numpy, pose_graph_from_numpy
from radarslampy_tpu_torch.models import ba as tba
from radarslampy_tpu_torch.models import posegraph as tpg
from tests import torch_dense_lm_reference as ref
from tests.test_ba import _make_problem
from tests.test_posegraph import _drifted_square_loop, _ring_graph
from tests.test_torch_ba import _maps
from tests.test_torch_parallel import _ring_with_a_masked_edge
from tests.torch_dist_ranks import spawn
from tests.torch_host_reads import HOST_DATA_OPS, SYNC_OPS, Forbid

# The suite runs in several pytest-xdist worker processes on one host; one
# intra-op thread per worker keeps torch from oversubscribing its cores.
torch.set_num_threads(1)

ITERATIONS = (0, 1, 2, 50)
PG_M, PG_RAD, PG_COST_RTOL = 1e-3, 1e-4, 1e-4          # tests/test_torch_posegraph.py
BA_M, BA_RAD, BA_COST_RTOL = 5e-3, 5e-4, 1e-3          # tests/test_torch_ba.py
SH_M, SH_COST_RTOL, SH_COST_ATOL = 1e-3, 1e-3, 1e-4    # tests/test_torch_parallel.py
JAX_ITERS = {"ring": 25, "drifted_square": 50, "line": 15, "loop_map": 10}
RANK_CFG = dict(pg_iterations=15)
MESHES = ("w2", "w1")
# all-reduces an LM iteration: the pose graph's cost, H, b and candidate
# cost; BA's reduced H, its right-hand side and the candidate cost
ALLREDUCES = {"pg": 4, "ba": 3}
SPAWN_S = 240


@pytest.fixture(scope="module")
def graphs():
    """name -> (JAX graph, the port's graph): the graphs of
    tests/test_torch_posegraph.py."""
    out = {"ring": _ring_graph(np.random.default_rng(1234))[0],
           "drifted_square": _drifted_square_loop(np.random.default_rng(7), n_side=30)[0]}
    return {k: (g, pose_graph_from_numpy(g, "cpu")) for k, g in out.items()}


@pytest.fixture(scope="module")
def problems():
    """name -> (JAX problem, the port's problem): those of tests/test_torch_ba.py."""
    _, jm = _maps()
    jp = {"line": _make_problem(np.random.default_rng(1234), noise=0.02, pose_noise=0.3)[0],
          "loop_map": jba.build_ba_problem(jm, min_views=2)}
    return {k: (p, ba_problem_from_numpy(p, "cpu")) for k, p in jp.items()}


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b, strict=True))


def _tensors(res):
    """The solve's tensors, not its stats."""
    return [x for x in res if isinstance(x, torch.Tensor)]


@pytest.mark.parametrize("iters", ITERATIONS)
@pytest.mark.parametrize("name", ["ring", "drifted_square"])
def test_pose_graph_equals_the_loop_it_replaced(graphs, name, iters):
    """The dense pose graph through its entry point, with and without the
    identity as the sharded hooks, gives the old loop's bits; on the CPU
    nothing is captured."""
    _, tg = graphs[name]
    cfg = SlamConfig(pg_iterations=iters)
    stats = {}
    got = tpg.optimize_pose_graph(tg, cfg, "dense", stats)
    assert _equal(got, ref.pose_graph_dense(tg, cfg))
    hooked = tpg._optimize_pose_graph_dense(tg, cfg, reduce_fn=lambda x: x,
                                            reduce_max_fn=lambda x: x)
    assert _equal(hooked, got)
    assert stats == dict(cg_sweeps=0, lm_captures=0, lm_capture_s=0.0, lm_replays=0,
                         lm_replay_s=0.0)


@pytest.mark.parametrize("iters", ITERATIONS)
@pytest.mark.parametrize("name", ["line", "loop_map"])
def test_ba_equals_the_loop_it_replaced(problems, name, iters):
    _, tp = problems[name]
    cfg = SlamConfig(pg_iterations=iters)
    stats = {}
    got = tba.optimize_ba(tp, cfg, method="dense", stats=stats)
    assert _equal(got, ref.ba_dense(tp, cfg))
    assert _equal(tba._optimize_ba_dense(tp, cfg, 8, reduce_fn=lambda x: x), got)
    assert stats["lm_captures"] == 0 and stats["lm_replays"] == 0 and stats["cg_sweeps"] == 0


@pytest.mark.parametrize("name", ["ring", "drifted_square"])
def test_pose_graph_matches_jax_dense_scan(graphs, name):
    """Against the JAX package's `_optimize_pose_graph` (its `lax.scan` of
    `lm_step`), at the iterations of tests/test_torch_posegraph.py."""
    g, tg = graphs[name]
    iters = JAX_ITERS[name]
    with jax.default_matmul_precision("float32"):
        jp, jc = jpg._optimize_pose_graph(g, JaxConfig(pg_iterations=iters))
    tp, tc = tpg.optimize_pose_graph(tg, SlamConfig(pg_iterations=iters), "dense")
    jp = np.asarray(jp)
    np.testing.assert_allclose(tp[:, :2].numpy(), jp[:, :2], atol=PG_M, rtol=0)
    np.testing.assert_allclose(tp[:, 2].numpy(), jp[:, 2], atol=PG_RAD, rtol=0)
    assert float(tc) == pytest.approx(float(jc), rel=PG_COST_RTOL, abs=1e-6)


@pytest.mark.parametrize("name", ["line", "loop_map"])
def test_ba_matches_jax_dense_jit(problems, name):
    """Against the JAX package's `_optimize_ba_dense_jit` (`jit` of the
    `lax.scan` in `_optimize_ba`), at the iterations of tests/test_torch_ba.py."""
    p, tp = problems[name]
    iters = JAX_ITERS[name]
    jpo, jl, jc = (np.asarray(x) for x in
                   jba._optimize_ba_dense_jit(p, JaxConfig(pg_iterations=iters), 8))
    tpo, tl, tc = tba.optimize_ba(tp, SlamConfig(pg_iterations=iters), method="dense")
    np.testing.assert_allclose(tpo[:, :2].numpy(), jpo[:, :2], atol=BA_M, rtol=0)
    np.testing.assert_allclose(tpo[:, 2].numpy(), jpo[:, 2], atol=BA_RAD, rtol=0)
    np.testing.assert_allclose(tl.numpy(), jl, atol=BA_M, rtol=0)
    assert float(tc) == pytest.approx(float(jc), rel=BA_COST_RTOL, abs=1e-6)


def _forbidding(body, calls):
    def wrapped(*args, **kwargs):
        calls.append(1)
        with Forbid(SYNC_OPS + HOST_DATA_OPS):
            return body(*args, **kwargs)

    return wrapped


@pytest.mark.parametrize("solver", ["pg", "ba"])
def test_lm_body_reads_nothing_from_the_host(graphs, problems, solver, monkeypatch):
    """Each body, under a dispatch mode that fails on a host read or a tensor
    made from host data, runs `pg_iterations` times and gives the solve's
    bits."""
    cfg = SlamConfig(pg_iterations=7)
    calls = []
    if solver == "pg":
        tg = graphs["drifted_square"][1]
        want = tpg.optimize_pose_graph(tg, cfg, "dense")
        monkeypatch.setattr(tpg, "pose_graph_lm_step",
                            _forbidding(tpg.pose_graph_lm_step, calls))
        got = tpg.optimize_pose_graph(tg, cfg, "dense")
    else:
        tp = problems["loop_map"][1]
        want = tba.optimize_ba(tp, cfg, method="dense")
        monkeypatch.setattr(tba, "ba_lm_step", _forbidding(tba.ba_lm_step, calls))
        got = tba.optimize_ba(tp, cfg, method="dense")
    assert len(calls) == cfg.pg_iterations
    assert _equal(got, want)


@pytest.mark.parametrize("n", [0, 1, 2, 5])
@pytest.mark.parametrize("replay", [True, False])
def test_lm_iterations_calls_the_body_n_times(n, replay):
    """On the CPU the driver runs the body n times eagerly, `replay` or not,
    and counts no capture and no replay."""
    calls = []

    def body(carry):
        calls.append(1)
        x, k = carry
        return x * 2.0 + 1.0, k + 1

    stats = collections.Counter()
    x, k = tpg.lm_iterations(body, (torch.ones(3), torch.zeros((), dtype=torch.int64)), n,
                             replay, stats)
    assert len(calls) == n and int(k) == n
    assert torch.equal(x, torch.full((3,), 2.0 ** (n + 1) - 1.0))
    assert stats["lm_captures"] == 0 and stats["lm_replays"] == 0


@pytest.fixture(scope="module")
def rank_problems():
    g = _ring_with_a_masked_edge()
    p = _make_problem(np.random.default_rng(1234), M=6, L=40, noise=0.02, pose_noise=0.3)[0]
    return dict(jax=(g, p), ring=tuple(pose_graph_from_numpy(g, "cpu")),
                ba=tuple(ba_problem_from_numpy(p, "cpu")))


@pytest.fixture(scope="module")
def ranks(rank_problems, tmp_path_factory):
    inputs = dict(cfg=RANK_CFG, meshes=MESHES, ring=rank_problems["ring"],
                  ba=rank_problems["ba"])
    return spawn("dense_lm", 2, tmp_path_factory.mktemp("dense_lm"), inputs, SPAWN_S)


@pytest.fixture(scope="module")
def rank_single(rank_problems):
    cfg = SlamConfig(**RANK_CFG)
    return dict(pg=tpg.optimize_pose_graph(tpg.PoseGraph(*rank_problems["ring"]), cfg, "dense"),
                ba=tba.optimize_ba(tba.BAProblem(*rank_problems["ba"]), cfg, method="dense"))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("solver", ["pg", "ba"])
def test_sharded_dense_equals_the_loop_it_replaced(ranks, mesh, solver):
    """The sharded entry points give the bits of the old loops run with the
    mesh's hooks, on every rank, with no capture on the CPU."""
    members = [out[mesh] for out in ranks if mesh in out]
    assert len(members) == {"w2": 2, "w1": 1}[mesh]
    for out in members:
        entry = out[solver, "entry"]
        assert _equal(_tensors(entry), out[solver, "loop"])
        assert _equal(_tensors(entry), _tensors(members[0][solver, "entry"]))
        assert entry[-1]["lm_captures"] == 0 and entry[-1]["cg_sweeps"] == 0


@pytest.mark.parametrize("solver", ["pg", "ba"])
def test_sharded_dense_one_rank_is_single_device(ranks, rank_single, solver):
    assert _equal(_tensors(ranks[0]["w1"][solver, "entry"]), rank_single[solver])


def test_sharded_dense_bodies_read_nothing_from_the_host(ranks):
    """At 2 ranks each body ran under `Forbid(SYNC_OPS + HOST_DATA_OPS)`
    `pg_iterations` times with its all-reduces inside it, and the solves
    gave the bits of the unwatched ones."""
    for rank in (0, 1):
        out = ranks[rank]["w2"]
        seen = out["forbid"]
        assert not [k for k in seen if k[0] == "failed"], seen
        for solver in ("pg", "ba"):
            bodies = seen[solver, "bodies"]
            assert bodies == RANK_CFG["pg_iterations"]
            assert seen[solver, "c10d.allreduce_.default"] == ALLREDUCES[solver] * bodies
            assert _equal(_tensors(out[solver, "forbid"]), _tensors(out[solver, "entry"]))


def test_sharded_dense_matches_jax_sharded(ranks, rank_problems):
    """Two ranks against the JAX sharded dense solvers on 8 devices."""
    g, p = rank_problems["jax"]
    mesh, cfg = jax_make_mesh(8), JaxConfig(**RANK_CFG)
    jp, jc = jdp.optimize_pose_graph_sharded(g, cfg, mesh, method="dense")
    jbp, jbl, jbc = (np.asarray(x) for x in jdb.optimize_ba_sharded(p, cfg, mesh,
                                                                   method="dense"))
    pg_poses, pg_cost, _ = ranks[0]["w2"]["pg", "entry"]
    ba_poses, ba_lms, ba_cost, _ = ranks[0]["w2"]["ba", "entry"]
    np.testing.assert_allclose(pg_poses.numpy(), np.asarray(jp), atol=SH_M, rtol=0)
    np.testing.assert_allclose(float(pg_cost), float(jc), rtol=SH_COST_RTOL, atol=SH_COST_ATOL)
    np.testing.assert_allclose(ba_poses[:, :2].numpy(), jbp[:, :2], atol=BA_M, rtol=0)
    np.testing.assert_allclose(ba_poses[:, 2].numpy(), jbp[:, 2], atol=BA_RAD, rtol=0)
    L = min(ba_lms.shape[0], jbl.shape[0])
    np.testing.assert_allclose(ba_lms[:L].numpy(), jbl[:L], atol=BA_M, rtol=0)
    assert float(ba_cost) == pytest.approx(float(jbc), rel=BA_COST_RTOL, abs=1e-6)
