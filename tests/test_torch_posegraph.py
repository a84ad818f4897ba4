"""The port's pose graph (`radarslampy_tpu_torch/models/posegraph.py`) against
the JAX package's, on the graphs of tests/test_posegraph.py carried across
with `interop.pose_graph_from_numpy`.

Bounds: the residual within 1e-6; the analytic Jacobians against `jax.jacfwd`
within 1e-5; H and b within 1e-5 of their largest entry; the Huber schedule
within 1e-6 relative; each LM solver against the same JAX solver: poses
within 1e-3 m and 1e-4 rad, cost within 1e-4 relative; the port's PCG
checked on the host after every sweep equal to the same PCG checked once at
its sweep cap (within 1e-6); the odometry graph equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radarslampy_tpu.config import SlamConfig as JaxConfig
from radarslampy_tpu.models import posegraph as jpg
from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.interop import pose_graph_from_numpy
from radarslampy_tpu_torch.models import posegraph as tpg
from tests.test_posegraph import _drifted_square_loop, _ring_graph

# The suite runs in several pytest-xdist worker processes on one host; one
# intra-op thread per worker keeps torch from oversubscribing its cores.
torch.set_num_threads(1)

POSE_M, POSE_RAD, COST_RTOL = 1e-3, 1e-4, 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _random_edges(rng, n=64):
    pi = np.concatenate([rng.uniform(-300, 300, (n, 2)), rng.uniform(-4, 4, (n, 1))], 1)
    pj = pi + np.concatenate([rng.uniform(-5, 5, (n, 2)), rng.uniform(-0.5, 0.5, (n, 1))], 1)
    meas = np.concatenate([rng.uniform(-5, 5, (n, 2)), rng.uniform(-3.1, 3.1, (n, 1))], 1)
    return (a.astype(np.float32) for a in (pi, pj, meas))


def test_edge_residual_and_jacobians_match_jax(rng):
    pi, pj, meas = _random_edges(rng)
    r = tpg.edge_residual(_t(pi), _t(pj), _t(meas)).numpy()
    jr = np.asarray(jax.vmap(jpg.edge_residual)(pi, pj, meas))
    np.testing.assert_allclose(r, jr, atol=1e-6, rtol=0)
    Ji, Jj = tpg.edge_jacobians(_t(pi), _t(pj), _t(meas))
    jJi = jax.vmap(jax.jacfwd(jpg.edge_residual, argnums=0))(pi, pj, meas)
    jJj = jax.vmap(jax.jacfwd(jpg.edge_residual, argnums=1))(pi, pj, meas)
    np.testing.assert_allclose(Ji.numpy(), np.asarray(jJi), atol=1e-5, rtol=0)
    np.testing.assert_allclose(Jj.numpy(), np.asarray(jJj), atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def graphs():
    """name -> (JAX graph, the port's graph, ground truth): the ring (one
    loop edge, on the Huber's linear branch at the drifted start) and a
    square loop drifted by tens of metres (ten loop edges)."""
    out = {"ring": _ring_graph(np.random.default_rng(1234)),
           "drifted_square": _drifted_square_loop(np.random.default_rng(7), n_side=30)}
    return {k: (g, pose_graph_from_numpy(g, "cpu"), gt) for k, (g, gt, _) in out.items()}


@pytest.fixture(scope="module")
def ring(graphs):
    return graphs["ring"][:2]


@pytest.mark.parametrize("name", ["ring", "drifted_square"])
def test_normal_equations_match_jax(graphs, name):
    g, tg, _ = graphs[name]
    hd = 1.0
    H, b = tpg.assemble_normal_equations(tg.poses, tg, hd)
    jH, jb = (np.asarray(x) for x in jpg.assemble_normal_equations(g.poses, g, hd))
    np.testing.assert_allclose(H.numpy(), jH, atol=1e-5 * np.abs(jH).max(), rtol=0)
    np.testing.assert_allclose(b.numpy(), jb, atol=1e-5 * np.abs(jb).max(), rtol=0)
    assert float(tpg.graph_cost(tg.poses, tg, hd)) == pytest.approx(
        float(jpg.graph_cost(g.poses, g, hd)), rel=1e-5)


@pytest.mark.parametrize("anneal", [True, False])
def test_huber_schedule_matches_jax(ring, anneal):
    g, tg = ring
    cfg = SlamConfig(pg_iterations=25, pg_gnc_anneal=anneal)
    jcfg = JaxConfig(pg_iterations=25, pg_gnc_anneal=anneal)
    np.testing.assert_allclose(tpg._huber_schedule(tg, cfg).numpy(),
                               np.asarray(jpg._huber_schedule(g, jcfg)), rtol=1e-6)


@pytest.fixture(scope="module")
def solved(graphs):
    """Each graph through both solvers of both packages, once."""
    out = {}
    for name, (g, tg, gt) in graphs.items():
        iters = 25 if name == "ring" else 50
        for method in ("dense", "pcg"):
            jp, jc = jpg.optimize_pose_graph(g, JaxConfig(pg_iterations=iters), method=method)
            stats = {}
            tp, tc = tpg.optimize_pose_graph(tg, SlamConfig(pg_iterations=iters),
                                             method=method, stats=stats)
            out[name, method] = (tp.numpy(), float(tc), np.asarray(jp), float(jc), gt, stats)
    return out


@pytest.mark.parametrize("method", ["dense", "pcg"])
@pytest.mark.parametrize("name", ["ring", "drifted_square"])
def test_lm_matches_jax(solved, name, method):
    tp, tc, jp, jc, gt, stats = solved[name, method]
    np.testing.assert_allclose(tp[:, :2], jp[:, :2], atol=POSE_M, rtol=0)
    np.testing.assert_allclose(tp[:, 2], jp[:, 2], atol=POSE_RAD, rtol=0)
    assert tc == pytest.approx(jc, rel=COST_RTOL, abs=1e-6)
    # and the loop closure pulls the drifted chain towards the ground truth
    err = np.linalg.norm(tp[:, :2] - gt[:, :2], axis=1).mean()
    assert err < 1.0, err
    assert (stats["cg_sweeps"] > 0) == (method == "pcg")


def test_auto_picks_dense_up_to_1024_nodes(ring, monkeypatch):
    calls = []
    monkeypatch.setattr(tpg, "_optimize_pose_graph_dense",
                        lambda g, cfg, **kw: calls.append("dense"))
    monkeypatch.setattr(tpg, "_optimize_pose_graph_pcg", lambda g, cfg, **kw: calls.append("pcg"))
    _, tg = ring
    big = tg._replace(poses=torch.zeros(1025, 3))
    tpg.optimize_pose_graph(tg, SlamConfig())
    tpg.optimize_pose_graph(big, SlamConfig())
    assert calls == ["dense", "pcg"]


def test_pcg_checked_every_sweep_equals_one_check(ring):
    """The host check's interval changes only how many frozen sweeps run: one
    check per sweep and one check at the sweep cap give the same poses."""
    _, tg = ring
    cfg = SlamConfig(pg_iterations=25)
    every, _ = tpg._optimize_pose_graph_pcg(tg, cfg, sweeps_per_check=1)
    once, _ = tpg._optimize_pose_graph_pcg(tg, cfg, sweeps_per_check=8 * tg.poses.shape[0])
    tiny, _ = tpg.optimize_pose_graph(tg, dataclasses.replace(cfg, pg_sweeps_per_dispatch=3),
                                      method="pcg")
    np.testing.assert_allclose(every.numpy(), once.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tiny.numpy(), once.numpy(), atol=1e-6, rtol=0)


def test_odometry_graph_from_map_equal():
    M = 16
    poses = np.cumsum(np.tile([1.0, 0.1, 0.05], (M, 1)), axis=0).astype(np.float32)
    for cursor, max_edges in ((5, None), (16, 40), (1, None)):
        g = tpg.odometry_graph_from_map(_t(poses), torch.tensor(cursor, dtype=torch.int32),
                                        max_edges=max_edges)
        jg = jpg.odometry_graph_from_map(jnp.asarray(poses), jnp.int32(cursor),
                                         max_edges=max_edges)
        for f in ("node_mask", "edges_ij", "edge_mask", "edges_info"):
            np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(jg, f)), f)
        np.testing.assert_allclose(g.edges_meas.numpy(), np.asarray(jg.edges_meas),
                                   atol=1e-6, rtol=0)
        assert float(tpg.graph_cost(g.poses, g, 1.0)) < 1e-4


@pytest.mark.parametrize("method", ["dense", "pcg"])
def test_identity_reduction_hooks_change_no_bit(ring, method):
    """The sharded solvers' hooks (`reduce_fn`, `reduce_max_fn`), given the
    identity, return what the solvers return without them, bit for bit."""
    _, tg = ring
    cfg = SlamConfig(pg_iterations=25)
    solve = {"dense": tpg._optimize_pose_graph_dense, "pcg": tpg._optimize_pose_graph_pcg}[method]
    plain = solve(tg, cfg)
    hooked = solve(tg, cfg, reduce_fn=lambda x: x, reduce_max_fn=lambda x: x)
    for a, b in zip(plain, hooked):
        assert torch.equal(a, b)
    assert torch.equal(tpg._huber_schedule(tg, cfg),
                       tpg._huber_schedule(tg, cfg, reduce_max_fn=lambda x: x))
