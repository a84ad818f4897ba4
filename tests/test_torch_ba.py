"""The port's bundle adjustment (`radarslampy_tpu_torch/models/ba.py`) against
the JAX package's, on the problems of tests/test_ba.py and on one packed from
the synthetic loop map of tests/test_torch_loopclosure.py.

Bounds: the packed problem and the view table equal (including the JAX
table's last cell, written by every entry past V views); the analytic
observation Jacobians against `jax.jacfwd` within 1e-5; the Schur blocks
within 1e-5 of their largest entry; each LM solver against the same JAX
solver: poses and landmarks within 5e-3 m (headings 5e-4 rad), cost within
1e-3 relative; the port's PCG checked on the host after every sweep equal to
the same PCG checked once at its sweep cap (within 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radarslampy_tpu.config import SlamConfig as JaxConfig
from radarslampy_tpu.models import ba as jba
from radarslampy_tpu.models.frontend import MapState as JaxMapState
from radarslampy_tpu_torch.config import SlamConfig
from radarslampy_tpu_torch.interop import ba_problem_from_numpy
from radarslampy_tpu_torch.models import ba as tba
from radarslampy_tpu_torch.models.frontend import MapState
from tests.test_ba import _make_problem
from tests.test_torch_loopclosure import _square_loop_map

# The suite runs in several pytest-xdist worker processes on one host; one
# intra-op thread per worker keeps torch from oversubscribing its cores.
torch.set_num_threads(1)

XY_M, HEAD_RAD, COST_RTOL = 5e-3, 5e-4, 1e-3


def _maps():
    f, _ = _square_loop_map(seed=2)
    return (MapState(**{k: torch.from_numpy(np.array(v)) for k, v in f.items()}),
            JaxMapState(**{k: jnp.asarray(v) for k, v in f.items()}))


@pytest.fixture(scope="module")
def problems():
    """name -> (JAX problem, the port's problem)."""
    _, jm = _maps()
    jp = {"line": _make_problem(np.random.default_rng(1234), noise=0.02, pose_noise=0.3)[0],
          "loop_map": jba.build_ba_problem(jm, min_views=2)}
    return {k: (p, ba_problem_from_numpy(p, "cpu")) for k, p in jp.items()}


@pytest.mark.parametrize("kw", [dict(min_views=2), dict(min_views=3),
                                dict(min_views=2, max_landmarks=700, max_obs=1500)],
                         ids=["views2", "views3", "padded"])
def test_build_ba_problem_equal(kw):
    tm, jm = _maps()
    a, b = tba.build_ba_problem(tm, **kw), jba.build_ba_problem(jm, **kw)
    for f in tba.BAProblem._fields:
        x, y = getattr(a, f).numpy(), np.asarray(getattr(b, f))
        assert x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, f)
    assert int(a.lm_mask.sum()) > 50


@pytest.mark.parametrize("V", [8, 3])
@pytest.mark.parametrize("padded", [False, True])
def test_build_view_table_equal(V, padded):
    """V = 3 leaves many landmarks, the last one among them, with more views
    than the table holds; padding adds masked observations."""
    tm, jm = _maps()
    kw = dict(max_obs=1500) if padded else {}
    a = tba.build_ba_problem(tm, **kw)
    b = jba.build_ba_problem(jm, **kw)
    vt, jvt = tba.build_view_table(a, V).numpy(), np.asarray(jba.build_view_table(b, V))
    np.testing.assert_array_equal(vt, jvt)
    counts = np.bincount(np.asarray(b.obs_lm)[np.asarray(b.obs_mask)])
    if V == 3:
        assert counts[-1] > V and (counts > V).sum() > 10


def test_obs_jacobians_match_jacfwd(rng):
    n = 50
    pose = np.concatenate([rng.uniform(-200, 200, (n, 2)), rng.uniform(-4, 4, (n, 1))], 1)
    # landmarks within 10 m: d r / d theta is the predicted point itself, so
    # float32 rounding of its larger entries would exceed the bound
    lm = pose[:, :2] + rng.uniform(-10, 10, (n, 2))
    z = rng.uniform(-10, 10, (n, 2))
    pose, lm, z = (a.astype(np.float32) for a in (pose, lm, z))
    r, Jp, Jl, w = tba.obs_blocks(*(torch.from_numpy(a) for a in (pose, lm, z)), 1.0)
    jr = jax.vmap(jba._obs_residual)(pose, lm, z)
    jJp = jax.vmap(jax.jacfwd(jba._obs_residual, argnums=0))(pose, lm, z)
    jJl = jax.vmap(jax.jacfwd(jba._obs_residual, argnums=1))(pose, lm, z)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-5, rtol=0)
    np.testing.assert_allclose(Jp.numpy(), np.asarray(jJp), atol=1e-5, rtol=0)
    np.testing.assert_allclose(Jl.numpy(), np.asarray(jJl), atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["line", "loop_map"])
def test_schur_blocks_match_jax(problems, name):
    """At poses moved off the problem's start: there the loop map's landmarks
    sit at the mean of their views, so bl cancels to ~0."""
    p, tp = problems[name]
    hd, lam = 1.0, 1e-3
    shift = np.random.default_rng(5).normal(0, [0.3, 0.3, 0.02], p.poses.shape)
    poses = (np.asarray(p.poses) + shift).astype(np.float32)
    got = tba.schur_blocks(torch.from_numpy(poses), tp.landmarks, tp, hd, torch.tensor(lam))
    want = jba.schur_blocks(jnp.asarray(poses), p.landmarks, p, hd, jnp.float32(lam))
    for k, x, y in zip(("Hpp", "bs", "Hinv", "bl", "U"), got, want):
        y = np.asarray(y)
        np.testing.assert_allclose(x.numpy(), y, atol=1e-5 * np.abs(y).max(), rtol=0,
                                   err_msg=k)
    assert float(tba.ba_cost(tp.poses, tp.landmarks, tp, hd)) == pytest.approx(
        float(jba.ba_cost(p.poses, p.landmarks, p, hd)), rel=1e-5)


@pytest.fixture(scope="module")
def solved(problems):
    out = {}
    for name in ("line", "loop_map"):
        p, tp = problems[name]
        iters = 15 if name == "line" else 10
        for method in ("dense", "pcg"):
            jpo, jl, jc = jba.optimize_ba(p, JaxConfig(pg_iterations=iters), method=method)
            stats = {}
            tpo, tl, tc = tba.optimize_ba(tp, SlamConfig(pg_iterations=iters), method=method,
                                          stats=stats)
            out[name, method] = ((tpo.numpy(), tl.numpy(), float(tc)),
                                 (np.asarray(jpo), np.asarray(jl), float(jc)), stats)
    return out


@pytest.mark.parametrize("method", ["dense", "pcg"])
@pytest.mark.parametrize("name", ["line", "loop_map"])
def test_ba_matches_jax(solved, problems, name, method):
    (tpo, tl, tc), (jpo, jl, jc), stats = solved[name, method]
    np.testing.assert_allclose(tpo[:, :2], jpo[:, :2], atol=XY_M, rtol=0)
    np.testing.assert_allclose(tpo[:, 2], jpo[:, 2], atol=HEAD_RAD, rtol=0)
    np.testing.assert_allclose(tl, jl, atol=XY_M, rtol=0)
    assert tc == pytest.approx(jc, rel=COST_RTOL, abs=1e-6)
    p = problems[name][0]
    assert tc < float(jba.ba_cost(p.poses, p.landmarks, p, 1.0))   # LM moved downhill
    assert (stats["cg_sweeps"] > 0) == (method == "pcg")


def test_ba_pcg_checked_every_sweep_equals_one_check(problems):
    _, tp = problems["line"]
    cfg = SlamConfig(pg_iterations=15)
    every = tba._optimize_ba_pcg(tp, cfg, sweeps_per_check=1)
    once = tba._optimize_ba_pcg(tp, cfg, sweeps_per_check=8 * tp.poses.shape[0])
    for a, b in zip(every, once):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


def test_auto_picks_dense_up_to_512_poses(problems, monkeypatch):
    calls = []
    monkeypatch.setattr(tba, "_optimize_ba_dense", lambda p, cfg, v, **kw: calls.append("dense"))
    monkeypatch.setattr(tba, "_optimize_ba_pcg", lambda p, cfg, **kw: calls.append("pcg"))
    _, tp = problems["line"]
    tba.optimize_ba(tp, SlamConfig())
    tba.optimize_ba(tp._replace(poses=torch.zeros(513, 3)), SlamConfig())
    assert calls == ["dense", "pcg"]


@pytest.mark.parametrize("method", ["dense", "pcg"])
def test_identity_reduction_hook_changes_no_bit(problems, method):
    """The sharded solvers' hook `reduce_fn`, given the identity, returns
    what the solvers return without it, bit for bit."""
    _, tp = problems["loop_map"]
    cfg = SlamConfig(pg_iterations=10)
    if method == "dense":
        plain, hooked = (tba._optimize_ba_dense(tp, cfg, 8, **kw)
                         for kw in ({}, dict(reduce_fn=lambda x: x)))
    else:
        plain, hooked = (tba._optimize_ba_pcg(tp, cfg, **kw)
                         for kw in ({}, dict(reduce_fn=lambda x: x)))
    for a, b in zip(plain, hooked):
        assert torch.equal(a, b)
