"""The port's CUDA kernels on the card, held against their plain twins.

Marked `cuda`; they skip without a CUDA device.  This file imports no JAX, so
it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from radarslampy_tpu_torch.ops.cuda import doh_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


# 2048: the reference grid; 1025: rows not a multiple of 16 bytes (scalar
# stores); 1000 and 77: no multiple of the tile sizes
@pytest.mark.parametrize("size", [1024, 1000, 77, 1025, 2048])
@pytest.mark.parametrize("sigmas", [(1.0, 5.0, 10.0), (0.1, 2.0), (2.0, 4.0)])
def test_doh_kernel_matches_twin(cuda, size, sigmas):
    g = torch.Generator(device=cuda).manual_seed(size)
    img = torch.rand((size, size), generator=g, device=cuda)
    img = torch.nn.functional.avg_pool2d(img[None, None], 5, 1, 2)[0, 0].contiguous()
    filters = doh_cuda.build_doh_filters(sigmas, cuda)
    before = doh_cuda.launches
    out = doh_cuda.doh_response(img, filters)
    assert doh_cuda.launches == before + 1
    ref = doh_cuda.doh_response_reference(img, filters)
    torch.cuda.synchronize()
    # float-order differences of the blur, amplified by sigma^4 (up to 1e4):
    # 2e-3 * max|ref| as in tests/test_doh_pallas.py, each sigma slice against
    # its own max
    for s in range(len(sigmas)):
        tol = 2e-3 * float(ref[s].abs().max())
        assert tol > 0
        assert float((out[s] - ref[s]).abs().max()) <= tol, f"sigma {sigmas[s]}"


def test_doh_kernel_is_deterministic_and_launches_once(cuda):
    g = torch.Generator(device=cuda).manual_seed(7)
    img = torch.rand((1024, 1024), generator=g, device=cuda)
    filters = doh_cuda.build_doh_filters((1.0, 5.0, 10.0), cuda)
    before = doh_cuda.launches
    a = doh_cuda.doh_response(img, filters)
    assert doh_cuda.launches == before + 1
    b = doh_cuda.doh_response(img, filters)
    assert doh_cuda.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_doh_kernel_refuses_radius_beyond_shared_memory(cuda):
    r = doh_cuda.max_radius() + 1
    taps = torch.zeros(2 * r + 1)
    taps[r] = 1.0
    filters = doh_cuda.filters_from_taps([taps.numpy()], (40.0,), cuda)
    before = doh_cuda.launches
    with pytest.raises(ValueError, match="shared memory"):
        doh_cuda.doh_response(torch.rand(256, 256, device=cuda), filters)
    assert doh_cuda.launches == before


def test_doh_kernel_refuses_bad_input(cuda):
    filters = doh_cuda.build_doh_filters((1.0, 5.0), cuda)
    with pytest.raises(ValueError):
        doh_cuda.doh_response(torch.rand(64, 64, device=cuda, dtype=torch.float64), filters)
    with pytest.raises(ValueError):
        doh_cuda.doh_response(torch.rand(64, 128, device=cuda)[:, ::2], filters)
    with pytest.raises(ValueError):
        doh_cuda.doh_response(torch.rand(64, 64, device=cuda),
                              doh_cuda.build_doh_filters((1.0,), "cpu"))


def test_scatter_add_is_deterministic(cuda):
    """The back-end's scatter-add (ops/scatter.py) gives the same bits on two
    runs on the card, where `index_add_` would sum with atomics."""
    from radarslampy_tpu_torch.ops.scatter import scatter_add

    g = torch.Generator(device=cuda).manual_seed(3)
    idx = torch.randint(0, 64, (200_000,), generator=g, device=cuda)
    vals = torch.randn((200_000, 3, 3), generator=g, device=cuda)
    zeros = torch.zeros((64, 3, 3), device=cuda)
    a, b = scatter_add(zeros, idx, vals), scatter_add(zeros, idx, vals)
    ref = torch.zeros((64, 3, 3), dtype=torch.float64).index_add_(0, idx.cpu(),
                                                                  vals.cpu().double())
    mag = torch.zeros((64, 3, 3), dtype=torch.float64).index_add_(0, idx.cpu(),
                                                                  vals.cpu().double().abs())
    assert torch.equal(a, b)
    # ~3,000 float32 terms a cell, summed in index order: far inside 1e-5 of
    # the sum of their magnitudes
    assert bool(((a.cpu().double() - ref).abs() <= 1e-5 * mag).all())


def _ring_graph(M, radius, noise, seed):
    """A ring of M poses: noisy odometry edges, one exact loop edge, poses
    initialised by integrating the odometry (tests/test_posegraph.py's ring,
    built here without JAX)."""
    import numpy as np

    from radarslampy_tpu_torch.models.posegraph import PoseGraph

    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, M, endpoint=False)
    gt = np.stack([radius * np.cos(th), radius * np.sin(th), th + np.pi / 2], 1)

    def rel(a, b):
        c, s = np.cos(a[2]), np.sin(a[2])
        d = b[:2] - a[:2]
        return [c * d[0] + s * d[1], -s * d[0] + c * d[1],
                (b[2] - a[2] + np.pi) % (2 * np.pi) - np.pi]

    ij = np.stack([np.arange(M), (np.arange(M) + 1) % M], 1)
    meas = np.array([rel(gt[i], gt[j]) for i, j in ij])
    meas[:-1] += rng.normal(0, noise, (M - 1, 3))
    init = gt.copy()
    for i in range(M - 1):
        c, s = np.cos(init[i, 2]), np.sin(init[i, 2])
        d = meas[i]
        init[i + 1] = [init[i, 0] + c * d[0] - s * d[1], init[i, 1] + s * d[0] + c * d[1],
                       init[i, 2] + d[2]]
    t = torch.from_numpy
    return PoseGraph(poses=t(init.astype(np.float32)), node_mask=torch.ones(M, dtype=torch.bool),
                     edges_ij=t(ij), edges_meas=t(meas.astype(np.float32)),
                     edges_info=torch.tensor([10.0, 10.0, 40.0]).expand(M, 3).clone(),
                     edge_mask=torch.ones(M, dtype=torch.bool))


def test_pcg_graph_replay_matches_eager_sweeps_and_the_cpu(cuda):
    """The card's PCG replays its sweeps from a CUDA graph after the first host
    check. On a 300-pose ring, two runs give the same bits, and the same PCG
    checked once at its sweep cap (no graph) lands within 1e-6. Card against
    CPU on the 24-pose ring of the CPU parity test (25 LM iterations): within
    its bound against JAX (tests/test_torch_posegraph.py: 1e-3 m, 1e-4 rad);
    an LM stopped far from convergence amplifies the devices' float-order
    differences beyond it."""
    from radarslampy_tpu_torch.config import SlamConfig
    from radarslampy_tpu_torch.models import posegraph as tpg

    big = _ring_graph(300, 40.0, 0.02, 0)
    cfg = SlamConfig(pg_iterations=10)
    gc = tpg.PoseGraph(*(x.to(cuda) for x in big))
    replay, _ = tpg._optimize_pose_graph_pcg(gc, cfg)
    again, _ = tpg._optimize_pose_graph_pcg(gc, cfg)
    once, _ = tpg._optimize_pose_graph_pcg(gc, cfg, sweeps_per_check=8 * 300)
    assert torch.equal(replay, again)
    assert float((replay - once).abs().max()) <= 1e-6

    ring = _ring_graph(24, 20.0, 0.05, 1234)
    cfg = SlamConfig(pg_iterations=25)
    card, _ = tpg._optimize_pose_graph_pcg(tpg.PoseGraph(*(x.to(cuda) for x in ring)), cfg)
    cpu, _ = tpg._optimize_pose_graph_pcg(ring, cfg)
    d = (card.cpu() - cpu).abs().max(0).values
    assert float(d[:2].max()) <= 1e-3 and float(d[2]) <= 1e-4


def _line_ba_problem(M, L, noise, pose_noise, seed):
    """Poses on a line 5 m apart, each landmark seen by 3 consecutive poses
    near it (tests/test_ba.py's problem, built here without JAX, with views
    that chain the poses, so that PCG needs many sweeps)."""
    import numpy as np

    from radarslampy_tpu_torch.models.ba import BAProblem

    rng = np.random.default_rng(seed)
    gt = np.stack([np.arange(M) * 5.0, np.zeros(M), rng.uniform(-0.3, 0.3, M)], 1)
    first = rng.integers(0, M - 2, L)
    lms = np.stack([first * 5.0 + rng.uniform(-5, 15, L), rng.uniform(-30, 30, L)], 1)
    obs_pose = (first[:, None] + np.arange(3)).reshape(-1)
    obs_lm = np.repeat(np.arange(L), 3)
    c, s = np.cos(gt[obs_pose, 2]), np.sin(gt[obs_pose, 2])
    d = lms[obs_lm] - gt[obs_pose, :2]
    xy = np.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1]], 1)
    xy += rng.normal(0, noise, xy.shape)
    init = gt + rng.normal(0, pose_noise, gt.shape)
    init[0] = gt[0]
    init_lms = lms + rng.normal(0, pose_noise * 2 + 0.01, lms.shape)
    t = torch.from_numpy
    return BAProblem(poses=t(init.astype(np.float32)), pose_mask=torch.ones(M, dtype=torch.bool),
                     landmarks=t(init_lms.astype(np.float32)),
                     lm_mask=torch.ones(L, dtype=torch.bool), obs_pose=t(obs_pose),
                     obs_lm=t(obs_lm), obs_xy=t(xy.astype(np.float32)),
                     obs_mask=torch.ones(3 * L, dtype=torch.bool))


def _ranks_module():
    """tests/torch_dist_ranks.py loaded from its path: where another package
    named `tests` is installed (the card machine has one), `tests.` does not
    reach this directory."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "torch_dist_ranks", Path(__file__).with_name("torch_dist_ranks.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("world", [1, 4])
def test_sharded_pcg_captures_its_all_reduce(cuda, tmp_path, world):
    """NCCL ranks, one card each, through the spawner: the sharded PCG pose
    graph (a 200-pose ring) and BA (100 poses, 400 landmarks) replay their
    sweeps from a CUDA graph holding the all-reduce, equal bit for bit to
    their eager sharded sweeps; at one rank also to the single-device
    solves, at more within tests/test_torch_parallel.py's bounds.  Traced
    (one LM iteration, 4 checks' sweeps), the replays launch as many NCCL
    kernels a sweep as the eager all-reduces launch a call, and each
    replayed sweep holds one all-reduce when NCCL launches one a call (more
    than one rank; a one-rank in-place sum launches nothing)."""
    from radarslampy_tpu_torch.models.posegraph import SWEEPS_PER_CHECK

    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} cards")
    meshes = {1: ("w1",), 4: ("w4", "w2")}[world]
    inputs = dict(cfg=dict(pg_iterations=3), meshes=meshes,
                  ring=tuple(_ring_graph(200, 40.0, 0.02, 0)),
                  ba=tuple(_line_ba_problem(100, 400, 0.02, 0.3, 5)))
    ranks = _ranks_module().spawn("sharded_cg_card", world, tmp_path, inputs, 600,
                                  backend="nccl")
    for mesh in meshes:
        out = ranks[0][mesh]
        for solver in ("pg", "ba"):
            cap, eager, single = (out[solver, k] for k in ("captured", "eager", "single"))
            for a, b in zip(cap[:-1], eager[:-1], strict=True):
                assert torch.equal(a, b), (mesh, solver)
            assert cap[-1]["cg_sweeps"] == eager[-1]["cg_sweeps"] > 0
            assert cap[-1]["cg_captures"] > 0 and eager[-1]["cg_captures"] == 0
            poses, cost = cap[0], cap[-2]
            if mesh == "w1":
                for a, b in zip(cap[:-1], single[:-1], strict=True):
                    assert torch.equal(a, b), (mesh, solver)
            else:  # tests/test_torch_parallel.py's bounds
                assert float((poses - single[0]).abs().max()) <= 1e-3, (mesh, solver)
                assert abs(float(cost) - float(single[-2])) <= 1e-3 * abs(float(single[-2])) + 1e-4
        (cap_t, cap_pg, cap_ba), (eager_t, *_) = out["trace", True], out["trace", False]
        replays = cap_pg["cg_batches"] + cap_ba["cg_batches"]
        print(f"{mesh} on {torch.cuda.get_device_name(0)}: captured trace {cap_t}, "
              f"eager trace {eager_t}; sweeps {out['pg', 'captured'][-1]['cg_sweeps']} + "
              f"{out['ba', 'captured'][-1]['cg_sweeps']}")
        per_call = eager_t["eager_nccl"] / eager_t["allreduce_calls"]
        assert cap_t["replays"] == replays > 0 and cap_t["replays_without_events"] == 0
        assert cap_t["replayed_nccl"] == per_call * SWEEPS_PER_CHECK * replays, (cap_t, eager_t)
        assert cap_t["eager_nccl"] + cap_t["replayed_nccl"] == eager_t["eager_nccl"]
        if mesh != "w1":
            assert per_call == 1


def _dense_case(cuda, case):
    """(solve(replay, stats) -> the solve's tensors, the LM iterations) for a
    dense pose graph on a ring of 256 or 1,024 poses (1,024: the rows the
    online pass pads its map to) or dense BA on 49 poses and 350 landmarks."""
    from radarslampy_tpu_torch.config import SlamConfig
    from radarslampy_tpu_torch.models.ba import BAProblem, optimize_ba
    from radarslampy_tpu_torch.models.posegraph import PoseGraph, optimize_pose_graph

    cfg = SlamConfig()
    if case == "ba":
        p = BAProblem(*(x.to(cuda) for x in _line_ba_problem(49, 350, 0.02, 0.3, 5)))
        return (lambda replay, st: optimize_ba(p, cfg, method="dense", stats=st,
                                               replay=replay)), cfg.pg_iterations
    M = {"pg256": 256, "pg1024": 1024}[case]
    g = PoseGraph(*(x.to(cuda) for x in _ring_graph(M, 40.0, 0.02, 0)))
    return (lambda replay, st: optimize_pose_graph(g, cfg, "dense", st, replay)), \
        cfg.pg_iterations


@pytest.mark.parametrize("case", ["pg256", "pg1024", "ba"])
def test_dense_lm_graph_equals_the_eager_loop(cuda, case):
    """The dense LM captured once and replayed `pg_iterations` - 1 times
    gives the bits of the same iterations run eagerly (`replay=False`)."""
    solve, n = _dense_case(cuda, case)
    st, st_e = {}, {}
    captured, eager = solve(True, st), solve(False, st_e)
    torch.cuda.synchronize()
    for a, b in zip(captured, eager, strict=True):
        assert torch.equal(a, b), case
    assert bool(torch.isfinite(captured[0]).all())
    assert (st["lm_captures"], st["lm_replays"]) == (1, n - 1)
    assert (st_e["lm_captures"], st_e["lm_replays"]) == (0, 0)
    print(f"{case} on {torch.cuda.get_device_name(0)}: capture {st['lm_capture_s'] * 1e3:.1f} "
          f"ms, {n - 1} replays {st['lm_replay_s'] * 1e3:.2f} ms")


@pytest.mark.parametrize("case", ["pg1024", "ba"])
def test_dense_lm_graph_frees_its_pool(cuda, case):
    """Once a captured solve returns, the graph's private pool is released:
    the memory allocated is what it was before the solve (a first solve
    warms up the library workspaces, which stay)."""
    import gc

    solve, _ = _dense_case(cuda, case)
    solve(True, {})
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    out = solve(True, {})
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    del out
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == before, held


def test_dense_lm_capture_that_reads_to_the_host_raises(cuda):
    """A body that reads a value to the host cannot be captured: the driver
    raises, after one eager iteration and the one call it tried to capture,
    and runs no eager iteration in the graph's place."""
    from radarslampy_tpu_torch.models.posegraph import lm_iterations

    calls = []

    def body(carry):
        calls.append(1)
        x, = carry
        return (x * (2.0 if float(x.sum()) > 0 else 3.0),)

    with pytest.raises(RuntimeError):
        lm_iterations(body, (torch.ones(4, device=cuda),), 5)
    torch.cuda.synchronize()
    assert len(calls) == 2


@pytest.mark.parametrize("world", [1, 4])
def test_sharded_dense_lm_captures_its_all_reduce(cuda, tmp_path, world):
    """NCCL ranks, one card each, through the spawner: the sharded dense pose
    graph (a 256-pose ring) and BA (49 poses, 350 landmarks) captured once and
    replayed, equal bit for bit to their eager runs (`replay=False`); at one
    rank also to the single-device solves, at more within
    tests/test_torch_parallel.py's bounds.  Traced at 3 LM iterations, each
    replay launches one NCCL all-reduce kernel for each all-reduce of the body
    (the pose graph's cost, H, b and candidate cost; BA's H, right-hand side
    and candidate cost) when NCCL launches one a call (more than one rank; a
    one-rank in-place sum launches nothing), and the windows launch the same
    NCCL kernels captured and eager."""
    from radarslampy_tpu_torch.config import SlamConfig

    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} cards")
    meshes = {1: ("w1",), 4: ("w4", "w2")}[world]
    trace_n, allreduces = 3, {"pg": 4, "ba": 3}
    inputs = dict(cfg={}, meshes=meshes, trace_iterations=trace_n,
                  ring=tuple(_ring_graph(256, 40.0, 0.02, 0)),
                  ba=tuple(_line_ba_problem(49, 350, 0.02, 0.3, 5)))
    ranks = _ranks_module().spawn("dense_lm_card", world, tmp_path, inputs, 600,
                                  backend="nccl")
    n = SlamConfig().pg_iterations
    for mesh in meshes:
        out = ranks[0][mesh]
        for solver in ("pg", "ba"):
            cap, eager, single = (out[solver, k] for k in ("captured", "eager", "single"))
            for a, b in zip(cap[:-1], eager[:-1], strict=True):
                assert torch.equal(a, b), (mesh, solver)
            assert (cap[-1]["lm_captures"], cap[-1]["lm_replays"]) == (1, n - 1)
            assert eager[-1]["lm_captures"] == 0
            if mesh == "w1":
                for a, b in zip(cap[:-1], single[:-1], strict=True):
                    assert torch.equal(a, b), (mesh, solver)
            else:  # tests/test_torch_parallel.py's bounds
                assert float((cap[0] - single[0]).abs().max()) <= 1e-3, (mesh, solver)
                c, ref = float(cap[-2]), float(single[-2])
                assert abs(c - ref) <= 1e-3 * abs(ref) + 1e-4, (mesh, solver)
            (cap_t, cap_st), (eager_t, _) = out["trace", solver, True], out["trace", solver, False]
            print(f"{mesh} {solver} on {torch.cuda.get_device_name(0)}: captured trace {cap_t}, "
                  f"eager trace {eager_t}")
            per_call = eager_t["eager_nccl"] / eager_t["allreduce_calls"]
            assert cap_t["replays"] == cap_st["lm_replays"] == trace_n - 1
            assert cap_t["replays_without_events"] == 0
            assert cap_t["replayed_nccl"] == per_call * allreduces[solver] * (trace_n - 1)
            assert cap_t["eager_nccl"] + cap_t["replayed_nccl"] == eager_t["eager_nccl"]
            if mesh != "w1":
                assert per_call == 1


# The small grid of tests/test_torch_render_device.py
RENDER_KW = dict(cart_size=512, cart_downsample=8, n_candidates=256, anms_top_k=100,
                 k_max=128, max_keyframes=128)


@pytest.mark.parametrize("mode", ["max", "sum"])
def test_renderer_on_the_card_matches_the_cpu(cuda, mode):
    """The device renderer on the card and on the CPU at noise 0, held as
    tests/test_torch_render_device.py holds it against JAX's: "sum" within
    1e-4; "max" (a blob centre can round to the next cell) 99.5% of pixels
    within 1e-3 and mean under 1e-4; after quantize_u8 at most 0.5% of
    pixels differ."""
    import numpy as np

    from radarslampy_tpu_torch.config import SlamConfig
    from radarslampy_tpu_torch.sim import fakedata as fd
    from radarslampy_tpu_torch.sim.render_device import quantize_u8, render_polar_scan_device

    cfg = SlamConfig(**RENDER_KW)
    wp, wr = fd.make_world(np.random.default_rng(3), 300, 120.0)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        def t(x):
            return torch.as_tensor(x, dtype=torch.float32, device=dev)

        out[dev.type] = render_polar_scan_device(
            t(wp), t(wr), t([5.0, -3.0, 0.4]), t([8.0, 0.5, 0.05]), None, cfg, noise=0.0,
            k_vis=256, mode=mode)
    card, cpu = out["cuda"].cpu(), out["cpu"]
    d = (card - cpu).abs()
    if mode == "sum":
        assert float(d.max()) <= 1e-4
    else:
        assert float(torch.quantile(d.flatten().double(), 0.995)) < 1e-3
        assert float(d.mean()) < 1e-4
    assert float((quantize_u8(card) != quantize_u8(cpu)).double().mean()) <= 5e-3
    assert (cpu > 0.1).sum() > 100


def test_device_render_eval_on_the_card_matches_the_cpu(cuda):
    """One short device-render eval (9 frames, chunks of 4 with a padded
    tail) on the card and on the CPU at noise 0: the same keyframes and
    retrack count; poses within the bound of tests/test_torch_sequence.py
    for two runs that each carry their own state (0.1728 m, 1/512 rad): a
    float-order difference in KLT or the renderer can flip one inlier of the
    peeling, which moves a pose by centimetres (measured on an H100: 2.7e-2 m
    at frame 7)."""
    import numpy as np

    from radarslampy_tpu_torch import evaluation
    from radarslampy_tpu_torch.config import SlamConfig

    radius = 2.2 / (2 * np.sin(np.pi / 40))
    th = 2 * np.pi / 40 * np.concatenate([[0.0], np.cumsum(np.minimum(1.0, np.arange(1, 9) / 4))])
    poses = np.stack([radius * np.sin(th), radius * (1 - np.cos(th)), th], 1)
    cfg = SlamConfig(**RENDER_KW)
    res = {dev: evaluation.evaluate_sequence(poses, cfg, seed=2, noise=0.0, chunk_frames=4,
                                             return_state=True, device=dev)
           for dev in ("cuda", "cpu")}
    a, b = res["cuda"], res["cpu"]
    d = np.abs(a.est_frames - b.est_frames)
    assert float(d[:, :2].max()) <= 0.1728 and float(d[:, 2].max()) <= 1.0 / 512
    assert (a.n_keyframes, a.n_retracks) == (b.n_keyframes, b.n_retracks)
    assert torch.equal(a.final_state.map.frame_ids.cpu(), b.final_state.map.frame_ids)


def test_png_decode_feeds_the_card_step(cuda, tmp_path):
    """Oxford PNGs decoded the way the driver decodes them (the native pool
    where it builds, else PIL) give the written bytes, and the step on the
    card over them equals the step over the written frames bit for bit."""
    import numpy as np

    from radarslampy_tpu_torch.config import SlamConfig
    from radarslampy_tpu_torch.io import native_loader, oxford
    from radarslampy_tpu_torch.models import frontend as F
    from radarslampy_tpu_torch.models import system as S
    from radarslampy_tpu_torch.sim import fakedata as fd
    from radarslampy_tpu_torch.sim import oxford_files

    cfg = SlamConfig(cart_size=256, cart_downsample=16, n_candidates=256, max_keyframes=16)
    poses = np.array([[0.0, 0.0, 0.0], [1.8, 0.0, 0.04], [3.6, 0.07, 0.08]])
    frames = np.stack([np.clip(np.round(s * 255.0), 0, 255).astype(np.uint8)
                       for _, s in fd.render_sequence(np.random.default_rng(2), poses, cfg,
                                                      n_landmarks=1200, noise=0.01)])
    oxford_files.write_sequence(str(tmp_path), "s", poses, cfg, frames)
    sp = oxford.sequence_paths(str(tmp_path), "s")
    paths = oxford.radar_image_paths(sp["radar"], sp["timestamps"])
    loader = (native_loader.NativeLoader if native_loader.native_available()
              else S._Prefetcher)
    decoded = [f.power for f in loader(paths, cfg, raw_u8=True)]
    frames[:, :, cfg.clipped_range_bins:] = 0
    assert np.array_equal(np.stack(decoded), frames)
    maps = F.build_frame_maps(cfg, cuda)
    outs = []
    for scans in (decoded, list(frames)):
        state = F.init_state(scans[0], np.zeros(3), maps, cfg)
        for scan in scans[1:]:
            state, out = F.slam_step(state, scan, maps, cfg)
        outs.append(out)
    torch.cuda.synchronize()
    for field in F.StepOutput._fields:
        assert torch.equal(getattr(outs[0], field), getattr(outs[1], field)), field


def test_bench_on_the_card(cuda):
    """The bench at SlamConfig() over 10 measured frames, one trial of each
    path: its checks hold (equal states and counts, ATE under 5 m) and the
    device readings are there."""
    from torch.profiler import ProfilerActivity, profile

    from radarslampy_tpu_torch import bench
    from radarslampy_tpu_torch.config import SlamConfig

    # a trace before the bench's own, as in chip_smoke.py, where the bench's
    # follows others in the same process; the bench's must still lose nothing
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(8, device=cuda).sum().item()
    res = bench.run_bench(SlamConfig(), cuda, frames=10, trials=1, chunk=4, trace_frames=3)
    assert res["device"] == "cuda" and res["device_kind"] == torch.cuda.get_device_name(0)
    assert res["power_limit_w"] > 0 and 0.0 <= res["device_idle_share"] <= 1.0
    assert res["doh_device_ms"] > 0 and res["doh_bound_share"] > 0
    assert res["ate_m"] < bench.ATE_LIMIT_M and res["keyframes"] == 10
    assert all(res[f"{p}_fps"] > 0 for p in bench.PATHS)
    # one launch a frame on each path and trial (the step detects on every
    # frame and selects), plus each trial's init and the traced windows
    assert res["doh_launches"] == {p: 10 for p in bench.PATHS}
    assert res["doh_launches_total"] >= 3 * (1 + 10) + 1


GRAPH_KW = dict(cart_size=256, cart_downsample=16, n_candidates=256, max_keyframes=16)


def _graph_case(cuda, n=6):
    """Maps, init_state and u8 frames (one a scan of noise: a coast) of a
    short track at a small config, on the card."""
    import numpy as np

    from radarslampy_tpu_torch.config import SlamConfig
    from radarslampy_tpu_torch.models import frontend as F
    from radarslampy_tpu_torch.sim import fakedata as fd

    cfg = SlamConfig(**GRAPH_KW)
    poses = np.array([[1.2 * t, 0.0, 0.0] for t in range(n)])
    frames = np.stack([np.clip(np.round(s * 255.0), 0, 255).astype(np.uint8)
                       for _, s in fd.render_sequence(np.random.default_rng(3), poses, cfg,
                                                      n_landmarks=1200, noise=0.01)])
    frames[-2] = np.random.default_rng(4).integers(0, 40, frames.shape[1:], dtype=np.uint8)
    maps = F.build_frame_maps(cfg, cuda)
    frames = torch.as_tensor(frames, device=cuda)
    return cfg, maps, F.init_state(frames[0], np.zeros(3), maps, cfg), frames


def test_step_graph_equals_the_eager_step(cuda):
    """A fresh StepGraph's replays against slam_step, frame after frame: the
    packed outputs and the state bit for bit; one DoH launch a frame on
    either (and one more for the first step's warm-up)."""
    from radarslampy_tpu_torch.models import frontend as F
    from radarslampy_tpu_torch.utils.checkpoint import states_equal

    cfg, maps, state, frames = _graph_case(cuda)
    g = F.StepGraph(maps, cfg)
    g.load(state)
    for k, f in enumerate(frames[1:]):
        before = doh_cuda.launches
        state, out = F.slam_step(state, f, maps, cfg)
        assert doh_cuda.launches == before + 1
        row = g.step(f)
        assert doh_cuda.launches == before + (3 if k == 0 else 2)
        assert torch.equal(row, F.pack_output(out))
        assert states_equal(g.state, state)
    assert states_equal(g.snapshot(), state)


def test_step_graph_counts_replays(cuda):
    from radarslampy_tpu_torch.models import frontend as F

    cfg, maps, state, frames = _graph_case(cuda)
    g = F.StepGraph(maps, cfg)
    g.load(state)
    before = doh_cuda.launches
    g.step(frames[1])
    # the warm-up step and the first replay; the capture adds none
    assert doh_cuda.launches == before + 2
    before = doh_cuda.launches
    for f in frames[2:]:
        g.step(f)
    assert doh_cuda.launches == before + len(frames) - 2


def test_chunk_does_not_sync(cuda):
    """slam_step_chunk on the card under set_sync_debug_mode("error"), once
    its graph is captured; equal to the eager loop bit for bit."""
    from radarslampy_tpu_torch.models import frontend as F
    from radarslampy_tpu_torch.utils.checkpoint import states_equal

    cfg, maps, state0, frames = _graph_case(cuda)
    g = F.StepGraph(maps, cfg)
    g.load(state0)
    g.step(frames[1])       # captures
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s_c, outs = F.slam_step_chunk(state0, frames[1:], maps, cfg, g)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    state = state0
    for k, f in enumerate(frames[1:]):
        state, out = F.slam_step(state, f, maps, cfg)
        assert torch.equal(F.pack_output(F.StepOutput(*(x[k] for x in outs))),
                           F.pack_output(out))
    assert states_equal(s_c, state)
    assert int(state0.map.cursor) == 1      # the chunk's input state is left as it was


def test_failed_capture_raises(cuda, monkeypatch):
    """A step that cannot be captured (here: one that reads a value to the
    host) raises from `step`; nothing runs the eager step in its place."""
    from radarslampy_tpu_torch.models import frontend as F

    cfg, maps, state, frames = _graph_case(cuda, n=3)
    real = F._slam_step

    def reads_to_host(*args, **kwargs):
        new, out = real(*args, **kwargs)
        out.n_inliers.item()
        return new, out

    monkeypatch.setattr(F, "_slam_step", reads_to_host)
    g = F.StepGraph(maps, cfg)
    g.load(state)
    eager = []
    monkeypatch.setattr(F, "slam_step", lambda *a, **k: eager.append(1))
    with pytest.raises(RuntimeError):
        g.step(frames[1])
    torch.cuda.synchronize()
    assert eager == [] and not g._graphs


def test_graph_keeps_the_tables_it_captured(cuda):
    """A captured StepGraph reads the step's device tables (filter taps,
    constants, the DoH schedule) by address.  With every table cache cleared
    and the freed memory taken by other tensors, its replays still equal
    slam_step bit for bit: the graph holds the tables it captured."""
    import gc

    from radarslampy_tpu_torch.models import frontend as F
    from radarslampy_tpu_torch.ops import features, motion, tracking
    from radarslampy_tpu_torch.utils.checkpoint import states_equal

    cfg, maps, state, frames = _graph_case(cuda)
    g = F.StepGraph(maps, cfg)
    g.load(state)
    state, out = F.slam_step(state, frames[1], maps, cfg)
    assert torch.equal(g.step(frames[1]), F.pack_output(out))
    assert g._tables
    for cached in (features._gaussian_taps, features._sigma_table, tracking._binomial_taps,
                   motion._information, doh_cuda._launch_plan):
        cached.cache_clear()
    gc.collect()
    # small blocks of NaN where the freed tables would have been
    filler = [torch.full((n,), float("nan"), device=cuda)
              for n in (1, 3, 5, 16, 61, 128, 512) for _ in range(512)]
    for f in frames[2:]:
        state, out = F.slam_step(state, f, maps, cfg)
        assert torch.equal(g.step(f), F.pack_output(out))
        assert states_equal(g.state, state)
    del filler


@pytest.mark.parametrize("size", [1024, 1000])
def test_batched_doh_kernel_equals_single_launches(cuda, size):
    """One launch over D images against D launches of one image each: equal
    bit for bit (each image's arithmetic does not depend on the batch), one
    launch counted; through vmap's batching rule too; each image against the
    twin with the tolerance above."""
    D = 4
    g = torch.Generator(device=cuda).manual_seed(size + 1)
    imgs = torch.rand((D, size, size), generator=g, device=cuda)
    imgs = torch.nn.functional.avg_pool2d(imgs[:, None], 5, 1, 2)[:, 0].contiguous()
    filters = doh_cuda.build_doh_filters((1.0, 5.0, 10.0), cuda)
    before = doh_cuda.launches
    out = doh_cuda.doh_response(imgs, filters)
    assert doh_cuda.launches == before + 1 and out.shape == (D, 3, size, size)
    vm = torch.func.vmap(lambda x: doh_cuda.doh_response(x, filters))(imgs)
    assert doh_cuda.launches == before + 2
    singles = [doh_cuda.doh_response(imgs[d], filters) for d in range(D)]
    torch.cuda.synchronize()
    assert torch.equal(vm, out)
    for d in range(D):
        assert torch.equal(out[d], singles[d]), d
        ref = doh_cuda.doh_response_reference(imgs[d], filters)
        for s in range(3):
            tol = 2e-3 * float(ref[s].abs().max())
            assert float((out[d, s] - ref[s]).abs().max()) <= tol, (d, s)


def _batched_case(cuda, D=3, n=5):
    """D segments of `_graph_case`'s track at shifted starts, as u8 frames
    [D, n, A, W] on the card, and the maps."""
    import numpy as np

    from radarslampy_tpu_torch.config import SlamConfig
    from radarslampy_tpu_torch.models import frontend as F
    from radarslampy_tpu_torch.sim import fakedata as fd

    cfg = SlamConfig(**GRAPH_KW)
    frames = []
    for d in range(D):
        poses = np.array([[1.2 * t + 5.0 * d, 0.3 * d, 0.01 * t] for t in range(n)])
        frames.append(np.stack([np.clip(np.round(s * 255.0), 0, 255).astype(np.uint8)
                                for _, s in fd.render_sequence(np.random.default_rng(3), poses,
                                                               cfg, n_landmarks=1200,
                                                               noise=0.01)]))
    frames = np.stack(frames)
    frames[-1, -2] = np.random.default_rng(4).integers(0, 40, frames.shape[2:], dtype=np.uint8)
    return cfg, F.build_frame_maps(cfg, cuda), torch.as_tensor(frames, device=cuda)


def _single_graph_runs(cfg, maps, frames):
    """Each segment through a StepGraph of its own: its rows [n - 1, 13] and
    final state."""
    import numpy as np

    from radarslampy_tpu_torch.models import frontend as F

    runs = []
    for seg in frames:
        g = F.StepGraph(maps, cfg)
        g.load(F.init_state(seg[0], np.zeros(3), maps, cfg))
        rows = torch.stack([g.step(f).clone() for f in seg[1:]])
        runs.append((rows, g.snapshot()))
    return runs


def test_batched_graph_equals_single_step_graphs(cuda):
    """StepGraph(batch=D) against D StepGraphs stepped in turn: every packed
    row and the final state of every segment bit for bit; one DoH launch a
    frame for all D (and one for the capture's warm-up step)."""
    from radarslampy_tpu_torch.models import frontend as F
    from radarslampy_tpu_torch.utils.checkpoint import states_equal

    cfg, maps, frames = _batched_case(cuda)
    D = len(frames)
    singles = _single_graph_runs(cfg, maps, frames)
    before = doh_cuda.launches
    s0 = F.batched_init_state(frames[:, 0], torch.zeros(D, 3), maps, cfg)
    assert doh_cuda.launches == before + 1
    g = F.StepGraph(maps, cfg, batch=D)
    g.load(s0)
    rows = []
    for t in range(1, frames.shape[1]):
        before = doh_cuda.launches
        rows.append(g.step(frames[:, t]).clone())
        assert doh_cuda.launches == before + (2 if t == 1 else 1)
    rows = torch.stack(rows)
    for d, (r, s) in enumerate(singles):
        assert torch.equal(rows[:, d], r), d
        assert states_equal(F.unstack_states(g.snapshot())[d], s), d


def test_batched_graph_keeps_the_tables_it_captured(cuda):
    """A captured batched graph with every table cache cleared (the DoH
    schedule of D images among them) and the freed memory refilled: its
    replays still equal the single StepGraphs bit for bit."""
    import gc

    from radarslampy_tpu_torch.models import frontend as F
    from radarslampy_tpu_torch.ops import features, motion, tracking
    from radarslampy_tpu_torch.utils.checkpoint import states_equal

    cfg, maps, frames = _batched_case(cuda)
    D = len(frames)
    singles = _single_graph_runs(cfg, maps, frames)
    g = F.StepGraph(maps, cfg, batch=D)
    g.load(F.batched_init_state(frames[:, 0], torch.zeros(D, 3), maps, cfg))
    rows = [g.step(frames[:, 1]).clone()]
    assert g._tables
    for cached in (features._gaussian_taps, features._sigma_table, tracking._binomial_taps,
                   motion._information, doh_cuda._launch_plan):
        cached.cache_clear()
    gc.collect()
    filler = [torch.full((n,), float("nan"), device=cuda)
              for n in (1, 3, 5, 16, 61, 128, 512) for _ in range(512)]
    for t in range(2, frames.shape[1]):
        rows.append(g.step(frames[:, t]).clone())
    rows = torch.stack(rows)
    for d, (r, s) in enumerate(singles):
        assert torch.equal(rows[:, d], r), d
        assert states_equal(F.unstack_states(g.snapshot())[d], s), d
    del filler
