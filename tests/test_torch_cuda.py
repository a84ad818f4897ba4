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
