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
