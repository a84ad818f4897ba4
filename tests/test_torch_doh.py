"""The port's DoH scale space (plain twin of the CUDA kernel) against the JAX
package's Toeplitz-matmul path and its Pallas kernel in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from radarslampy_tpu.ops.pallas import doh_pallas as dp
from radarslampy_tpu_torch.ops.cuda import doh_cuda

# The suite runs in several pytest-xdist worker processes on one host; one
# intra-op thread per worker keeps torch from oversubscribing its cores.
torch.set_num_threads(1)

SIGMAS = (1.0, 5.0, 10.0)


def _img(rng, size):
    img = rng.random((size, size)).astype(np.float32)
    # smooth a bit so second derivatives aren't pure noise (as test_doh_pallas)
    k = np.ones(5) / 5
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, img)
    img = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 0, img)
    return img.astype(np.float32)


def _mats(size, sigmas=SIGMAS):
    return jnp.asarray(np.stack([
        np.eye(size, dtype=np.float32) if s < 0.3 else dp.gaussian_blur_matrix(size, s)
        for s in sigmas]))


def _assert_doh_close(out, ref):
    # tolerance of tests/test_doh_pallas.py, 2e-3 * max|ref|: the same math up
    # to float addition order, amplified by sigma^4 (up to 1e4).  Each sigma
    # slice is held to its own max, so a small-sigma slice far weaker than the
    # sigma = 10 one cannot hide under the larger slice's scale.
    assert out.shape == ref.shape
    for s in range(ref.shape[0]):
        scale = np.abs(ref[s]).max()
        assert scale > 0, f"sigma slice {s} is all zero"
        np.testing.assert_allclose(out[s], ref[s], atol=2e-3 * scale, rtol=0,
                                   err_msg=f"sigma slice {s}")


@pytest.mark.parametrize("sigma", [0.1, 1.0, 2.5, 5.0, 10.0])
def test_taps_are_the_toeplitz_band(sigma):
    taps = doh_cuda.gaussian_taps(sigma)
    r = len(taps) // 2
    B = np.asarray(_mats(96, (sigma,))[0])
    np.testing.assert_array_equal(taps, B[48, 48 - r: 48 + r + 1])


@pytest.mark.parametrize("size", [256, 200])  # 200: not a multiple of 64
def test_twin_matches_matmul(rng, size):
    img = _img(rng, size)
    ref = np.asarray(dp.doh_response_matmul(jnp.asarray(img), _mats(size), SIGMAS))
    filters = doh_cuda.build_doh_filters(SIGMAS, "cpu")
    out = doh_cuda.doh_response_reference(torch.from_numpy(img), filters).numpy()
    assert out.shape == ref.shape
    _assert_doh_close(out, ref)
    # the border rows and columns are exactly zero on both sides
    for a in (out, ref):
        assert not a[:, [0, -1], :].any() and not a[:, :, [0, -1]].any()


def test_twin_matches_pallas_interpret(rng):
    size = 256
    img_np = _img(rng, size)
    img = jnp.asarray(img_np)
    mats = _mats(size)
    n_sigma = mats.shape[0]
    sig4 = jnp.asarray([max(s, 1.0) ** 4 for s in SIGMAS], jnp.float32).reshape(n_sigma, 1)
    ref = pl.pallas_call(
        dp._kernel,
        out_shape=jax.ShapeDtypeStruct((n_sigma, size, size), jnp.float32),
        grid=(n_sigma, size // dp.ROW_TILE),
        in_specs=[
            pl.BlockSpec((n_sigma, 1), lambda s, r: (0, 0)),
            pl.BlockSpec((size, size), lambda s, r: (0, 0)),
            pl.BlockSpec((1, size, size), lambda s, r: (s, 0, 0)),
        ],
        out_specs=pl.BlockSpec((1, dp.ROW_TILE, size), lambda s, r: (s, r, 0)),
        interpret=True,
    )(sig4, img, mats)
    out = doh_cuda.doh_response(torch.from_numpy(img_np),
                                doh_cuda.build_doh_filters(SIGMAS, "cpu"))
    _assert_doh_close(out.numpy(), np.asarray(ref))


def test_identity_sigma(rng):
    """sigma < 0.3 is the identity blur, as build_doh_mats makes it."""
    img = _img(rng, 64)
    sig = (0.1, 2.0)
    ref = np.asarray(dp.doh_response_matmul(jnp.asarray(img), _mats(64, sig), sig))
    out = doh_cuda.doh_response(torch.from_numpy(img), doh_cuda.build_doh_filters(sig, "cpu"))
    _assert_doh_close(out.numpy(), ref)


def test_dispatch_cpu_twin_and_refusals():
    filters = doh_cuda.build_doh_filters(SIGMAS, "cpu")
    before = doh_cuda.launches
    out = doh_cuda.doh_response(torch.rand(70, 70), filters)
    assert out.shape == (3, 70, 70)
    assert doh_cuda.launches == before  # the twin is not a launch
    with pytest.raises(ValueError):
        doh_cuda.doh_response_cuda(torch.rand(70, 70), filters)
    with pytest.raises(ValueError):
        doh_cuda.doh_response(torch.empty(70, 70, device="meta"), filters)


def test_vmap_of_the_op_is_the_twin_per_image(rng):
    """`doh_response` under torch.func.vmap (the batched step's DoH): its
    batching rule runs the twin image by image on the CPU, so each image has
    the twin's bits, with no launch and no vmap fallback; against the JAX
    package's vmapped matmul path within the tolerance above."""
    size = 96
    imgs = np.stack([_img(rng, size) for _ in range(3)])
    filters = doh_cuda.build_doh_filters(SIGMAS, "cpu")
    before = doh_cuda.launches
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        out = torch.func.vmap(lambda x: doh_cuda.doh_response(x, filters))(
            torch.from_numpy(imgs))
        out_t = torch.func.vmap(lambda x: doh_cuda.doh_response(x, filters), in_dims=1,
                                out_dims=1)(torch.from_numpy(imgs).transpose(0, 1))
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(True)
    assert out.shape == (3, len(SIGMAS), size, size) and doh_cuda.launches == before
    ref = jax.vmap(lambda x: dp.doh_response_matmul(x, _mats(size), SIGMAS))(jnp.asarray(imgs))
    for d in range(3):
        twin = doh_cuda.doh_response_reference(torch.from_numpy(imgs[d]), filters)
        assert torch.equal(out[d], twin) and torch.equal(out_t[:, d], twin)
        _assert_doh_close(out[d].numpy(), np.asarray(ref[d]))
    # the op itself takes images [..., S, S]
    assert torch.equal(doh_cuda.doh_response(torch.from_numpy(imgs), filters), out)
