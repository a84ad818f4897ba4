"""DoH scale space: the hand-written CUDA kernel and its plain PyTorch twin.

`doh_response(img, filters)` computes, for each sigma, the scale-normalised
determinant of Hessian of the Gaussian-blurred image — the function of the TPU
kernel `radarslampy_tpu/ops/pallas/doh_pallas.py::_kernel` and of its XLA twin
`doh_response_matmul`.  A CUDA tensor goes to the kernel in `csrc/doh.cu`
(which says what bounds it on an H100); a CPU tensor goes to the plain twin
`doh_response_reference`.  There is no fallback from one to the other.

`doh_response` is the custom op `radarslampy::doh_response` (tensors in,
[..., n_sigma, S, S] out), so that `torch.func.vmap` reaches it: its batching
rule makes one launch over the whole batch on the card (the counterpart of the
Pallas call's grid gaining a batch axis under `jax.vmap`), and runs the twin
image by image on the CPU.  A batched launch gives every image the bits of a
launch of its own.

The twin is the separable `conv2d` form (horizontal, then vertical, zero
padding), with TF32 off for cuDNN (set on package import).  It is the same
algorithm as the kernel, so the kernel is held against a twin whose only
difference is the order of its sums; and at O(S^2 * taps) it stays cheap on the
CPU, where the dense Toeplitz form costs 2 * 2 * S^3 flop per sigma.

Build: `nvcc` compiles `csrc/doh.cu` straight to a shared library with a plain
C interface (no PyTorch header), loaded with ctypes.  That takes seconds, where
`torch.utils.cpp_extension.load` takes minutes for a source that includes
PyTorch's headers, and it needs no `ninja`.  The library goes to
`radarslampy_tpu_torch/_build/`, named by the source's hash, at first use.
The launch geometry (grid, block, shared bytes and each block's list of
(image, sigma, tile) work items) is computed here, in `launch_geometry`, where the CPU
tests reach it; the entry point refuses a block size or shared-memory size
that differs from its own.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import heapq
import math
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from radarslampy_tpu_torch import resolve_device
from radarslampy_tpu_torch.ops.tables import device_table

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "doh.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-Xcompiler", "-fPIC", "-shared", "-Xptxas=-v"]

launches = 0        # kernel launches (CUDA tensors only; a batched launch counts once)
build_log = ""      # nvcc's output of the build this process did, if any
_lib = None


class DohFilters(NamedTuple):
    """1-D Gaussian taps per sigma, on the device of the step."""

    taps: torch.Tensor     # [n_sigma, 2 * rmax + 1] f32, row s centred at radii[s]
    radii: tuple           # blur radius per sigma
    scales: tuple          # max(sigma, 1)^4 per sigma (python floats)


def gaussian_taps(sigma: float) -> np.ndarray:
    """Zero-padded Gaussian taps of `gaussian_blur_matrix` (float64, normalised,
    cast to f32); a single unit tap (identity) for sigma < 0.3."""
    if sigma < 0.3:
        return np.ones(1, np.float32)
    radius = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / max(sigma, 1e-6)) ** 2)
    k /= k.sum()
    return k.astype(np.float32)


def filters_from_taps(taps_per_sigma, sigmas, device="cuda") -> DohFilters:
    """Pack per-sigma odd-length tap vectors into `DohFilters`.  The filters
    are checked here, once: the kernel's wrapper checks only the image."""
    device = resolve_device(device)
    if len(taps_per_sigma) == 0 or len(taps_per_sigma) != len(sigmas):
        raise ValueError("need one tap vector per sigma")
    if any(len(t) % 2 != 1 for t in taps_per_sigma):
        raise ValueError("tap vectors must have odd length (centred)")
    radii = tuple(len(t) // 2 for t in taps_per_sigma)
    rmax = max(radii)
    packed = np.zeros((len(radii), 2 * rmax + 1), np.float32)
    for s, t in enumerate(taps_per_sigma):
        packed[s, : len(t)] = t
    scales = tuple(float(max(s, 1.0)) ** 4 for s in sigmas)
    return DohFilters(taps=torch.as_tensor(packed, device=device), radii=radii,
                      scales=scales)


def build_doh_filters(sigmas, device="cuda") -> DohFilters:
    return filters_from_taps([gaussian_taps(float(s)) for s in sigmas], sigmas,
                             device)


def hessian_det(y, sig4: float):
    """sig4 * (Ixx * Iyy - Ixy^2) of [..., H, W], zero on the border rows/cols."""
    c = y[..., 1:-1, 1:-1]
    ixx = y[..., 1:-1, 2:] - 2.0 * c + y[..., 1:-1, :-2]
    iyy = y[..., 2:, 1:-1] - 2.0 * c + y[..., :-2, 1:-1]
    ixy = 0.25 * (y[..., 2:, 2:] - y[..., 2:, :-2] - y[..., :-2, 2:] + y[..., :-2, :-2])
    return F.pad(sig4 * (ixx * iyy - ixy * ixy), (1, 1, 1, 1))


def doh_response_reference(img, filters: DohFilters):
    """Plain PyTorch twin: separable conv2d blur (horizontal, then vertical,
    zero padding) and the Hessian stencil.  [S, S] -> [n_sigma, S, S]."""
    outs = []
    x = img[None, None]
    for s, (r, sig4) in enumerate(zip(filters.radii, filters.scales)):
        if r == 0:
            y = x * filters.taps[s, 0]
        else:
            k = filters.taps[s, : 2 * r + 1]
            y = F.conv2d(x, k.view(1, 1, 1, -1), padding=(0, r))
            y = F.conv2d(y, k.view(1, 1, -1, 1), padding=(r, 0))
        outs.append(hessian_det(y[0, 0], sig4))
    return torch.stack(outs)


# Tile constants of csrc/doh.cu.  The entry point refuses a launch whose block
# or shared-memory size differs from its own, which these constants set.
TILE_W = 128         # output columns per tile
TILE_H = 30          # output rows per tile
ROWS = TILE_H + 2    # vertically blurred rows per tile
R = 8                # taps per block of the register-blocked passes
NB = 128             # columns of the horizontal pass's register-blocked items
THREADS = 128
HS = 140             # row stride of the horizontal blur in shared memory
MAX_SIGMA = 8        # sigmas one launch takes
BLOCKS_PER_SM = 5    # the shared memory's limit at the default radii
SMEM_LIMIT = 232_448  # bytes of shared memory one block may have on an H100
SM_SHARED = 233_472  # bytes of shared memory an H100 SM has for its blocks


class DohGeometry(NamedTuple):
    """Launch geometry of `csrc/doh.cu`: `grid` blocks (as many as the card
    holds at once), each walking its own list of (image, sigma, tile) work
    items."""

    grid: int          # blocks: SMs x blocks per SM (or fewer, one per item)
    block: int         # threads per block
    smem_bytes: int    # dynamic shared memory per block, sized for the largest radius
    n_strips: int      # column strips of TILE_W
    n_bands: int       # row bands of TILE_H
    slots: tuple       # per block, its items plane * n_strips * n_bands + tile, where
                       # plane = image * n_sigma + sigma (the item's output plane)


def tap_blocks(radius: int) -> int:
    """Blocks of R taps that cover 2 radius + 1 taps."""
    return -(-(2 * radius + 1) // R)


def v_groups(radius: int) -> int:
    """Column groups of 32 that the vertical pass computes (TILE_W + 2 +
    2 radius columns)."""
    return -(-(TILE_W + 2 + 2 * radius) // 32)


def smem_bytes(radius: int, n_sigma: int = 1) -> int:
    """Shared memory of a block when the largest of `n_sigma` radii is
    `radius`: every sigma's taps, the vertical blur (its row stride a multiple
    of 8 floats plus 4) and the horizontal blur."""
    nkb = tap_blocks(radius)
    vs = -(-max(32 * v_groups(radius), NB + R * nkb) // 8) * 8 + 4
    return 4 * (n_sigma * R * nkb + ROWS * vs + ROWS * HS)


def max_radius(n_sigma: int = 1) -> int:
    """The largest blur radius whose block fits in SMEM_LIMIT."""
    r = 0
    while smem_bytes(r + 1, n_sigma) <= SMEM_LIMIT:
        r += 1
    return r


def tile_fmas(radius: int) -> int:
    """Multiply-adds of one tile at `radius`: the vertical pass over whole
    column groups of 32, the horizontal pass over NB columns plus the two
    apron columns, taps padded to R in the register-blocked parts."""
    nkb = tap_blocks(radius)
    return ROWS * (32 * v_groups(radius) * R * nkb + NB * R * nkb + 2 * (2 * radius + 1))


def item_cost(radius: int) -> int:
    """Relative cost of one tile at `radius` for the schedule: its
    multiply-adds plus a fixed cost per tile (set-up and the stencil).  The
    fixed cost, 128K multiply-adds, is an estimate, not a measurement."""
    return tile_fmas(radius) + 128 * 1024


@functools.lru_cache(maxsize=64)
def launch_geometry(S: int, radii: tuple, n_sm: int, batch: int = 1) -> DohGeometry:
    """Grid, block, shared memory and per-block work lists of one launch over
    all sigma of `batch` images on a card of `n_sm` SMs.  The (image, sigma,
    tile) items go to blocks longest first (ties in item order), each to the
    block with the least work so far, so no block ends far after the others.
    Raises ValueError, before any launch, for a radius whose block does not
    fit in shared memory."""
    if S < 1 or n_sm < 1 or batch < 1 or not 1 <= len(radii) <= MAX_SIGMA:
        raise ValueError(f"bad DoH launch: S={S}, radii={radii}, n_sm={n_sm}, "
                         f"batch={batch} (1 to {MAX_SIGMA} sigmas)")
    rmax, n_sigma = max(radii), len(radii)
    smem = smem_bytes(rmax, n_sigma)
    if min(radii) < 0 or smem > SMEM_LIMIT:
        raise ValueError(f"blur radius {rmax} needs {smem} B of shared memory per block, "
                         f"over the {SMEM_LIMIT} B a block can have "
                         f"(largest radius {max_radius(n_sigma)})")
    per_sm = min(BLOCKS_PER_SM, SM_SHARED // (smem + 1024))
    n_strips, n_bands = -(-S // TILE_W), -(-S // TILE_H)
    tiles = n_strips * n_bands
    items = sorted(((item_cost(r), (d * n_sigma + s) * tiles + t) for d in range(batch)
                    for s, r in enumerate(radii) for t in range(tiles)),
                   key=lambda c: (-c[0], c[1]))
    grid = min(n_sm * per_sm, len(items))
    heap = [(0, b) for b in range(grid)]
    slots = [[] for _ in range(grid)]
    for cost, item in items:
        load, b = heapq.heappop(heap)
        slots[b].append(item)
        heapq.heappush(heap, (load + cost, b))
    return DohGeometry(grid=grid, block=THREADS, smem_bytes=smem, n_strips=n_strips,
                       n_bands=n_bands, slots=tuple(map(tuple, slots)))


def schedule_array(geom: DohGeometry) -> np.ndarray:
    """The kernel's int32 schedule: grid + 1 offsets, then every block's items."""
    counts = [len(sl) for sl in geom.slots]
    offsets = np.concatenate([[0], np.cumsum(counts)])
    items = [i for sl in geom.slots for i in sl]
    return np.asarray(np.concatenate([offsets, items]), np.int32)


def work_items(S: int, radii: tuple, n_sm: int, batch: int = 1):
    """(block, plane, y0, x0, rows, cols) of each item in schedule order, as
    the kernel decodes it: the output pixels that item writes, in plane
    image * n_sigma + sigma of the [batch * n_sigma, S, S] output."""
    g = launch_geometry(S, radii, n_sm, batch)
    tiles = g.n_strips * g.n_bands
    for b, sl in enumerate(g.slots):
        for item in sl:
            s, t = divmod(item, tiles)
            y0, x0 = (t // g.n_strips) * TILE_H, (t % g.n_strips) * TILE_W
            yield b, s, y0, x0, min(TILE_H, S - y0), min(TILE_W, S - x0)


def redundant_work(S: int, radii: tuple) -> tuple:
    """Per sigma, the multiply-adds the kernel issues (`tile_fmas` over whole
    tiles, the ragged edge included) over the 2 (2r + 1) S^2 of the separable
    blur."""
    tiles = -(-S // TILE_W) * -(-S // TILE_H)
    return tuple(tiles * tile_fmas(r) / (2 * (2 * r + 1) * S * S) for r in radii)


# H100 SXM data sheet: HBM3 bandwidth and fp32 rate of the CUDA cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12


def doh_bound_ms(S: int, radii: tuple, batch: int = 1):
    """Least time for the DoH function of `batch` images on an H100 -> (ms,
    "bytes" or "operations"): each input byte read once, each output byte
    written once; separable blur (2 passes, 2 flop per tap) plus the 14-flop
    Hessian stencil per pixel and sigma."""
    n = len(radii)
    bytes_moved = batch * (4 * S * S + 4 * n * S * S) + 4 * sum(2 * r + 1 for r in radii)
    flops = batch * S * S * sum(2 * 2 * (2 * r + 1) + 14 for r in radii)
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def build_library(source: Path = SOURCE) -> Path:
    """Compile `source` (csrc/doh.cu by default) into _build/, once per source
    hash; return the .so."""
    global build_log
    source = Path(source)
    src = source.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{source.stem}-{digest}.so"
    if lib_path.exists():
        return lib_path
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    nvcc = shutil.which("nvcc") or (
        str(Path(cuda_home) / "bin" / "nvcc") if cuda_home else None)
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, lib_path)
    return lib_path


# doh_response_launch(img, taps, radius, sig4, n_sigma, tap_stride, S, batch,
# img_stride, schedule, grid, block, smem_bytes, out, stream)
LAUNCH_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)


def load_library():
    """Build (if needed) and load the kernel library; returns the ctypes CDLL."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        fn = lib.doh_response_launch
        fn.argtypes = LAUNCH_ARGTYPES
        fn.restype = ctypes.c_int
        lib.doh_kernel_info.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.doh_kernel_info.restype = ctypes.c_int
        _lib = lib
    return _lib


def kernel_info(radius: int, n_sigma: int = 1) -> dict:
    """Registers and local (spill) bytes per thread, and blocks per SM, of
    the kernel at the shared memory of `n_sigma` radii up to `radius`."""
    smem = smem_bytes(radius, n_sigma)
    vals = (ctypes.c_int * 3)()
    err = load_library().doh_kernel_info(smem, vals)
    if err != 0:
        raise RuntimeError(f"doh_kernel_info failed: cudaError {err}")
    return dict(registers=vals[0], local_bytes=vals[1], blocks_per_sm=vals[2],
                smem_bytes=smem)


@device_table(maxsize=64)
def _launch_plan(S: int, radii: tuple, batch: int, device: torch.device):
    """The launch geometry of `batch` images for the card `device` and its
    schedule there."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    geom = launch_geometry(S, radii, n_sm, batch)
    return geom, torch.as_tensor(schedule_array(geom), device=device)


@functools.lru_cache(maxsize=64)
def _host_scalars(radii: tuple, scales: tuple):
    """The radii and sigma^4 scales as C arrays, which the entry point passes
    to the kernel by value."""
    return (ctypes.c_int * len(radii))(*radii), (ctypes.c_float * len(scales))(*scales)


def doh_response_cuda(img, filters: DohFilters):
    """Launch the CUDA kernel on the current stream, once for every image of
    `img` [..., S, S] -> [..., n_sigma, S, S]; no synchronisation.  The
    filters were checked when `filters_from_taps` built them."""
    global launches
    if not img.is_cuda:
        raise ValueError("doh_response_cuda needs a CUDA tensor")
    if (img.dtype != torch.float32 or img.dim() < 2 or img.shape[-1] != img.shape[-2]
            or img.numel() == 0):
        raise ValueError(f"expected square float32 images [..., S, S], got {img.dtype} "
                         f"{tuple(img.shape)}")
    if not img.is_contiguous():
        raise ValueError("image must be contiguous")
    if filters.taps.device != img.device:
        raise ValueError(f"filters are on {filters.taps.device}, the image on {img.device}")
    S = img.shape[-1]
    batch = img.numel() // (S * S)
    geom, schedule = _launch_plan(S, filters.radii, batch, img.device)
    radii, sig4 = _host_scalars(filters.radii, filters.scales)
    lib = load_library()
    n_sigma, tap_stride = filters.taps.shape
    out = torch.empty((*img.shape[:-2], n_sigma, S, S), dtype=torch.float32,
                      device=img.device)
    err = lib.doh_response_launch(
        img.data_ptr(), filters.taps.data_ptr(), radii, sig4, n_sigma, tap_stride, S, batch,
        S * S, schedule.data_ptr(), geom.grid, geom.block, geom.smem_bytes, out.data_ptr(),
        torch.cuda.current_stream(img.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"doh_response_launch failed: cudaError {err}")
    launches += 1
    return out


def _reference_images(img, filters: DohFilters):
    """The twin over every image of `img` [..., S, S], one at a time."""
    S = img.shape[-1]
    flat = img.reshape(-1, S, S)
    out = torch.stack([doh_response_reference(x, filters) for x in flat])
    return out.reshape(*img.shape[:-2], *out.shape[1:])


@torch.library.custom_op("radarslampy::doh_response", mutates_args=())
def _doh_op(img: torch.Tensor, taps: torch.Tensor, radii: Sequence[int],
            scales: Sequence[float]) -> torch.Tensor:
    filters = DohFilters(taps=taps, radii=tuple(radii), scales=tuple(scales))
    if img.is_cuda:
        return doh_response_cuda(img, filters)
    return _reference_images(img, filters)


@_doh_op.register_fake
def _doh_op_fake(img, taps, radii, scales):
    return img.new_empty((*img.shape[:-2], len(radii), img.shape[-2], img.shape[-1]))


@_doh_op.register_vmap
def _doh_op_vmap(info, in_dims, img, taps, radii, scales):
    """One call over the batch: the images' axis of this vmap level first."""
    img_dim, taps_dim = in_dims[0], in_dims[1]
    if img_dim is None or taps_dim is not None:
        raise ValueError("vmap of the DoH op batches the image, never the filters")
    return _doh_op(img.movedim(img_dim, 0).contiguous(), taps, radii, scales), 0


def doh_response(img, filters: DohFilters):
    """[..., n_sigma, S, S] DoH responses of images [..., S, S]: the CUDA
    kernel for a CUDA tensor (one launch), the plain twin for a CPU tensor.
    Under `torch.func.vmap` the batch goes to the op's batching rule.  Any
    other device raises (the op's fake kernel would answer a meta tensor)."""
    if img.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no DoH path for device {img.device}")
    return _doh_op(img, filters.taps, filters.radii, filters.scales)
