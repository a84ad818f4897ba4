// Determinant-of-Hessian scale space for the radar front-end, CUDA C++ for sm_90a.
//
// Replaces the TPU kernel `_kernel` of radarslampy_tpu/ops/pallas/doh_pallas.py:84
// (launched by `doh_response_pallas`): for each sigma, blur the [S, S] image with
// the zero-padded Gaussian of radius max(1, ceil(3 sigma)) (taps built in float64,
// normalised, cast to f32; identity for sigma < 0.3), then write
//   max(sigma, 1)^4 * (Ixx * Iyy - Ixy^2)
// with 3-tap second differences and the 4-point cross stencil for Ixy, and zero
// at the border rows and columns 0 and S-1.  Output is [n_sigma, S, S] f32.
//
// Bound on an H100 SXM at S = 1024, sigma = (1, 5, 10) (radii 3, 15, 30):
//   fp32:  1024^2 * sum(2 passes * 2 flop * (2r + 1) + 14) = 459 MFLOP,
//          6.85 us at the 67 TFLOP/s of the CUDA cores;
//   bytes: 4 MB image read + 12 MB response written = 16.8 MB, 5.0 us at 3.35 TB/s.
// A batch of B images is B times both.  So it is bound by fp32 operations.  It
// stays in fp32 FMAs on the CUDA cores, with no fast-math intrinsic and no
// tensor core: the determinant subtracts near-equal products scaled by
// sigma^4 (up to 1e4), which TF32 does not survive, and a 3xTF32 banded
// product would spend most of each dense tile on the band's zeros.
//
// Design: one launch over all sigma (and over a batch of B images: under
// `torch.func.vmap` the segments of `parallel/batch_odometry.py` share one
// launch a frame, as the Pallas call's grid gains a batch axis under
// `jax.vmap`); nothing is written to device memory but the output.
//   - Work items are (image, sigma, tile) triples; a tile is kTW = 128 output
//     columns by kTH = 30 output rows.  An image's arithmetic does not depend
//     on the batch, so a batched launch gives each image the bits of a launch
//     of its own.  The grid holds as many blocks as the card runs
//     at once (5 per SM), and each block walks its own list of items, which
//     the wrapper fills longest first, each item to the block with the least
//     work so far (`launch_geometry` in ops/cuda/doh_cuda.py).  So the sigma =
//     10 tiles, 9x the work of a sigma = 1 tile, spread over all blocks and
//     the light ones fill in behind them.
//   - Per item, phase V blurs the image vertically, straight from device
//     memory, into shared memory: the 32 rows the stencil needs (30 + an
//     apron row on each side) over the 130 + 2r columns the horizontal blur
//     needs.  A warp blurs 32 adjacent columns, so each load instruction reads
//     one contiguous 128-byte row segment, and the rows that neighbouring row
//     groups share come from L1; warps run phase V with no barrier between
//     them.  (Versions that staged input rows through shared memory by
//     cp.async or TMA, for the whole block or per warp, were no faster.)
//     Phase H blurs those rows horizontally into a second buffer (the 130
//     columns the stencil needs), and phase S applies the Hessian stencil
//     from there.  The blurred image never leaves the SM.  The 2r-column halo
//     is phase V's redundant work; the 2r-row halo costs loads, not FMAs.
//     Redundant multiply-adds over the separable minimum, counting tap
//     padding and rounding (`redundant_work` in ops/cuda/doh_cuda.py): 1.41
//     (sigma 1), 1.28 (sigma 5), 1.44 (sigma 10) at S = 1024.
//   - Register blocking: a thread computes 16 consecutive outputs along the
//     blur direction (kRV in phase V, kRH in phase H) and walks the taps in
//     blocks of 8 (taps zero-padded to a multiple of 8).  A ring of blocks of
//     8 inputs in registers takes 8 new inputs per block of taps, so each
//     input is loaded once and feeds 16 FMAs; the two-pass kernel this
//     replaces did two shared-memory loads per FMA.  The radius stays a
//     runtime value.  Phase H's 8 x 32 items fill the block's 128 threads
//     twice; 64 threads then blur the tile's two apron columns one output each.
//   - Zero padding: a column outside the image blurs clamped data and is
//     zeroed after; row groups that reach past the top or bottom edge take a
//     checked path.
//   - Bank layout: phase H lanes walk rows at one column (row stride 4 mod 8
//     floats, so 16-byte loads of 8 lanes hit distinct banks); phase S lanes
//     read 16 bytes at consecutive addresses.
//   - Stores: 16 bytes a thread where S is a multiple of 4, a masked scalar
//     tail otherwise.
//   - Shared memory at n sigma of largest radius r (kb = ceil((2r + 1) / 8)
//     tap blocks): 4 * (8 kb n + 32 vs + 32 * 140) bytes with vs =
//     max(32 ceil((130 + 2r) / 32), 128 + 8 kb) rounded up to 8, plus 4; every
//     sigma's taps are read into it once per block.  43,776 B at r = 30 and
//     n = 3, so 5 blocks of 4 warps share an SM; small blocks give each SM
//     more independent chains of latency to interleave.  `max_radius()` in the
//     wrapper gives the largest radius that fits in a block's shared memory.
// No atomics, and a fixed order of every sum: two launches on one input give
// the same bits.
//
// The entry point takes raw device pointers, the launch geometry and schedule
// computed by the wrapper and the stream from the caller, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTW = 128;                  // output columns per tile
constexpr int kTH = 30;                   // output rows per tile
constexpr int kRows = kTH + 2;            // vertically blurred rows (apron row each side)
constexpr int kR = 8;                     // taps per block; inputs per load
constexpr int kRV = 16;                   // outputs per thread of phase V
constexpr int kRH = 16;                   // outputs per thread of phase H
constexpr int kNB = 128;                  // columns of phase H's register-blocked items
constexpr int kThreads = 128;
constexpr int kBlocksPerSM = 5;           // at most 102 registers a thread
constexpr int kHS = 140;                  // row stride of the horizontal blur (16-byte rows)
constexpr int kMaxSigma = 8;

// Per-launch scalars, passed by value (the constant bank).
struct DohParams {
  int n_sigma;
  int tap_stride;
  int S;
  long long img_stride;  // floats from one image of the batch to the next
  int nkb_max;  // tap blocks of the largest radius
  int vs;       // row stride of the vertical blur
  int radius[kMaxSigma];
  float sig4[kMaxSigma];
};

__host__ __device__ constexpr int tap_blocks(int r) { return (2 * r + 1 + kR - 1) / kR; }
// column groups of 32 that phase V computes: kTW + 2 + 2r columns
__host__ __device__ constexpr int v_groups(int r) { return (kTW + 2 + 2 * r + 31) / 32; }
__host__ __device__ constexpr int max2(int a, int b) { return a > b ? a : b; }
// row stride of the vertical blur: the columns phase V writes and phase H
// loads (up to kNB + 8 kb), rounded to 8, plus 4 (4 mod 8: conflict-free
// 16-byte loads by lanes on consecutive rows)
__host__ __device__ constexpr int v_stride(int r) {
  return (max2(32 * v_groups(r), kNB + kR * tap_blocks(r)) + 7) / 8 * 8 + 4;
}
__host__ __device__ constexpr int smem_floats(int rmax, int n_sigma) {
  return n_sigma * kR * tap_blocks(rmax) + kRows * v_stride(rmax) + kRows * kHS;
}

// The blur of NQ consecutive outputs, acc[q] = sum_{k < kR nkb} w[k] x(q + k),
// with load(i, v) filling v[0..kR) = x(i..i + kR).  A ring of NW = NQ / kR + 1
// blocks of kR inputs lives in registers and takes kR new inputs per block of
// taps, so each input is loaded once and feeds NQ FMAs.  Loads x up to
// kR nkb + NQ - 1; sums each output's taps in ascending order.
template <int NQ, class Load>
__device__ __forceinline__ void blur(const Load& load, const float* w, int nkb,
                                     float (&acc)[NQ]) {
  constexpr int NW = NQ / kR + 1;
  float x[NW][kR];
#pragma unroll
  for (int q = 0; q < NQ; ++q) acc[q] = 0.0f;
#pragma unroll
  for (int b = 0; b < NW - 1; ++b) load(kR * b, x[b]);
  for (int kb0 = 0; kb0 < nkb; kb0 += NW) {
    // NW blocks of taps a turn, so that the ring's names rotate at compile
    // time: block kb + j of x is in x[(m + j) % NW]
#pragma unroll
    for (int m = 0; m < NW; ++m) {
      const int kb = kb0 + m;
      if (kb < nkb) {
        load(kR * (kb + NW - 1), x[(m + NW - 1) % NW]);
#pragma unroll
        for (int k = 0; k < kR; ++k) {
          const float t = w[kR * kb + k];
#pragma unroll
          for (int q = 0; q < NQ; ++q)
            acc[q] = fmaf(t, x[(m + (k + q) / kR) % NW][(k + q) % kR], acc[q]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
doh_kernel(const float* __restrict__ img, const float* __restrict__ taps, const DohParams p,
           const int* __restrict__ schedule, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int S = p.S;
  const int n_strips = (S + kTW - 1) / kTW;
  const int n_tiles = n_strips * ((S + kTH - 1) / kTH);

  // This block's work items are schedule[gridDim.x + 1 + n] for n in
  // [schedule[b], schedule[b + 1]): item = plane * n_tiles + tile, where
  // plane = image * n_sigma + sigma is the item's [S, S] plane of the output.
  const int* items = schedule + gridDim.x + 1;
  const int tstride = kR * p.nkb_max;       // taps of one sigma in shared memory
  float* w_all = smem;                      // [n_sigma][tstride], zero padded
  float* vb = w_all + p.n_sigma * tstride;  // [kRows][vs]: row j <-> image row y0 - 1 + j,
                                            //   column c <-> image column x0 - 1 - r + c
  float* hb = vb + kRows * p.vs;            // [kRows][kHS]: row j <-> image row y0 - 1 + j,
                                            //   column c <-> image column x0 - 1 + c
  for (int i = tid; i < p.n_sigma * tstride; i += kThreads) {
    const int a = i / tstride, k = i % tstride;
    int ra = 0;
#pragma unroll
    for (int b = 0; b < kMaxSigma; ++b)
      if (b == a) ra = p.radius[b];
    w_all[i] = k <= 2 * ra ? taps[a * p.tap_stride + k] : 0.0f;
  }
  for (int n = schedule[blockIdx.x]; n < schedule[blockIdx.x + 1]; ++n) {
    const int item = items[n];
    const int tile = item % n_tiles;
    const int plane = item / n_tiles;
    const float* img_b = img + (size_t)(plane / p.n_sigma) * p.img_stride;
    const int x0 = (tile % n_strips) * kTW;
    const int y0 = (tile / n_strips) * kTH;
    // sigma's radius and scale (unrolled over kMaxSigma: constant indices keep p
    // in the constant bank)
    const int s = plane % p.n_sigma;
    int r = 0;
    float s4 = 0.0f;
#pragma unroll
    for (int a = 0; a < kMaxSigma; ++a) {
      if (a == s) {
        r = p.radius[a];
        s4 = p.sig4[a];
      }
    }
    const int nkb = tap_blocks(r);
    const int ncg = v_groups(r);
    const int vs = p.vs;
    const float* w = w_all + s * tstride;
    // phase H loads vb columns up to kNB + 8 nkb - 1; those past phase V's are zero
    const int n_pad = max2(kNB + kR * nkb - 32 * ncg, 0);
    for (int i = tid; i < kRows * n_pad; i += kThreads)
      vb[(i / n_pad) * vs + 32 * ncg + i % n_pad] = 0.0f;
    // (the previous item's phase S reads only hb, so these writes do not race it)
    __syncthreads();

    // phase V: warp item -> (column group cg, row group rg of kRV rows), lane
    // -> column; x(i) is image row y0 - 1 - r + kRV rg + i.  The row groups of
    // one column group go to neighbouring warps, which share rows in L1.
    const int n_items = ncg * (kRows / kRV);
    for (int it = warp; it < n_items; it += kThreads / 32) {
      const int cg = it / (kRows / kRV), rg = it % (kRows / kRV);
      const int gx = x0 - 1 - r + 32 * cg + lane;
      const bool col_in = gx >= 0 && gx < S;
      const int gy_top = y0 - 1 - r + kRV * rg;
      const float* base = img_b + min(max(gx, 0), S - 1);  // a column outside: any finite data
      float acc[kRV];
      if (gy_top >= 0 && gy_top + kR * nkb + kRV <= S) {
        const float* col = base + (size_t)gy_top * S;
        blur(
            [col, S](int i, float* v) {
#pragma unroll
              for (int q = 0; q < kR; ++q) v[q] = __ldg(col + (size_t)(i + q) * S);
            },
            w, nkb, acc);
      } else {  // rows past the top or bottom edge are the blur's zero padding
        blur(
            [base, gy_top, S](int i, float* v) {
#pragma unroll
              for (int q = 0; q < kR; ++q) {
                const int gy = gy_top + i + q;
                v[q] = (gy >= 0 && gy < S) ? __ldg(base + (size_t)gy * S) : 0.0f;
              }
            },
            w, nkb, acc);
      }
      float* dst = vb + kRV * rg * vs + 32 * cg + lane;
#pragma unroll
      for (int q = 0; q < kRV; ++q) dst[q * vs] = col_in ? acc[q] : 0.0f;
    }
    __syncthreads();

    // phase H: thread -> (column group g of kRH columns, row j), lanes walk
    // rows, for hb columns 0 .. kNB - 1 (one item per thread); then 2 kRows
    // threads one output each for the apron columns kNB, kNB + 1
    for (int i = tid; i < kRows * (kNB / kRH); i += kThreads) {
      const int g = i / kRows, j = i % kRows;
      const float* in = vb + j * vs + kRH * g;
      float acc[kRH];
      blur(
          [in](int k, float* v) {
            const float4 a = *reinterpret_cast<const float4*>(in + k);
            const float4 b = *reinterpret_cast<const float4*>(in + k + 4);
            v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
            v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
          },
          w, nkb, acc);
      float* dst = hb + j * kHS + kRH * g;
#pragma unroll
      for (int q = 0; q < kRH; ++q) dst[q] = acc[q];
    }
    if (tid < 2 * kRows) {
      const int j = tid >> 1, c = kNB + (tid & 1);
      const float* in = vb + j * vs + c;
      float acc = 0.0f;
      for (int k = 0; k <= 2 * r; ++k) acc = fmaf(w[k], in[k], acc);
      hb[j * kHS + c] = acc;
    }
    __syncthreads();

    // phase S, the Hessian stencil: thread -> (row, 4 consecutive columns)
    const int rows_out = min(kTH, S - y0);
    const int cols_out = min(kTW, S - x0);
    const bool vec = (S & 3) == 0;
    float* out_s = out + (size_t)plane * S * S;
    for (int i = tid; i < rows_out * (kTW / 4); i += kThreads) {
      const int ty = i / (kTW / 4), qx = 4 * (i % (kTW / 4));
      if (qx >= cols_out) continue;
      const int gy = y0 + ty;
      // rows ty, ty + 1, ty + 2 of hb are image rows gy - 1, gy, gy + 1;
      // columns qx .. qx + 5 are image columns x0 + qx - 1 .. x0 + qx + 4
      // (the 16-byte loads also bring columns qx + 6, qx + 7, unused)
      float m[3][8];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float* row = hb + (ty + d) * kHS + qx;
        const float4 a = *reinterpret_cast<const float4*>(row);
        const float4 b = *reinterpret_cast<const float4*>(row + 4);
        m[d][0] = a.x; m[d][1] = a.y; m[d][2] = a.z; m[d][3] = a.w;
        m[d][4] = b.x; m[d][5] = b.y; m[d][6] = b.z; m[d][7] = b.w;
      }
      const bool row_in = gy > 0 && gy < S - 1;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = e + 1, gx = x0 + qx + e;
        const float ixx = m[1][c + 1] - 2.0f * m[1][c] + m[1][c - 1];
        const float iyy = m[2][c] - 2.0f * m[1][c] + m[0][c];
        const float ixy = 0.25f * (m[2][c + 1] - m[2][c - 1] - m[0][c + 1] + m[0][c - 1]);
        v[e] = (row_in && gx > 0 && gx < S - 1) ? s4 * (ixx * iyy - ixy * ixy) : 0.0f;
      }
      float* dst = out_s + (size_t)gy * S + x0 + qx;
      if (vec && qx + 4 <= cols_out) {
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (qx + e < cols_out) dst[e] = v[e];
      }
    }
  }
}

// The smallest shared-memory carveout, in percent of the SM's 228 KB, that
// holds as many blocks of `bytes` (and the 1 KB the runtime reserves per
// block) as the registers allow: the rest of the SM's 256 KB stays L1, which
// caches phase V's rows.
int carveout_percent(int bytes) {
  const int smem_max = 228 * 1024;
  const int blocks = max2(1, min(kBlocksPerSM, smem_max / (bytes + 1024)));
  return (100 * blocks * (bytes + 1024) + smem_max - 1) / smem_max;
}

// Raises the kernel's dynamic shared memory limit to `bytes` (once per size
// above the last) and sets the carveout for the blocks of that size an SM runs.
int g_smem_configured = 0;
cudaError_t configure_smem(int bytes) {
  if (bytes <= g_smem_configured) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(doh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(doh_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               carveout_percent(bytes));
  if (err == cudaSuccess) g_smem_configured = bytes;
  return err;
}

}  // namespace

// Registers per thread, local (spill) bytes per thread, and blocks per SM at
// smem_bytes of dynamic shared memory, as the runtime reports them.
extern "C" int doh_kernel_info(int smem_bytes, int* out3) {
  cudaFuncAttributes attr;
  cudaError_t err = configure_smem(smem_bytes);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, doh_kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, doh_kernel, kThreads,
                                                        smem_bytes);
  if (err != cudaSuccess) return (int)err;
  out3[0] = attr.numRegs;
  out3[1] = (int)attr.localSizeBytes;
  out3[2] = blocks;
  return 0;
}

// img [batch, S, S] f32 (device; image b at img + b * img_stride, its rows
// contiguous); taps [n_sigma, tap_stride] f32 (device; row s holds
// 2 radius[s] + 1 taps centred at index radius[s], tap_stride >= 2 max(radius) + 1);
// radius [n_sigma] i32 and sig4 [n_sigma] f32 (host); out [batch, n_sigma, S, S]
// f32 (device, contiguous); schedule [grid + 1 + n_items] i32 (device): the
// wrapper's `launch_geometry(S, radii, n_sm, batch)`, whose block and smem_bytes
// must be this file's or the call is refused.
extern "C" int doh_response_launch(const void* img, const void* taps, const int* radius,
                                   const float* sig4, int n_sigma, int tap_stride, int S,
                                   int batch, long long img_stride, const void* schedule,
                                   int grid, int block, int smem_bytes, void* out,
                                   void* stream) {
  if (n_sigma < 1 || n_sigma > kMaxSigma || batch < 1 || img_stride < (long long)S * S)
    return (int)cudaErrorInvalidValue;
  DohParams p;
  p.n_sigma = n_sigma;
  p.tap_stride = tap_stride;
  p.S = S;
  p.img_stride = img_stride;
  int rmax = 0;
  for (int i = 0; i < kMaxSigma; ++i) {
    p.radius[i] = i < n_sigma ? radius[i] : 0;
    p.sig4[i] = i < n_sigma ? sig4[i] : 0.0f;
    rmax = max2(rmax, p.radius[i]);
  }
  p.nkb_max = tap_blocks(rmax);
  p.vs = v_stride(rmax);
  if (block != kThreads || grid < 1 ||
      smem_bytes != (int)sizeof(float) * smem_floats(rmax, n_sigma))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = configure_smem(smem_bytes);
  if (err != cudaSuccess) return (int)err;
  doh_kernel<<<grid, block, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(taps), p,
      static_cast<const int*>(schedule), static_cast<float*>(out));
  return (int)cudaGetLastError();
}
