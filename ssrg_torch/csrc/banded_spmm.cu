// Banded (windowed dense-block) sparse-times-dense product for Hopper (sm_90a):
//     out[b*rb + i, :] = sum_k blocks[b, i, k] * xt[los[b] + k, :]
//         b < nb, i < rb, k < w;  xt = x, or x rounded to bf16 (round_x)
//
// Replaces ssrg_tpu/ops/pallas_banded.py::_banded_kernel, the Pallas TPU kernel
// that walks the row blocks in order, DMAs the [w, F] window of x for block b+1
// while the MXU multiplies block b, and writes each [rb, F] block once. After a
// locality reorder (RCM) every neighbour of a row block lies in one contiguous
// column window, so the sparse product becomes nb small dense products against
// contiguous slices of x: no gather at all.
//
// Numerics: f32 accumulation. blocks are f32 or bf16; bf16 values are widened
// to f32, and xt is rounded to bf16 (round to nearest even) when the blocks are
// bf16 or the caller asks for a bf16 window, so every product is a bf16 x bf16
// product, exact in f32, as with the reference's preferred_element_type=f32.
// Window rows los[b] + k >= n read as zero: that replaces the reference's pad
// of x to `pad_to` rows (window starts are 16-aligned and unclamped), so the
// kernel needs no padded copy of x each hop.
//
// What bounds it: bytes. At the f32 pack of the 169,343-node banded graph
// (nb 662, rb 256, w 2,816, F 128) the blocks hold 1.909 GB; with x and out
// that is 2.08 GB to move once, 0.62 ms at the H100 SXM data sheet's 3.35 TB/s.
// The work the function needs is one multiply-add per feature for each of the
// 2,527,311 nonzeros (2*nnz*F = 6.5e8 flops, 0.01 ms at 67 TFLOP/s f32): 99.5 %
// of the block entries are zero. This kernel multiplies every entry anyway,
// 2*nb*rb*w*F = 1.222e11 flops, 1.82 ms at that f32 rate, so skipping zero
// k-tiles is the first lever. Rows of x are read again by the about w/rb = 11
// overlapping windows that hold them, mostly from L2. At the bf16 pack (rb 512,
// w 3,200, window in bf16) the compulsory bytes are 1.258 GB, 0.376 ms.
//
// What the simple design does about it: a register-tiled GEMM for each row
// block. The grid covers (row block, 128-row tile of it) x (128-column tile of
// F); each block of 256 threads walks w in steps of 16, stages a [128, 16] tile
// of the dense block (transposed) and a [16, 128] tile of the x window in
// shared memory, and each thread keeps an 8 x 8 tile of f32 sums in registers
// (rows and columns strided by 16, so shared-memory reads are broadcasts or hit
// distinct banks). Ragged rb, w and F are masked. Every output element is
// written once, with no atomics: the result does not depend on the schedule.
// Tensor cores (wgmma on the bf16 pack), TMA window loads and a multi-stage
// pipeline are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;  // rows of a block's output tile
constexpr int kBN = 128;  // columns (features) of the output tile
constexpr int kBK = 16;   // depth of one shared-memory stage
constexpr int kThreads = 256;
constexpr int kTM = kBM / 16;  // rows per thread (strided by 16)
constexpr int kTN = kBN / 16;  // columns per thread (strided by 16)

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
banded_spmm_kernel(const T* __restrict__ blocks, const int32_t* __restrict__ los,
                   const float* __restrict__ x, float* __restrict__ out, int rb, int w,
                   int64_t n, int f, int tiles_m, int round_x) {
  // block tile, transposed: [k][row]; the pad column spreads the transposing
  // stores over the banks
  __shared__ float a_s[kBK][kBM + 1];
  __shared__ float b_s[kBK][kBN];  // window tile: [k][feature]

  const int b = blockIdx.x / tiles_m;
  const int row0 = (blockIdx.x % tiles_m) * kBM;
  const int col0 = blockIdx.y * kBN;
  const int t = threadIdx.x;
  const int tx = t & 15, ty = t >> 4;
  const int64_t lo = los[b];
  const T* blk = blocks + static_cast<int64_t>(b) * rb * w;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  // loader coordinates: the block tile by 16-float row segments, the window
  // tile by 128-float row segments (both coalesced along memory)
  const int a_k = t & 15, a_r = t >> 4;     // + 16 * pass
  const int b_c = t & 127, b_k = t >> 7;    // + 2 * pass

  for (int k0 = 0; k0 < w; k0 += kBK) {
#pragma unroll
    for (int p = 0; p < kBM / 16; ++p) {
      const int r = a_r + 16 * p;
      const int k = k0 + a_k;
      float v = 0.f;
      if (row0 + r < rb && k < w) v = widen(blk[static_cast<int64_t>(row0 + r) * w + k]);
      a_s[a_k][r] = v;
    }
#pragma unroll
    for (int p = 0; p < kBK / 2; ++p) {
      const int kk = b_k + 2 * p;
      const int64_t xr = lo + k0 + kk;
      const int c = col0 + b_c;
      float v = 0.f;
      if (k0 + kk < w && xr < n && c < f) {
        v = __ldg(x + xr * f + c);
        if (round_x) v = round_bf16(v);
      }
      b_s[kk][b_c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[kTM], bv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) av[i] = a_s[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = b_s[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out_b = out + static_cast<int64_t>(b) * rb * f;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= rb) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < f) out_b[static_cast<int64_t>(r) * f + c] = acc[i][j];
    }
  }
}

}  // namespace

// blocks [nb, rb, w] (f32, or bf16 when blocks_bf16 != 0), los int32 [nb],
// x f32 [n, f] and out f32 [nb * rb, f], all contiguous on the current device.
// round_x != 0 rounds the window to bf16 before the products (the caller sets it
// for bf16 blocks too). Launches on `stream` and returns cudaGetLastError()
// (0 on success); does not synchronize.
extern "C" int banded_spmm(const void* blocks, int blocks_bf16, const int32_t* los,
                           const float* x, float* out, int nb, int rb, int w, int64_t n,
                           int f, int round_x, cudaStream_t stream) {
  if (nb <= 0 || rb <= 0 || w <= 0 || f <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_m = (rb + kBM - 1) / kBM;
  const int64_t grid_x = static_cast<int64_t>(nb) * tiles_m;
  const int64_t grid_y = (f + kBN - 1) / kBN;
  if (grid_x > 0x7fffffffLL || grid_y > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const dim3 grid(static_cast<unsigned>(grid_x), static_cast<unsigned>(grid_y));
  if (blocks_bf16) {
    banded_spmm_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(blocks), los, x, out, rb, w, n, f, tiles_m, round_x);
  } else {
    banded_spmm_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(blocks), los, x, out, rb, w, n, f, tiles_m, round_x);
  }
  return static_cast<int>(cudaGetLastError());
}
