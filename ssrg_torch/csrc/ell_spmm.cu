// ELL sparse-times-dense product for Hopper (sm_90a):
//     out[r, :] = sum_w vals[r, w] * x[cols[r, w], :]      r < n_rows, w < width
//
// Replaces ssrg_tpu/ops/pallas_spmm.py::_spmm_kernel, the Pallas TPU kernel that
// gathers the neighbour rows of 8-row blocks by double-buffered DMA and reduces
// them on the vector unit. Like it, this kernel computes every slot of the pack,
// padding slots (column 0, weight 0) included; the COO tail of a hybrid pack is
// added outside.
//
// What bounds it: the gather. Each slot reads one row of x (F floats) from a
// data-dependent address. At the headline graph (N = 169,343, width 24, F = 128)
// that is about 1.27 GB of neighbour rows per hop for the real slots and about
// 2.08 GB with the padding slots, against about 0.21 GB of compulsory traffic
// (the pack, x and out each moved once). x is 86.7 MB, larger than the 50 MB L2,
// so part of the gather goes to device memory.
//
// What the simple design does about it: one warp per output row, lanes across F,
// so every neighbour-row read is one coalesced 512-byte transaction (16 bytes a
// lane as float4 when F % 4 == 0 and the pointers are 16-byte aligned; 4 bytes a
// lane otherwise). The (col, val) pairs of a row are loaded once per warp, lane j
// holding slot j, and broadcast by shuffle. Sums stay in f32 registers and every
// output row is written once: no atomics, and the result does not depend on the
// schedule. F wider than 128 floats is walked in 128-float tiles. Eight warps a
// block keep many independent gathers in flight on each SM. Skipping padding
// slots, staging x in shared memory or L2-sized tiles, and cp.async/TMA are left
// for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kTile = 128;  // floats of a row that one warp covers per pass
constexpr unsigned kFullMask = 0xffffffffu;

template <bool kVec4>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ell_spmm_kernel(const int32_t* __restrict__ cols, const float* __restrict__ vals,
                const float* __restrict__ x, float* __restrict__ out,
                int64_t n_rows, int width, int f) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // uniform across the warp
  const int32_t* row_cols = cols + row * width;
  const float* row_vals = vals + row * width;
  float* out_row = out + row * static_cast<int64_t>(f);

  for (int f0 = 0; f0 < f; f0 += kTile) {
    float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
    for (int w0 = 0; w0 < width; w0 += 32) {
      const int n = min(32, width - w0);
      int32_t my_col = 0;
      float my_val = 0.f;
      if (lane < n) {
        my_col = row_cols[w0 + lane];
        my_val = row_vals[w0 + lane];
      }
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const int64_t c = __shfl_sync(kFullMask, my_col, j);
        const float v = __shfl_sync(kFullMask, my_val, j);
        const float* xr = x + c * f + f0;
        if (kVec4) {
          const int fi = lane * 4;
          if (f0 + fi < f) {
            const float4 xv = __ldg(reinterpret_cast<const float4*>(xr + fi));
            acc0 = fmaf(v, xv.x, acc0);
            acc1 = fmaf(v, xv.y, acc1);
            acc2 = fmaf(v, xv.z, acc2);
            acc3 = fmaf(v, xv.w, acc3);
          }
        } else {
          if (f0 + lane < f) acc0 = fmaf(v, __ldg(xr + lane), acc0);
          if (f0 + lane + 32 < f) acc1 = fmaf(v, __ldg(xr + lane + 32), acc1);
          if (f0 + lane + 64 < f) acc2 = fmaf(v, __ldg(xr + lane + 64), acc2);
          if (f0 + lane + 96 < f) acc3 = fmaf(v, __ldg(xr + lane + 96), acc3);
        }
      }
    }
    if (kVec4) {
      const int fi = lane * 4;
      if (f0 + fi < f) {
        *reinterpret_cast<float4*>(out_row + f0 + fi) =
            make_float4(acc0, acc1, acc2, acc3);
      }
    } else {
      if (f0 + lane < f) out_row[f0 + lane] = acc0;
      if (f0 + lane + 32 < f) out_row[f0 + lane + 32] = acc1;
      if (f0 + lane + 64 < f) out_row[f0 + lane + 64] = acc2;
      if (f0 + lane + 96 < f) out_row[f0 + lane + 96] = acc3;
    }
  }
}

}  // namespace

// cols int32 [n_rows, width], vals f32 [n_rows, width], x f32 [*, f] and
// out f32 [n_rows, f], all contiguous on the current device; every column
// index must lie in x. vec4 != 0 asks for the float4 path: the caller
// guarantees f % 4 == 0 and 16-byte aligned x and out. Launches on `stream`
// and returns cudaGetLastError() (0 on success); does not synchronize.
extern "C" int ell_spmm_f32(const int32_t* cols, const float* vals, const float* x,
                            float* out, int64_t n_rows, int width, int f, int vec4,
                            cudaStream_t stream) {
  if (n_rows <= 0 || width <= 0 || f <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(kWarpsPerBlock * 32);
  if (vec4) {
    ell_spmm_kernel<true><<<grid, block, 0, stream>>>(cols, vals, x, out, n_rows, width, f);
  } else {
    ell_spmm_kernel<false><<<grid, block, 0, stream>>>(cols, vals, x, out, n_rows, width, f);
  }
  return static_cast<int>(cudaGetLastError());
}
