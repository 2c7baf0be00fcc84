// Segmented sum of a destination-sorted COO ("scattered rest") for Hopper
// (sm_90a), with the gather fused in:
//     out[r, :] = sum_{e in [row_ptr[r], row_ptr[r+1])} g_e
//     g_e = vals[e] * x[cols[e], :]                       (f32 products), or
//     g_e = bf16(bf16(x[cols[e], :]) * bf16(vals[e]))     (gather_bf16)
//
// Replaces ssrg_tpu/ops/pallas_rest.py::_rest_kernel. On the TPU the rest is cut
// into chunks of `chunk` edges that each belong to one row block; XLA gathers
// the [P, chunk, F] slab of scaled neighbour rows into device memory, and the
// Pallas kernel reduces each chunk as a one-hot matrix product into the row
// block's output, which it revisits across consecutive chunks (zeroed on the
// first visit), because a scatter is slow there. Hopper has no such need: this
// kernel reads the same layout (cols and vals [P, chunk], flat) through a row
// offset array that the host derives once from it, and never builds the slab.
// Entries of a row are contiguous in the layout: build_rest_segmented sorts
// by (row, col), and the pad entries (col 0, val 0) that fill each row
// block's last chunk sit after its last row's entries, where this kernel
// skips them. The
// bf16 variant keeps the reference's rounding points: x and the weight rounded
// to bf16, their product rounded to bf16, the sum in f32.
//
// What bounds it: bytes. At the rest of community_graph(169,343) (675,240
// edges in 728 chunks of 1,024, F 128) the layout is 8.95 MB, x 86.7 MB and out
// 87.0 MB: 0.0545 ms at 3.35 TB/s. The useful work, 2 * 675,240 * 128 flops,
// is negligible. The gather itself (675,240 rows of 512 bytes, 346 MB) reads
// rows of x at data-dependent addresses, partly from L2.
//
// What the simple design does about it: one warp per output row, lanes across
// F, so every neighbour row is read in coalesced 128-byte segments; the
// (col, val) pairs of a row are loaded once per warp, 32 at a time, and
// broadcast by shuffle. Sums stay in f32 registers; every row of the output is
// written once, rows without an edge as zeros, so no output needs zeroing
// beforehand, there are no atomics, and the result does not depend on the
// schedule. F wider than 128 floats is walked in 128-float tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kTile = 128;  // floats of a row that one warp covers per pass
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool kBf16>
__device__ __forceinline__ float term(float v, float xv) {
  // v is already rounded to bf16 in the bf16 variant
  if (kBf16) return round_bf16(__fmul_rn(v, round_bf16(xv)));
  return __fmul_rn(v, xv);  // the rounded product, as the reference gathers it
}

template <bool kBf16>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rest_spmm_kernel(const int64_t* __restrict__ row_ptr, const int32_t* __restrict__ cols,
                 const float* __restrict__ vals, const float* __restrict__ x,
                 float* __restrict__ out, int64_t n_rows, int f) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // uniform across the warp
  const int64_t start = row_ptr[row];
  const int64_t end = row_ptr[row + 1];
  float* out_row = out + row * static_cast<int64_t>(f);

  for (int f0 = 0; f0 < f; f0 += kTile) {
    float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
    for (int64_t e0 = start; e0 < end; e0 += 32) {
      const int n = static_cast<int>(min(static_cast<int64_t>(32), end - e0));
      int32_t my_col = 0;
      float my_val = 0.f;
      if (lane < n) {
        my_col = cols[e0 + lane];
        my_val = vals[e0 + lane];
      }
      for (int j = 0; j < n; ++j) {
        const int64_t c = __shfl_sync(kFullMask, my_col, j);
        float v = __shfl_sync(kFullMask, my_val, j);
        if (c == 0 && v == 0.f) continue;  // a pad entry (uniform across the warp)
        if (kBf16) v = round_bf16(v);
        const float* xr = x + c * f + f0;
        if (f0 + lane < f) acc0 += term<kBf16>(v, __ldg(xr + lane));
        if (f0 + lane + 32 < f) acc1 += term<kBf16>(v, __ldg(xr + lane + 32));
        if (f0 + lane + 64 < f) acc2 += term<kBf16>(v, __ldg(xr + lane + 64));
        if (f0 + lane + 96 < f) acc3 += term<kBf16>(v, __ldg(xr + lane + 96));
      }
    }
    if (f0 + lane < f) out_row[f0 + lane] = acc0;
    if (f0 + lane + 32 < f) out_row[f0 + lane + 32] = acc1;
    if (f0 + lane + 64 < f) out_row[f0 + lane + 64] = acc2;
    if (f0 + lane + 96 < f) out_row[f0 + lane + 96] = acc3;
  }
}

}  // namespace

// row_ptr int64 [n_rows + 1] (entries of row r at flat positions
// [row_ptr[r], row_ptr[r + 1]) of cols and vals), cols int32 and vals f32 (flat,
// at least row_ptr[n_rows] entries), x f32 [*, f] and out f32 [n_rows, f], all
// contiguous on the current device; every column index must lie in x.
// gather_bf16 != 0 selects the bf16 rounding points. Launches on `stream` and
// returns cudaGetLastError() (0 on success); does not synchronize.
extern "C" int rest_spmm(const int64_t* row_ptr, const int32_t* cols, const float* vals,
                         const float* x, float* out, int64_t n_rows, int f, int gather_bf16,
                         cudaStream_t stream) {
  if (n_rows <= 0 || f <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(blocks));
  const dim3 block(kWarpsPerBlock * 32);
  if (gather_bf16) {
    rest_spmm_kernel<true><<<grid, block, 0, stream>>>(row_ptr, cols, vals, x, out, n_rows, f);
  } else {
    rest_spmm_kernel<false><<<grid, block, 0, stream>>>(row_ptr, cols, vals, x, out, n_rows, f);
  }
  return static_cast<int>(cudaGetLastError());
}
