// Segmented sum of a destination-sorted COO ("scattered rest") for Hopper
// (sm_90a), with the gather fused in:
//     out[r, :] = sum_{e in [row_ptr[r], row_end[r])} g_e
//     g_e = vals[e] * x[cols[e], :]                       (f32 products), or
//     g_e = bf16(bf16(x[cols[e], :]) * bf16(vals[e]))     (gather_bf16)
//
// Replaces ssrg_tpu/ops/pallas_rest.py::_rest_kernel. On the TPU the rest is cut
// into chunks of `chunk` edges that each belong to one row block; XLA gathers
// the [P, chunk, F] slab of scaled neighbour rows into device memory, and the
// Pallas kernel reduces each chunk as a one-hot matrix product into the row
// block's output, which it revisits across consecutive chunks (zeroed on the
// first visit), because a scatter is slow there. Hopper has no such need: this
// kernel reads the same layout (cols and vals [P, chunk], flat) through two
// arrays that the host derives once from it, and never builds the slab.
// Entries of a row are contiguous in the layout (build_rest_segmented sorts by
// (row, col)); row_ptr[r] is the first of them and row_end[r] one past the
// last real one, so the pad entries (col 0, val 0) that fill each row block's
// last chunk lie outside every row's range and are never read. The bf16
// variant keeps the reference's rounding points: x and the weight rounded to
// bf16, their product rounded to bf16, the sum in f32.
//
// What bounds it: bytes. At the rest of community_graph(169,343) (675,240
// edges in 728 chunks of 1,024, F 128) cols and vals are 5.96 MB, row_ptr
// 1.36 MB, x 86.7 MB and out 87.0 MB: 181.1 MB, 0.0541 ms at the H100 SXM data
// sheet's 3.35 TB/s (row_end, another 1.36 MB, is this design's and not
// counted). The useful work, 2 * 675,240 * 128 flops, is negligible. The gather
// reads 675,240 rows of 512 bytes (346 MB) at data-dependent addresses from an
// x that does not fit in the 50 MB L2, so part of it comes from device memory
// more than once, and the bound (x once) may be out of reach.
//
// What the design does about it: rows hold 4 real entries on average, so the
// lever is loads in flight. For F % 4 == 0 and a 16-byte aligned x, half a warp
// owns an output row and each lane holds 8 of a 128-feature tile as two
// float4s, one 16-byte load per neighbour row per float4, neighbouring lanes on
// neighbouring addresses (on the community rest half a warp a row ran 6-7 %
// faster than a warp a row, one float4 a lane; PERF.md). The (col, val) pairs
// of kBatch entries are read first (the same address for all lanes of the
// row), then the kBatch neighbour rows are all requested before any is added;
// terms are added in entry order, so the sum order is fixed. Other F, or a
// misaligned x, take masked scalar loads, a warp a row, 4 strided floats a
// lane. x, cols and vals go through the read-only path; the output, written
// once, goes out with streaming (evict-first) stores so that it does not push
// x out of L2. Every row is written once, rows without an edge as zeros: no
// output needs zeroing beforehand, there are no atomics, and the result does
// not depend on the schedule. F wider than 128 floats is walked in 128-float
// tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 4;  // neighbour rows requested before any is added
constexpr int kTile = 128;  // features an output row's lanes cover per pass

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool kBf16>
__device__ __forceinline__ float term(float v, float xv) {
  // v is already rounded to bf16 in the bf16 variant
  if (kBf16) return round_bf16(__fmul_rn(v, round_bf16(xv)));
  return __fmul_rn(v, xv);  // the rounded product, as the reference gathers it
}

// kLanes lanes own a row (16 on the vector path, 32 on the scalar one); each
// holds kPer = kTile / kLanes features of a tile: float4 q of the lane covers
// f0 + 4 * (lane + kLanes * q) + 0..3 (vector), or feature f0 + lane + 32 * i
// (scalar).
template <bool kBf16, bool kVec>
__global__ void __launch_bounds__(kThreads)
rest_spmm_kernel(const int64_t* __restrict__ row_ptr, const int64_t* __restrict__ row_end,
                 const int32_t* __restrict__ cols, const float* __restrict__ vals,
                 const float* __restrict__ x, float* __restrict__ out, int64_t n_rows, int f) {
  constexpr int kLanes = kVec ? 16 : 32;
  constexpr int kPer = kTile / kLanes;
  const int lane = threadIdx.x & (kLanes - 1);
  const int64_t row = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) / kLanes;
  if (row >= n_rows) return;  // uniform across the row's lanes
  const int64_t start = __ldg(row_ptr + row);
  const int64_t end = __ldg(row_end + row);
  float* out_row = out + row * static_cast<int64_t>(f);

  for (int f0 = 0; f0 < f; f0 += kTile) {
    float acc[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
    for (int64_t e0 = start; e0 < end; e0 += kBatch) {
      float v[kBatch];
      const float* xr[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const bool valid = e0 + j < end;
        const int64_t c = valid ? __ldg(cols + e0 + j) : 0;
        v[j] = valid ? __ldg(vals + e0 + j) : 0.f;
        if (kBf16) v[j] = round_bf16(v[j]);
        xr[j] = x + c * f + f0;
      }
      float g[kBatch][kPer];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const bool valid = e0 + j < end;
        if (kVec) {
#pragma unroll
          for (int q = 0; q < kPer / 4; ++q) {
            const int c = 4 * (lane + kLanes * q);
            float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
            if (valid && f0 + c < f) t = __ldg(reinterpret_cast<const float4*>(xr[j] + c));
            g[j][4 * q] = t.x; g[j][4 * q + 1] = t.y; g[j][4 * q + 2] = t.z; g[j][4 * q + 3] = t.w;
          }
        } else {
#pragma unroll
          for (int i = 0; i < kPer; ++i) {
            const int c = lane + 32 * i;
            g[j][i] = (valid && f0 + c < f) ? __ldg(xr[j] + c) : 0.f;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (e0 + j < end) {  // uniform across the row's lanes
#pragma unroll
          for (int i = 0; i < kPer; ++i) acc[i] += term<kBf16>(v[j], g[j][i]);
        }
      }
    }
    if (kVec) {
#pragma unroll
      for (int q = 0; q < kPer / 4; ++q) {
        const int c = 4 * (lane + kLanes * q);
        if (f0 + c < f) {
          __stcs(reinterpret_cast<float4*>(out_row + f0 + c),
                 make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]));
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        if (f0 + lane + 32 * i < f) __stcs(out_row + f0 + lane + 32 * i, acc[i]);
    }
  }
}

template <bool kBf16, bool kVec>
cudaError_t launch_variant(const int64_t* row_ptr, const int64_t* row_end,
                           const int32_t* cols, const float* vals, const float* x, float* out,
                           int64_t n_rows, int f, cudaStream_t stream) {
  constexpr int kLanes = kVec ? 16 : 32;
  const int64_t blocks = (n_rows * kLanes + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  rest_spmm_kernel<kBf16, kVec><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      row_ptr, row_end, cols, vals, x, out, n_rows, f);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t launch_path(const int64_t* row_ptr, const int64_t* row_end, const int32_t* cols,
                        const float* vals, const float* x, float* out, int64_t n_rows, int f,
                        cudaStream_t stream) {
  const bool vec = f % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto* variant = vec ? launch_variant<kBf16, true> : launch_variant<kBf16, false>;
  return variant(row_ptr, row_end, cols, vals, x, out, n_rows, f, stream);
}

}  // namespace

// row_ptr and row_end int64 [n_rows] (the entries of row r are the flat
// positions [row_ptr[r], row_end[r]) of cols and vals), cols int32 and vals f32
// (flat), x f32 [*, f] and out f32 [n_rows, f], all contiguous on the current
// device; every column index in a row's range must lie in x. gather_bf16 != 0
// selects the bf16 rounding points. Launches on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronize.
extern "C" int rest_spmm(const int64_t* row_ptr, const int64_t* row_end, const int32_t* cols,
                         const float* vals, const float* x, float* out, int64_t n_rows, int f,
                         int gather_bf16, cudaStream_t stream) {
  if (n_rows <= 0 || f <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto* path = gather_bf16 ? launch_path<true> : launch_path<false>;
  return static_cast<int>(path(row_ptr, row_end, cols, vals, x, out, n_rows, f, stream));
}
