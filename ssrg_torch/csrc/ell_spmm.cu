// ELL sparse-times-dense product for Hopper (sm_90a):
//     out[r, :] = sum_w vals[r, w] * x[cols[r, w], :]      r < n_rows, w < width
//
// Replaces ssrg_tpu/ops/pallas_spmm.py::_spmm_kernel, the Pallas TPU kernel that
// gathers the neighbour rows of 8-row blocks by double-buffered DMA and reduces
// them on the vector unit, padding slots (column 0, weight 0) included. This
// kernel adds only the nonzero slots: for finite x the products are the same and
// only the order of the f32 sum differs. One difference by design: an Inf or NaN
// of x under a zero-weight slot turns the reference's row into NaN, not this
// kernel's. The COO tail of a hybrid pack is added outside.
//
// What bounds it: the gather. At the headline graph (N = 169,343, width 24,
// F = 128) the compulsory traffic (the pack, x and out each moved once) is about
// 0.21 GB, 0.0615 ms at the H100 SXM data sheet's 3.35 TB/s, but each of the
// 2,486,502 real slots reads one 512-byte row of x from a data-dependent
// address: 1.27 GB of gathers a hop, from an x of 86.7 MB that does not fit in
// the 50 MB L2. 39 % of the headline pack's slots and 73 % of the power-law
// pack's are padding. Even with x held in L2 the gathers cross from L2 to the
// SMs: that takes about 0.16 ms on the headline pack (its columns folded onto
// an 8.4 MB x; chip_smoke.py, PERF.md), the floor below the bound.
//
// What the design does about it:
// - Feature tiles of kTile floats, walked tile-major within the one launch: the
//   tile is the slowest index of the grid (blockIdx.y), so the card runs every
//   row of tile 0 before tile 1, and the x the warps in flight gather from is
//   N * kTile * 4 bytes (43.4 MB at kTile = 64 against 86.7 MB), which L2 holds
//   in large part. The price: the pack is read once per tile, and each row's
//   listing of its slots is done once per tile.
// - A row group of kG = kTile / 4 lanes owns one output row of the tile, each
//   lane 4 features (one float4 when F % 4 == 0 and x and out are 16-byte
//   aligned, else 4 masked scalars); a warp serves 32 / kG rows at once.
// - The group loads its row's (col, val) slots, kG at a time, with evict-first
//   loads (the pack must not push x out of L2). A warp vote, masked to the
//   group, marks the nonzero slots, and each nonzero goes, in slot order, to the
//   group's list in shared memory (32 slots at a time; widths above 32 take
//   several votes and lists). Padding slots cost no gather and no FMA.
// - The group walks its list kBatch entries at a time: every lane requests its
//   kBatch neighbour rows before it adds any. The warp runs as long as its
//   longest row; shorter rows' lanes sit out with masked loads. Each row's sum
//   is in slot order, so it depends only on the data, not on the schedule.
// - Each output row is written once per tile with streaming stores (no atomics;
//   rows without a nonzero slot, padding rows included, as zeros), so out, which
//   nothing reads again in this launch, does not push x out of L2 either.
// The constants below were chosen by timing variants of this source on the
// H100 (tools/ell_variants.py builds it with other values of kTile, kBatch and
// kWarps and times each; PERF.md): 64-float tiles (32 lists every row four
// times, 128 gathers from all of x), 4-warp blocks, 2 gathers a lane.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // floats of a feature tile
constexpr int kWarps = 4;      // warps of a thread block
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 32;     // slots of a row listed before they are gathered
constexpr int kBatch = 2;      // neighbour rows a lane requests before adding any
constexpr unsigned kFull = 0xffffffffu;
static_assert(kTile == 32 || kTile == 64 || kTile == 128,
              "a row group is kTile / 4 lanes: 8, 16 or 32, within one warp");

// The lane's 4 features of neighbour row `xr` (a pointer to x[col, f0]): features
// 4 * gl + q (vector) or gl + kG * q (scalar) of the nf left in the tile.
template <int kG, bool kVec>
__device__ __forceinline__ void load_x(const float* __restrict__ xr, int gl, int nf,
                                       bool valid, float (&g)[4]) {
  if (kVec) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid && 4 * gl < nf) v = __ldg(reinterpret_cast<const float4*>(xr) + gl);
    g[0] = v.x; g[1] = v.y; g[2] = v.z; g[3] = v.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) g[q] = (valid && gl + kG * q < nf) ? __ldg(xr + gl + kG * q) : 0.f;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
ell_spmm_kernel(const int32_t* __restrict__ cols, const float* __restrict__ vals,
                const float* __restrict__ x, float* __restrict__ out, int64_t n_rows,
                int width, int f, int tiles) {
  constexpr int kG = kTile / 4;  // lanes of a row group
  constexpr int kR = 32 / kG;    // rows of a warp
  // a row group's nonzeros; one entry more than a chunk keeps the groups'
  // reads of the same position on different banks
  __shared__ int2 list_s[kWarps][kR][kChunk + 1];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rg = lane / kG;
  const int gl = lane % kG;
  const unsigned group_bits = kG == 32 ? kFull : ((1u << (kG & 31)) - 1u) << (rg * kG);
  const int64_t row0 = (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * kR;
  if (row0 >= n_rows) return;  // uniform across the warp
  const int64_t row = row0 + rg;
  const bool live = row < n_rows;  // a dead group votes no slot and writes nothing
  const int32_t* row_cols = cols + row * width;
  const float* row_vals = vals + row * width;
  int2* list = list_s[warp][rg];

  for (int t = blockIdx.y; t < tiles; t += gridDim.y) {
    const int f0 = t * kTile;
    const int nf = min(kTile, f - f0);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int c0 = 0; c0 < width; c0 += kChunk) {
      // list the nonzero slots of [c0, c0 + kChunk) in slot order, kG at a time
      int cnt = 0;
      const int c1 = min(c0 + kChunk, width);
      for (int w0 = c0; w0 < c1; w0 += kG) {
        const int w = w0 + gl;
        int32_t c = 0;
        float v = 0.f;
        if (live && w < c1) {
          c = __ldcs(row_cols + w);
          v = __ldcs(row_vals + w);
        }
        const unsigned m = __ballot_sync(kFull, v != 0.f) & group_bits;  // +0, -0 are zero
        if (v != 0.f) list[cnt + __popc(m & ((1u << lane) - 1u))] = make_int2(c, __float_as_int(v));
        cnt += __popc(m);
      }
      __syncwarp();
      // every group walks its own list; the warp runs as long as the longest
      const int most = __reduce_max_sync(kFull, cnt);
      for (int k0 = 0; k0 < most; k0 += kBatch) {
        float vj[kBatch];
        float g[kBatch][4];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const bool valid = k0 + j < cnt;
          const int2 e = valid ? list[k0 + j] : make_int2(0, 0);
          vj[j] = __int_as_float(e.y);  // 0 for an invalid entry, whose g is 0 too
          load_x<kG, kVec>(x + static_cast<int64_t>(e.x) * f + f0, gl, nf, valid, g[j]);
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] = fmaf(vj[j], g[j][q], acc[q]);
        }
      }
      __syncwarp();  // the lists are refilled by the next chunk
    }
    if (live) {
      float* out_row = out + row * static_cast<int64_t>(f) + f0;
      if (kVec) {
        if (4 * gl < nf) {
          __stcs(reinterpret_cast<float4*>(out_row) + gl,
                 make_float4(acc[0], acc[1], acc[2], acc[3]));
        }
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (gl + kG * q < nf) __stcs(out_row + gl + kG * q, acc[q]);
      }
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
  const int64_t rows_a_block = kWarps * (32 / (kTile / 4));
  const int64_t blocks = (n_rows + rows_a_block - 1) / rows_a_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int tiles = (f + kTile - 1) / kTile;
  // tile-major: blockIdx.y is the tile; past 65,535 tiles a block walks several
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(tiles < 65535 ? tiles : 65535));
  if (vec4) {
    ell_spmm_kernel<true><<<grid, kThreads, 0, stream>>>(cols, vals, x, out, n_rows, width, f,
                                                         tiles);
  } else {
    ell_spmm_kernel<false><<<grid, kThreads, 0, stream>>>(cols, vals, x, out, n_rows, width, f,
                                                          tiles);
  }
  return static_cast<int>(cudaGetLastError());
}
