// COO segmented sum for Hopper (sm_90a):
//     out[row[e], :] += val[e] * x[col[e], :]      e < nnz
//
// Replaces no TPU kernel. The JAX package leaves this term, the COO tail of its
// hybrid engine (the overflow of rows longer than the ELL width), to XLA's
// segment_sum, not to a Pallas kernel. The port first ran it as three torch
// operations a chunk of up to 2^19 entries: an index_select of the x rows into
// a [chunk, F] temporary, a scaling by the values that read and wrote it again,
// and an index_add_ that read it a third time and added it entry by entry with
// atomics. On the GCN epoch at ogbn-products' size (9,318,803 tail entries of
// 126,167,309, W = 112, a largest degree of 16,970) those were 486 of the
// epoch's 605 launches and 37 % of its time for 7.4 % of its entries (PERF.md).
// This kernel was added to do that work in one launch, reading each gathered row
// of x once and writing no temporary.
//
// What bounds it: the gather. Each entry reads one F-float row of x from a
// data-dependent address; the tail's columns are the neighbours of hub rows,
// spread over the whole graph, so at F = 256 a launch reads 9.5 GB of rows
// (2.85 ms at the H100 SXM data sheet's 3.35 TB/s) out of an x of 2.5 GB that
// does not fit in the 50 MB L2. The compulsory bytes (the entries, every x row
// and out row touched, each moved once; chip_smoke.py) are several times fewer.
//
// What the design does about it:
// - The entries are cut into segments of kSeg, whatever the rows' lengths, and
//   one group of lanes sums one segment for one feature tile: no group owns a
//   hub row (a hub's 16,858 tail entries are 66 segments), and the grid is set
//   by the entry count alone. The tile is the slowest index of the grid
//   (blockIdx.y), as in the ELL kernel, so a tile's rows are gathered together.
// - A group is the narrowest of 8, 16 and 32 lanes whose tile (4 * kQuads
//   floats a lane) holds the row, so a narrow row keeps every lane busy: at
//   F = 256 a warp is one group on two tiles of 128, at F = 47 two groups of 16
//   on one tile of 64, each group on its own segment.
// - The group loads its entries kG at a time, one per lane, coalesced, with
//   evict-first loads (the entries are read once and must not push x or out out
//   of L2), and loads the next kG before it gathers the current ones. Each
//   entry's row, column and value go to the group's lanes by shuffle.
// - Every lane requests kBatch entries' x rows (kQuads float4, or 4 * kQuads
//   masked scalars, of the tile) before it adds any, scales them by the entry's
//   value and sums consecutive entries of one row in registers. float4 lanes
//   when F % 4 == 0 and x and out are 16-byte aligned; masked scalars otherwise
//   (F = 47, the GCN's class count, is one).
// - When the row changes, and at the segment's end, the run's sum goes to out
//   with one atomic add a feature (float4 atomicAdd on the float4 path, a
//   reduction that returns nothing): one atomic per run, segment and feature,
//   where index_add_ took one per entry and feature. A run inside one segment
//   is added once; a run that crosses segments (a hub) once by each of them.
//   Atomics are taken for every run, not only for the runs at a segment's
//   edges: a run that stays inside its segment is added once all the same, no
//   lane waits for a reduction that returns nothing, and the kernel needs no
//   proof that no other segment holds the row. So it is right on entries that
//   are not sorted by row (the distributed packs pad each shard with row 0
//   after their last row); row-sorted entries only make it fast, with few runs.
// - Only the order of the f32 sums changes: a run's terms are summed in entry
//   order, the runs of one row in the order their atomics land, which varies
//   from run to run as index_add_'s did. The wrapper may pass the real entry
//   count, leaving out the pack's padding (row 0, column 0, value 0 after the
//   last real entry): an Inf or NaN in x's row 0 then does not reach out's row 0,
//   where the reference's segment_sum (0 * Inf) makes it NaN. Stored zeros among
//   the real entries are summed like any other.
// The constants below were chosen by timing variants of this source on the H100
// (tools/coo_variants.py builds it with other values of kSeg, kBatch, kQuads and
// kWarps and times each on the GCN cell's tail; PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSeg = 256;      // entries of a group's segment
constexpr int kWarps = 4;      // warps of a thread block
constexpr int kThreads = 32 * kWarps;
constexpr int kBatch = 4;      // entries whose x rows a lane requests before adding any
constexpr int kQuads = 1;      // float4 (or 4 scalars) of a tile a lane holds
constexpr int kLane = 4 * kQuads;  // floats of a tile a lane holds
constexpr unsigned kFull = 0xffffffffu;
static_assert(kSeg % 32 == 0, "a segment is whole loads of a group's entries");

// The lane's floats of a tile of row `xr` (a pointer to x[col, f0]): features
// 4 * (kG * p + gl) + q (vector) or gl + kG * k (scalar) of the nf left.
template <int kG, bool kVec>
__device__ __forceinline__ void load_x(const float* __restrict__ xr, int gl, int nf,
                                       bool valid, float (&g)[kLane]) {
  if (kVec) {
#pragma unroll
    for (int p = 0; p < kQuads; ++p) {
      const int i = kG * p + gl;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (valid && 4 * i < nf) v = __ldg(reinterpret_cast<const float4*>(xr) + i);
      g[4 * p] = v.x; g[4 * p + 1] = v.y; g[4 * p + 2] = v.z; g[4 * p + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kLane; ++k) {
      const int i = gl + kG * k;
      g[k] = (valid && i < nf) ? __ldg(xr + i) : 0.f;
    }
  }
}

// out[row, f0 : f0 + nf] += acc, the lane's share, by atomics.
template <int kG, bool kVec>
__device__ __forceinline__ void add_run(float* __restrict__ out_row, int gl, int nf,
                                        const float (&acc)[kLane]) {
  if (kVec) {
#pragma unroll
    for (int p = 0; p < kQuads; ++p) {
      const int i = kG * p + gl;
      if (4 * i < nf) {
        atomicAdd(reinterpret_cast<float4*>(out_row) + i,
                  make_float4(acc[4 * p], acc[4 * p + 1], acc[4 * p + 2], acc[4 * p + 3]));
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kLane; ++k) {
      const int i = gl + kG * k;
      if (i < nf) atomicAdd(out_row + i, acc[k]);
    }
  }
}

// A group of kG lanes sums one segment of kSeg entries for one feature tile of
// 4 * kQuads * kG floats; a warp holds 32 / kG groups, each on its own segment.
template <int kG, bool kVec>
__global__ void __launch_bounds__(kThreads)
coo_segment_sum_kernel(const int32_t* __restrict__ row, const int32_t* __restrict__ col,
                       const float* __restrict__ val, const float* __restrict__ x,
                       float* __restrict__ out, int64_t nnz, int f, int tiles,
                       int64_t segments) {
  constexpr int kR = 32 / kG;       // groups of a warp
  constexpr int kTile = kLane * kG;  // floats of a feature tile
  const int lane = threadIdx.x & 31;
  const int gl = lane % kG;
  const int base = lane - gl;        // the group's first lane
  const int64_t seg0 = (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * kR;
  if (seg0 >= segments) return;      // uniform across the warp
  const int64_t e0 = (seg0 + lane / kG) * kSeg;
  // the group's entries; 0 for a group past the last segment
  const int len = static_cast<int>(e0 < nnz ? (nnz - e0 < kSeg ? nnz - e0 : kSeg) : 0);
  const int most = __reduce_max_sync(kFull, len);  // the warp runs as long as its longest

  for (int t = blockIdx.y; t < tiles; t += gridDim.y) {
    const int f0 = t * kTile;
    const int nf = min(kTile, f - f0);
    float acc[kLane];
#pragma unroll
    for (int k = 0; k < kLane; ++k) acc[k] = 0.f;
    int cur = -1;  // the row of the run being summed; none before the first entry

    // this lane's entry of the group's next kG, loaded one round ahead
    int32_t r_next = 0, c_next = 0;
    float v_next = 0.f;
    if (gl < len) {
      r_next = __ldcs(row + e0 + gl);
      c_next = __ldcs(col + e0 + gl);
      v_next = __ldcs(val + e0 + gl);
    }
    for (int c0 = 0; c0 < most; c0 += kG) {
      const int n = min(kG, len - c0);  // the group's entries of this round; <= 0 past its end
      const int32_t r = r_next, c = c_next;
      const float v = v_next;
      if (c0 + kG + gl < len) {
        r_next = __ldcs(row + e0 + c0 + kG + gl);
        c_next = __ldcs(col + e0 + c0 + kG + gl);
        v_next = __ldcs(val + e0 + c0 + kG + gl);
      }
      const int steps = min(kG, most - c0);  // uniform across the warp
      for (int j0 = 0; j0 < steps; j0 += kBatch) {
        float g[kBatch][kLane];
        float vj[kBatch];
        int32_t rj[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int src = base + ((j0 + j) & (kG - 1));
          const int32_t cj = __shfl_sync(kFull, c, src);
          vj[j] = __shfl_sync(kFull, v, src);
          rj[j] = __shfl_sync(kFull, r, src);
          load_x<kG, kVec>(x + static_cast<int64_t>(cj) * f + f0, gl, nf, j0 + j < n, g[j]);
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (j0 + j < n) {  // uniform across the group
            if (rj[j] != cur) {
              if (cur >= 0) {
                add_run<kG, kVec>(out + static_cast<int64_t>(cur) * f + f0, gl, nf, acc);
              }
              cur = rj[j];
#pragma unroll
              for (int k = 0; k < kLane; ++k) acc[k] = 0.f;
            }
#pragma unroll
            for (int k = 0; k < kLane; ++k) acc[k] = fmaf(vj[j], g[j][k], acc[k]);
          }
        }
      }
    }
    if (cur >= 0) add_run<kG, kVec>(out + static_cast<int64_t>(cur) * f + f0, gl, nf, acc);
  }
}

template <int kG>
int launch(const int32_t* row, const int32_t* col, const float* val, const float* x,
           float* out, int64_t nnz, int f, bool vec4, cudaStream_t stream) {
  const int64_t segments = (nnz + kSeg - 1) / kSeg;
  const int64_t per_block = static_cast<int64_t>(kWarps) * (32 / kG);
  const int64_t blocks = (segments + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int tiles = (f + kLane * kG - 1) / (kLane * kG);
  // tile-major: blockIdx.y is the tile; past 65,535 tiles a block walks several
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(tiles < 65535 ? tiles : 65535));
  if (vec4) {
    coo_segment_sum_kernel<kG, true><<<grid, kThreads, 0, stream>>>(row, col, val, x, out, nnz,
                                                                    f, tiles, segments);
  } else {
    coo_segment_sum_kernel<kG, false><<<grid, kThreads, 0, stream>>>(row, col, val, x, out, nnz,
                                                                     f, tiles, segments);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// row, col int32 [>= nnz], val f32 [>= nnz], x f32 [*, f] and out f32 [*, f], all
// contiguous on the current device; every row index must lie in out and every
// column index in x. Adds the first nnz entries into out. vec4 != 0 asks for the
// float4 path: the caller guarantees f % 4 == 0 and 16-byte aligned x and out.
// The group is the narrowest of 8, 16 and 32 lanes whose tile holds the row.
// Launches on `stream` and returns cudaGetLastError() (0 on success); does not
// synchronize.
extern "C" int coo_spmm_f32(const int32_t* row, const int32_t* col, const float* val,
                            const float* x, float* out, int64_t nnz, int f, int vec4,
                            cudaStream_t stream) {
  if (nnz <= 0 || f <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (f <= 8 * kLane) return launch<8>(row, col, val, x, out, nnz, f, vec4 != 0, stream);
  if (f <= 16 * kLane) return launch<16>(row, col, val, x, out, nnz, f, vec4 != 0, stream);
  return launch<32>(row, col, val, x, out, nnz, f, vec4 != 0, stream);
}
