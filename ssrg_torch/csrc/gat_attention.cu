// Graph attention (GAT) edge attention for Hopper (sm_90a), forward and backward.
//
// The entries of the attention's edge structure are listed by destination
// (row = i, col = j: a message from j to i), sorted by row; H heads of C
// features each, z = [N, H, C], the scores s_src, s_dst = [N, H]:
//
//   pre[e, h]   = s_dst[i, h] + s_src[j, h]
//   a[e, h]     = pre > 0 ? pre : slope * pre                       (LeakyReLU)
//   m[i, h]     = max of a over i's entries,  l[i, h] = sum of exp(a - m[i, h])
//   alpha[e, h] = exp(a - m[i, h]) / l[i, h]
//   out[i, h, :] = sum over i's entries of alpha[e, h] * z[j, h, :]
//
// and, given g = dL/dout:
//
//   delta[i, h]  = <g[i, h, :], out[i, h, :]>           (= sum over i's entries of alpha * dalpha)
//   dz[j, h, :]  = sum over the entries (i <- j) of alpha * g[i, h, :]
//   dalpha       = <g[i, h, :], z[j, h, :]>
//   dpre         = alpha * (dalpha - delta[i, h]) * (pre > 0 ? 1 : slope)
//   ds_src[j, h] += dpre,  ds_dst[i, h] += dpre
//
// Replaces no TPU kernel: the JAX package's GAT (ssrg_tpu/models/baselines.py)
// leaves the scores, the segment softmax and the weighted sum to XLA, and builds
// the per-edge messages z[j] * alpha as one [E, H, C] array. At ogbn-products'
// size with self-loops (126,167,309 entries, H = 4, C = 128) that array is 258 GB
// a layer, more than three cards hold, and autograd keeps arrays of its kind for
// the backward pass. These kernels hold no per-edge message: a message is
// gathered, scaled and summed in registers, and only [N, H] statistics (m, l,
// delta) stay between the kernels; alpha is recomputed where it is needed from
// them and the scores, never stored.
//
// What bounds them: the gathers. Each entry of the weighted sum reads one C-float
// slice of z (512 bytes at C = 128) from a data-dependent row; at the cell's size
// that is 258 GB a pass over all heads (77 ms at the H100 SXM data sheet's
// 3.35 TB/s), from a z of 5.0 GB that does not fit in the 50 MB L2. The backward
// pass gathers g the same way. The compulsory bytes (the entries, z or g, out or
// dz, each once) are some twenty times fewer. The statistics read 4 bytes of
// s_src an entry and head (s_src, 39 MB, mostly stays in L2).
//
// What the design does about it:
// - Four kernels, three launches forward and two backward. gat_stats_kernel runs
//   twice (kPhase 0: the row maxima m; 1: the row sums l) over the entries, one
//   thread an entry, every head in turn: a warp's 32 consecutive entries are
//   reduced by row in registers (a segmented reduction by shuffles: entries are
//   sorted by row, so a row's entries in the warp are consecutive) and each run's
//   first lane adds its result into m or l with one atomic. gat_aggregate_kernel
//   is the weighted sum. gat_rowdot_kernel computes delta and packs the row-side
//   values (s_dst, m, l, delta) of every (i, h) into one float4, which the
//   backward kernel then gathers in one 16-byte load. gat_backward_kernel walks
//   the transposed listing (entries by source j) and, in the same pass, adds
//   dz, computes dalpha and dpre, and adds ds_src and ds_dst: dalpha costs no
//   second gather of z or g, since z[j] stays in registers along j's run.
// - The weighted sums are cut as the COO tail kernel (coo_spmm.cu) cuts its
//   entries: segments of kSeg entries whatever the rows' lengths, one group of
//   lanes a segment and head. No group owns a hub row (a row of 17,000 entries is
//   67 segments), and the grid is set by the entry count. A run of one row inside
//   a segment is summed in registers and added to out (or dz) with one atomic a
//   feature; a row that crosses segments is added once by each of them, so the
//   softmax statistics of a split row are joined by the atomics of the stats
//   kernel (max, then sum) before any weight is formed.
// - Per head: a group is the narrowest of 8, 16 and 32 lanes whose tile (4 * kQuads
//   floats a lane) holds one head's C features, so the head is the grid's slowest
//   index (blockIdx.y) and a group's dalpha is a sum over its own lanes (shuffles,
//   no atomics). float4 lanes when C % 4 == 0 and z, out, g and dz are 16-byte
//   aligned; masked scalars otherwise.
// - Whole row, where a head is not whole float4s but the row of H heads is (C = 47,
//   the class count of the last layer: 4 x 47 = 188 floats, 752 bytes): per head,
//   16 scalar lanes would issue four loads a lane for 188 bytes, fetch an entry's
//   indices and statistics once a head, and touch 6-7 sectors for a head's slice
//   (26-28 for the four, where the row needs 24-25). So a group of kRowG lanes (32
//   for rows over 16 kRowG floats) gathers the whole row of an entry in float4
//   lanes, at most 4 a lane, with no head on the grid; each float knows its head,
//   as in gat_scores_kernel. The group's lanes are slots of kH lanes (the heads
//   rounded up to 2, 4 or 8): lane kH s + h fetches head h's values of the round's
//   entries s, s + kS, ... (the indices once a slot, s_src[j, h] and the row's
//   statistics beside its neighbours'), and each float takes its head's weight
//   from that lane by one shuffle. Backward, a run keeps z[j] as one masked copy
//   per head, so each head's dalpha is a lane's multiply-adds, then one exchange
//   that halves the heads a lane holds at each step leaves the group's sum of head
//   h on the lanes kH s + h, which hold that entry's values: one ds_dst atomic a
//   head and entry, ds_src summed in entry order by the lanes of slot 0, one
//   atomic a head and run. The f32 sums of z and g keep their order; only
//   dalpha's changes. Registers are capped so that an SM holds kRowBlocks blocks
//   (row_blocks). Taken for at most kRowHeads heads and kRowFloats floats; every
//   other shape keeps the per-head instances, C = 128 among them.
// - Per head, each lane of a group loads one entry of the group's next kG, one
//   round ahead, computes that entry's alpha (and, backward, the other per-entry
//   values) and hands them to the group by shuffle; every lane requests kBatch rows
//   (kRowBatch on whole rows) before it adds any.
// - Only the order of the f32 sums differs from the plain version: a run's terms
//   in entry order, the runs of one row in the order their atomics land.
// The constants and the design were chosen by timing on the H100
// (tools/kernels.py, its gat entry, on the GAT cell's listing; PERF.md). Whole rows at 4 heads of
// 47, ms a weighted sum / backward pass: 39.82 / 52.51 against the per-head scalar
// lanes' 61.35 / 84.81. 32-lane groups (2 float4s a lane) beat 16 (3 float4s;
// 41.71 / 64.57), 8 entries a batch beat 4 and 16, and registers capped at 4 blocks
// an SM beat 3 (39.86 / 57.58), no cap (39.79 / 57.24) and 5-8 (spills, up to 151 /
// 214); one copy of z[j] with a select a head and float in place of the masked
// copies took 39.82 / 55.08.
// Per head: no value of kSeg (128,
// 512), kBatch (2, 8) or kWarps (8) moved the weighted sum or the backward pass by 1 %;
// the backward pass split into two launches (dz, then dalpha and the scores'
// gradients, each gathering g) took 1.77 and 1.69 times as long (C = 128, 47); the
// scores' values loaded two rounds ahead in place of one changed nothing. The ELL and
// COO kernels with alpha as their values sum 14-23 % faster than gat_aggregate_kernel,
// but need alpha laid out in their packs, per-head copies of z and of the output, and
// give no dalpha.
//
// The scores and their gradient, a_src and a_dst = [H, C] (the layer's weights):
//
//   s_src[n, h] = <z[n, h, :], a_src[h, :]>,   s_dst[n, h] = <z[n, h, :], a_dst[h, :]>
//   dz[n, h, :] = ds_src[n, h] * a_src[h, :] + ds_dst[n, h] * a_dst[h, :]
//   da_src[h, :] = sum over n of ds_src[n, h] * z[n, h, :],  da_dst likewise
//
// They replace no TPU kernel: XLA fuses the reference's (z * a).sum(-1)
// (ssrg_tpu/models/baselines.py:194-195). In eager PyTorch each score is a
// broadcast product written out as [N, H, C] and a sum that reads it back, and
// autograd's backward adds four more products, two sums over N and an add into
// dz: about 30 GB a forward and 70 GB a backward pass at N = 2,449,029, H = 4,
// C = 128, where the compulsory bytes are one read of z (5.0 GB) forward and a
// read of z and a write of dz backward. Both kernels are bound by those bytes.
// - One warp a row of z, the warps striding over the rows; a row's H * C floats
//   are read once, float4 lanes where the row and the chunk are whole float4s
//   (also at C = 47: a head's boundary falls inside a lane's float4, and each of
//   its floats carries the index of its head), with evict-first loads and stores.
//   A warp takes a chunk of at most 512 floats and 32 whole heads (blockIdx.y
//   picks the chunk of a row longer than that); which head each of its lane's
//   floats belongs to, and the weights a_src and a_dst there, are the same for
//   every row, so the lane loads them once. A head's dot product is the lane's
//   share summed by shuffles; lane h writes head h. The grid holds as many
//   blocks as the device keeps resident (at C = 47, 4 blocks an SM took 1.74 ms
//   a forward pass and 8 took 1.12 on the cell's z; PERF.md).
// - Backward, lane h holds the row's ds_src and ds_dst of head h and hands them
//   to the floats of that head by shuffle; dz is written once (autograd adds it
//   to the attention's dz). da is summed without atomics, so two runs give the
//   same bits: each lane keeps its floats' sums over its warp's rows, a block
//   sums its warps' in warp order into its own partial row, and
//   gat_score_sum_kernel sums the blocks' partial rows in block order.
//
// Per-edge scores and dropped weights (UniMP's graph-transformer attention, PyG's
// TransformerConv; and GAT with its weights dropped). With q, k, v = [N, H, C] and a
// mask M = [H, E] of the entries e of the row listing (1 kept, 0 dropped; none at a
// rate of 0), keep = 1 / (1 - rate):
//
//   s[h, e]      = scale * <q[i, h, :], k[j, h, :]>                       (sddmm_kernel)
//   alpha[e, h]  = exp(s - m[i, h]) / l[i, h],  alpha~ = alpha * M * keep
//   out[i, h, :] = sum over i's entries of alpha~ * v[j, h, :]
//
// and backward, given g, with delta[i, h] = <g[i, h, :], out[i, h, :]>:
//
//   dv[j, h, :]  = sum over the entries (i <- j) of alpha~ * g[i, h, :]
//   ds[h, e]     = alpha * (M * keep * <g[i, h, :], v[j, h, :]> - delta[i, h])
//   dq[i, h, :]  = scale * sum over i's entries of ds * k[j, h, :]
//   dk[j, h, :]  = scale * sum over the entries (i <- j) of ds * q[i, h, :]
//
// The steps are the node-score kernels above in another mode (kMode): the stats
// kernel reads s in place of the node scores; the weighted sum forms alpha~ from s
// (kEdgeScores), or takes given weights (kEdgeWeights: dq and dk, weights ds); the
// backward pass forms alpha from s, adds dv, and writes ds in place of adding the
// node scores' gradients; GAT's weights dropped (kNodeMasked) multiply alpha by the
// mask. kNodeScores is GAT's attention as it was: its instances read no mask. Per-edge
// arrays are head-major, [H, E], so that a head's entries lie in the listing's order;
// a pass over the transposed listing finds an entry's place in the row listing in
// pos (the forward place of each transposed entry). Only per-head instances take
// these modes; the whole-row path stays GAT's. sddmm_kernel is a group a segment and
// head, as the weighted sum: it keeps q[i] of the run's row in registers and gathers
// k[j] (the bytes that bound it, as z bounds the weighted sum), each entry's dot
// product summed over the group's lanes by shuffles. Nothing of [E, H, C] is formed.
// A fused row kernel with an online softmax (reading k and v once an entry) was not
// built: it gathers the same bytes as the scores' kernel and the weighted sum
// together, and could save only the stats kernel and the scores' [H, E] traffic,
// about 1 % of the UniMP cell's epoch (its traced epoch; PERF.md),
// while a hub row split across segments would need a second pass to merge.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;      // warps of a thread block
constexpr int kThreads = 32 * kWarps;
constexpr int kSeg = 256;      // entries of a group's segment
constexpr int kBatch = 4;      // entries whose rows a lane requests before adding any
constexpr unsigned kFull = 0xffffffffu;
static_assert(kSeg % 32 == 0, "a segment is whole loads of a group's entries");

// The whole-row path of the weighted sum and the backward pass:
constexpr int kRowG = 32;        // lanes of a group for rows up to 16 kRowG floats (32 above)
constexpr int kRowBatch = 8;     // entries whose rows a lane requests before adding any
constexpr int kRowBlocks = 4;       // blocks an SM holds at once, at least: caps the registers
constexpr int kRowLaneFloats = 96;  // of the instances whose lanes hold at most this (row_blocks)
constexpr int kRowFloats = 512;  // the longest row the path takes (0: none)
constexpr int kRowHeads = 8;     // the most heads the path takes
struct WholeRow {};              // names the path in the kernels' instances
static_assert(kRowG >= kRowHeads && kRowG <= 32 && kRowFloats <= 512 && kRowHeads <= 8,
              "a group holds a slot of every head, and a row in at most 4 float4s a lane");

__device__ __forceinline__ float leaky(float p, float slope) { return p > 0.f ? p : slope * p; }

// Where an entry's weight comes from (kMode of the per-head weighted sum and
// backward pass): GAT's node scores as they were, GAT's node scores with the
// weights dropped, per-edge scores (alpha~ from s, m, l and the mask, if any), or
// per-edge weights as given.
constexpr int kNodeScores = 0, kNodeMasked = 1, kEdgeScores = 2, kEdgeWeights = 3;

// The per-edge operands of the modes other than kNodeScores, all [H, E] by the
// entry's place e in the row listing: es the scores or the weights, mask 1 where a
// weight is kept (null: none dropped), keep the factor of a kept weight; pos the
// place e of each entry of the listing walked (null: the row listing itself).
struct EdgeOps {
  const float* es;
  const uint8_t* mask;
  const int32_t* pos;
  float keep;
};

// The index in an [H, E] array of listed entry `e`, head h.
__device__ __forceinline__ int64_t edge_index(const EdgeOps& ops, int64_t e, int h, int64_t nnz) {
  const int64_t f = ops.pos != nullptr ? static_cast<int64_t>(__ldcs(ops.pos + e)) : e;
  return static_cast<int64_t>(h) * nnz + f;
}

// The factor of a kept or dropped weight at index x: keep or 0, 1 without a mask.
__device__ __forceinline__ float kept(const EdgeOps& ops, int64_t x) {
  return ops.mask == nullptr ? 1.f : (__ldg(ops.mask + x) != 0 ? ops.keep : 0.f);
}

// *addr = max(*addr, v) for floats, by the order of their bits: a value whose sign
// bit is clear orders as a signed int, one whose sign bit is set in reverse as an
// unsigned int (-0.0 and -inf included).
__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
  if (__float_as_int(v) >= 0) {
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  } else {
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
  }
}

// kPhase 0: m[i, h] = max over i's entries of a[e, h] (m holds -inf on entry).
// kPhase 1: l[i, h] += exp(a[e, h] - m[i, h]) (l holds 0 on entry).
// a is leaky(s_dst[i] + s_src[j]), or with kEdge the per-edge score es[h, e].
template <int kPhase, bool kEdge>
__global__ void __launch_bounds__(kThreads)
gat_stats_kernel(const int32_t* __restrict__ row, const int32_t* __restrict__ col,
                 const float* __restrict__ s_src, const float* __restrict__ s_dst,
                 const float* __restrict__ es, float* __restrict__ m, float* __restrict__ l,
                 int64_t nnz, int heads, float slope) {
  const int lane = threadIdx.x & 31;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e - lane >= nnz) return;  // uniform across the warp
  const bool valid = e < nnz;
  const int32_t r = valid ? __ldcs(row + e) : -1;
  const int32_t c = (valid && !kEdge) ? __ldcs(col + e) : 0;
  const int32_t r_prev = __shfl_up_sync(kFull, r, 1);
  const bool first = valid && (lane == 0 || r_prev != r);
  for (int h = 0; h < heads; ++h) {
    const int64_t ri = static_cast<int64_t>(r) * heads + h;
    float v;
    if (valid) {
      float a;
      if constexpr (kEdge) {
        a = __ldcs(es + static_cast<int64_t>(h) * nnz + e);
      } else {
        a = leaky(__ldg(s_dst + ri) + __ldg(s_src + static_cast<int64_t>(c) * heads + h), slope);
      }
      if constexpr (kPhase == 0) {
        v = a;
      } else {
        v = expf(a - __ldg(m + ri));
      }
    } else {
      v = kPhase == 0 ? __int_as_float(static_cast<int>(0xff800000u)) : 0.f;  // -inf, 0
    }
    // lane L gathers the lanes after it that hold its row (a row's lanes are
    // consecutive), so a run's first lane ends with the run's whole result
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v2 = __shfl_down_sync(kFull, v, o);
      const int32_t r2 = __shfl_down_sync(kFull, r, o);
      if (lane + o < 32 && r2 == r) {
        if constexpr (kPhase == 0) {
          v = fmaxf(v, v2);
        } else {
          v += v2;
        }
      }
    }
    if (first) {
      if constexpr (kPhase == 0) {
        atomic_max_f32(m + ri, v);
      } else {
        atomicAdd(l + ri, v);
      }
    }
  }
}

// The lane's floats of one head's tile of row `xr` (a pointer to x[row, h, 0]):
// features 4 * (kG * p + gl) + q (vector) or gl + kG * k (scalar) of the nf.
template <int kG, bool kVec, int kQuads>
__device__ __forceinline__ void load_tile(const float* __restrict__ xr, int gl, int nf,
                                          bool valid, float (&g)[4 * kQuads]) {
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
    for (int k = 0; k < 4 * kQuads; ++k) {
      const int i = gl + kG * k;
      g[k] = (valid && i < nf) ? __ldg(xr + i) : 0.f;
    }
  }
}

// out_row[...] += acc, the lane's share of the tile, by atomics.
template <int kG, bool kVec, int kQuads>
__device__ __forceinline__ void add_tile(float* __restrict__ out_row, int gl, int nf,
                                         const float (&acc)[4 * kQuads]) {
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
    for (int k = 0; k < 4 * kQuads; ++k) {
      const int i = gl + kG * k;
      if (i < nf) atomicAdd(out_row + i, acc[k]);
    }
  }
}

// The segment of a group: its first entry and its length (0 past the last).
__device__ __forceinline__ int segment_length(int64_t e0, int64_t nnz) {
  return static_cast<int>(e0 < nnz ? (nnz - e0 < kSeg ? nnz - e0 : kSeg) : 0);
}

// out[i, h, :] += w[e, h] * z[j, h, :] over the entries; out holds 0 on entry. w
// is alpha, alpha~ or the given weight (kMode). A group of kG lanes sums one
// segment of kSeg entries for head blockIdx.y.
template <int kG, bool kVec, int kQuads, int kMode>
__global__ void __launch_bounds__(kThreads)
gat_aggregate_kernel(const int32_t* __restrict__ row, const int32_t* __restrict__ col,
                     const float* __restrict__ s_src, const float* __restrict__ s_dst,
                     const float* __restrict__ m, const float* __restrict__ l,
                     const float* __restrict__ z, float* __restrict__ out, int64_t nnz,
                     int heads, int c_head, float slope, int64_t segments, EdgeOps ops) {
  constexpr int kLane = 4 * kQuads;
  constexpr int kR = 32 / kG;  // groups of a warp
  const int lane = threadIdx.x & 31;
  const int gl = lane % kG;
  const int base = lane - gl;
  const int h = blockIdx.y;
  const int64_t seg0 = (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * kR;
  if (seg0 >= segments) return;  // uniform across the warp
  const int64_t e0 = (seg0 + lane / kG) * kSeg;
  const int len = segment_length(e0, nnz);
  const int most = __reduce_max_sync(kFull, len);
  const int64_t stride = static_cast<int64_t>(heads) * c_head;  // a row of z and out
  const float* zh = z + static_cast<int64_t>(h) * c_head;
  float* oh = out + static_cast<int64_t>(h) * c_head;

  float acc[kLane];
#pragma unroll
  for (int k = 0; k < kLane; ++k) acc[k] = 0.f;
  int cur = -1;  // the row of the run being summed

  // this lane's entry of the group's next kG, and its weight, one round ahead
  int32_t r_next = 0, c_next = 0;
  float w_next = 0.f;
  auto fetch = [&](int64_t e) {
    r_next = __ldcs(row + e);
    c_next = __ldcs(col + e);
    const int64_t ri = static_cast<int64_t>(r_next) * heads + h;
    if constexpr (kMode == kEdgeWeights) {
      w_next = __ldg(ops.es + edge_index(ops, e, h, nnz));
    } else if constexpr (kMode == kEdgeScores) {
      const int64_t x = edge_index(ops, e, h, nnz);
      w_next = expf(__ldg(ops.es + x) - __ldg(m + ri)) / __ldg(l + ri) * kept(ops, x);
    } else {
      const float a = leaky(__ldg(s_dst + ri) + __ldg(s_src + static_cast<int64_t>(c_next) * heads + h),
                            slope);
      w_next = expf(a - __ldg(m + ri)) / __ldg(l + ri);
      if constexpr (kMode == kNodeMasked) w_next *= kept(ops, edge_index(ops, e, h, nnz));
    }
  };
  if (gl < len) fetch(e0 + gl);
  for (int c0 = 0; c0 < most; c0 += kG) {
    const int n = min(kG, len - c0);  // the group's entries this round; <= 0 past its end
    const int32_t r = r_next, c = c_next;
    const float w = w_next;
    if (c0 + kG + gl < len) fetch(e0 + c0 + kG + gl);
    const int steps = min(kG, most - c0);  // uniform across the warp
    for (int j0 = 0; j0 < steps; j0 += kBatch) {
      float g[kBatch][kLane];
      float wj[kBatch];
      int32_t rj[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int src = base + ((j0 + j) & (kG - 1));
        const int32_t cj = __shfl_sync(kFull, c, src);
        wj[j] = __shfl_sync(kFull, w, src);
        rj[j] = __shfl_sync(kFull, r, src);
        load_tile<kG, kVec, kQuads>(zh + static_cast<int64_t>(cj) * stride, gl, c_head,
                                    j0 + j < n, g[j]);
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (j0 + j < n) {  // uniform across the group
          if (rj[j] != cur) {
            if (cur >= 0) {
              add_tile<kG, kVec, kQuads>(oh + static_cast<int64_t>(cur) * stride, gl, c_head, acc);
            }
            cur = rj[j];
#pragma unroll
            for (int k = 0; k < kLane; ++k) acc[k] = 0.f;
          }
#pragma unroll
          for (int k = 0; k < kLane; ++k) acc[k] = fmaf(wj[j], g[j][k], acc[k]);
        }
      }
    }
  }
  if (cur >= 0) add_tile<kG, kVec, kQuads>(oh + static_cast<int64_t>(cur) * stride, gl, c_head, acc);
}

// delta[i, h] = <g[i, h, :], out[i, h, :]>; q[i, h] = (s_dst, m, l, delta), s_dst 0
// where it is null (per-edge scores). One warp a row, the heads in turn.
__global__ void __launch_bounds__(kThreads)
gat_rowdot_kernel(const float* __restrict__ g, const float* __restrict__ out,
                  const float* __restrict__ s_dst, const float* __restrict__ m,
                  const float* __restrict__ l, float4* __restrict__ q, int64_t n_rows,
                  int heads, int c_head) {
  const int lane = threadIdx.x & 31;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (i >= n_rows) return;  // uniform across the warp
  const int64_t stride = static_cast<int64_t>(heads) * c_head;
  for (int h = 0; h < heads; ++h) {
    const float* gr = g + i * stride + static_cast<int64_t>(h) * c_head;
    const float* orow = out + i * stride + static_cast<int64_t>(h) * c_head;
    float d = 0.f;
    for (int k = lane; k < c_head; k += 32) d = fmaf(__ldcs(gr + k), __ldcs(orow + k), d);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(kFull, d, o);
    if (lane == 0) {
      const int64_t ri = i * heads + h;
      q[ri] = make_float4(s_dst != nullptr ? __ldg(s_dst + ri) : 0.f, __ldg(m + ri),
                          __ldg(l + ri), d);
    }
  }
}

// The backward pass over the transposed listing (t_row = source j, t_col =
// destination i, sorted by j), head blockIdx.y: dz[j] += w * g[i] (w alpha, or
// alpha~ where weights are dropped) and dpre = alpha' * (k * dalpha - delta[i, h])
// (k the mask's factor, 1 without one; alpha' alpha times the LeakyReLU's slope at
// pre for node scores, alpha for per-edge ones). Node scores: ds_src[j] += dpre,
// ds_dst[i] += dpre; per-edge scores: ds_out[h, e] = ds_scale * dpre at the entry's
// place e in the row listing. dz, ds_src and ds_dst hold 0 on entry.
template <int kG, bool kVec, int kQuads, int kMode>
__global__ void __launch_bounds__(kThreads)
gat_backward_kernel(const int32_t* __restrict__ t_row, const int32_t* __restrict__ t_col,
                    const float* __restrict__ s_src, const float4* __restrict__ q,
                    const float* __restrict__ z, const float* __restrict__ g,
                    float* __restrict__ dz, float* __restrict__ ds_src,
                    float* __restrict__ ds_dst, int64_t nnz, int heads, int c_head, float slope,
                    int64_t segments, EdgeOps ops, float* __restrict__ ds_out, float ds_scale) {
  constexpr int kLane = 4 * kQuads;
  constexpr int kR = 32 / kG;
  constexpr bool kMasked = kMode != kNodeScores;  // the factor k is read
  constexpr bool kEdge = kMode == kEdgeScores;
  const int lane = threadIdx.x & 31;
  const int gl = lane % kG;
  const int base = lane - gl;
  const int h = blockIdx.y;
  const int64_t seg0 = (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * kR;
  if (seg0 >= segments) return;  // uniform across the warp
  const int64_t e0 = (seg0 + lane / kG) * kSeg;
  const int len = segment_length(e0, nnz);
  const int most = __reduce_max_sync(kFull, len);
  const int64_t stride = static_cast<int64_t>(heads) * c_head;
  const float* zh = z + static_cast<int64_t>(h) * c_head;
  const float* gh = g + static_cast<int64_t>(h) * c_head;
  float* dzh = dz + static_cast<int64_t>(h) * c_head;

  float acc[kLane];  // the run's dz
  float zr[kLane];   // the run's z[j, h, :]
#pragma unroll
  for (int k = 0; k < kLane; ++k) acc[k] = zr[k] = 0.f;
  float ds = 0.f;    // the run's ds_src
  int cur = -1;

  // this lane's entry of the group's next kG: source j, destination i, dz's weight,
  // dpre's factor alpha', delta[i, h], the mask's factor and (per-edge) ds's index
  int32_t j_next = 0, i_next = 0;
  float w_next = 0.f, ws_next = 0.f, d_next = 0.f, k_next = 1.f;
  int64_t x_next = 0;
  auto fetch = [&](int64_t e) {
    j_next = __ldcs(t_row + e);
    i_next = __ldcs(t_col + e);
    const float4 qi = __ldg(q + static_cast<int64_t>(i_next) * heads + h);
    if constexpr (kEdge) {
      x_next = edge_index(ops, e, h, nnz);
      ws_next = expf(__ldg(ops.es + x_next) - qi.y) / qi.z;
      k_next = kept(ops, x_next);
      w_next = ws_next * k_next;
    } else {
      const float p = qi.x + __ldg(s_src + static_cast<int64_t>(j_next) * heads + h);
      w_next = expf(leaky(p, slope) - qi.y) / qi.z;
      ws_next = p > 0.f ? w_next : w_next * slope;
      if constexpr (kMasked) {
        k_next = kept(ops, edge_index(ops, e, h, nnz));
        w_next *= k_next;
      }
    }
    d_next = qi.w;
  };
  if (gl < len) fetch(e0 + gl);
  for (int c0 = 0; c0 < most; c0 += kG) {
    const int n = min(kG, len - c0);
    const int32_t jr = j_next, ir = i_next;
    const float w = w_next, ws = ws_next, dl = d_next, kf = k_next;
    const int64_t xr = x_next;
    if (c0 + kG + gl < len) fetch(e0 + c0 + kG + gl);
    const int steps = min(kG, most - c0);  // uniform across the warp
    for (int j0 = 0; j0 < steps; j0 += kBatch) {
      float gi[kBatch][kLane];
      float wj[kBatch], wsj[kBatch], dj[kBatch], kj[kBatch];
      int32_t rj[kBatch], ij[kBatch];
      int64_t xj[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int src = base + ((j0 + b) & (kG - 1));
        ij[b] = __shfl_sync(kFull, ir, src);
        rj[b] = __shfl_sync(kFull, jr, src);
        wj[b] = __shfl_sync(kFull, w, src);
        wsj[b] = __shfl_sync(kFull, ws, src);
        dj[b] = __shfl_sync(kFull, dl, src);
        if constexpr (kMasked) kj[b] = __shfl_sync(kFull, kf, src);
        if constexpr (kEdge) xj[b] = __shfl_sync(kFull, xr, src);
        load_tile<kG, kVec, kQuads>(gh + static_cast<int64_t>(ij[b]) * stride, gl, c_head,
                                    j0 + b < n, gi[b]);
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const bool valid = j0 + b < n;  // uniform across the group
        if (valid && rj[b] != cur) {
          if (cur >= 0) {
            add_tile<kG, kVec, kQuads>(dzh + static_cast<int64_t>(cur) * stride, gl, c_head, acc);
            if (!kEdge && gl == 0) atomicAdd(ds_src + static_cast<int64_t>(cur) * heads + h, ds);
          }
          cur = rj[b];
          load_tile<kG, kVec, kQuads>(zh + static_cast<int64_t>(cur) * stride, gl, c_head, true,
                                      zr);
#pragma unroll
          for (int k = 0; k < kLane; ++k) acc[k] = 0.f;
          ds = 0.f;
        }
        // dalpha = <g[i, h, :], z[j, h, :]>, summed over the group's lanes (every
        // lane of the warp takes part; a group past its entries sums zeros)
        float da = 0.f;
#pragma unroll
        for (int k = 0; k < kLane; ++k) da = fmaf(gi[b][k], zr[k], da);
#pragma unroll
        for (int o = kG / 2; o > 0; o >>= 1) da += __shfl_xor_sync(kFull, da, o);
        if (valid) {
          float dpre;
          if constexpr (kMasked) {
            dpre = wsj[b] * (kj[b] * da - dj[b]);
          } else {
            dpre = wsj[b] * (da - dj[b]);
          }
#pragma unroll
          for (int k = 0; k < kLane; ++k) acc[k] = fmaf(wj[b], gi[b][k], acc[k]);
          if constexpr (kEdge) {
            if (gl == 0) ds_out[xj[b]] = ds_scale * dpre;
          } else {
            ds += dpre;
            if (gl == 0) atomicAdd(ds_dst + static_cast<int64_t>(ij[b]) * heads + h, dpre);
          }
        }
      }
    }
  }
  if (cur >= 0) {
    add_tile<kG, kVec, kQuads>(dzh + static_cast<int64_t>(cur) * stride, gl, c_head, acc);
    if (!kEdge && gl == 0) atomicAdd(ds_src + static_cast<int64_t>(cur) * heads + h, ds);
  }
}

// s[h, e] = scale * <q[i, h, :], k[j, h, :]> over the row listing (i = row, j =
// col), head blockIdx.y: a group of kG lanes a segment, q[i] of the run's row kept
// in its lanes, k[j] gathered, each entry's product summed over the group's lanes.
template <int kG, bool kVec, int kQuads>
__global__ void __launch_bounds__(kThreads)
sddmm_kernel(const int32_t* __restrict__ row, const int32_t* __restrict__ col,
             const float* __restrict__ q, const float* __restrict__ k, float* __restrict__ s,
             int64_t nnz, int heads, int c_head, float scale, int64_t segments) {
  constexpr int kLane = 4 * kQuads;
  constexpr int kR = 32 / kG;
  const int lane = threadIdx.x & 31;
  const int gl = lane % kG;
  const int base = lane - gl;
  const int h = blockIdx.y;
  const int64_t seg0 = (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * kR;
  if (seg0 >= segments) return;  // uniform across the warp
  const int64_t e0 = (seg0 + lane / kG) * kSeg;
  const int len = segment_length(e0, nnz);
  const int most = __reduce_max_sync(kFull, len);
  const int64_t stride = static_cast<int64_t>(heads) * c_head;
  const float* qh = q + static_cast<int64_t>(h) * c_head;
  const float* kh = k + static_cast<int64_t>(h) * c_head;
  float* sh = s + static_cast<int64_t>(h) * nnz;

  float qr[kLane];  // the run's q[i, h, :]
#pragma unroll
  for (int t = 0; t < kLane; ++t) qr[t] = 0.f;
  int cur = -1;
  int32_t r_next = 0, c_next = 0;  // this lane's entry of the group's next kG
  auto fetch = [&](int64_t e) {
    r_next = __ldcs(row + e);
    c_next = __ldcs(col + e);
  };
  if (gl < len) fetch(e0 + gl);
  for (int c0 = 0; c0 < most; c0 += kG) {
    const int n = min(kG, len - c0);
    const int32_t r = r_next, c = c_next;
    if (c0 + kG + gl < len) fetch(e0 + c0 + kG + gl);
    const int steps = min(kG, most - c0);  // uniform across the warp
    for (int j0 = 0; j0 < steps; j0 += kBatch) {
      float kj[kBatch][kLane];
      int32_t rj[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int src = base + ((j0 + b) & (kG - 1));
        const int32_t cj = __shfl_sync(kFull, c, src);
        rj[b] = __shfl_sync(kFull, r, src);
        load_tile<kG, kVec, kQuads>(kh + static_cast<int64_t>(cj) * stride, gl, c_head,
                                    j0 + b < n, kj[b]);
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const bool valid = j0 + b < n;  // uniform across the group
        if (valid && rj[b] != cur) {
          cur = rj[b];
          load_tile<kG, kVec, kQuads>(qh + static_cast<int64_t>(cur) * stride, gl, c_head, true,
                                      qr);
        }
        float d = 0.f;
#pragma unroll
        for (int t = 0; t < kLane; ++t) d = fmaf(kj[b][t], qr[t], d);
#pragma unroll
        for (int o = kG / 2; o > 0; o >>= 1) d += __shfl_xor_sync(kFull, d, o);
        if (valid && gl == 0) __stcs(sh + e0 + c0 + j0 + b, scale * d);
      }
    }
  }
}

// -- the whole-row path ------------------------------------------------------

// The head of each of the lane's floats of a row laid out as load_tile's
// float4 lanes lay it out (0 past the row's row_floats).
template <int kG, int kQuads>
__device__ __forceinline__ void row_heads(int gl, int row_floats, int c_head,
                                          int (&hd)[4 * kQuads]) {
#pragma unroll
  for (int p = 0; p < kQuads; ++p) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int k = 4 * (kG * p + gl) + t;
      hd[4 * p + t] = k < row_floats ? k / c_head : 0;
    }
  }
}

// part[h], h < kH: the lane's share of a sum of each head. Returns the group's
// sum of head gl % kH. Each step halves the heads a lane holds: it keeps the
// half its lane bit selects and adds its partner's share of that half; then the
// kG / kH lanes that hold one head add theirs.
template <int kG, int kH>
__device__ __forceinline__ float group_head_sum(float (&part)[kH], int gl) {
#pragma unroll
  for (int n = kH / 2; n >= 1; n >>= 1) {
    const bool upper = (gl & n) != 0;
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const float send = upper ? part[i] : part[i + n];
      const float keep = upper ? part[i + n] : part[i];
      part[i] = keep + __shfl_xor_sync(kFull, send, n);
    }
  }
  float v = part[0];
#pragma unroll
  for (int o = kH; o < kG; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The blocks an SM must hold of a whole-row instance: kRowBlocks (its registers
// capped at 65536 / (kRowBlocks kThreads)) where a lane's rows of a batch and
// copies of z (4 kQuads (kRowBatch + kH) floats) fit in kRowLaneFloats, as the GAT
// cell's (4 heads of 47, 2 float4s a lane) do; above, the compiler's choice (1).
template <int kQuads, int kH>
constexpr int row_blocks() {
  return 4 * kQuads * (kRowBatch + kH) <= kRowLaneFloats ? kRowBlocks : 1;
}

// The whole-row layout of a group: kS slots of kH lanes fetch a round's
// kRowBatch entries, lane kH s + h head h's values of entries s, s + kS, ...
template <int kG, int kH>
struct RowRound {
  static constexpr int kS = kG / kH < kRowBatch ? kG / kH : kRowBatch;  // slots that fetch
  static constexpr int kU = kRowBatch / kS;                              // entries a lane fetches
};

// out[i, :] += alpha[e, h(f)] * z[j, :] over the entries, every head of a row at
// once; out holds 0 on entry. A group of kG lanes sums one segment of kSeg
// entries; float f of a row takes the weight of its head h(f).
template <typename Path, int kG, int kQuads, int kH>
__global__ void __launch_bounds__(kThreads, (row_blocks<kQuads, kH>()))
gat_aggregate_kernel(const int32_t* __restrict__ row, const int32_t* __restrict__ col,
                     const float* __restrict__ s_src, const float* __restrict__ s_dst,
                     const float* __restrict__ m, const float* __restrict__ l,
                     const float* __restrict__ z, float* __restrict__ out, int64_t nnz,
                     int heads, int c_head, float slope, int64_t segments) {
  constexpr int kLane = 4 * kQuads;
  constexpr int kR = 32 / kG;
  constexpr int kS = RowRound<kG, kH>::kS, kU = RowRound<kG, kH>::kU;
  const int lane = threadIdx.x & 31;
  const int gl = lane % kG;
  const int base = lane - gl;
  const int slot = gl / kH, h = gl % kH;
  const bool fetcher = slot < kS && h < heads;
  const int64_t seg0 = (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * kR;
  if (seg0 >= segments) return;  // uniform across the warp
  const int64_t e0 = (seg0 + lane / kG) * kSeg;
  const int len = segment_length(e0, nnz);
  const int most = __reduce_max_sync(kFull, len);
  const int stride = heads * c_head;  // a row of z and out, whole float4s
  int hd[kLane];
  row_heads<kG, kQuads>(gl, stride, c_head, hd);

  float acc[kLane];
#pragma unroll
  for (int k = 0; k < kLane; ++k) acc[k] = 0.f;
  int cur = -1;  // the row of the run being summed

  // this lane's entries of the group's next round, and head h's weights
  int32_t r_next[kU], c_next[kU];
  float w_next[kU];
  auto fetch = [&](int c0) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int b = c0 + u * kS + slot;
      r_next[u] = c_next[u] = 0;
      w_next[u] = 0.f;
      if (fetcher && b < len) {
        r_next[u] = __ldcs(row + e0 + b);
        c_next[u] = __ldcs(col + e0 + b);
        const int64_t ri = static_cast<int64_t>(r_next[u]) * heads + h;
        const float a = leaky(
            __ldg(s_dst + ri) + __ldg(s_src + static_cast<int64_t>(c_next[u]) * heads + h), slope);
        w_next[u] = expf(a - __ldg(m + ri)) / __ldg(l + ri);
      }
    }
  };
  fetch(0);
  for (int c0 = 0; c0 < most; c0 += kRowBatch) {
    const int n = len - c0;  // the group's entries left; <= 0 past its end
    int32_t r[kU], c[kU];
    float w[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      r[u] = r_next[u];
      c[u] = c_next[u];
      w[u] = w_next[u];
    }
    fetch(c0 + kRowBatch);
    float g[kRowBatch][kLane];
    int32_t rj[kRowBatch];
#pragma unroll
    for (int b = 0; b < kRowBatch; ++b) {
      const int src = base + (b % kS) * kH;
      const int32_t cj = __shfl_sync(kFull, c[b / kS], src);
      rj[b] = __shfl_sync(kFull, r[b / kS], src);
      load_tile<kG, true, kQuads>(z + static_cast<int64_t>(cj) * stride, gl, stride, b < n, g[b]);
    }
#pragma unroll
    for (int b = 0; b < kRowBatch; ++b) {
      const int src = base + (b % kS) * kH;
      float wf[kLane];
#pragma unroll
      for (int k = 0; k < kLane; ++k) wf[k] = __shfl_sync(kFull, w[b / kS], src + hd[k]);
      if (b < n) {  // uniform across the group
        if (rj[b] != cur) {
          if (cur >= 0) {
            add_tile<kG, true, kQuads>(out + static_cast<int64_t>(cur) * stride, gl, stride, acc);
          }
          cur = rj[b];
#pragma unroll
          for (int k = 0; k < kLane; ++k) acc[k] = 0.f;
        }
#pragma unroll
        for (int k = 0; k < kLane; ++k) acc[k] = fmaf(wf[k], g[b][k], acc[k]);
      }
    }
  }
  if (cur >= 0) {
    add_tile<kG, true, kQuads>(out + static_cast<int64_t>(cur) * stride, gl, stride, acc);
  }
}

// The backward pass over the transposed listing, every head of a row at once:
// dz[j] += alpha * g[i], ds_src[j] += dpre, ds_dst[i] += dpre. dz, ds_src and
// ds_dst hold 0 on entry.
template <typename Path, int kG, int kQuads, int kH>
__global__ void __launch_bounds__(kThreads, (row_blocks<kQuads, kH>()))
gat_backward_kernel(const int32_t* __restrict__ t_row, const int32_t* __restrict__ t_col,
                    const float* __restrict__ s_src, const float4* __restrict__ q,
                    const float* __restrict__ z, const float* __restrict__ g,
                    float* __restrict__ dz, float* __restrict__ ds_src,
                    float* __restrict__ ds_dst, int64_t nnz, int heads, int c_head, float slope,
                    int64_t segments) {
  constexpr int kLane = 4 * kQuads;
  constexpr int kR = 32 / kG;
  constexpr int kS = RowRound<kG, kH>::kS, kU = RowRound<kG, kH>::kU;
  const int lane = threadIdx.x & 31;
  const int gl = lane % kG;
  const int base = lane - gl;
  const int slot = gl / kH, h = gl % kH;
  const bool fetcher = slot < kS && h < heads;
  const int64_t seg0 = (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * kR;
  if (seg0 >= segments) return;  // uniform across the warp
  const int64_t e0 = (seg0 + lane / kG) * kSeg;
  const int len = segment_length(e0, nnz);
  const int most = __reduce_max_sync(kFull, len);
  const int stride = heads * c_head;
  int hd[kLane];
  row_heads<kG, kQuads>(gl, stride, c_head, hd);

  float acc[kLane];     // the run's dz
  float zh[kH][kLane];  // the run's z[j], each head's floats alone (0 elsewhere)
#pragma unroll
  for (int k = 0; k < kLane; ++k) {
    acc[k] = 0.f;
#pragma unroll
    for (int x = 0; x < kH; ++x) zh[x][k] = 0.f;
  }
  float ds = 0.f;  // the run's ds_src[j, h], kept by the lanes of slot 0
  int cur = -1;

  // this lane's entries of the group's next round: source j, destination i, and
  // head h's alpha, alpha times the LeakyReLU's slope at pre, and delta[i, h]
  int32_t j_next[kU], i_next[kU];
  float w_next[kU], ws_next[kU], d_next[kU];
  auto fetch = [&](int c0) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int b = c0 + u * kS + slot;
      j_next[u] = i_next[u] = 0;
      w_next[u] = ws_next[u] = d_next[u] = 0.f;
      if (fetcher && b < len) {
        j_next[u] = __ldcs(t_row + e0 + b);
        i_next[u] = __ldcs(t_col + e0 + b);
        const float4 qi = __ldg(q + static_cast<int64_t>(i_next[u]) * heads + h);
        const float p = qi.x + __ldg(s_src + static_cast<int64_t>(j_next[u]) * heads + h);
        w_next[u] = expf(leaky(p, slope) - qi.y) / qi.z;
        ws_next[u] = p > 0.f ? w_next[u] : w_next[u] * slope;
        d_next[u] = qi.w;
      }
    }
  };
  fetch(0);
  for (int c0 = 0; c0 < most; c0 += kRowBatch) {
    const int n = len - c0;
    int32_t jr[kU], ir[kU];
    float w[kU], ws[kU], dl[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      jr[u] = j_next[u];
      ir[u] = i_next[u];
      w[u] = w_next[u];
      ws[u] = ws_next[u];
      dl[u] = d_next[u];
    }
    fetch(c0 + kRowBatch);
    float gi[kRowBatch][kLane];
    int32_t rj[kRowBatch];
#pragma unroll
    for (int b = 0; b < kRowBatch; ++b) {
      const int src = base + (b % kS) * kH;
      const int32_t ij = __shfl_sync(kFull, ir[b / kS], src);
      rj[b] = __shfl_sync(kFull, jr[b / kS], src);
      load_tile<kG, true, kQuads>(g + static_cast<int64_t>(ij) * stride, gl, stride, b < n, gi[b]);
    }
#pragma unroll
    for (int b = 0; b < kRowBatch; ++b) {
      const int s = b % kS, u = b / kS;
      const int src = base + s * kH;
      const bool valid = b < n;  // uniform across the group
      float wf[kLane];
#pragma unroll
      for (int k = 0; k < kLane; ++k) wf[k] = __shfl_sync(kFull, w[u], src + hd[k]);
      if (valid && rj[b] != cur) {
        if (cur >= 0) {
          add_tile<kG, true, kQuads>(dz + static_cast<int64_t>(cur) * stride, gl, stride, acc);
          if (gl < heads) atomicAdd(ds_src + static_cast<int64_t>(cur) * heads + gl, ds);
        }
        cur = rj[b];
        float zr[kLane];
        load_tile<kG, true, kQuads>(z + static_cast<int64_t>(cur) * stride, gl, stride, true, zr);
#pragma unroll
        for (int k = 0; k < kLane; ++k) {
          acc[k] = 0.f;
#pragma unroll
          for (int x = 0; x < kH; ++x) zh[x][k] = hd[k] == x ? zr[k] : 0.f;
        }
        ds = 0.f;
      }
      // dalpha = <g[i, h, :], z[j, h, :]> of each head, summed over the group's
      // lanes (every lane of the warp takes part; a group past its entries sums
      // zeros); lane kH s + h holds the entry's values of head h
      float part[kH];
#pragma unroll
      for (int x = 0; x < kH; ++x) {
        part[x] = 0.f;
#pragma unroll
        for (int k = 0; k < kLane; ++k) part[x] = fmaf(gi[b][k], zh[x][k], part[x]);
      }
      const float da = group_head_sum<kG, kH>(part, gl);
      const float dpre = ws[u] * (da - dl[u]);
      const float dp = __shfl_sync(kFull, dpre, src + h);  // the entry's dpre of head h
      if (valid) {
        if (slot == s && h < heads) {
          atomicAdd(ds_dst + static_cast<int64_t>(ir[u]) * heads + h, dpre);
        }
        if (slot == 0) ds += dp;
#pragma unroll
        for (int k = 0; k < kLane; ++k) acc[k] = fmaf(wf[k], gi[b][k], acc[k]);
      }
    }
  }
  if (cur >= 0) {
    add_tile<kG, true, kQuads>(dz + static_cast<int64_t>(cur) * stride, gl, stride, acc);
    if (gl < heads) atomicAdd(ds_src + static_cast<int64_t>(cur) * heads + gl, ds);
  }
}

// The grid of a segmented kernel: blocks over the segments, the heads on y.
inline bool segment_grid(int64_t nnz, int kg, int heads, dim3& grid, int64_t& segments) {
  segments = (nnz + kSeg - 1) / kSeg;
  const int64_t per_block = static_cast<int64_t>(kWarps) * (32 / kg);
  const int64_t blocks = (segments + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL || heads > 65535) return false;
  grid = dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(heads));
  return true;
}

template <int kG, int kQuads, int kMode>
int launch_aggregate(const int32_t* row, const int32_t* col, const float* s_src,
                     const float* s_dst, const float* m, const float* l, const float* z,
                     float* out, int64_t nnz, int heads, int c_head, float slope, bool vec4,
                     EdgeOps ops, cudaStream_t stream) {
  dim3 grid;
  int64_t segments;
  if (!segment_grid(nnz, kG, heads, grid, segments)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (vec4) {
    gat_aggregate_kernel<kG, true, kQuads, kMode><<<grid, kThreads, 0, stream>>>(
        row, col, s_src, s_dst, m, l, z, out, nnz, heads, c_head, slope, segments, ops);
  } else {
    gat_aggregate_kernel<kG, false, kQuads, kMode><<<grid, kThreads, 0, stream>>>(
        row, col, s_src, s_dst, m, l, z, out, nnz, heads, c_head, slope, segments, ops);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int kG, int kQuads, int kMode>
int launch_backward(const int32_t* t_row, const int32_t* t_col, const float* s_src,
                    const float4* q, const float* z, const float* g, float* dz, float* ds_src,
                    float* ds_dst, int64_t nnz, int heads, int c_head, float slope, bool vec4,
                    EdgeOps ops, float* ds_out, float ds_scale, cudaStream_t stream) {
  dim3 grid;
  int64_t segments;
  if (!segment_grid(nnz, kG, heads, grid, segments)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (vec4) {
    gat_backward_kernel<kG, true, kQuads, kMode><<<grid, kThreads, 0, stream>>>(
        t_row, t_col, s_src, q, z, g, dz, ds_src, ds_dst, nnz, heads, c_head, slope, segments,
        ops, ds_out, ds_scale);
  } else {
    gat_backward_kernel<kG, false, kQuads, kMode><<<grid, kThreads, 0, stream>>>(
        t_row, t_col, s_src, q, z, g, dz, ds_src, ds_dst, nnz, heads, c_head, slope, segments,
        ops, ds_out, ds_scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int kG, int kQuads>
int launch_sddmm(const int32_t* row, const int32_t* col, const float* q, const float* k,
                 float* s, int64_t nnz, int heads, int c_head, float scale, bool vec4,
                 cudaStream_t stream) {
  dim3 grid;
  int64_t segments;
  if (!segment_grid(nnz, kG, heads, grid, segments)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  if (vec4) {
    sddmm_kernel<kG, true, kQuads><<<grid, kThreads, 0, stream>>>(
        row, col, q, k, s, nnz, heads, c_head, scale, segments);
  } else {
    sddmm_kernel<kG, false, kQuads><<<grid, kThreads, 0, stream>>>(
        row, col, q, k, s, nnz, heads, c_head, scale, segments);
  }
  return static_cast<int>(cudaGetLastError());
}

// The per-head instance for a head of c_head features (at most 512): groups of
// 8, 16 or 32 lanes, 4 kQuads floats a lane; Launch<kG, kQuads>::run(args...).
template <template <int, int> class Launch, typename... Args>
int dispatch_head(int c_head, Args... args) {
  if (c_head <= 32) return Launch<8, 1>::run(args...);
  if (c_head <= 64) return Launch<16, 1>::run(args...);
  if (c_head <= 128) return Launch<32, 1>::run(args...);
  if (c_head <= 256) return Launch<32, 2>::run(args...);
  if (c_head <= 512) return Launch<32, 4>::run(args...);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int kMode>
struct HeadAggregate {
  template <int kG, int kQuads>
  struct At {
    template <typename... Args>
    static int run(Args... args) { return launch_aggregate<kG, kQuads, kMode>(args...); }
  };
};

template <int kMode>
struct HeadBackward {
  template <int kG, int kQuads>
  struct At {
    template <typename... Args>
    static int run(Args... args) { return launch_backward<kG, kQuads, kMode>(args...); }
  };
};

template <int kG, int kQuads>
struct HeadSddmm {
  template <typename... Args>
  static int run(Args... args) { return launch_sddmm<kG, kQuads>(args...); }
};

template <int kG, int kQuads, int kH>
struct RowAggregate {
  static int run(const int32_t* row, const int32_t* col, const float* s_src,
                 const float* s_dst, const float* m, const float* l, const float* z,
                 float* out, int64_t nnz, int heads, int c_head, float slope,
                 cudaStream_t stream) {
    dim3 grid;
    int64_t segments;
    if (!segment_grid(nnz, kG, 1, grid, segments)) {
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    gat_aggregate_kernel<WholeRow, kG, kQuads, kH><<<grid, kThreads, 0, stream>>>(
        row, col, s_src, s_dst, m, l, z, out, nnz, heads, c_head, slope, segments);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int kG, int kQuads, int kH>
struct RowBackward {
  static int run(const int32_t* t_row, const int32_t* t_col, const float* s_src,
                 const float4* q, const float* z, const float* g, float* dz, float* ds_src,
                 float* ds_dst, int64_t nnz, int heads, int c_head, float slope,
                 cudaStream_t stream) {
    dim3 grid;
    int64_t segments;
    if (!segment_grid(nnz, kG, 1, grid, segments)) {
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    gat_backward_kernel<WholeRow, kG, kQuads, kH><<<grid, kThreads, 0, stream>>>(
        t_row, t_col, s_src, q, z, g, dz, ds_src, ds_dst, nnz, heads, c_head, slope, segments);
    return static_cast<int>(cudaGetLastError());
  }
};

// The whole-row instance for a row of row4 float4s (at most 128): kRowG lanes
// of at most 4 float4s each, 32 lanes above; heads rounded up to 2, 4 or 8.
template <template <int, int, int> class Launch, int kH, typename... Args>
int dispatch_row_quads(int row4, Args... args) {
  if (row4 <= kRowG) return Launch<kRowG, 1, kH>::run(args...);
  if (row4 <= 2 * kRowG) return Launch<kRowG, 2, kH>::run(args...);
  if (row4 <= 3 * kRowG) return Launch<kRowG, 3, kH>::run(args...);
  if (row4 <= 4 * kRowG) return Launch<kRowG, 4, kH>::run(args...);
  return row4 <= 96 ? Launch<32, 3, kH>::run(args...) : Launch<32, 4, kH>::run(args...);
}

template <template <int, int, int> class Launch, typename... Args>
int dispatch_row(int heads, int row4, Args... args) {
  if (heads <= 2) return dispatch_row_quads<Launch, 2>(row4, args...);
  if (heads <= 4) return dispatch_row_quads<Launch, 4>(row4, args...);
  return dispatch_row_quads<Launch, 8>(row4, args...);
}

// The entries' layout argument.
constexpr int kLayoutScalar = 0, kLayoutVec4 = 1, kLayoutRow = 2;

// Whether the kernels take a layout for the shape: float4 lanes a head need
// heads of whole float4s, the whole row rows of whole float4s and at most
// kRowHeads heads.
inline bool layout_ok(int layout, int heads, int c_head) {
  if (layout == kLayoutVec4) return c_head % 4 == 0;
  if (layout == kLayoutRow) return heads <= kRowHeads && (heads * c_head) % 4 == 0;
  return layout == kLayoutScalar;
}

// -- the scores ------------------------------------------------------------

constexpr int kChunk = 512;  // floats of a warp's chunk of a row (16 a lane)

// Heads of a chunk: as many whole heads as kChunk floats and 32 lanes hold.
inline int chunk_heads(int heads, int c_head) {
  const int hp = kChunk / c_head < 32 ? kChunk / c_head : 32;
  return hp < heads ? hp : heads;
}

// Element j of a lane's kE in a chunk: float4 j / 4 of the lane is the chunk's
// float4 32 (j / 4) + lane (vector layout), or element lane + 32 j (scalar).
template <bool kVec>
__device__ __forceinline__ int chunk_index(int lane, int j) {
  return kVec ? 4 * (32 * (j >> 2) + lane) + (j & 3) : lane + 32 * j;
}

// The lane's elements of the chunk at x, 0 past its len floats.
template <int kE, bool kVec>
__device__ __forceinline__ void load_chunk(const float* __restrict__ x, int lane, int len,
                                           float (&v)[kE]) {
  if (kVec) {
#pragma unroll
    for (int p = 0; p < kE / 4; ++p) {
      const int i = 32 * p + lane;
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (4 * i < len) t = __ldcs(reinterpret_cast<const float4*>(x) + i);
      v[4 * p] = t.x; v[4 * p + 1] = t.y; v[4 * p + 2] = t.z; v[4 * p + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      const int k = lane + 32 * j;
      v[j] = k < len ? __ldcs(x + k) : 0.f;
    }
  }
}

template <int kE, bool kVec>
__device__ __forceinline__ void store_chunk(float* __restrict__ x, int lane, int len,
                                            const float (&v)[kE]) {
  if (kVec) {
#pragma unroll
    for (int p = 0; p < kE / 4; ++p) {
      const int i = 32 * p + lane;
      if (4 * i < len) {
        __stcs(reinterpret_cast<float4*>(x) + i,
               make_float4(v[4 * p], v[4 * p + 1], v[4 * p + 2], v[4 * p + 3]));
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      const int k = lane + 32 * j;
      if (k < len) __stcs(x + k, v[j]);
    }
  }
}

// The warp's chunk, heads [h0, h0 + hc) of every row: its floats' heads in the
// chunk (-1 past its end) and weights (0 past its end) for this lane.
struct Chunk {
  int h0, hc, len;
  int64_t stride, off;  // floats of a row; the chunk's first float in a row
};

__device__ __forceinline__ Chunk chunk_of(int heads, int c_head, int chunk_heads) {
  Chunk ch;
  ch.h0 = blockIdx.y * chunk_heads;
  ch.hc = min(chunk_heads, heads - ch.h0);
  ch.len = ch.hc * c_head;
  ch.stride = static_cast<int64_t>(heads) * c_head;
  ch.off = static_cast<int64_t>(ch.h0) * c_head;
  return ch;
}

template <int kE, bool kVec>
__device__ __forceinline__ void chunk_weights(const Chunk& ch, const float* __restrict__ a_src,
                                              const float* __restrict__ a_dst, int c_head,
                                              int lane, int (&hd)[kE], float (&ws)[kE],
                                              float (&wd)[kE]) {
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    const int k = chunk_index<kVec>(lane, j);
    const bool in = k < ch.len;
    hd[j] = in ? k / c_head : -1;
    ws[j] = in ? __ldg(a_src + ch.off + k) : 0.f;
    wd[j] = in ? __ldg(a_dst + ch.off + k) : 0.f;
  }
}

// s_src, s_dst [n_rows, heads] from z [n_rows, heads, c_head]; chunk blockIdx.y.
template <int kE, bool kVec>
__global__ void __launch_bounds__(kThreads)
gat_scores_kernel(const float* __restrict__ z, const float* __restrict__ a_src,
                  const float* __restrict__ a_dst, float* __restrict__ s_src,
                  float* __restrict__ s_dst, int64_t n_rows, int heads, int c_head,
                  int chunk_heads) {
  const int lane = threadIdx.x & 31;
  const Chunk ch = chunk_of(heads, c_head, chunk_heads);
  int hd[kE];
  float ws[kE], wd[kE];
  chunk_weights<kE, kVec>(ch, a_src, a_dst, c_head, lane, hd, ws, wd);
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5); i < n_rows;
       i += warps) {
    float v[kE];
    load_chunk<kE, kVec>(z + i * ch.stride + ch.off, lane, ch.len, v);
    float mine_s = 0.f, mine_d = 0.f;
    for (int h = 0; h < ch.hc; ++h) {  // uniform across the warp
      float s = 0.f, d = 0.f;
#pragma unroll
      for (int j = 0; j < kE; ++j) {
        if (hd[j] == h) {
          s = fmaf(v[j], ws[j], s);
          d = fmaf(v[j], wd[j], d);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s += __shfl_xor_sync(kFull, s, o);
        d += __shfl_xor_sync(kFull, d, o);
      }
      if (lane == h) {
        mine_s = s;
        mine_d = d;
      }
    }
    if (lane < ch.hc) {
      const int64_t si = i * heads + ch.h0 + lane;
      s_src[si] = mine_s;
      s_dst[si] = mine_d;
    }
  }
}

// dz [n_rows, heads, c_head] written, and the block's partial sums of da_src and
// da_dst into part[blockIdx.x, 0 or 1, :] (heads * c_head floats each) over the
// rows of its warps; chunk blockIdx.y.
template <int kE, bool kVec>
__global__ void __launch_bounds__(kThreads)
gat_score_grad_kernel(const float* __restrict__ z, const float* __restrict__ a_src,
                      const float* __restrict__ a_dst, const float* __restrict__ ds_src,
                      const float* __restrict__ ds_dst, float* __restrict__ dz,
                      float* __restrict__ part, int64_t n_rows, int heads, int c_head,
                      int chunk_heads) {
  __shared__ float sums[kWarps][2][32 * kE];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Chunk ch = chunk_of(heads, c_head, chunk_heads);
  int hd[kE];
  float ws[kE], wd[kE], gs[kE], gd[kE];
  chunk_weights<kE, kVec>(ch, a_src, a_dst, c_head, lane, hd, ws, wd);
#pragma unroll
  for (int j = 0; j < kE; ++j) gs[j] = gd[j] = 0.f;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kWarps + warp; i < n_rows; i += warps) {
    const int64_t si = i * heads + ch.h0 + lane;
    const float my_s = lane < ch.hc ? __ldcs(ds_src + si) : 0.f;
    const float my_d = lane < ch.hc ? __ldcs(ds_dst + si) : 0.f;
    float v[kE];
    load_chunk<kE, kVec>(z + i * ch.stride + ch.off, lane, ch.len, v);
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      // past the chunk's end hd is -1: lane 31's values, times weights and z of 0
      const float s = __shfl_sync(kFull, my_s, hd[j] & 31);
      const float d = __shfl_sync(kFull, my_d, hd[j] & 31);
      gs[j] = fmaf(s, v[j], gs[j]);
      gd[j] = fmaf(d, v[j], gd[j]);
      v[j] = fmaf(s, ws[j], d * wd[j]);
    }
    store_chunk<kE, kVec>(dz + i * ch.stride + ch.off, lane, ch.len, v);
  }
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    const int k = chunk_index<kVec>(lane, j);
    sums[warp][0][k] = gs[j];
    sums[warp][1][k] = gd[j];
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 2 * ch.len; t += kThreads) {
    const int which = t < ch.len ? 0 : 1;
    const int k = t - which * ch.len;
    float acc = sums[0][which][k];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) acc += sums[w][which][k];
    part[(2 * static_cast<int64_t>(blockIdx.x) + which) * ch.stride + ch.off + k] = acc;
  }
}

// da_src and da_dst (width floats each) from the blocks' partial rows part
// [blocks, 2, width], in block order: warp w of a block sums the blocks w, w +
// kWarps, ... of 32 of the 2 * width sums, then the block adds its warps' in
// warp order.
__global__ void __launch_bounds__(kThreads)
gat_score_sum_kernel(const float* __restrict__ part, float* __restrict__ da_src,
                     float* __restrict__ da_dst, int blocks, int64_t width) {
  __shared__ float sums[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * 32 + lane;
  const bool valid = t < 2 * width;
  float acc = 0.f;
  if (valid) {
#pragma unroll 8
    for (int b = warp; b < blocks; b += kWarps) acc += __ldcs(part + 2 * width * b + t);
  }
  sums[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && valid) {
#pragma unroll
    for (int w = 1; w < kWarps; ++w) acc += sums[w][lane];
    if (t < width) {
      da_src[t] = acc;
    } else {
      da_dst[t - width] = acc;
    }
  }
}

// The blocks of a score kernel's grid: as many as stay resident on the device
// at once (the warps stride over the rows; blocks beyond that would run in a
// second, thinner wave), at most one warp a row and at most cap.
template <typename Kernel>
int resident_blocks(Kernel kernel, int64_t n_rows, int64_t cap, int& blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err == 0) err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (err == 0) {
    err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                                         kThreads, 0));
  }
  if (err != 0) return err;
  int64_t b = static_cast<int64_t>(sms) * per_sm;
  if (b > (n_rows + kWarps - 1) / kWarps) b = (n_rows + kWarps - 1) / kWarps;
  if (b > cap) b = cap;
  if (b < 1 || b > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  blocks = static_cast<int>(b);
  return 0;
}

// The chunk's floats a lane, 4, 8 or 16, and the layout: the kernel's instance.
template <template <int, bool> class Launch, typename... Args>
int dispatch_chunk(int len, bool vec, Args... args) {
  if (len <= 128) return vec ? Launch<4, true>::run(args...) : Launch<4, false>::run(args...);
  if (len <= 256) return vec ? Launch<8, true>::run(args...) : Launch<8, false>::run(args...);
  return vec ? Launch<16, true>::run(args...) : Launch<16, false>::run(args...);
}

template <int kE, bool kVec>
struct LaunchScores {
  static int run(int chunks, cudaStream_t stream, const float* z, const float* a_src,
                 const float* a_dst, float* s_src, float* s_dst, int64_t n_rows, int heads,
                 int c_head, int hp) {
    int blocks = 0;
    const int err = resident_blocks(gat_scores_kernel<kE, kVec>, n_rows, 0x7fffffffLL, blocks);
    if (err != 0) return err;
    gat_scores_kernel<kE, kVec><<<dim3(blocks, chunks), kThreads, 0, stream>>>(
        z, a_src, a_dst, s_src, s_dst, n_rows, heads, c_head, hp);
    return static_cast<int>(cudaGetLastError());
  }
};

template <int kE, bool kVec>
struct LaunchScoreGrad {
  static int run(int chunks, cudaStream_t stream, const float* z, const float* a_src,
                 const float* a_dst, const float* ds_src, const float* ds_dst, float* dz,
                 float* part, int part_rows, int* blocks, int64_t n_rows, int heads,
                 int c_head, int hp) {
    const int err = resident_blocks(gat_score_grad_kernel<kE, kVec>, n_rows, part_rows, *blocks);
    if (err != 0) return err;
    gat_score_grad_kernel<kE, kVec><<<dim3(*blocks, chunks), kThreads, 0, stream>>>(
        z, a_src, a_dst, ds_src, ds_dst, dz, part, n_rows, heads, c_head, hp);
    return static_cast<int>(cudaGetLastError());
  }
};

// The heads of a chunk, the chunks of a row (the grid's y) and whether the
// float4 layout applies; false for shapes refused.
inline bool score_chunks(int64_t n_rows, int heads, int c_head, int aligned, int& hp,
                         int& chunks, bool& vec) {
  if (n_rows <= 0 || heads <= 0 || c_head <= 0 || c_head > kChunk) return false;
  hp = chunk_heads(heads, c_head);
  chunks = (heads + hp - 1) / hp;
  vec = aligned != 0 && (hp * c_head) % 4 == 0 && (static_cast<int64_t>(heads) * c_head) % 4 == 0;
  return chunks <= 65535;
}

}  // namespace

// All pointers contiguous on the current device; every index must lie in [0, n).
// row, col int32 [nnz] sorted by row; s_src, s_dst, m, l f32 [n, heads]; z, out,
// g, dz f32 [n, heads, c_head]; q float4 [n, heads]. c_head is at most 512.
// layout picks the weighted sum's and the backward pass's lanes: 0 one group a
// head, scalar; 1 one group a head, float4 (c_head % 4 == 0); 2 one group every
// head of a row (heads * c_head % 4 == 0, heads at most kRowHeads; a row longer
// than kRowFloats floats takes layout 0). For 1 and 2 the caller guarantees
// 16-byte aligned z, out (forward), z, g and dz (backward). The per-edge operands
// es, mask and ds_out are [heads, nnz] by the entry's place in the row listing,
// mask uint8 (null: no weight dropped); pos int32 [nnz] holds the place in the row
// listing of each entry of the listing walked (null: the row listing itself). Each
// entry launches on `stream` and returns cudaGetLastError() (0 on success); none
// synchronizes.

// The softmax statistics: m must hold -inf and l 0; two launches, the maxima then
// the sums. es null: the node scores' a = leaky(s_dst[i] + s_src[j]); else the
// per-edge scores es [heads, nnz] (row, m and l alone are read).
extern "C" int gat_stats_f32(const int32_t* row, const int32_t* col, const float* s_src,
                             const float* s_dst, const float* es, float* m, float* l,
                             int64_t nnz, int heads, float slope, cudaStream_t stream) {
  if (nnz <= 0 || heads <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (nnz + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const unsigned b = static_cast<unsigned>(blocks);
  if (es == nullptr) {
    gat_stats_kernel<0, false><<<b, kThreads, 0, stream>>>(row, col, s_src, s_dst, nullptr, m,
                                                           l, nnz, heads, slope);
  } else {
    gat_stats_kernel<0, true><<<b, kThreads, 0, stream>>>(row, nullptr, nullptr, nullptr, es, m,
                                                          l, nnz, heads, 0.f);
  }
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  if (es == nullptr) {
    gat_stats_kernel<1, false><<<b, kThreads, 0, stream>>>(row, col, s_src, s_dst, nullptr, m,
                                                           l, nnz, heads, slope);
  } else {
    gat_stats_kernel<1, true><<<b, kThreads, 0, stream>>>(row, nullptr, nullptr, nullptr, es, m,
                                                          l, nnz, heads, 0.f);
  }
  return static_cast<int>(cudaGetLastError());
}

// The weighted sum; out must hold 0. mode 0 (kNodeScores): GAT's node scores, in
// any layout, reading no per-edge operand; 1 (kNodeMasked): the node scores with
// the weights dropped by mask; 2 (kEdgeScores): alpha~ from the per-edge scores
// es, m and l; 3 (kEdgeWeights): the weights es as given, at pos. Modes 1-3 take
// the per-head layouts only (0 or 1).
extern "C" int gat_aggregate_f32(const int32_t* row, const int32_t* col, const float* s_src,
                                 const float* s_dst, const float* m, const float* l,
                                 const float* es, const uint8_t* mask, const int32_t* pos,
                                 float keep, const float* z, float* out, int64_t nnz,
                                 int heads, int c_head, float slope, int mode, int layout,
                                 cudaStream_t stream) {
  if (nnz <= 0 || heads <= 0 || c_head <= 0 || !layout_ok(layout, heads, c_head) ||
      (mode != kNodeScores && layout == kLayoutRow)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mode == kNodeScores && layout == kLayoutRow && heads * c_head <= kRowFloats) {
    return dispatch_row<RowAggregate>(heads, heads * c_head / 4, row, col, s_src, s_dst, m, l, z,
                                      out, nnz, heads, c_head, slope, stream);
  }
  const EdgeOps ops{es, mask, pos, keep};
  const bool v = layout == kLayoutVec4;
  switch (mode) {
    case kNodeScores:
      return dispatch_head<HeadAggregate<kNodeScores>::At>(
          c_head, row, col, s_src, s_dst, m, l, z, out, nnz, heads, c_head, slope, v,
          EdgeOps{nullptr, nullptr, nullptr, 1.f}, stream);
    case kNodeMasked:
      return dispatch_head<HeadAggregate<kNodeMasked>::At>(
          c_head, row, col, s_src, s_dst, m, l, z, out, nnz, heads, c_head, slope, v, ops,
          stream);
    case kEdgeScores:
      return dispatch_head<HeadAggregate<kEdgeScores>::At>(
          c_head, row, col, s_src, s_dst, m, l, z, out, nnz, heads, c_head, slope, v, ops,
          stream);
    case kEdgeWeights:
      return dispatch_head<HeadAggregate<kEdgeWeights>::At>(
          c_head, row, col, s_src, s_dst, m, l, z, out, nnz, heads, c_head, slope, v, ops,
          stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int gat_rowdot_f32(const float* g, const float* out, const float* s_dst,
                              const float* m, const float* l, float4* q, int64_t n_rows,
                              int heads, int c_head, cudaStream_t stream) {
  if (n_rows <= 0 || heads <= 0 || c_head <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n_rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  gat_rowdot_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      g, out, s_dst, m, l, q, n_rows, heads, c_head);
  return static_cast<int>(cudaGetLastError());
}

// The backward pass over the transposed listing t_row, t_col (sorted by t_row); dz
// must hold 0. mode 0 (kNodeScores): GAT's node scores, in any layout, ds_src and
// ds_dst (holding 0) added; 1 (kNodeMasked): the same with the weights dropped by
// mask; 2 (kEdgeScores): per-edge scores es, ds_out [heads, nnz] written whole,
// times ds_scale. Modes 1 and 2 take the per-head layouts only (0 or 1).
extern "C" int gat_backward_f32(const int32_t* t_row, const int32_t* t_col, const float* s_src,
                                const float4* q, const float* es, const uint8_t* mask,
                                const int32_t* pos, float keep, const float* z, const float* g,
                                float* dz, float* ds_src, float* ds_dst, float* ds_out,
                                float ds_scale, int64_t nnz, int heads, int c_head, float slope,
                                int mode, int layout, cudaStream_t stream) {
  if (nnz <= 0 || heads <= 0 || c_head <= 0 || !layout_ok(layout, heads, c_head) ||
      (mode != kNodeScores && layout == kLayoutRow)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mode == kNodeScores && layout == kLayoutRow && heads * c_head <= kRowFloats) {
    return dispatch_row<RowBackward>(heads, heads * c_head / 4, t_row, t_col, s_src, q, z, g, dz,
                                     ds_src, ds_dst, nnz, heads, c_head, slope, stream);
  }
  const EdgeOps ops{es, mask, pos, keep};
  const bool v = layout == kLayoutVec4;
  switch (mode) {
    case kNodeScores:
      return dispatch_head<HeadBackward<kNodeScores>::At>(
          c_head, t_row, t_col, s_src, q, z, g, dz, ds_src, ds_dst, nnz, heads, c_head, slope,
          v, EdgeOps{nullptr, nullptr, nullptr, 1.f}, static_cast<float*>(nullptr), 1.f, stream);
    case kNodeMasked:
      return dispatch_head<HeadBackward<kNodeMasked>::At>(
          c_head, t_row, t_col, s_src, q, z, g, dz, ds_src, ds_dst, nnz, heads, c_head, slope,
          v, ops, ds_out, ds_scale, stream);
    case kEdgeScores:
      return dispatch_head<HeadBackward<kEdgeScores>::At>(
          c_head, t_row, t_col, s_src, q, z, g, dz, ds_src, ds_dst, nnz, heads, c_head, slope,
          v, ops, ds_out, ds_scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// s [heads, nnz] written whole: s[h, e] = scale * <q[row_e, h, :], k[col_e, h, :]>,
// on the rows' listing, by the per-head layouts only (0 or 1).
extern "C" int edge_sddmm_f32(const int32_t* row, const int32_t* col, const float* q,
                              const float* k, float* s, int64_t nnz, int heads, int c_head,
                              float scale, int layout, cudaStream_t stream) {
  if (nnz <= 0 || heads <= 0 || c_head <= 0 || layout == kLayoutRow ||
      !layout_ok(layout, heads, c_head)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch_head<HeadSddmm>(c_head, row, col, q, k, s, nnz, heads, c_head, scale,
                                  layout == kLayoutVec4, stream);
}

// z [n_rows, heads, c_head], a_src and a_dst [heads, c_head], s_src and s_dst
// [n_rows, heads]; c_head is at most 512. aligned != 0: z (and, backward, dz)
// 16-byte aligned; the float4 layout is then taken where the shape allows it.
extern "C" int gat_scores_f32(const float* z, const float* a_src, const float* a_dst,
                              float* s_src, float* s_dst, int64_t n_rows, int heads,
                              int c_head, int aligned, cudaStream_t stream) {
  int hp, chunks;
  bool vec;
  if (!score_chunks(n_rows, heads, c_head, aligned, hp, chunks, vec)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch_chunk<LaunchScores>(hp * c_head, vec, chunks, stream, z, a_src, a_dst, s_src,
                                      s_dst, n_rows, heads, c_head, hp);
}

// ds_src, ds_dst [n_rows, heads]; dz [n_rows, heads, c_head] written whole;
// part [part_rows, 2, heads * c_head] scratch, a partial row of da_src and one
// of da_dst for each of the grid's blocks (part_rows at least the blocks the
// device holds at once: 16 an SM); da_src, da_dst [heads, c_head] written
// whole. Two launches: the gradient, then the sum of the blocks' partial rows.
extern "C" int gat_score_grad_f32(const float* z, const float* a_src, const float* a_dst,
                                  const float* ds_src, const float* ds_dst, float* dz,
                                  float* part, int part_rows, float* da_src, float* da_dst,
                                  int64_t n_rows, int heads, int c_head, int aligned,
                                  cudaStream_t stream) {
  int hp, chunks, blocks = 0;
  bool vec;
  if (!score_chunks(n_rows, heads, c_head, aligned, hp, chunks, vec) || part_rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int err = dispatch_chunk<LaunchScoreGrad>(hp * c_head, vec, chunks, stream, z, a_src,
                                                  a_dst, ds_src, ds_dst, dz, part, part_rows,
                                                  &blocks, n_rows, heads, c_head, hp);
  if (err != 0) return err;
  const int64_t width = static_cast<int64_t>(heads) * c_head;
  const int64_t sum_blocks = (2 * width + 31) / 32;
  if (sum_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  gat_score_sum_kernel<<<static_cast<unsigned>(sum_blocks), kThreads, 0, stream>>>(
      part, da_src, da_dst, blocks, width);
  return static_cast<int>(cudaGetLastError());
}
