// Banded (windowed dense-block) sparse-times-dense product for Hopper (sm_90a):
//     out[b*rb + i, :] = sum_k blocks[b, i, k] * xt[los[b] + k, :]
//         b < nb, i < rb, k < w;  xt = x, or x rounded to bf16 (round_x)
//
// Replaces ssrg_tpu/ops/pallas_banded.py::_banded_kernel, the Pallas TPU kernel
// that walks the row blocks in order, DMAs the [w, F] window of x for block b+1
// while the MXU multiplies block b (jnp.dot(a, xwin.astype(a.dtype),
// preferred_element_type=f32)), and writes each [rb, F] block once. After a
// locality reorder (RCM) every neighbour of a row block lies in one contiguous
// column window, so the sparse product becomes nb small dense products against
// contiguous slices of x. Window rows los[b] + k >= n read as zero: that
// replaces the reference's pad of x to `pad_to` rows (window starts are
// 16-aligned and unclamped). The C entry takes the path; the wrapper
// (ops/banded_spmm.py::path) picks it by the blocks' type, never by density.
//
// The work. A dense product of the pack is 2*nb*rb*w*F flops: 1.39e11 at the
// bf16 pack of the 169,343-node banded graph (nb 331, rb 512, w 3,200, F 128),
// 0.140 ms at the H100 SXM data sheet's 989 TFLOP/s in bf16, under the 0.3756
// ms it takes to move the pack's 1.085 GB, x and out once at 3.35 TB/s; and
// 1.05e11 flops, 0.106 ms, for the bench's dense bf16 pack (330 x 512 x 2,432),
// under its 0.2970 ms of bytes. So on the tensor cores even the dense product
// of every entry, zeros included, stays bound by the pack's bytes. In f32 the
// pack is 1.909 GB (nb 662, rb 256, w 2,816: 0.62 ms of bytes), but a dense f32
// product is 1.53e11 flops, 2.3 ms at the 67 TFLOP/s of f32 outside the tensor
// cores, and a tensor core cannot multiply f32 blocks exactly (TF32 keeps 10
// bits). Its entries are 99.47 % zeros: the work the function needs there is
// one multiply-add per feature for each of the 2,527,311 nonzeros, 6.5e8 flops.
//
// Path "tensor_core" (bf16 blocks, either round_x) replaces the reference's
// MXU dot where it is a bf16 x bf16 -> f32 product; the pack's bytes bound it.
// A rounding pass writes xb = bf16_rn(x) into an [n, fpad] scratch buffer
// (fpad = F rounded up to 8, so each row is 16-byte aligned; pad columns
// zero): it reads x once and writes half its bytes, as the reference's
// window_bf16 halves its window DMA. Then one CTA of two warpgroups takes a
// tile of kTcRows output rows of one row block and a tile of features, and
// walks k over the window a stage of window rows at a time through a
// cp.async ring in shared memory: the pack tile [kTcRows, stage] with the
// evict-first L2 policy (the pack is the term that bounds the path), the
// window tile xb[los[b] + k0 : + stage, f0 : f0 + features] with the
// evict-last policy (the rb / kTcRows CTAs of a row block and the neighbouring
// row blocks reread it from L2). Both tiles are laid out in wgmma's 128-byte
// swizzle, the pack tile K-major and the window tile MN-major, so each
// warpgroup runs its m64n128k16 products straight from the ring, bf16 x bf16
// -> f32 in registers. With a ring of 192 KB an SM holds one CTA.
//   F <= 128: 128 features (one wgmma of N 128 a k16 step), 128 window rows a
// stage (256 contiguous bytes of each pack row), 3 stages, each stage's wgmma
// waited for before the barrier that frees its slot.
//   F > 128: 256 features (two wgmma of N 128 a k16 step, 128 accumulators a
// thread), 64 window rows a stage, 4 stages, and the wgmma of a stage left in
// flight across the next stage's barrier (two stages requested ahead). So the
// pack is read once for F <= 256; a wider F takes one CTA per 256 features,
// the feature tiles of a pack tile scheduled side by side, and reads the pack
// once per 256 features. A pack byte feeds twice the products of F <= 128
// there, and the tensor cores' idle time at each barrier shows: the wgmma in
// flight made that tile faster, and made the F <= 128 tile slower (its ring
// then keeps one stage ahead). Stages of 64 rows, two CTAs an SM, a
// persistent CTA walking its tiles, mma.sync with ldmatrix and, for F > 128,
// one CTA per 128 features were each slower on the card
// (tools/banded_variants.py times the tile constants; PERF.md section 6 has
// the numbers).
// Pack rows past rb, k past w, window rows past n and features past fpad are
// zero-filled by the copy (src-size 0), never read. A pack whose rows are not
// whole 16-byte chunks (w % 8 != 0) or that is not 16-byte aligned is staged
// by masked scalar loads instead. Each output row is written once with f32
// stores: no atomics, and the result does not depend on the schedule.
//
// Numerics of "tensor_core": every entry is multiplied, zeros included, as in
// the reference's dot: an Inf or NaN of x under a zero entry gives NaN there
// too. Each bf16 x bf16 product is exact in f32; only the f32 sum differs.
// The bound below rests on the model of an MMA's sum that Fasi et al.,
// "Numerical behavior of NVIDIA tensor cores" (PeerJ CS, 2021), measured on
// Volta, Turing and Ampere; it is assumed, not measured, for Hopper's wgmma,
// and the card's observed error against it (chip_smoke.py's
// max_err_over_tolerance) is what backs it. In that model an MMA adds a
// group of exact products to its accumulator by aligning every term to the
// largest one's exponent, truncating what falls past the f32 significand
// (each term loses less than 2^-23 of the largest) and truncating the
// normalized sum (less than 2^-23 of it). A zero product loses nothing and a
// group of zero products leaves the accumulator as it was. A group with g
// nonzero products thus loses at most (g + 2) * 2^-23 * sum|a*x| of the row,
// and a row of c nonzero entries at most 3c * 2^-23 * sum|a*x| over its
// groups; the plain version's f32 sum of the same c exact products is within
// c * 2^-24 * sum|a*x|. So the two differ by at most 7 * c * 2^-24 *
// sum|a*x|, elementwise.
//
// Path "stream" (f32 blocks, either round_x) is the design for the f32
// pack, which is 99.47 % zeros and which a tensor core cannot multiply
// exactly; the pack's bytes bound it too. The pack is read as a stream at
// the rate of device memory and its nonzeros found on the way. f32 sums; a
// bf16 window is rounded to nearest even on the load, so every product is a
// bf16 x bf16 or f32 x f32 product added in f32. Only nonzero entries are
// multiplied, in increasing k; a zero entry added an exact zero to the dense
// product, so the set of products is the same and only the order of the f32
// sum differs. One difference by design: the dense product turns an Inf or
// NaN of x at a zero entry's column into NaN, this path does not.
//
// How the stream path is laid out: one warp per output row (b, i). The warp
// streams the row of the pack, W entries, in 512-byte chunks (16 bytes a
// lane: 4 entries, neighbouring lanes on neighbouring addresses) through a
// ring of kStages chunks in shared memory, filled by cp.async with an
// evict-first L2 policy, so that the pack does not push x out of L2 and the
// bytes in flight cost no registers. Each lane copies, and later reads back,
// only its own 16 bytes of a chunk, so the ring needs no barrier. For each
// chunk a warp vote finds the lanes that hold a nonzero entry (a window row
// past N counts as zero); a warp prefix sum of their counts appends each
// nonzero's (k, value) in increasing k to a short list in shared memory. When
// the list could overflow, and at the end of the row, the warp walks it kBatch
// entries at a time: every lane loads its 4 features of the kBatch window rows
// at once (one float4 a row a lane when F % 4 == 0 and x is 16-byte aligned,
// else four masked scalars), then adds them in list order. The rows of x come
// from L2: the warps in flight cover a few thousand rows of the pack, whose
// windows overlap in a few MB of x. The row is written once, with streaming
// stores, rows without a nonzero as zeros. F wider than 128 streams the row
// again for each 128 features, so the design holds its bound only for F <= 128.
// A W that is not a multiple of the 16-byte group, or a pack that is not
// 16-byte aligned, fills the ring with masked scalar loads instead.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py at F = 128,
// tools/banded_variants.py at F = 256 and for the tile neighbours; PERF.md
// section 6 has the rest). Tensor-core path: 0.4705 ms on the bf16 pack
// (79.8 % of its 0.3756 ms bound; torch.bmm over windows gathered beforehand
// 0.4737) and 0.3809 ms on the bench's dense bf16 pack (78.0 % of 0.2970;
// torch.bmm 0.3644), where the stream design took 0.5294 and 19.22 ms; at
// F = 256 on the bf16 pack 0.7105 ms (60.1 % of its 0.4273 ms bound, which
// counts the pack once; torch.bmm 0.5787), against 0.7340 with one CTA per
// 128 features and 0.7652 without the wgmma in flight. What holds it back:
// the rounding pass, 40.6 of about 462 us of device time on the bf16 pack
// (85.6 of 701 at F = 256; torch.profiler), whose xb write and reread the
// bound does not count; at F = 128 the product itself moves the pack, xb and
// out at about 2.9 TB/s; at F = 256 the tensor cores (391 TFLOP/s of dense
// products) still wait at each stage's barrier; and each tile's epilogue and
// the next CTA's first stages, with one CTA an SM. Stream path: 0.7589 ms on
// the f32 pack (81.9 % of its 0.6216 ms bound; torch.bmm 2.696); there the
// end of each row, where the warp sums its list from L2 with nothing of the
// stream in flight, is the cost that remains.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWarps = 2;      // output rows (warps) of a thread block
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 8;     // 512-byte chunks of the pack in flight a warp
constexpr int kCap = 256;      // (k, value) entries of a warp's list
constexpr int kBatch = 4;      // window rows gathered before any is added
constexpr int kTile = 128;     // features a warp covers per pass over the row
constexpr int kE = 4;          // f32 pack entries in 16 bytes
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

__device__ __forceinline__ void set_word(uint4& r, int i, uint32_t v) {
  if (i == 0) r.x = v;
  else if (i == 1) r.y = v;
  else if (i == 2) r.z = v;
  else r.w = v;
}

// bit j set where entry j of a 16-byte group is nonzero (+0 and -0 are zero)
__device__ __forceinline__ unsigned nonzero_bits(const uint4& r) {
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < kE; ++j) m |= ((word(r, j) & 0x7fffffffu) != 0u) << j;
  return m;
}

// the lane's 16-byte group of the row at entry k by masked scalar loads
// (zeros past w), for rows that are not whole aligned groups
__device__ __forceinline__ uint4 load_group(const float* __restrict__ arow, int k, int w) {
  const unsigned* a = reinterpret_cast<const unsigned*>(arow);
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int j = 0; j < kE; ++j)
    if (k + j < w) set_word(r, j, __ldcs(a + k + j));
  return r;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The lane's 4 features of window row `xr` (a pointer to x[row, f0]):
// x[row, f0 + 4*lane + q] (vector) or x[row, f0 + lane + 32*q] (scalar).
template <bool kVecX>
__device__ __forceinline__ void load_x(const float* __restrict__ xr, int lane, int nf,
                                       bool valid, float (&g)[4]) {
  if (kVecX) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid && 4 * lane < nf) v = __ldg(reinterpret_cast<const float4*>(xr) + lane);
    g[0] = v.x; g[1] = v.y; g[2] = v.z; g[3] = v.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      g[q] = (valid && lane + 32 * q < nf) ? __ldg(xr + lane + 32 * q) : 0.f;
  }
}

// Add the listed terms to acc, in list order, kBatch window rows at a time.
template <bool kVecX>
__device__ __forceinline__ void flush(const int2* list, int cnt, const float* __restrict__ x,
                                      int64_t lo, int f, int f0, int nf, int lane, int round_x,
                                      float (&acc)[4]) {
  __syncwarp();
  for (int t0 = 0; t0 < cnt; t0 += kBatch) {
    float v[kBatch];
    float g[kBatch][4];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const bool valid = t0 + i < cnt;
      const int2 e = valid ? list[t0 + i] : make_int2(0, 0);
      v[i] = __int_as_float(e.y);
      load_x<kVecX>(x + (lo + e.x) * static_cast<int64_t>(f) + f0, lane, nf, valid, g[i]);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (t0 + i < cnt) {  // uniform across the warp
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[q] = fmaf(v[i], round_x ? round_bf16(g[i][q]) : g[i][q], acc[q]);
        }
      }
    }
  }
  __syncwarp();
}

// L2 policy for the pack: evict first, so that the stream does not push the
// window rows of x out of L2
__device__ __forceinline__ uint64_t evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// Ask for the lane's 16-byte group of the row at entry k into its ring slot:
// an asynchronous copy (zeros past w), or masked scalar loads stored at once.
template <bool kVecA>
__device__ __forceinline__ void request(uint4* slot, const float* __restrict__ arow, int k, int w,
                                        uint64_t policy) {
  if (kVecA) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(slot));
    const int bytes = k < w ? 16 : 0;  // 0: fill the slot with zeros, read nothing
    asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n"
                 :: "r"(dst), "l"(arow + (k < w ? k : 0)), "r"(bytes), "l"(policy)
                 : "memory");
  } else {
    *slot = load_group(arow, k, w);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <bool kVecA, bool kVecX>
__global__ void __launch_bounds__(kThreads)
banded_spmm_kernel(const float* __restrict__ blocks, const int32_t* __restrict__ los,
                   const float* __restrict__ x, float* __restrict__ out, int64_t rows, int rb,
                   int w, int64_t n, int f, int round_x) {
  constexpr int kChunk = 32 * kE;  // entries of one warp-wide 16-byte load
  __shared__ int2 list_s[kWarps][kCap];
  __shared__ uint4 ring_s[kWarps][kStages][32];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (row >= rows) return;  // uniform across the warp
  const float* arow = blocks + row * w;
  const uint64_t policy = evict_first();
  const int chunks = (w + kChunk - 1) / kChunk;
  const int64_t lo = los[row / rb];
  // entries k >= lim lie past N or past the window: they read as zero
  const int lim = static_cast<int>(
      max(static_cast<int64_t>(0), min(static_cast<int64_t>(w), n - lo)));
  int2* list = list_s[warp];
  float* out_row = out + row * static_cast<int64_t>(f);

  for (int f0 = 0; f0 < f; f0 += kTile) {
    const int nf = min(kTile, f - f0);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      request<kVecA>(&ring_s[warp][s][lane], arow, (s * 32 + lane) * kE,
                        s < chunks ? w : 0, policy);
    }
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    int cnt = 0;
    for (int c = 0; c < chunks; ++c) {
      // the lane's own copy of chunk c has landed (one group a chunk)
      asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 1) : "memory");
      uint4* slot = &ring_s[warp][c % kStages][lane];
      const uint4 raw = *slot;
      const int k = (c * 32 + lane) * kE;         // the lane's first entry
      unsigned m = nonzero_bits(raw);
      const int in = lim - k;                      // entries of the group before lim
      m &= in >= kE ? (1u << kE) - 1u : in > 0 ? (1u << in) - 1u : 0u;
      if (__any_sync(kFull, m != 0u)) {
        const int cc = __popc(m);
        int incl = cc;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(kFull, incl, d);
          if (lane >= d) incl += y;
        }
        const int total = __shfl_sync(kFull, incl, 31);
        if (cnt + total > kCap) {
          flush<kVecX>(list, cnt, x, lo, f, f0, nf, lane, round_x, acc);
          cnt = 0;
        }
        int pos = cnt + incl - cc;
        while (m) {
          const int j = __ffs(m) - 1;
          m &= m - 1u;
          list[pos++] = make_int2(k + j, static_cast<int>(word(raw, j)));
        }
        cnt += total;
      }
      // refill the slot, now read, with chunk c + kStages
      const int next = c + kStages;
      request<kVecA>(slot, arow, (next * 32 + lane) * kE, next < chunks ? w : 0, policy);
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    flush<kVecX>(list, cnt, x, lo, f, f0, nf, lane, round_x, acc);
    if (kVecX) {
      if (4 * lane < nf) {
        __stcs(reinterpret_cast<float4*>(out_row + f0) + lane,
               make_float4(acc[0], acc[1], acc[2], acc[3]));
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (lane + 32 * q < nf) __stcs(out_row + f0 + lane + 32 * q, acc[q]);
    }
  }
}

template <bool kVecA>
void launch_x(const float* blocks, const int32_t* los, const float* x, float* out, int64_t rows,
              int rb, int w, int64_t n, int f, int round_x, bool vec_x, dim3 grid,
              cudaStream_t stream) {
  if (vec_x) {
    banded_spmm_kernel<kVecA, true><<<grid, kThreads, 0, stream>>>(
        blocks, los, x, out, rows, rb, w, n, f, round_x);
  } else {
    banded_spmm_kernel<kVecA, false><<<grid, kThreads, 0, stream>>>(
        blocks, los, x, out, rows, rb, w, n, f, round_x);
  }
}

void launch_stream(const float* blocks, const int32_t* los, const float* x, float* out,
                   int64_t rows, int rb, int w, int64_t n, int f, int round_x, bool vec_x,
                   dim3 grid, cudaStream_t stream) {
  // 16-byte groups need whole groups per row and an aligned pack
  const bool vec_a = w % kE == 0 && reinterpret_cast<uintptr_t>(blocks) % 16 == 0;
  if (vec_a) {
    launch_x<true>(blocks, los, x, out, rows, rb, w, n, f, round_x, vec_x, grid, stream);
  } else {
    launch_x<false>(blocks, los, x, out, rows, rb, w, n, f, round_x, vec_x, grid, stream);
  }
}

// --- the tensor-core path: bf16 blocks ---------------------------------------

constexpr int kTcRows = 128;      // output rows of a CTA, 64 a warpgroup, of one row block
constexpr int kTcMinBlocks = 1;   // CTAs an SM should hold at once
// the tile for F <= 128: 128 features (the N of one wgmma), 128 window rows a
// stage (256 contiguous bytes of each pack row), 3 stages, and the stages of
// wgmma left in flight across the next stage's barrier (0 or 1)
constexpr int kTcDepth = 128;
constexpr int kTcStages = 3;
constexpr int kTcInFlight = 0;
// the tile for F > 128: kTcWideFeatures features (two wgmma of N 128 a k16
// step when 256, so that the pack is read once for F <= 256), 64 window rows
// a stage, 4 stages
constexpr int kTcWideFeatures = 256;
constexpr int kTcWideDepth = 64;
constexpr int kTcWideStages = 4;
constexpr int kTcWideInFlight = 1;
constexpr int kTcGroups = kTcRows / 64;                // warpgroups of a CTA
constexpr int kTcThreads = 128 * kTcGroups;
constexpr int kTcSlabA = kTcRows * 128;                // 64 window rows of the pack tile
constexpr int kWindowWarps = 8;   // rows of x a block of the rounding pass takes at once
static_assert(kTcRows % 64 == 0, "64 rows a warpgroup");

// The shape of a CTA's tile and ring for kFeatures features.
template <int kFeatures>
struct TcShape {
  static constexpr bool kWide = kFeatures > 128;
  static constexpr int kDepth = kWide ? kTcWideDepth : kTcDepth;     // window rows a stage
  static constexpr int kStages = kWide ? kTcWideStages : kTcStages;  // stages of the ring
  static constexpr int kInFlight = kWide ? kTcWideInFlight : kTcInFlight;
  // stages requested ahead of the one multiplied: a slot is refilled once
  // the wgmma of every stage it held, kInFlight of them still running, are done
  static constexpr int kAhead = kStages - 1 - kInFlight;
  static constexpr int kHalves = kFeatures / 128;   // m64n128k16 wgmma a k16 step
  static constexpr int kChunksA = kDepth / 8;       // 16-byte chunks of a pack row a stage
  static constexpr int kChunksB = kFeatures / 8;    // 16-byte chunks of a window row
  static constexpr int kBytesA = kTcRows * kDepth * 2;
  static constexpr int kSlab = kDepth * 128;        // 64 features of the window tile
  static constexpr int kStageBytes = kBytesA + kDepth * kFeatures * 2;
  static constexpr int kSmem = kStages * kStageBytes + 1024;  // + room to align the ring
  static_assert(kFeatures % 128 == 0, "whole wgmma of N 128");
  static_assert((kInFlight == 0 || kInFlight == 1) && kAhead >= 1, "a stage ahead at least");
  static_assert(kDepth % 64 == 0, "pack tile slabs of 128-byte swizzle rows");
  static_assert(kStageBytes % 1024 == 0, "stages start on 1024-byte swizzle atoms");
  static_assert((kTcRows * kChunksA) % kTcThreads == 0 && (kDepth * kChunksB) % kTcThreads == 0,
                "every thread copies the same number of chunks a stage");
  static_assert(kSmem <= 227 * 1024, "the ring fits an SM's shared memory");
};

// The rounding pass: xb[r, :] = bf16_rn(x[r, :]), zeros in the pad columns
// f <= c < fpad. A warp takes a row, a lane four features at a time.
__global__ void __launch_bounds__(32 * kWindowWarps)
round_window_kernel(const float* __restrict__ x, __nv_bfloat16* __restrict__ xb, int64_t n,
                    int f, int fpad, int vec) {
  const int lane = threadIdx.x & 31;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWindowWarps;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * kWindowWarps + (threadIdx.x >> 5); r < n;
       r += step) {
    const float* xr = x + r * f;
    uint2* dst = reinterpret_cast<uint2*>(xb + r * fpad);
    for (int q = lane; 4 * q < fpad; q += 32) {
      const int c = 4 * q;
      float v[4];
      if (vec && c + 4 <= f) {
        const float4 t = __ldcs(reinterpret_cast<const float4*>(xr + c));
        v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = c + j < f ? __ldcs(xr + c + j) : 0.f;
      }
      const __nv_bfloat162 lo2 = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 hi2 = __floats2bfloat162_rn(v[2], v[3]);
      dst[q] = make_uint2(*reinterpret_cast<const uint32_t*>(&lo2),
                          *reinterpret_cast<const uint32_t*>(&hi2));
    }
  }
}

__device__ __forceinline__ uint64_t evict_last() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int bytes,
                                            uint64_t policy) {
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n"
               :: "r"(dst), "l"(src), "r"(bytes), "l"(policy) : "memory");
}

// the 8 entries of a pack row at k by masked scalar loads (zeros past w),
// for packs that are not whole aligned 16-byte chunks
__device__ __forceinline__ uint4 load_chunk_bf16(const __nv_bfloat16* __restrict__ arow, int k,
                                                 int w) {
  const unsigned short* a = reinterpret_cast<const unsigned short*>(arow);
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (k + j < w) {
      const uint32_t h = __ldcs(a + k + j);
      set_word(r, j >> 1, word(r, j >> 1) | (h << (16 * (j & 1))));
    }
  }
  return r;
}

// Stage layouts, both the 128-byte swizzle of wgmma's shared-memory operands:
// 16-byte chunk c of a 128-byte row r lands at chunk c ^ (r & 7), in atoms of
// 8 rows x 128 bytes. The pack tile is K-major: row r of the tile (an output
// row) holds 64 entries, in kDepth / 64 slabs of kTcSlabA bytes. The window
// tile is MN-major: row k (a window row) holds 64 features, in kFeatures / 64
// slabs of kSlab bytes.
__device__ __forceinline__ uint32_t tile_a(int r, int c) {
  return (c >> 3) * kTcSlabA + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}
template <int kFeatures>
__device__ __forceinline__ uint32_t tile_b(int k, int c) {
  using S = TcShape<kFeatures>;
  return S::kBytesA + (c >> 3) * S::kSlab + k * 128 + (((c & 7) ^ (k & 7)) << 4);
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the 128-byte swizzle (mode 1, bits 62-63).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3fff) << 32) | (1ull << 62);
}

// d += a b over one k16 step: a [64, 16] K-major, b [16, 128] MN-major (the
// transpose bit), bf16 operands from shared memory, f32 sums in registers.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// Ask for stage `kt` of the CTA's tile into the ring slot at `slot`: the pack
// rows [i0, i0 + rows) of row block b at k in [k0, k0 + kDepth) and the window
// rows lo + k0 ... of xb at features [f0, f0 + kFeatures). Entries past the
// row block, past w, past n or past fpad are zero-filled: nothing is read past
// an allocation, and a window row at k >= w adds 0 * 0.
template <int kFeatures, bool kVecA>
__device__ __forceinline__ void tc_request(uint32_t slot, const __nv_bfloat16* __restrict__ a_tile,
                                           const __nv_bfloat16* __restrict__ xb, int rows, int w,
                                           int64_t n, int fpad, int64_t lo, int k0, int f0,
                                           int tid, uint64_t policy, uint64_t keep) {
  using S = TcShape<kFeatures>;
#pragma unroll
  for (int j = 0; j < kTcRows * S::kChunksA / kTcThreads; ++j) {
    const int c = tid + j * kTcThreads;
    const int r = c / S::kChunksA;
    const int kc = c % S::kChunksA;
    const int k = k0 + kc * 8;
    if (kVecA) {
      const bool ok = r < rows && k < w;
      cp_async_16(slot + tile_a(r, kc), ok ? a_tile + static_cast<int64_t>(r) * w + k : a_tile,
                  ok ? 16 : 0, policy);
    } else {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows) v = load_chunk_bf16(a_tile + static_cast<int64_t>(r) * w, k, w);
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                   :: "r"(slot + tile_a(r, kc)), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                   : "memory");
    }
  }
#pragma unroll
  for (int j = 0; j < S::kDepth * S::kChunksB / kTcThreads; ++j) {
    const int c = tid + j * kTcThreads;
    const int k = c / S::kChunksB;
    const int nc = c % S::kChunksB;
    const int64_t row = lo + k0 + k;
    const int col = f0 + nc * 8;
    const bool ok = k0 + k < w && row < n && col < fpad;
    cp_async_16(slot + tile_b<kFeatures>(k, nc), ok ? xb + row * fpad + col : xb, ok ? 16 : 0,
                keep);
  }
}

// A tile of the product: output rows [i0, i0 + kTcRows) of row block b
// (clipped to rb), features [f0, f0 + kFeatures). Tiles are numbered with the
// feature tile fastest, then the row tile, then the row block, so that the CTAs
// working at one time share their pack tile (F > kFeatures) and their window
// of xb.
struct TcTile {
  int64_t out_row;  // its first output row (and pack row)
  int b;            // its row block
  int rows;         // its rows
  int f0;           // its first feature
};

__device__ __forceinline__ TcTile tc_tile(int t, int rb, int mtiles, int ftiles, int features) {
  const int rest = t / ftiles;
  const int mt = rest % mtiles;
  TcTile tile;
  tile.b = rest / mtiles;
  tile.out_row = static_cast<int64_t>(tile.b) * rb + mt * kTcRows;
  tile.rows = min(kTcRows, rb - mt * kTcRows);
  tile.f0 = t % ftiles * features;
  return tile;
}

// Each output row of the tile once, f32 pairs where f is even, streaming
// stores. Accumulator h of warp w of warpgroup g: rows 64 g + 16 w + lane / 4
// (+ 8), for each n8 chunk j features 128 h + 8 j + 2 (lane % 4) (+ 1).
template <int kFeatures>
__device__ __forceinline__ void tc_store(const float (&acc)[kFeatures / 128][64],
                                         float* __restrict__ out, const TcTile& tile, int f,
                                         int tid) {
  const int lane = tid & 31;
  const int warp = (tid >> 5) & 3;
  const int group = tid >> 7;
  const bool pairs = (f & 1) == 0;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = group * 64 + warp * 16 + (lane >> 2) + 8 * e;
    if (r >= tile.rows) continue;
    float* orow = out + (tile.out_row + r) * f;
#pragma unroll
    for (int h = 0; h < kFeatures / 128; ++h) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = tile.f0 + 128 * h + 8 * j + 2 * (lane & 3);
        const float v0 = acc[h][4 * j + 2 * e];
        const float v1 = acc[h][4 * j + 2 * e + 1];
        if (pairs && col + 1 < f) {
          __stcs(reinterpret_cast<float2*>(orow + col), make_float2(v0, v1));
        } else {
          if (col < f) __stcs(orow + col, v0);
          if (col + 1 < f) __stcs(orow + col + 1, v1);
        }
      }
    }
  }
}

// One CTA a tile (the hardware's block scheduler balances the tiles over the
// SMs). Warpgroup g takes rows [64 g, 64 g + 64) of the tile: for each stage,
// kDepth / 16 k16 steps of kFeatures / 128 wgmma m64n128k16 straight from the
// ring, waited for before the slot is refilled.
template <int kFeatures, bool kVecA>
__global__ void __launch_bounds__(kTcThreads, kTcMinBlocks)
banded_mma_kernel(const __nv_bfloat16* __restrict__ blocks, const int32_t* __restrict__ los,
                  const __nv_bfloat16* __restrict__ xb, float* __restrict__ out, int rb, int w,
                  int64_t n, int f, int fpad, int mtiles, int ftiles) {
  using S = TcShape<kFeatures>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x;
  const int group = tid >> 7;
  const TcTile tile = tc_tile(static_cast<int>(blockIdx.x), rb, mtiles, ftiles, kFeatures);
  const __nv_bfloat16* a_tile = blocks + tile.out_row * w;
  const int64_t lo = los[tile.b];
  const int ktiles = (w + S::kDepth - 1) / S::kDepth;
  const uint64_t policy = evict_first();
  const uint64_t keep = evict_last();
  // the swizzle atoms must start on 1024-byte boundaries
  const uint32_t base = (static_cast<uint32_t>(__cvta_generic_to_shared(smem)) + 1023u) & ~1023u;

  float acc[S::kHalves][64];
#pragma unroll
  for (int h = 0; h < S::kHalves; ++h) {
#pragma unroll
    for (int q = 0; q < 64; ++q) acc[h][q] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < S::kAhead; ++s) {
    if (s < ktiles) {
      tc_request<kFeatures, kVecA>(base + s * S::kStageBytes, a_tile, xb, tile.rows, w, n, fpad,
                                   lo, s * S::kDepth, tile.f0, tid, policy, keep);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    // stage kt has landed for this thread; the proxy fence hands its writes to
    // the tensor cores' (async) proxy, the barrier makes the stage the CTA's
    // and frees the slot stage kt - 1 - kInFlight was read from (every
    // warpgroup has waited for its wgmma)
    asm volatile("cp.async.wait_group %0;\n" :: "n"(S::kAhead - 1) : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int next = kt + S::kAhead;
    if (next < ktiles) {
      tc_request<kFeatures, kVecA>(base + (next % S::kStages) * S::kStageBytes, a_tile, xb,
                                   tile.rows, w, n, fpad, lo, next * S::kDepth, tile.f0, tid,
                                   policy, keep);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const uint32_t slot = base + (kt % S::kStages) * S::kStageBytes;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < S::kDepth / 16; ++ks) {
      // A: 8-row atoms 1024 bytes apart (stride), k16 = 32 bytes along the row;
      // B: slabs of 64 features kSlab apart (leading), 8-row atoms 1024 apart,
      // wgmma h on the slabs of features [128 h, 128 h + 128)
      const uint64_t desc_a = smem_desc(
          slot + (ks >> 2) * kTcSlabA + group * 64 * 128 + (ks & 3) * 32, 16, 1024);
#pragma unroll
      for (int h = 0; h < S::kHalves; ++h) {
        wgmma_m64n128k16(acc[h], desc_a,
                         smem_desc(slot + S::kBytesA + 2 * h * S::kSlab + ks * 16 * 128,
                                   S::kSlab, 1024));
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(S::kInFlight) : "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  tc_store<kFeatures>(acc, out, tile, f, tid);
}

template <int kFeatures, bool kVecA>
int launch_mma(const __nv_bfloat16* blocks, const int32_t* los, const __nv_bfloat16* xb,
               float* out, int nb, int rb, int w, int64_t n, int f, int fpad,
               cudaStream_t stream) {
  using S = TcShape<kFeatures>;
  const int mtiles = (rb + kTcRows - 1) / kTcRows;
  const int ftiles = (f + kFeatures - 1) / kFeatures;
  const int64_t tiles = static_cast<int64_t>(nb) * mtiles * ftiles;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaError_t err = cudaFuncSetAttribute(
      banded_mma_kernel<kFeatures, kVecA>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  banded_mma_kernel<kFeatures, kVecA><<<static_cast<unsigned>(tiles), kTcThreads, S::kSmem,
                                        stream>>>(blocks, los, xb, out, rb, w, n, f, fpad,
                                                  mtiles, ftiles);
  return static_cast<int>(cudaGetLastError());
}

template <int kFeatures>
int launch_mma_a(const __nv_bfloat16* blocks, const int32_t* los, const __nv_bfloat16* xb,
                 float* out, int nb, int rb, int w, int64_t n, int f, int fpad,
                 cudaStream_t stream) {
  // 16-byte chunks need whole chunks per pack row and an aligned pack
  if (w % 8 == 0 && reinterpret_cast<uintptr_t>(blocks) % 16 == 0) {
    return launch_mma<kFeatures, true>(blocks, los, xb, out, nb, rb, w, n, f, fpad, stream);
  }
  return launch_mma<kFeatures, false>(blocks, los, xb, out, nb, rb, w, n, f, fpad, stream);
}

// The rounding pass, then the product; `window` holds n * fpad bf16 values.
int launch_tensor_core(const __nv_bfloat16* blocks, const int32_t* los, const float* x,
                       float* out, __nv_bfloat16* window, int nb, int rb, int w, int64_t n,
                       int f, cudaStream_t stream) {
  const int fpad = (f + 7) / 8 * 8;
  if (n > 0) {
    const int64_t grid = std::min<int64_t>((n + kWindowWarps - 1) / kWindowWarps, 8192);
    const int vec = f % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    round_window_kernel<<<static_cast<unsigned>(grid), 32 * kWindowWarps, 0, stream>>>(
        x, window, n, f, fpad, vec);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (f > 128) {
    return launch_mma_a<kTcWideFeatures>(blocks, los, window, out, nb, rb, w, n, f, fpad,
                                         stream);
  }
  return launch_mma_a<128>(blocks, los, window, out, nb, rb, w, n, f, fpad, stream);
}

}  // namespace

constexpr int kPathStream = 0;      // banded_spmm.py::PATHS[0]
constexpr int kPathTensorCore = 1;  // banded_spmm.py::PATHS[1]

// blocks [nb, rb, w] (f32, or bf16 when blocks_bf16 != 0), los int32 [nb],
// x f32 [n, f] and out f32 [nb * rb, f], all contiguous on the current device.
// path kPathStream takes f32 blocks only; round_x != 0 rounds their window to
// bf16 before the products. kPathTensorCore takes bf16 blocks only (their
// window is always rounded) and needs `window`, scratch of n * round_up(f, 8)
// bf16 values on the same device, that it overwrites; kPathStream ignores
// `window`. Launches on `stream` and returns cudaGetLastError() (0 on
// success); does not synchronize.
extern "C" int banded_spmm(const void* blocks, int blocks_bf16, const int32_t* los,
                           const float* x, float* out, int nb, int rb, int w, int64_t n,
                           int f, int round_x, int path, void* window, cudaStream_t stream) {
  if (nb <= 0 || rb <= 0 || w <= 0 || f <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (path == kPathTensorCore) {
    if (!blocks_bf16 || window == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return launch_tensor_core(static_cast<const __nv_bfloat16*>(blocks), los, x, out,
                              static_cast<__nv_bfloat16*>(window), nb, rb, w, n, f, stream);
  }
  if (path != kPathStream || blocks_bf16) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t rows = static_cast<int64_t>(nb) * rb;
  const int64_t grid_x = (rows + kWarps - 1) / kWarps;
  if (grid_x > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool vec_x = f % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  launch_stream(static_cast<const float*>(blocks), los, x, out, rows, rb, w, n, f, round_x, vec_x,
                dim3(static_cast<unsigned>(grid_x)), stream);
  return static_cast<int>(cudaGetLastError());
}
