// Banded (windowed dense-block) sparse-times-dense product for Hopper (sm_90a):
//     out[b*rb + i, :] = sum_k blocks[b, i, k] * xt[los[b] + k, :]
//         b < nb, i < rb, k < w;  xt = x, or x rounded to bf16 (round_x)
//
// Replaces ssrg_tpu/ops/pallas_banded.py::_banded_kernel, the Pallas TPU kernel
// that walks the row blocks in order, DMAs the [w, F] window of x for block b+1
// while the MXU multiplies block b, and writes each [rb, F] block once. After a
// locality reorder (RCM) every neighbour of a row block lies in one contiguous
// column window, so the sparse product becomes nb small dense products against
// contiguous slices of x. On the TPU the dense product is the cheap way through
// the pack; on Hopper it is not, because almost every entry is zero.
//
// Numerics: f32 sums. blocks are f32 or bf16; bf16 values are widened to f32,
// and xt is rounded to bf16 (round to nearest even) when the blocks are bf16 or
// the caller asks for a bf16 window, so every product is a bf16 x bf16 product,
// exact in f32, as with the reference's preferred_element_type=f32. Window rows
// los[b] + k >= n read as zero: that replaces the reference's pad of x to
// `pad_to` rows (window starts are 16-aligned and unclamped). Only nonzero
// entries are multiplied, in increasing k; a zero entry added an exact zero to
// the dense product, so the set of products is the same and only the order of
// the f32 sum differs. One difference by design: the dense product turns an Inf
// or NaN of x at a zero entry's column into NaN, this kernel does not.
//
// What bounds it: bytes. At the f32 pack of the 169,343-node banded graph
// (nb 662, rb 256, w 2,816, F 128) the blocks hold 1.909 GB; with x and out
// that is 2.08 GB to move once, 0.62 ms at the H100 SXM data sheet's 3.35 TB/s
// (0.376 ms for the 1.258 GB of the bf16 pack: nb 331, rb 512, w 3,200). The
// entries are 99.47 % zeros: the work the function needs is one multiply-add
// per feature for each of the 2,527,311 nonzeros, 6.5e8 flops, 0.01 ms at the
// f32 rate. Tensor cores do not apply: with the zeros skipped there is no dense
// product left to give them. So the pack has to be read as a stream, at the
// rate of device memory, and the nonzeros found on the way.
//
// What the design does about it: one warp per output row (b, i). The warp
// streams the row of the pack, W entries, in 512-byte chunks (16 bytes a lane:
// 4 f32 or 8 bf16 entries, neighbouring lanes on neighbouring addresses)
// through a ring of kStages chunks in shared memory, filled by cp.async with an
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
// stores, rows without a nonzero as zeros: no atomics, and the result does not
// depend on the schedule. F wider than 128 streams the row again for each 128
// features, so the design holds its bound only for F <= 128: at F = 256 it
// reads the pack, the term that bounds it, twice. A W that is not a multiple of
// the 16-byte group, or a pack that is not 16-byte aligned, fills the ring with
// masked scalar loads instead.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W): see PERF.md. The
// end of each row, where the warp sums its list from L2 with nothing of the
// stream in flight, is the cost that remains: it weighs most on the bf16 pack,
// whose rows are 6.4 KB against the f32 pack's 11 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 2;      // output rows (warps) of a thread block
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 8;     // 512-byte chunks of the pack in flight a warp
constexpr int kCap = 256;      // (k, value) entries of a warp's list
constexpr int kBatch = 4;      // window rows gathered before any is added
constexpr int kTile = 128;     // features a warp covers per pass over the row
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Entries;  // pack entries in 16 bytes
template <>
struct Entries<float> {
  static constexpr int kE = 4;
};
template <>
struct Entries<__nv_bfloat16> {
  static constexpr int kE = 8;
};

__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

__device__ __forceinline__ void set_word(uint4& r, int i, uint32_t v) {
  if (i == 0) r.x = v;
  else if (i == 1) r.y = v;
  else if (i == 2) r.z = v;
  else r.w = v;
}

// entry j of a 16-byte group, widened to f32
template <typename T>
__device__ __forceinline__ float entry(const uint4& r, int j);
template <>
__device__ __forceinline__ float entry<float>(const uint4& r, int j) {
  return __uint_as_float(word(r, j));
}
template <>
__device__ __forceinline__ float entry<__nv_bfloat16>(const uint4& r, int j) {
  return __uint_as_float((word(r, j >> 1) >> (16 * (j & 1))) << 16);
}

// bit j set where entry j is nonzero (+0 and -0 are zero)
template <typename T>
__device__ __forceinline__ unsigned nonzero_bits(const uint4& r) {
  unsigned m = 0;
  if (sizeof(T) == 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) m |= ((word(r, j) & 0x7fffffffu) != 0u) << j;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      m |= (((word(r, j >> 1) >> (16 * (j & 1))) & 0x7fffu) != 0u) << j;
    }
  }
  return m;
}

// the lane's 16-byte group of the row at entry k by masked scalar loads
// (zeros past w), for rows that are not whole aligned groups
template <typename T>
__device__ __forceinline__ uint4 load_group(const T* __restrict__ arow, int k, int w) {
  constexpr int kE = Entries<T>::kE;
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (sizeof(T) == 4) {
    const unsigned* a = reinterpret_cast<const unsigned*>(arow);
#pragma unroll
    for (int j = 0; j < kE; ++j)
      if (k + j < w) set_word(r, j, __ldcs(a + k + j));
  } else {
    const unsigned short* a = reinterpret_cast<const unsigned short*>(arow);
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      if (k + j < w) {
        const uint32_t h = __ldcs(a + k + j);
        set_word(r, j >> 1, word(r, j >> 1) | (h << (16 * (j & 1))));
      }
    }
  }
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
template <typename T, bool kVecA>
__device__ __forceinline__ void request(uint4* slot, const T* __restrict__ arow, int k, int w,
                                        uint64_t policy) {
  if (kVecA) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(slot));
    const int bytes = k < w ? 16 : 0;  // 0: fill the slot with zeros, read nothing
    asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n"
                 :: "r"(dst), "l"(arow + (k < w ? k : 0)), "r"(bytes), "l"(policy)
                 : "memory");
  } else {
    *slot = load_group<T>(arow, k, w);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <typename T, bool kVecA, bool kVecX>
__global__ void __launch_bounds__(kThreads)
banded_spmm_kernel(const T* __restrict__ blocks, const int32_t* __restrict__ los,
                   const float* __restrict__ x, float* __restrict__ out, int64_t rows, int rb,
                   int w, int64_t n, int f, int round_x) {
  constexpr int kE = Entries<T>::kE;
  constexpr int kChunk = 32 * kE;  // entries of one warp-wide 16-byte load
  __shared__ int2 list_s[kWarps][kCap];
  __shared__ uint4 ring_s[kWarps][kStages][32];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (row >= rows) return;  // uniform across the warp
  const T* arow = blocks + row * w;
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
      request<T, kVecA>(&ring_s[warp][s][lane], arow, (s * 32 + lane) * kE,
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
      unsigned m = nonzero_bits<T>(raw);
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
          list[pos++] = make_int2(k + j, __float_as_int(entry<T>(raw, j)));
        }
        cnt += total;
      }
      // refill the slot, now read, with chunk c + kStages
      const int next = c + kStages;
      request<T, kVecA>(slot, arow, (next * 32 + lane) * kE, next < chunks ? w : 0, policy);
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

template <typename T, bool kVecA>
void launch_x(const T* blocks, const int32_t* los, const float* x, float* out, int64_t rows,
            int rb, int w, int64_t n, int f, int round_x, bool vec_x, dim3 grid,
            cudaStream_t stream) {
  if (vec_x) {
    banded_spmm_kernel<T, kVecA, true><<<grid, kThreads, 0, stream>>>(
        blocks, los, x, out, rows, rb, w, n, f, round_x);
  } else {
    banded_spmm_kernel<T, kVecA, false><<<grid, kThreads, 0, stream>>>(
        blocks, los, x, out, rows, rb, w, n, f, round_x);
  }
}

template <typename T>
void launch_a(const T* blocks, const int32_t* los, const float* x, float* out, int64_t rows,
            int rb, int w, int64_t n, int f, int round_x, bool vec_x, dim3 grid,
            cudaStream_t stream) {
  // 16-byte groups need whole groups per row and an aligned pack
  const bool vec_a = w % Entries<T>::kE == 0 && reinterpret_cast<uintptr_t>(blocks) % 16 == 0;
  if (vec_a) {
    launch_x<T, true>(blocks, los, x, out, rows, rb, w, n, f, round_x, vec_x, grid, stream);
  } else {
    launch_x<T, false>(blocks, los, x, out, rows, rb, w, n, f, round_x, vec_x, grid, stream);
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
  const int64_t rows = static_cast<int64_t>(nb) * rb;
  const int64_t grid_x = (rows + kWarps - 1) / kWarps;
  if (grid_x > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(grid_x));
  const bool vec_x = f % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (blocks_bf16) {
    launch_a(static_cast<const __nv_bfloat16*>(blocks), los, x, out, rows, rb, w, n, f, round_x,
           vec_x, grid, stream);
  } else {
    launch_a(static_cast<const float*>(blocks), los, x, out, rows, rb, w, n, f, round_x, vec_x,
           grid, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
