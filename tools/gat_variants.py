#!/usr/bin/env python3
"""Time variants of the GAT attention kernels, and the design that would
reuse the hybrid SpMM's kernels, on one NVIDIA GPU.

    python3 tools/gat_variants.py [--seed N] [--variants NAME,NAME,...]
                                  [--parts attention,scores]

Builds ``ssrg_torch/csrc/gat_attention.cu`` as it stands and once for each
entry of ``VARIANTS`` with one of its ``constexpr`` constants changed: the
entries of a group's segment (``kSeg``), the rows a lane requests before it
adds any (``kBatch``) and the warps of a block (``kWarps``). All ``nvcc``
processes start together; the libraries go to
``ssrg_torch/build/gat_variants/``.

Then it draws the ``gat-products-fullbatch`` cell's graph from ``--seed``
(``portbench/configs/gat-products.json``: ogbn-products' 2,449,029 nodes and
61,859,140 edges on the benchmark's power-law rule), lists ``A`` with one
self-loop a node sorted by row (the attention listing; symmetric, so it is
its own transposed listing), and at the cell's head widths, 4 heads of 128
(float4 lanes) and 4 of 47 (scalar lanes), times every variant's four steps
(``softmax_stats``, ``aggregate``, ``rowdot``, ``backward``) through the
wrappers in turns (each round in order, the next in reverse), each held to
the source's outputs, and each step's plain version once. Beside them, the
design that reuses the hybrid
SpMM's kernels: alpha formed as ``[E, H]`` from the same statistics (torch),
an ELL pack of the first W entries of each row (W the p95 degree rounded up
to 8, as ``build_hybrid``) and a COO tail of the rest, alpha as their values,
and per head the ELL kernel and the COO tail kernel on a contiguous copy of
the head's z; its kernels' time, the time of forming alpha and of the
copies, each apart.

Then the scores (``gat_scores``: ``scores`` forward, ``score_grad``
backward) on a z of the cell's rows at each width, each held to the
source's outputs and timed in turns: the source (one warp a row, a row read
once, a grid of the blocks the card keeps resident); one group of lanes a row and head
(``BY_HEAD_CU``, a head a grid row, as the attention kernels cut their
tiles); and where the scores' ``dz`` goes: (a) written on its own and added
to the attention's ``dz`` as autograd adds it, against (b) added into the
attention's ``dz`` in place (the source with ``add_chunk`` in place of its
store). Beside them the scores as PyTorch's products and sums, forward and
autograd's backward with its adds into ``dz``.

Prints a JSON line per build and per width, then the card's name and power
limit. Without a CUDA card it exits 2.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402

VARIANTS = (  # (name, the constants changed from the source's)
    ("source", {}),
    ("kBatch=2", {"kBatch": 2}),
    ("kBatch=8", {"kBatch": 8}),
    ("kSeg=128", {"kSeg": 128}),
    ("kSeg=512", {"kSeg": 512}),
    ("kWarps=8", {"kWarps": 8}),
)
ROUNDS = 2
SHAPES = ((4, 128), (4, 47))  # (heads, head width): the hidden layers', the last layer's
CONFIG = os.path.join(ROOT, "portbench", "configs", "gat-products.json")
SLOPE = 0.2


# the scores' dz added into the attention's in place, for the source's
# gat_score_grad_kernel in place of its store (design (b))
ADD_CHUNK = """
template <int kE, bool kVec>
__device__ __forceinline__ void add_chunk(float* __restrict__ x, int lane, int len,
                                          const float (&v)[kE]) {
  float w[kE];
  load_chunk<kE, kVec>(x, lane, len, w);
#pragma unroll
  for (int j = 0; j < kE; ++j) w[j] += v[j];
  store_chunk<kE, kVec>(x, lane, len, w);
}

"""

# the scores with one group of kG lanes a row and head, the head on the grid's
# y (as the attention kernels cut their tiles), with the source's C entries
BY_HEAD_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
namespace {
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

template <int kG, bool kVec, int kQ>
__device__ __forceinline__ void load_head(const float* __restrict__ x, int gl, int c, bool valid,
                                          float (&v)[4 * kQ]) {
  if (kVec) {
#pragma unroll
    for (int p = 0; p < kQ; ++p) {
      const int i = kG * p + gl;
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (valid && 4 * i < c) t = __ldcs(reinterpret_cast<const float4*>(x) + i);
      v[4 * p] = t.x; v[4 * p + 1] = t.y; v[4 * p + 2] = t.z; v[4 * p + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4 * kQ; ++k) {
      const int i = gl + kG * k;
      v[k] = (valid && i < c) ? __ldcs(x + i) : 0.f;
    }
  }
}

template <int kG, bool kVec, int kQ>
__device__ __forceinline__ void store_head(float* __restrict__ x, int gl, int c, bool valid,
                                           const float (&v)[4 * kQ]) {
  if (!valid) return;
  if (kVec) {
#pragma unroll
    for (int p = 0; p < kQ; ++p) {
      const int i = kG * p + gl;
      if (4 * i < c) {
        __stcs(reinterpret_cast<float4*>(x) + i,
               make_float4(v[4 * p], v[4 * p + 1], v[4 * p + 2], v[4 * p + 3]));
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4 * kQ; ++k) {
      const int i = gl + kG * k;
      if (i < c) __stcs(x + i, v[k]);
    }
  }
}

template <int kG, bool kVec, int kQ>
__global__ void __launch_bounds__(kThreads)
scores_by_head(const float* __restrict__ z, const float* __restrict__ a_src,
               const float* __restrict__ a_dst, float* __restrict__ s_src,
               float* __restrict__ s_dst, int64_t n, int heads, int c) {
  constexpr int kR = 32 / kG;
  const int lane = threadIdx.x & 31, gl = lane % kG, grp = lane / kG;
  const int h = blockIdx.y;
  float ws[4 * kQ], wd[4 * kQ];
  load_head<kG, kVec, kQ>(a_src + static_cast<int64_t>(h) * c, gl, c, true, ws);
  load_head<kG, kVec, kQ>(a_dst + static_cast<int64_t>(h) * c, gl, c, true, wd);
  const int64_t stride = static_cast<int64_t>(heads) * c;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarps * kR;
  for (int64_t i0 = (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * kR;
       i0 < n; i0 += step) {
    const int64_t i = i0 + grp;
    const bool valid = i < n;
    float v[4 * kQ];
    load_head<kG, kVec, kQ>(z + i * stride + static_cast<int64_t>(h) * c, gl, c, valid, v);
    float s = 0.f, d = 0.f;
#pragma unroll
    for (int k = 0; k < 4 * kQ; ++k) {
      s = fmaf(v[k], ws[k], s);
      d = fmaf(v[k], wd[k], d);
    }
#pragma unroll
    for (int o = kG / 2; o > 0; o >>= 1) {
      s += __shfl_xor_sync(kFull, s, o);
      d += __shfl_xor_sync(kFull, d, o);
    }
    if (valid && gl == 0) {
      s_src[i * heads + h] = s;
      s_dst[i * heads + h] = d;
    }
  }
}

template <int kG, bool kVec, int kQ>
__global__ void __launch_bounds__(kThreads)
score_grad_by_head(const float* __restrict__ z, const float* __restrict__ a_src,
                   const float* __restrict__ a_dst, const float* __restrict__ ds_src,
                   const float* __restrict__ ds_dst, float* __restrict__ dz,
                   float* __restrict__ part, int64_t n, int heads, int c) {
  constexpr int kR = 32 / kG;
  constexpr int kL = 4 * kQ;
  __shared__ float sums[kWarps][2][kG * kL];
  const int lane = threadIdx.x & 31, gl = lane % kG, grp = lane / kG, warp = threadIdx.x >> 5;
  const int h = blockIdx.y;
  float ws[kL], wd[kL], gs[kL], gd[kL];
  load_head<kG, kVec, kQ>(a_src + static_cast<int64_t>(h) * c, gl, c, true, ws);
  load_head<kG, kVec, kQ>(a_dst + static_cast<int64_t>(h) * c, gl, c, true, wd);
#pragma unroll
  for (int k = 0; k < kL; ++k) gs[k] = gd[k] = 0.f;
  const int64_t stride = static_cast<int64_t>(heads) * c;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarps * kR;
  for (int64_t i0 = (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * kR; i0 < n; i0 += step) {
    const int64_t i = i0 + grp;
    const bool valid = i < n;
    const float s = valid ? __ldcs(ds_src + i * heads + h) : 0.f;
    const float d = valid ? __ldcs(ds_dst + i * heads + h) : 0.f;
    float v[kL];
    load_head<kG, kVec, kQ>(z + i * stride + static_cast<int64_t>(h) * c, gl, c, valid, v);
#pragma unroll
    for (int k = 0; k < kL; ++k) {
      gs[k] = fmaf(s, v[k], gs[k]);
      gd[k] = fmaf(d, v[k], gd[k]);
      v[k] = fmaf(s, ws[k], d * wd[k]);
    }
    store_head<kG, kVec, kQ>(dz + i * stride + static_cast<int64_t>(h) * c, gl, c, valid, v);
  }
  // the warp's groups hold the same features: sum them, then the block's warps
#pragma unroll
  for (int k = 0; k < kL; ++k) {
#pragma unroll
    for (int o = kG; o < 32; o <<= 1) {
      gs[k] += __shfl_xor_sync(kFull, gs[k], o);
      gd[k] += __shfl_xor_sync(kFull, gd[k], o);
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int k = 0; k < kL; ++k) {
      const int f = kVec ? 4 * (kG * (k / 4) + gl) + k % 4 : gl + kG * k;
      sums[warp][0][f] = gs[k];
      sums[warp][1][f] = gd[k];
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 2 * c; t += kThreads) {
    const int which = t < c ? 0 : 1, f = t - which * c;
    float acc = sums[0][which][f];
    for (int w = 1; w < kWarps; ++w) acc += sums[w][which][f];
    part[(2 * static_cast<int64_t>(blockIdx.x) + which) * stride + static_cast<int64_t>(h) * c + f] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
score_sum(const float* __restrict__ part, float* __restrict__ da_src, float* __restrict__ da_dst,
          int blocks, int64_t width) {
  __shared__ float sums[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * 32 + lane;
  const bool valid = t < 2 * width;
  float acc = 0.f;
  if (valid) {
    for (int b = warp; b < blocks; b += kWarps) acc += __ldcs(part + 2 * width * b + t);
  }
  sums[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && valid) {
    for (int w = 1; w < kWarps; ++w) acc += sums[w][lane];
    if (t < width) da_src[t] = acc; else da_dst[t - width] = acc;
  }
}

// blocks on x, heads on y: as many as the card keeps resident, at most cap on x
template <typename Kernel>
int resident(Kernel kernel, int64_t n, int heads, int64_t cap, int rows_per_block) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  int64_t b = static_cast<int64_t>(sms) * per_sm / heads;
  if (b > (n + rows_per_block - 1) / rows_per_block) b = (n + rows_per_block - 1) / rows_per_block;
  if (b > cap) b = cap;
  return b < 1 ? 1 : static_cast<int>(b);
}

template <int kG, int kQ>
int launch(const float* z, const float* a_src, const float* a_dst, const float* ds_src,
           const float* ds_dst, float* s_src, float* s_dst, float* dz, float* part,
           int64_t n, int heads, int c, bool vec, int cap, int* blocks, cudaStream_t stream) {
  const int rows = kWarps * (32 / kG);
  if (dz == nullptr) {
    *blocks = vec ? resident(scores_by_head<kG, true, kQ>, n, heads, cap, rows)
                  : resident(scores_by_head<kG, false, kQ>, n, heads, cap, rows);
  } else {
    *blocks = vec ? resident(score_grad_by_head<kG, true, kQ>, n, heads, cap, rows)
                  : resident(score_grad_by_head<kG, false, kQ>, n, heads, cap, rows);
  }
  dim3 grid(*blocks, heads);
  if (dz == nullptr) {
    if (vec) scores_by_head<kG, true, kQ><<<grid, kThreads, 0, stream>>>(z, a_src, a_dst, s_src, s_dst, n, heads, c);
    else scores_by_head<kG, false, kQ><<<grid, kThreads, 0, stream>>>(z, a_src, a_dst, s_src, s_dst, n, heads, c);
  } else {
    if (vec) score_grad_by_head<kG, true, kQ><<<grid, kThreads, 0, stream>>>(z, a_src, a_dst, ds_src, ds_dst, dz, part, n, heads, c);
    else score_grad_by_head<kG, false, kQ><<<grid, kThreads, 0, stream>>>(z, a_src, a_dst, ds_src, ds_dst, dz, part, n, heads, c);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const float* z, const float* a_src, const float* a_dst, const float* ds_src,
             const float* ds_dst, float* s_src, float* s_dst, float* dz, float* part,
             int64_t n, int heads, int c, int aligned, int cap, int* b, cudaStream_t stream) {
  const bool v = aligned != 0 && c % 4 == 0;
  if (c <= 32) return launch<8, 1>(z, a_src, a_dst, ds_src, ds_dst, s_src, s_dst, dz, part, n, heads, c, v, cap, b, stream);
  if (c <= 64) return launch<16, 1>(z, a_src, a_dst, ds_src, ds_dst, s_src, s_dst, dz, part, n, heads, c, v, cap, b, stream);
  if (c <= 128) return launch<32, 1>(z, a_src, a_dst, ds_src, ds_dst, s_src, s_dst, dz, part, n, heads, c, v, cap, b, stream);
  if (c <= 256) return launch<32, 2>(z, a_src, a_dst, ds_src, ds_dst, s_src, s_dst, dz, part, n, heads, c, v, cap, b, stream);
  if (c <= 512) return launch<32, 4>(z, a_src, a_dst, ds_src, ds_dst, s_src, s_dst, dz, part, n, heads, c, v, cap, b, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
}  // namespace

extern "C" int gat_scores_f32(const float* z, const float* a_src, const float* a_dst,
                              float* s_src, float* s_dst, int64_t n, int heads, int c,
                              int aligned, cudaStream_t stream) {
  int blocks = 0;
  return dispatch(z, a_src, a_dst, nullptr, nullptr, s_src, s_dst, nullptr, nullptr, n, heads,
                  c, aligned, 0x7fffffff, &blocks, stream);
}

extern "C" int gat_score_grad_f32(const float* z, const float* a_src, const float* a_dst,
                                  const float* ds_src, const float* ds_dst, float* dz,
                                  float* part, int part_rows, float* da_src, float* da_dst,
                                  int64_t n, int heads, int c, int aligned,
                                  cudaStream_t stream) {
  int blocks = 0;
  const int err = dispatch(z, a_src, a_dst, ds_src, ds_dst, nullptr, nullptr, dz, part, n,
                           heads, c, aligned, part_rows, &blocks, stream);
  if (err != 0) return err;
  const int64_t width = static_cast<int64_t>(heads) * c;
  score_sum<<<static_cast<unsigned>((2 * width + 31) / 32), kThreads, 0, stream>>>(
      part, da_src, da_dst, blocks, width);
  return static_cast<int>(cudaGetLastError());
}
"""

SCORE_SOURCES = ("by_head", "add_into")  # the score designs built beside the source
SCORE_ENTRIES = ("gat_scores_f32", "gat_score_grad_f32")


def score_source(name: str, text: str) -> str:
    """The source of a score design: ``by_head`` its own file, ``add_into``
    the source with ``add_chunk`` in place of the gradient's store."""
    if name == "by_head":
        return BY_HEAD_CU
    anchor = "// The warp's chunk, heads [h0, h0 + hc) of every row"
    store = "store_chunk<kE, kVec>(dz + i * ch.stride + ch.off, lane, ch.len, v);"
    smoke.check(text.count(anchor) == 1 and text.count(store) == 1,
                "gat_attention.cu: the scores' anchors are not where add_into expects them")
    text = text.replace(anchor, ADD_CHUNK + anchor)
    return text.replace(store, store.replace("store_chunk", "add_chunk"))


def variant_source(text: str, changes: dict) -> str:
    for const, value in changes.items():
        text, n = re.subn(rf"constexpr int {const} = \d+;", f"constexpr int {const} = {value};",
                          text)
        smoke.check(n == 1, f"gat_attention.cu has no single 'constexpr int {const} = ...;'")
    return text


def build_variants(names) -> dict:
    """Every variant's library of ``names``, loaded and declared, by name."""
    from ssrg_torch.ops import _nvcc
    from ssrg_torch.ops import gat_attention as ga

    out_dir = os.path.join(_nvcc.BUILD_DIR, "gat_variants")
    os.makedirs(out_dir, exist_ok=True)
    with open(_nvcc.source(ga.NAME)) as f:
        text = f.read()
    procs = {}
    for name, changes in VARIANTS:
        if name not in names:
            continue
        stem = os.path.join(out_dir, re.sub(r"\W", "_", name))
        with open(f"{stem}.cu", "w") as f:
            f.write(variant_source(text, changes))
        cmd = [_nvcc.nvcc(), *_nvcc.NVCC_FLAGS, "-Xptxas=-v", "-o", f"{stem}.so", f"{stem}.cu"]
        procs[name] = (f"{stem}.so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        out, err = proc.communicate()
        smoke.check(proc.returncode == 0, f"nvcc failed for {name}:\n{err}")
        smoke.emit({"phase": "build", "variant": name,
                    "ptxas": [ln.strip() for ln in (out + err).splitlines()
                              if "registers" in ln and ("aggregate" in ln or "backward" in ln
                                                        or "Used" in ln)][:40]})
        libs[name] = ctypes.CDLL(path)
        ga._declare(libs[name])
    return libs


def use(lib) -> None:
    """Make the wrappers launch ``lib``'s kernels."""
    from ssrg_torch.ops import _nvcc
    from ssrg_torch.ops import gat_attention as ga

    _nvcc._libs[ga.NAME] = lib


def cell_listing(seed: int):
    """The cell's attention listing on the card: ``(row, col)`` int32 of
    ``A + I`` sorted by row, and the node count."""
    import torch

    from portbench.graphs import make_graph

    with open(CONFIG) as f:
        cfg = json.load(f)
    data = make_graph(cfg["dataset"], cfg["graph"], seed, "cuda")
    n = data.num_nodes
    loops = torch.arange(n, device="cuda")
    key = torch.sort(torch.cat([data.lo * n + data.hi, data.hi * n + data.lo,
                                loops * n + loops])).values
    del data, loops
    row, col = (key // n).int(), (key % n).int()
    del key
    torch.cuda.empty_cache()
    return row, col, n


def steps(row, col, s_src, s_dst, z, g):
    """The four steps of a forward and a backward pass, as callables, with
    the forward's outputs the backward takes."""
    from ssrg_torch.ops import gat_attention as ga

    nnz = int(row.numel())
    m, l = ga.softmax_stats(row, col, s_src, s_dst, nnz, SLOPE)
    out = ga.aggregate(row, col, s_src, s_dst, m, l, z, nnz, SLOPE)
    q = ga.rowdot(g, out, s_dst, m, l)
    return {
        "stats": lambda: ga.softmax_stats(row, col, s_src, s_dst, nnz, SLOPE),
        "aggregate": lambda: ga.aggregate(row, col, s_src, s_dst, m, l, z, nnz, SLOPE),
        "rowdot": lambda: ga.rowdot(g, out, s_dst, m, l),
        "backward": lambda: ga.backward(row, col, q, s_src, z, g, nnz, SLOPE),
    }, (m, l, out, q)


def plain_ms(row, col, s_src, s_dst, z, g, m, l, out, q) -> dict:
    """Each step's plain version (``ops/gat_attention.py``, chunked torch) on
    the card, one timed call after one warm-up."""
    from ssrg_torch.ops import gat_attention as ga

    nnz = int(row.numel())
    steps = {
        "stats": lambda: ga.softmax_stats_plain(row, col, s_src, s_dst, nnz, SLOPE),
        "aggregate": lambda: ga.aggregate_plain(row, col, s_src, s_dst, m, l, z, nnz, SLOPE),
        "rowdot": lambda: ga.rowdot_plain(g, out, s_dst, m, l),
        "backward": lambda: ga.backward_plain(row, col, q, s_src, z, g, nnz, SLOPE),
    }
    return {name: smoke.cuda_ms(fn, iters=1, warmup=1) for name, fn in steps.items()}


def reuse_design(row, col, n: int, s_src, s_dst, m, l, z, want):
    """The aggregation on the ELL kernel and the COO tail kernel, alpha as
    their values, one head at a time: its times and its largest gap to the
    fused kernel's output ``want`` over ``want``'s largest value."""
    import torch

    from ssrg_torch.ops.coo_spmm import coo_accumulate
    from ssrg_torch.ops.ell_spmm import ell_spmm

    h, c = z.shape[1], z.shape[2]
    r, cl = row.long(), col.long()
    deg = torch.bincount(r, minlength=n)
    width = int(torch.quantile(deg.double(), 0.95, interpolation="lower"))
    width = -(-max(width, 1) // 8) * 8
    start = torch.zeros(n + 1, dtype=torch.int64, device="cuda")
    start[1:] = torch.cumsum(deg, 0)
    pos = torch.arange(r.numel(), device="cuda") - start[r]
    in_ell = pos < width
    n_pad = -(-n // 256) * 256
    slot = r[in_ell] * width + pos[in_ell]
    cols = torch.zeros(n_pad * width, dtype=torch.int32, device="cuda")
    cols[slot] = col[in_ell]
    cols = cols.view(n_pad, width)
    t_row, t_col = row[~in_ell].contiguous(), col[~in_ell].contiguous()

    def alpha():
        a = torch.nn.functional.leaky_relu(s_dst[r] + s_src[cl], SLOPE)
        return torch.exp(a - m[r]) / l[r]

    alpha_ms = smoke.cuda_ms(alpha, iters=3, warmup=1)
    al = alpha()
    vals = []
    for k in range(h):
        v = torch.zeros(n_pad * width, dtype=torch.float32, device="cuda")
        v[slot] = al[in_ell, k]
        vals.append((v.view(n_pad, width), al[~in_ell, k].contiguous()))
    del al
    z_heads = [z[:, k].contiguous() for k in range(h)]

    def spmm():
        outs = []
        for k in range(h):
            o = ell_spmm(cols, vals[k][0], z_heads[k])[:n]
            coo_accumulate(t_row, t_col, vals[k][1], z_heads[k], o)
            outs.append(o)
        return outs

    outs = spmm()
    gap = max(float((outs[k] - want[:, k]).abs().max()) for k in range(h))
    gap /= float(want.abs().max())
    del outs
    spmm_ms = smoke.cuda_ms(spmm, iters=3, warmup=1)
    copies_ms = smoke.cuda_ms(lambda: [z[:, k].contiguous() for k in range(h)], iters=3,
                              warmup=1)
    return {"ell_width": width, "tail_entries": int(t_row.numel()), "alpha_ms": alpha_ms,
            "spmm_ms": spmm_ms, "head_copies_ms": copies_ms, "gap_to_fused": gap}


def measure(row, col, n: int, h: int, c: int, libs: dict, seed: int) -> dict:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    z = torch.randn((n, h, c), generator=gen, device="cuda")
    s_src = torch.randn((n, h), generator=gen, device="cuda")
    s_dst = torch.randn((n, h), generator=gen, device="cuda")
    g = torch.randn((n, h, c), generator=gen, device="cuda")
    use(libs["source"])
    fns, (m, l, out, q) = steps(row, col, s_src, s_dst, z, g)
    want_bwd = fns["backward"]()
    gaps = {}
    for variant, lib in libs.items():
        use(lib)
        got_out = fns["aggregate"]()
        got_bwd = fns["backward"]()
        torch.cuda.synchronize()
        gaps[variant] = max(
            float((got_out - out).abs().max()) / float(out.abs().max()),
            *(float((a - b).abs().max()) / float(b.abs().max())
              for a, b in zip(got_bwd, want_bwd)))
        smoke.check(gaps[variant] <= 1e-4, f"{variant}: off the source by {gaps[variant]}")
        del got_out, got_bwd
    del want_bwd
    torch.cuda.empty_cache()
    ms = {v: {step: [] for step in fns} for v in libs}
    order = list(libs)
    for rnd in range(ROUNDS):
        for variant in (order if rnd % 2 == 0 else order[::-1]):
            use(libs[variant])
            for step, fn in fns.items():
                ms[variant][step].append(smoke.cuda_ms(fn, iters=5, warmup=1))
    use(libs["source"])
    plain = plain_ms(row, col, s_src, s_dst, z, g, m, l, out, q)
    reuse = reuse_design(row, col, n, s_src, s_dst, m, l, z, out)
    mean = {v: {s: sum(t) / len(t) for s, t in by.items()} for v, by in ms.items()}
    e = int(row.numel())
    return {"phase": "variants", "heads": h, "head_width": c, "n": n, "entries": e,
            "gap_to_source": gaps, "ms": ms, "ms_mean": mean, "plain_ms": plain,
            "reuse_hybrid_kernels": reuse,
            "gather_bytes": e * h * c * 4,
            "aggregate_gather_gb_per_s": e * h * c * 4 / mean["source"]["aggregate"] / 1e6,
            "backward_gather_gb_per_s": e * h * c * 4 / mean["source"]["backward"] / 1e6}


def build_scores() -> dict:
    """The score designs' libraries, declared for the score entries, by name;
    ``source`` is the kernels' own library."""
    from ssrg_torch.ops import _nvcc
    from ssrg_torch.ops import gat_attention as ga

    out_dir = os.path.join(_nvcc.BUILD_DIR, "gat_variants")
    os.makedirs(out_dir, exist_ok=True)
    with open(_nvcc.source(ga.NAME)) as f:
        text = f.read()
    procs = {}
    for name in SCORE_SOURCES:
        stem = os.path.join(out_dir, f"scores_{name}")
        with open(f"{stem}.cu", "w") as f:
            f.write(score_source(name, text))
        cmd = [_nvcc.nvcc(), *_nvcc.NVCC_FLAGS, "-Xptxas=-v", "-o", f"{stem}.so", f"{stem}.cu"]
        procs[name] = (f"{stem}.so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {"source": ga._lib()}
    for name, (path, proc) in procs.items():
        out, err = proc.communicate()
        smoke.check(proc.returncode == 0, f"nvcc failed for {name}:\n{err}")
        lines = (out + err).splitlines()
        smoke.emit({"phase": "build", "variant": f"scores {name}",
                    "ptxas": [f"{a.strip()} {b.strip()}" for a, b in zip(lines, lines[1:])
                              if "score" in a and "registers" in b][:12]})
        libs[name] = ctypes.CDLL(path)
        ga._declare(libs[name], SCORE_ENTRIES)
    return libs


def score_grad_into(lib, z, a_src, a_dst, ds_src, ds_dst, dz):
    """Design (b): ``lib``'s gradient (``add_into``) adds the scores' share
    into ``dz`` in place; ``(dz, da_src, da_dst)``."""
    import torch

    from ssrg_torch.ops import _nvcc
    from ssrg_torch.ops import gat_attention as ga

    n, h, c = z.shape
    rows = ga._score_part_rows(z.device)
    part = torch.empty((rows, 2, h * c), dtype=torch.float32, device=z.device)
    da_src, da_dst = torch.empty_like(a_src), torch.empty_like(a_dst)
    _nvcc.check_launch(ga.NAME, lib.gat_score_grad_f32(
        z.data_ptr(), a_src.data_ptr(), a_dst.data_ptr(), ds_src.data_ptr(), ds_dst.data_ptr(),
        dz.data_ptr(), part.data_ptr(), rows, da_src.data_ptr(), da_dst.data_ptr(), n, h, c, 1,
        _nvcc.stream_of(z)))
    return dz, da_src, da_dst


def measure_scores(n: int, h: int, c: int, libs: dict, seed: int) -> dict:
    """Every score design on a random z of ``n`` rows, ``h`` heads of ``c``,
    held to the source's outputs and timed in turns, beside the scores as
    PyTorch's products and sums."""
    import torch

    from ssrg_torch.ops import _nvcc
    from ssrg_torch.ops import gat_attention as ga

    gen = torch.Generator(device="cuda").manual_seed(seed)
    z = torch.randn((n, h, c), generator=gen, device="cuda")
    a_src = torch.randn((1, h, c), generator=gen, device="cuda")
    a_dst = torch.randn((1, h, c), generator=gen, device="cuda")
    ds_src = torch.randn((n, h), generator=gen, device="cuda")
    ds_dst = torch.randn((n, h), generator=gen, device="cuda")
    dz_attn = torch.randn((n, h, c), generator=gen, device="cuda")

    def on(lib: str, fn):
        def call():
            _nvcc._libs[ga.NAME] = libs[lib]
            return fn()
        return call

    def torch_backward():
        zl, al, dl = (t.detach().requires_grad_(True) for t in (z, a_src, a_dst))
        s = ((zl * al).sum(-1), (zl * dl).sum(-1))
        grads = torch.autograd.grad(s, (zl, al, dl), (ds_src, ds_dst))
        return (dz_attn + grads[0], *grads[1:])

    grad = lambda: ga.score_grad(z, a_src, a_dst, ds_src, ds_dst)  # noqa: E731
    into = torch.empty_like(dz_attn)
    added = lambda g: (dz_attn + g[0], *g[1:])  # noqa: E731
    forward = {"source": on("source", lambda: ga.scores(z, a_src, a_dst)),
               "by_head": on("by_head", lambda: ga.scores(z, a_src, a_dst)),
               "torch": lambda: ga.scores_plain(z, a_src, a_dst)}
    backward = {  # each with the scores' dz added to the attention's
        "a_source": on("source", lambda: added(grad())),
        "a_by_head": on("by_head", lambda: added(grad())),
        "b_add_into": lambda: score_grad_into(libs["add_into"], z, a_src, a_dst, ds_src,
                                              ds_dst, into.copy_(dz_attn)),
        "torch": torch_backward}
    want_f = forward["source"]()
    want_b = backward["a_source"]()
    gaps = {}
    for kind, fns, want in (("forward", forward, want_f), ("backward", backward, want_b)):
        for name, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            gaps[f"{kind} {name}"] = max(float((a - b).abs().max()) / float(b.abs().max())
                                         for a, b in zip(got, want))
            smoke.check(gaps[f"{kind} {name}"] <= 1e-5,
                        f"scores {kind} {name}: off the source by {gaps[f'{kind} {name}']}")
            del got
    del want_f, want_b
    # (b) times its copy of the attention's dz, (a) its add: time each alone
    # too, and the gradient's kernels alone
    backward["b_copy_only"] = lambda: into.copy_(dz_attn)
    backward["a_add_only"] = lambda: dz_attn + into
    backward["source_kernels_only"] = on("source", grad)
    backward["by_head_kernels_only"] = on("by_head", grad)
    ms = {f"{kind} {name}": [] for kind, fns in (("forward", forward), ("backward", backward))
          for name in fns}
    order = list(ms)
    for rnd in range(ROUNDS):
        for key in (order if rnd % 2 == 0 else order[::-1]):
            kind, name = key.split(" ")
            fn = (forward if kind == "forward" else backward)[name]
            ms[key].append(smoke.cuda_ms(fn, iters=5, warmup=1))
    _nvcc._libs[ga.NAME] = libs["source"]
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    f32, nhc = 4, n * h * c
    return {"phase": "scores", "heads": h, "head_width": c, "n": n, "gap_to_source": gaps,
            "ms": ms, "ms_mean": mean,
            # compulsory bytes over 3.35 TB/s: forward z once and both scores;
            # backward z and dz, and (a) the add's two reads and its write
            "bound_ms": {"forward": f32 * (nhc + 2 * n * h) / 3.35e9,
                         "backward_kernel": f32 * (2 * nhc + 2 * n * h) / 3.35e9,
                         "backward_add": f32 * 3 * nhc / 3.35e9}}


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--variants", default=",".join(name for name, _ in VARIANTS))
    parser.add_argument("--parts", default="attention,scores",
                        help="attention: the attention's steps on the cell's listing; "
                             "scores: the score designs on a z of the cell's rows")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("gat_variants: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    parts = args.parts.split(",")
    if "attention" in parts:
        names = args.variants.split(",")
        smoke.check("source" in names, "the variants are held to 'source': name it")
        libs = build_variants(names)
        row, col, n = cell_listing(args.seed)
        smoke.emit({"phase": "listing", "seed": args.seed, "n": n, "entries": int(row.numel())})
        for h, c in SHAPES:
            smoke.emit(measure(row, col, n, h, c, libs, args.seed))
            torch.cuda.empty_cache()
        del row, col, libs
        torch.cuda.empty_cache()
    if "scores" in parts:
        with open(CONFIG) as f:
            n = json.load(f)["dataset"]["num_nodes"]
        libs = build_scores()
        for h, c in SHAPES:
            smoke.emit(measure_scores(n, h, c, libs, args.seed))
            torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(" | ".join(ln.strip() for ln in smi.stdout.splitlines() if ln.strip()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
