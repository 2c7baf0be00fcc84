// graphbuild.cpp — the port's host graph-construction library.
//
// Host code, not a device kernel: the port's own copy of the JAX package's
// OpenMP graph builder (the library behind ssrg_tpu/native.py), with the same
// entry points and the same results. It carries the O(E) host work that feeds
// the card: edge-list symmetrization and coalescing, CSR construction,
// degrees and normalization weights, ELL/hybrid packing, symmetric degree
// accumulation, and the label propagation behind the tiled engine's cluster
// order.
//
// Every entry point is extern "C", works on caller-allocated numpy buffers
// and parallelizes with OpenMP. ssrg_torch/ops/_nvcc.py::build_host compiles
// it at first use with `c++ -O3 -fPIC -fopenmp -std=c++17 -shared` into
// ssrg_torch/build/libgraphbuild.so; ssrg_torch/native.py binds it.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Edge64 {
  uint64_t key;  // row * n + col
  float w;
};

}  // namespace

extern "C" {

// Sort (row, col, w) lexicographically by (row, col) and sum duplicate
// entries (in double). Returns the number of unique edges written to the out
// arrays (caller allocates out arrays of size nnz).
int64_t coalesce_edges(const int64_t* rows, const int64_t* cols,
                       const float* weights, int64_t nnz, int64_t num_nodes,
                       int64_t* out_rows, int64_t* out_cols, float* out_w) {
  if (nnz == 0) return 0;
  std::vector<Edge64> edges(nnz);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < nnz; ++i) {
    edges[i].key =
        static_cast<uint64_t>(rows[i]) * static_cast<uint64_t>(num_nodes) +
        static_cast<uint64_t>(cols[i]);
    edges[i].w = weights ? weights[i] : 1.0f;
  }
  std::sort(edges.begin(), edges.end(),
            [](const Edge64& a, const Edge64& b) { return a.key < b.key; });
  int64_t m = 0;
  uint64_t cur = edges[0].key;
  double acc = edges[0].w;
  for (int64_t i = 1; i < nnz; ++i) {
    if (edges[i].key == cur) {
      acc += edges[i].w;
    } else {
      out_rows[m] = static_cast<int64_t>(cur / num_nodes);
      out_cols[m] = static_cast<int64_t>(cur % num_nodes);
      out_w[m] = static_cast<float>(acc);
      ++m;
      cur = edges[i].key;
      acc = edges[i].w;
    }
  }
  out_rows[m] = static_cast<int64_t>(cur / num_nodes);
  out_cols[m] = static_cast<int64_t>(cur % num_nodes);
  out_w[m] = static_cast<float>(acc);
  return m + 1;
}

// Symmetrize a (possibly half-directed) edge list: emit both directions,
// coalesce duplicates (min-clamp weights to 1 for unweighted graphs when
// clamp_unit != 0), drop self loops. Caller allocates out arrays of size
// 2 * nnz. Returns the unique symmetric edge count; the edges come out
// sorted by (row, col).
int64_t symmetrize_edges(const int64_t* rows, const int64_t* cols,
                         const float* weights, int64_t nnz, int64_t num_nodes,
                         int clamp_unit, int64_t* out_rows, int64_t* out_cols,
                         float* out_w) {
  if (nnz == 0) return 0;
  std::vector<int64_t> r2(2 * nnz), c2(2 * nnz);
  std::vector<float> w2(2 * nnz);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < nnz; ++i) {
    r2[i] = rows[i];
    c2[i] = cols[i];
    w2[i] = weights ? weights[i] : 1.0f;
    r2[nnz + i] = cols[i];
    c2[nnz + i] = rows[i];
    w2[nnz + i] = weights ? weights[i] : 1.0f;
  }
  int64_t m = coalesce_edges(r2.data(), c2.data(), w2.data(), 2 * nnz,
                             num_nodes, out_rows, out_cols, out_w);
  // drop self loops, clamp weights
  int64_t k = 0;
  for (int64_t i = 0; i < m; ++i) {
    if (out_rows[i] == out_cols[i]) continue;
    out_rows[k] = out_rows[i];
    out_cols[k] = out_cols[i];
    out_w[k] = clamp_unit ? std::min(out_w[i], 1.0f) : out_w[i];
    ++k;
  }
  return k;
}

// Build CSR from a row-sorted coalesced edge list.
void build_csr(const int64_t* rows, const int64_t* cols, const float* weights,
               int64_t nnz, int64_t num_nodes, int32_t* indptr,
               int32_t* indices, float* data) {
  std::memset(indptr, 0, sizeof(int32_t) * (num_nodes + 1));
  for (int64_t i = 0; i < nnz; ++i) indptr[rows[i] + 1]++;
  for (int64_t v = 0; v < num_nodes; ++v) indptr[v + 1] += indptr[v];
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < nnz; ++i) {
    indices[i] = static_cast<int32_t>(cols[i]);
    data[i] = weights ? weights[i] : 1.0f;
  }
}

// Degrees (weighted row sums, in double) of a CSR matrix.
void csr_degrees(const int32_t* indptr, const float* data, int64_t num_nodes,
                 double* deg) {
#pragma omp parallel for schedule(static)
  for (int64_t v = 0; v < num_nodes; ++v) {
    double acc = 0.0;
    for (int32_t j = indptr[v]; j < indptr[v + 1]; ++j) acc += data[j];
    deg[v] = acc;
  }
}

// Generalized symmetric normalization weights in place:
// data[j] <- deg[row]^(r-1) * data[j] * deg[col]^(-r), inf -> 0.
void sym_norm_weights(const int32_t* indptr, const int32_t* indices,
                      float* data, const double* deg, int64_t num_nodes,
                      double r) {
#pragma omp parallel for schedule(dynamic, 1024)
  for (int64_t v = 0; v < num_nodes; ++v) {
    double dl = std::pow(deg[v], r - 1.0);
    if (!std::isfinite(dl)) dl = 0.0;
    for (int32_t j = indptr[v]; j < indptr[v + 1]; ++j) {
      double dr = std::pow(deg[indices[j]], -r);
      if (!std::isfinite(dr)) dr = 0.0;
      data[j] = static_cast<float>(dl * data[j] * dr);
    }
  }
}

// Pack a CSR matrix into ELL (first `width` slots per row) + COO tail.
// Caller allocates ell_cols/ell_vals of size n_pad*width (zeroed) and tail
// arrays of size nnz. Returns the tail length. Each thread appends its rows'
// overflow as one run, so the tail comes out in thread order, each row's
// entries together and in CSR order: a stable sort by row gives row order.
int64_t ell_hybrid_pack(const int32_t* indptr, const int32_t* indices,
                        const float* data, int64_t num_nodes, int64_t width,
                        int64_t n_pad, int32_t* ell_cols, float* ell_vals,
                        int32_t* tail_rows, int32_t* tail_cols,
                        float* tail_vals) {
  std::atomic<int64_t> tail_len{0};
#pragma omp parallel
  {
    std::vector<int32_t> lr, lc;
    std::vector<float> lv;
#pragma omp for schedule(dynamic, 2048) nowait
    for (int64_t v = 0; v < num_nodes; ++v) {
      int32_t lo = indptr[v], hi = indptr[v + 1];
      int32_t take = std::min<int64_t>(hi - lo, width);
      for (int32_t k = 0; k < take; ++k) {
        ell_cols[v * width + k] = indices[lo + k];
        ell_vals[v * width + k] = data[lo + k];
      }
      for (int32_t j = lo + take; j < hi; ++j) {
        lr.push_back(static_cast<int32_t>(v));
        lc.push_back(indices[j]);
        lv.push_back(data[j]);
      }
    }
    int64_t off = tail_len.fetch_add(static_cast<int64_t>(lr.size()));
    std::memcpy(tail_rows + off, lr.data(), lr.size() * sizeof(int32_t));
    std::memcpy(tail_cols + off, lc.data(), lc.size() * sizeof(int32_t));
    std::memcpy(tail_vals + off, lv.data(), lv.size() * sizeof(float));
  }
  (void)n_pad;
  return tail_len.load();
}

// Accumulate symmetric degrees from a directed edge chunk: deg[src]++ and
// deg[dst]++ for every non-self-loop edge.
void edge_degree_accumulate(const int64_t* src, const int64_t* dst, int64_t e,
                            int64_t* deg) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < e; ++i) {
    if (src[i] == dst[i]) continue;
#pragma omp atomic
    deg[src[i]]++;
#pragma omp atomic
    deg[dst[i]]++;
  }
}

// Synchronous label propagation over an undirected CSR: the community
// detector behind the tiled engine's cluster order
// (ssrg_torch/ops/reorder.py::cluster_permutation). Each sweep gives every
// node the most frequent label among its neighbours (ties to the smallest
// label), reading the PREVIOUS sweep's labels: synchronous sweeps are
// deterministic, need no locks, and cannot let one label cascade across the
// graph in one sweep as in-place updates can. Stops once at most n / 1000
// labels change in a sweep, or after max_sweeps. These three rules make the
// labels bit-identical to the numpy version (native.py::lpa_cluster_plain).
// Returns the number of sweeps performed.
int64_t lpa_cluster(const int32_t* indptr, const int32_t* indices, int64_t n,
                    int32_t max_sweeps, int32_t* labels) {
#pragma omp parallel for schedule(static)
  for (int64_t v = 0; v < n; ++v) labels[v] = static_cast<int32_t>(v);
  std::vector<int32_t> prev(n);
  int64_t sweep = 0;
  for (; sweep < max_sweeps; ++sweep) {
    std::memcpy(prev.data(), labels, sizeof(int32_t) * n);
    std::atomic<int64_t> changed{0};
#pragma omp parallel
    {
      std::vector<int32_t> nl;
      int64_t local_changed = 0;
#pragma omp for schedule(dynamic, 4096) nowait
      for (int64_t v = 0; v < n; ++v) {
        const int32_t lo = indptr[v], hi = indptr[v + 1];
        if (hi == lo) continue;
        nl.resize(hi - lo);
        for (int32_t j = lo; j < hi; ++j) nl[j - lo] = prev[indices[j]];
        std::sort(nl.begin(), nl.end());
        int32_t best = nl[0];
        int32_t best_c = 1, cur_c = 1;
        for (size_t k = 1; k < nl.size(); ++k) {
          cur_c = (nl[k] == nl[k - 1]) ? cur_c + 1 : 1;
          if (cur_c > best_c) {
            best_c = cur_c;
            best = nl[k];
          }
        }
        if (best != prev[v]) {
          labels[v] = best;
          ++local_changed;
        }
      }
      changed.fetch_add(local_changed, std::memory_order_relaxed);
    }
    if (changed.load() <= n / 1000) {
      ++sweep;
      break;
    }
  }
  return sweep;
}

int omp_max_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
