"""Host-side graph builders (counterpart of ``ssrg_tpu/native.py``).

The functions run the port's OpenMP C++ library, ``ssrg_torch/csrc/
graphbuild.cpp``, built at first use into ``ssrg_torch/build/
libgraphbuild.so`` by :func:`ssrg_torch.ops._nvcc.build_host` and bound with
ctypes. There is no silent fallback: a library that does not build or load
raises. Beside them stand the numpy versions (``*_plain``), which the tests
hold the library to and nothing on the main path calls:

- ``symmetrize_edges``: symmetric, coalesced, self-loop-free edge list,
  sorted by (row, col).
- ``edge_degree_accumulate``: symmetric degrees of a directed edge chunk.
- ``sym_norm_csr``: ``D^{r-1} A D^{-r}`` weights of a CSR.
- ``lpa_cluster``: synchronous label propagation, ties to the smallest
  label, stopping once at most ``N // 1000`` labels change; the C++ labels
  are bit-identical to the numpy version's.
- ``ell_hybrid_pack``: CSR to ELL slots plus a COO tail. The C packer emits
  the tail in thread order (each row's entries together, in CSR order), so
  it equals the plain version's once sorted stably by row, as
  ``ops.sparse.build_coo`` does.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import numpy.ctypeslib as ctl

from ssrg_torch.ops import _nvcc

LIBRARY = "graphbuild"

_i64 = ctl.ndpointer(dtype=np.int64, ndim=1, flags="C_CONTIGUOUS")
_i32 = ctl.ndpointer(dtype=np.int32, ndim=1, flags="C_CONTIGUOUS")
_f32 = ctl.ndpointer(dtype=np.float32, ndim=1, flags="C_CONTIGUOUS")
_f64 = ctl.ndpointer(dtype=np.float64, ndim=1, flags="C_CONTIGUOUS")

_lib: Optional[ctypes.CDLL] = None


def _declare(lib: ctypes.CDLL) -> None:
    i64, c_int = ctypes.c_int64, ctypes.c_int
    signatures = {
        "coalesce_edges": ([_i64, _i64, _f32, i64, i64, _i64, _i64, _f32], i64),
        "symmetrize_edges": ([_i64, _i64, _f32, i64, i64, c_int, _i64, _i64, _f32], i64),
        "build_csr": ([_i64, _i64, _f32, i64, i64, _i32, _i32, _f32], None),
        "csr_degrees": ([_i32, _f32, i64, _f64], None),
        "sym_norm_weights": ([_i32, _i32, _f32, _f64, i64, ctypes.c_double], None),
        "ell_hybrid_pack": ([_i32, _i32, _f32, i64, i64, i64, _i32, _f32, _i32, _i32, _f32],
                            i64),
        "edge_degree_accumulate": ([_i64, _i64, i64, _i64], None),
        "lpa_cluster": ([_i32, _i32, i64, ctypes.c_int32, _i32], i64),
        "omp_max_threads": ([], c_int),
    }
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype


def load_library() -> ctypes.CDLL:
    """The host library, built first if it is missing or older than its
    source. Raises ``RuntimeError`` when it cannot be built, ``OSError`` when
    it cannot be loaded."""
    global _lib
    if _lib is None:
        _nvcc.build_host(LIBRARY)
        lib = ctypes.CDLL(_nvcc.library_path(LIBRARY))
        _declare(lib)
        _lib = lib
    return _lib


def available() -> bool:
    """Build and load the library; ``True``, or the build's error."""
    load_library()
    return True


def omp_max_threads() -> int:
    """The OpenMP threads the library's parallel loops use."""
    return int(load_library().omp_max_threads())


def symmetrize_edges(
    rows: np.ndarray, cols: np.ndarray, weights: Optional[np.ndarray],
    num_nodes: int, clamp_unit: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Symmetric, coalesced, self-loop-free edge list (sorted by row, then
    column): both directions of every edge summed into one entry, the sums
    clamped to 1 when ``clamp_unit``."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    w = np.ascontiguousarray(
        weights if weights is not None else np.ones(rows.shape[0]), np.float32
    )
    out_r = np.empty(2 * rows.size, np.int64)
    out_c = np.empty(2 * rows.size, np.int64)
    out_w = np.empty(2 * rows.size, np.float32)
    m = load_library().symmetrize_edges(
        rows, cols, w, rows.size, num_nodes, int(clamp_unit), out_r, out_c, out_w,
    )
    return out_r[:m].copy(), out_c[:m].copy(), out_w[:m].copy()


def symmetrize_edges_plain(
    rows: np.ndarray, cols: np.ndarray, weights: Optional[np.ndarray],
    num_nodes: int, clamp_unit: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """:func:`symmetrize_edges` through scipy (sums in float32)."""
    import scipy.sparse as sp

    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    w = np.ascontiguousarray(
        weights if weights is not None else np.ones(rows.shape[0]), np.float32
    )
    adj = sp.coo_matrix(
        (np.concatenate([w, w]),
         (np.concatenate([rows, cols]), np.concatenate([cols, rows]))),
        shape=(num_nodes, num_nodes),
    ).tocsr()
    if clamp_unit:
        adj.data[:] = np.minimum(adj.data, 1.0)
    adj.setdiag(0)
    adj.eliminate_zeros()
    coo = adj.tocoo()
    return coo.row.astype(np.int64), coo.col.astype(np.int64), coo.data.astype(np.float32)


def _check_degrees(deg: np.ndarray) -> None:
    if deg.dtype != np.int64 or not deg.flags["C_CONTIGUOUS"]:
        raise TypeError("edge_degree_accumulate: deg must be a C-contiguous int64 array")


def edge_degree_accumulate(src: np.ndarray, dst: np.ndarray, deg: np.ndarray) -> None:
    """In place, ``deg[src] += 1`` and ``deg[dst] += 1`` for every edge that
    is not a self loop; ``deg`` is int64 ``[N]``."""
    src = np.ascontiguousarray(src, np.int64)
    dst = np.ascontiguousarray(dst, np.int64)
    _check_degrees(deg)
    load_library().edge_degree_accumulate(src, dst, src.size, deg)


def edge_degree_accumulate_plain(src: np.ndarray, dst: np.ndarray, deg: np.ndarray) -> None:
    """:func:`edge_degree_accumulate` with ``np.bincount``."""
    src = np.ascontiguousarray(src, np.int64)
    dst = np.ascontiguousarray(dst, np.int64)
    _check_degrees(deg)
    keep = src != dst
    n = deg.shape[0]
    deg += np.bincount(src[keep], minlength=n).astype(np.int64)
    deg += np.bincount(dst[keep], minlength=n).astype(np.int64)


def sym_norm_csr(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
                 r: float) -> np.ndarray:
    """``D^{r-1} A D^{-r}`` weights of a CSR (degrees are its row sums, so
    any self loops must already be in it; an infinite scale becomes 0).
    Returns the new float32 data array; an input already float32 and
    contiguous is updated in place."""
    n = indptr.shape[0] - 1
    indptr = np.ascontiguousarray(indptr, np.int32)
    indices = np.ascontiguousarray(indices, np.int32)
    data = np.ascontiguousarray(data, np.float32)
    lib = load_library()
    deg = np.empty(n, np.float64)
    lib.csr_degrees(indptr, data, n, deg)
    lib.sym_norm_weights(indptr, indices, data, deg, n, float(r))
    return data


def sym_norm_csr_plain(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
                       r: float) -> np.ndarray:
    """:func:`sym_norm_csr` in numpy (float64, then rounded to float32)."""
    n = indptr.shape[0] - 1
    indptr = np.ascontiguousarray(indptr, np.int32)
    indices = np.ascontiguousarray(indices, np.int32)
    data = np.ascontiguousarray(data, np.float32)
    deg = np.add.reduceat(
        data.astype(np.float64), indptr[:-1]
    ) if data.size else np.zeros(n)
    deg[np.diff(indptr) == 0] = 0.0
    with np.errstate(divide="ignore"):
        left = np.power(deg, r - 1.0)
        right = np.power(deg, -r)
    left[~np.isfinite(left)] = 0.0
    right[~np.isfinite(right)] = 0.0
    rows_of = np.repeat(np.arange(n), np.diff(indptr))
    return (left[rows_of] * data * right[indices]).astype(np.float32)


def _lpa_inputs(indptr: np.ndarray, indices: np.ndarray):
    if indices.size >= 2**31:
        raise ValueError(
            f"lpa_cluster: nnz={indices.size} exceeds the int32 index limit "
            "(2^31-1); cluster a subsampled or partitioned graph instead"
        )
    return np.ascontiguousarray(indptr, np.int32), np.ascontiguousarray(indices, np.int32)


def lpa_cluster(
    indptr: np.ndarray, indices: np.ndarray, max_sweeps: int = 20,
) -> np.ndarray:
    """Label-propagation community labels over an undirected CSR (int32
    ``[N]``): synchronous sweeps, each node taking the most frequent label
    of its neighbours (ties to the smallest label), until at most ``N //
    1000`` labels change in a sweep or ``max_sweeps`` sweeps have run."""
    n = indptr.shape[0] - 1
    indptr, indices = _lpa_inputs(indptr, indices)
    labels = np.empty(n, np.int32)
    load_library().lpa_cluster(indptr, indices, n, int(max_sweeps), labels)
    return labels


def lpa_cluster_plain(
    indptr: np.ndarray, indices: np.ndarray, max_sweeps: int = 20,
) -> np.ndarray:
    """:func:`lpa_cluster` in numpy: the mode of each row's neighbour labels
    by lexsort and run lengths."""
    n = indptr.shape[0] - 1
    indptr, indices = _lpa_inputs(indptr, indices)
    labels = np.arange(n, dtype=np.int32)
    if indices.size == 0:
        return labels
    rows_of = np.repeat(np.arange(n), np.diff(indptr))
    for _ in range(max_sweeps):
        nl = labels[indices]
        order = np.lexsort((nl, rows_of))
        r, lab = rows_of[order], nl[order]
        grp_start = np.empty(r.size, bool)
        grp_start[0] = True
        grp_start[1:] = (r[1:] != r[:-1]) | (lab[1:] != lab[:-1])
        starts = np.flatnonzero(grp_start)
        counts = np.diff(np.append(starts, r.size))
        gr, gl = r[starts], lab[starts]
        # per row: most frequent label, ties -> smallest label
        o2 = np.lexsort((gl, -counts, gr))
        _, first = np.unique(gr[o2], return_index=True)
        new = labels.copy()
        new[gr[o2][first]] = gl[o2][first]
        changed = int(np.count_nonzero(new != labels))
        labels = new
        if changed <= n // 1000:
            break
    return labels


def ell_hybrid_pack(
    indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
    width: int, n_pad: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """CSR -> (ell_cols [n_pad, width] int32, ell_vals f32, tail_rows,
    tail_cols, tail_vals): the first ``width`` entries of each row go to
    the ELL slots (padding slots hold column 0 and weight 0), the rest to
    a COO tail in thread order."""
    n = indptr.shape[0] - 1
    indptr = np.ascontiguousarray(indptr, np.int32)
    indices = np.ascontiguousarray(indices, np.int32)
    data = np.ascontiguousarray(data, np.float32)
    ell_cols = np.zeros(n_pad * width, np.int32)
    ell_vals = np.zeros(n_pad * width, np.float32)
    tr = np.empty(indices.size, np.int32)
    tc = np.empty(indices.size, np.int32)
    tv = np.empty(indices.size, np.float32)
    tlen = load_library().ell_hybrid_pack(
        indptr, indices, data, n, width, n_pad, ell_cols, ell_vals, tr, tc, tv,
    )
    return (ell_cols.reshape(n_pad, width), ell_vals.reshape(n_pad, width),
            tr[:tlen].copy(), tc[:tlen].copy(), tv[:tlen].copy())


def ell_hybrid_pack_plain(
    indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
    width: int, n_pad: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """:func:`ell_hybrid_pack` in numpy, with the tail in row order."""
    n = indptr.shape[0] - 1
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    data = np.ascontiguousarray(data, np.float32)
    deg = np.diff(indptr)
    pos = np.arange(indices.size) - np.repeat(indptr[:-1], deg)
    rows_of = np.repeat(np.arange(n), deg)
    in_ell = pos < width
    ell_cols = np.zeros((n_pad, width), np.int32)
    ell_vals = np.zeros((n_pad, width), np.float32)
    ell_cols[rows_of[in_ell], pos[in_ell]] = indices[in_ell]
    ell_vals[rows_of[in_ell], pos[in_ell]] = data[in_ell]
    t = ~in_ell
    return ell_cols, ell_vals, rows_of[t].astype(np.int32), indices[t], data[t]
