"""Host-side graph kernels (counterpart of ``ssrg_tpu/native.py``).

The reference runs these with an OpenMP C++ library and a numpy fallback;
the port keeps the numpy versions only:

- ``ell_hybrid_pack``: its packs equal the C packer's: the same ELL slots,
  and the same tail entries (the C packer emits the tail in thread order,
  so the two agree once the tail is sorted by row, as
  ``ops.sparse.build_coo`` does).
- ``lpa_cluster``: synchronous label propagation, ties to the smallest
  label. The reference's C++ path is bit-identical to its numpy path, which
  this is a copy of.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def ell_hybrid_pack(
    indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
    width: int, n_pad: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """CSR -> (ell_cols [n_pad, width] int32, ell_vals f32, tail_rows,
    tail_cols, tail_vals): the first ``width`` entries of each row go to
    the ELL slots (padding slots hold column 0 and weight 0), the rest to
    a COO tail in row order."""
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


def lpa_cluster(
    indptr: np.ndarray, indices: np.ndarray, max_sweeps: int = 20,
) -> np.ndarray:
    """Label-propagation community labels over an undirected CSR (int32
    ``[N]``): synchronous sweeps, each node taking the most frequent label
    of its neighbours (ties to the smallest label), until at most ``N //
    1000`` labels change in a sweep or ``max_sweeps`` sweeps have run."""
    n = indptr.shape[0] - 1
    if indices.size >= 2**31:
        raise ValueError(
            f"lpa_cluster: nnz={indices.size} exceeds the int32 index limit "
            "(2^31-1); cluster a subsampled or partitioned graph instead"
        )
    indptr = np.ascontiguousarray(indptr, np.int32)
    indices = np.ascontiguousarray(indices, np.int32)
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
