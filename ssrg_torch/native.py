"""Host-side ELL/hybrid packing (counterpart of ``ssrg_tpu/native.py``).

The reference packs with an OpenMP C++ builder and a numpy fallback; the
port keeps the numpy version only. Its packs equal the C packer's: the same
ELL slots, and the same tail entries (the C packer emits the tail in
thread order, so the two agree once the tail is sorted by row, as
``ops.sparse.build_coo`` does).
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
