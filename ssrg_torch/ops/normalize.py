"""Adjacency normalization (counterpart of ``ssrg_tpu/ops/normalize.py``).

Host-side numpy/scipy, run once per graph. Only the construction that the
serving path's ``sym`` graph op uses is ported; the other six operators
come with the spectral/complex slice (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _degree_scale(row, col, weight, deg, r):
    """w' = deg[row]^{r-1} * w * deg[col]^{-r}, with inf -> 0."""
    with np.errstate(divide="ignore"):
        left = np.power(deg, r - 1.0)
        right = np.power(deg, -r)
    left[~np.isfinite(left)] = 0.0
    right[~np.isfinite(right)] = 0.0
    return left[row] * weight * right[col]


def sym_norm(adj: sp.spmatrix, r: float = 0.5) -> sp.csr_matrix:
    """Generalized symmetric normalization D^{r-1}(A+I)D^{-r}.

    Degrees are row sums of (A+I); weights are computed in float64 and
    stored as float32. r=0.5 gives the GCN operator D^{-1/2}(A+I)D^{-1/2}.
    """
    n = adj.shape[0]
    a = (adj + sp.eye(n, format=adj.format if sp.issparse(adj) else "csr")).tocoo()
    deg = np.asarray(a.sum(axis=1)).reshape(-1)
    w = _degree_scale(a.row, a.col, a.data.astype(np.float64), deg, r)
    return sp.csr_matrix((w.astype(np.float32), (a.row, a.col)), shape=(n, n))
