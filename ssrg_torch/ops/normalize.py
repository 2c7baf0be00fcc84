"""Adjacency normalization (counterpart of ``ssrg_tpu/ops/normalize.py``):
all seven graph-operator constructions.

Host-side numpy/scipy, run once per graph; weights are computed in float64
and stored as float32, exactly as the reference computes them:

- ``sym_norm``                  D^{r-1}(A+I)D^{-r} (the ``sym`` graph op)
- ``ppr_norm``                  (1-alpha) sym_norm + alpha I (``ppr``)
- ``magnetic_norm``             the magnetic Laplacian's (real, imag) pair
  (``magnetic``)
- ``magnetic_pygsd_norm``       its Chebyshev-rescaled PyGSD variant
- ``magnetic_com_ppr_norm``     complex PPR over ``magnetic_norm``
  (``magnetic_ppr``)
- ``un_in_out_norm``            undirected / in (PᵀP) / out (PPᵀ) triple,
  sparse end to end, with a guard on the second-order products' size
  (``two_dir``)
- ``fast_ppr_approx_norm``      PageRank-stationary symmetrization by power
  iteration (``fast_ppr``)
- ``two_order_ppr_approx_norm`` first-order pi-symmetrized PPR adjacency and
  the co-support-masked second-order average, dense by definition, with a
  guard on N (``two_order``)

All return scipy CSR (or tuples of CSR) for ``ops.sparse.device_adjacency``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.linalg
import scipy.sparse as sp


def _coalesce_coo(row, col, *values, shape):
    """Sum duplicate (row, col) entries for each value array."""
    key = row.astype(np.int64) * shape[1] + col.astype(np.int64)
    uniq, inv = np.unique(key, return_inverse=True)
    out_row = (uniq // shape[1]).astype(np.int64)
    out_col = (uniq % shape[1]).astype(np.int64)
    outs = []
    for v in values:
        acc = np.zeros(uniq.shape[0], dtype=np.float64)
        np.add.at(acc, inv, v.astype(np.float64))
        outs.append(acc)
    return (out_row, out_col, *outs)


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

    Degrees are row sums of (A+I); r=0.5 gives the GCN operator
    D^{-1/2}(A+I)D^{-1/2}.
    """
    n = adj.shape[0]
    a = (adj + sp.eye(n, format=adj.format if sp.issparse(adj) else "csr")).tocoo()
    deg = np.asarray(a.sum(axis=1)).reshape(-1)
    w = _degree_scale(a.row, a.col, a.data.astype(np.float64), deg, r)
    return sp.csr_matrix((w.astype(np.float32), (a.row, a.col)), shape=(n, n))


def ppr_norm(adj: sp.spmatrix, r: float = 0.5, alpha: float = 0.15) -> sp.csr_matrix:
    """PPR / APPNP-style teleport: (1-alpha) * sym_norm(A, r) + alpha * I."""
    n = adj.shape[0]
    return ((1.0 - alpha) * sym_norm(adj, r) + alpha * sp.eye(n)).tocsr()


def magnetic_norm(
    adj: sp.spmatrix, r: float = 0.5, q: float = 0.05
) -> Tuple[sp.csr_matrix, sp.csr_matrix]:
    """Magnetic Laplacian normalization for directed graphs.

    A_s(u,v) = (A(u,v)+A(v,u))/2 (+ self-loops of weight 1);
    theta(u,v) = A(u,v)-A(v,u); phase = exp(i * 2*pi*q * theta);
    entry = d[u]^{r-1} * A_s(u,v) * d[v]^{-r} * phase, split into
    (real, imag) CSR matrices.
    """
    n = adj.shape[0]
    coo = adj.tocoo()
    # symmetrized weight and antisymmetric phase via coalesce over A | Aᵀ
    row = np.concatenate([coo.row, coo.col])
    col = np.concatenate([coo.col, coo.row])
    sym_v = np.concatenate([coo.data, coo.data]).astype(np.float64)
    theta_v = np.concatenate([coo.data, -coo.data]).astype(np.float64)
    row, col, sym_v, theta_v = _coalesce_coo(row, col, sym_v, theta_v, shape=(n, n))
    sym_v = sym_v / 2.0
    # append self-loops: weight 1, phase 0
    loops = np.arange(n, dtype=np.int64)
    row = np.concatenate([row, loops])
    col = np.concatenate([col, loops])
    sym_v = np.concatenate([sym_v, np.ones(n)])
    theta_v = np.concatenate([theta_v, np.zeros(n)])

    deg = np.zeros(n)
    np.add.at(deg, row, sym_v)
    scaled = _degree_scale(row, col, sym_v, deg, r)
    phase = 2.0 * np.pi * q * theta_v
    real = scaled * np.cos(phase)
    imag = scaled * np.sin(phase)
    real_m = sp.csr_matrix((real.astype(np.float32), (row, col)), shape=(n, n))
    imag_m = sp.csr_matrix((imag.astype(np.float32), (row, col)), shape=(n, n))
    return real_m, imag_m


def magnetic_pygsd_norm(
    adj: sp.spmatrix, r: float = 0.5, q: float = 0.05, lambda_max: float = 2.0
) -> Tuple[sp.csr_matrix, sp.csr_matrix]:
    """PyGSD-style magnetic variant: Chebyshev-rescaled Laplacian
    2/lambda_max * (I - A_mag_norm) - I, real part gets the extra -I shift.

    Follows SSRG's hardcoded lambda_max = 2 path
    (SSRG ``operators/utils.py:175-178``): no self-loops in A_s, L = I - A_norm,
    rescale by 2/lambda_max, then real -= I.
    """
    n = adj.shape[0]
    coo = adj.tocoo()
    row = np.concatenate([coo.row, coo.col])
    col = np.concatenate([coo.col, coo.row])
    sym_v = np.concatenate([coo.data, coo.data]).astype(np.float64)
    theta_v = np.concatenate([coo.data, -coo.data]).astype(np.float64)
    row, col, sym_v, theta_v = _coalesce_coo(row, col, sym_v, theta_v, shape=(n, n))
    sym_v = sym_v / 2.0

    deg = np.zeros(n)
    np.add.at(deg, row, sym_v)
    scaled = _degree_scale(row, col, sym_v, deg, r)
    phase = 2.0 * np.pi * q * theta_v
    real = scaled * np.cos(phase)
    imag = scaled * np.sin(phase)

    # L = I - A_norm  (negate entries, +1 on the diagonal)
    neg_real = sp.csr_matrix((-real, (row, col)), shape=(n, n)) + sp.eye(n)
    neg_imag = sp.csr_matrix((-imag, (row, col)), shape=(n, n))
    neg_real = (2.0 / lambda_max) * neg_real - sp.eye(n)
    neg_imag = (2.0 / lambda_max) * neg_imag
    return neg_real.tocsr().astype(np.float32), neg_imag.tocsr().astype(np.float32)


def magnetic_com_ppr_norm(
    adj: sp.spmatrix, r: float = 0.5, q: float = 0.25, ppr_alpha: float = 0.15
) -> Tuple[sp.csr_matrix, sp.csr_matrix]:
    """Complex PPR over the magnetic normalization: real <- (1-a)Re + aI,
    imag <- (1-a)Im."""
    n = adj.shape[0]
    real_m, imag_m = magnetic_norm(adj, r, q)
    real_m = ((1.0 - ppr_alpha) * real_m + ppr_alpha * sp.eye(n)).tocsr()
    imag_m = ((1.0 - ppr_alpha) * imag_m).tocsr()
    return real_m.astype(np.float32), imag_m.astype(np.float32)


def _row_col_norm(mat: sp.spmatrix, r: float) -> sp.csr_matrix:
    """Degree-scale an arbitrary nonneg matrix by its own row sums."""
    coo = mat.tocoo()
    n = coo.shape[0]
    deg = np.zeros(n)
    np.add.at(deg, coo.row, coo.data.astype(np.float64))
    w = _degree_scale(coo.row, coo.col, coo.data.astype(np.float64), deg, r)
    w[~np.isfinite(w)] = 0.0
    return sp.csr_matrix((w.astype(np.float32), (coo.row, coo.col)), shape=coo.shape)


def un_in_out_norm(
    adj: sp.spmatrix, r: float = 0.5, max_second_order_nnz: int = 250_000_000
) -> Tuple[sp.csr_matrix, sp.csr_matrix, sp.csr_matrix]:
    """Directed triple: undirected sym norm, in-norm(PᵀP), out-norm(PPᵀ)
    with P = D^{-1}(A+I).

    SSRG computes PᵀP / PPᵀ with dense matmuls (SSRG
    ``operators/utils.py:216-219``); here, as in ``ssrg_tpu``, they stay
    sparse end to end. Weights are binarized to 1 before the self-loops.

    The second-order products densify on hub-heavy graphs (nnz(PᵀP) is
    bounded by Σ_k indeg(k)²), so the upper bound is estimated BEFORE
    multiplying and the call refuses with a remedy above
    ``max_second_order_nnz`` (same contract as the wavelet construction's
    ``max_nodes`` guard).
    """
    n = adj.shape[0]
    coo = adj.tocoo()
    ones = np.ones(coo.nnz)
    a = sp.csr_matrix((ones, (coo.row, coo.col)), shape=(n, n)) + sp.eye(n)
    a = a.tocsr()
    indeg = np.asarray((a != 0).sum(axis=0)).reshape(-1).astype(np.int64)
    outdeg = np.asarray((a != 0).sum(axis=1)).reshape(-1).astype(np.int64)
    est = int(max(np.square(indeg).sum(), np.square(outdeg).sum()))
    if est > max_second_order_nnz:
        raise ValueError(
            f"un_in_out_norm second-order products PᵀP/PPᵀ can reach ~{est:.2e} "
            f"nonzeros at N={n} (budget max_second_order_nnz="
            f"{max_second_order_nnz:.0e}): ~{est * 12 / 2**30:.0f} GB of COO "
            f"on host. The two-order operators are a small/medium-graph "
            f"capability (reference operators/utils.py:216-219 materializes "
            f"them DENSE); for large graphs use sym_norm/ppr_norm-based "
            f"models, sparsify hubs first, or raise max_second_order_nnz "
            f"explicitly if you accept the cost."
        )
    deg = np.asarray(a.sum(axis=1)).reshape(-1)
    with np.errstate(divide="ignore"):
        d_inv = 1.0 / deg
    d_inv[~np.isfinite(d_inv)] = 0.0
    p = sp.diags(d_inv) @ a

    un = _row_col_norm(a, r)
    in_l = (p.T @ p).tocsr()
    out_l = (p @ p.T).tocsr()
    return un, _row_col_norm(in_l, r), _row_col_norm(out_l, r)


def fast_ppr_approx_norm(
    adj: sp.spmatrix,
    r: float = 0.5,
    ppr_alpha: float = 0.1,
    max_iter: int = 100,
    tol: float = 1e-6,
) -> sp.csr_matrix:
    """PageRank-stationary symmetrization
    (Pi^{1/2} P Pi^{-1/2} + Pi^{-1/2} Pᵀ Pi^{1/2}) / 2 followed by degree
    scaling; pi found by power iteration on the PPR Google matrix with
    dangling-node correction (SSRG ``operators/utils.py:262-322``)."""
    n = adj.shape[0]
    coo = adj.tocoo()
    ones = np.ones(coo.nnz)
    a = (sp.csr_matrix((ones, (coo.row, coo.col)), shape=(n, n)) + sp.eye(n)).tocsr()
    rowsum = np.asarray(a.sum(axis=1)).reshape(-1)
    nz = rowsum.nonzero()[0]
    d_inv = sp.csr_matrix((1.0 / rowsum[nz], (nz, nz)), shape=(n, n))

    s = (1.0 / (1.0 + ppr_alpha) / n) * np.ones((n, 1))
    z_t = (
        ppr_alpha * (1.0 + ppr_alpha) * (rowsum != 0)
        + ((1.0 - ppr_alpha) / (1.0 + ppr_alpha) + ppr_alpha * (1.0 + ppr_alpha))
        * (rowsum == 0)
    )[np.newaxis, :]
    w = (1.0 - ppr_alpha) * a.T @ d_inv
    x = s
    oldx = np.zeros((n, 1))
    it = 0
    while np.linalg.norm(x - oldx) > tol:
        oldx = x
        x = w @ x + s @ (z_t @ x)
        it += 1
        if it >= max_iter:
            break
    x = (x / x.sum()).reshape(-1)

    p = d_inv @ a
    with np.errstate(divide="ignore", invalid="ignore"):
        pi_sqrt = sp.diags(np.power(x, 0.5))
        pi_inv_sqrt = sp.diags(np.power(x, -0.5))
    lap = (pi_sqrt @ p @ pi_inv_sqrt + pi_inv_sqrt @ p.T @ pi_sqrt) / 2.0
    lap = lap.tocoo()
    data = lap.data
    data[~np.isfinite(data)] = 0.0
    deg = np.zeros(n)
    np.add.at(deg, lap.row, data)
    wgt = _degree_scale(lap.row, lap.col, data, deg, r)
    return sp.csr_matrix((wgt.astype(np.float32), (lap.row, lap.col)), shape=(n, n))


def two_order_ppr_approx_norm(
    adj: sp.spmatrix, r: float = 0.5, ppr_alpha: float = 0.1,
    max_nodes: int = 10_000,
) -> Tuple[sp.csr_matrix, sp.csr_matrix]:
    """First-order pi-symmetrized PPR adjacency + second-order
    co-support-masked (L_in, L_out) average (SSRG
    ``operators/utils.py:324-424``: the exact left eigenvector of the
    (N+1)x(N+1) Google matrix, dense, so only for small N).

    SSRG's co-support masking aliases L_in_hat to L_in, so its second mask
    reads an already-modified L_in. Here, as in ``ssrg_tpu``, both masks come
    from the unmodified products.

    Inherently dense — the construction materializes four N×N float64
    matrices and runs an O(N³) left-eigendecomposition — so it refuses with
    a remedy above ``max_nodes`` (wavelet-guard contract): at arxiv scale
    (N=169k) the dense intermediates alone would be ~115 GB each.
    """
    n = adj.shape[0]
    if n > max_nodes:
        est_gb = (n + 1) * (n + 1) * 8 / 2**30
        raise ValueError(
            f"two_order_ppr_approx_norm at N={n} exceeds the supported "
            f"budget (max_nodes={max_nodes}): the construction is dense by "
            f"definition — an (N+1)² Google matrix (~{est_gb:.0f} GB f64), "
            f"an O(N³) left-eigendecomposition, and N² second-order "
            f"products (reference operators/utils.py:324-424 is equally "
            f"dense). It is a Planetoid-scale operator; for large graphs "
            f"use fast_ppr_approx_norm (sparse power iteration) or a "
            f"sym/ppr-norm model, or raise max_nodes explicitly if you "
            f"accept the cost."
        )
    coo = adj.tocoo()
    ones = np.ones(coo.nnz)
    a = (sp.csr_matrix((ones, (coo.row, coo.col)), shape=(n, n)) + sp.eye(n)).tocsr()
    deg = np.asarray(a.sum(axis=1)).reshape(-1)
    with np.errstate(divide="ignore"):
        d_inv = 1.0 / deg
    d_inv[~np.isfinite(d_inv)] = 0.0
    p_dense = (sp.diags(d_inv) @ a).toarray()

    # (N+1)^2 PPR google matrix, dominant left eigenvector
    p_v = np.zeros((n + 1, n + 1))
    p_v[:n, :n] = (1.0 - ppr_alpha) * p_dense
    p_v[n, :n] = 1.0 / n
    p_v[:n, n] = ppr_alpha
    eigvals, left = scipy.linalg.eig(p_v, left=True, right=False)
    order = np.argsort(-eigvals.real)
    pi = left[:, order[0]].real[:n]
    pi = pi / pi.sum()
    if (pi < 0).any():
        pi = np.abs(pi)  # eigenvector sign/scale guard

    with np.errstate(divide="ignore"):
        pi_sqrt = np.power(pi, 0.5)
        pi_inv_sqrt = np.power(pi, -0.5)
    pi_sqrt[~np.isfinite(pi_sqrt)] = 0.0
    pi_inv_sqrt[~np.isfinite(pi_inv_sqrt)] = 0.0
    lap = (
        (pi_sqrt[:, None] * p_dense) * pi_inv_sqrt[None, :]
        + (pi_inv_sqrt[:, None] * p_dense.T) * pi_sqrt[None, :]
    ) / 2.0
    lap[~np.isfinite(lap)] = 0.0
    one_order = _row_col_norm(sp.csr_matrix(lap), r)

    l_in = p_dense.T @ p_dense
    l_out = p_dense @ p_dense.T
    co_support = (l_in != 0) & (l_out != 0)
    second = np.where(co_support, (l_in + l_out) / 2.0, 0.0)
    second[~np.isfinite(second)] = 0.0
    two_order = _row_col_norm(sp.csr_matrix(second), r)
    return one_order, two_order
