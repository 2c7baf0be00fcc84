"""Graph wavelets (GWNN) (counterpart of ``ssrg_tpu/models/wavelet.py``).

Construction. The heat-kernel wavelet basis Φ = g(L), g(λ) = exp(-τ λ /
λ_max) at τ ∈ {-s, +s} on the combinatorial Laplacian L = D - A, is
evaluated by the Chebyshev three-term recurrence on blocks of
``impulse_batch`` impulse columns: the block is built on the device and each
T_k step is one SpMM of the Laplacian's device adjacency (above
``DENSE_THRESHOLD`` nodes the hybrid engine, so the ELL kernel at F =
``impulse_batch``). λ_max comes from a host Lanczos (scipy ``eigsh``) with a
1.01 safety factor. Each block comes back to the host, where ``out[out <
tol] = 0`` thresholds it (negative entries too, as the reference does), and
the rows of Φ and Φ⁻¹ are L1-normalized.

Layer. θ is diagonal, so Φ diag(θ) Φ⁻¹ (X W) runs as Φ (θ ⊙ (Φ⁻¹ (X W))):
one matrix product and two SpMMs. For training, Φ and Φ⁻¹ reach the device
through :func:`ssrg_torch.ops.sparse.differentiable_adjacency`: an ELL or
hybrid pack runs the ELL kernel forward and, under autograd, backward on the
packs of Φᵀ and Φ⁻ᵀ, built on the host (neither matrix is symmetric).
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from ssrg_torch.configs.config import WaveletConfig
from ssrg_torch.models.heads import Dropout, _edge_concat, check_query_edges
from ssrg_torch.ops.sparse import Adjacency, device_adjacency, differentiable_adjacency
from ssrg_torch.utils import DeviceLike, init_dense_, resolve_device, synchronize, variance_scaling_


# ---------------------------------------------------------------------------
# Chebyshev heat-kernel wavelet construction
# ---------------------------------------------------------------------------


def combinatorial_laplacian(adj: sp.spmatrix) -> sp.csr_matrix:
    """L = D - A, in float64."""
    a = adj.tocsr().astype(np.float64)
    deg = np.asarray(a.sum(axis=1)).reshape(-1)
    return (sp.diags(deg) - a).tocsr()


def estimate_lmax(lap: sp.csr_matrix, safety: float = 1.01) -> float:
    """Largest Laplacian eigenvalue by Lanczos (``eigsh``, tol 5e-3),
    inflated by 1%; the Gershgorin bound ``2 max(deg)`` if Lanczos fails."""
    try:
        from scipy.sparse.linalg import eigsh

        lmax = float(eigsh(lap, k=1, which="LM", return_eigenvectors=False, tol=5e-3)[0])
        return lmax * safety
    except Exception:
        deg = lap.diagonal()
        return float(2.0 * deg.max())


def compute_cheby_coeff(tau: float, lmax: float, order: int,
                        quad_points: Optional[int] = None) -> np.ndarray:
    """Chebyshev coefficients of g(λ) = exp(-τ λ / λ_max) on [0, λ_max] by
    Gauss-Chebyshev quadrature on N = order+1 points: c_k = (2/N) Σ_j
    g(a1 cos(π(j+.5)/N) + a2) cos(π k (j+.5)/N), a1 = a2 = λ_max/2."""
    n = quad_points or (order + 1)
    a1 = a2 = lmax / 2.0
    j = (np.arange(n) + 0.5) * np.pi / n
    g = np.exp(-tau * (a1 * np.cos(j) + a2) / lmax)
    return np.array([2.0 / n * (g * np.cos(k * j)).sum() for k in range(order + 1)])


@torch.no_grad()
def cheby_op_batch(lap_dev: Adjacency, coeffs, block: torch.Tensor,
                   lmax: float) -> torch.Tensor:
    """Σ_k c_k T_k(L̃) block by the three-term recurrence, L̃ = (2/λ_max) L
    - I: one SpMM a step, ``len(coeffs) - 1`` in all. The coefficients are
    rounded to float32, as the reference's are."""
    a1 = a2 = lmax / 2.0
    c = [float(np.float32(v)) for v in coeffs]

    def shifted(x):
        return (lap_dev.spmm(x) - a2 * x) / a1

    t_prev = block
    t_cur = shifted(block)
    out = 0.5 * c[0] * t_prev + c[1] * t_cur
    for k in range(2, len(c)):
        t_next = 2.0 * shifted(t_cur) - t_prev
        out = out + c[k] * t_next
        t_prev, t_cur = t_cur, t_next
    return out


def _impulse_block(n: int, batch: int, lo: int, device: torch.device) -> torch.Tensor:
    """``[n, batch]`` float32 on ``device``: column j is the impulse at node
    ``lo + j`` (all zeros past ``n``)."""
    block = torch.zeros((n, batch), dtype=torch.float32, device=device)
    idx = torch.arange(lo, min(lo + batch, n), device=device)
    block[idx, idx - lo] = 1.0
    return block


def calculate_wavelets(
    adj: sp.spmatrix,
    cfg: WaveletConfig,
    engine: str = "auto",
    verbose: bool = True,
    device: DeviceLike = "cuda",
) -> Tuple[sp.csr_matrix, sp.csr_matrix, dict]:
    """(Φ, Φ⁻¹) as thresholded, L1-row-normalized float32 CSR matrices on
    the host, and their statistics.

    Scales -s then +s (Φ first, then Φ⁻¹), impulse blocks of
    ``cfg.impulse_batch`` columns, ``out[out < tolerance] = 0``, L1 row
    normalization. ``stats`` holds ``lmax``, the densities of Φ and Φ⁻¹ in
    percent, and the seconds of the device recurrence (``recurrence_s``,
    up to each block's end on the device) and of the host's copy,
    thresholding and assembly (``threshold_s``)."""
    dev = resolve_device(device)
    n = adj.shape[0]
    if n > cfg.max_nodes:
        est_gb = n * n * 4 / 2**30
        raise ValueError(
            f"wavelet basis construction at N={n} exceeds the supported "
            f"budget (max_nodes={cfg.max_nodes}): Φ is evaluated by "
            f"{-(-n // cfg.impulse_batch)} batched impulse blocks with dense "
            f"[N, {cfg.impulse_batch}] intermediates (~{est_gb:.0f} GB "
            f"streamed through host thresholding). Wavelet models are a "
            f"Planetoid-scale capability (reference base_model.py:236-265); "
            f"for large graphs use a precompute model (sgc/ssgc/gamlp/...) "
            f"or raise WaveletConfig.max_nodes explicitly if you accept the "
            f"cost."
        )
    lap = combinatorial_laplacian(adj)
    lmax = estimate_lmax(lap)
    lap_dev = device_adjacency(lap.astype(np.float32), engine, device=dev)
    batch = min(cfg.impulse_batch, n)

    recurrence_s = threshold_s = 0.0
    mats = []
    for tau in (-cfg.scale, cfg.scale):
        coeffs = compute_cheby_coeff(tau, lmax, cfg.approximation_order)
        cols = []
        for lo in range(0, n, batch):
            width = min(lo + batch, n) - lo
            t0 = time.perf_counter()
            block = cheby_op_batch(lap_dev, coeffs, _impulse_block(n, batch, lo, dev), lmax)
            synchronize(dev)
            t1 = time.perf_counter()
            out = block[:, :width].cpu().numpy()
            out[out < cfg.tolerance] = 0.0
            cols.append(sp.csr_matrix(out))
            threshold_s += time.perf_counter() - t1
            recurrence_s += t1 - t0
        t1 = time.perf_counter()
        mat = sp.hstack(cols).tocsr()
        rowsum = np.abs(mat).sum(axis=1).A.reshape(-1)
        inv = np.where(rowsum > 0, 1.0 / rowsum, 0.0)
        mats.append((sp.diags(inv) @ mat).tocsr().astype(np.float32))
        threshold_s += time.perf_counter() - t1

    phi, phi_inv = mats
    stats = {
        "lmax": lmax,
        "phi_density": 100.0 * phi.nnz / (n * n),
        "phi_inv_density": 100.0 * phi_inv.nnz / (n * n),
        "recurrence_s": recurrence_s,
        "threshold_s": threshold_s,
    }
    if verbose:
        print(f"Density of wavelets: {stats['phi_density']:.2f}%.")
        print(f"Density of inverse wavelets: {stats['phi_inv_density']:.2f}%.")
    return phi, phi_inv, stats


def prepare_spectral(
    adj: sp.spmatrix, cfg: WaveletConfig, engine: str = "auto",
    verbose: bool = False, device: DeviceLike = "cuda",
) -> Tuple[Adjacency, Adjacency]:
    """(Φ, Φ⁻¹) on ``device``, each through ``differentiable_adjacency``."""
    dev = resolve_device(device)
    phi, phi_inv, _ = calculate_wavelets(adj, cfg, engine, verbose=verbose, device=dev)
    return (differentiable_adjacency(phi, engine, device=dev),
            differentiable_adjacency(phi_inv, engine, device=dev))


# ---------------------------------------------------------------------------
# Layers / heads
# ---------------------------------------------------------------------------


class GraphWaveletLayer(nn.Module):
    """One wavelet convolution, Φ (θ ⊙ (Φ⁻¹ (X W))), with ReLU and dropout
    after it when ``apply_act``.

    Parameters in the flax names and layout: ``theta`` ``[num_nodes, 1]``
    drawn from U(0.9, 1.1), ``weight`` ``[in, out]`` from
    variance-scaling(2, fan_avg, uniform). ``num_nodes`` may be set after
    construction (:meth:`set_num_nodes`), once the graph is known."""

    def __init__(self, in_features: int, output_dim: int, num_nodes: int = 0,
                 dropout: float = 0.5, apply_act: bool = True):
        super().__init__()
        self.in_features, self.output_dim, self.apply_act = in_features, output_dim, apply_act
        self.theta = nn.Parameter(torch.empty(num_nodes, 1))
        self.weight = nn.Parameter(torch.empty(in_features, output_dim))
        self.dropout = Dropout(dropout)
        self.reset_parameters()

    def set_num_nodes(self, num_nodes: int) -> None:
        """Give θ one entry per node (a fresh parameter, drawn anew)."""
        if self.theta.shape[0] != num_nodes:
            self.theta = nn.Parameter(torch.empty(num_nodes, 1, device=self.theta.device))
            self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.theta.uniform_(0.9, 1.1, generator=generator)
        variance_scaling_(self.weight, 2.0, "fan_avg", "uniform", fan_in=self.in_features,
                          fan_out=self.output_dim, generator=generator)

    def forward(self, x: torch.Tensor, phi: Adjacency, phi_inv: Adjacency) -> torch.Tensor:
        if self.theta.shape[0] != phi.shape[0]:
            raise ValueError(f"theta has {self.theta.shape[0]} entries for a graph of "
                             f"{phi.shape[0]} nodes: call set_num_nodes first")
        u = phi_inv.spmm(x @ self.weight)
        y = phi.spmm(self.theta * u)
        if self.apply_act:
            y = self.dropout(torch.relu(y))
        return y


class Wavelet2NeuralNetwork(nn.Module):
    """Two wavelet layers, ``conv1`` (ReLU, dropout) and ``conv2``; returns
    raw logits. ``forward(feature, adj)`` takes ``adj = (Φ, Φ⁻¹)``. With
    ``link``, ``edge_fc`` (``[2 C, C]``, flax-default init) scores the
    concatenated logits of each pair of ``query_edges``."""

    def __init__(self, feat_dim: int, hidden_dim: int, output_dim: int,
                 dropout: float = 0.5, num_nodes: int = 0, link: bool = False):
        super().__init__()
        self.link = link
        self.conv1 = GraphWaveletLayer(feat_dim, hidden_dim, num_nodes, dropout)
        self.conv2 = GraphWaveletLayer(hidden_dim, output_dim, num_nodes, dropout,
                                       apply_act=False)
        if link:
            self.edge_fc = nn.Linear(2 * output_dim, output_dim)
            init_dense_(self.edge_fc)

    def set_num_nodes(self, num_nodes: int) -> None:
        self.conv1.set_num_nodes(num_nodes)
        self.conv2.set_num_nodes(num_nodes)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.conv1.reset_parameters(generator)
        self.conv2.reset_parameters(generator)
        if self.link:
            init_dense_(self.edge_fc, generator=generator)

    def forward(self, feature, adj, query_edges=None):
        check_query_edges(self, query_edges)
        phi, phi_inv = adj
        logits = self.conv2(self.conv1(feature, phi, phi_inv), phi, phi_inv)
        if not self.link:
            return logits
        return self.edge_fc(_edge_concat(logits, query_edges))
