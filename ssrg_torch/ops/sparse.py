"""Sparse adjacency formats and SpMM engines (counterpart of
``ssrg_tpu/ops/sparse.py``).

Each format is a small dataclass of tensors with ``spmm(x)`` and
``to(device)``; the packs are built on the host with numpy and equal the
reference's packs entry for entry:

- ``DenseAdj``  — the adjacency as a dense matrix; SpMM is ``torch.matmul``
  (the reference leaves it to XLA's ``jnp.dot``).
- ``COOAdj``    — row-sorted COO padded to a multiple of ``chunk``; SpMM
  gathers, scales and ``index_add_``s one chunk at a time.
- ``ELLAdj``    — row-padded ELLPACK; SpMM is the hand-written CUDA kernel
  of :mod:`ssrg_torch.ops.ell_spmm` (its plain version on the CPU).
- ``HybridAdj`` — ELL for the first ``width`` neighbours of each row plus a
  COO tail for the overflow of hub rows; the default above
  ``DENSE_THRESHOLD`` nodes.

All engines compute in float32.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple, Union

import numpy as np
import scipy.sparse as sp
import torch

from ssrg_torch.ops.ell_spmm import ell_spmm
from ssrg_torch.utils import DeviceLike, resolve_device

# The locality tier and its meta-engines are ported in a later slice.
_UNPORTED_ENGINES = ("banded", "tiled", "blockcoo", "pallas_banded")
LOCALITY_TIER = "ROADMAP.md, queue item 3 (locality tier)"


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _check_rows(x: torch.Tensor, n_cols: int) -> None:
    if x.dim() != 2 or x.shape[0] != n_cols:
        raise ValueError(
            f"spmm: x must be [{n_cols}, F] for this adjacency, got {tuple(x.shape)}"
        )


@dataclass
class DenseAdj:
    """Adjacency stored dense; SpMM is one matrix product."""

    mat: torch.Tensor  # f32 [N, M]

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.mat.shape)

    def spmm(self, x: torch.Tensor) -> torch.Tensor:
        _check_rows(x, self.mat.shape[1])
        return torch.matmul(self.mat, x)

    def to(self, device: DeviceLike) -> "DenseAdj":
        return DenseAdj(self.mat.to(resolve_device(device)))


@dataclass
class COOAdj:
    """Row-sorted COO padded to a multiple of ``chunk``; padding entries are
    ``row = col = 0, val = 0``. SpMM bounds the gathered block at
    ``chunk x F``."""

    row: torch.Tensor  # int32 [nnz_pad]
    col: torch.Tensor  # int32 [nnz_pad]
    val: torch.Tensor  # f32   [nnz_pad]
    n_rows: int
    n_cols: int
    chunk: int

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.n_cols)

    @property
    def nnz_padded(self) -> int:
        return int(self.row.shape[0])

    def accumulate(self, out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``out += A @ x`` in place (the hybrid engine adds its tail into
        the ELL result this way instead of allocating a second [N, F])."""
        _check_rows(x, self.n_cols)
        for s in range(0, self.nnz_padded, self.chunk):
            r = self.row[s:s + self.chunk]
            c = self.col[s:s + self.chunk]
            v = self.val[s:s + self.chunk]
            out.index_add_(0, r, x.index_select(0, c) * v[:, None])
        return out

    def spmm(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((self.n_rows, x.shape[1]), dtype=torch.float32,
                          device=x.device)
        return self.accumulate(out, x)

    def to(self, device: DeviceLike) -> "COOAdj":
        dev = resolve_device(device)
        return replace(self, row=self.row.to(dev), col=self.col.to(dev),
                       val=self.val.to(dev))


@dataclass
class ELLAdj:
    """Row-padded ELLPACK: per row, ``width`` (neighbour, weight) slots,
    ``row_block``-padded rows; padding slots hold column 0 and weight 0."""

    cols: torch.Tensor  # int32 [n_pad, width]
    vals: torch.Tensor  # f32   [n_pad, width]
    n_rows: int
    n_cols: int
    row_block: int

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.n_cols)

    @property
    def width(self) -> int:
        return int(self.cols.shape[1])

    def spmm(self, x: torch.Tensor) -> torch.Tensor:
        _check_rows(x, self.n_cols)
        return ell_spmm(self.cols, self.vals, x)[: self.n_rows]

    def to(self, device: DeviceLike) -> "ELLAdj":
        dev = resolve_device(device)
        return replace(self, cols=self.cols.to(dev), vals=self.vals.to(dev))


@dataclass
class HybridAdj:
    """ELL + COO-tail hybrid: up to ``width`` slots per row in the ELL part,
    the overflow edges of hub rows in a row-sorted COO tail."""

    ell: ELLAdj
    tail: COOAdj

    @property
    def shape(self) -> Tuple[int, int]:
        return self.ell.shape

    def spmm(self, x: torch.Tensor) -> torch.Tensor:
        return self.tail.accumulate(self.ell.spmm(x), x)

    def to(self, device: DeviceLike) -> "HybridAdj":
        return HybridAdj(self.ell.to(device), self.tail.to(device))


Adjacency = Union[DenseAdj, COOAdj, ELLAdj, HybridAdj]


# ---------------------------------------------------------------------------
# Host-side builders (tensors on the CPU; device_adjacency moves them)
# ---------------------------------------------------------------------------


def build_dense(adj: sp.spmatrix) -> DenseAdj:
    return DenseAdj(torch.as_tensor(adj.toarray(), dtype=torch.float32))


def build_coo(adj: sp.spmatrix, chunk: int = 1 << 19) -> COOAdj:
    """Row-sorted padded COO with the reference's chunking: one 512-padded
    chunk up to ``chunk`` entries, else the chunk count first and a chunk
    shrunk so padding stays below ``num_chunks * 512``."""
    coo = adj.tocoo()
    order = np.argsort(coo.row, kind="stable")
    row = coo.row[order].astype(np.int32)
    col = coo.col[order].astype(np.int32)
    val = coo.data[order].astype(np.float32)
    nnz = row.shape[0]
    if nnz <= chunk:
        chunk = max(_round_up(nnz, 512), 512)
        nnz_pad = chunk
    else:
        num_chunks = -(-nnz // chunk)
        chunk = _round_up(-(-nnz // num_chunks), 512)
        nnz_pad = num_chunks * chunk
    pad = nnz_pad - nnz
    if pad:
        row = np.concatenate([row, np.zeros(pad, np.int32)])
        col = np.concatenate([col, np.zeros(pad, np.int32)])
        val = np.concatenate([val, np.zeros(pad, np.float32)])
    return COOAdj(
        torch.from_numpy(row), torch.from_numpy(col), torch.from_numpy(val),
        n_rows=adj.shape[0], n_cols=adj.shape[1], chunk=chunk,
    )


def build_ell(
    adj: sp.spmatrix,
    row_block: int = 256,
    width: Optional[int] = None,
    lane_pad: int = 8,
) -> ELLAdj:
    """Row-padded ELL; ``width`` defaults to the max degree rounded up to
    ``lane_pad``; a row longer than ``width`` raises (use COO or hybrid)."""
    csr = adj.tocsr()
    n, m = csr.shape
    deg = np.diff(csr.indptr)
    max_deg = int(deg.max()) if n else 0
    if width is None:
        width = _round_up(max(max_deg, 1), lane_pad)
    elif max_deg > width:
        raise ValueError(f"max degree {max_deg} exceeds ELL width {width}")
    n_pad = _round_up(max(n, 1), row_block)
    cols = np.zeros((n_pad, width), np.int32)
    vals = np.zeros((n_pad, width), np.float32)
    if csr.nnz:
        pos = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], deg)
        rows_of = np.repeat(np.arange(n), deg)
        cols[rows_of, pos] = csr.indices
        vals[rows_of, pos] = csr.data
    return ELLAdj(torch.from_numpy(cols), torch.from_numpy(vals),
                  n_rows=n, n_cols=m, row_block=row_block)


def build_hybrid(
    adj: sp.spmatrix,
    width: Optional[int] = None,
    width_percentile: float = 95.0,
    row_block: int = 256,
    chunk: int = 1 << 19,
) -> HybridAdj:
    """ELL part (first ``width`` neighbours per row; default p95 degree
    rounded up to 8) + row-sorted COO tail of the overflow edges."""
    from ssrg_torch import native

    csr = adj.tocsr()
    n, m = csr.shape
    if width is None:
        deg = np.diff(csr.indptr)
        width = int(np.percentile(deg, width_percentile)) if n else 1
        width = _round_up(max(width, 1), 8)
    n_pad = _round_up(max(n, 1), row_block)
    cols, vals, tr, tc, tv = native.ell_hybrid_pack(
        csr.indptr, csr.indices, csr.data, width, n_pad
    )
    ell = ELLAdj(torch.from_numpy(cols), torch.from_numpy(vals),
                 n_rows=n, n_cols=m, row_block=row_block)
    tail = sp.coo_matrix((tv, (tr, tc)), shape=(n, m))
    return HybridAdj(ell, build_coo(tail, chunk=chunk))


# "auto" crossover, as in the reference. The H100 dense/hybrid crossover is
# not measured yet.
DENSE_THRESHOLD = 8192


def device_adjacency(
    adj: sp.spmatrix,
    engine: str = "auto",
    dense_threshold: int = DENSE_THRESHOLD,
    device: DeviceLike = "cuda",
    **kwargs,
) -> Adjacency:
    """Pack a scipy adjacency for ``engine`` and move it to ``device``.

    ``auto`` is dense up to ``dense_threshold`` rows and hybrid above;
    ``pallas`` is the ELL + tail pack of :mod:`ssrg_torch.ops.pallas_spmm`
    (8-row blocks, p90 width) on the same kernel."""
    dev = resolve_device(device)
    if engine == "auto":
        engine = "dense" if adj.shape[0] <= dense_threshold else "hybrid"
    if engine == "dense":
        built = build_dense(adj, **kwargs)
    elif engine == "coo":
        built = build_coo(adj, **kwargs)
    elif engine == "ell":
        built = build_ell(adj, **kwargs)
    elif engine == "hybrid":
        built = build_hybrid(adj, **kwargs)
    elif engine == "pallas":
        from ssrg_torch.ops.pallas_spmm import build_pallas_csr

        built = build_pallas_csr(adj, **kwargs)
    elif engine in _UNPORTED_ENGINES:
        raise NotImplementedError(
            f"spmm engine {engine!r} is not ported yet: {LOCALITY_TIER}"
        )
    else:
        raise ValueError(f"unknown spmm engine: {engine!r}")
    return built.to(dev)
