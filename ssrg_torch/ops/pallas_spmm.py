"""The ``pallas`` engine (counterpart of ``ssrg_tpu/ops/pallas_spmm.py``).

In the reference this engine is the ELL pack evaluated by the Pallas TPU
kernel ``_spmm_kernel`` in 8-row blocks, with the p90-degree width and the
overflow edges in a COO tail added outside the kernel. Here the same pack
runs on the hand-written CUDA kernel of :mod:`ssrg_torch.ops.ell_spmm`,
which also carries the hybrid engine's ELL part; only the pack differs
(``ROW_BLOCK`` = 8 rows of padding and the p90 width).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ssrg_torch.ops import _nvcc
from ssrg_torch.ops.ell_spmm import ell_spmm
from ssrg_torch.ops.sparse import COOAdj, _check_rows, _round_up, build_coo
from ssrg_torch.utils import DeviceLike, resolve_device

ROW_BLOCK = 8  # rows of padding, as the reference's grid step
NO_GRAD = ("forward only, as the reference's pallas engine, whose pallas_call jax "
           "cannot differentiate (ROADMAP.md section 3); use engine 'hybrid'")


@dataclass
class PallasELLAdj:
    """ELL pack on the kernel plus a COO tail for rows longer than
    ``width``. Forward only, as in the reference, where jax cannot
    differentiate the ``pallas_call``: asked for a gradient, it raises. The
    precompute needs none; the naive GCN differentiates through the hybrid
    engine (:func:`ssrg_torch.ops.sparse.differentiable_adjacency`)."""

    cols: torch.Tensor  # int32 [n_pad, width]
    vals: torch.Tensor  # f32   [n_pad, width]
    tail: COOAdj
    n_rows: int
    n_cols: int

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.n_cols)

    @property
    def width(self) -> int:
        return int(self.cols.shape[1])

    def spmm(self, x: torch.Tensor) -> torch.Tensor:
        _check_rows(x, self.n_cols)
        _nvcc.refuse_grad("pallas engine", NO_GRAD, x=x)
        out = ell_spmm(self.cols, self.vals, x)[: self.n_rows]
        return self.tail.accumulate(out, x)

    def to(self, device: DeviceLike) -> "PallasELLAdj":
        dev = resolve_device(device)
        return replace(self, cols=self.cols.to(dev), vals=self.vals.to(dev),
                       tail=self.tail.to(dev))


def build_pallas_csr(
    adj: sp.spmatrix,
    width: Optional[int] = None,
    width_percentile: float = 90.0,
    chunk: int = 1 << 19,
) -> PallasELLAdj:
    """Pack a scipy adjacency as the reference's ``build_pallas_csr`` does:
    width = the p90 degree (at least 1), rows padded to ``ROW_BLOCK``."""
    from ssrg_torch import native

    csr = adj.tocsr()
    n, m = csr.shape
    deg = np.diff(csr.indptr)
    if width is None:
        width = int(np.percentile(deg, width_percentile)) if n else 1
        width = max(int(width), 1)
    n_pad = _round_up(max(n, 1), ROW_BLOCK)
    cols, vals, tr, tc, tv = native.ell_hybrid_pack(
        csr.indptr, csr.indices, csr.data, width, n_pad
    )
    tail = sp.coo_matrix((tv, (tr, tc)), shape=(n, m))
    return PallasELLAdj(
        torch.from_numpy(cols), torch.from_numpy(vals), build_coo(tail, chunk=chunk),
        n_rows=n, n_cols=m,
    )
