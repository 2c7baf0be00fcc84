"""The ``pallas_banded`` engine (counterpart of ``ssrg_tpu/ops/pallas_banded.py``).

In the reference this engine is the banded pack (``ops.sparse.BandedAdj``)
evaluated by the Pallas TPU kernel ``_banded_kernel``, which DMAs each row
block's window of x ahead of the block's matrix product. Here the same pack
runs on the hand-written CUDA kernel of :mod:`ssrg_torch.ops.banded_spmm`
(its plain version on the CPU). ``spmm_engine="reorder_banded"`` picks this
engine on the card.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

import scipy.sparse as sp
import torch

from ssrg_torch.ops.banded_spmm import banded_spmm
from ssrg_torch.ops.sparse import _check_rows, build_banded
from ssrg_torch.utils import DeviceLike, resolve_device


@dataclass
class PallasBandedAdj:
    """The banded pack on the kernel. ``window_bf16`` rounds the window of x
    to bf16 before the products (always so for bf16 blocks); sums stay f32.
    Forward only, as in the reference: the precompute needs no gradient."""

    blocks: torch.Tensor  # f32 or bf16 [nb, row_block, window]
    los: torch.Tensor     # int32 [nb]
    n_rows: int
    n_cols: int
    row_block: int
    pad_to: int = 0
    window_bf16: bool = False

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.n_cols)

    @property
    def window(self) -> int:
        return int(self.blocks.shape[2])

    def spmm(self, x: torch.Tensor) -> torch.Tensor:
        _check_rows(x, self.n_cols)
        return banded_spmm(self.blocks, self.los, x, self.window_bf16)[: self.n_rows]

    def to(self, device: DeviceLike) -> "PallasBandedAdj":
        dev = resolve_device(device)
        return replace(self, blocks=self.blocks.to(dev), los=self.los.to(dev))


def build_pallas_banded(
    adj: sp.spmatrix,
    row_block: int = 256,
    lane_pad: int = 128,
    dtype: torch.dtype = torch.float32,
    mem_budget_bytes: int = 2 << 30,
    window_bf16: bool = False,
) -> PallasBandedAdj:
    """Pack with :func:`ssrg_torch.ops.sparse.build_banded` (which raises
    ``ValueError`` when the graph is not banded enough), evaluate on the
    kernel."""
    banded = build_banded(adj, row_block=row_block, lane_pad=lane_pad, dtype=dtype,
                          mem_budget_bytes=mem_budget_bytes)
    return PallasBandedAdj(
        banded.blocks, banded.los, banded.n_rows, banded.n_cols, banded.row_block,
        pad_to=banded.pad_to, window_bf16=window_bf16,
    )
