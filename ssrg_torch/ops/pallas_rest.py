"""The segmented ("onehot") rest engine (counterpart of
``ssrg_tpu/ops/pallas_rest.py``).

The scattered edges that a tiled pack leaves over are sorted by destination
row, grouped by ``row_block``-row block, and cut into chunks of ``chunk``
entries that each belong to one block (each block's list padded to a whole
chunk with entries of local row 0, col 0, val 0). Two executors read that
layout:

- :meth:`RestSegmentedAdj.spmm_xla`, the counterpart of the reference's XLA
  executor: gather the chunk's scaled neighbour rows, reduce them as a
  one-hot matrix product into the chunk's row block. Plain torch.
- :meth:`RestSegmentedAdj.spmm_pallas`: the hand-written CUDA kernel of
  :mod:`ssrg_torch.ops.rest_spmm` (its plain version on the CPU), which
  fuses the gather into the segmented sum and never builds the gathered
  ``[P, chunk, F]`` slab. ``spmm_engine="reorder_tiled"`` with ``spmm_bf16``
  runs it on the card.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ssrg_torch.ops.rest_spmm import rest_spmm
from ssrg_torch.ops.sparse import _GROUP_BYTES, _check_rows
from ssrg_torch.utils import DeviceLike, resolve_device


@dataclass
class RestSegmentedAdj:
    """Sorted COO in the flat chunk -> row-block layout.

    - ``rows``     int32 ``[P, C]`` destination rows local to the chunk's block
    - ``cols``     int32 ``[P, C]`` column indices
    - ``vals``     f32   ``[P, C]``
    - ``block_of`` int32 ``[P]`` destination row block of each chunk (sorted)
    - ``row_ptr``  int64 ``[nb * row_block + 1]``: the entries of output row
      ``r`` are the flat positions ``[row_ptr[r], row_ptr[r+1])`` of the
      layout (a block's pad entries fall in its last row's range)
    - ``row_end``  int64 ``[nb * row_block]``: one past row ``r``'s last real
      entry; ``row_ptr[r+1]`` except on a block's last row, where it stops
      before the block's pad entries
    """

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    block_of: torch.Tensor
    row_ptr: torch.Tensor
    row_end: torch.Tensor
    n_rows: int
    n_cols: int
    row_block: int
    # round x, the weights and their products to bf16 (sums stay f32)
    gather_bf16: bool = False
    # the executor ``spmm`` runs: "xla" or "pallas"
    default_executor: str = "xla"

    # The reference's Pallas executor materializes the gathered [P, C, F]
    # slab and refuses above this size. The fused kernel builds no slab, but
    # the same guard keeps the same graphs on the same path as the reference.
    MAX_GATHER_BYTES = 10 << 30

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.n_cols)

    @property
    def num_chunks(self) -> int:
        return int(self.rows.shape[0])

    @property
    def chunk(self) -> int:
        return int(self.rows.shape[1])

    @property
    def nb(self) -> int:
        return -(-self.n_rows // self.row_block)

    def spmm(self, x: torch.Tensor) -> torch.Tensor:
        """Run the configured executor (``default_executor``)."""
        if self.default_executor == "pallas":
            return self.spmm_pallas(x)
        return self.spmm_xla(x)

    def spmm_xla(self, x: torch.Tensor) -> torch.Tensor:
        """One-hot reduce: for each group of chunks, the scaled neighbour
        rows ``[g, C, F]``, the one-hot ``[g, rb, C]`` of their local rows,
        one ``torch.bmm`` and an ``index_add_`` into the row blocks."""
        _check_rows(x, self.n_cols)
        rb, c, f = self.row_block, self.chunk, x.shape[1]
        xg = x.to(torch.bfloat16) if self.gather_bf16 else x
        acc = torch.zeros((self.nb, rb, f), dtype=torch.float32, device=x.device)
        iota = torch.arange(rb, device=x.device, dtype=torch.int32)[None, :, None]
        step = max(1, _GROUP_BYTES // (4 * (rb * c + c * f + rb * f)))
        for p0 in range(0, self.num_chunks, step):
            cols = self.cols[p0:p0 + step]
            g = xg.index_select(0, cols.reshape(-1)).view(*cols.shape, f)
            g = g * self.vals[p0:p0 + step, :, None].to(xg.dtype)
            onehot = (iota == self.rows[p0:p0 + step, None, :]).float()
            acc.index_add_(0, self.block_of[p0:p0 + step], torch.bmm(onehot, g.float()))
        return acc.view(-1, f)[: self.n_rows]

    def spmm_pallas(self, x: torch.Tensor) -> torch.Tensor:
        """The fused segmented-sum kernel. Refuses, with the reference's
        ``ValueError``, a layout whose gathered slab the reference's Pallas
        executor would not build."""
        itemsize = 2 if self.gather_bf16 else 4
        f_pad = (x.shape[1] + 127) // 128 * 128
        g_bytes = self.num_chunks * self.chunk * f_pad * itemsize
        if g_bytes > self.MAX_GATHER_BYTES:
            raise ValueError(
                f"pallas rest engine would materialize a "
                f"{g_bytes / 2**30:.1f} GiB gathered slab "
                f"({self.num_chunks} chunks x {self.chunk} x {f_pad} "
                f"@ {itemsize} B) > the {self.MAX_GATHER_BYTES / 2**30:.0f} "
                f"GiB budget. Remedies: gather_bf16=True (halves it), "
                f"row-partition the graph first, or use the hybrid/blockcoo "
                f"rest engines which stream without materializing."
            )
        _check_rows(x, self.n_cols)
        out = rest_spmm(self.row_ptr, self.row_end, self.cols, self.vals, x, self.gather_bf16)
        return out[: self.n_rows]

    def to(self, device: DeviceLike) -> "RestSegmentedAdj":
        dev = resolve_device(device)
        return replace(self, rows=self.rows.to(dev), cols=self.cols.to(dev),
                       vals=self.vals.to(dev), block_of=self.block_of.to(dev),
                       row_ptr=self.row_ptr.to(dev), row_end=self.row_end.to(dev))


def build_rest_segmented(
    adj: sp.spmatrix,
    row_block: int = 256,
    chunk: int = 512,
    gather_bf16: bool = False,
    default_executor: str = "auto",
    device: DeviceLike = "cuda",
) -> RestSegmentedAdj:
    """Host pack: sort the entries by (row, col), bucket them by row block,
    pad each block's list to a multiple of ``chunk`` (an edge-free block
    gets one all-pad chunk), emit the flat ``[P, C]`` arrays, ``block_of``
    and the derived ``row_ptr`` and ``row_end``. ``default_executor="auto"``
    is ``pallas`` (the kernel) when ``device`` is a CUDA device, ``xla`` on the CPU;
    ``device`` steers only that choice, and the pack is returned on the
    host."""
    coo = adj.tocoo()
    n_rows, n_cols = coo.shape
    r = coo.row.astype(np.int64)
    c = coo.col.astype(np.int64)
    v = coo.data.astype(np.float32)
    order = np.lexsort((c, r))
    r, c, v = r[order], c[order], v[order]
    blk = r // row_block
    nb = -(-n_rows // row_block)

    rows_chunks, cols_chunks, vals_chunks, block_of = [], [], [], []
    chunks_of_block = np.zeros(nb, np.int64)
    starts = np.searchsorted(blk, np.arange(nb + 1))
    for b in range(nb):
        lo, hi = int(starts[b]), int(starts[b + 1])
        cnt = hi - lo
        k = max(1, -(-cnt // chunk))
        pad = k * chunk - cnt
        rows_chunks.append(np.concatenate([r[lo:hi] - b * row_block,
                                           np.zeros(pad, np.int64)]).reshape(k, chunk))
        cols_chunks.append(np.concatenate([c[lo:hi], np.zeros(pad, np.int64)]).reshape(k, chunk))
        vals_chunks.append(np.concatenate([v[lo:hi], np.zeros(pad, np.float32)]).reshape(k, chunk))
        block_of.append(np.full(k, b, np.int32))
        chunks_of_block[b] = k
    if not rows_chunks:  # no rows: one all-pad chunk
        rows_chunks = [np.zeros((1, chunk), np.int64)]
        cols_chunks = [np.zeros((1, chunk), np.int64)]
        vals_chunks = [np.zeros((1, chunk), np.float32)]
        block_of = [np.zeros(1, np.int32)]

    # row r of block b starts after the chunks of blocks < b and the entries
    # of block b's rows < r, and ends before those of its rows <= r: on the
    # block's last row that is before the block's pad entries
    first_chunk = np.concatenate([[0], np.cumsum(chunks_of_block)])
    out_rows = np.arange(nb * row_block)
    b_of = out_rows // row_block
    block_start = first_chunk[b_of] * chunk - starts[b_of]
    row_ptr = np.empty(nb * row_block + 1, np.int64)
    row_ptr[:-1] = block_start + np.searchsorted(r, out_rows)
    row_ptr[-1] = first_chunk[-1] * chunk
    row_end = block_start + np.searchsorted(r, out_rows + 1)

    if default_executor == "auto":
        default_executor = "pallas" if torch.device(device).type == "cuda" else "xla"
    return RestSegmentedAdj(
        rows=torch.from_numpy(np.concatenate(rows_chunks).astype(np.int32)),
        cols=torch.from_numpy(np.concatenate(cols_chunks).astype(np.int32)),
        vals=torch.from_numpy(np.concatenate(vals_chunks)),
        block_of=torch.from_numpy(np.concatenate(block_of)),
        row_ptr=torch.from_numpy(row_ptr),
        row_end=torch.from_numpy(row_end),
        n_rows=n_rows, n_cols=n_cols, row_block=row_block,
        gather_bf16=gather_bf16, default_executor=default_executor,
    )
