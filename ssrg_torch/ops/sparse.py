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
- ``BandedAdj`` — windowed dense blocks of a locality-reordered (banded)
  graph; SpMM is a batched product of each block with its contiguous window
  of x (the plain version of :mod:`ssrg_torch.ops.banded_spmm`). The same
  pack on the hand-written kernel is ``ops.pallas_banded.PallasBandedAdj``.
- ``TiledAdj`` — dense tiles of a clustered graph plus a rest engine for the
  scattered edges (hybrid, blockcoo, or the segmented rest of
  :mod:`ssrg_torch.ops.pallas_rest`).
- ``BlockCOOAdj`` — COO bucketed by row bucket x column bucket.
- ``DifferentiableAdj`` — an ELL or hybrid pack under autograd: forward on
  the pack of A, backward (``A^T g``) on the pack of ``A^T``, both through
  the ELL kernel; :func:`differentiable_adjacency` builds it for the naive
  GCN path.

All engines accumulate in float32; banded blocks and tiles may be stored in
bf16, and their windows of x are then rounded to bf16 before the products.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple, Union

import numpy as np
import scipy.sparse as sp
import torch
from torch.autograd.function import once_differentiable

from ssrg_torch.logger import count, span
from ssrg_torch.ops.banded_spmm import banded_spmm_plain
from ssrg_torch.ops.ell_spmm import ell_spmm
from ssrg_torch.utils import DeviceLike, resolve_device

# f32 temporaries (tile groups, windows, products, gathered rows) the plain
# torch engines hold at once
_GROUP_BYTES = 1 << 28


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


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
    nnz: Optional[int] = None  # the real entries, padding left out (None: not known)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.n_cols)

    @property
    def nnz_padded(self) -> int:
        return int(self.row.shape[0])

    @property
    def chunks(self) -> int:
        return -(-self.nnz_padded // self.chunk)

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
    nnz: Optional[int] = None  # the real entries, padding left out (None: not known)

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
    the overflow edges of hub rows in a row-sorted COO tail.

    Its SpMM is the span ``spmm`` around the spans ``spmm.ell`` and
    ``spmm.tail``, both timed on the stream while a profiler runs, and
    counts the real entries each term carries (``spmm.ell_nnz``,
    ``spmm.tail_nnz``, where the pack knows them) and the tail's chunks
    (``spmm.tail_chunks``): host numbers of the pack, no device read."""

    ell: ELLAdj
    tail: COOAdj

    @property
    def shape(self) -> Tuple[int, int]:
        return self.ell.shape

    def spmm(self, x: torch.Tensor) -> torch.Tensor:
        with span("spmm"):
            if self.ell.nnz is not None:
                count("spmm.ell_nnz", self.ell.nnz)
            if self.tail.nnz is not None:
                count("spmm.tail_nnz", self.tail.nnz)
            count("spmm.tail_chunks", self.tail.chunks)
            with span("spmm.ell", device=True):
                out = self.ell.spmm(x)
            with span("spmm.tail", device=True):
                return self.tail.accumulate(out, x)

    def to(self, device: DeviceLike) -> "HybridAdj":
        return HybridAdj(self.ell.to(device), self.tail.to(device))


@dataclass
class BandedAdj:
    """Windowed dense-block ("banded") adjacency: for each ``row_block``-row
    block, one dense ``[row_block, window]`` block against the contiguous
    window of x that starts at its ``los`` entry (16-aligned, not clamped:
    window rows past ``N`` read as zero). SpMM is the batched product of
    :func:`ssrg_torch.ops.banded_spmm.banded_spmm_plain`, the counterpart of
    the reference's XLA ``lax.scan`` engine."""

    blocks: torch.Tensor  # f32 or bf16 [nb, row_block, window]
    los: torch.Tensor     # int32 [nb] window start per block
    n_rows: int
    n_cols: int
    row_block: int
    # rows the reference pads x to so that no window slice clips
    pad_to: int = 0

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.n_cols)

    @property
    def window(self) -> int:
        return int(self.blocks.shape[2])

    def spmm(self, x: torch.Tensor) -> torch.Tensor:
        _check_rows(x, self.n_cols)
        return banded_spmm_plain(self.blocks, self.los, x)[: self.n_rows]

    def to(self, device: DeviceLike) -> "BandedAdj":
        dev = resolve_device(device)
        return replace(self, blocks=self.blocks.to(dev), los=self.los.to(dev))


@dataclass
class TiledAdj:
    """Tile-sparse dense-block adjacency: one dense ``[row_block,
    tile_cols]`` tile for each (row block, column segment) pair that holds
    enough edges, against the contiguous window of x at ``starts``; the
    remaining edges go to ``rest``. SpMM multiplies groups of tiles with
    ``torch.bmm`` and adds them into their row blocks with ``index_add_``
    (the reference scans the tiles with XLA; neither is a Pallas kernel)."""

    tiles: torch.Tensor     # f32 or bf16 [P, row_block, tile_cols]
    starts: torch.Tensor    # int32 [P] column start per tile
    block_of: torch.Tensor  # int32 [P] destination row block per tile
    rest: "Adjacency"       # HybridAdj, BlockCOOAdj or RestSegmentedAdj
    n_rows: int
    n_cols: int
    tiled_fraction: float = 1.0

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.n_cols)

    @property
    def tile_stats(self) -> Tuple[int, int, int]:
        p, rb, tc = self.tiles.shape
        nb = -(-max(self.n_rows, 1) // rb)
        return nb, p, rb * tc

    def spmm(self, x: torch.Tensor) -> torch.Tensor:
        _check_rows(x, self.n_cols)
        p, rb, tc = self.tiles.shape
        f = x.shape[1]
        nb = -(-max(self.n_rows, 1) // rb)
        xp = x
        if tc > x.shape[0]:  # tiny graph
            xp = torch.cat([x, x.new_zeros((tc - x.shape[0], f))])
        if self.tiles.dtype == torch.bfloat16:
            xp = xp.to(torch.bfloat16).float()
        acc = torch.zeros((nb, rb, f), dtype=torch.float32, device=x.device)
        offs = torch.arange(tc, device=x.device)
        step = max(1, _GROUP_BYTES // (4 * (rb * tc + tc * f + rb * f)))
        for p0 in range(0, p, step):
            windows = xp[self.starts[p0:p0 + step].long()[:, None] + offs]
            prod = torch.bmm(self.tiles[p0:p0 + step].float(), windows)
            acc.index_add_(0, self.block_of[p0:p0 + step], prod)
        out = acc.view(nb * rb, f)[: self.n_rows]
        return out + self.rest.spmm(x)

    def to(self, device: DeviceLike) -> "TiledAdj":
        dev = resolve_device(device)
        return replace(self, tiles=self.tiles.to(dev), starts=self.starts.to(dev),
                       block_of=self.block_of.to(dev), rest=self.rest.to(dev))


@dataclass
class BlockCOOAdj:
    """COO bucketed by (column bucket, row bucket): ``[nb_c, nb_r, L]``
    arrays of bucket-local row and column ids, padded to the fullest bucket
    (pad entries: local row 0, local col 0, val 0). SpMM gathers each
    entry's row inside its column bucket's window of x and ``index_add_``s
    it into its row bucket."""

    rows: torch.Tensor  # int32 [nb_c, nb_r, L], local to the row bucket
    cols: torch.Tensor  # int32 [nb_c, nb_r, L], local to the column bucket
    vals: torch.Tensor  # f32   [nb_c, nb_r, L]
    n_rows: int
    n_cols: int
    row_bucket: int
    col_bucket: int

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_rows, self.n_cols)

    def spmm(self, x: torch.Tensor) -> torch.Tensor:
        _check_rows(x, self.n_cols)
        nb_c, nb_r, length = self.rows.shape
        f = x.shape[1]
        rb, cb = self.row_bucket, self.col_bucket
        out = torch.zeros((nb_r * rb, f), dtype=torch.float32, device=x.device)
        step = max(1, _GROUP_BYTES // (4 * max(f, 1)))
        for j in range(nb_c):
            xw = x[j * cb:(j + 1) * cb]
            for i in range(nb_r):
                dst = out[i * rb:(i + 1) * rb]
                for s in range(0, length, step):
                    c = self.cols[j, i, s:s + step]
                    v = self.vals[j, i, s:s + step]
                    dst.index_add_(0, self.rows[j, i, s:s + step],
                                   xw.index_select(0, c) * v[:, None])
        return out[: self.n_rows]

    def to(self, device: DeviceLike) -> "BlockCOOAdj":
        dev = resolve_device(device)
        return replace(self, rows=self.rows.to(dev), cols=self.cols.to(dev),
                       vals=self.vals.to(dev))


class _TransposedSpmm(torch.autograd.Function):
    """``A @ x`` on the forward pack; its gradient ``A^T g`` on the pack of
    ``A^T``. Both packs run the ELL kernel (its plain version on the CPU);
    the COO tail of a hybrid is a torch ``index_add_`` in both."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd.spmm(x)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        return ctx.bwd.spmm(grad_out.contiguous()), None, None


@dataclass
class DifferentiableAdj:
    """An ELL or hybrid adjacency whose SpMM carries gradients to ``x``.

    ``bwd`` is the same format packed from ``A^T`` (the same object when
    ``A`` equals ``A^T``): the gradient of ``A @ x`` is ``A^T @ g``, the same
    kernel on the transposed pack. A hybrid's transpose has its own width and
    its own tail. The reference's XLA engines get this from autodiff; the
    port's kernel writes through a raw pointer and has no gradient of its
    own. The adjacency's values take no gradient."""

    fwd: Union[ELLAdj, HybridAdj]
    bwd: Union[ELLAdj, HybridAdj]

    @property
    def shape(self) -> Tuple[int, int]:
        return self.fwd.shape

    @property
    def symmetric(self) -> bool:
        return self.bwd is self.fwd

    def spmm(self, x: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and x.requires_grad:
            return _TransposedSpmm.apply(x, self.fwd, self.bwd)
        return self.fwd.spmm(x)


Adjacency = Union[DenseAdj, COOAdj, ELLAdj, HybridAdj, BandedAdj, TiledAdj, BlockCOOAdj,
                  DifferentiableAdj]


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
        n_rows=adj.shape[0], n_cols=adj.shape[1], chunk=chunk, nnz=nnz,
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
                  n_rows=n, n_cols=m, row_block=row_block, nnz=int(csr.nnz))


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
                 n_rows=n, n_cols=m, row_block=row_block, nnz=int(csr.nnz) - int(tv.size))
    tail = sp.coo_matrix((tv, (tr, tc)), shape=(n, m))
    return HybridAdj(ell, build_coo(tail, chunk=chunk))


def build_banded(
    adj: sp.spmatrix,
    row_block: int = 256,
    lane_pad: int = 128,
    dtype: torch.dtype = torch.float32,
    mem_budget_bytes: int = 2 << 30,
) -> BandedAdj:
    """Pack a (locality-reordered) adjacency into windowed dense blocks.

    The window is the widest column span of a row block (from a 16-aligned
    start) rounded up to ``lane_pad``. Raises ``ValueError`` when the blocks
    would exceed ``mem_budget_bytes``: the graph is not banded enough
    (reorder it first, or use the hybrid engine)."""
    csr = adj.tocsr()
    n, m = csr.shape
    nb = -(-max(n, 1) // row_block)

    lo = np.zeros(nb, np.int64)
    hi = np.zeros(nb, np.int64)
    for b in range(nb):
        r0, r1 = b * row_block, min((b + 1) * row_block, n)
        cols_b = csr.indices[csr.indptr[r0]: csr.indptr[r1]]
        if cols_b.size:
            lo[b], hi[b] = cols_b.min(), cols_b.max()
    lo = (lo // 16) * 16
    window = int((hi - lo).max()) + 1 if n else 1
    window = _round_up(max(window, 1), lane_pad)
    need = nb * row_block * window * _itemsize(dtype)
    if need > mem_budget_bytes:
        raise ValueError(
            f"banded pack needs {need/2**30:.2f} GiB (window={window}) > "
            f"budget {mem_budget_bytes/2**30:.2f} GiB; graph is not banded "
            f"enough — RCM-reorder it or use engine='hybrid'"
        )
    pad_to = int((lo + window).max()) if n else window

    blocks = np.zeros((nb, row_block, window), np.float32)
    rows_of = np.repeat(np.arange(n), np.diff(csr.indptr))
    block_of = rows_of // row_block
    blocks[block_of, rows_of % row_block, csr.indices - lo[block_of]] = csr.data
    # the f32 pack is handed over without a copy; a bf16 pack is rounded once
    blocks_t = torch.from_numpy(blocks)
    if dtype != torch.float32:
        blocks_t = blocks_t.to(dtype)
    return BandedAdj(blocks_t, torch.from_numpy(lo.astype(np.int32)),
                     n_rows=n, n_cols=m, row_block=row_block, pad_to=pad_to)


def build_blockcoo(
    adj: sp.spmatrix,
    row_bucket: int = 1 << 18,
    col_bucket: int = 1 << 19,
    lane_pad: int = 512,
) -> BlockCOOAdj:
    """Pack any sparse matrix into the bucketed COO layout (entries grouped
    by column bucket, then row bucket, padded to the fullest bucket)."""
    coo = adj.tocoo()
    n, m = coo.shape
    nb_r = -(-max(n, 1) // row_bucket)
    nb_c = -(-max(m, 1) // col_bucket)
    key = (coo.col // col_bucket).astype(np.int64) * nb_r + coo.row // row_bucket
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    counts = np.bincount(key_s, minlength=nb_r * nb_c)
    length = _round_up(max(int(counts.max()), 1), lane_pad)
    starts = np.zeros(nb_r * nb_c, np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    pos = np.arange(key_s.size) - starts[key_s]
    rows = np.zeros((nb_c * nb_r, length), np.int32)
    cols = np.zeros((nb_c * nb_r, length), np.int32)
    vals = np.zeros((nb_c * nb_r, length), np.float32)
    rows[key_s, pos] = (coo.row[order] % row_bucket).astype(np.int32)
    cols[key_s, pos] = (coo.col[order] % col_bucket).astype(np.int32)
    vals[key_s, pos] = coo.data[order].astype(np.float32)
    shape = (nb_c, nb_r, length)
    return BlockCOOAdj(
        torch.from_numpy(rows.reshape(shape)), torch.from_numpy(cols.reshape(shape)),
        torch.from_numpy(vals.reshape(shape)),
        n_rows=n, n_cols=m, row_bucket=row_bucket, col_bucket=col_bucket,
    )


def build_tiled(
    adj: sp.spmatrix,
    row_block: int = 256,
    tile_cols: int = 512,
    min_edges_per_tile: int = 48,
    dtype: torch.dtype = torch.float32,
    mem_budget_bytes: int = 4 << 30,
    min_tiled_fraction: float = 0.25,
    device_scatter: bool = True,
    rest_engine: str = "auto",
    rest_gather_bf16: bool = False,
    device: DeviceLike = "cuda",
) -> TiledAdj:
    """Pack a clustered adjacency into dense tiles plus a rest engine.

    A (row block, column segment) pair becomes a tile when it holds at least
    ``min_edges_per_tile`` edges; each tile's window starts at its segment,
    clamped to ``m - tile_cols``. Raises ``ValueError`` when fewer than
    ``min_tiled_fraction`` of the edges land in tiles (the graph is not
    clustered enough) or the tiles would exceed ``mem_budget_bytes``.

    ``rest_engine`` packs the other edges: ``hybrid``, ``blockcoo``,
    ``onehot`` (:func:`ssrg_torch.ops.pallas_rest.build_rest_segmented`,
    row blocks and chunks of 1024), or ``auto``: above 2^19 nodes
    ``onehot`` when ``device`` is a CUDA device and the reference's slab
    estimate (F = 128, f32) stays within 3 GiB, else ``blockcoo``; hybrid
    below. ``device`` only steers that choice and the rest's executor; the
    pack is returned on the host. The tiles are always filled on the host:
    ``device_scatter`` is accepted for the reference's signature."""
    csr = adj.tocsr()
    n, m = csr.shape

    rows_of = np.repeat(np.arange(n), np.diff(csr.indptr))
    block_of = rows_of // row_block
    seg_of = csr.indices // tile_cols
    num_segs = -(-m // tile_cols)
    pair_key = block_of.astype(np.int64) * num_segs + seg_of
    uniq, counts = np.unique(pair_key, return_counts=True)
    dense_pairs = uniq[counts >= min_edges_per_tile]
    dense_set = np.isin(pair_key, dense_pairs)

    tiled_frac = dense_set.sum() / max(csr.nnz, 1)
    if tiled_frac < min_tiled_fraction:
        raise ValueError(
            f"only {tiled_frac:.1%} of edges fall in dense "
            f"{row_block}x{tile_cols} tiles (>= {min_edges_per_tile} edges); "
            f"graph is not clustered enough — use engine='hybrid'"
        )
    blocks_of_pairs = (dense_pairs // num_segs).astype(np.int64)
    segs_of_pairs = (dense_pairs % num_segs).astype(np.int64)
    p_num = len(dense_pairs)
    need = p_num * row_block * tile_cols * _itemsize(dtype)
    if need > mem_budget_bytes:
        raise ValueError(
            f"tiled pack needs {need/2**30:.2f} GiB ({p_num} tiles) > budget "
            f"{mem_budget_bytes/2**30:.2f} GiB"
        )
    pair_start = np.minimum(
        segs_of_pairs * tile_cols, max(m - tile_cols, 0)
    ).astype(np.int32)

    data = csr.data.astype(np.float32)
    cols = csr.indices
    dense_idx = np.where(dense_set)[0]
    pair_rank = np.searchsorted(dense_pairs, pair_key[dense_idx])

    rest_mask = ~dense_set
    rest = sp.coo_matrix(
        (data[rest_mask], (rows_of[rest_mask], cols[rest_mask])), shape=(n, m)
    ).tocsr()
    # the rest engines need at least one edge: add a zero-weight one
    if rest.nnz == 0:
        rest = sp.coo_matrix(
            (np.zeros(1, np.float32), ([0], [0])), shape=(n, m)
        ).tocsr()
    on_card = torch.device(device).type == "cuda"
    if rest_engine == "auto":
        if n > (1 << 19):
            slab_est = int(rest.nnz * 1.25) * 128 * 4
            rest_engine = "onehot" if on_card and slab_est <= (3 << 30) else "blockcoo"
        else:
            rest_engine = "hybrid"
    if rest_engine == "onehot":
        from ssrg_torch.ops.pallas_rest import build_rest_segmented

        rest_pack = build_rest_segmented(
            rest, row_block=1024, chunk=1024, gather_bf16=rest_gather_bf16,
            device=device,
        )
    elif rest_engine == "blockcoo":
        rest_pack = build_blockcoo(rest)
    else:
        rest_pack = build_hybrid(rest)

    tiles = np.zeros((p_num, row_block, tile_cols), np.float32)
    tiles[pair_rank, rows_of[dense_idx] % row_block,
          cols[dense_idx] - pair_start[pair_rank]] = data[dense_idx]
    tiles_t = torch.from_numpy(tiles)
    if dtype != torch.float32:
        tiles_t = tiles_t.to(dtype)
    return TiledAdj(
        tiles_t, torch.from_numpy(pair_start),
        torch.from_numpy(blocks_of_pairs.astype(np.int32)),
        rest_pack, n_rows=n, n_cols=m, tiled_fraction=float(tiled_frac),
    )


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
    (8-row blocks, p90 width) on the same kernel; ``pallas_banded`` is the
    banded pack on the kernel of :mod:`ssrg_torch.ops.banded_spmm`."""
    dev = resolve_device(device)
    if engine == "auto":
        engine = "dense" if adj.shape[0] <= dense_threshold else "hybrid"
    with span("prepare.pack"):
        built = _build(adj, engine, dev, kwargs)
    with span("prepare.copy"):
        if dev.type != "cpu":
            count("prepare.h2d_bytes", _host_bytes(built))
        return built.to(dev)


def _build(adj: sp.spmatrix, engine: str, dev: torch.device, kwargs: dict) -> Adjacency:
    if engine == "dense":
        return build_dense(adj, **kwargs)
    if engine == "coo":
        return build_coo(adj, **kwargs)
    if engine == "ell":
        return build_ell(adj, **kwargs)
    if engine == "hybrid":
        return build_hybrid(adj, **kwargs)
    if engine == "pallas":
        from ssrg_torch.ops.pallas_spmm import build_pallas_csr

        return build_pallas_csr(adj, **kwargs)
    if engine == "blockcoo":
        return build_blockcoo(adj, **kwargs)
    if engine == "banded":
        return build_banded(adj, **kwargs)
    if engine == "tiled":
        return build_tiled(adj, device=dev, **kwargs)
    if engine == "pallas_banded":
        from ssrg_torch.ops.pallas_banded import build_pallas_banded

        return build_pallas_banded(adj, **kwargs)
    raise ValueError(f"unknown spmm engine: {engine!r}")


def _host_bytes(pack) -> int:
    """The bytes of the host tensors a pack holds (nested packs included):
    what moving it to a device copies."""
    if torch.is_tensor(pack):
        return pack.nbytes if pack.device.type == "cpu" else 0
    fields = getattr(pack, "__dataclass_fields__", None)
    if fields is None:
        return 0
    return sum(_host_bytes(getattr(pack, name)) for name in fields)


def differentiable_adjacency(
    adj: sp.spmatrix,
    engine: str = "auto",
    device: DeviceLike = "cuda",
) -> Adjacency:
    """:func:`device_adjacency` for a path that differentiates through the
    SpMM (the naive GCN's layers). An ELL or hybrid pack comes back as a
    :class:`DifferentiableAdj` whose gradient runs the kernel on the pack of
    ``A^T``, built here on the host next to the forward pack; that pack is
    reused only when ``A`` equals ``A^T`` exactly. The other packs come back
    as they are: dense and coo are torch operations, and ``pallas`` stays
    forward-only, as in the reference, where jax cannot differentiate its
    ``pallas_call``."""
    dev = resolve_device(device)
    fwd = device_adjacency(adj, engine, device=dev)
    if not isinstance(fwd, (ELLAdj, HybridAdj)):
        return fwd
    with span("prepare.symmetry_test"):
        symmetric = adj.shape[0] == adj.shape[1] and (adj != adj.T).nnz == 0
    if symmetric:
        return DifferentiableAdj(fwd, fwd)
    packed_as = "hybrid" if isinstance(fwd, HybridAdj) else "ell"
    return DifferentiableAdj(fwd, device_adjacency(adj.T.tocsr(), packed_as, device=dev))
