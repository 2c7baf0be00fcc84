"""Host-side graph partitioner (counterpart of ``ssrg_tpu/parallel/partition.py``):
1-D row partitions of a CSR adjacency, in host numpy and scipy only.

Each shard owns a contiguous block of adjacency rows (padded to equal size)
and the matching block of node features; every shard's arrays have one
shape, so they stack along a leading shard axis. Column indices stay
global, or, with a halo plan, index each shard's gather table ``[own block
‖ received halo rows]``. The planners are the reference's, array for array:

- :class:`RowPartition`: padded COO per shard (what ``data/streaming.py``
  spools);
- :class:`HybridPartition`: ELL slots plus a COO tail per shard, packed by
  :func:`ssrg_torch.native.ell_hybrid_pack`;
- :class:`TiledPartition`: dense tiles plus a hybrid rest, tiled in each
  shard's table coordinates;
- :func:`cluster_reorder_for_partition`: community renumbering, so that
  shard boundaries follow clusters and the halo stays small.

:mod:`ssrg_torch.parallel.dist_spmm` places one shard on each rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import scipy.sparse as sp


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class RowPartition:
    """Per-shard padded COO blocks, stackable along a leading shard axis.

    - ``rows``   int32 [D, nnz_pad]  row index LOCAL to the shard's block
    - ``cols``   int32 [D, nnz_pad]  GLOBAL column index
    - ``vals``   f32   [D, nnz_pad]  weight (0 on padding)
    - ``block``  rows per shard (n_pad / D)
    - ``n``      true number of rows/cols (square adjacency)
    """

    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    block: int
    n: int

    @property
    def num_shards(self) -> int:
        return self.rows.shape[0]

    @property
    def n_pad(self) -> int:
        return self.block * self.num_shards


def partition_rows(adj: sp.spmatrix, num_shards: int, row_align: int = 8
                   ) -> RowPartition:
    """Split a square CSR adjacency into ``num_shards`` contiguous row blocks,
    rows padded to a common block size and nnz to the largest shard's
    (rounded up to 512), so that all shards have one shape."""
    csr = adj.tocsr()
    n = csr.shape[0]
    block = _round_up(-(-n // num_shards), row_align)

    shard_data = []
    max_nnz = 1
    for d in range(num_shards):
        lo = d * block
        hi = min(lo + block, n)
        if lo >= n:
            sub = sp.csr_matrix((0, csr.shape[1]))
        else:
            sub = csr[lo:hi]
        coo = sub.tocoo()
        shard_data.append((coo.row, coo.col, coo.data))
        max_nnz = max(max_nnz, coo.nnz)

    nnz_pad = _round_up(max_nnz, 512)
    rows = np.zeros((num_shards, nnz_pad), np.int32)
    cols = np.zeros((num_shards, nnz_pad), np.int32)
    vals = np.zeros((num_shards, nnz_pad), np.float32)
    for d, (r, c, v) in enumerate(shard_data):
        k = r.shape[0]
        rows[d, :k] = r
        cols[d, :k] = c
        vals[d, :k] = v
    return RowPartition(rows, cols, vals, block=block, n=n)


def pad_features(x: np.ndarray, part: RowPartition) -> np.ndarray:
    """Zero-pad node features to the partition's padded row count."""
    pad = part.n_pad - x.shape[0]
    if pad == 0:
        return x
    return np.concatenate([x, np.zeros((pad, x.shape[1]), x.dtype)], axis=0)


# ---------------------------------------------------------------------------
# Sharded hybrid (ELL + COO) partition
# ---------------------------------------------------------------------------


@dataclass
class HybridPartition:
    """Per-shard ELL + COO hybrid blocks, stackable along a leading shard axis:
    each shard's row block in the single-device hybrid layout, shapes
    equalized across shards.

    - ``ell_cols``/``ell_vals``  [D, block, width]   per-row regular slots
    - ``tail_rows/cols/vals``    [D, tail_pad]       hub-overflow COO
    - column indices are GLOBAL (all-gather mode) or LOCAL-TABLE indices
      (halo mode): own rows at [0, block), then the received halo buffer at
      ``block + src·halo_pad + j``.
    - ``tail_chunk``: the nnz chunk the tail is processed in.
    """

    ell_cols: np.ndarray
    ell_vals: np.ndarray
    tail_rows: np.ndarray
    tail_cols: np.ndarray
    tail_vals: np.ndarray
    block: int
    n: int
    width: int
    tail_chunk: int
    # halo-exchange plan (None => all-gather mode, columns global)
    send_idx: Optional[np.ndarray] = None   # int32 [D, D, halo_pad]
    halo_pad: int = 0
    halo_fraction: float = 0.0              # mean true-halo rows / block

    @property
    def num_shards(self) -> int:
        return self.ell_cols.shape[0]

    @property
    def n_pad(self) -> int:
        return self.block * self.num_shards

    @property
    def local_table_rows(self) -> int:
        """Rows of the per-shard gather table the column indices address."""
        if self.send_idx is None:
            return self.n_pad
        return self.block + self.num_shards * self.halo_pad


def _build_halo_plan(
    shard_cols: list, num_shards: int, block: int, lane_pad: int,
):
    """The static halo send/recv plan shared by the hybrid and tiled
    partitioners.

    ``shard_cols[d]`` is the (possibly repeated) GLOBAL column indices shard
    ``d``'s edges reference. Returns ``(send_idx, halo_pad, halo_fraction,
    col_maps)``: ``send_idx[src, dst]`` lists the local row ids src ships to
    dst each hop (padded to the largest pair, so that the exchange has one
    shape), and ``col_maps[d] = (sorted_halo_cols, table_idx)`` maps each
    non-local column to its position in the receiver's gather table
    ``[own block ‖ recv buffer]``."""
    halos = []      # per shard: sorted unique non-local global cols
    for d, cols in enumerate(shard_cols):
        cols_d = np.unique(cols)
        own = (cols_d >= d * block) & (cols_d < (d + 1) * block)
        halos.append(cols_d[~own].astype(np.int64))
    sizes = [
        [int(((h // block) == src).sum()) for src in range(num_shards)]
        for h in halos
    ]
    halo_pad = max(
        1, _round_up(max((max(s) for s in sizes), default=1), lane_pad)
    )
    send_idx = np.zeros((num_shards, num_shards, halo_pad), np.int32)
    for dst in range(num_shards):
        h = halos[dst]
        owner = h // block
        for src in range(num_shards):
            rows_src = (h[owner == src] - src * block).astype(np.int32)
            send_idx[src, dst, : rows_src.size] = rows_src
    halo_fraction = float(np.mean([len(h) for h in halos]) / max(block, 1))
    col_maps = []
    for d, h in enumerate(halos):
        owner = h // block
        group_start = np.searchsorted(owner, np.arange(num_shards))
        j = np.arange(h.size) - group_start[owner]
        table_idx = (block + owner * halo_pad + j).astype(np.int64)
        col_maps.append((h, table_idx))
    return send_idx, halo_pad, halo_fraction, col_maps


def _remap_cols(
    cols: np.ndarray, d: int, block: int, col_map,
) -> np.ndarray:
    """Remap global columns into shard ``d``'s local gather table
    ``[own block ‖ recv buffer]`` per the halo plan's ``col_map``."""
    own = (cols >= d * block) & (cols < (d + 1) * block)
    out = np.empty(cols.shape, np.int64)
    out[own] = cols[own] - d * block
    h, table_idx = col_map
    out[~own] = table_idx[np.searchsorted(h, cols[~own])]
    return out.astype(np.int32)


def _tail_geometry(max_tail: int, tail_chunk: int):
    """The tail's chunk and padded length (``ops.sparse.build_coo``'s rule):
    one 512-aligned chunk up to ``tail_chunk`` entries, else the chunk count
    first and a chunk shrunk to fit."""
    if max_tail <= tail_chunk:
        tail_chunk = max(_round_up(max_tail, 512), 512)
        return tail_chunk, tail_chunk
    num_chunks = -(-max_tail // tail_chunk)
    tail_chunk = _round_up(-(-max_tail // num_chunks), 512)
    return tail_chunk, num_chunks * tail_chunk


def partition_rows_hybrid(
    adj: sp.spmatrix,
    num_shards: int,
    width: Optional[int] = None,
    width_percentile: float = 95.0,
    row_align: int = 256,
    halo: bool = False,
    tail_chunk: int = 1 << 19,
    lane_pad: int = 8,
) -> HybridPartition:
    """Row-partition a CSR adjacency into stacked per-shard ELL + COO blocks.

    ``width`` defaults to the GLOBAL p95 degree (one width for all shards).
    With ``halo=True`` the static send/recv plan of :func:`_build_halo_plan`
    is built and every edge column remapped into the receiver's local
    gather table ``[own block ‖ recv buffer]``."""
    from ssrg_torch import native

    csr = adj.tocsr()
    n = csr.shape[0]
    if csr.shape[1] != n:
        raise ValueError("partition_rows_hybrid expects a square adjacency")
    block = _round_up(-(-n // num_shards), row_align)
    deg = np.diff(csr.indptr)
    if width is None:
        width = int(np.percentile(deg, width_percentile)) if n else 1
        width = _round_up(max(width, 1), lane_pad)

    # per-shard local CSR slices (rows local to the block)
    subs = []
    for d in range(num_shards):
        lo, hi = d * block, min((d + 1) * block, n)
        subs.append(
            csr[lo:hi] if lo < n else sp.csr_matrix((0, n), dtype=csr.dtype)
        )

    send_idx = None
    halo_pad = 0
    halo_fraction = 0.0
    col_maps: list = [None] * num_shards
    if halo:
        send_idx, halo_pad, halo_fraction, col_maps = _build_halo_plan(
            [sub.indices for sub in subs], num_shards, block, lane_pad
        )

    def _remap(d: int, cols: np.ndarray) -> np.ndarray:
        if not halo:
            return cols.astype(np.int32)
        return _remap_cols(cols, d, block, col_maps[d])

    # per-shard hybrid pack (shapes equalized across shards)
    packed = []
    max_tail = 1
    for d, sub in enumerate(subs):
        cols_r = _remap(d, sub.indices.astype(np.int64))
        sub_r = sp.csr_matrix(
            (sub.data.astype(np.float32), cols_r,
             np.concatenate([sub.indptr,
                             np.full(block - sub.shape[0], sub.indptr[-1],
                                     sub.indptr.dtype)])
             if sub.shape[0] < block else sub.indptr),
            shape=(block, max(int(cols_r.max()) + 1 if cols_r.size else 1, 1)),
        )
        ec, ev, tr, tc, tv = native.ell_hybrid_pack(
            sub_r.indptr, sub_r.indices, sub_r.data, width, block
        )
        packed.append((ec, ev, tr, tc, tv))
        max_tail = max(max_tail, tr.size)

    tail_chunk, tail_pad = _tail_geometry(max_tail, tail_chunk)
    ell_cols = np.stack([p[0] for p in packed])
    ell_vals = np.stack([p[1] for p in packed])
    tail_rows = np.zeros((num_shards, tail_pad), np.int32)
    tail_cols = np.zeros((num_shards, tail_pad), np.int32)
    tail_vals = np.zeros((num_shards, tail_pad), np.float32)
    for d, (_, _, tr, tc, tv) in enumerate(packed):
        tail_rows[d, : tr.size] = tr
        tail_cols[d, : tc.size] = tc
        tail_vals[d, : tv.size] = tv
    return HybridPartition(
        ell_cols, ell_vals, tail_rows, tail_cols, tail_vals,
        block=block, n=n, width=width, tail_chunk=tail_chunk,
        send_idx=send_idx, halo_pad=halo_pad, halo_fraction=halo_fraction,
    )


# ---------------------------------------------------------------------------
# Sharded tiled partition
# ---------------------------------------------------------------------------


@dataclass
class TiledPartition:
    """Per-shard dense-tile + hybrid-rest blocks, stackable along a leading
    shard axis: :class:`~ssrg_torch.ops.sparse.TiledAdj`'s layout under the
    1-D row partition.

    Tiling happens in TABLE space: every edge column is first mapped into
    the per-shard gather table (``[own block ‖ recv buffer]`` in halo mode,
    the full gathered X otherwise), and any ``[row_block × tile_cols]`` cell
    of that table holding at least ``min_edges_per_tile`` edges packs into a
    dense tile, so that dense off-diagonal bundles tile against the halo
    buffer's contiguous segments too. Everything else spills into the
    :class:`HybridPartition` rest layout, addressing the same table.

    - ``tiles``     f32  [D, P_pad, row_block, tile_cols] (zero pad tiles)
    - ``starts``    int32 [D, P_pad] column start of each tile in TABLE
      coordinates (multiples of ``tile_cols``; 0 on padding)
    - ``block_of``  int32 [D, P_pad] destination row block within the shard
    - rest arrays and halo plan exactly as :class:`HybridPartition`
    """

    tiles: np.ndarray
    starts: np.ndarray
    block_of: np.ndarray
    ell_cols: np.ndarray
    ell_vals: np.ndarray
    tail_rows: np.ndarray
    tail_cols: np.ndarray
    tail_vals: np.ndarray
    block: int
    n: int
    width: int
    tail_chunk: int
    row_block: int
    tile_cols: int
    tiled_fraction: float
    send_idx: Optional[np.ndarray] = None   # int32 [D, D, halo_pad]
    halo_pad: int = 0
    halo_fraction: float = 0.0

    @property
    def num_shards(self) -> int:
        return self.tiles.shape[0]

    @property
    def n_pad(self) -> int:
        return self.block * self.num_shards

    @property
    def local_table_rows(self) -> int:
        if self.send_idx is None:
            return self.n_pad
        return self.block + self.num_shards * self.halo_pad


def partition_rows_tiled(
    adj: sp.spmatrix,
    num_shards: int,
    row_block: int = 256,
    tile_cols: int = 512,
    min_edges_per_tile: int = 48,
    width: Optional[int] = None,
    width_percentile: float = 95.0,
    halo: bool = True,
    tail_chunk: int = 1 << 19,
    lane_pad: int = 8,
) -> TiledPartition:
    """Row-partition a CSR adjacency into per-shard dense tiles + hybrid rest.

    Meant to run after :func:`cluster_reorder_for_partition` (shard
    boundaries that follow communities make the table blocks tile-dense and
    the halo small). The tiles are packed on the host in each shard's TABLE
    coordinates (see :class:`TiledPartition`)."""
    from ssrg_torch import native

    csr = adj.tocsr()
    n = csr.shape[0]
    if csr.shape[1] != n:
        raise ValueError("partition_rows_tiled expects a square adjacency")
    row_align = int(np.lcm(row_block, tile_cols))
    block = _round_up(-(-n // num_shards), row_align)

    # per-shard COO (rows local, cols global)
    shard_coos = []
    for d in range(num_shards):
        lo = d * block
        sub = (csr[lo: min(lo + block, n)] if lo < n
               else sp.csr_matrix((0, n), dtype=csr.dtype)).tocoo()
        shard_coos.append((
            sub.row.astype(np.int64), sub.col.astype(np.int64),
            sub.data.astype(np.float32),
        ))

    # the halo plan from ALL referenced columns (the same plan as from the
    # rest's columns alone: tiled diagonal edges are local, and off-diagonal
    # columns cross shards whether a tile or the rest consumes them)
    send_idx = None
    halo_pad = 0
    halo_fraction = 0.0
    col_maps: list = [None] * num_shards
    if halo:
        send_idx, halo_pad, halo_fraction, col_maps = _build_halo_plan(
            [c for _, c, _ in shard_coos], num_shards, block, lane_pad
        )
        table_rows = block + num_shards * halo_pad
    else:
        table_rows = block * num_shards
    # tile-grid column segments span the whole gather table
    num_segs = -(-table_rows // tile_cols)

    shard_tiles: list = []       # per shard: (tiles [P_d, rb, tc], starts, blks)
    rest_csrs: list = []         # per shard: (indptr, table cols, data)
    dense_edges = 0
    for d in range(num_shards):
        r, c, v = shard_coos[d]
        c_t = (_remap_cols(c, d, block, col_maps[d]).astype(np.int64)
               if halo else c)
        key = (r // row_block) * num_segs + c_t // tile_cols
        uniq, inv, counts = np.unique(key, return_inverse=True,
                                      return_counts=True)
        dense_key = counts >= min_edges_per_tile
        is_dense = dense_key[inv]
        dense_edges += int(is_dense.sum())

        dkeys = uniq[dense_key]
        rank = np.full(uniq.shape, -1, np.int64)
        rank[dense_key] = np.arange(dkeys.size)
        p_d = int(dkeys.size)
        tiles_d = np.zeros((max(p_d, 1), row_block, tile_cols), np.float32)
        if p_d:
            e = is_dense
            flat = (rank[inv[e]] * row_block * tile_cols
                    + (r[e] % row_block) * tile_cols
                    + c_t[e] % tile_cols)
            np.add.at(tiles_d.reshape(-1), flat, v[e])
        shard_tiles.append((
            tiles_d,
            ((dkeys % num_segs) * tile_cols).astype(np.int32)
            if p_d else np.zeros(1, np.int32),
            (dkeys // num_segs).astype(np.int32)
            if p_d else np.zeros(1, np.int32),
        ))

        rr, cc, vv = r[~is_dense], c_t[~is_dense], v[~is_dense]
        order = np.lexsort((cc, rr))
        rr, cc, vv = rr[order], cc[order], vv[order]
        indptr = np.zeros(block + 1, np.int64)
        np.add.at(indptr, rr + 1, 1)
        rest_csrs.append((np.cumsum(indptr), cc, vv))

    if width is None:
        rest_degs = np.concatenate(
            [np.diff(ip) for ip, _, _ in rest_csrs]
        ) if rest_csrs else np.zeros(1)
        width = int(np.percentile(rest_degs, width_percentile)) if n else 1
        width = _round_up(max(width, 1), lane_pad)

    packed = []
    max_tail = 1
    for d, (indptr, cc, vv) in enumerate(rest_csrs):
        ec, ev, tr, tc_, tv = native.ell_hybrid_pack(
            indptr, cc.astype(np.int32), vv, width, block
        )
        packed.append((ec, ev, tr, tc_, tv))
        max_tail = max(max_tail, tr.size)

    tail_chunk, tail_pad = _tail_geometry(max_tail, tail_chunk)
    p_pad = max(t[0].shape[0] for t in shard_tiles)
    tiles = np.zeros((num_shards, p_pad, row_block, tile_cols), np.float32)
    starts = np.zeros((num_shards, p_pad), np.int32)
    block_of = np.zeros((num_shards, p_pad), np.int32)
    tail_rows = np.zeros((num_shards, tail_pad), np.int32)
    tail_cols = np.zeros((num_shards, tail_pad), np.int32)
    tail_vals = np.zeros((num_shards, tail_pad), np.float32)
    for d in range(num_shards):
        t, s, b = shard_tiles[d]
        tiles[d, : t.shape[0]] = t
        starts[d, : s.size] = s
        block_of[d, : b.size] = b
        _, _, tr, tc_, tv = packed[d]
        tail_rows[d, : tr.size] = tr
        tail_cols[d, : tc_.size] = tc_
        tail_vals[d, : tv.size] = tv
    return TiledPartition(
        tiles=tiles, starts=starts, block_of=block_of,
        ell_cols=np.stack([p[0] for p in packed]),
        ell_vals=np.stack([p[1] for p in packed]),
        tail_rows=tail_rows, tail_cols=tail_cols, tail_vals=tail_vals,
        block=block, n=n, width=width, tail_chunk=tail_chunk,
        row_block=row_block, tile_cols=tile_cols,
        tiled_fraction=dense_edges / max(csr.nnz, 1),
        send_idx=send_idx, halo_pad=halo_pad, halo_fraction=halo_fraction,
    )


def cluster_reorder_for_partition(
    adj: sp.spmatrix,
    x: Optional[np.ndarray] = None,
    y: Optional[np.ndarray] = None,
    max_sweeps: int = 20,
    merge_target: int = 0,
):
    """Cluster-align node ids before partitioning: label-propagation
    communities in affinity order (:mod:`ssrg_torch.ops.reorder`) renumber
    the graph so that shard boundaries follow communities, the condition for
    a small halo. ``merge_target`` > 0 also merges fragmented communities
    (``ops.reorder.merge_clusters``), which keeps sibling communities inside
    one shard. Returns ``(adj', x', y', inverse)`` with ``inverse[old_id] =
    new_id`` for remapping index splits."""
    from ssrg_torch.ops.reorder import apply_permutation, cluster_permutation

    perm = cluster_permutation(adj, max_sweeps=max_sweeps,
                               merge_target=merge_target)
    return apply_permutation(adj, perm, x, y)
