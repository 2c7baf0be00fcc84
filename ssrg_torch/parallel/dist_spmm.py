"""Distributed SpMM and K-hop propagation over a mesh (counterpart of
``ssrg_tpu/parallel/dist_spmm.py``), on ``torch.distributed``.

The normalized adjacency is 1-D row-partitioned over the mesh's ``graph``
axis (:mod:`ssrg_torch.parallel.partition`); node features live as the
matching row blocks. Every rank holds only its own shard, on its own device:
``shard_*`` take the host partition and copy shard ``mesh.coords[axis]``
over. Each hop is an exchange over the axis's process group, then a local
SpMM against what arrived:

- all-gather (``all_gather_into_tensor``): the table is the full ``X``;
- halo (``all_to_all_single``): each rank gathers the rows its peers need
  (``send_idx``) and the table is ``[own block ‖ received rows]``;
- ring (``batch_isend_irecv``): the blocks travel around the ring, two
  receive buffers taking turns, and each rank multiplies the bucket of the
  block that is visiting while the next one is in flight.

The local engines: the padded COO segment sum (the COO kernel
:func:`ssrg_torch.ops.coo_spmm.coo_accumulate`), the hybrid (ELL slots on the
ELL kernel :func:`ssrg_torch.ops.ell_spmm.ell_spmm`, the COO tail on the COO
kernel), the tiled engine (dense tiles as
``torch.bmm`` into their row blocks, the rest on the hybrid term) and, for
the ring, one hybrid pack per (shard, source block) bucket, one ELL launch
each on the visiting block.

``dist_propagate*`` return this rank's ``[K+1, block, F]`` rows, where the
reference returns the global ``[K+1, n_pad, F]`` array sharded by rows;
:func:`all_gather_hops` assembles the global tensor. Passed a ``stats``
dict, they time each hop's exchange and local SpMM (CUDA events on a card,
the host clock on the CPU) and count the bytes the exchange moved.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import scipy.sparse as sp
import torch
import torch.distributed as dist

from ssrg_torch.ops.coo_spmm import coo_accumulate
from ssrg_torch.ops.ell_spmm import ell_spmm
from ssrg_torch.ops.sparse import _GROUP_BYTES
from ssrg_torch.parallel.mesh import Mesh
from ssrg_torch.parallel.partition import RowPartition, _round_up, _tail_geometry, pad_features


def _own(arr: np.ndarray, mesh: Mesh, axis: str) -> torch.Tensor:
    """This rank's entry of an array stacked on a leading shard axis, on the
    mesh's device."""
    if arr.shape[0] != mesh.shape[axis]:
        raise ValueError(f"the partition has {arr.shape[0]} shards but mesh axis {axis!r} "
                         f"has size {mesh.shape[axis]}")
    return torch.from_numpy(np.ascontiguousarray(arr[mesh.coords[axis]])).to(mesh.device)


class _HopClock:
    """Each hop's time split into its exchange and its local SpMM, kept only
    when the caller passed a ``stats`` dict. A mark closes the interval since
    the previous one under its label."""

    def __init__(self, stats: Optional[dict], device: torch.device):
        self.stats = stats
        self.cuda = device.type == "cuda"
        self.hops: List[list] = []

    def _now(self):
        if self.cuda:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def _ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def start(self) -> None:
        if self.stats is not None:
            self.hops.append([(None, self._now())])

    def mark(self, label: str) -> None:
        if self.stats is not None:
            self.hops[-1].append((label, self._now()))

    def finish(self, mode: str, exchange_bytes_per_hop: int) -> None:
        if self.stats is None:
            return
        if self.cuda:
            torch.cuda.synchronize()
        split = {"exchange": [], "spmm": []}
        for marks in self.hops:
            sums = dict.fromkeys(split, 0.0)
            for (_, a), (label, b) in zip(marks, marks[1:]):
                sums[label] += self._ms(a, b)
            for label in split:
                split[label].append(sums[label])
        self.stats.update(
            mode=mode, hop_ms=[self._ms(m[0][1], m[-1][1]) for m in self.hops],
            exchange_ms=split["exchange"], spmm_ms=split["spmm"],
            exchange_bytes_per_hop=exchange_bytes_per_hop)


class _OnMesh:
    """The shard geometry of a rank's adjacency (its ``mesh``, ``axis`` and
    ``block``)."""

    @property
    def num_shards(self) -> int:
        return self.mesh.shape[self.axis]

    @property
    def n_pad(self) -> int:
        return self.block * self.num_shards


def _propagate(x_block: torch.Tensor, prop_steps: int, hop: Callable, clock: _HopClock
               ) -> torch.Tensor:
    hops = [x_block]
    for _ in range(prop_steps):
        clock.start()
        hops.append(hop(hops[-1]))
    return torch.stack(hops)


def _all_gather_rows(h_block: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    out = h_block.new_empty((mesh.shape[axis] * h_block.shape[0], h_block.shape[1]))
    dist.all_gather_into_tensor(out, h_block.contiguous(), group=mesh.groups[axis])
    return out


def all_gather_hops(hops: torch.Tensor, mesh: Mesh, axis: Optional[str] = "graph"
                    ) -> torch.Tensor:
    """The global ``[K+1, n_pad, F]`` hops from every rank's ``[K+1, rows,
    F]`` (a collective), for tests and checks: over ``axis`` for the
    propagated blocks, over the whole world (``axis=None``, rows in rank
    order) for a context's head rows."""
    group = dist.group.WORLD if axis is None else mesh.groups[axis]
    d = mesh.world_size if axis is None else mesh.shape[axis]
    k1, rows, f = hops.shape
    out = hops.new_empty((d * k1, rows, f))
    dist.all_gather_into_tensor(out, hops.contiguous(), group=group)
    return out.view(d, k1, rows, f).transpose(0, 1).reshape(k1, d * rows, f)


# ---------------------------------------------------------------------------
# Row-partitioned COO, all-gather exchange
# ---------------------------------------------------------------------------


@dataclass
class ShardedAdj(_OnMesh):
    """This rank's shard of a :class:`RowPartition` on the mesh's device."""

    rows: torch.Tensor   # int32 [nnz_pad], local to the shard's row block
    cols: torch.Tensor   # int32 [nnz_pad], global columns
    vals: torch.Tensor   # f32   [nnz_pad], 0 on padding
    mesh: Mesh
    axis: str
    block: int
    n: int


def shard_adjacency(part: RowPartition, mesh: Mesh, axis: str = "graph") -> ShardedAdj:
    """Copy shard ``mesh.coords[axis]`` of the partition to this rank's
    device."""
    return ShardedAdj(rows=_own(part.rows, mesh, axis), cols=_own(part.cols, mesh, axis),
                      vals=_own(part.vals, mesh, axis), mesh=mesh, axis=axis,
                      block=part.block, n=part.n)


def shard_features(x: np.ndarray, part, mesh: Mesh, axis: str = "graph") -> torch.Tensor:
    """This rank's ``[block, F]`` feature rows, zero past the graph's last
    node, on its device."""
    x = np.asarray(x, np.float32)
    lo = mesh.coords[axis] * part.block
    blk = np.zeros((part.block, x.shape[1]), np.float32)
    hi = min(lo + part.block, x.shape[0])
    if lo < hi:
        blk[: hi - lo] = x[lo:hi]
    return torch.from_numpy(blk).to(mesh.device)


def _local_spmm(rows, cols, vals, x_full: torch.Tensor, block: int, chunk: int) -> torch.Tensor:
    """Segment sum of this shard's edges (padding included: row 0, weight
    0) against the gathered feature matrix; ``chunk`` edges at a time on the
    CPU."""
    out = torch.zeros((block, x_full.shape[1]), dtype=torch.float32, device=x_full.device)
    return coo_accumulate(rows, cols, vals, x_full, out, chunk=chunk)


def _exchange_propagate(adj, x_sharded: torch.Tensor, prop_steps: int, stats: Optional[dict],
                        local: Callable, send: Optional[torch.Tensor] = None,
                        halo_pad: int = 0) -> torch.Tensor:
    """K hops, each the exchange (all-gather, or the halo plan ``send``)
    then ``local(table)``, the rank's next block."""
    clock = _HopClock(stats, x_sharded.device)

    def hop(h):
        table = _exchange_table(h, send, adj.mesh, adj.axis, halo_pad)
        clock.mark("exchange")
        out = local(table)
        clock.mark("spmm")
        return out

    hops = _propagate(x_sharded, prop_steps, hop, clock)
    rows = adj.block if send is None else halo_pad
    clock.finish("all_gather" if send is None else "halo",
                 (adj.num_shards - 1) * rows * x_sharded.shape[1] * 4)
    return hops


def dist_propagate(adj: ShardedAdj, x_sharded: torch.Tensor, prop_steps: int,
                   chunk: int = 1 << 19, stats: Optional[dict] = None) -> torch.Tensor:
    """K hops over the mesh, all-gather then the COO segment sum; this rank's
    ``[K+1, block, F]`` rows, equal (to f32 roundoff) to single-device
    ``ops.propagate`` on the unpartitioned adjacency."""
    return _exchange_propagate(
        adj, x_sharded, prop_steps, stats,
        lambda table: _local_spmm(adj.rows, adj.cols, adj.vals, table, adj.block, chunk))


# ---------------------------------------------------------------------------
# Ring exchange
# ---------------------------------------------------------------------------


def _ring_hop(h_block: torch.Tensor, mesh: Mesh, axis: str, buffers: list,
              multiply: Callable, clock: _HopClock) -> torch.Tensor:
    """One hop around the ring: at step ``s`` the block of shard ``(my - s)
    mod D`` visits, ``multiply(acc, source, visiting)`` adds its bucket, and
    meanwhile the visiting block goes on to the next rank while the one
    after it arrives in the other buffer. A receive buffer is read only after
    its ``wait()``, and a buffer is received into only after the send that
    read it has ended. The reference's last rotation, which only brings each
    block home, is not made."""
    d, my = mesh.shape[axis], mesh.coords[axis]
    ring, group = mesh.ranks[axis], mesh.groups[axis]
    acc = torch.zeros_like(h_block)
    visiting = h_block
    for s in range(d):
        requests = []
        if s < d - 1:
            incoming = buffers[s % 2]
            requests = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, visiting, ring[(my + 1) % d], group),
                dist.P2POp(dist.irecv, incoming, ring[(my - 1) % d], group),
            ])
        multiply(acc, (my - s) % d, visiting)
        clock.mark("spmm")
        for request in requests:
            request.wait()
        clock.mark("exchange")
        if s < d - 1:
            visiting = incoming
    return acc


def _ring_propagate(x_sharded, prop_steps, mesh, axis, multiply, stats, block) -> torch.Tensor:
    clock = _HopClock(stats, x_sharded.device)
    buffers = [torch.empty_like(x_sharded) for _ in range(2 if mesh.shape[axis] > 1 else 0)]
    hops = _propagate(x_sharded, prop_steps,
                      lambda h: _ring_hop(h, mesh, axis, buffers, multiply, clock), clock)
    clock.finish("ring", (mesh.shape[axis] - 1) * block * x_sharded.shape[1] * 4)
    return hops


@dataclass
class RingPartitionArrays:
    """Ring partition: per shard, its edges bucketed by source block, with
    LOCAL rows and LOCAL columns. ``rows/cols/vals`` ``[D, D, bucket_pad]``."""

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


def partition_rows_ring(adj, num_shards: int, row_align: int = 8) -> RingPartitionArrays:
    """Host-side column-bucketed row partition for the ring, buckets padded
    to the largest (rounded up to 512)."""
    csr = adj.tocsr()
    n = csr.shape[0]
    block = _round_up(-(-n // num_shards), row_align)
    buckets = [[None] * num_shards for _ in range(num_shards)]
    max_bucket = 1
    for d in range(num_shards):
        lo, hi = d * block, min((d + 1) * block, n)
        sub = csr[lo:hi].tocoo() if lo < n else sp.coo_matrix((0, n))
        col_block = sub.col // block
        for j in range(num_shards):
            m = col_block == j
            buckets[d][j] = (sub.row[m].astype(np.int32),
                             (sub.col[m] - j * block).astype(np.int32),
                             sub.data[m].astype(np.float32))
            max_bucket = max(max_bucket, int(m.sum()))
    pad = _round_up(max_bucket, 512)
    rows = np.zeros((num_shards, num_shards, pad), np.int32)
    cols = np.zeros((num_shards, num_shards, pad), np.int32)
    vals = np.zeros((num_shards, num_shards, pad), np.float32)
    for d in range(num_shards):
        for j in range(num_shards):
            r, c, v = buckets[d][j]
            rows[d, j, : r.size], cols[d, j, : r.size], vals[d, j, : r.size] = r, c, v
    return RingPartitionArrays(rows, cols, vals, block, n)


@dataclass
class ShardedAdjRing(_OnMesh):
    """This rank's buckets of a :class:`RingPartitionArrays`: ``rows/cols/vals``
    ``[D, bucket_pad]``, entry ``j`` its edges whose source lies in block ``j``."""

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    mesh: Mesh
    axis: str
    block: int
    n: int


def shard_adjacency_ring(part: RingPartitionArrays, mesh: Mesh, axis: str = "graph"
                         ) -> ShardedAdjRing:
    return ShardedAdjRing(rows=_own(part.rows, mesh, axis), cols=_own(part.cols, mesh, axis),
                          vals=_own(part.vals, mesh, axis), mesh=mesh, axis=axis,
                          block=part.block, n=part.n)


def dist_propagate_ring(adj: ShardedAdjRing, x_sharded: torch.Tensor, prop_steps: int,
                        stats: Optional[dict] = None) -> torch.Tensor:
    """K hops with the blocks travelling around the ring instead of an
    all-gather: each rank holds its own block, the visiting one and the one
    in flight, O(3·block·F), and multiplies each visiting block's bucket as
    a COO segment sum while the next block moves."""

    def multiply(acc, src, visiting):
        coo_accumulate(adj.rows[src], adj.cols[src], adj.vals[src], visiting, acc)

    return _ring_propagate(x_sharded, prop_steps, adj.mesh, adj.axis, multiply, stats,
                           adj.block)


# ---------------------------------------------------------------------------
# Communication accounting and the host oracle
# ---------------------------------------------------------------------------


def format_bytes(num: float) -> str:
    """A byte count in B, KB, MB or GB, whichever reads at its scale."""
    for unit in ("B", "KB", "MB", "GB"):
        if abs(num) < 1024.0 or unit == "GB":
            return f"{num:.0f} {unit}" if unit == "B" else f"{num:.2f} {unit}"
        num /= 1024.0
    return f"{num:.2f} GB"


def comm_stats(
    num_shards: int,
    block: int,
    feature_dim: int,
    prop_steps: int,
    mode: str = "all_gather",
    itemsize: int = 4,
    halo_pad: int = 0,
) -> dict:
    """The reference's analytic exchange volume and peak feature memory per
    device:

    - ``all_gather``: each device receives the other D-1 blocks,
      ``(D-1)·block·F·itemsize`` bytes a hop, and holds the full matrix;
    - ``ring``: ``D·block·F·itemsize`` bytes a hop (the reference's last
      rotation, which the port does not make, included) at
      ``2·block·F·itemsize`` of feature memory;
    - ``halo``: ``(D-1)·halo_pad·F·itemsize`` bytes a hop, the table holding
      the own block and the ``D·halo_pad`` receive buffer."""
    if mode == "all_gather":
        per_dev_hop = (num_shards - 1) * block * feature_dim * itemsize
        peak_feature = num_shards * block * feature_dim * itemsize
    elif mode == "ring":
        per_dev_hop = num_shards * block * feature_dim * itemsize
        peak_feature = 2 * block * feature_dim * itemsize
    elif mode == "halo":
        per_dev_hop = (num_shards - 1) * halo_pad * feature_dim * itemsize
        peak_feature = (block + num_shards * halo_pad) * feature_dim * itemsize
    else:
        raise ValueError(f"unknown comm mode {mode!r}")
    return {
        "mode": mode,
        "num_shards": num_shards,
        "block": block,
        "halo_pad": halo_pad,
        "feature_dim": feature_dim,
        "prop_steps": prop_steps,
        "bytes_per_device_per_hop": per_dev_hop,
        "bytes_per_device_total": per_dev_hop * prop_steps,
        "bytes_mesh_total": per_dev_hop * prop_steps * num_shards,
        "peak_feature_bytes_per_device": peak_feature,
    }


def dist_propagate_reference(part: RowPartition, x: np.ndarray, k: int) -> np.ndarray:
    """Host oracle for tests: scipy propagation on the stitched-back
    adjacency, ``[K+1, n_pad, F]``."""
    d, _ = part.rows.shape
    rows_g = (part.rows + np.arange(d)[:, None] * part.block).reshape(-1)
    cols_g = part.cols.reshape(-1)
    vals_g = part.vals.reshape(-1)
    keep = vals_g != 0
    adj = sp.csr_matrix((vals_g[keep], (rows_g[keep], cols_g[keep])),
                        shape=(part.n_pad, part.n_pad))
    hops = [pad_features(np.asarray(x, np.float32), part)]
    for _ in range(k):
        hops.append(adj @ hops[-1])
    return np.stack(hops)


# ---------------------------------------------------------------------------
# Hybrid local engine, all-gather or halo exchange
# ---------------------------------------------------------------------------


@dataclass
class ShardedHybridAdj(_OnMesh):
    """This rank's shard of a :class:`~ssrg_torch.parallel.partition.HybridPartition`.

    ``send_idx`` None: all-gather, columns global. Otherwise ``[D, halo_pad]``
    local rows this rank ships to each peer every hop, and the columns index
    the table ``[own block ‖ received rows]``."""

    ell_cols: torch.Tensor    # int32 [block, width]
    ell_vals: torch.Tensor    # f32   [block, width]
    tail_rows: torch.Tensor   # int32 [tail_pad]
    tail_cols: torch.Tensor   # int32 [tail_pad]
    tail_vals: torch.Tensor   # f32   [tail_pad]
    send_idx: Optional[torch.Tensor]
    mesh: Mesh
    axis: str
    block: int
    n: int
    width: int
    tail_chunk: int
    halo_pad: int


def _hybrid_fields(part, mesh: Mesh, axis: str) -> dict:
    return dict(
        ell_cols=_own(part.ell_cols, mesh, axis), ell_vals=_own(part.ell_vals, mesh, axis),
        tail_rows=_own(part.tail_rows, mesh, axis), tail_cols=_own(part.tail_cols, mesh, axis),
        tail_vals=_own(part.tail_vals, mesh, axis),
        send_idx=None if part.send_idx is None else _own(part.send_idx, mesh, axis),
        mesh=mesh, axis=axis, block=part.block, n=part.n, width=part.width,
        tail_chunk=part.tail_chunk, halo_pad=part.halo_pad)


def shard_adjacency_hybrid(part, mesh: Mesh, axis: str = "graph") -> ShardedHybridAdj:
    """Copy shard ``mesh.coords[axis]`` of a hybrid partition to this rank's
    device."""
    return ShardedHybridAdj(**_hybrid_fields(part, mesh, axis))


def _exchange_table(h_block: torch.Tensor, send: Optional[torch.Tensor], mesh: Mesh, axis: str,
                    halo_pad: int) -> torch.Tensor:
    """The hop's exchange, shared by the hybrid and tiled engines. ``send``
    None: all-gather the blocks (the table is the full X). Otherwise gather
    the rows each peer needs (``send [D, halo_pad]``, local ids), ship them in
    one ``all_to_all_single`` and return ``[own block ‖ received rows]``,
    peer ``src``'s rows at ``block + src·halo_pad``."""
    if send is None:
        return _all_gather_rows(h_block, mesh, axis)
    sends = h_block.index_select(0, send.reshape(-1))
    received = torch.empty_like(sends)
    dist.all_to_all_single(received, sends, group=mesh.groups[axis])
    return torch.cat([h_block, received])


def _hybrid_term(adj, table: torch.Tensor) -> torch.Tensor:
    """ELL slots on the ELL kernel, then the tail added on the COO kernel."""
    out = ell_spmm(adj.ell_cols, adj.ell_vals, table)
    return coo_accumulate(adj.tail_rows, adj.tail_cols, adj.tail_vals, table, out,
                          chunk=adj.tail_chunk)


def dist_propagate_hybrid(adj: ShardedHybridAdj, x_sharded: torch.Tensor, prop_steps: int,
                          row_block: int = 256, stats: Optional[dict] = None) -> torch.Tensor:
    """K hops with the hybrid local engine: per hop the exchange (all-gather,
    or the halo's ``all_to_all_single``), then one ELL kernel launch and one
    COO kernel launch for the tail against the table. ``row_block`` is the
    reference's scan block; the kernel takes the whole pack at once."""
    return _exchange_propagate(adj, x_sharded, prop_steps, stats,
                               lambda table: _hybrid_term(adj, table), adj.send_idx,
                               adj.halo_pad)


# ---------------------------------------------------------------------------
# Tiled local engine: dense tiles plus the hybrid rest
# ---------------------------------------------------------------------------


@dataclass
class ShardedTiledAdj(_OnMesh):
    """This rank's shard of a :class:`~ssrg_torch.parallel.partition.TiledPartition`:
    dense tiles against windows of the exchange table (``starts`` in table
    coordinates), the rest in the hybrid layout against the same table."""

    tiles: torch.Tensor       # f32 or bf16 [P_pad, row_block, tile_cols]
    starts: torch.Tensor      # int32 [P_pad]
    block_of: torch.Tensor    # int32 [P_pad]
    ell_cols: torch.Tensor
    ell_vals: torch.Tensor
    tail_rows: torch.Tensor
    tail_cols: torch.Tensor
    tail_vals: torch.Tensor
    send_idx: Optional[torch.Tensor]
    mesh: Mesh
    axis: str
    block: int
    n: int
    width: int
    tail_chunk: int
    halo_pad: int
    tiled_fraction: float


def shard_adjacency_tiled(part, mesh: Mesh, axis: str = "graph",
                          dtype: torch.dtype = torch.float32) -> ShardedTiledAdj:
    """Copy shard ``mesh.coords[axis]`` of a tiled partition to this rank's
    device; ``dtype=torch.bfloat16`` stores the tiles in bf16 (their products
    still accumulate in f32)."""
    return ShardedTiledAdj(tiles=_own(part.tiles, mesh, axis).to(dtype),
                           starts=_own(part.starts, mesh, axis),
                           block_of=_own(part.block_of, mesh, axis),
                           tiled_fraction=part.tiled_fraction,
                           **_hybrid_fields(part, mesh, axis))


def _tiled_local_spmm(tiles, starts, block_of, table: torch.Tensor, block: int) -> torch.Tensor:
    """The tiles against the table: each tile times its ``tile_cols``-row
    window of the table (zero past its end), added into its destination row
    block, in groups of ``torch.bmm``. Pad tiles are zero and add nothing.
    bf16 tiles meet a bf16-rounded table, as the reference's bf16 dot."""
    p, rb, tc = tiles.shape
    f = table.shape[1]
    pad = -table.shape[0] % tc
    tab = torch.cat([table, table.new_zeros((pad, f))]) if pad else table
    if tiles.dtype == torch.bfloat16:
        tab = tab.to(torch.bfloat16).float()
    acc = torch.zeros((block // rb, rb, f), dtype=torch.float32, device=table.device)
    offs = torch.arange(tc, device=table.device)
    step = max(1, _GROUP_BYTES // (4 * (rb * tc + tc * f + rb * f)))
    for p0 in range(0, p, step):
        windows = tab[starts[p0:p0 + step].long()[:, None] + offs]
        acc.index_add_(0, block_of[p0:p0 + step],
                       torch.bmm(tiles[p0:p0 + step].float(), windows))
    return acc.view(block, f)


def dist_propagate_tiled(adj: ShardedTiledAdj, x_sharded: torch.Tensor, prop_steps: int,
                         row_block: int = 256, stats: Optional[dict] = None) -> torch.Tensor:
    """K hops with the tiled local engine: per hop the exchange, then the
    dense tiles (``torch.bmm``) and the hybrid rest (one ELL launch and the
    tail) against the same table. ``row_block`` is the reference's scan
    block, unused by the kernel."""

    def local(table):
        out = _tiled_local_spmm(adj.tiles, adj.starts, adj.block_of, table, adj.block)
        return out.add_(_hybrid_term(adj, table))

    return _exchange_propagate(adj, x_sharded, prop_steps, stats, local, adj.send_idx,
                               adj.halo_pad)


# ---------------------------------------------------------------------------
# Ring exchange with the hybrid local engine
# ---------------------------------------------------------------------------


@dataclass
class RingHybridPartitionArrays:
    """Ring partition with each (shard, source block) bucket in the hybrid
    layout, shapes equal across buckets:

    - ``ell_cols``/``ell_vals``  [D, D, block, width]  entry [d, j]: shard d's
      edges whose source lies in block j, local rows and local columns
    - ``tail_rows/cols/vals``    [D, D, tail_pad]      the overflow COO
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

    @property
    def num_shards(self) -> int:
        return self.ell_cols.shape[0]

    @property
    def n_pad(self) -> int:
        return self.block * self.num_shards


def partition_rows_ring_hybrid(
    adj, num_shards: int, row_align: int = 8,
    width: Optional[int] = None, width_percentile: float = 95.0,
    lane_pad: int = 8, tail_chunk: int = 1 << 19,
) -> RingHybridPartitionArrays:
    """Host-side column-bucketed partition with a hybrid pack per bucket.

    ``width`` defaults to the p95 degree over the rows that have edges in a
    bucket (most rows have none for a given source block, and counting them
    would send everything to the tail)."""
    from ssrg_torch import native

    csr = adj.tocsr()
    n = csr.shape[0]
    block = _round_up(-(-n // num_shards), row_align)
    buckets = []   # [d][j] -> (rows, local cols, vals)
    nz_degs = []
    for d in range(num_shards):
        lo, hi = d * block, min((d + 1) * block, n)
        sub = (csr[lo:hi] if lo < n else sp.csr_matrix((0, n), dtype=csr.dtype)).tocoo()
        col_block = sub.col // block
        row = []
        for j in range(num_shards):
            m = col_block == j
            r = sub.row[m].astype(np.int64)
            row.append((r, (sub.col[m] - j * block).astype(np.int64),
                        sub.data[m].astype(np.float32)))
            if r.size:
                counts = np.bincount(r)
                nz_degs.append(counts[counts > 0])
        buckets.append(row)
    if width is None:
        all_deg = np.concatenate(nz_degs) if nz_degs else np.ones(1, np.int64)
        width = _round_up(max(int(np.percentile(all_deg, width_percentile)), 1), lane_pad)

    packed = [[None] * num_shards for _ in range(num_shards)]
    max_tail = 1
    for d in range(num_shards):
        for j in range(num_shards):
            r, c, v = buckets[d][j]
            order = np.lexsort((c, r))
            r, c, v = r[order], c[order], v[order]
            indptr = np.zeros(block + 1, np.int64)
            np.add.at(indptr, r + 1, 1)
            packed[d][j] = native.ell_hybrid_pack(np.cumsum(indptr), c.astype(np.int32), v,
                                                  width, block)
            max_tail = max(max_tail, packed[d][j][2].size)

    tail_chunk, tail_pad = _tail_geometry(max_tail, tail_chunk)
    ell_cols = np.zeros((num_shards, num_shards, block, width), np.int32)
    ell_vals = np.zeros((num_shards, num_shards, block, width), np.float32)
    tails = [np.zeros((num_shards, num_shards, tail_pad), dt)
             for dt in (np.int32, np.int32, np.float32)]
    for d in range(num_shards):
        for j in range(num_shards):
            ec, ev, *tail = packed[d][j]
            ell_cols[d, j], ell_vals[d, j] = ec, ev
            for dst, src in zip(tails, tail):
                dst[d, j, : src.size] = src
    return RingHybridPartitionArrays(ell_cols, ell_vals, *tails, block=block, n=n,
                                     width=width, tail_chunk=tail_chunk)


@dataclass
class ShardedAdjRingHybrid(_OnMesh):
    """This rank's buckets of a :class:`RingHybridPartitionArrays`:
    ``ell_*`` ``[D, block, width]`` and ``tail_*`` ``[D, tail_pad]``, entry
    ``j`` for source block ``j``."""

    ell_cols: torch.Tensor
    ell_vals: torch.Tensor
    tail_rows: torch.Tensor
    tail_cols: torch.Tensor
    tail_vals: torch.Tensor
    mesh: Mesh
    axis: str
    block: int
    n: int
    width: int
    tail_chunk: int


def shard_adjacency_ring_hybrid(part: RingHybridPartitionArrays, mesh: Mesh,
                                axis: str = "graph") -> ShardedAdjRingHybrid:
    return ShardedAdjRingHybrid(
        ell_cols=_own(part.ell_cols, mesh, axis), ell_vals=_own(part.ell_vals, mesh, axis),
        tail_rows=_own(part.tail_rows, mesh, axis), tail_cols=_own(part.tail_cols, mesh, axis),
        tail_vals=_own(part.tail_vals, mesh, axis), mesh=mesh, axis=axis, block=part.block,
        n=part.n, width=part.width, tail_chunk=part.tail_chunk)


def dist_propagate_ring_hybrid(adj: ShardedAdjRingHybrid, x_sharded: torch.Tensor,
                               prop_steps: int, row_block: int = 256,
                               stats: Optional[dict] = None) -> torch.Tensor:
    """The ring of :func:`dist_propagate_ring` with a hybrid pack per bucket:
    each visiting block takes one ELL launch on its bucket (D a hop) and the
    bucket's tail on the COO kernel. ``row_block`` is the reference's scan
    block, unused by the kernel."""

    def multiply(acc, src, visiting):
        acc += ell_spmm(adj.ell_cols[src], adj.ell_vals[src], visiting)
        coo_accumulate(adj.tail_rows[src], adj.tail_cols[src], adj.tail_vals[src], visiting,
                       acc, chunk=adj.tail_chunk)

    return _ring_propagate(x_sharded, prop_steps, adj.mesh, adj.axis, multiply, stats,
                           adj.block)
