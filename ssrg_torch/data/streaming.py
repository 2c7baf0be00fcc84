"""Out-of-core graph loading for graphs beyond host memory (counterpart of
``ssrg_tpu/data/streaming.py``); host numpy only.

The full CSR and the feature matrix are never held in memory:

- Inputs are memory-mapped ``.npy`` files: ``edges.npy`` int64 [2, E]
  (directed entries, deduplicated single-direction pairs), ``features.npy``
  f32/f16 [N, F], ``labels.npy`` int64 [N].
- Pass 1 streams the edge file in chunks and accumulates degrees on
  :func:`ssrg_torch.native.edge_degree_accumulate` (O(N) memory).
- Pass 2 streams it again, buckets each edge (both directions, plus self
  loops) by destination row block and appends its sym-normalized weight to
  that shard's spool file.
- Each shard's padded COO block and feature row block then load on their
  own, in the layout of :class:`ssrg_torch.parallel.partition.RowPartition`.

The files on disk have the reference's names and formats (``shard_<d>.bin``
records of int32 row, int32 column, f32 value; ``halo_<d>.npy``;
``fast_meta.json``), so that a spool written by either package is read by
the other.
"""

from __future__ import annotations

import json
import os
import os.path as osp
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ssrg_torch.parallel.partition import RowPartition, _round_up

# one spooled edge: destination row local to its shard, global source, weight
SPOOL_RECORD = np.dtype([("row", np.int32), ("col", np.int32), ("val", np.float32)])


@dataclass
class StreamingGraphMeta:
    num_nodes: int
    num_edges: int
    block: int
    num_shards: int
    spool_dir: str


def stream_degrees(
    edges_path: str, num_nodes: int, chunk_edges: int = 1 << 24,
    add_self_loops: bool = True,
) -> np.ndarray:
    """Pass 1: the degree of the symmetrized adjacency (+I) from a
    memory-mapped edge file, O(N) memory."""
    from ssrg_torch.native import edge_degree_accumulate

    edges = np.load(edges_path, mmap_mode="r")
    e = edges.shape[1]
    counts = np.zeros(num_nodes, np.int64)
    for lo in range(0, e, chunk_edges):
        hi = min(lo + chunk_edges, e)
        src = np.asarray(edges[0, lo:hi], np.int64)
        dst = np.asarray(edges[1, lo:hi], np.int64)
        edge_degree_accumulate(src, dst, counts)
    deg = counts.astype(np.float64)
    if add_self_loops:
        deg += 1.0
    return deg


def stream_partition(
    edges_path: str,
    num_nodes: int,
    num_shards: int,
    spool_dir: str,
    r: float = 0.5,
    chunk_edges: int = 1 << 24,
    row_align: int = 8,
    fast_layout: bool = True,
) -> StreamingGraphMeta:
    """Pass 2: bucket sym-normalized edges (both directions and self loops)
    by destination row block into per-shard spool files.

    Symmetric duplicates in the input are not merged (the degree pass
    counts both, and the weights are per entry): the input holds each
    undirected pair once, or consistently twice."""
    os.makedirs(spool_dir, exist_ok=True)
    deg = stream_degrees(edges_path, num_nodes, chunk_edges)
    with np.errstate(divide="ignore"):
        left = np.power(deg, r - 1.0)
        right = np.power(deg, -r)
    left[~np.isfinite(left)] = 0.0
    right[~np.isfinite(right)] = 0.0

    block = _round_up(-(-num_nodes // num_shards), row_align)
    spools = [open(osp.join(spool_dir, f"shard_{d}.bin"), "wb") for d in range(num_shards)]

    def emit(dst, src):
        """Append the edges dst <- src with weight left[dst] * right[src]."""
        sh = dst // block
        w = (left[dst] * right[src]).astype(np.float32)
        for d in np.unique(sh):
            m = sh == d
            buf = np.empty(int(m.sum()), SPOOL_RECORD)
            buf["row"] = (dst[m] - d * block).astype(np.int32)
            buf["col"] = src[m].astype(np.int32)
            buf["val"] = w[m]
            spools[int(d)].write(buf.tobytes())

    edges = np.load(edges_path, mmap_mode="r")
    e = edges.shape[1]
    total = 0
    try:
        for lo in range(0, e, chunk_edges):
            hi = min(lo + chunk_edges, e)
            src = np.asarray(edges[0, lo:hi]).astype(np.int64)
            dst = np.asarray(edges[1, lo:hi]).astype(np.int64)
            keep = src != dst
            src, dst = src[keep], dst[keep]
            emit(dst, src)   # src -> dst
            emit(src, dst)   # the symmetric direction
            total += 2 * src.shape[0]
        loops = np.arange(num_nodes, dtype=np.int64)
        emit(loops, loops)
        total += num_nodes
    finally:
        for f in spools:
            f.close()
    meta = StreamingGraphMeta(num_nodes, total, block, num_shards, spool_dir)
    if fast_layout:
        # one more O(E) pass; the loaders recompute the side files if absent
        finalize_spool_fast_layout(meta)
    return meta


def finalize_spool_fast_layout(
    meta: StreamingGraphMeta,
    width_percentile: float = 95.0,
    lane_pad: int = 8,
) -> dict:
    """Post-pass over the spools: write what a host needs to build the fast
    (ELL + COO hybrid, halo-planned) per-shard layout while loading only its
    own shard's edges:

    - ``halo_<d>.npy``: shard d's sorted unique non-local columns. The halo
      plan is a function of these lists alone, so every host computes the
      same plan without communication.
    - ``fast_meta.json``: the hybrid geometry all hosts agree on: the ELL
      ``width`` (global p95 row degree, lane-padded), the per-shard COO
      tail sizes at that width and the halo sizes.

    Reads each spool file once; it runs on spools written without it."""
    rowdeg_parts = []
    halo_sizes = []
    for d in range(meta.num_shards):
        r, c, _ = load_shard(meta, d)
        rowdeg_parts.append(np.bincount(r, minlength=meta.block))
        u = np.unique(c.astype(np.int64))
        lo, hi = d * meta.block, (d + 1) * meta.block
        h = u[(u < lo) | (u >= hi)]
        np.save(osp.join(meta.spool_dir, f"halo_{d}.npy"), h)
        halo_sizes.append(int(h.size))
    rowdeg = np.concatenate(rowdeg_parts)[: meta.num_nodes]
    width = int(np.percentile(rowdeg, width_percentile)) if rowdeg.size else 1
    width = _round_up(max(width, 1), lane_pad)
    tail_sizes = [int(np.maximum(deg - width, 0).sum()) for deg in rowdeg_parts]
    fast_meta = {
        "width": width,
        "tail_sizes": tail_sizes,
        "halo_sizes": halo_sizes,
        "width_percentile": width_percentile,
        "lane_pad": lane_pad,
    }
    with open(osp.join(meta.spool_dir, "fast_meta.json"), "w") as f:
        json.dump(fast_meta, f)
    return fast_meta


def load_spool_fast_meta(meta: StreamingGraphMeta) -> dict:
    """Read (or, where it is missing, compute) the fast-layout metadata of
    :func:`finalize_spool_fast_layout`."""
    path = osp.join(meta.spool_dir, "fast_meta.json")
    if not osp.exists(path):
        return finalize_spool_fast_layout(meta)
    with open(path) as f:
        return json.load(f)


def load_spool_halo_cols(meta: StreamingGraphMeta) -> list:
    """Per-shard sorted unique non-local column lists (the halo plan's
    input); computed from the spools if the side files are missing."""
    paths = [osp.join(meta.spool_dir, f"halo_{d}.npy") for d in range(meta.num_shards)]
    if not all(osp.exists(p) for p in paths):
        finalize_spool_fast_layout(meta)
    return [np.load(p) for p in paths]


def load_shard(
    meta: StreamingGraphMeta, shard: int, nnz_pad: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One shard's spooled (row, col, val) arrays, optionally padded."""
    raw = np.fromfile(osp.join(meta.spool_dir, f"shard_{shard}.bin"), dtype=SPOOL_RECORD)
    rows, cols, vals = raw["row"], raw["col"], raw["val"]
    if nnz_pad is not None:
        pad = nnz_pad - rows.shape[0]
        if pad < 0:
            raise ValueError("nnz_pad smaller than shard nnz")
        rows = np.concatenate([rows, np.zeros(pad, np.int32)])
        cols = np.concatenate([cols, np.zeros(pad, np.int32)])
        vals = np.concatenate([vals, np.zeros(pad, np.float32)])
    return rows, cols, vals


def assemble_row_partition(meta: StreamingGraphMeta) -> RowPartition:
    """Stitch all shard spools into a :class:`RowPartition` (on one host; a
    host of several loads only its own shards with :func:`load_shard`)."""
    sizes = [
        osp.getsize(osp.join(meta.spool_dir, f"shard_{d}.bin")) // SPOOL_RECORD.itemsize
        for d in range(meta.num_shards)
    ]
    nnz_pad = _round_up(max(max(sizes), 1), 512)
    rows = np.zeros((meta.num_shards, nnz_pad), np.int32)
    cols = np.zeros((meta.num_shards, nnz_pad), np.int32)
    vals = np.zeros((meta.num_shards, nnz_pad), np.float32)
    for d in range(meta.num_shards):
        rows[d], cols[d], vals[d] = load_shard(meta, d, nnz_pad)
    return RowPartition(rows, cols, vals, block=meta.block, n=meta.num_nodes)


def shard_feature_block(
    features_path: str, meta: StreamingGraphMeta, shard: int
) -> np.ndarray:
    """Memory-mapped load of one shard's feature row block (zero-padded)."""
    x = np.load(features_path, mmap_mode="r")
    lo = shard * meta.block
    hi = min(lo + meta.block, meta.num_nodes)
    out = np.zeros((meta.block, x.shape[1]), np.float32)
    if lo < meta.num_nodes:
        out[: hi - lo] = np.asarray(x[lo:hi], np.float32)
    return out
