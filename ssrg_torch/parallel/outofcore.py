"""Out-of-core K-hop propagation on one device (counterpart of
``ssrg_tpu/parallel/outofcore.py``).

Features live on disk as per-block ``.npy`` files and the adjacency as the
streaming partitioner's per-destination-block spools
(:mod:`ssrg_torch.data.streaming`). Propagation runs block at a time: the
device holds one source feature block, the output accumulator(s) and one
edge bucket at a time, O(block·F + bucket) device memory under
``dest_outer``, whatever N is.

Each hop: for each (destination block i, source block j) bucket, ``acc_i
+= A[i, j] @ X_j``, and hop h's blocks go to ``<work_dir>/hop<h>/block<i>.npy``
(f32, the reference's names) before hop h+1 starts. The local engines:

- ``hybrid`` (default): each bucket packed once on the host into ELL slots
  and a COO tail (the reference's rule: width the p95 of the bucket's
  nonzero row degrees, a power of two of at least 8, packed by
  :func:`ssrg_torch.native.ell_hybrid_pack`). The ELL part runs the ELL
  kernel (:func:`ssrg_torch.ops.ell_spmm.ell_spmm`) on the ``[block, F]``
  source block, the tail the COO kernel
  (:func:`ssrg_torch.ops.coo_spmm.coo_accumulate`). The packs stay on the host, in
  pinned memory when the device is a card, and go to the device one at a
  time; the reference keeps every pack on the device for the whole run
  (ROADMAP.md section 3).
- ``coo``: each bucket as padded COO on the COO kernel.
"""

from __future__ import annotations

import os
import os.path as osp
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ssrg_torch.data.streaming import StreamingGraphMeta, load_shard
from ssrg_torch.ops.coo_spmm import coo_accumulate
from ssrg_torch.ops.ell_spmm import ell_spmm
from ssrg_torch.utils import DeviceLike, resolve_device, synchronize

_CHUNK = 1 << 20  # bounds a gathered edge slice at _CHUNK x F (the COO plain version)


def _pow2_pad(n: int, floor: int = 1 << 12) -> int:
    """The reference's bucket padding: a power of two from ``floor`` up to
    ``_CHUNK``, a multiple of ``_CHUNK`` past it."""
    p = floor
    while p < n and p < _CHUNK:
        p <<= 1
    if n <= p:
        return p
    return -(-n // _CHUNK) * _CHUNK


def stage_feature_blocks(features_path: str, meta: StreamingGraphMeta, work_dir: str) -> str:
    """Split the memory-mapped feature matrix into per-block hop-0 files."""
    hop0 = osp.join(work_dir, "hop0")
    os.makedirs(hop0, exist_ok=True)
    x = np.load(features_path, mmap_mode="r")
    f = x.shape[1]
    for i in range(meta.num_shards):
        lo = i * meta.block
        hi = min(lo + meta.block, meta.num_nodes)
        blk = np.zeros((meta.block, f), np.float32)
        if lo < meta.num_nodes:
            blk[: hi - lo] = np.asarray(x[lo:hi], np.float32)
        np.save(osp.join(hop0, f"block{i}.npy"), blk)
    return hop0


def bucket_edges(meta: StreamingGraphMeta) -> list:
    """Each destination shard's spooled edges grouped by source block:
    ``(rows, local cols, vals, offsets)`` with bucket ``j`` at
    ``[offsets[j], offsets[j+1])``."""
    s, block = meta.num_shards, meta.block
    buckets = []
    for i in range(s):
        r, c, v = load_shard(meta, i)
        src_blk = c // block
        order = np.argsort(src_blk, kind="stable")
        r, c, v, src_blk = r[order], c[order], v[order], src_blk[order]
        offsets = np.searchsorted(src_blk, np.arange(s + 1))
        buckets.append((r, (c - src_blk * block).astype(np.int32), v, offsets))
    return buckets


def pack_bucket(r: np.ndarray, c: np.ndarray, v: np.ndarray, block: int):
    """The reference's hybrid pack of one bucket (local rows ``r``, local
    columns ``c``): ``(ell_cols [block, w], ell_vals, tail)`` with ``w`` the
    p95 of the nonzero row degrees rounded up to a power of two of at least
    8, and ``tail`` None or ``(rows, cols, vals)`` padded to
    ``_pow2_pad(len, 512)`` with zero-weight entries."""
    from ssrg_torch import native

    order = np.lexsort((c, r))
    r, c, v = (r[order].astype(np.int64), c[order].astype(np.int32),
               v[order].astype(np.float32))
    deg = np.bincount(r, minlength=block)
    nz = deg[deg > 0]
    width = int(np.percentile(nz, 95)) if nz.size else 1
    w = 8
    while w < width:
        w <<= 1
    indptr = np.zeros(block + 1, np.int64)
    np.add.at(indptr, r + 1, 1)
    ec, ev, tr, tc, tv = native.ell_hybrid_pack(np.cumsum(indptr), c, v, w, block)
    tail = None
    if tr.size:
        t_pad = _pow2_pad(tr.size, floor=1 << 9)
        tail = tuple(np.zeros(t_pad, dt) for dt in (np.int32, np.int32, np.float32))
        tail[0][: tr.size], tail[1][: tc.size], tail[2][: tv.size] = tr, tc, tv
    return ec, ev, tail


@dataclass
class HostPack:
    """One bucket's hybrid pack, kept on the host."""

    cols: torch.Tensor                      # int32 [block, w]
    vals: torch.Tensor                      # f32 [block, w]
    tail: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]

    @property
    def nbytes(self) -> int:
        parts = (self.cols, self.vals) + (self.tail or ())
        return sum(t.numel() * t.element_size() for t in parts)


def _host(a: np.ndarray, pin: bool) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.pin_memory() if pin else t


def outofcore_propagate(
    meta: StreamingGraphMeta,
    features_path: str,
    prop_steps: int,
    work_dir: str,
    verbose: bool = False,
    mode: str = "auto",
    acc_budget_bytes: int = 4 << 30,
    transfer_dtype: str = "float32",
    local_engine: str = "hybrid",
    device: DeviceLike = "cuda",
    stats: Optional[dict] = None,
) -> List[str]:
    """Run K hops block at a time on ``device``; returns the per-hop
    directories (``hop0`` … ``hop<K>``), each holding ``num_shards`` block
    files.

    Two schedules:

    - ``dest_outer``: one ``[block, F]`` accumulator and one source block
      on the device at a time (O(block·F + bucket)), every source block
      read and moved once per destination block that needs it;
    - ``source_outer``: every destination accumulator stays on the device
      and each source block moves once a hop (``num_shards`` times fewer
      bytes), at O(N·F) device memory.

    ``auto`` takes ``source_outer`` when the accumulators fit
    ``acc_budget_bytes``. ``transfer_dtype="bfloat16"`` moves the source
    blocks at half width and widens them to f32 on the device before the
    products (the kernel takes f32); accumulation and the hop files stay
    f32. ``stats``, when given, receives ``mode``, ``pack_s`` (host packing),
    ``hop_s`` (one per hop), ``nonempty_buckets``, and the bytes of the
    largest bucket pack and of all of them (``max_pack_bytes``,
    ``pack_bytes``)."""
    if local_engine not in ("hybrid", "coo"):
        raise ValueError(f"unknown local engine {local_engine!r}; use 'hybrid' or 'coo'")
    if transfer_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown transfer dtype {transfer_dtype!r}")
    dev = resolve_device(device)
    stage_feature_blocks(features_path, meta, work_dir)
    hop_dirs = [osp.join(work_dir, "hop0")]
    s, block = meta.num_shards, meta.block
    buckets = bucket_edges(meta)
    nonempty = [(i, j) for i in range(s) for j in range(s)
                if buckets[i][3][j] != buckets[i][3][j + 1]]
    has_edges = set(nonempty)

    f_dim = int(np.load(osp.join(hop_dirs[0], "block0.npy"), mmap_mode="r").shape[1])
    if mode == "auto":
        mode = "source_outer" if s * block * f_dim * 4 <= acc_budget_bytes else "dest_outer"
    if mode not in ("source_outer", "dest_outer"):
        raise ValueError(f"unknown schedule {mode!r}")
    xfer = torch.bfloat16 if transfer_dtype == "bfloat16" else torch.float32

    t0 = time.perf_counter()
    packs = {}
    if local_engine == "hybrid":
        pin = dev.type == "cuda"
        for i, j in nonempty:
            r, c, v, off = buckets[i]
            ec, ev, tail = pack_bucket(r[off[j]:off[j + 1]], c[off[j]:off[j + 1]],
                                       v[off[j]:off[j + 1]], block)
            packs[(i, j)] = HostPack(_host(ec, pin), _host(ev, pin),
                                     None if tail is None else
                                     tuple(_host(a, pin) for a in tail))
    pack_s = time.perf_counter() - t0

    def load_block(hop_dir: str, j: int) -> torch.Tensor:
        blk = torch.from_numpy(np.load(osp.join(hop_dir, f"block{j}.npy")))
        return blk.to(xfer).to(dev).float()

    def apply_bucket(i: int, j: int, xj: torch.Tensor, acc: torch.Tensor) -> None:
        """acc += A[i, j] @ xj with the chosen local engine."""
        if local_engine == "hybrid":
            pack = packs[(i, j)]
            acc += ell_spmm(pack.cols.to(dev, non_blocking=True),
                            pack.vals.to(dev, non_blocking=True), xj)
            if pack.tail is not None:
                tr, tc, tv = (t.to(dev, non_blocking=True) for t in pack.tail)
                coo_accumulate(tr, tc, tv, xj, acc, chunk=_CHUNK)
            return
        r, c, v, off = buckets[i]
        lo, hi = int(off[j]), int(off[j + 1])
        n_pad = _pow2_pad(hi - lo)
        padded = [np.zeros(n_pad, dt) for dt in (np.int32, np.int32, np.float32)]
        for dst, src in zip(padded, (r, c, v)):
            dst[: hi - lo] = src[lo:hi]
        coo_accumulate(*(torch.from_numpy(a).to(dev) for a in padded), xj, acc, chunk=_CHUNK)

    hop_s = []
    for h in range(prop_steps):
        t_hop = time.perf_counter()
        prev_dir = hop_dirs[-1]
        cur_dir = osp.join(work_dir, f"hop{h + 1}")
        os.makedirs(cur_dir, exist_ok=True)
        if mode == "source_outer":
            accs = [torch.zeros((block, f_dim), dtype=torch.float32, device=dev)
                    for _ in range(s)]
            for j in range(s):
                xj = load_block(prev_dir, j)
                for i in range(s):
                    if (i, j) in has_edges:
                        apply_bucket(i, j, xj, accs[i])
                del xj
            for i in range(s):
                np.save(osp.join(cur_dir, f"block{i}.npy"), accs[i].cpu().numpy())
            del accs
        else:
            for i in range(s):
                acc = torch.zeros((block, f_dim), dtype=torch.float32, device=dev)
                for j in range(s):
                    if (i, j) in has_edges:  # an empty bucket moves no block
                        apply_bucket(i, j, load_block(prev_dir, j), acc)
                np.save(osp.join(cur_dir, f"block{i}.npy"), acc.cpu().numpy())
                del acc
        synchronize(dev)
        hop_s.append(time.perf_counter() - t_hop)
        if verbose:
            print(f"out-of-core hop {h + 1}/{prop_steps} done ({mode})")
        hop_dirs.append(cur_dir)
    if stats is not None:
        sizes = [p.nbytes for p in packs.values()]
        stats.update(mode=mode, pack_s=pack_s, hop_s=hop_s, nonempty_buckets=len(nonempty),
                     max_pack_bytes=max(sizes, default=0), pack_bytes=sum(sizes))
    return hop_dirs


def load_hop_rows(hop_dir: str, meta: StreamingGraphMeta, node_ids: np.ndarray) -> np.ndarray:
    """Gather node rows from a per-block hop directory (memory-mapped), to
    feed training batches without assembling the full hop."""
    node_ids = np.asarray(node_ids)
    out = None
    blocks = node_ids // meta.block
    for b in np.unique(blocks):
        blk = np.load(osp.join(hop_dir, f"block{int(b)}.npy"), mmap_mode="r")
        m = blocks == b
        rows = np.asarray(blk[node_ids[m] - b * meta.block])
        if out is None:
            out = np.zeros((node_ids.shape[0], rows.shape[1]), np.float32)
        out[m] = rows
    return out
