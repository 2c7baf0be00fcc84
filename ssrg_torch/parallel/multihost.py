"""Several processes, one program: per-rank shard loading into SPMD training
(counterpart of ``ssrg_tpu/parallel/multihost.py``), on ``torch.distributed``.

Every process

1. calls :func:`initialize_multihost`, which joins the world from its
   arguments or from ``torchrun``'s variables (``MASTER_ADDR``,
   ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``): NCCL and one
   card per rank for ``cuda``, gloo for the host;
2. loads ONLY the adjacency shard and feature rows its rank owns
   (:func:`ssrg_torch.data.streaming.load_shard` and
   :func:`~ssrg_torch.data.streaming.shard_feature_block`; the spool directory,
   written by either package, is shardable by construction);
3. builds the same context as
   :func:`ssrg_torch.parallel.dist_train.build_spmd_context` from them, and
   trains with the same functions.

The geometry every rank needs (padded nnz, ELL width, tail sizes, the halo
plan) is a pure function of the spool's small side files, so the ranks agree
on it without communicating.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp
import torch
import torch.distributed as dist

from ssrg_torch.data.streaming import (
    SPOOL_RECORD,
    StreamingGraphMeta,
    load_shard,
    load_spool_fast_meta,
    load_spool_halo_cols,
    shard_feature_block,
)
from ssrg_torch.parallel.dist_spmm import ShardedAdj, ShardedHybridAdj, comm_stats
from ssrg_torch.parallel.mesh import TIMEOUT, Mesh, backend_for, make_mesh, node_slice
from ssrg_torch.parallel.partition import _build_halo_plan, _remap_cols, _round_up, _tail_geometry
from ssrg_torch.utils import DeviceLike, resolve_device


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    device: DeviceLike = "cuda",
    timeout: timedelta = TIMEOUT,
) -> bool:
    """Join the world (or find there is none to join); True when more than
    one process runs after the call.

    Already initialized: nothing to do. Otherwise the arguments, or
    ``torchrun``'s ``WORLD_SIZE``, ``RANK`` and ``MASTER_ADDR:MASTER_PORT``,
    say where to join: ``coordinator_address`` is ``host:port`` (a TCP
    store) or a ``file://`` or ``tcp://`` URL. No coordinator and one process
    (or none named) is a plain single-process run: False, and nothing is
    started. On ``cuda`` the rank's card is ``local_device_ids[0]``, else
    ``LOCAL_RANK``, else the rank modulo the cards; the backend is NCCL, and
    a card or NCCL that is missing raises."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if coordinator_address is None and num_processes in (None, 1):
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize_multihost needs a coordinator address, the number of "
                         "processes and this process's id (or torchrun's variables)")
    dev = resolve_device(device)
    backend = backend_for(dev)
    if dev.type == "cuda":
        if local_device_ids:
            index = int(local_device_ids[0])
        else:
            index = int(env.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(index)
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, timeout=timeout)
    return num_processes > 1


def global_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("graph",),
    device: Optional[DeviceLike] = None,
) -> Mesh:
    """A mesh over every rank of the world, the same on every process."""
    return make_mesh(shape=shape, axis_names=axis_names, device=device)


def spool_nnz_pad(meta: StreamingGraphMeta, align: int = 512) -> int:
    """The padded nnz every shard agrees on: a pure function of the spool
    files' sizes, so every rank computes it without communication."""
    sizes = [os.path.getsize(os.path.join(meta.spool_dir, f"shard_{d}.bin"))
             // SPOOL_RECORD.itemsize for d in range(meta.num_shards)]
    return _round_up(max(max(sizes), 1), align)


def _graph_shard(meta: StreamingGraphMeta, mesh: Mesh, axis: str) -> int:
    if meta.num_shards != mesh.shape[axis]:
        raise ValueError(f"spool has {meta.num_shards} shards but mesh axis {axis!r} has "
                         f"size {mesh.shape[axis]}; re-spool with num_shards={mesh.shape[axis]}")
    return mesh.coords[axis]


def _tensor(arr: np.ndarray, mesh: Mesh) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(mesh.device)


def shard_adjacency_from_spool(meta: StreamingGraphMeta, mesh: Mesh, axis: str = "graph"
                               ) -> ShardedAdj:
    """This rank's :class:`ShardedAdj`, loaded from its own spool file only.
    The spool must have one shard per position of the mesh's ``axis``."""
    shard = _graph_shard(meta, mesh, axis)
    r, c, v = load_shard(meta, shard, spool_nnz_pad(meta))
    return ShardedAdj(rows=_tensor(r, mesh), cols=_tensor(c, mesh), vals=_tensor(v, mesh),
                      mesh=mesh, axis=axis, block=meta.block, n=meta.num_nodes)


def shard_adjacency_hybrid_from_spool(
    meta: StreamingGraphMeta,
    mesh: Mesh,
    axis: str = "graph",
    comm: str = "all_gather",
    lane_pad: int = 8,
    tail_chunk: int = 1 << 19,
) -> ShardedHybridAdj:
    """This rank's shard in the hybrid layout (ELL slots plus a COO tail),
    packed from its own spool file with the geometry every rank reads from
    ``fast_meta.json``; with ``comm='halo'`` the halo plan is built the same
    on every rank from the ``halo_<d>.npy`` column lists."""
    from ssrg_torch import native

    shard = _graph_shard(meta, mesh, axis)
    if comm not in ("all_gather", "halo"):
        raise ValueError(f"unknown comm {comm!r} (use 'all_gather' or 'halo')")
    block = meta.block
    fast = load_spool_fast_meta(meta)
    width = int(fast["width"])
    send_idx, halo_pad, col_map = None, 0, None
    if comm == "halo":
        send_idx, halo_pad, _, col_maps = _build_halo_plan(
            load_spool_halo_cols(meta), meta.num_shards, block, lane_pad)
        col_map = col_maps[shard]
    # the tail sizes are upper bounds: merging duplicate entries only shrinks a row
    tail_chunk, tail_pad = _tail_geometry(max(max(int(t) for t in fast["tail_sizes"]), 1),
                                          tail_chunk)
    r, c, v = load_shard(meta, shard)
    cols = c.astype(np.int64)
    if col_map is not None:
        cols = _remap_cols(cols, shard, block, col_map).astype(np.int64)
    ncols = max(int(cols.max()) + 1, 1) if cols.size else 1
    csr = sp.csr_matrix((v.astype(np.float32), (r.astype(np.int64), cols)), shape=(block, ncols))
    ec, ev, tr, tc, tv = native.ell_hybrid_pack(csr.indptr, csr.indices, csr.data, width, block)
    if tr.size > tail_pad:
        raise AssertionError(f"shard {shard} tail {tr.size} exceeds agreed pad {tail_pad}")
    tails = [np.zeros(tail_pad, dt) for dt in (np.int32, np.int32, np.float32)]
    for dst, src in zip(tails, (tr, tc, tv)):
        dst[: src.size] = src
    return ShardedHybridAdj(
        ell_cols=_tensor(ec, mesh), ell_vals=_tensor(ev, mesh),
        tail_rows=_tensor(tails[0], mesh), tail_cols=_tensor(tails[1], mesh),
        tail_vals=_tensor(tails[2], mesh),
        send_idx=None if send_idx is None else _tensor(send_idx[shard], mesh),
        mesh=mesh, axis=axis, block=block, n=meta.num_nodes, width=width,
        tail_chunk=tail_chunk, halo_pad=halo_pad)


def shard_features_from_file(features_path: str, meta: StreamingGraphMeta, mesh: Mesh,
                             axis: str = "graph") -> torch.Tensor:
    """This rank's ``[block, F]`` feature rows, memory-mapped from the file."""
    return _tensor(shard_feature_block(features_path, meta, _graph_shard(meta, mesh, axis)),
                   mesh)


def shard_node_values(values: np.ndarray, meta: StreamingGraphMeta, mesh: Mesh,
                      axes: Sequence[str] = ("graph",)) -> torch.Tensor:
    """This rank's rows of a per-node vector (labels, masks) zero-padded to
    ``n_pad``, the node axis split over ``axes``; ``values`` may be a memory
    map, of which only these rows are read."""
    n_pad = meta.block * meta.num_shards
    lo, hi = node_slice(mesh, axes, n_pad)
    out = np.zeros(hi - lo, np.asarray(values[:1]).dtype)
    top = min(hi, values.shape[0])
    if lo < top:
        out[: top - lo] = values[lo:top]
    return _tensor(out, mesh)


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Every array or tensor of a nested dict, list or tuple on this rank's
    device. Every rank must hold the same values (e.g. drawn from one seed):
    nothing is communicated."""
    if isinstance(tree, dict):
        return {k: replicate(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(v, mesh) for v in tree)
    return torch.as_tensor(np.asarray(tree) if not torch.is_tensor(tree) else tree
                           ).to(mesh.device)


def build_spmd_context_from_spool(
    meta: StreamingGraphMeta,
    features_path: str,
    y: np.ndarray,
    train_idx: np.ndarray,
    module,
    mesh: Mesh,
    prop_steps: int,
    lr: float = 1e-2,
    weight_decay: float = 1e-5,
    axis: str = "graph",
    data_axis: Optional[str] = None,
    seed: int = 0,
    local_engine: str = "hybrid",
    comm: str = "all_gather",
    val_idx: Optional[np.ndarray] = None,
    test_idx: Optional[np.ndarray] = None,
    device: Optional[DeviceLike] = None,
):
    """The spool-fed twin of
    :func:`ssrg_torch.parallel.dist_train.build_spmd_context`: the same
    context and training functions, every tensor loaded by its own rank from
    the streaming partitioner's files. ``local_engine='hybrid'`` packs the
    shard for the ELL kernel (``comm='halo'`` ships only the planned
    boundary rows); ``'coo'`` keeps the padded COO segment sum. Collective:
    every process calls it with the same arguments."""
    from ssrg_torch.parallel.dist_train import _check_device, _context, _refuse_batch_norm

    _refuse_batch_norm(module)
    _check_device(device, mesh)
    if local_engine == "hybrid":
        adj = shard_adjacency_hybrid_from_spool(meta, mesh, axis, comm=comm)
    elif local_engine == "coo":
        if comm != "all_gather":
            raise ValueError("local_engine='coo' supports comm='all_gather'")
        adj = shard_adjacency_from_spool(meta, mesh, axis)
    else:
        raise ValueError(f"unknown local_engine {local_engine!r} (use 'hybrid' or 'coo')")
    xs = shard_features_from_file(features_path, meta, mesh, axis)
    stats = comm_stats(meta.num_shards, meta.block, xs.shape[1], prop_steps, mode=comm,
                       halo_pad=getattr(adj, "halo_pad", 0))
    return _context(mesh, adj, xs, lambda arr, axes: shard_node_values(arr, meta, mesh, axes),
                    module, prop_steps, lr, weight_decay, axis, data_axis, seed, local_engine,
                    train_idx, val_idx, test_idx, y, stats)
