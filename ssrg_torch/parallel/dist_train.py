"""SPMD training: distributed propagation, then a data-parallel head, with
the reference's evaluation protocol under the mesh (counterpart of
``ssrg_tpu/parallel/dist_train.py``), on ``torch.distributed``.

1. ``dist_propagate*`` give each rank the hops of its graph row block.
2. The head (an ``nn.Module`` from :func:`ssrg_torch.models.zoo.load_model`)
   is replicated: rank 0's initial parameters are broadcast. Each rank
   takes the loss over its rows, summed and divided by the global train
   count, so that the gradients summed over the world by one ``all_reduce``
   are the reference's global masked mean. With a ``data_axis`` the ranks of
   one data group hold the same hops and each keeps its ``1/D_data`` slice
   of the rows, as the reference's ``P(None, (graph, data), None)`` does.
3. Adam updates every replica alike.

:func:`run_steps` runs full steps (propagate and head each step), the
liveness and parity path. :func:`run_epochs_scan` propagates once and trains
the head epoch by epoch with masked val/test accuracy (global counts) and
best-val→test selection, in one host loop where the reference scans on the
device (as ``scan_epochs`` does on one card); :func:`run_multi` adds the
reference's multi-run mean±std.

The reference applies the head with its parameters only, so a head with
BatchNorm fails at its first step there; :func:`build_spmd_context` refuses
one before any work, rather than invent a synchronized BatchNorm.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from ssrg_torch.models.heads import BatchNorm, bind_generator
from ssrg_torch.parallel.dist_spmm import (
    comm_stats,
    dist_propagate,
    dist_propagate_hybrid,
    dist_propagate_tiled,
    format_bytes,
    shard_adjacency,
    shard_adjacency_hybrid,
    shard_adjacency_tiled,
    shard_features,
)
from ssrg_torch.parallel.mesh import Mesh, node_slice
from ssrg_torch.parallel.partition import (
    cluster_reorder_for_partition,
    partition_rows,
    partition_rows_hybrid,
    partition_rows_tiled,
)
from ssrg_torch.train.common import make_optimizer
from ssrg_torch.utils import DeviceLike, resolve_device

log = logging.getLogger("ssrg_torch")

PROPAGATE_FNS = {
    "hybrid": dist_propagate_hybrid,
    "tiled": dist_propagate_tiled,
    "coo": dist_propagate,
}


@dataclass
class SPMDTrainContext:
    """Everything one rank needs to run sharded training steps."""

    mesh: Mesh
    adj: Any                      # ShardedAdj | ShardedHybridAdj | ShardedTiledAdj
    x: torch.Tensor               # [block, F] this rank's graph rows
    y: torch.Tensor               # [rows] labels of this rank's head rows
    train_mask: torch.Tensor      # [rows] f32 (0 on padding)
    module: nn.Module             # the replicated head
    optimizer: torch.optim.Optimizer
    propagate_fn: Callable        # (adj, x, K) -> [K+1, block, F]
    prop_steps: int
    head_rows: Tuple[int, int]    # this rank's head rows, local to its graph block
    train_count: float            # the global train rows, the loss's denominator
    val_mask: Optional[torch.Tensor] = None
    test_mask: Optional[torch.Tensor] = None
    hops: Optional[torch.Tensor] = None      # cached [K+1, rows, F] head rows
    init_fn: Optional[Callable] = None       # seed -> fresh parameters and optimizer
    comm: Optional[dict] = None              # comm_stats of the exchange


@dataclass
class SPMDRunResult:
    """Best-val→test outcome of one (or several) SPMD runs."""

    best_val: float
    best_test: float
    best_epoch: int
    final_loss: float
    history: Tuple[np.ndarray, ...] = ()           # (loss, val, test) per epoch
    runs: Tuple[Tuple[float, float], ...] = ()     # per-run (val, test)

    @property
    def mean_std(self) -> Tuple[float, float, float, float]:
        """(val_mean, val_std, test_mean, test_std) over runs."""
        vals = np.array([r[0] for r in self.runs] or [self.best_val])
        tests = np.array([r[1] for r in self.runs] or [self.best_test])
        return (float(vals.mean()), float(vals.std()),
                float(tests.mean()), float(tests.std()))


def _masked_accuracy(logits: torch.Tensor, y: torch.Tensor, mask: torch.Tensor
                     ) -> torch.Tensor:
    """The fraction of the mask-weighted rows whose argmax matches ``y``,
    over the whole world (one ``all_reduce`` of the counts), on the device.
    ``mask`` ``[rows]`` gives a scalar, a stack ``[m, rows]`` one accuracy per
    mask."""
    correct = (logits.argmax(dim=-1) == y).float()
    masks = mask.reshape(-1, mask.shape[-1])
    sums = torch.stack([(masks * correct).sum(dim=1), masks.sum(dim=1)])
    dist.all_reduce(sums)
    acc = sums[0] / torch.clamp_min(sums[1], 1.0)
    return acc.reshape(mask.shape[:-1])


def _refuse_batch_norm(module: nn.Module) -> None:
    if any(isinstance(m, BatchNorm) for m in module.modules()):
        raise ValueError(
            "build_spmd_context: the head holds BatchNorm (use_bn=True). The reference "
            "applies the head with its parameters only, so such a head fails at its first "
            "step there (no batch_stats); the port refuses it rather than invent a "
            "synchronized BatchNorm. Use use_bn=False.")


def _dropout_generator(device: torch.device, seed: int, rank: int) -> torch.Generator:
    """Each rank's dropout draws, from ``(seed, rank)``: the ranks hold
    different rows, as the reference's one global mask does."""
    state = int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(state)


def _context(mesh: Mesh, adj, x_block: torch.Tensor, values: Callable, module: nn.Module,
             prop_steps: int, lr: float, weight_decay: float, axis: str,
             data_axis: Optional[str], seed: int, local_engine: str, train_idx,
             val_idx, test_idx, y, comm: dict) -> SPMDTrainContext:
    """The context every SPMD entry point shares: ``values(array, axes)``
    gives this rank's rows of a per-node host vector (zero-padded to
    n_pad), as a tensor on its device."""
    dev = mesh.device
    n_pad = adj.n_pad
    axes = (axis,) if data_axis is None else (axis, data_axis)
    lo, hi = node_slice(mesh, axes, n_pad)
    g0 = mesh.coords[axis] * adj.block

    def idx_mask(idx):
        if idx is None:
            return None
        m = np.zeros(n_pad, np.float32)
        m[np.asarray(idx)] = 1.0
        return values(m, axes)

    y_pad = np.zeros(n_pad, np.int64)
    y_arr = np.asarray(y, np.int64)
    y_pad[: y_arr.shape[0]] = y_arr
    train_mask = idx_mask(train_idx)
    count = train_mask.sum().reshape(1)
    dist.all_reduce(count)
    module.to(dev)

    def init_fn(s: int):
        # initialized on the host from a CPU generator, as one card does, then
        # rank 0's values go to every replica
        module.cpu()
        module.reset_parameters(torch.Generator().manual_seed(s))
        module.to(dev)
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t, src=0)
        return make_optimizer(module.parameters(), lr, weight_decay)

    ctx = SPMDTrainContext(
        mesh=mesh, adj=adj, x=x_block, y=values(y_pad, axes), train_mask=train_mask,
        module=module, optimizer=init_fn(seed), propagate_fn=PROPAGATE_FNS[local_engine],
        prop_steps=prop_steps, head_rows=(lo - g0, hi - g0),
        train_count=max(float(count), 1.0), val_mask=idx_mask(val_idx),
        test_mask=idx_mask(test_idx), init_fn=init_fn, comm=comm)
    return ctx


def _log_comm(stats: dict, comm: str, local_engine: str, part) -> None:
    halo_note = ""
    if comm == "halo":
        ag = comm_stats(stats["num_shards"], part.block, stats["feature_dim"],
                        stats["prop_steps"], mode="all_gather")
        ratio = ag["bytes_per_device_per_hop"] / max(stats["bytes_per_device_per_hop"], 1)
        halo_note = (f", halo {part.halo_pad}/{part.block} rows/shard (fraction "
                     f"{part.halo_fraction:.3f}; all_gather equivalent "
                     f"{format_bytes(ag['bytes_per_device_per_hop'])}/device/hop = "
                     f"{ratio:.2f}x the halo volume)")
        if part.halo_pad >= part.block:
            log.warning(
                "halo plan saturated (halo_pad %d >= block %d): each shard needs at least a "
                "full block of remote rows per peer, so halo exchange ships >= the "
                "all_gather volume. The graph has no community structure under the current "
                "ordering — use reorder='cluster' (and a community-structured graph) or "
                "comm='all_gather'.", part.halo_pad, part.block)
    log.info("spmd comm (%s, local_engine=%s, %d graph shards): %s/device/hop, %s mesh total "
             "per %d-hop propagate, peak feature memory %s/device%s", comm, local_engine,
             stats["num_shards"], format_bytes(stats["bytes_per_device_per_hop"]),
             format_bytes(stats["bytes_mesh_total"]), stats["prop_steps"],
             format_bytes(stats["peak_feature_bytes_per_device"]), halo_note)


def _check_device(device: Optional[DeviceLike], mesh: Mesh) -> None:
    dev = None if device is None else resolve_device(device)
    if dev is not None and (dev.type != mesh.device.type
                            or dev.index not in (None, mesh.device.index)):
        raise ValueError(f"device {device} is not the mesh's device {mesh.device}")


def _check_comm(comm: str, local_engine: str) -> None:
    if comm not in ("all_gather", "halo"):
        raise ValueError(f"unknown comm {comm!r} (use 'all_gather' or 'halo'; the ring "
                         "exchange is the separate dist_propagate_ring path)")
    if comm == "halo" and local_engine not in ("hybrid", "tiled"):
        raise ValueError("comm='halo' requires local_engine hybrid|tiled")


def build_spmd_context(
    adj_scipy,
    x: np.ndarray,
    y: np.ndarray,
    train_idx: np.ndarray,
    module: nn.Module,
    mesh: Mesh,
    prop_steps: int,
    lr: float = 1e-2,
    weight_decay: float = 1e-5,
    axis: str = "graph",
    data_axis: Optional[str] = None,
    seed: int = 0,
    local_engine: str = "hybrid",
    comm: str = "all_gather",
    reorder: Optional[str] = None,
    tile_bf16: bool = False,
    val_idx: Optional[np.ndarray] = None,
    test_idx: Optional[np.ndarray] = None,
    device: Optional[DeviceLike] = None,
) -> SPMDTrainContext:
    """Partition the graph over ``mesh``, copy this rank's shard to its
    device and initialize the replicated head. Collective: every rank calls
    it with the same arguments.

    ``local_engine``: ``"hybrid"`` (ELL kernel plus COO tail per shard),
    ``"tiled"`` (dense tiles plus the hybrid rest; ``tile_bf16`` stores the
    tiles in bf16) or ``"coo"`` (segment sum). ``comm="halo"`` (hybrid or
    tiled) ships only the planned boundary rows; pair it with
    ``reorder="cluster"``, which renumbers the nodes by communities first (x,
    y, the masks and the hops then live in that order). ``val_idx`` and
    ``test_idx`` install the masks :func:`run_epochs_scan` and
    :func:`evaluate` need. ``device`` defaults to the mesh's, the only one it
    may name."""
    _refuse_batch_norm(module)
    _check_device(device, mesh)
    if reorder == "cluster":
        adj_scipy, x, y, inverse = cluster_reorder_for_partition(adj_scipy, x, y)
        train_idx = inverse[np.asarray(train_idx)]
        if val_idx is not None:
            val_idx = inverse[np.asarray(val_idx)]
        if test_idx is not None:
            test_idx = inverse[np.asarray(test_idx)]
    elif reorder is not None:
        raise ValueError(f"unknown reorder {reorder!r} (use 'cluster')")
    _check_comm(comm, local_engine)
    num_graph_shards = mesh.shape[axis]
    n_nodes = adj_scipy.shape[0]
    # the production row alignment on toy graphs would put every node in shard 0
    big = n_nodes >= 256 * num_graph_shards
    if local_engine == "hybrid":
        part = partition_rows_hybrid(adj_scipy, num_graph_shards, halo=(comm == "halo"),
                                     row_align=256 if big else 8)
        sharded = shard_adjacency_hybrid(part, mesh, axis)
    elif local_engine == "tiled":
        part = partition_rows_tiled(adj_scipy, num_graph_shards, halo=(comm == "halo"),
                                    row_block=256 if big else 8,
                                    tile_cols=512 if big else 16,
                                    min_edges_per_tile=48 if big else 4)
        sharded = shard_adjacency_tiled(part, mesh, axis,
                                        dtype=torch.bfloat16 if tile_bf16 else torch.float32)
        log.info("tiled local engine: tiled_fraction %.3f (%d tile pairs/shard)",
                 part.tiled_fraction, part.starts.shape[1])
    elif local_engine == "coo":
        part = partition_rows(adj_scipy, num_graph_shards)
        sharded = shard_adjacency(part, mesh, axis)
    else:
        raise ValueError(f"unknown local_engine {local_engine!r} "
                         "(use 'hybrid', 'tiled' or 'coo')")
    stats = comm_stats(num_graph_shards, part.block, x.shape[1], prop_steps, mode=comm,
                       halo_pad=getattr(part, "halo_pad", 0))
    _log_comm(stats, comm, local_engine, part)

    def values(arr: np.ndarray, axes) -> torch.Tensor:
        lo, hi = node_slice(mesh, axes, part.n_pad)
        return torch.from_numpy(np.ascontiguousarray(arr[lo:hi])).to(mesh.device)

    return _context(mesh, sharded, shard_features(x, part, mesh, axis), values, module,
                    prop_steps, lr, weight_decay, axis, data_axis, seed, local_engine,
                    train_idx, val_idx, test_idx, y, stats)


@torch.no_grad()
def _precompute(ctx: SPMDTrainContext) -> torch.Tensor:
    """This rank's head rows of the propagated hops."""
    hops = ctx.propagate_fn(ctx.adj, ctx.x, ctx.prop_steps)
    lo, hi = ctx.head_rows
    return hops[:, lo:hi].contiguous()


def _train_step(ctx: SPMDTrainContext, hops: torch.Tensor) -> torch.Tensor:
    """One update of the replicated head; the global loss (a device scalar,
    the same on every rank)."""
    module = ctx.module.train()
    losses = F.cross_entropy(module(hops), ctx.y, reduction="none")
    loss = (losses * ctx.train_mask).sum() / ctx.train_count
    ctx.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    params = list(module.parameters())
    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                      for p in params] + [loss.detach().reshape(1)])
    dist.all_reduce(flat)
    offset = 0
    for p in params:
        p.grad = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    ctx.optimizer.step()
    return flat[-1]


def run_steps(ctx: SPMDTrainContext, num_steps: int, seed: int = 0):
    """Full steps, each propagating and then updating the head; returns
    ``(ctx, last global loss)``, ``nan`` for ``num_steps == 0``. Training
    proper should use :func:`run_epochs_scan`: propagation does not depend on
    the parameters."""
    bind_generator(ctx.module, _dropout_generator(ctx.mesh.device, seed, ctx.mesh.rank))
    loss = None
    for _ in range(num_steps):
        loss = _train_step(ctx, _precompute(ctx))
    return ctx, (float("nan") if loss is None else float(loss))


def ensure_hops(ctx: SPMDTrainContext) -> torch.Tensor:
    """Propagate once and cache this rank's head rows of the hops, ``[K+1,
    rows, F]`` (the reference returns the global tensor, sharded)."""
    if ctx.hops is None:
        ctx.hops = _precompute(ctx)
    return ctx.hops


def _require_eval_masks(ctx: SPMDTrainContext, who: str) -> None:
    if ctx.val_mask is None or ctx.test_mask is None:
        raise ValueError(
            f"{who} needs evaluation masks: pass val_idx= and test_idx= to "
            "build_spmd_context (best-val→test selection is undefined without a "
            "validation split)")


def run_epochs_scan(ctx: SPMDTrainContext, num_epochs: int, seed: int = 0
                    ) -> Tuple[SPMDTrainContext, SPMDRunResult]:
    """Train the head ``num_epochs`` epochs on the hops propagated once
    (:func:`ensure_hops`), with masked val/test accuracy after each update
    and the best-val epoch's test accuracy kept on the device."""
    _require_eval_masks(ctx, "run_epochs_scan")
    hops = ensure_hops(ctx)
    bind_generator(ctx.module, _dropout_generator(ctx.mesh.device, seed, ctx.mesh.rank))
    dev = ctx.mesh.device
    eval_masks = torch.stack([ctx.val_mask, ctx.test_mask])
    epochs = torch.arange(num_epochs, dtype=torch.float32, device=dev)
    best = torch.zeros(3, device=dev)           # best val, its test, its epoch
    history = []
    for epoch in range(num_epochs):
        loss = _train_step(ctx, hops)
        with torch.no_grad():
            acc = _masked_accuracy(ctx.module.eval()(hops), ctx.y, eval_masks)
        best = torch.where(acc[0] > best[0], torch.stack([acc[0], acc[1], epochs[epoch]]),
                           best)
        history.append(torch.stack([loss, acc[0], acc[1]]))
    rows = torch.stack(history).cpu().numpy().T if history else np.zeros((3, 0), np.float32)
    bv, bt, be = best.tolist()
    result = SPMDRunResult(best_val=bv, best_test=bt, best_epoch=int(be),
                           final_loss=float(rows[0][-1]) if num_epochs else float("nan"),
                           history=tuple(rows))
    return ctx, result


def run_multi(ctx: SPMDTrainContext, num_epochs: int, num_runs: int, seed: int = 0
              ) -> Tuple[SPMDTrainContext, SPMDRunResult]:
    """The reference's multi-run protocol: fresh parameters for each run
    (seed, seed+1, ...), each trained by :func:`run_epochs_scan`, the per-run
    best-val→test pairs in ``runs`` (mean±std via ``mean_std``)."""
    _require_eval_masks(ctx, "run_multi")
    runs = []
    last = None
    for r in range(num_runs):
        ctx.optimizer = ctx.init_fn(seed + r)
        ctx, last = run_epochs_scan(ctx, num_epochs, seed=seed + r)
        runs.append((last.best_val, last.best_test))
    last.runs = tuple(runs)
    return ctx, last


@torch.no_grad()
def evaluate(ctx: SPMDTrainContext) -> dict:
    """Masked train/val/test accuracy of the current parameters on the
    cached hops, over the whole world."""
    hops = ensure_hops(ctx)
    names = ["train_acc"] + [n for n, m in (("val_acc", ctx.val_mask),
                                            ("test_acc", ctx.test_mask)) if m is not None]
    masks = torch.stack([m for m in (ctx.train_mask, ctx.val_mask, ctx.test_mask)
                         if m is not None])
    acc = _masked_accuracy(ctx.module.eval()(hops), ctx.y, masks)
    return dict(zip(names, acc.tolist()))
