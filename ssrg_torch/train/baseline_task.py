"""Baseline pipeline trainer (counterpart of ``ssrg_tpu/train/baseline_task.py``).

Choose a model (MLP, robust MLP, GCN, SAGE, GAT, UniMP, SGC, SIGN), run it
``runs`` times, each run full-batch epochs with best-val selection through
:class:`ssrg_torch.logger.RunLogger`; or, for GCN, SAGE and GAT, train on
cluster minibatches.

The engines: SGC and SIGN precompute their hops on any engine that
:func:`~ssrg_torch.ops.sparse.device_adjacency` takes; GCN and SAGE train on
a :func:`~ssrg_torch.ops.sparse.differentiable_adjacency` (the ELL kernel
forward and, on the pack of ``A^T``, backward). The forward-only kernels
(the ``pallas`` and ``pallas_banded`` engines, a tiled pack whose rest runs
the rest kernel) cannot train them: the reference fails at its first step
there, and the port raises a ``RuntimeError`` at construction.

Cluster minibatches: nodes in BFS order (no METIS), split into
``num_parts`` contiguous parts, groups of ``parts_per_batch`` parts in a
seeded order; each group trains on its induced subgraph, one optimizer step
per batch. The reference pads every group to the largest by repeating its
first node, which repeats that node's edges in the induced subgraph
(ROADMAP.md section 3); the port pads nothing: a batch is exactly its
group, its sub-adjacency ``norm(adj[g][:, g])``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import scipy.sparse as sp
import torch

from ssrg_torch.configs.config import TrainingConfig
from ssrg_torch.logger import RunLogger, count, span
from ssrg_torch.models.baselines import (
    BaselineGAT,
    BaselineGCN,
    BaselineMLP,
    BaselineSAGE,
    BaselineSGC,
    BaselineSIGN,
    BaselineUniMP,
    EdgeList,
    RobustMLP,
    triplet_loss,
)
from ssrg_torch.ops.normalize import sym_norm
from ssrg_torch.ops.propagate import propagate
from ssrg_torch.ops.sparse import TiledAdj, device_adjacency, differentiable_adjacency
from ssrg_torch.train.common import (
    TrainState,
    accuracy,
    backward_and_update,
    create_train_state,
    cross_entropy_loss,
    seed_everything,
)
from ssrg_torch.utils import DeviceLike, resolve_device, synchronize


def mean_norm(adj: sp.spmatrix) -> sp.csr_matrix:
    """Row-mean normalization ``P = D^-1 A`` for SAGE."""
    csr = adj.tocsr().astype(np.float64)
    deg = np.asarray(csr.sum(axis=1)).reshape(-1)
    with np.errstate(divide="ignore"):
        inv = 1.0 / deg
    inv[~np.isfinite(inv)] = 0.0
    return (sp.diags(inv) @ csr).tocsr().astype(np.float32)


def bfs_order(adj: sp.csr_matrix) -> np.ndarray:
    """BFS node order for partition locality (METIS-free): a BFS from each
    node not yet seen, in id order."""
    from scipy.sparse.csgraph import breadth_first_order

    n = adj.shape[0]
    seen = np.zeros(n, bool)
    order = []
    for start in range(n):
        if seen[start]:
            continue
        nodes = breadth_first_order(adj, start, return_predecessors=False)
        nodes = nodes[~seen[nodes]]
        seen[nodes] = True
        order.append(nodes)
    return np.concatenate(order) if order else np.arange(n)


@dataclass
class ClusterBatch:
    node_ids: torch.Tensor   # int64 [B] global ids of the batch's nodes, on the device
    adj_dev: object          # the induced sub-adjacency: a device adjacency or an EdgeList


def cluster_groups(adj: sp.spmatrix, num_parts: int, parts_per_batch: int,
                   seed: int = 0) -> List[np.ndarray]:
    """The node ids of each cluster batch: BFS order split into
    ``num_parts`` parts, taken ``parts_per_batch`` at a time in a seeded
    order (the reference's groups, before its padding)."""
    order = bfs_order(adj)
    parts = np.array_split(order, num_parts)
    part_order = np.random.default_rng(seed).permutation(num_parts)
    return [np.concatenate([parts[i] for i in part_order[b:b + parts_per_batch]])
            for b in range(0, num_parts, parts_per_batch)]


def gat_edges(adj: sp.spmatrix, published: bool = False) -> EdgeList:
    """The :class:`EdgeList` a GAT consumes, on the host: the reference's
    padded list of ``adj``'s entries, or for the ``published`` form the
    attention listing with its self-loops that the fused kernels consume
    (:meth:`EdgeList.attention`)."""
    if published:
        return EdgeList.attention(adj)
    return EdgeList.from_scipy(adj)


def build_cluster_batches(
    adj: sp.spmatrix, num_parts: int, parts_per_batch: int,
    engine: str = "auto", seed: int = 0, model_kind: str = "gcn",
    device: DeviceLike = "cuda", published: bool = False,
) -> List[ClusterBatch]:
    """One batch per group of :func:`cluster_groups`, with the induced
    subgraph in the form ``model_kind`` consumes: ``gcn`` the symmetric-norm
    sub-adjacency, ``sage`` the row-mean one (both on
    ``differentiable_adjacency``), ``gat`` the subgraph's own
    :class:`EdgeList` (:func:`gat_edges` of the ``published`` form or the
    reference's). No padding: each batch holds its group's nodes and
    edges once."""
    dev = resolve_device(device)
    csr = adj.tocsr()
    norm = mean_norm if model_kind == "sage" else (lambda a: sym_norm(a, 0.5))
    batches = []
    for g in cluster_groups(csr, num_parts, parts_per_batch, seed):
        sub = csr[g][:, g]
        if model_kind == "gat":
            sub_dev = gat_edges(sub, published).to(dev)
        else:
            sub_dev = differentiable_adjacency(norm(sub), engine, device=dev)
        batches.append(ClusterBatch(torch.as_tensor(g, dtype=torch.int64, device=dev),
                                    sub_dev))
    return batches


def forward_only(adj) -> bool:
    """Whether ``adj``'s SpMM runs a kernel without a gradient: the
    ``pallas`` and ``pallas_banded`` packs, and a rest on the rest kernel
    (alone or under a tiled pack)."""
    from ssrg_torch.ops.pallas_banded import PallasBandedAdj
    from ssrg_torch.ops.pallas_rest import RestSegmentedAdj
    from ssrg_torch.ops.pallas_spmm import PallasELLAdj

    if isinstance(adj, TiledAdj):
        return forward_only(adj.rest)
    if isinstance(adj, RestSegmentedAdj):
        return adj.default_executor == "pallas"
    return isinstance(adj, (PallasELLAdj, PallasBandedAdj))


class BaselineTask:
    """Multi-run baseline trainer on ``device`` (``cuda`` by default).

    After a run, ``state`` holds the train state and ``history`` the last
    run's per-epoch ``loss``, ``train_acc``, ``val_acc`` and ``test_acc``;
    ``prepare_seconds`` is the time the constructor took to pack and
    propagate: its span ``prepare``.

    GAT takes ``heads`` (8 by default, the reference's), ``published``
    (PyG's ``GATConv`` form, see ``models/baselines.py::BaselineGAT``: skip
    linears and a bias after the aggregation, over the attention listing
    with self-loops that the fused kernels consume; without it the
    reference's form over its padded list) and ``attn_dropout``, the rate
    the attention's weights are dropped at (None: the form's own, the
    feature rate in the reference's, 0 in the published one). Its edges
    are built in the span ``prepare.edges``.

    UniMP (``models/baselines.py::BaselineUniMP``) takes ``heads``,
    ``attn_dropout`` (None: 0) and ``label_rate``, which it requires, and
    no feature dropout (the published stack has none: ``dropout`` is not
    read). Its listing, built in ``prepare.edges``, has no self-loops, and
    the places of its transposed entries are found there too. Each training
    step draws, from the train state's generator, which train nodes feed
    their labels (each with probability ``label_rate``, PyG's
    ``MaskLabel.ratio_mask``, counted in ``labels.fed``) and takes the loss
    over the others; evaluation feeds every train label."""

    MODELS = ("mlp", "robust_mlp", "gcn", "sage", "gat", "unimp", "sgc", "sign")

    def __init__(
        self,
        dataset,
        model_name: str,
        cfg: TrainingConfig,
        hidden_dim: int = 64,
        num_layers: int = 2,
        dropout: float = 0.5,
        runs: int = 1,
        prop_steps: int = 3,
        cluster_parts: Optional[int] = None,
        parts_per_batch: int = 8,
        triplet_weight: float = 0.0,
        verbose: bool = False,
        run: bool = True,
        device: DeviceLike = "cuda",
        heads: int = 8,
        published: bool = False,
        attn_dropout: Optional[float] = None,
        label_rate: Optional[float] = None,
    ):
        if model_name not in self.MODELS:
            raise ValueError(f"unknown baseline {model_name!r}; available: {self.MODELS}")
        if model_name == "unimp" and not (label_rate is not None and 0.0 <= label_rate <= 1.0):
            raise ValueError(f"unimp: label_rate must be given, in [0, 1]; got {label_rate}")
        if cluster_parts is not None and model_name not in ("gcn", "sage", "gat"):
            raise ValueError(
                "cluster minibatching applies to the full-graph models "
                f"(gcn/sage/gat), not {model_name!r}; precompute-family "
                "baselines minibatch over nodes instead"
            )
        with span("prepare") as whole:
            dev = self.device = resolve_device(device)
            self.dataset = dataset
            self.model_name = model_name
            self.cfg = cfg
            self.runs = runs
            self.verbose = verbose
            self.triplet_weight = triplet_weight
            self.logger = RunLogger(runs)
            self.num_classes = dataset.num_classes
            self.label_rate = label_rate
            self.history: dict = {}
            self.state: Optional[TrainState] = None

            engine = cfg.spmm_engine
            x = torch.as_tensor(np.asarray(dataset.x), dtype=torch.float32, device=dev)
            f, c = x.shape[1], self.num_classes
            self.labels = torch.as_tensor(np.asarray(dataset.y), dtype=torch.int64, device=dev)
            self.idx = {name: torch.as_tensor(np.asarray(getattr(dataset, f"{name}_idx")),
                                              dtype=torch.int64, device=dev)
                        for name in ("train", "val", "test")}

            self.adj_op = None
            self.inputs = x
            if model_name in ("gcn", "sage"):
                adj = dataset.adj
                with span("prepare.normalize"):
                    norm = sym_norm(adj, 0.5) if model_name == "gcn" else mean_norm(adj)
                self.adj_op = differentiable_adjacency(norm, engine, device=dev)
                if forward_only(self.adj_op):
                    raise RuntimeError(
                        f"{model_name}: engine {engine!r} is forward only (its kernel has no "
                        "gradient, and the reference fails at its first step there; "
                        "ROADMAP.md section 3); use 'hybrid'")
                cls = BaselineGCN if model_name == "gcn" else BaselineSAGE
                self.module = cls(f, hidden_dim, c, num_layers, dropout)
            elif model_name == "gat":
                adj = dataset.adj
                with span("prepare.edges"):
                    edges = gat_edges(adj, published)
                self.adj_op = edges.to(dev)
                self.module = BaselineGAT(f, hidden_dim, c, num_layers, heads=heads,
                                          dropout=dropout, published=published,
                                          attn_dropout=attn_dropout)
            elif model_name == "unimp":
                adj = dataset.adj  # its own span, prepare.adjacency, outside prepare.edges
                with span("prepare.edges"):
                    edges = EdgeList.attention(adj, self_loops=False).to(dev)
                    edges.positions()
                self.adj_op = edges
                self.module = BaselineUniMP(f, hidden_dim, c, num_layers, heads=heads,
                                            attn_dropout=attn_dropout or 0.0)
            elif model_name in ("sgc", "sign"):
                adj = dataset.adj
                with span("prepare.normalize"):
                    norm = sym_norm(adj, 0.5)
                p = device_adjacency(norm, engine, device=dev)
                with span("prepare.hops"):
                    hops = propagate(p, x, prop_steps, device=dev)
                if model_name == "sgc":
                    self.inputs = hops[-1].clone()
                    self.module = BaselineSGC(f, c)
                else:
                    self.inputs = hops
                    self.module = BaselineSIGN(f, hidden_dim, c, prop_steps + 1, dropout)
            elif model_name == "mlp":
                self.module = BaselineMLP(f, hidden_dim, c, num_layers, dropout)
            else:
                self.module = RobustMLP(f, hidden_dim, c, num_layers, dropout)

            self.cluster_batches = None
            if cluster_parts is not None:
                self.cluster_batches = build_cluster_batches(
                    dataset.adj, cluster_parts, parts_per_batch, engine, cfg.seed,
                    model_kind=model_name, device=dev, published=published)
                self.train_mask = torch.zeros(dataset.num_node, dtype=torch.float32, device=dev)
                self.train_mask[self.idx["train"]] = 1.0
            synchronize(dev)
        self.prepare_seconds = whole.seconds

        if run:
            for r in range(runs):
                self.execute(r, seed=cfg.seed + r)

    # ------------------------------------------------------------------

    def _forward(self, module, inputs, adj, fed=None):
        if self.model_name == "unimp":
            return module(inputs, adj, self.labels, self.idx["train"] if fed is None else fed)
        return module(inputs) if adj is None else module(inputs, adj)

    def label_split(self, state: TrainState):
        """UniMP's split of the train nodes for one step, drawn from the
        state's generator: ``(fed, supervised)``, the nodes whose labels are
        input and those the loss is taken over."""
        tr = self.idx["train"]
        fed = torch.rand(tr.shape, generator=state.generator, device=tr.device) < self.label_rate
        fed_idx, sup = tr[fed], tr[~fed]
        count("labels.fed", int(fed_idx.numel()))
        return fed_idx, sup

    def train_step(self, state: TrainState) -> torch.Tensor:
        """One full-graph update; the loss, detached, on the device. The
        spans of :func:`~ssrg_torch.train.common.train_step`."""
        module = state.module.train()
        with span("step.forward"):
            tr = self.idx["train"]
            fed = None
            if self.model_name == "unimp":
                fed, tr = self.label_split(state)
            out = self._forward(module, self.inputs, self.adj_op, fed)
            if self.model_name == "robust_mlp":
                hidden, logp = out
                loss = -logp[tr].gather(1, self.labels[tr][:, None]).mean()
                if self.triplet_weight:
                    loss = loss + self.triplet_weight * triplet_loss(
                        hidden, self.labels, tr, self.num_classes)
            else:
                loss = cross_entropy_loss(out[tr], self.labels[tr])
        return backward_and_update(state, loss)

    def cluster_step(self, state: TrainState, batch: ClusterBatch) -> torch.Tensor:
        """One update on a cluster batch: the loss over its train nodes."""
        module = state.module.train()
        ids = batch.node_ids
        with span("step.forward"):
            out = self._forward(module, self.inputs[ids], batch.adj_dev)
            loss = cross_entropy_loss(out, self.labels[ids], self.train_mask[ids])
        return backward_and_update(state, loss)

    def train_epoch(self, state: TrainState) -> torch.Tensor:
        """A full-graph update, or one update per cluster batch (their mean
        loss). The span ``epoch.train``."""
        with span("epoch.train"):
            if self.cluster_batches is None:
                return self.train_step(state)
            return torch.stack([self.cluster_step(state, cb)
                                for cb in self.cluster_batches]).mean()

    @torch.no_grad()
    def evaluate(self, state: TrainState):
        """Train, val and test accuracy from one full-graph forward, as
        device scalars. The span ``epoch.evaluate`` around ``eval.forward``."""
        with span("epoch.evaluate"):
            with span("eval.forward"):
                out = self._forward(state.module.eval(), self.inputs, self.adj_op)
            logits = out[1] if self.model_name == "robust_mlp" else out
            return tuple(accuracy(logits[self.idx[k]], self.labels[self.idx[k]])
                         for k in ("train", "val", "test"))

    def execute(self, run_id: int, seed: int) -> None:
        """One run from a fresh initialization drawn with ``seed``."""
        cfg = self.cfg
        generator = seed_everything(seed, self.device)
        # initialized on the host from a CPU generator: one seed, one
        # initialization, whatever the device
        module = self.module.cpu()
        module.reset_parameters(torch.Generator().manual_seed(seed))
        module.to(self.device)
        state = create_train_state(module, generator, cfg.lr, cfg.weight_decay)
        losses, accs = [], []
        for epoch in range(cfg.num_epochs):
            loss = self.train_epoch(state)
            tr, va, te = (float(a) for a in self.evaluate(state))
            self.logger.add_result(run_id, (tr, va, te))
            losses.append(loss)
            accs.append((tr, va, te))
            if self.verbose:
                print(f"run {run_id} epoch {epoch + 1}: loss {float(loss):.4f} "
                      f"train {tr:.4f} val {va:.4f} test {te:.4f}")
        self.history = {"loss": torch.stack(losses).tolist() if losses else [],
                        **{f"{k}_acc": [a[i] for a in accs]
                           for i, k in enumerate(("train", "val", "test"))}}
        self.state = state

    # ------------------------------------------------------------------

    def best_of_run(self, run_id: int):
        return self.logger.best_of_run(run_id)

    @property
    def best_test(self) -> float:
        pairs = [self.logger.best_of_run(r) for r in range(self.runs)]
        return float(np.mean([p[1] for p in pairs]))
