"""The baseline GCN as its users train it: the port's
``train/baseline_task.py::BaselineTask`` full-batch, each epoch
``train_epoch`` then ``evaluate`` with the accuracies brought to the host,
as ``BaselineTask.execute`` runs them."""

from __future__ import annotations

from typing import Dict

import torch

from portbench import work as W
from portbench.graphs import GraphData
from portbench.programs.common import (change_norms, dropout_generator,
                                       first_gradient_norms, port_dataset)


def dims(cfg: dict) -> list:
    ds = cfg["dataset"]
    h = int(cfg["hidden_channels"])
    return [int(ds["num_features"])] + [h] * (int(cfg["num_layers"]) - 1) + \
        [int(ds["num_classes"])]


def weight_shapes(cfg: dict) -> list:
    """The state-dict names and shapes of ``models/baselines.py::BaselineGCN``."""
    d = dims(cfg)
    names = [f"conv_{i}" for i in range(len(d) - 2)] + ["conv_out"]
    out = []
    for name, fan_in, fan_out in zip(names, d[:-1], d[1:]):
        out += [(f"{name}.weight", (fan_out, fan_in), "weight"),
                (f"{name}.bias", (fan_out,), "bias")]
    return out


class TrainSession:
    """One ``BaselineTask`` and one train state over the benchmark's
    weights, its dropout drawing from the benchmark's generator."""

    def __init__(self, data: GraphData, cfg: dict, weights: Dict[str, torch.Tensor],
                 seed: int, device):
        from ssrg_torch.configs.config import TrainingConfig
        from ssrg_torch.train.baseline_task import BaselineTask
        from ssrg_torch.train.common import create_train_state

        tc = TrainingConfig(lr=float(cfg["lr"]), weight_decay=float(cfg["weight_decay"]),
                            spmm_engine=cfg["spmm_engine"])
        self.task = BaselineTask(port_dataset(data), "gcn", tc,
                                 hidden_dim=int(cfg["hidden_channels"]),
                                 num_layers=int(cfg["num_layers"]),
                                 dropout=float(cfg["dropout"]), run=False, device=device)
        module = self.task.module.to(device)
        module.load_state_dict(weights, strict=True)
        self.state = create_train_state(module, dropout_generator(seed, device), tc.lr,
                                        tc.weight_decay)

    def step(self) -> torch.Tensor:
        loss = self.task.train_epoch(self.state)
        self.accuracies = [float(a) for a in self.task.evaluate(self.state)]
        return loss

    def first_gradient_norms(self) -> Dict[str, float]:
        return first_gradient_norms(self.state)

    def change_norms(self, start) -> Dict[str, float]:
        return change_norms(self.state.module, start)

    def pack(self) -> dict:
        """The shapes the program's kernels run at: the hybrid pack's ELL
        width and the COO tail's chunks (nothing on another engine)."""
        from ssrg_torch.ops.sparse import DifferentiableAdj, HybridAdj

        adj = self.task.adj_op
        fwd = adj.fwd if isinstance(adj, DifferentiableAdj) else adj
        if not isinstance(fwd, HybridAdj):
            return {}
        return {"ell_width": fwd.ell.width,
                "tail_chunks": -(-fwd.tail.nnz_padded // fwd.tail.chunk)}

    def close(self) -> None:
        self.task = self.state = None


def spmm_features(cfg: dict) -> list:
    """The feature widths of an epoch's SpMMs, in order: the training
    forward, its backward (by ``A^T``), the evaluation forward."""
    d = dims(cfg)[1:]
    return d + d[::-1] + d


def epoch_work(cfg: dict, data: GraphData) -> W.Work:
    """The least work of one epoch: every product, SpMM (on ``A + I``, from
    the graph) and fused elementwise pass of the training step and of the
    evaluation forward, and the Adam update."""
    n, nnz = data.num_nodes, data.nnz
    n_tr = int(data.train_idx.numel())
    d = dims(cfg)
    w = W.Work()
    # training forward
    for i, (fi, fo) in enumerate(zip(d[:-1], d[1:])):
        W.gemm(w, f"lin{i}.fwd", n, fi, fo)
        W.spmm(w, f"spmm{i}.fwd", nnz, n, n, fo)
        if i < len(d) - 2:
            W.elementwise(w, f"relu_dropout{i}.fwd", n * fo, 2)
    W.elementwise(w, "loss", n_tr * d[-1], 2)
    # backward: the loss's gradient into [N, C], then the layers in reverse
    W.elementwise(w, "loss.bwd", n * d[-1], 1)
    for i in reversed(range(len(d) - 1)):
        fi, fo = d[i], d[i + 1]
        W.spmm(w, f"spmm{i}.bwd", nnz, n, n, fo)
        W.gemm(w, f"lin{i}.dW", fi, n, fo)
        if i > 0:
            W.gemm(w, f"lin{i}.dX", n, fo, fi)
            W.elementwise(w, f"relu_dropout{i - 1}.bwd", n * fi, 2)
    W.adam(w, sum((fi + 1) * fo for fi, fo in zip(d[:-1], d[1:])))
    # evaluation forward and the three accuracies
    for i, (fi, fo) in enumerate(zip(d[:-1], d[1:])):
        W.gemm(w, f"lin{i}.eval", n, fi, fo)
        W.spmm(w, f"spmm{i}.eval", nnz, n, n, fo)
        if i < len(d) - 2:
            W.elementwise(w, f"relu{i}.eval", n * fo, 2)
    W.elementwise(w, "accuracy", (n_tr + int(data.val_idx.numel())
                                  + int(data.test_idx.numel())) * d[-1], 1)
    return w


def ell_edges(data: GraphData, width: int) -> int:
    """The nonzeros of ``A + I`` that an ELL term of ``width`` slots a row
    carries: ``min(degree + 1, width)`` in each row."""
    deg = data.degrees() + 1
    return int(torch.clamp(deg, max=width).sum())


def ell_least_s(cfg: dict, data: GraphData, width: int) -> float:
    """The least time of an epoch's ELL launches: each carries the ELL
    term's edges (values and column ids), reads x once and writes the
    output once."""
    edges, n = ell_edges(data, width), data.num_nodes
    w = W.Work()
    for f in spmm_features(cfg):
        w.add("ell", 2.0 * edges * f, W.F32 * (2 * edges + 2 * n * f))
    return w.least_s
