"""The published GAT as its users would train it through the port:
``train/baseline_task.py::BaselineTask("gat", ...)`` full-batch in its
published form (heads, skip linears, bias after the aggregation, self-loops,
attention dropout 0), each epoch ``train_epoch`` then ``evaluate`` with the
accuracies brought to the host, as ``BaselineTask.execute`` runs them.

Beside the session: the epoch's least work for ``epoch_mfu``, and each
attention kernel's least time (``csrc/gat_attention.cu``: its entries, heads
and widths, its compulsory bytes) with the reader of its roofline share."""

from __future__ import annotations

from typing import Dict

import torch

from portbench import work as W
from portbench.graphs import GraphData
from portbench.programs.common import (change_norms, dropout_generator,
                                       first_gradient_norms, port_dataset)

# the attention kernels and their launches an epoch (layers x passes): the
# stats kernel twice a forward pass (maxima, then sums), the weighted sum
# once, the row dot and the backward pass once a backward pass; two forward
# passes an epoch (training, evaluation), one backward
KERNELS = {"gat_stats_kernel": 4, "gat_aggregate_kernel": 2, "gat_rowdot_kernel": 1,
           "gat_backward_kernel": 1}


def heads(cfg: dict) -> int:
    return int(cfg["heads"])


def layers(cfg: dict) -> list:
    """``(fan_in, head width, output width)`` of each layer: heads
    concatenated between layers, averaged at the last."""
    ds, h, hd = cfg["dataset"], heads(cfg), int(cfg["hidden_channels"])
    n_layers = int(cfg["num_layers"])
    widths = [hd] * (n_layers - 1) + [int(ds["num_classes"])]
    out, fan_in = [], int(ds["num_features"])
    for i, d in enumerate(widths):
        last = i == n_layers - 1
        out.append((fan_in, d, d if last else h * d))
        fan_in = h * d
    return out


def weight_shapes(cfg: dict) -> list:
    """The state-dict names and shapes of ``models/baselines.py::BaselineGAT``
    in its published form."""
    h = heads(cfg)
    out = []
    for i, (fan_in, d, width) in enumerate(layers(cfg)):
        out += [(f"w_{i}.weight", (h * d, fan_in), "weight"),
                (f"a_src_{i}", (1, h, d), "weight"),
                (f"a_dst_{i}", (1, h, d), "weight"),
                (f"bias_{i}", (width,), "bias"),
                (f"skip_{i}.weight", (width, fan_in), "weight"),
                (f"skip_{i}.bias", (width,), "bias")]
    return out


class TrainSession:
    """One ``BaselineTask`` and one train state over the benchmark's
    weights, its dropout drawing from the benchmark's generator."""

    def __init__(self, data: GraphData, cfg: dict, weights: Dict[str, torch.Tensor],
                 seed: int, device):
        from ssrg_torch.configs.config import TrainingConfig
        from ssrg_torch.train.baseline_task import BaselineTask
        from ssrg_torch.train.common import create_train_state

        if not (cfg["skip"] and cfg["bias"] and cfg["self_loops"]):
            raise ValueError("the port's published GAT form has skip linears, a bias and "
                             "self-loops together")
        tc = TrainingConfig(lr=float(cfg["lr"]), weight_decay=float(cfg["weight_decay"]))
        self.task = BaselineTask(port_dataset(data), "gat", tc,
                                 hidden_dim=int(cfg["hidden_channels"]),
                                 num_layers=int(cfg["num_layers"]),
                                 dropout=float(cfg["dropout"]), run=False, device=device,
                                 heads=heads(cfg), published=True,
                                 attn_dropout=float(cfg["attn_dropout"]))
        if self.task.module.negative_slope != float(cfg["negative_slope"]):
            raise ValueError("the port's GAT takes LeakyReLU's slope 0.2")
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
        """No pack: the attention's readers count from the graph."""
        return {}

    def close(self) -> None:
        self.task = self.state = None


# -- each attention kernel's least work, by launch ----------------------------


def stats_work(w: W.Work, name: str, e: int, n: int, h: int) -> W.Work:
    """The two launches of ``gat_stats_kernel``: the entries and both scores
    read by each, the maxima written, then read and the sums written; a few
    operations an entry and head (sum, LeakyReLU, max or exponent and sum)."""
    nh = W.F32 * n * h
    w.add(f"{name}.max", 3.0 * e * h, 2 * W.F32 * e + 3 * nh)
    return w.add(f"{name}.sum", 4.0 * e * h, 2 * W.F32 * e + 4 * nh)


def aggregate_work(w: W.Work, name: str, e: int, n: int, h: int, c: int) -> W.Work:
    """``gat_aggregate_kernel``: a multiply-add an entry and feature; the
    entries, z and the four ``[N, H]`` statistics read, out written, once."""
    return w.add(name, 2.0 * e * h * c, W.F32 * (2 * e + 2 * n * h * c + 4 * n * h))


def rowdot_work(w: W.Work, name: str, n: int, h: int, c: int) -> W.Work:
    """``gat_rowdot_kernel``: ``delta = <g, out>``; g, out and three ``[N, H]``
    values read, the packed ``[N, H, 4]`` written."""
    return w.add(name, 2.0 * n * h * c, W.F32 * (2 * n * h * c + 7 * n * h))


def backward_work(w: W.Work, name: str, e: int, n: int, h: int, c: int) -> W.Work:
    """``gat_backward_kernel``: two multiply-adds an entry and feature (dz
    and dalpha); the entries, z, g, the packed row values and s_src read, dz
    and both score gradients written, once."""
    return w.add(name, 4.0 * e * h * c, W.F32 * (2 * e + 3 * n * h * c + 7 * n * h))


def attention_forward(w: W.Work, name: str, e: int, n: int, h: int, c: int) -> W.Work:
    stats_work(w, f"{name}.stats", e, n, h)
    return aggregate_work(w, f"{name}.aggregate", e, n, h, c)


def attention_backward(w: W.Work, name: str, e: int, n: int, h: int, c: int) -> W.Work:
    rowdot_work(w, f"{name}.rowdot", n, h, c)
    return backward_work(w, f"{name}.backward", e, n, h, c)


def kernel_least_s(kernel: str, cfg: dict, data: GraphData) -> float:
    """The least time of one epoch's launches of ``kernel``."""
    e, n, h = data.nnz, data.num_nodes, heads(cfg)  # entries of A with one self-loop a node
    w = W.Work()
    for _fan_in, d, _width in layers(cfg):
        for _ in range(2):  # the training and the evaluation forward
            if kernel == "gat_stats_kernel":
                stats_work(w, "stats", e, n, h)
            elif kernel == "gat_aggregate_kernel":
                aggregate_work(w, "aggregate", e, n, h, d)
        if kernel == "gat_rowdot_kernel":
            rowdot_work(w, "rowdot", n, h, d)
        elif kernel == "gat_backward_kernel":
            backward_work(w, "backward", e, n, h, d)
    return w.least_s


def roofline(kernel: str, view, info) -> float:
    """``kernel``'s share of its roofline in the profiled epochs: its least
    time over its summed device time; None unless the profile holds exactly
    the epochs' expected launches of it."""
    cfg, data = info.get("config"), info.get("data")
    if kernel not in KERNELS or cfg is None or data is None or not view.calls:
        return None
    launches = view.kernels_named(kernel)
    busy = sum(k.dur for k in launches) / 1e6
    expected = view.calls * KERNELS[kernel] * len(layers(cfg))
    if len(launches) != expected or busy <= 0:
        return None
    return 100.0 * view.calls * kernel_least_s(kernel, cfg, data) / busy


def epoch_work(cfg: dict, data: GraphData) -> W.Work:
    """The least work of one epoch: every product, attention kernel and
    fused elementwise pass of the training step and of the evaluation
    forward, and the Adam update."""
    n, e, h = data.num_nodes, data.nnz, heads(cfg)
    n_tr = int(data.train_idx.numel())
    lay = layers(cfg)
    c_out = lay[-1][2]
    w = W.Work()

    def forward(tag: str, train: bool) -> None:
        for i, (fi, d, width) in enumerate(lay):
            last = i == len(lay) - 1
            W.gemm(w, f"lin{i}.{tag}", n, fi, h * d)
            # both scores in one read of z
            w.add(f"score{i}.{tag}", 4.0 * n * h * d, W.F32 * (n * h * d + 2 * n * h))
            attention_forward(w, f"attn{i}.{tag}", e, n, h, d)
            W.gemm(w, f"skip{i}.{tag}", n, fi, width)
            # bias and skip added (the mean first at the last layer)
            W.elementwise(w, f"add{i}.{tag}", n * width, 3)
            if not last:
                W.elementwise(w, f"elu_dropout{i}.{tag}" if train else f"elu{i}.{tag}",
                              n * width, 2)

    forward("fwd", True)
    W.elementwise(w, "loss", n_tr * c_out, 2)
    W.elementwise(w, "loss.bwd", n * c_out, 1)
    for i in reversed(range(len(lay))):
        fi, d, width = lay[i]
        if i < len(lay) - 1:
            W.elementwise(w, f"elu_dropout{i}.bwd", n * width, 3)
        W.gemm(w, f"skip{i}.dW", fi, n, width)
        attention_backward(w, f"attn{i}.bwd", e, n, h, d)
        # the scores' gradient into dz and into a_src, a_dst
        w.add(f"score{i}.bwd", 8.0 * n * h * d, W.F32 * (2 * n * h * d + 2 * n * h))
        W.gemm(w, f"lin{i}.dW", fi, n, h * d)
        if i > 0:
            W.gemm(w, f"lin{i}.dX", n, h * d, fi)
            W.gemm(w, f"skip{i}.dX", n, width, fi)
    W.adam(w, sum(h * d * fi + 2 * h * d + width + width * fi + width
                  for fi, d, width in lay))
    forward("eval", False)
    W.elementwise(w, "accuracy", (n_tr + int(data.val_idx.numel())
                                  + int(data.test_idx.numel())) * c_out, 1)
    return w
