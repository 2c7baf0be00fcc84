"""UniMP as its users would train it through the port:
``train/baseline_task.py::BaselineTask("unimp", ...)`` full-batch
(``TransformerConv(beta=True)`` layers, the label input, attention dropout,
a listing without self-loops), each epoch ``train_epoch`` then
``evaluate`` with the accuracies brought to the host, as
``BaselineTask.execute`` runs them.

The benchmark's weights are drawn by ``programs/common.py::make_weights``:
the layer norms' scales take its ``slope`` kind (0.25 each), the one kind
it has that is not drawn near 0.

Beside the session: the epoch's least work for ``epoch_mfu`` (the model's
work: the forward pass that the checkpointed backward runs again is not
counted), and each attention kernel's least time over all its launches
(``csrc/gat_attention.cu`` in its per-edge modes: entries, heads, widths,
compulsory bytes) with the reader of its roofline share."""

from __future__ import annotations

from typing import Dict

import torch

from portbench import work as W
from portbench.graphs import GraphData
from portbench.programs.common import (change_norms, dropout_generator,
                                       first_gradient_norms, port_dataset)

# the attention kernels and their launches a layer and epoch, the layers run
# under checkpointing: a forward pass (the scores, the stats kernel twice, the
# weighted sum) in training, again in the backward pass, and in evaluation;
# the backward pass's row dot, backward kernel, and weighted sums for dq and dk
KERNELS = {"sddmm_kernel": 3, "gat_stats_kernel": 6, "gat_aggregate_kernel": 5,
           "gat_rowdot_kernel": 1, "gat_backward_kernel": 1}
# forward passes of the attention an epoch: training, its recomputation, evaluation
FORWARDS = ("train", "recompute", "eval")


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
    """The state-dict names and shapes of ``models/baselines.py::BaselineUniMP``."""
    h, ds = heads(cfg), cfg["dataset"]
    out = [("label_emb.weight", (int(ds["num_classes"]), int(ds["num_features"])), "weight")]
    lay = layers(cfg)
    for i, (fan_in, d, width) in enumerate(lay):
        for name in ("query", "key", "value"):
            out += [(f"{name}_{i}.weight", (h * d, fan_in), "weight"),
                    (f"{name}_{i}.bias", (h * d,), "bias")]
        out += [(f"skip_{i}.weight", (width, fan_in), "weight"),
                (f"skip_{i}.bias", (width,), "bias"),
                (f"beta_{i}.weight", (1, 3 * width), "weight")]
        if i < len(lay) - 1:
            out += [(f"norm_{i}.weight", (width,), "slope"),
                    (f"norm_{i}.bias", (width,), "bias")]
    return out


class TrainSession:
    """One ``BaselineTask`` and one train state over the benchmark's
    weights, its label split and attention dropout drawing from the
    benchmark's generator."""

    def __init__(self, data: GraphData, cfg: dict, weights: Dict[str, torch.Tensor],
                 seed: int, device):
        from ssrg_torch.configs.config import TrainingConfig
        from ssrg_torch.train.baseline_task import BaselineTask
        from ssrg_torch.train.common import create_train_state

        if not cfg["beta"] or cfg["self_loops"]:
            raise ValueError("the port's UniMP has the beta gate and a listing without "
                             "self-loops")
        tc = TrainingConfig(lr=float(cfg["lr"]), weight_decay=float(cfg["weight_decay"]))
        self.task = BaselineTask(port_dataset(data), "unimp", tc,
                                 hidden_dim=int(cfg["hidden_channels"]),
                                 num_layers=int(cfg["num_layers"]), run=False, device=device,
                                 heads=heads(cfg), attn_dropout=float(cfg["attn_dropout"]),
                                 label_rate=float(cfg["label_rate"]))
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


def entries(data: GraphData) -> int:
    """The listing's entries: each undirected edge both ways, no self-loop."""
    return 2 * data.num_edges


def sddmm_work(w: W.Work, name: str, e: int, n: int, h: int, c: int) -> W.Work:
    """``sddmm_kernel``: a multiply-add an entry and feature; the entries, q
    and k read, the scores written, once."""
    return w.add(name, 2.0 * e * h * c, W.F32 * (2 * e + 2 * n * h * c + e * h))


def stats_work(w: W.Work, name: str, e: int, n: int, h: int) -> W.Work:
    """The two launches of ``gat_stats_kernel`` on per-edge scores: the rows
    and the scores read by each, the maxima written, then read and the sums
    written; a max, then an exponent and a sum, an entry and head."""
    nh = W.F32 * n * h
    w.add(f"{name}.max", 1.0 * e * h, W.F32 * (e + e * h) + nh)
    return w.add(f"{name}.sum", 3.0 * e * h, W.F32 * (e + e * h) + 2 * nh)


def aggregate_work(w: W.Work, name: str, e: int, n: int, h: int, c: int,
                   masked: bool) -> W.Work:
    """``gat_aggregate_kernel`` on per-edge scores: a multiply-add an entry
    and feature; the entries, the scores, m and l, v (and the mask's byte an
    entry and head) read, out written, once."""
    return w.add(name, 2.0 * e * h * c,
                 W.F32 * (2 * e + e * h + 2 * n * h * c + 2 * n * h) + masked * e * h)


def weighted_sum_work(w: W.Work, name: str, e: int, n: int, h: int, c: int,
                      placed: bool) -> W.Work:
    """``gat_aggregate_kernel`` on given weights (dq, and over the
    transposed listing with its places, dk): the entries (and places), the
    weights and the gathered rows read, the sum written, once."""
    return w.add(name, 2.0 * e * h * c,
                 W.F32 * (2 * e + placed * e + e * h + 2 * n * h * c))


def rowdot_work(w: W.Work, name: str, n: int, h: int, c: int) -> W.Work:
    """``gat_rowdot_kernel``: ``delta = <g, out>``; g, out, m and l read, the
    packed ``[N, H, 4]`` written."""
    return w.add(name, 2.0 * n * h * c, W.F32 * (2 * n * h * c + 6 * n * h))


def backward_work(w: W.Work, name: str, e: int, n: int, h: int, c: int) -> W.Work:
    """``gat_backward_kernel`` on per-edge scores: two multiply-adds an
    entry and feature (dv and the weight's gradient); the transposed entries
    and their places, the scores, the mask's bytes, the packed row values,
    v and g read, dv and the scores' gradient written, once."""
    return w.add(name, 4.0 * e * h * c,
                 W.F32 * (3 * e + 2 * e * h + 4 * n * h + 3 * n * h * c) + e * h)


def attention_forward(w: W.Work, name: str, e: int, n: int, h: int, c: int,
                      masked: bool, kernel: str = None) -> W.Work:
    """One forward pass of the attention, or of ``kernel``'s part of it."""
    if kernel in (None, "sddmm_kernel"):
        sddmm_work(w, f"{name}.sddmm", e, n, h, c)
    if kernel in (None, "gat_stats_kernel"):
        stats_work(w, f"{name}.stats", e, n, h)
    if kernel in (None, "gat_aggregate_kernel"):
        aggregate_work(w, f"{name}.aggregate", e, n, h, c, masked)
    return w


def attention_backward(w: W.Work, name: str, e: int, n: int, h: int, c: int,
                       kernel: str = None) -> W.Work:
    """One backward pass of the attention, or of ``kernel``'s part of it."""
    if kernel in (None, "gat_rowdot_kernel"):
        rowdot_work(w, f"{name}.rowdot", n, h, c)
    if kernel in (None, "gat_backward_kernel"):
        backward_work(w, f"{name}.backward", e, n, h, c)
    if kernel in (None, "gat_aggregate_kernel"):
        weighted_sum_work(w, f"{name}.dq", e, n, h, c, False)
        weighted_sum_work(w, f"{name}.dk", e, n, h, c, True)
    return w


def kernel_least_s(kernel: str, cfg: dict, data: GraphData) -> float:
    """The least time of one epoch's launches of ``kernel``, the
    recomputed forward passes included."""
    e, n, h = entries(data), data.num_nodes, heads(cfg)
    masked = float(cfg["attn_dropout"]) > 0
    w = W.Work()
    for _fan_in, d, _width in layers(cfg):
        for what in FORWARDS:
            attention_forward(w, what, e, n, h, d, masked and what != "eval", kernel)
        attention_backward(w, "bwd", e, n, h, d, kernel)
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
    fused elementwise pass of the training step (its forward pass once) and
    of the evaluation forward, and the Adam update."""
    n, e, h = data.num_nodes, entries(data), heads(cfg)
    n_tr = int(data.train_idx.numel())
    f = int(cfg["dataset"]["num_features"])
    masked = float(cfg["attn_dropout"]) > 0
    lay = layers(cfg)
    c_out = lay[-1][2]
    w = W.Work()

    def forward(tag: str, train: bool) -> None:
        # the fed labels' embeddings added to their rows
        W.elementwise(w, f"labels.{tag}", n * f, 2)
        for i, (fi, d, width) in enumerate(lay):
            last = i == len(lay) - 1
            for name in ("q", "k", "v"):
                W.gemm(w, f"{name}{i}.{tag}", n, fi, h * d)
            attention_forward(w, f"attn{i}.{tag}", e, n, h, d, masked and train)
            W.gemm(w, f"skip{i}.{tag}", n, fi, width)
            # the gate's two products, then beta r + (1 - beta) m
            W.gemm(w, f"gate{i}.{tag}", n, 2 * width, 1)
            W.elementwise(w, f"mix{i}.{tag}", n * width, 3)
            if not last:
                W.elementwise(w, f"norm_relu{i}.{tag}", n * width, 2)

    forward("fwd", True)
    W.elementwise(w, "loss", n_tr * c_out, 2)
    W.elementwise(w, "loss.bwd", n * c_out, 1)
    for i in reversed(range(len(lay))):
        fi, d, width = lay[i]
        if i < len(lay) - 1:
            W.elementwise(w, f"norm_relu{i}.bwd", n * width, 4)
        W.elementwise(w, f"mix{i}.bwd", n * width, 5)
        W.gemm(w, f"gate{i}.bwd", n, 1, 2 * width)
        W.gemm(w, f"skip{i}.dW", fi, n, width)
        attention_backward(w, f"attn{i}.bwd", e, n, h, d)
        for name in ("q", "k", "v"):
            W.gemm(w, f"{name}{i}.dW", fi, n, h * d)
            if i > 0:
                W.gemm(w, f"{name}{i}.dX", n, h * d, fi)
        if i > 0:
            W.gemm(w, f"skip{i}.dX", n, width, fi)
    W.adam(w, sum(int(torch.tensor(s).prod()) for _, s, _ in weight_shapes(cfg)))
    forward("eval", False)
    W.elementwise(w, "accuracy", (n_tr + int(data.val_idx.numel())
                                  + int(data.test_idx.numel())) * c_out, 1)
    return w
