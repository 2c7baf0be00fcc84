"""The baseline GCN written out: ``x <- dropout(relu(A (x W_i^T + b_i)))``
for each hidden layer, logits ``A (x W_out^T + b_out)``, the mean cross
entropy of the train rows, Adam. ``A`` is ``D^-1/2 (A + I) D^-1/2``, its
gradient taken on its transpose, as the port's ``models/baselines.py::
BaselineGCN`` over ``ops/sparse.py::differentiable_adjacency`` does."""

from __future__ import annotations

import torch

from portbench.graphs import GraphData, generator
from portbench.reference.common import (Adam, Precision, cross_entropy, dropout, faulty,
                                        leaf_params, sym_norm, transpose)


def layer_names(num_layers: int) -> list:
    return [f"conv_{i}" for i in range(num_layers - 1)] + ["conv_out"]


def train_steps(data: GraphData, cfg: dict, weights: dict, seed: int, steps: int,
                precision: str = "float32", fault: str = None) -> dict:
    """``steps`` full-batch updates from ``weights``: each step's loss, the
    first update's gradients' norms by leaf, and each leaf's distance from
    its start after the last. ``fault`` plants a fault the comparison has to
    catch (see :func:`portbench.reference.common.faulty`)."""
    prec = Precision(precision)
    a = sym_norm(data.num_nodes, data.lo, data.hi)
    at = transpose(a)
    params = leaf_params(weights)
    opt = Adam(params, float(cfg["lr"]), float(cfg["weight_decay"]))
    gen = generator(seed, "dropout", data.x.device)
    names = layer_names(int(cfg["num_layers"]))
    rate = float(cfg["dropout"])
    tr = faulty(fault, data.train_idx)
    losses, grads = [], None
    for step in range(steps):
        x = data.x
        for i, name in enumerate(names):
            x = prec.spmm(a, at, prec.linear(x, params[f"{name}.weight"], params[f"{name}.bias"]))
            if i < len(names) - 1:
                x = dropout(torch.relu(x), rate, gen)
        loss = cross_entropy(x[tr], data.y[tr])
        loss.backward()
        del x
        seen = opt.step(frozen=fault == "unchanged")
        losses.append(float(loss.detach()))
        if step == 0:
            grads = {k: float(g.norm()) for k, g in seen.items()}
    change = {k: float((p.detach() - weights[k]).norm()) for k, p in params.items()}
    return {"losses": losses, "grads": grads, "change": change}
