"""What the configurations share when they hand the benchmark's data to
the port: the port's dataset object, the weights drawn from the seed, and
the readings of a train state that the comparison needs."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench.graphs import GraphData, generator


def port_dataset(data: GraphData):
    """The port's ``InMemoryDataset`` over the benchmark's graph: each
    undirected edge once, unit weights (the port symmetrizes), features,
    labels and the split as host arrays."""
    import numpy as np

    from ssrg_torch.data.graph import Graph
    from ssrg_torch.data.synthetic import InMemoryDataset

    graph = Graph(data.lo.cpu().numpy(), data.hi.cpu().numpy(),
                  np.ones(data.num_edges, np.float32), data.num_nodes, "UUU",
                  x=data.x.cpu().numpy(), y=data.y.cpu().numpy())
    return InMemoryDataset(graph, data.train_idx.cpu().numpy(), data.val_idx.cpu().numpy(),
                           data.test_idx.cpu().numpy(), name="portbench")


def make_weights(shapes: List[Tuple[str, tuple, str]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """Float32 weights drawn from ``seed`` on ``device`` in one call: a
    ``weight`` of ``[fan_out, fan_in]`` uniform with variance ``1 /
    fan_in``, a ``bias`` uniform in ``[-0.05, 0.05]``, a ``slope`` 0.25
    (PReLU's start)."""
    sizes = [math.prod(s) for _, s, _ in shapes]
    flat = torch.rand(sum(sizes), generator=generator(seed, "weights", device),
                      device=device) * 2 - 1
    out, at = {}, 0
    for (name, shape, kind), size in zip(shapes, sizes):
        u = flat[at:at + size].view(shape)
        at += size
        if kind == "weight":
            out[name] = u * math.sqrt(3.0 / shape[-1])
        elif kind == "bias":
            out[name] = u * 0.05
        elif kind == "slope":
            out[name] = torch.full(shape, 0.25, device=device)
        else:
            raise ValueError(f"unknown kind of weight {kind!r}")
    return out


def dropout_generator(seed: int, device) -> torch.Generator:
    """The generator the program's dropout draws from (the benchmark's
    input, as the weights are); the reference draws from another made
    alike."""
    return generator(seed, "dropout", device)


@torch.no_grad()
def first_gradient_norms(state) -> Dict[str, float]:
    """Each leaf's gradient as the optimizer took it in the first update,
    worked out from Adam's first moment after one step: ``m = (1 - b1) g``."""
    opt = state.optimizer
    beta1 = opt.param_groups[0]["betas"][0]
    names = {id(p): n for n, p in state.module.named_parameters()}
    out = {}
    for group in opt.param_groups:
        for p in group["params"]:
            state_p = opt.state.get(p, {})
            # a leaf the update never reached has no moment: it took nothing
            out[names[id(p)]] = (float((state_p["exp_avg"] / (1 - beta1)).norm())
                                 if "exp_avg" in state_p else 0.0)
    return out


@torch.no_grad()
def change_norms(module, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's distance from where it started."""
    return {n: float((p - start[n]).norm()) for n, p in module.named_parameters()}
