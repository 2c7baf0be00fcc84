"""GAMLP written out (the port's ``ops/combine.py::LearnableWeightedMessageOp``
in its ``jk`` form under a ``models/heads.py::MultiLayerPerceptron``):

- hops ``H_0 = X``, ``H_k = A H_{k-1}``, ``A = D^-r' (A + I) D^-r`` at
  ``r = 0.5``;
- for each hop ``k`` a score ``s_k = jk([H_0 | ... | H_K | H_k])``, hop
  weights ``softmax_k(sigmoid(s_k))`` and their weighted sum of the hops;
- the head: ``(num_layers - 1)`` times ``Linear -> PReLU -> Dropout``,
  then ``Linear``; the mean cross entropy of the train rows; Adam.
"""

from __future__ import annotations

import torch

from portbench.graphs import GraphData, generator
from portbench.reference.common import (Adam, Precision, cross_entropy, dropout, faulty,
                                        leaf_params, sym_norm)


@torch.no_grad()
def hops(data: GraphData, cfg: dict, precision: str = "float32") -> torch.Tensor:
    """The hop stack ``[K + 1, N, F]``."""
    if float(cfg["r"]) != 0.5:
        raise ValueError("the reference normalizes at r = 0.5 only")
    prec = Precision(precision)
    a = sym_norm(data.num_nodes, data.lo, data.hi)
    out = torch.empty((int(cfg["prop_steps"]) + 1, *data.x.shape), device=data.x.device)
    out[0] = data.x
    for k in range(int(cfg["prop_steps"])):
        out[k + 1] = torch.sparse.mm(prec.sparse(a), prec.round(out[k]))
    return out


def forward(params: dict, stack: torch.Tensor, cfg: dict, prec: Precision,
            gen=None) -> torch.Tensor:
    """Logits of the rows of ``stack`` (``[K + 1, B, F]``); dropout drawn
    from ``gen`` when it is given (training)."""
    k1, b, f = stack.shape
    every = stack.permute(1, 0, 2).reshape(b, k1 * f)
    scored = torch.cat([every.unsqueeze(0).expand(k1, b, k1 * f), stack], dim=-1)
    score = prec.linear(scored.reshape(k1 * b, -1), params["msg_op.jk.weight"],
                        params["msg_op.jk.bias"]).view(k1, b)
    wts = torch.softmax(torch.sigmoid(score).T, dim=1)
    x = torch.einsum("nk,knf->nf", prec.rounded(wts), prec.rounded(stack))
    for i in range(int(cfg["num_layers"]) - 1):
        x = prec.linear(x, params[f"head.fc_{i}.weight"], params[f"head.fc_{i}.bias"])
        x = torch.where(x >= 0, x, params[f"head.prelu_{i}.slope"] * x)
        if gen is not None:
            x = dropout(x, float(cfg["dropout"]), gen)
    return prec.linear(x, params["head.fc_out.weight"], params["head.fc_out.bias"])


@torch.no_grad()
def logits(stack: torch.Tensor, weights: dict, cfg: dict, precision: str = "float32",
           block: int = 65536) -> torch.Tensor:
    """Evaluation logits of every node, ``block`` rows at a time."""
    prec = Precision(precision)
    n = stack.shape[1]
    return torch.cat([forward(weights, stack[:, i:i + block], cfg, prec)
                      for i in range(0, n, block)])


def train_steps(data: GraphData, cfg: dict, weights: dict, seed: int, steps: int,
                precision: str = "float32", fault: str = None) -> dict:
    """``steps`` full-batch updates on the train rows from ``weights``: each
    step's loss, the first update's gradients' norms by leaf, each leaf's
    distance from its start after the last. ``fault`` plants a fault the
    comparison has to catch (see :func:`portbench.reference.common.faulty`)."""
    prec = Precision(precision)
    stack = hops(data, cfg, precision)[:, data.train_idx]
    labels = data.y[data.train_idx]
    rows = faulty(fault, torch.arange(labels.numel(), device=labels.device))
    params = leaf_params(weights)
    opt = Adam(params, float(cfg["lr"]), float(cfg["weight_decay"]))
    gen = generator(seed, "dropout", data.x.device)
    losses, grads = [], None
    for step in range(steps):
        logits = forward(params, stack, cfg, prec, gen)
        loss = cross_entropy(logits[rows], labels[rows])
        loss.backward()
        seen = opt.step(frozen=fault == "unchanged")
        losses.append(float(loss.detach()))
        if step == 0:
            grads = {k: float(g.norm()) for k, g in seen.items()}
    change = {k: float((p.detach() - weights[k]).norm()) for k, p in params.items()}
    return {"losses": losses, "grads": grads, "change": change}
