"""UniMP (Shi et al., *Masked Label Prediction*, IJCAI 2021) as PyG's
``examples/unimp_arxiv.py`` stacks ``TransformerConv(beta=True)`` with
``MaskLabel``, written out in plain torch, float32 (TF32 off;
``Precision``'s control rounds the operands of every product to TF32). For
layer ``i`` with ``H`` heads of ``d`` features, over the entries ``(row,
col)`` (message ``col -> row``) of ``A``, no self-loops::

    q, k, v  = x Wq_i^T + bq_i, x Wk_i^T + bk_i, x Wv_i^T + bv_i    [N, H, d]
    s[e]     = <q[row_e], k[col_e]> / sqrt(d)                       [E, H]
    alpha[e] = exp(s[e] - max_row s) / sum_row exp(s - max_row s)
    alpha~   = alpha * mask / (1 - attn_dropout)   (mask [H, E], drawn each layer)
    m[i]     = sum over i's entries of alpha~[e] * v[col_e]
               (heads concatenated; their mean at the last layer)
    r        = x Ws_i^T + bs_i
    beta     = sigmoid(w_beta_i . [m, r, m - r])                     (no bias)
    h        = beta r + (1 - beta) m
    x        = relu(layer_norm_i(h)) between layers; h the logits last

with ``x_0 = x + emb(y)`` on the nodes whose labels are fed. Each step
draws from the dropout stream, in this order: which train nodes feed their
labels (``rand < label_rate``, one draw over the train rows in their
order, PyG's ``MaskLabel.ratio_mask``), then each layer's mask
(``rand([H, E]) < 1 - attn_dropout``, the entries in the row listing's
order: by row, then column). The loss is the mean cross entropy of the
train rows that were not fed; Adam (lr 0.001, no weight decay). Parameter
names are the port's (``label_emb``, ``query_{i}``, ``key_{i}``,
``value_{i}``, ``skip_{i}``, ``beta_{i}``, ``norm_{i}``); the weights are
the benchmark's.

Departures from PyG, each the configuration's (``assumed``) or forced by
size:

- full batch: every node is a target, in place of ``NeighborSampler``
  blocks;
- no self-loops: the example adds them to its dataset
  (``T.AddSelfLoops()``); here the node's own row enters through the
  gated skip alone, as ``TransformerConv`` itself adds none;
- the widths are per head (128 each, the paper's code's reading); the
  example splits its ``hidden_channels`` over the heads;
- the label split is the train rows' Bernoulli draw each step, as
  ``ratio_mask`` draws it; the example's 0.65 is the configuration's
  ``label_rate``;
- the softmax's shift is the row maximum taken without a gradient (PyG's
  ``softmax`` detaches it too);
- at the cell's size nothing of ``[E, H, d]`` is formed whole: the scores
  and the weighted sum run in blocks of ``gat.BLOCK`` entries under
  autograd functions whose backward passes run in the same blocks, and
  each layer runs under ``torch.utils.checkpoint``, its mask drawn before
  it, so that only the layers' inputs stay for the backward pass. The
  products are written out so that in the TF32 control their operands
  are rounded ``gat.ROWS`` rows at a time.

Nothing here imports the port or JAX; the entries are rebuilt from the
benchmark's edge list.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.graphs import GraphData, generator
from portbench.reference import gat
from portbench.reference.common import (Adam, Precision, cross_entropy, faulty,
                                        leaf_params)


def entries(data: GraphData):
    """``(row, col)`` int64 of ``A``: each undirected edge both ways, sorted
    by row, then column."""
    n = data.num_nodes
    key = torch.sort(torch.cat([data.lo * n + data.hi, data.hi * n + data.lo])).values
    return key // n, key % n


class _Scores(torch.autograd.Function):
    """``s[e, h] = <q[row_e, h], k[col_e, h]>`` (``[E, H]``), ``gat.BLOCK``
    entries at a time; in the TF32 control both operands rounded."""

    @staticmethod
    def forward(ctx, q, k, row, col, prec):
        ctx.save_for_backward(q, k)
        ctx.row, ctx.col, ctx.prec = row, col, prec
        s = q.new_empty((row.numel(), q.shape[1]))
        for a in range(0, row.numel(), gat.BLOCK):
            r, c = row[a:a + gat.BLOCK], col[a:a + gat.BLOCK]
            s[a:a + gat.BLOCK] = (prec.round(q[r]) * prec.round(k[c])).sum(-1)
        return s

    @staticmethod
    def backward(ctx, ds):
        q, k = ctx.saved_tensors
        row, col, prec = ctx.row, ctx.col, ctx.prec
        ds = ds.contiguous()
        dq, dk = torch.zeros_like(q), torch.zeros_like(k)
        for a in range(0, row.numel(), gat.BLOCK):
            r, c = row[a:a + gat.BLOCK], col[a:a + gat.BLOCK]
            g = prec.round(ds[a:a + gat.BLOCK])[..., None]
            dq.index_add_(0, r, g * prec.round(k[c]))
            dk.index_add_(0, c, g * prec.round(q[r]))
        return dq, dk, None, None, None


def scores(q, k, row, col, prec: Precision) -> torch.Tensor:
    return _Scores.apply(q, k, row, col, prec)


def softmax_weights(s: torch.Tensor, row: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """``alpha [E, H]``: the scores' softmax over each row's entries."""
    with torch.no_grad():
        top = torch.full((num_nodes, s.shape[1]), float("-inf"), device=s.device)
        top.scatter_reduce_(0, row[:, None].expand_as(s), s, "amax", include_self=True)
    ex = torch.exp(s - top[row])
    total = torch.zeros((num_nodes, s.shape[1]), device=s.device).index_add(0, row, ex)
    return ex / total[row]


def attention(q, k, v, row, col, mask, keep: float, prec: Precision) -> torch.Tensor:
    """One layer's attention ``[N, H, d]``: scores, softmax, the mask's
    dropped weights, the weighted sum of v."""
    n, _h, d = q.shape
    s = scores(q, k, row, col, prec) / math.sqrt(d)
    alpha = softmax_weights(s, row, n)
    del s
    if mask is not None:
        alpha = alpha * mask.T * keep
    return gat.weighted_sum(v, alpha, row, col, prec)


def layer_widths(cfg: dict) -> list:
    """One head's width at each layer: the hidden width, the classes last."""
    h = int(cfg["hidden_channels"])
    return [h] * (int(cfg["num_layers"]) - 1) + [int(cfg["dataset"]["num_classes"])]


def layer(x, i: int, last: bool, params: dict, prec: Precision, row, col, mask, keep: float,
          heads: int, d: int):
    """Layer ``i`` of the stack: its output, the next layer's input or the
    logits."""
    n = x.shape[0]
    q, k, v = (gat.linear(x, params[f"{name}_{i}.weight"], params[f"{name}_{i}.bias"], prec)
               .view(n, heads, d) for name in ("query", "key", "value"))
    out = attention(q, k, v, row, col, mask, keep, prec)
    del q, k, v
    m = out.mean(dim=1) if last else out.reshape(n, heads * d)
    del out
    r = gat.linear(x, params[f"skip_{i}.weight"], params[f"skip_{i}.bias"], prec)
    w = params[f"beta_{i}.weight"].view(3, 1, -1)
    logit = sum(gat._Linear.apply(t, w[j], prec) for j, t in enumerate((m, r, m - r)))
    beta = torch.sigmoid(logit)
    h = beta * r + (1.0 - beta) * m
    if last:
        return h
    return torch.relu(F.layer_norm(h, (h.shape[1],), params[f"norm_{i}.weight"],
                                   params[f"norm_{i}.bias"]))


def forward(data: GraphData, cfg: dict, params: dict, prec: Precision, gen, row, col,
            fed: torch.Tensor, train: bool = True):
    """The logits ``[N, C]`` of one forward pass with the labels of ``fed``
    as input; in training each layer's mask drawn from ``gen`` before it."""
    heads, rate = int(cfg["heads"]), float(cfg["attn_dropout"])
    widths = layer_widths(cfg)
    keep = 1.0 / (1.0 - rate)
    x = data.x.index_add(0, fed, params["label_emb.weight"][data.y[fed]])
    for i, d in enumerate(widths):
        last = i == len(widths) - 1
        mask = None
        if train and rate > 0:
            mask = torch.rand((heads, row.numel()), generator=gen, device=x.device) < 1.0 - rate
        if train:
            x = checkpoint(layer, x, i, last, params, prec, row, col, mask, keep, heads, d,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = layer(x, i, last, params, prec, row, col, mask, keep, heads, d)
    return x


def label_split(data: GraphData, rate: float, gen):
    """``(fed, supervised)``: the train rows whose labels are input, each
    with probability ``rate``, and the others."""
    tr = data.train_idx
    fed = torch.rand(tr.shape, generator=gen, device=tr.device) < rate
    return tr[fed], tr[~fed]


def train_steps(data: GraphData, cfg: dict, weights: dict, seed: int, steps: int,
                precision: str = "float32", fault: str = None) -> dict:
    """``steps`` full-batch updates from ``weights``: each step's loss, the
    first update's gradients' norms by leaf, and each leaf's distance from
    its start after the last. ``fault`` plants a fault the comparison has to
    catch (see :func:`portbench.reference.common.faulty`)."""
    if cfg["self_loops"] or not cfg["beta"]:
        raise ValueError("the reference writes out the published stack: no self-loops and "
                         "the beta gate")
    prec = Precision(precision)
    row, col = entries(data)
    params = leaf_params(weights)
    opt = Adam(params, float(cfg["lr"]), float(cfg["weight_decay"]))
    gen = generator(seed, "dropout", data.x.device)
    losses, grads = [], None
    for step in range(steps):
        fed, sup = label_split(data, float(cfg["label_rate"]), gen)
        logits = forward(data, cfg, params, prec, gen, row, col, fed)
        tr = faulty(fault, sup)
        loss = cross_entropy(logits[tr], data.y[tr])
        loss.backward()
        del logits
        seen = opt.step(frozen=fault == "unchanged")
        losses.append(float(loss.detach()))
        if step == 0:
            grads = {k: float(g.norm()) for k, g in seen.items()}
    change = {k: float((p.detach() - weights[k]).norm()) for k, p in params.items()}
    return {"losses": losses, "grads": grads, "change": change}
