"""GAT as PyG's ``examples/ogbn_products_gat.py`` stacks ``GATConv``, written
out in plain torch, float32 (TF32 off; ``Precision``'s control rounds the
operands of every product to TF32). For layer ``i`` with ``H`` heads of
``d`` features, over the entries ``(row, col)`` (message ``col -> row``) of
``A`` with one self-loop a node::

    z        = x W_i^T                               [N, H, d]   (no bias)
    s_src    = <z, a_src_i>,  s_dst = <z, a_dst_i>   [N, H]
    a[e]     = leaky_relu(s_dst[row_e] + s_src[col_e], 0.2)
    alpha[e] = exp(a[e] - max_row a) / sum_row exp(a - max_row a)
    out[i]   = sum over i's entries of alpha[e] * z[col_e]
    h        = concat_heads(out) (mean over heads at the last layer) + bias_i
               + skip_i(x)                            (skip_i a Linear with bias)
    x        = dropout(elu(h), 0.5) between layers

then the mean cross entropy of the train rows and Adam (lr 0.001, no weight
decay). Parameter names are the port's (``w_{i}``, ``a_src_{i}``,
``a_dst_{i}``, ``bias_{i}``, ``skip_{i}``); the weights are the
benchmark's.

Departures from PyG, each the configuration's (``assumed``) or forced by
size:

- full batch: every node is a target (``x_target = x``), in place of
  ``NeighborSampler`` blocks;
- the loss is ``cross_entropy``, which is the script's ``log_softmax`` then
  ``nll_loss``;
- attention dropout is 0 (``GATConv``'s default), so no draw is made for
  the weights: the dropout stream holds the two feature masks of a step, in
  forward order, as the program's;
- the softmax's shift is the row maximum taken without a gradient (PyG's
  ``softmax`` detaches it too; the softmax does not move under a shift);
- at the cell's size the per-edge messages ``alpha * z[col]`` (258 GB a
  layer) are never formed whole: the weighted sum runs in blocks of
  ``BLOCK`` entries under an autograd function whose backward, ``dz[col] +=
  alpha * g[row]`` and ``dalpha = <g[row], z[col]>``, runs in the same
  blocks; the weights are recomputed in the backward pass
  (``torch.utils.checkpoint``) rather than kept. The products (the linear
  maps and the scores) are written out too, so that in the TF32 control
  their operands are rounded ``ROWS`` rows at a time (in float32 each is one
  product): rounding a whole ``[N, 512]`` operand at once, and keeping
  rounded copies for the backward pass, does not fit on the card beside
  the step.

Nothing here imports the port or JAX; the entries are rebuilt from the
benchmark's edge list.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.graphs import GraphData, generator
from portbench.reference.common import (Adam, Precision, cross_entropy, dropout, faulty,
                                        leaf_params)

# entries of one block of the weighted sum
BLOCK = 1 << 19
# rows of one block of a product's rounding in the TF32 control
ROWS = 1 << 18


def entries(data: GraphData):
    """``(row, col)`` int64 of ``A`` with one self-loop a node: each
    undirected edge both ways, then the loops."""
    loops = torch.arange(data.num_nodes, device=data.lo.device)
    return torch.cat([data.lo, data.hi, loops]), torch.cat([data.hi, data.lo, loops])


def softmax_weights(s_src: torch.Tensor, s_dst: torch.Tensor, row: torch.Tensor,
                    col: torch.Tensor, num_nodes: int, slope: float) -> torch.Tensor:
    """``alpha [E, H]``: the scores' LeakyReLU, softmax over each row's
    entries."""
    a = F.leaky_relu(s_dst[row] + s_src[col], slope)
    with torch.no_grad():
        top = torch.full((num_nodes, a.shape[1]), float("-inf"), device=a.device)
        top.scatter_reduce_(0, row[:, None].expand_as(a), a, "amax", include_self=True)
    ex = torch.exp(a - top[row])
    total = torch.zeros((num_nodes, a.shape[1]), device=a.device).index_add(0, row, ex)
    return ex / total[row]


class _WeightedSum(torch.autograd.Function):
    """``out[i] = sum over i's entries of alpha[e] * z[col_e]`` (``z [N, H,
    d]``, ``alpha [E, H]``), ``BLOCK`` entries at a time."""

    @staticmethod
    def forward(ctx, z, alpha, row, col, prec):
        ctx.save_for_backward(z, alpha)
        ctx.row, ctx.col, ctx.prec = row, col, prec
        out = torch.zeros_like(z)
        for s in range(0, row.numel(), BLOCK):
            r, c = row[s:s + BLOCK], col[s:s + BLOCK]
            out.index_add_(0, r, prec.round(z[c]) * prec.round(alpha[s:s + BLOCK])[..., None])
        return out

    @staticmethod
    def backward(ctx, grad):
        z, alpha = ctx.saved_tensors
        row, col, prec = ctx.row, ctx.col, ctx.prec
        grad = grad.contiguous()
        dz = torch.zeros_like(z)
        dalpha = torch.empty_like(alpha)
        for s in range(0, row.numel(), BLOCK):
            r, c = row[s:s + BLOCK], col[s:s + BLOCK]
            gr = prec.round(grad[r])
            dz.index_add_(0, c, gr * prec.round(alpha[s:s + BLOCK])[..., None])
            dalpha[s:s + BLOCK] = (gr * prec.round(z[c])).sum(-1)
        return dz, dalpha, None, None, None


def weighted_sum(z, alpha, row, col, prec: Precision) -> torch.Tensor:
    return _WeightedSum.apply(z, alpha, row, col, prec)


def _rows(n: int):
    return ((s, min(s + ROWS, n)) for s in range(0, n, ROWS))


class _Linear(torch.autograd.Function):
    """``x @ w^T``; in the TF32 control every operand rounded, ``ROWS`` rows
    of x (and of the gradient) at a time."""

    @staticmethod
    def forward(ctx, x, w, prec):
        ctx.save_for_backward(x, w)
        ctx.prec = prec
        if prec.name == "float32":
            return x @ w.t()
        wr = prec.round(w)
        out = x.new_empty((x.shape[0], w.shape[0]))
        for a, b in _rows(x.shape[0]):
            out[a:b] = prec.round(x[a:b]) @ wr.t()
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        prec = ctx.prec
        want_x = ctx.needs_input_grad[0]
        if prec.name == "float32":
            return (g @ w) if want_x else None, g.t() @ x, None
        wr = prec.round(w)
        dx = torch.empty_like(x) if want_x else None
        dw = torch.zeros_like(w)
        for a, b in _rows(x.shape[0]):
            gb = prec.round(g[a:b])
            if want_x:
                dx[a:b] = gb @ wr
            dw += gb.t() @ prec.round(x[a:b])
        return dx, dw, None


class _Score(torch.autograd.Function):
    """``<z[n, h, :], a[0, h, :]>`` for every node and head: ``[N, H]``; in
    the TF32 control both operands rounded, ``ROWS`` rows of z at a time."""

    @staticmethod
    def forward(ctx, z, a, prec):
        ctx.save_for_backward(z, a)
        ctx.prec = prec
        if prec.name == "float32":
            return (z * a).sum(-1)
        ar = prec.round(a)
        out = z.new_empty(z.shape[:2])
        for s, e in _rows(z.shape[0]):
            out[s:e] = (prec.round(z[s:e]) * ar).sum(-1)
        return out

    @staticmethod
    def backward(ctx, g):
        z, a = ctx.saved_tensors
        prec = ctx.prec
        gr, ar = prec.round(g.contiguous()), prec.round(a)
        da = torch.zeros_like(a)
        for s, e in _rows(z.shape[0]):
            da += (gr[s:e, :, None] * prec.round(z[s:e])).sum(0, keepdim=True)
        return gr[..., None] * ar, da, None


def linear(x, w, b, prec: Precision) -> torch.Tensor:
    return _Linear.apply(x, w, prec) + b


def score(z: torch.Tensor, a: torch.Tensor, prec: Precision) -> torch.Tensor:
    return _Score.apply(z, a, prec)


def layer_widths(cfg: dict) -> list:
    """One head's width at each layer: the hidden width, the classes last."""
    h = int(cfg["hidden_channels"])
    return [h] * (int(cfg["num_layers"]) - 1) + [int(cfg["dataset"]["num_classes"])]


def forward(data: GraphData, cfg: dict, params: dict, prec: Precision, gen, row, col):
    """The logits ``[N, C]`` of one training forward pass."""
    heads, slope = int(cfg["heads"]), float(cfg["negative_slope"])
    widths = layer_widths(cfg)
    n, rate = data.num_nodes, float(cfg["dropout"])
    x = data.x
    for i, d in enumerate(widths):
        last = i == len(widths) - 1
        z = _Linear.apply(x, params[f"w_{i}.weight"], prec).view(n, heads, d)
        s_src = score(z, params[f"a_src_{i}"], prec)
        s_dst = score(z, params[f"a_dst_{i}"], prec)
        alpha = checkpoint(softmax_weights, s_src, s_dst, row, col, n, slope,
                           use_reentrant=False)
        out = weighted_sum(z, alpha, row, col, prec)
        del alpha
        h = out.mean(dim=1) if last else out.reshape(n, heads * d)
        del out
        h = h + params[f"bias_{i}"] + linear(x, params[f"skip_{i}.weight"],
                                             params[f"skip_{i}.bias"], prec)
        x = h if last else dropout(F.elu(h), rate, gen)
    return x


def train_steps(data: GraphData, cfg: dict, weights: dict, seed: int, steps: int,
                precision: str = "float32", fault: str = None) -> dict:
    """``steps`` full-batch updates from ``weights``: each step's loss, the
    first update's gradients' norms by leaf, and each leaf's distance from
    its start after the last. ``fault`` plants a fault the comparison has to
    catch (see :func:`portbench.reference.common.faulty`)."""
    if (float(cfg["attn_dropout"]) != 0.0 or not cfg["self_loops"] or not cfg["skip"]
            or not cfg["bias"]):
        raise ValueError("the reference writes out the published form: self-loops, skip "
                         "linears, a bias and no attention dropout")
    prec = Precision(precision)
    row, col = entries(data)
    params = leaf_params(weights)
    opt = Adam(params, float(cfg["lr"]), float(cfg["weight_decay"]))
    gen = generator(seed, "dropout", data.x.device)
    tr = faulty(fault, data.train_idx)
    losses, grads = [], None
    for step in range(steps):
        logits = forward(data, cfg, params, prec, gen, row, col)
        loss = cross_entropy(logits[tr], data.y[tr])
        loss.backward()
        del logits
        seen = opt.step(frozen=fault == "unchanged")
        losses.append(float(loss.detach()))
        if step == 0:
            grads = {k: float(g.norm()) for k, g in seen.items()}
    change = {k: float((p.detach() - weights[k]).norm()) for k, p in params.items()}
    return {"losses": losses, "grads": grads, "change": change}
