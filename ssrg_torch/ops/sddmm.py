"""SDDMM, sampled dense-dense matrix multiplication (counterpart of
``ssrg_tpu/ops/sddmm.py``).

``score[e] = <u[row_e], v[col_e]>`` for each edge ``e``: the edge-scoring
primitive behind graph attention. Two row gathers and a per-edge dot
product, chunked over the edges so that the gathered ``[chunk, F]`` rows
stay bounded. In the reference this is XLA, not a Pallas kernel, so here it
is plain tensor code.
"""

from __future__ import annotations

import torch


def sddmm(row: torch.Tensor, col: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
          chunk: int = 1 << 19) -> torch.Tensor:
    """Per-edge dot products. ``row``/``col`` int ``[E]`` (padded entries
    may hold any valid index; mask the output), ``u`` ``[N, F]``, ``v``
    ``[M, F]`` -> float32 ``[E]``. Above ``chunk`` edges the gathers run one
    chunk at a time."""
    row, col = row.long(), col.long()
    u32, v32 = u.float(), v.float()
    e = row.shape[0]
    if e <= chunk:
        return (u32.index_select(0, row) * v32.index_select(0, col)).sum(dim=-1)
    return torch.cat([
        (u32.index_select(0, row[s:s + chunk]) * v32.index_select(0, col[s:s + chunk]))
        .sum(dim=-1)
        for s in range(0, e, chunk)
    ])


def edge_softmax(scores: torch.Tensor, row: torch.Tensor, mask: torch.Tensor,
                    num_nodes: int) -> torch.Tensor:
    """Per-destination softmax of edge ``scores`` (``[E]`` or ``[E, H]``)
    over the edges whose ``mask`` is positive (the attention weights of
    ``models.baselines.BaselineGAT``); padded entries get weight 0,
    and so does every edge of a row that has none. The shift is each row's
    largest score (``scatter_reduce`` ``amax``, a row without entries 0, as
    the reference's non-finite segment max). It is detached: the softmax
    does not move under a shift, so its gradient through the shift is 0."""
    row = row.long()
    m = mask.reshape(mask.shape + (1,) * (scores.dim() - 1)).to(scores.dtype)
    neg = torch.finfo(scores.dtype).min
    masked = torch.where(m > 0, scores, torch.full_like(scores, neg))
    idx = row.reshape(row.shape + (1,) * (scores.dim() - 1)).expand_as(masked)
    with torch.no_grad():
        row_max = masked.new_zeros((num_nodes,) + tuple(scores.shape[1:])).scatter_reduce(
            0, idx, masked, "amax", include_self=False)
        row_max = torch.where(torch.isfinite(row_max), row_max, torch.zeros_like(row_max))
    ex = torch.exp(masked - row_max.index_select(0, row)) * m
    denom = torch.zeros_like(row_max).index_add(0, row, ex)
    return ex / torch.clamp_min(denom.index_select(0, row), 1e-16)


def sddmm_softmax_spmm(row: torch.Tensor, col: torch.Tensor, mask: torch.Tensor,
                       u: torch.Tensor, v: torch.Tensor, values: torch.Tensor,
                       num_nodes: int) -> torch.Tensor:
    """One attention layer's graph math: edge scores ``sddmm(u, v)``, their
    per-destination softmax, then the weighted sum of ``values[col]`` into
    each destination row -> ``[num_nodes, F_values]``."""
    alpha = edge_softmax(sddmm(row, col, u, v), row, mask, num_nodes)
    gathered = values.float().index_select(0, col.long()) * alpha[:, None]
    out = gathered.new_zeros((num_nodes, values.shape[1]))
    return out.index_add(0, row.long(), gathered)
