"""Message-passing baselines (counterpart of ``ssrg_tpu/models/baselines.py``):
MLP, robust MLP (for the triplet loss), GCN, GraphSAGE, GAT, SGC and SIGN,
and UniMP, which the JAX package has not (``BaselineUniMP``: graph-transformer
layers over :func:`ssrg_torch.ops.gat_attention.dot_attention` with the
labels of some nodes as input).

Unlike the precompute zoo, each layer of GCN, SAGE and GAT runs its own
graph product:

- GCN and SAGE call ``adj.spmm`` on the device adjacency. For training that
  is a :func:`ssrg_torch.ops.sparse.differentiable_adjacency`: the ELL
  kernel forward, and backward on the pack of ``A^T`` (SAGE's row-mean
  ``D^-1 A`` is not symmetric, so its backward has a pack of its own).
- GAT scores every node with
  :func:`ssrg_torch.ops.gat_attention.gat_scores` (``(z * a).sum(-1)`` on
  the CPU, kernels that read z once on a card), then every edge of an
  :class:`EdgeList`, and takes a per-destination softmax with segment ops
  (``scatter_reduce``, ``index_add``): plain tensor code, as it is XLA in
  the reference. Over an attention listing
  (:meth:`EdgeList.attention`) each layer's attention is instead
  :func:`ssrg_torch.ops.gat_attention.gat_attention`: the hand-written CUDA
  kernels on a card (no per-edge message is held), their plain versions on
  the CPU. ``BaselineGAT(published=True)`` is PyG's ``GATConv`` as
  ``examples/ogbn_products_gat.py`` stacks it: a bias after the
  aggregation, a skip ``Linear`` added to each layer, self-loops in the
  listing, attention dropout of its own (on a card too: the kernels read
  the mask); without it, the reference's form.

Submodule and parameter names are the flax names (``lin_{i}``, ``bn_{i}``,
``lin_out``, ``conv_{i}``, ``conv_out``, ``self_{i}``, ``nbr_{i}``,
``w_{i}``, ``a_src_{i}``, ``a_dst_{i}``, ``lin``, ``hop_{k}``, ``out``), so
that :mod:`ssrg_torch.convert` carries the reference's parameters over; the
published GAT form adds ``bias_{i}`` and ``skip_{i}``, which the reference
has not.
flax infers input widths at the first call; these modules take them at
construction. Dropout draws from the generator that
:func:`ssrg_torch.models.heads.bind_generator` binds, BatchNorm has flax's
semantics (:class:`ssrg_torch.models.heads.BatchNorm`).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ssrg_torch.models.heads import BatchNorm, Dropout
from ssrg_torch.ops.gat_attention import dot_attention, gat_attention, gat_scores
from ssrg_torch.ops.sddmm import edge_softmax
from ssrg_torch.utils import DeviceLike, init_dense_, resolve_device, variance_scaling_


@dataclass
class EdgeList:
    """COO edge list for edge-level ops (GAT attention): ``row`` the
    destination, ``col`` the source, ``mask`` 1 on real edges and 0 on the
    padding that rounds the length up to a multiple of ``pad_to`` (padding
    entries point at node 0). The padding keeps the packs equal entry for
    entry to the reference's; it costs the port nothing else.

    An attention listing (:meth:`attention`) is the structure the attention
    kernels of :mod:`ssrg_torch.ops.gat_attention` consume: every entry once,
    no padding (``mask`` None, ``nnz`` the entry count), sorted by ``row``
    then ``col``, and beside it the transposed listing ``t_row`` (source),
    ``t_col`` (destination) sorted by source, which the backward pass walks;
    for a symmetric structure the two listings are the same tensors. GAT's
    listing has one self-loop a node in place of the diagonal; the
    graph-transformer's (UniMP, ``self_loops=False``) keeps the stored
    entries as they are, so a node without neighbours has a row without
    entries. ``t_pos`` (:meth:`positions`) gives each transposed entry's
    place in the row listing, where per-edge values (scores, dropped
    weights) are kept."""

    row: torch.Tensor             # int32 [E_pad] destination
    col: torch.Tensor             # int32 [E_pad] source
    mask: Optional[torch.Tensor]  # f32 [E_pad]; None: every entry is real
    num_nodes: int
    nnz: Optional[int] = None     # the real entries of an attention listing
    t_row: Optional[torch.Tensor] = None  # int32 [nnz] source, sorted
    t_col: Optional[torch.Tensor] = None  # int32 [nnz] destination
    t_pos: Optional[torch.Tensor] = None  # int32 [nnz] each one's place in row, col

    @property
    def weights_mask(self) -> torch.Tensor:
        """``mask``, or ones where every entry is real."""
        if self.mask is not None:
            return self.mask
        return torch.ones(self.row.shape, dtype=torch.float32, device=self.row.device)

    @classmethod
    def from_scipy(cls, adj: sp.spmatrix, pad_to: int = 512,
                   e_pad: Optional[int] = None) -> "EdgeList":
        """The entries of ``adj`` in its COO order, on the host; ``e_pad``
        forces the padded length."""
        coo = adj.tocoo()
        e = coo.nnz
        if e_pad is None:
            e_pad = ((e + pad_to - 1) // pad_to) * pad_to if e else pad_to
        elif e_pad < e:
            raise ValueError(f"e_pad {e_pad} < nnz {e}")
        row = np.zeros(e_pad, np.int32)
        col = np.zeros(e_pad, np.int32)
        mask = np.zeros(e_pad, np.float32)
        row[:e] = coo.row
        col[:e] = coo.col
        mask[:e] = 1.0
        return cls(torch.from_numpy(row), torch.from_numpy(col), torch.from_numpy(mask),
                   adj.shape[0])

    @classmethod
    def attention(cls, adj: sp.spmatrix, self_loops: bool = True) -> "EdgeList":
        """The attention listing of ``adj``'s stored entries, on the host:
        with ``self_loops`` every diagonal entry dropped and one self-loop
        added a node (PyG's ``add_self_loops``, as ``GATConv`` does); without
        them the stored entries as they are (``TransformerConv`` adds none),
        rows without entries included."""
        coo = adj.tocoo()
        n, m = adj.shape
        if n != m:
            raise ValueError(f"an attention listing needs a square adjacency, got {adj.shape}")
        if self_loops:
            keep = coo.row != coo.col
            loops = np.arange(n)
            r = np.concatenate([coo.row[keep], loops])
            c = np.concatenate([coo.col[keep], loops])
        else:
            r, c = coo.row, coo.col
        csr = sp.csr_matrix((np.ones(r.shape[0], np.float32), (r, c)), shape=(n, m))
        csr.sum_duplicates()
        row = torch.from_numpy(np.repeat(np.arange(n, dtype=np.int32), np.diff(csr.indptr)))
        col = torch.from_numpy(csr.indices.astype(np.int32))
        t = csr.T.tocsr()
        t.sum_duplicates()
        if np.array_equal(t.indptr, csr.indptr) and np.array_equal(t.indices, csr.indices):
            t_row, t_col = row, col
        else:
            t_row = torch.from_numpy(np.repeat(np.arange(m, dtype=np.int32), np.diff(t.indptr)))
            t_col = torch.from_numpy(t.indices.astype(np.int32))
        return cls(row, col, None, n, int(csr.nnz), t_row, t_col)

    def positions(self) -> torch.Tensor:
        """``t_pos``, computed on the listing's device at the first call:
        the place ``e`` in the row listing of each transposed entry, the
        entry with ``row[e] = t_col[p]`` and ``col[e] = t_row[p]`` (found by
        a binary search of the sorted keys ``row * N + col``)."""
        if self.t_pos is None:
            if self.t_row is None:
                raise TypeError("positions need an attention listing (EdgeList.attention)")
            n = self.num_nodes
            keys = self.row[:self.nnz].long() * n + self.col[:self.nnz].long()
            want = self.t_col.long() * n + self.t_row.long()
            self.t_pos = torch.searchsorted(keys, want).to(torch.int32)
        return self.t_pos

    def to(self, device: DeviceLike) -> "EdgeList":
        dev = resolve_device(device)
        row, col = self.row.to(dev), self.col.to(dev)
        t_row, t_col = self.t_row, self.t_col
        if t_row is self.row and t_col is self.col:
            t_row, t_col = row, col
        elif t_row is not None:
            t_row, t_col = t_row.to(dev), t_col.to(dev)
        return replace(self, row=row, col=col, t_row=t_row, t_col=t_col,
                       mask=None if self.mask is None else self.mask.to(dev),
                       t_pos=None if self.t_pos is None else self.t_pos.to(dev))


class BaselineMLP(nn.Module):
    """(num_layers-1) x [Linear -> BatchNorm -> ReLU -> Dropout] -> Linear."""

    def __init__(self, feat_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 3, dropout: float = 0.5):
        super().__init__()
        self.num_layers = num_layers
        dims = [feat_dim] + [hidden_dim] * (num_layers - 1)
        for i in range(num_layers - 1):
            self.add_module(f"lin_{i}", nn.Linear(dims[i], hidden_dim))
            self.add_module(f"bn_{i}", BatchNorm(hidden_dim))
        self.lin_out = nn.Linear(dims[-1], output_dim)
        self.dropout = Dropout(dropout)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for i in range(self.num_layers - 1):
            init_dense_(getattr(self, f"lin_{i}"), generator=generator)
            getattr(self, f"bn_{i}").reset_parameters()
        init_dense_(self.lin_out, generator=generator)

    def forward(self, x, adj=None):
        for i in range(self.num_layers - 1):
            x = getattr(self, f"bn_{i}")(getattr(self, f"lin_{i}")(x))
            x = self.dropout(torch.relu(x))
        return self.lin_out(x)


class RobustMLP(nn.Module):
    """The robust MLP: returns ``(L2-normalized hidden, log-probabilities)``
    for the class-wise margin triplet loss. The hidden norm's gradient at an
    all-zero row is 0 here (torch's ``vector_norm``); the reference's
    ``jnp.linalg.norm`` gives NaN, which ReLU's gradient stops before the
    parameters (ROADMAP.md section 3)."""

    def __init__(self, feat_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 3, dropout: float = 0.5):
        super().__init__()
        self.num_layers = num_layers
        dims = [feat_dim] + [hidden_dim] * (num_layers - 1)
        for i in range(num_layers - 1):
            self.add_module(f"lin_{i}", nn.Linear(dims[i], hidden_dim))
        self.lin_out = nn.Linear(dims[-1], output_dim)
        self.dropout = Dropout(dropout)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for i in range(self.num_layers - 1):
            init_dense_(getattr(self, f"lin_{i}"), generator=generator)
        init_dense_(self.lin_out, generator=generator)

    def forward(self, x, adj=None) -> Tuple[torch.Tensor, torch.Tensor]:
        for i in range(self.num_layers - 1):
            x = self.dropout(torch.relu(getattr(self, f"lin_{i}")(x)))
        norm = torch.linalg.vector_norm(x, dim=1, keepdim=True)
        hidden = x / torch.clamp_min(norm, 1e-12)
        return hidden, F.log_softmax(self.lin_out(x), dim=1)


class BaselineGCN(nn.Module):
    """Multi-layer GCN over a sym-normalized device adjacency:
    ``x <- dropout(relu(A conv_i(x)))``, then ``A conv_out(x)``."""

    def __init__(self, feat_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 2, dropout: float = 0.5):
        super().__init__()
        self.num_layers = num_layers
        dims = [feat_dim] + [hidden_dim] * (num_layers - 1)
        for i in range(num_layers - 1):
            self.add_module(f"conv_{i}", nn.Linear(dims[i], hidden_dim))
        self.conv_out = nn.Linear(dims[-1], output_dim)
        self.dropout = Dropout(dropout)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for i in range(self.num_layers - 1):
            init_dense_(getattr(self, f"conv_{i}"), generator=generator)
        init_dense_(self.conv_out, generator=generator)

    def forward(self, x, adj):
        for i in range(self.num_layers - 1):
            x = self.dropout(torch.relu(adj.spmm(getattr(self, f"conv_{i}")(x))))
        return adj.spmm(self.conv_out(x))


class BaselineSAGE(nn.Module):
    """GraphSAGE-mean: ``h' = self_i(h) + nbr_i(P h)`` with ``P = D^-1 A``
    the device adjacency. The first layer's ``P x`` multiplies the raw
    features, which take no gradient: only the later layers' SpMMs run a
    backward."""

    def __init__(self, feat_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 2, dropout: float = 0.5):
        super().__init__()
        self.num_layers = num_layers
        dims = [feat_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        for i in range(num_layers):
            self.add_module(f"self_{i}", nn.Linear(dims[i], dims[i + 1]))
            self.add_module(f"nbr_{i}", nn.Linear(dims[i], dims[i + 1], bias=False))
        self.dropout = Dropout(dropout)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for i in range(self.num_layers):
            init_dense_(getattr(self, f"self_{i}"), generator=generator)
            init_dense_(getattr(self, f"nbr_{i}"), generator=generator)

    def forward(self, x, adj):
        for i in range(self.num_layers):
            neigh = adj.spmm(x)
            x = getattr(self, f"self_{i}")(x) + getattr(self, f"nbr_{i}")(neigh)
            if i < self.num_layers - 1:
                x = self.dropout(torch.relu(x))
        return x


class BaselineGAT(nn.Module):
    """GAT: ``heads``-head attention layers over an :class:`EdgeList`,
    heads concatenated between layers and averaged at the output layer.
    ``hidden_dim`` is the width of one head.

    The reference's form (the default): ``z = w_i(x)``, the attention's
    weighted sum of ``z``, ELU and dropout between layers, the weights of
    the attention dropped at the feature rate (``attn_dropout`` None). The
    ``published`` form, PyG's ``GATConv`` stack in ``ogbn_products_gat.py``,
    adds a bias (``bias_{i}``, after the concatenation or the mean) and a
    skip ``Linear`` (``skip_{i}``) of the layer's input added to its output
    before ELU, and drops the weights at ``attn_dropout`` (None: 0, no draw
    made); its self-loops are in the listing (:meth:`EdgeList.attention`).

    Over an attention listing a layer runs
    :func:`ssrg_torch.ops.gat_attention.gat_attention`, the kernels on a
    card and their plain versions on the CPU; in training at an
    ``attn_dropout`` above 0 the mask of the weights, ``[H, E]``, is drawn
    from the bound generator as :class:`~ssrg_torch.models.heads.Dropout`
    draws one (none at a rate of 0) and handed to the kernels. The
    reference's padded list always takes the plain path. Both take their
    scores from :func:`ssrg_torch.ops.gat_attention.gat_scores`."""

    def __init__(self, feat_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 2, heads: int = 8, dropout: float = 0.5,
                 negative_slope: float = 0.2, published: bool = False,
                 attn_dropout: Optional[float] = None):
        super().__init__()
        self.num_layers, self.heads, self.negative_slope = num_layers, heads, negative_slope
        self.published = published
        self.dims = [hidden_dim] * (num_layers - 1) + [output_dim]
        in_dim = feat_dim
        for i, d in enumerate(self.dims):
            last = i == num_layers - 1
            self.add_module(f"w_{i}", nn.Linear(in_dim, heads * d, bias=False))
            self.register_parameter(f"a_src_{i}", nn.Parameter(torch.empty(1, heads, d)))
            self.register_parameter(f"a_dst_{i}", nn.Parameter(torch.empty(1, heads, d)))
            if published:
                width = d if last else heads * d
                self.register_parameter(f"bias_{i}", nn.Parameter(torch.empty(width)))
                self.add_module(f"skip_{i}", nn.Linear(in_dim, width))
            in_dim = heads * d
        self.dropout = Dropout(dropout)
        if attn_dropout is None:
            self.attn_dropout = Dropout(0.0) if published else self.dropout
        else:
            self.attn_dropout = Dropout(attn_dropout)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for i, d in enumerate(self.dims):
            init_dense_(getattr(self, f"w_{i}"), generator=generator)
            for name in (f"a_src_{i}", f"a_dst_{i}"):
                # flax's xavier_uniform on (1, H, D): fan_in H, fan_out D
                variance_scaling_(getattr(self, name), 1.0, "fan_avg", "uniform",
                                  fan_in=self.heads, fan_out=d, generator=generator)
            if self.published:
                nn.init.zeros_(getattr(self, f"bias_{i}"))
                init_dense_(getattr(self, f"skip_{i}"), generator=generator)

    def forward(self, x, edges: EdgeList):
        h, n = self.heads, edges.num_nodes
        fused = edges.t_row is not None  # an attention listing: the fused attention
        row, col = edges.row.long(), edges.col.long()
        for i, d in enumerate(self.dims):
            last = i == self.num_layers - 1
            x_in = x
            z = getattr(self, f"w_{i}")(x).view(n, h, d)
            score_src, score_dst = gat_scores(z, getattr(self, f"a_src_{i}"),
                                              getattr(self, f"a_dst_{i}"))   # [N, H]
            if fused:
                out = gat_attention(z, score_src, score_dst, edges, self.negative_slope,
                                    self.attn_dropout.keep_mask((h, edges.nnz), x.device),
                                    self.attn_dropout.rate)
            else:
                e = F.leaky_relu(score_dst.index_select(0, row) + score_src.index_select(0, col),
                                 self.negative_slope)
                alpha = self.attn_dropout(edge_softmax(e, row, edges.weights_mask, n))  # [E, H]
                msgs = z.index_select(0, col) * alpha[..., None]                        # [E, H, D]
                out = z.new_zeros((n, h, d)).index_add(0, row, msgs)
            x = out.mean(dim=1) if last else out.reshape(n, h * d)
            if self.published:
                x = x + getattr(self, f"bias_{i}") + getattr(self, f"skip_{i}")(x_in)
            if not last:
                x = self.dropout(F.elu(x))
        return x


class BaselineUniMP(nn.Module):
    """UniMP (Shi et al., IJCAI 2021): graph-transformer layers with the
    labels of some nodes fed as input, PyG's ``TransformerConv(beta=True)``
    as ``examples/unimp_arxiv.py`` stacks it with ``MaskLabel``. For layer
    ``i`` with ``heads`` heads of ``d`` features (``hidden_dim``, the
    classes at the last layer), over an attention listing without
    self-loops (:meth:`EdgeList.attention`)::

        q, k, v  = query_i(x), key_i(x), value_i(x)           [N, H, d]
        m        = dot_attention(q, k, v): softmax over i's entries of
                   <q_i, k_j> / sqrt(d), weights dropped at attn_dropout,
                   the weighted sum of v_j; heads concatenated, averaged
                   at the last layer
        r        = skip_i(x)
        beta     = sigmoid(beta_i([m, r, m - r]))             (no bias)
        h        = beta r + (1 - beta) m
        x        = relu(norm_i(h)) between layers; h the logits last

    with ``x_0 = x + label_emb(y)`` on the nodes ``fed`` (``MaskLabel``'s
    ``add``). The attention is
    :func:`ssrg_torch.ops.gat_attention.dot_attention`: the kernels on a
    card, their plain versions on the CPU, never an ``[E, H, d]`` tensor.
    The gate's product is taken as ``m (w_m + w_d) + r (w_r - w_d)``, the
    same sum without the ``[N, 3 width]`` concatenation. Each layer's mask
    of the weights, ``[H, E]``, is drawn from the bound generator before
    the layer (none at a rate of 0), and in training each layer runs under
    ``torch.utils.checkpoint``: only its input and its mask stay for the
    backward pass, which runs the layer again (a hidden layer would
    otherwise keep about 40 GB at ogbn-products' size). No feature dropout
    between layers, as the published stack has none. Parameter names:
    ``label_emb``, ``query_{i}``, ``key_{i}``, ``value_{i}``, ``skip_{i}``,
    ``beta_{i}``, ``norm_{i}``."""

    def __init__(self, feat_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 3, heads: int = 4, attn_dropout: float = 0.0):
        super().__init__()
        self.num_layers, self.heads = num_layers, heads
        self.dims = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.label_emb = nn.Embedding(output_dim, feat_dim)
        in_dim = feat_dim
        for i, d in enumerate(self.dims):
            width = d if i == num_layers - 1 else heads * d
            for name in ("query", "key", "value"):
                self.add_module(f"{name}_{i}", nn.Linear(in_dim, heads * d))
            self.add_module(f"skip_{i}", nn.Linear(in_dim, width))
            self.add_module(f"beta_{i}", nn.Linear(3 * width, 1, bias=False))
            if i < num_layers - 1:
                self.add_module(f"norm_{i}", nn.LayerNorm(width))
            in_dim = heads * d
        self.attn_dropout = Dropout(attn_dropout)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.label_emb.weight.normal_(generator=generator)
        for i in range(self.num_layers):
            for name in ("query", "key", "value", "skip", "beta"):
                init_dense_(getattr(self, f"{name}_{i}"), generator=generator)
            if i < self.num_layers - 1:
                getattr(self, f"norm_{i}").reset_parameters()

    def _layer(self, i: int, x: torch.Tensor, edges: EdgeList, mask) -> torch.Tensor:
        n, h, d = x.shape[0], self.heads, self.dims[i]
        last = i == self.num_layers - 1
        q, k, v = (getattr(self, f"{name}_{i}")(x).view(n, h, d)
                   for name in ("query", "key", "value"))
        out = dot_attention(q, k, v, edges, mask, self.attn_dropout.rate)
        del q, k, v
        m = out.mean(dim=1) if last else out.reshape(n, h * d)
        r = getattr(self, f"skip_{i}")(x)
        w_m, w_r, w_d = getattr(self, f"beta_{i}").weight.view(3, -1)
        beta = torch.sigmoid(m @ (w_m + w_d) + r @ (w_r - w_d))[:, None]
        x = beta * r + (1.0 - beta) * m
        return x if last else torch.relu(getattr(self, f"norm_{i}")(x))

    def forward(self, x, edges: EdgeList, labels: torch.Tensor, fed: torch.Tensor):
        """The logits ``[N, C]``; ``labels`` every node's, ``fed`` the nodes
        whose labels enter the input."""
        if edges.t_row is None:
            raise TypeError("BaselineUniMP runs over an attention listing "
                            "(EdgeList.attention(adj, self_loops=False))")
        x = x.index_add(0, fed, self.label_emb(labels[fed]))
        saving = self.training and torch.is_grad_enabled()
        for i in range(self.num_layers):
            mask = self.attn_dropout.keep_mask((self.heads, edges.nnz), x.device)
            if saving:
                x = checkpoint(self._layer, i, x, edges, mask, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = self._layer(i, x, edges, mask)
        return x


class BaselineSGC(nn.Module):
    """SGC's head over the K-hop precomputed feature: one linear map."""

    def __init__(self, feat_dim: int, output_dim: int):
        super().__init__()
        self.lin = nn.Linear(feat_dim, output_dim)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        init_dense_(self.lin, generator=generator)

    def forward(self, x_propagated, adj=None):
        return self.lin(x_propagated)


class BaselineSIGN(nn.Module):
    """SIGN: one linear map with ReLU for each hop of the stack ``[K+1, N,
    F]``, concatenated, dropout, then the output map."""

    def __init__(self, feat_dim: int, hidden_dim: int, output_dim: int, num_hops: int,
                 dropout: float = 0.5):
        super().__init__()
        self.num_hops = num_hops
        for k in range(num_hops):
            self.add_module(f"hop_{k}", nn.Linear(feat_dim, hidden_dim))
        self.out = nn.Linear(num_hops * hidden_dim, output_dim)
        self.dropout = Dropout(dropout)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for k in range(self.num_hops):
            init_dense_(getattr(self, f"hop_{k}"), generator=generator)
        init_dense_(self.out, generator=generator)

    def forward(self, hops, adj=None):
        x = torch.cat([torch.relu(getattr(self, f"hop_{k}")(hops[k]))
                       for k in range(hops.shape[0])], dim=-1)
        return self.out(self.dropout(x))


def triplet_loss(hidden: torch.Tensor, labels: torch.Tensor, idx: torch.Tensor,
                 num_classes: int, margin: float = 1.0) -> torch.Tensor:
    """Class-wise margin triplet loss: pull each node toward its class
    centroid, push it from the nearest other centroid. A node at zero
    distance from its centroid (a class with one node) gets gradient 0
    here; the reference's ``jnp.linalg.norm`` gives NaN (ROADMAP.md
    section 3)."""
    h = hidden[idx]
    onehot = F.one_hot(labels[idx], num_classes).to(h.dtype)           # [B, C]
    counts = torch.clamp_min(onehot.sum(0), 1.0)
    centroids = (onehot.T @ h) / counts[:, None]                        # [C, D]
    d = torch.linalg.vector_norm(h[:, None, :] - centroids[None], dim=-1)  # [B, C]
    d_pos = (d * onehot).sum(1)
    d_neg = torch.where(onehot > 0, torch.full_like(d, float("inf")), d).amin(dim=1)
    return torch.clamp_min(d_pos - d_neg + margin, 0.0).mean()
