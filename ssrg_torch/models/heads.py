"""NN heads (counterpart of ``ssrg_tpu/models/heads.py``).

The node-classification heads: ``PReLU``, ``LogisticRegression``,
``MultiLayerPerceptron`` (with BatchNorm and the bfloat16 compute type),
``ResMultiLayerPerceptron``, the naive GCN head ``Layer2GraphConvolution``
(which takes the device adjacency in ``forward``), ``IdenticalMapping``,
the three ``OneDimConvolution`` hop combiners and the augmentation encoder
``FeatureAugment2MLP``. Submodule and parameter names are the flax names
(``fc``, ``fc_<i>``, ``bn_<i>``, ``prelu_<i>``, ``fc_out``, ``fc1``,
``fc2``, ``slope``, ``hop_weight``, ...), so that
:mod:`ssrg_torch.convert` carries parameters both ways. flax infers input
widths at the first call; these modules take them at construction.

Link heads. Built with ``link=True``, a head scores ``query_edges``
(``[B, 2]`` node ids) instead of nodes: the pair's endpoint
representations are joined and projected by ``edge_fc``. As in the
reference, the parameters depend on it: the logistic regression keeps
``fc`` and adds ``edge_fc``; the MLP and the residual MLP have ``edge_fc``
in place of ``fc_out``; the GCN has ``fc2_edge`` (hidden to hidden, before
its second SpMM) and ``edge_fc`` in place of ``fc2``. The logistic
regression and the MLP join the pair by ``edge_mode`` (``concat``, or
``hadamard``: ``[a, b, a * b, |a - b|]``) and the MLP drops out the joined
features once more; the residual MLP and the GCN always concatenate. A
link head called without ``query_edges``, or a node head with them,
raises ``ValueError``.

Training behaviour follows flax, not torch's own layers:

- :class:`Dropout` draws its mask from an explicit ``torch.Generator``
  (:func:`bind_generator`; ``NodeClassification`` binds its train state's),
  never from the global RNG.
- :class:`BatchNorm` is flax's ``nn.BatchNorm``: momentum 0.99, epsilon
  1e-5, batch variance ``E[x^2] - E[x]^2`` (biased) both for normalizing
  and for the running variance, statistics in float32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ssrg_torch.utils import init_dense_, init_dense_xavier_relu_

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class PReLU(nn.Module):
    """Parametric ReLU with one learnable slope (cast to the input's type)."""

    def __init__(self, init_slope: float = 0.25):
        super().__init__()
        self.init_slope = init_slope
        self.slope = nn.Parameter(torch.tensor(init_slope, dtype=torch.float32))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.slope.fill_(self.init_slope)

    def forward(self, x):
        return torch.where(x >= 0, x, self.slope.to(x.dtype) * x)


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in training, keep each element with probability
    ``1 - rate`` and scale the kept ones by ``1 / (1 - rate)``. The mask is
    drawn from ``self.generator`` (on the input's device), which
    :func:`bind_generator` sets; training without one raises."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        keep = self.keep_mask(x.shape, x.device)
        if keep is None:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        return torch.where(keep, x / (1.0 - self.rate),
                           torch.zeros((), dtype=x.dtype, device=x.device))

    def keep_mask(self, shape, device) -> Optional[torch.Tensor]:
        """The mask :meth:`forward` draws for an input of ``shape`` on
        ``device`` (bool, True where a value is kept), for a consumer that
        applies it itself (the attention kernels); None where nothing is
        dropped."""
        if not self.training or self.rate == 0.0:
            return None
        if self.rate >= 1.0:
            return torch.zeros(shape, dtype=torch.bool, device=device)
        if self.generator is None:
            raise RuntimeError(
                "Dropout in training mode needs a torch.Generator: call "
                "ssrg_torch.models.heads.bind_generator(module, generator)"
            )
        return torch.rand(shape, generator=self.generator, device=device) < 1.0 - self.rate


def bind_generator(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Let every :class:`Dropout` of ``module`` draw from ``generator``."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the batch axis of ``[n, C]`` inputs.

    Training normalizes with the batch mean and the biased batch variance
    ``max(E[x^2] - E[x]^2, 0)`` (every row counts, padding rows of a
    minibatch included, as in the reference) and moves the running
    statistics by ``r = momentum * r + (1 - momentum) * batch``; evaluation
    uses the running ones. Statistics and the affine part run in float32;
    the output has the input's type. ``weight``/``bias`` are flax's
    ``scale``/``bias``, ``running_mean``/``running_var`` its ``batch_stats``
    ``mean``/``var``."""

    def __init__(self, num_features: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x):
        x32 = x.float()
        if self.training:
            mean = x32.mean(dim=0)
            var = torch.clamp_min((x32 * x32).mean(dim=0) - mean * mean, 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(x.dtype)


EDGE_WIDTHS = {"concat": 2, "hadamard": 4}  # pair features per endpoint feature


def edge_width(width: int, mode: str = "concat") -> int:
    """The width of the pair features of ``width``-wide endpoints."""
    if mode not in EDGE_WIDTHS:
        raise ValueError(f"unknown edge feature mode {mode!r}")
    return EDGE_WIDTHS[mode] * width


def _edge_features(x: torch.Tensor, query_edges: torch.Tensor,
                   mode: str = "concat") -> torch.Tensor:
    """``[B, 2]`` endpoint pairs -> pair features: ``[a, b]`` (``concat``)
    or ``[a, b, a * b, |a - b|]`` (``hadamard``)."""
    a, b = x[query_edges[:, 0]], x[query_edges[:, 1]]
    if mode == "concat":
        return torch.cat([a, b], dim=-1)
    if mode == "hadamard":
        return torch.cat([a, b, a * b, (a - b).abs()], dim=-1)
    raise ValueError(f"unknown edge feature mode {mode!r}")


def _edge_concat(x: torch.Tensor, query_edges: torch.Tensor) -> torch.Tensor:
    """``[B, 2]`` endpoint pairs -> their concatenated rows ``[B, 2D]``."""
    return _edge_features(x, query_edges, "concat")


def check_query_edges(head: nn.Module, query_edges) -> None:
    """A link head needs ``query_edges``, a node head takes none."""
    if (query_edges is not None) != head.link:
        kind = "a link head needs" if head.link else "a node head takes no"
        raise ValueError(f"{type(head).__name__}: {kind} query_edges")


def _dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """flax ``Dense(dtype=x.dtype)``: kernel and bias cast to the input's
    type, the parameters themselves kept in float32."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class LogisticRegression(nn.Module):
    """Linear head; with ``link``, ``edge_fc`` scores the pairs of its
    outputs."""

    def __init__(self, feat_dim: int, output_dim: int, link: bool = False,
                 edge_mode: str = "concat"):
        super().__init__()
        self.link, self.edge_mode = link, edge_mode
        self.fc = nn.Linear(feat_dim, output_dim)
        if link:
            self.edge_fc = nn.Linear(edge_width(output_dim, edge_mode), output_dim)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        init_dense_xavier_relu_(self.fc, generator)
        if self.link:
            init_dense_xavier_relu_(self.edge_fc, generator)

    def forward(self, feature, query_edges=None):
        check_query_edges(self, query_edges)
        x = self.fc(feature)
        if not self.link:
            return x
        return self.edge_fc(_edge_features(x, query_edges, self.edge_mode))


class MultiLayerPerceptron(nn.Module):
    """(num_layers-1) x [Linear -> (BatchNorm) -> PReLU -> Dropout] -> Linear.

    ``dtype="bfloat16"`` runs the layers in bf16 (operands cast, parameters
    kept in float32) and returns float32 logits, as the reference's
    ``dtype=jnp.bfloat16``. With ``link``, ``edge_fc`` (in place of
    ``fc_out``) scores the pairs of the last hidden layer, dropped out once
    more."""

    def __init__(self, feat_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 2, dropout: float = 0.5, bn: bool = False,
                 dtype: str = "float32", link: bool = False, edge_mode: str = "concat"):
        super().__init__()
        if num_layers < 2:
            raise ValueError("MLP must have at least two layers!")
        if dtype not in _DTYPES:
            raise ValueError(f"head compute dtype must be one of {sorted(_DTYPES)}, got {dtype!r}")
        self.output_dim, self.num_layers, self.bn = output_dim, num_layers, bn
        self.link, self.edge_mode = link, edge_mode
        self.compute_dtype = _DTYPES[dtype]
        dims = [feat_dim] + [hidden_dim] * (num_layers - 1)
        for i in range(num_layers - 1):
            self.add_module(f"fc_{i}", nn.Linear(dims[i], hidden_dim))
            if bn:
                self.add_module(f"bn_{i}", BatchNorm(hidden_dim))
            self.add_module(f"prelu_{i}", PReLU())
        if link:
            self.edge_fc = nn.Linear(edge_width(hidden_dim, edge_mode), output_dim)
        else:
            self.fc_out = nn.Linear(hidden_dim, output_dim)
        self.dropout = Dropout(dropout)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for i in range(self.num_layers - 1):
            init_dense_xavier_relu_(getattr(self, f"fc_{i}"), generator)
            if self.bn:
                getattr(self, f"bn_{i}").reset_parameters()
            getattr(self, f"prelu_{i}").reset_parameters()
        init_dense_xavier_relu_(self.edge_fc if self.link else self.fc_out, generator)

    def forward(self, feature, query_edges=None):
        check_query_edges(self, query_edges)
        x = feature.to(self.compute_dtype)
        for i in range(self.num_layers - 1):
            x = _dense(getattr(self, f"fc_{i}"), x)
            if self.bn:
                x = getattr(self, f"bn_{i}")(x)
            x = getattr(self, f"prelu_{i}")(x)
            x = self.dropout(x)
        if not self.link:
            return _dense(self.fc_out, x).float()
        x = self.dropout(_edge_features(x, query_edges, self.edge_mode))
        return _dense(self.edge_fc, x).float()


class ResMultiLayerPerceptron(nn.Module):
    """Residual MLP: dropout first, ReLU blocks whose residual is the
    previous block's activation, flax-default (lecun-normal) Dense init.
    With ``link``, ``edge_fc`` (in place of ``fc_out``) scores the
    concatenated pairs."""

    def __init__(self, feat_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 2, dropout: float = 0.8, bn: bool = False,
                 link: bool = False):
        super().__init__()
        if num_layers < 2:
            raise ValueError("ResMLP must have at least two layers!")
        self.num_layers, self.bn, self.link = num_layers, bn, link
        for i in range(num_layers - 1):
            self.add_module(f"fc_{i}", nn.Linear(feat_dim if i == 0 else hidden_dim,
                                                 hidden_dim))
            if bn:
                self.add_module(f"bn_{i}", BatchNorm(hidden_dim))
        if link:
            self.edge_fc = nn.Linear(edge_width(hidden_dim), output_dim)
        else:
            self.fc_out = nn.Linear(hidden_dim, output_dim)
        self.dropout = Dropout(dropout)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for i in range(self.num_layers - 1):
            init_dense_(getattr(self, f"fc_{i}"), generator=generator)
            if self.bn:
                getattr(self, f"bn_{i}").reset_parameters()
        init_dense_(self.edge_fc if self.link else self.fc_out, generator=generator)

    def _block(self, i: int, x):
        x = getattr(self, f"fc_{i}")(self.dropout(x))
        if self.bn:
            x = getattr(self, f"bn_{i}")(x)
        return torch.relu(x)

    def forward(self, feature, query_edges=None):
        check_query_edges(self, query_edges)
        x = residual = self._block(0, feature)
        for i in range(1, self.num_layers - 1):
            x_act = self._block(i, x)
            x, residual = x_act + residual, x_act
        x = self.dropout(x)
        if not self.link:
            return self.fc_out(x)
        return self.edge_fc(_edge_concat(x, query_edges))


class Layer2GraphConvolution(nn.Module):
    """Naive 2-layer GCN: ``A @ fc2(dropout(relu(A @ fc1(x))))``. The
    adjacency comes into ``forward`` (for training, a
    :func:`ssrg_torch.ops.sparse.differentiable_adjacency`). With ``link``,
    the second layer is ``A @ fc2_edge(...)`` at the hidden width and
    ``edge_fc`` scores the concatenated pairs of its rows."""

    def __init__(self, feat_dim: int, hidden_dim: int, output_dim: int,
                 dropout: float = 0.5, link: bool = False):
        super().__init__()
        self.link = link
        self.fc1 = nn.Linear(feat_dim, hidden_dim)
        if link:
            self.fc2_edge = nn.Linear(hidden_dim, hidden_dim)
            self.edge_fc = nn.Linear(edge_width(hidden_dim), output_dim)
        else:
            self.fc2 = nn.Linear(hidden_dim, output_dim)
        self.dropout = Dropout(dropout)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        layers = ("fc1", "fc2_edge", "edge_fc") if self.link else ("fc1", "fc2")
        for name in layers:
            init_dense_(getattr(self, name), generator=generator)

    def forward(self, feature, adj, query_edges=None):
        check_query_edges(self, query_edges)
        x = self.dropout(torch.relu(adj.spmm(self.fc1(feature))))
        if not self.link:
            return adj.spmm(self.fc2(x))
        return self.edge_fc(_edge_concat(adj.spmm(self.fc2_edge(x)), query_edges))


class IdenticalMapping(nn.Module):
    """Identity head."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        pass

    def forward(self, feature):
        return feature


class OneDimConvolution(nn.Module):
    """One learnable scalar per hop (ones at init), summed over the hop
    stack ``[K, n, F]``."""

    def __init__(self, num_hops: int):
        super().__init__()
        self.hop_weight = nn.Parameter(torch.ones(num_hops, 1, 1))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.hop_weight.fill_(1.0)

    def forward(self, hops):
        return (hops * self.hop_weight).sum(dim=0)


class OneDimConvolutionWeightSharedAcrossFeatures(nn.Module):
    """One learnable weight per (hop, node), shared across the features,
    summed over the hop stack ``[K, num_nodes, F]``."""

    def __init__(self, num_nodes: int, num_hops: int):
        super().__init__()
        self.hop_node_weight = nn.Parameter(torch.ones(num_hops, num_nodes, 1))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.hop_node_weight.fill_(1.0)

    def forward(self, hops):
        return (hops * self.hop_node_weight).sum(dim=0)


class FastOneDimConvolution(nn.Module):
    """``[n, K, F]`` -> ``[n, F]``: a weighted sum over K with one learnable
    ``[K]`` vector (ones at init)."""

    def __init__(self, num_subgraphs: int):
        super().__init__()
        self.subgraph_weight = nn.Parameter(torch.ones(num_subgraphs))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.subgraph_weight.fill_(1.0)

    def forward(self, stacked):
        return torch.einsum("nkf,k->nf", stacked, self.subgraph_weight)


class FeatureAugment2MLP(nn.Module):
    """Augmentation encoder: a 2-layer MLP returning ``(hidden activation,
    logits)``."""

    def __init__(self, feat_dim: int, hidden_dim: int, output_dim: int,
                 dropout: float = 0.5):
        super().__init__()
        self.fc1 = nn.Linear(feat_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, output_dim)
        self.dropout = Dropout(dropout)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        init_dense_(self.fc1, generator=generator)
        init_dense_(self.fc2, generator=generator)

    def forward(self, feature):
        h = torch.relu(self.fc1(feature))
        return h, self.fc2(self.dropout(h))
