"""Model zoo (counterpart of ``ssrg_tpu/models/zoo.py``): the precompute
models as {graph op, message op, head} compositions.

| model | graph_op | msg_op                        | head   |
|-------|----------|-------------------------------|--------|
| sgc   | sym      | last                          | LogReg |
| ssgc  | sym      | mean                          | LogReg |
| sign  | sym      | proj_concat (per-hop MLP)     | MLP    |
| gbp   | sym      | simple_weighted (alpha decay) | MLP    |
| gamlp | sym      | learnable_weighted ("jk")     | MLP    |
| nafs  | sym      | over_smooth_dis_weighted      | LogReg |
| gcn   | naive sym (in the head) | —                      | 2-layer GCN |
| wavelet | spectral (Φ, Φ⁻¹)      | —                      | 2-layer GWNN |
| magnet | magnetic (complex)     | last (re, im)                 | ComMLP |
| two_dir | two_dir (un/in/out)   | last of each, concatenated    | MLP    |
| two_order | two_order (pair)    | last of each, concatenated    | MLP    |
| clean_train | — (featureless)   | —                      | FeatureAugment2MLP |

``GRAPH_OPS`` names every construction of :mod:`ssrg_torch.ops.normalize`
(sym, ppr, magnetic, magnetic_ppr, two_dir, fast_ppr, two_order), so a
custom composition can use any of them.

``load_model(..., link=True)`` builds the model's link head, which scores
``query_edges`` pairs (:mod:`ssrg_torch.models.heads`); magnet and
clean_train, whose heads have no link scorer, refuse it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import scipy.sparse as sp
import torch
from torch import nn

from ssrg_torch.configs.config import ModelConfig
from ssrg_torch.models.complex_heads import ComMLP
from ssrg_torch.models.heads import (
    FeatureAugment2MLP,
    Layer2GraphConvolution,
    LogisticRegression,
    MultiLayerPerceptron,
)
from ssrg_torch.models.wavelet import Wavelet2NeuralNetwork
from ssrg_torch.ops import normalize
from ssrg_torch.ops.combine import (
    LEARNABLE_AGGR_TYPES,
    ProjectedConcatMessageOp,
    make_message_op,
)

# graph op name -> (adj, cfg) -> CSR or tuple of CSR
GRAPH_OPS: Dict[str, Callable[[sp.spmatrix, ModelConfig], Any]] = {
    "sym": lambda adj, cfg: normalize.sym_norm(adj, cfg.r),
    "ppr": lambda adj, cfg: normalize.ppr_norm(adj, cfg.r, 0.15),
    "magnetic": lambda adj, cfg: normalize.magnetic_norm(adj, cfg.r, cfg.q),
    "magnetic_ppr": lambda adj, cfg: normalize.magnetic_com_ppr_norm(adj, cfg.r, cfg.q, 0.15),
    "two_dir": lambda adj, cfg: normalize.un_in_out_norm(adj, cfg.r),
    "fast_ppr": lambda adj, cfg: normalize.fast_ppr_approx_norm(adj, cfg.r, cfg.ppr_alpha),
    "two_order": lambda adj, cfg: normalize.two_order_ppr_approx_norm(
        adj, cfg.r, cfg.ppr_alpha),
}
# the graph ops that give a tuple of adjacencies: (real, imag) for the
# complex propagation, or the hop-stack lists of propagate_multi
MULTI_ADJACENCY_GRAPH_OPS = ("magnetic", "magnetic_ppr", "two_dir", "two_order")
COMPLEX_GRAPH_OPS = ("magnetic", "magnetic_ppr")


class PrecomputeModel(nn.Module):
    """The trainable part of a precompute model: an optional in-forward
    message op, then the head. ``inputs`` is ``[n, D]`` when aggregation
    happened at precompute time, or the hop stack ``[K+1, n, F]`` when the
    message op is learnable, or the ``(re, im)`` pair of a complex model. A
    naive model's head also takes the device adjacency ``adj``, a spectral
    model's the pair ``(Φ, Φ⁻¹)``."""

    def __init__(self, msg_op: Optional[nn.Module] = None, head: nn.Module = None):
        super().__init__()
        self.msg_op = msg_op
        self.head = head

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if self.msg_op is not None:
            self.msg_op.reset_parameters(generator)
        self.head.reset_parameters(generator)

    def forward(self, inputs, adj=None, query_edges=None):
        x = inputs if self.msg_op is None else self.msg_op(inputs)
        kwargs = {} if query_edges is None else {"query_edges": query_edges}
        if adj is not None:
            return self.head(x, adj, **kwargs)
        return self.head(x, **kwargs)


@dataclass
class ModelSpec:
    """Declarative model description consumed by the task layer."""

    name: str
    graph_op: Optional[str]
    module: PrecomputeModel
    aggr_type: Optional[str] = None
    naive: bool = False
    spectral: bool = False
    prop_steps: int = 3

    @property
    def pre_msg_learnable(self) -> bool:
        """Learnable aggregation runs per batch, in forward."""
        return self.aggr_type in LEARNABLE_AGGR_TYPES

    @property
    def link(self) -> bool:
        """Whether the head scores ``query_edges`` pairs."""
        return bool(getattr(self.module.head, "link", False))

    def construct_adj(self, adj: sp.spmatrix, cfg: ModelConfig):
        return GRAPH_OPS[self.graph_op](adj, cfg)


def _mlp(cfg: ModelConfig, feat_dim: int, output_dim: int,
         link: bool = False) -> MultiLayerPerceptron:
    return MultiLayerPerceptron(
        feat_dim=feat_dim,
        hidden_dim=cfg.hidden_dim,
        output_dim=output_dim,
        num_layers=cfg.num_layers,
        dropout=cfg.dropout,
        bn=cfg.use_bn,
        dtype=cfg.dtype,
        link=link,
        edge_mode=cfg.edge_mode,
    )


def _logreg(cfg: ModelConfig, feat_dim: int, output_dim: int,
            link: bool = False) -> LogisticRegression:
    return LogisticRegression(feat_dim, output_dim, link=link, edge_mode=cfg.edge_mode)


def _no_link(name: str, link: bool) -> None:
    if link:
        raise ValueError(f"model {name!r} has no link head (its head scores no query_edges)")


def _spec(name: str, cfg: ModelConfig, aggr_type: str, msg_op: nn.Module,
          head: nn.Module) -> ModelSpec:
    return ModelSpec(name=name, graph_op="sym", aggr_type=aggr_type,
                     prop_steps=cfg.prop_steps,
                     module=PrecomputeModel(msg_op=msg_op, head=head))


def make_sgc(cfg: ModelConfig, feat_dim: int, output_dim: int,
             link: bool = False) -> ModelSpec:
    """SGC: sym norm -> last hop -> logistic regression."""
    return _spec("sgc", cfg, "last", make_message_op("last"),
                 _logreg(cfg, feat_dim, output_dim, link))


def make_ssgc(cfg: ModelConfig, feat_dim: int, output_dim: int,
              link: bool = False) -> ModelSpec:
    """SSGC: mean over hops 0..K -> logistic regression."""
    return _spec("ssgc", cfg, "mean", make_message_op("mean"),
                 _logreg(cfg, feat_dim, output_dim, link))


def make_sign(cfg: ModelConfig, feat_dim: int, output_dim: int,
              link: bool = False) -> ModelSpec:
    """SIGN: per-hop MLP projections, concat, MLP head."""
    msg = ProjectedConcatMessageOp(
        hidden_dim=cfg.hidden_dim, num_layers=cfg.num_layers, feat_dim=feat_dim,
        prop_steps=cfg.prop_steps, dropout=cfg.dropout,
    )
    return _spec("sign", cfg, "proj_concat", msg, _mlp(cfg, msg.out_dim, output_dim, link))


def make_gbp(cfg: ModelConfig, feat_dim: int, output_dim: int,
             link: bool = False) -> ModelSpec:
    """GBP: alpha-decay weighted hops, MLP head."""
    msg = make_message_op("simple_weighted", combination_type="alpha",
                          alpha=cfg.message_alpha)
    return _spec("gbp", cfg, "simple_weighted", msg, _mlp(cfg, feat_dim, output_dim, link))


def make_gamlp(cfg: ModelConfig, feat_dim: int, output_dim: int,
               link: bool = False) -> ModelSpec:
    """GAMLP: JK-style learnable hop attention, MLP head."""
    msg = make_message_op("learnable_weighted", combination_type="jk",
                          prop_steps=cfg.prop_steps, feat_dim=feat_dim)
    return _spec("gamlp", cfg, "learnable_weighted", msg,
                 _mlp(cfg, feat_dim, output_dim, link))


def make_nafs(cfg: ModelConfig, feat_dim: int, output_dim: int,
              link: bool = False) -> ModelSpec:
    """NAFS: over-smoothing-distance hop weights, logistic regression."""
    return _spec("nafs", cfg, "over_smooth_dis_weighted",
                 make_message_op("over_smooth_dis_weighted"),
                 _logreg(cfg, feat_dim, output_dim, link))


def make_gcn(cfg: ModelConfig, feat_dim: int, output_dim: int,
             link: bool = False) -> ModelSpec:
    """Naive GCN: the normalized adjacency rides into the head."""
    return ModelSpec(
        name="gcn", graph_op="sym", naive=True, prop_steps=cfg.prop_steps,
        module=PrecomputeModel(head=Layer2GraphConvolution(
            feat_dim, cfg.hidden_dim, output_dim, dropout=cfg.dropout, link=link)),
    )


def make_clean_train(cfg: ModelConfig, feat_dim: int, output_dim: int,
                     link: bool = False) -> ModelSpec:
    """The augmentation flow's model: a bare FeatureAugment2MLP on the raw
    features, returning ``(hidden, logits)``, which
    :class:`ssrg_torch.train.augment_train.TrainModel` trains."""
    _no_link("clean_train", link)
    return ModelSpec(
        name="clean_train", graph_op=None, prop_steps=0,
        module=PrecomputeModel(head=FeatureAugment2MLP(
            feat_dim, cfg.hidden_dim, output_dim, dropout=cfg.dropout)),
    )


def make_wavelet(cfg: ModelConfig, feat_dim: int, output_dim: int,
                 link: bool = False) -> ModelSpec:
    """Graph-wavelet GWNN: the spectral precompute builds (Φ, Φ⁻¹), which
    ride into the head; ``prepare`` sizes θ to the graph."""
    return ModelSpec(
        name="wavelet", graph_op=None, spectral=True, prop_steps=cfg.prop_steps,
        module=PrecomputeModel(head=Wavelet2NeuralNetwork(
            feat_dim, cfg.hidden_dim, output_dim, dropout=cfg.dropout, link=link)),
    )


def make_magnet(cfg: ModelConfig, feat_dim: int, output_dim: int,
                link: bool = False) -> ModelSpec:
    """Magnetic-Laplacian model: complex propagation, then the complex MLP
    with the magnitude readout on the last (re, im) hop."""
    _no_link("magnet", link)
    return ModelSpec(
        name="magnet", graph_op="magnetic", prop_steps=cfg.prop_steps,
        module=PrecomputeModel(head=ComMLP(feat_dim, cfg.hidden_dim, output_dim,
                                           num_layers=cfg.num_layers, dropout=cfg.dropout)),
    )


def make_two_dir(cfg: ModelConfig, feat_dim: int, output_dim: int,
                 link: bool = False) -> ModelSpec:
    """Directed two-direction model: un/in/out triple propagation, the last
    hop of each concatenated into an MLP."""
    return ModelSpec(name="two_dir", graph_op="two_dir", aggr_type="last",
                     prop_steps=cfg.prop_steps,
                     module=PrecomputeModel(head=_mlp(cfg, 3 * feat_dim, output_dim, link)))


def make_two_order(cfg: ModelConfig, feat_dim: int, output_dim: int,
                   link: bool = False) -> ModelSpec:
    """Two-order PPR-approximation model: first/second-order pair
    propagation, the last hops concatenated into an MLP."""
    return ModelSpec(name="two_order", graph_op="two_order", aggr_type="last",
                     prop_steps=cfg.prop_steps,
                     module=PrecomputeModel(head=_mlp(cfg, 2 * feat_dim, output_dim, link)))


MODEL_REGISTRY: Dict[str, Callable[..., ModelSpec]] = {
    "sgc": make_sgc,
    "ssgc": make_ssgc,
    "sign": make_sign,
    "gbp": make_gbp,
    "gamlp": make_gamlp,
    "nafs": make_nafs,
    "gcn": make_gcn,
    "clean_train": make_clean_train,
    "wavelet": make_wavelet,
    "magnet": make_magnet,
    "two_dir": make_two_dir,
    "two_order": make_two_order,
}


def load_model(cfg: ModelConfig, feat_dim: int, output_dim: int,
               link: bool = False) -> ModelSpec:
    """Factory keyed on ``cfg.model_name``; ``link`` builds the link head,
    for :class:`ssrg_torch.train.LinkClassification`."""
    try:
        ctor = MODEL_REGISTRY[cfg.model_name]
    except KeyError:
        raise ValueError(
            f"unknown model {cfg.model_name!r}; available: {sorted(MODEL_REGISTRY)}"
        ) from None
    return ctor(cfg, feat_dim, output_dim, link=link)
