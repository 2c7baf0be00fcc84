"""Message operators (counterpart of ``ssrg_tpu/ops/combine.py``).

Every combiner takes the hop stack ``hops`` ``[K+1, n, F]`` and returns
``[n, D]``. Unlearnable combiners are plain tensor functions wrapped in
parameter-free modules; learnable ones are ``nn.Module``s whose submodule
and parameter names are the flax names (``gate``, ``ori_ref``, ``jk``,
``recursive_gate``, ``proj_<i>``, ``hop_weight``), so that
:func:`ssrg_torch.convert.params_from_jax` maps a flax tree onto them.

flax infers input widths at the first call; torch modules are built with
them, so the learnable ops take ``feat_dim`` and ``prop_steps`` where the
widths depend on them. As in the reference, ``ori_ref``/``jk`` read the
scores hop-major (``[K, n] -> [n, K]``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ssrg_torch.utils import init_dense_, variance_scaling_

LEARNABLE_AGGR_TYPES = frozenset(
    {"proj_concat", "learnable_weighted", "iterate_learnable_weighted"}
)


def _slice_hops(hops: torch.Tensor, start: Optional[int], end: Optional[int]):
    return hops[slice(start, end)]


def _num_sliced(num_hops: int, start: Optional[int], end: Optional[int]) -> int:
    return len(range(num_hops)[slice(start, end)])


# ---------------------------------------------------------------------------
# Unlearnable combiners
# ---------------------------------------------------------------------------


def combine_last(hops, start=None, end=None):
    return _slice_hops(hops, start, end)[-1]


def combine_sum(hops, start=None, end=None):
    return _slice_hops(hops, start, end).sum(dim=0)


def combine_mean(hops, start=None, end=None):
    return _slice_hops(hops, start, end).mean(dim=0)


def combine_max(hops, start=None, end=None):
    return _slice_hops(hops, start, end).amax(dim=0)


def combine_min(hops, start=None, end=None):
    return _slice_hops(hops, start, end).amin(dim=0)


def combine_concat(hops, start=None, end=None):
    """Hop-order feature concat ``[X_s | X_{s+1} | ...]``."""
    h = _slice_hops(hops, start, end)
    k, n, f = h.shape
    return h.permute(1, 0, 2).reshape(n, k * f)


def alpha_decay_weights(num_hops: int, alpha: float,
                        device: Optional[torch.device] = None) -> torch.Tensor:
    """GBP weights ``w_k = alpha * (1-alpha)^k``."""
    k = torch.arange(num_hops, dtype=torch.float32, device=device)
    return alpha * (1.0 - alpha) ** k


def combine_weighted(hops, weights):
    """Scalar-per-hop weighted sum ``sum_k w_k * H_k``."""
    return torch.einsum("k,knf->nf", weights, hops)


def combine_node_weighted(hops, weights):
    """Per-node weighted sum: weights ``[n, K]``, hops ``[K, n, F]``."""
    return torch.einsum("nk,knf->nf", weights, hops)


def combine_over_smooth(hops, start=None, end=None, eps: float = 1e-10):
    """NAFS weights: per node, the cosine of each hop to hop 0, softmax
    over hops, weighted sum."""
    h = _slice_hops(hops, start, end)
    ref = h[0]
    ref_norm = torch.linalg.vector_norm(ref, dim=1) + eps          # [n]
    hop_norm = torch.linalg.vector_norm(h, dim=2) + eps            # [K, n]
    cos = torch.einsum("nf,knf->kn", ref, h) / (hop_norm * ref_norm[None, :])
    w = torch.softmax(cos.T, dim=1)                                # [n, K]
    return combine_node_weighted(h, w)


_SIMPLE_FNS = {
    "last": combine_last,
    "sum": combine_sum,
    "mean": combine_mean,
    "max": combine_max,
    "min": combine_min,
    "concat": combine_concat,
    "over_smooth": combine_over_smooth,
}


class SimpleMessageOp(nn.Module):
    """Parameter-free combiner; ``kind`` selects the function."""

    def __init__(self, kind: str, start: Optional[int] = None,
                 end: Optional[int] = None):
        super().__init__()
        if kind not in _SIMPLE_FNS:
            raise ValueError(f"unknown combiner kind {kind!r}")
        self.kind, self.start, self.end = kind, start, end

    def forward(self, hops):
        return _SIMPLE_FNS[self.kind](hops, self.start, self.end)

    def reset_parameters(self, generator=None) -> None:
        pass


class SimpleWeightedMessageOp(nn.Module):
    """Fixed-weight combiner: alpha-geometric decay (GBP) or hand-crafted
    weights."""

    def __init__(self, start: Optional[int] = None, end: Optional[int] = None,
                 combination_type: str = "alpha", alpha: float = 0.5,
                 weight_list: Optional[Sequence[float]] = None):
        super().__init__()
        if combination_type not in ("alpha", "hand_crafted"):
            raise ValueError(combination_type)
        self.start, self.end = start, end
        self.combination_type, self.alpha = combination_type, alpha
        self.weight_list = weight_list

    def forward(self, hops):
        if self.combination_type == "alpha":
            w = alpha_decay_weights(hops.shape[0], self.alpha, hops.device)
        else:
            w = torch.as_tensor(self.weight_list, dtype=torch.float32,
                                device=hops.device)
        w = w[slice(self.start, self.end)]
        return combine_weighted(_slice_hops(hops, self.start, self.end), w)

    def reset_parameters(self, generator=None) -> None:
        pass


def _hop_softmax(score: torch.Tensor) -> torch.Tensor:
    """``[K, n, 1]`` scores -> ``[n, K]`` weights: softmax over hops of
    the sigmoid, read hop-major."""
    return torch.softmax(torch.sigmoid(score[..., 0]).T, dim=1)


class LearnableWeightedMessageOp(nn.Module):
    """Five trainable hop weightings:

    - ``simple``           softmax(sigmoid(w_k)), one scalar per hop
    - ``simple_allow_neg`` the raw scalar per hop
    - ``gate``             a per-node Linear(F -> 1) score per hop
    - ``ori_ref``          a score of ``[H_0 | H_k]`` per (node, hop)
    - ``jk``               a score of ``[concat of all hops | H_k]`` (GAMLP)

    ``simple*`` and ``jk`` need ``prop_steps``; ``gate``, ``ori_ref`` and
    ``jk`` need ``feat_dim``.
    """

    def __init__(self, combination_type: str, prop_steps: Optional[int] = None,
                 feat_dim: Optional[int] = None, start: Optional[int] = None,
                 end: Optional[int] = None):
        super().__init__()
        self.combination_type = ct = combination_type
        self.start, self.end = start, end
        if ct in ("simple", "simple_allow_neg", "jk") and prop_steps is None:
            raise ValueError(f"combination_type {ct!r} needs prop_steps")
        if ct in ("gate", "ori_ref", "jk") and feat_dim is None:
            raise ValueError(f"combination_type {ct!r} needs feat_dim")
        if ct in ("simple", "simple_allow_neg"):
            self.hop_weight = nn.Parameter(torch.empty(1, prop_steps + 1))
        elif ct == "gate":
            self.gate = nn.Linear(feat_dim, 1)
        elif ct == "ori_ref":
            self.ori_ref = nn.Linear(2 * feat_dim, 1)
        elif ct == "jk":
            self.jk = nn.Linear((prop_steps + 2) * feat_dim, 1)
        else:
            raise ValueError(f"unknown combination_type {ct!r}")
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        ct = self.combination_type
        if ct in ("simple", "simple_allow_neg"):
            # flax xavier_normal on a (1, steps) kernel: fan_in 1, fan_out steps
            variance_scaling_(self.hop_weight, 1.0, "fan_avg", "truncated_normal",
                              fan_in=1, fan_out=self.hop_weight.shape[1],
                              generator=generator)
        else:
            init_dense_(getattr(self, ct), generator=generator)

    def forward(self, hops):
        h = _slice_hops(hops, self.start, self.end)
        k, n, f = h.shape
        ct = self.combination_type
        if ct in ("simple", "simple_allow_neg"):
            w_param = self.hop_weight.reshape(-1)[slice(self.start, self.end)]
            w = torch.softmax(torch.sigmoid(w_param), dim=0) if ct == "simple" else w_param
            return combine_weighted(h, w)
        if ct == "gate":
            return combine_node_weighted(h, _hop_softmax(self.gate(h)))
        if ct == "ori_ref":
            ref = h[0][None].expand(k, n, f)
            score = self.ori_ref(torch.cat([ref, h], dim=-1))
            return combine_node_weighted(h, _hop_softmax(score))
        all_cat = combine_concat(hops)                              # [n, (K+1)F]
        ref = all_cat[None].expand(k, n, all_cat.shape[1])
        score = self.jk(torch.cat([ref, h], dim=-1))
        return combine_node_weighted(h, _hop_softmax(score))


class IterateLearnableWeightedMessageOp(nn.Module):
    """Recursive gating: fold the hops in one at a time, re-softmaxing the
    weight vector at each step."""

    def __init__(self, feat_dim: int, start: Optional[int] = None,
                 end: Optional[int] = None):
        super().__init__()
        self.start, self.end = start, end
        self.recursive_gate = nn.Linear(2 * feat_dim, 1)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        init_dense_(self.recursive_gate, generator=generator)

    def forward(self, hops):
        h = _slice_hops(hops, self.start, self.end)
        weighted = h[0]
        weights = None
        for i in range(h.shape[0]):
            s = torch.sigmoid(self.recursive_gate(torch.cat([h[i], weighted], dim=-1)))
            weights = s if i == 0 else torch.cat([weights, s], dim=1)
            weights = torch.softmax(weights, dim=1)
            weighted = combine_node_weighted(h[: i + 1], weights)
        return weighted


class ProjectedConcatMessageOp(nn.Module):
    """SIGN: a per-hop MLP projection, then concat. Hop 0's projection is
    taken raw, later hops pass through relu."""

    def __init__(self, hidden_dim: int, num_layers: int, feat_dim: int,
                 prop_steps: int, dropout: float = 0.5,
                 start: Optional[int] = None, end: Optional[int] = None):
        super().__init__()
        from ssrg_torch.models.heads import MultiLayerPerceptron

        self.start, self.end = start, end
        self.num_hops = _num_sliced(prop_steps + 1, start, end)
        for i in range(self.num_hops):
            self.add_module(f"proj_{i}", MultiLayerPerceptron(
                feat_dim=feat_dim, hidden_dim=hidden_dim, output_dim=hidden_dim,
                num_layers=num_layers, dropout=dropout,
            ))

    @property
    def out_dim(self) -> int:
        return self.num_hops * self.proj_0.output_dim

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for i in range(self.num_hops):
            getattr(self, f"proj_{i}").reset_parameters(generator)

    def forward(self, hops):
        h = _slice_hops(hops, self.start, self.end)
        outs = []
        for i in range(h.shape[0]):
            proj = getattr(self, f"proj_{i}")(h[i])
            outs.append(proj if i == 0 else torch.relu(proj))
        return torch.cat(outs, dim=-1)


def combine_multi_last(hop_stacks, start=None, end=None):
    """``combine_last`` of each stack of a tuple of hop stacks (the
    two_dir and two_order models' per-adjacency readout)."""
    return tuple(combine_last(h, start, end) for h in hop_stacks)


def combine_complex(re_hops, im_hops, fn=combine_last, **kwargs):
    """Apply the combiner ``fn`` to the real and the imaginary hop stacks
    of a magnetic propagation; returns the pair."""
    return fn(re_hops, **kwargs), fn(im_hops, **kwargs)


def make_message_op(aggr_type: str, **kwargs) -> nn.Module:
    """Build a message op by the reference's ``aggr_type`` string."""
    simple = {
        "last": "last",
        "sum": "sum",
        "mean": "mean",
        "max": "max",
        "min": "min",
        "concat": "concat",
        "over_smooth_dis_weighted": "over_smooth",
    }
    if aggr_type in simple:
        return SimpleMessageOp(kind=simple[aggr_type], **kwargs)
    if aggr_type == "simple_weighted":
        return SimpleWeightedMessageOp(**kwargs)
    if aggr_type == "learnable_weighted":
        return LearnableWeightedMessageOp(**kwargs)
    if aggr_type == "iterate_learnable_weighted":
        return IterateLearnableWeightedMessageOp(**kwargs)
    if aggr_type == "proj_concat":
        return ProjectedConcatMessageOp(**kwargs)
    raise ValueError(f"unknown aggr_type {aggr_type!r}")
