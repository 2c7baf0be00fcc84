"""The precompute phase of node classification (counterpart of
``ssrg_tpu/train/node_classification.py:46-255``).

``prepare`` normalizes the adjacency on the host, propagates K hops on the
device through the chosen SpMM engine and, when the message op is not
learnable, aggregates the hops once. The locality meta-engines
``reorder_banded`` and ``reorder_tiled`` renumber the graph first (RCM or
label-propagation clusters), propagate on the dense-block engine and put
the hops back in the original node order; ``autotune`` times the engines
and takes the fastest. The training loop (``NodeClassification``) comes
with the training slice (ROADMAP.md).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass

import numpy as np
import torch

from ssrg_torch.cache import cached_propagate
from ssrg_torch.configs.config import ModelConfig, TrainingConfig
from ssrg_torch.models.heads import TRAINING_SLICE
from ssrg_torch.models.zoo import SPECTRAL_SLICE, ModelSpec, PrecomputeModel
from ssrg_torch.utils import DeviceLike, resolve_device

log = logging.getLogger("ssrg_torch")


@dataclass
class Prepared:
    """Result of the precompute phase."""

    module: PrecomputeModel
    inputs: torch.Tensor        # [N, D], or the hop stack [K+1, N, F]
    hops_layout: bool           # True when inputs is the hop stack
    preprocess_seconds: float = 0.0
    # the basic engine name, with the meta-engines resolved ("auto" for
    # reorder_*): what a consumer that packs the adjacency again must use
    engine: str = "auto"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reorder_propagate(engine: str, spec: ModelSpec, adj_norm, x: np.ndarray,
                       model_cfg: ModelConfig, training_cfg: TrainingConfig,
                       dev: torch.device) -> torch.Tensor:
    """The locality meta-engines: renumber the nodes so that the adjacency
    is banded (RCM) or cluster-diagonal (label propagation), propagate on
    the dense-block engine, and take the hops back to the original order.
    A ``ValueError`` of the pack functions (not banded or clustered enough)
    or of the rest's slab guard falls back to the hybrid engine with a
    warning."""
    from ssrg_torch.ops.reorder import apply_permutation, reorder_permutation, reorder_plan

    method, dense_engine, merge_target, engine_kwargs = reorder_plan(
        engine, dev, training_cfg.spmm_bf16, training_cfg.cluster_merge_target)
    perm = reorder_permutation(adj_norm, method, merge_target=merge_target)
    adj_p, x_p, _, inverse = apply_permutation(adj_norm, perm, x)
    tag = (f"{spec.graph_op}:{model_cfg.r}:{method}"
           + (f":mt{merge_target}" if merge_target else "")
           + (":bf16" if training_cfg.spmm_bf16 else ""))
    try:
        hops_p = cached_propagate(adj_p, x_p, spec.prop_steps, training_cfg.cache_dir,
                                  dense_engine, tag=tag, device=dev,
                                  engine_kwargs=engine_kwargs)
    except ValueError as exc:
        log.warning("%s fell back to hybrid: %s", engine, exc)
        return cached_propagate(adj_norm, x, spec.prop_steps, training_cfg.cache_dir,
                                "hybrid", tag=f"{spec.graph_op}:{model_cfg.r}", device=dev)
    return hops_p.index_select(1, torch.as_tensor(inverse, device=dev))


def prepare(
    spec: ModelSpec,
    dataset,
    model_cfg: ModelConfig,
    training_cfg: TrainingConfig,
    device: DeviceLike = "cuda",
) -> Prepared:
    """Run the one-time precompute on ``device``."""
    if not isinstance(spec, ModelSpec):
        raise TypeError(
            f"expected a ModelSpec (from ssrg_torch.models.load_model), got "
            f"{type(spec).__name__}; did you pass the ModelConfig instead?"
        )
    dev = resolve_device(device)
    if spec.naive:
        raise NotImplementedError(f"the naive (in-head adjacency) path: {TRAINING_SLICE}")
    if spec.spectral:
        raise NotImplementedError(f"the spectral path: {SPECTRAL_SLICE}")
    t0 = time.perf_counter()
    x = np.asarray(dataset.x)
    engine = training_cfg.spmm_engine
    if engine == "autotune":
        from ssrg_torch.ops.autotune import autotune_engine

        engine, _ = autotune_engine(dataset.adj, x.shape[1], device=dev)
    is_meta = engine in ("reorder_banded", "reorder_tiled")
    basic_engine = "auto" if is_meta else engine
    adj_norm = spec.construct_adj(dataset.adj, model_cfg)
    if is_meta:
        hops = _reorder_propagate(engine, spec, adj_norm, x, model_cfg, training_cfg, dev)
    else:
        hops = cached_propagate(
            adj_norm, x, spec.prop_steps, training_cfg.cache_dir, engine,
            tag=f"{spec.graph_op}:{model_cfg.r}", device=dev,
        )
    if spec.pre_msg_learnable:
        _sync(dev)
        return Prepared(spec.module, hops, True,
                        preprocess_seconds=time.perf_counter() - t0, engine=basic_engine)

    # aggregate now, once
    msg = spec.module.msg_op
    if msg is not None:
        with torch.no_grad():
            aggregated = msg.to(dev)(hops)
        module = PrecomputeModel(msg_op=None, head=spec.module.head)
    else:
        aggregated, module = hops[-1], spec.module
    _sync(dev)
    return Prepared(module, aggregated, False,
                    preprocess_seconds=time.perf_counter() - t0, engine=basic_engine)


def slice_inputs(prepared: Prepared, idx: torch.Tensor) -> torch.Tensor:
    """The rows of ``prepared.inputs`` for node ids ``idx``, for either
    layout (hop stack ``[K+1, N, F]`` or aggregated ``[N, D]``)."""
    if prepared.hops_layout:
        return prepared.inputs[:, idx]
    return prepared.inputs[idx]
