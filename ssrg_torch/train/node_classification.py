"""The precompute phase of node classification (counterpart of
``ssrg_tpu/train/node_classification.py:46-255``).

``prepare`` normalizes the adjacency on the host, propagates K hops on the
device through the chosen SpMM engine and, when the message op is not
learnable, aggregates the hops once. The training loop
(``NodeClassification``) comes with the training slice (ROADMAP.md).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ssrg_torch.cache import cached_propagate
from ssrg_torch.configs.config import ModelConfig, TrainingConfig
from ssrg_torch.models.heads import TRAINING_SLICE
from ssrg_torch.models.zoo import SPECTRAL_SLICE, ModelSpec, PrecomputeModel
from ssrg_torch.ops.sparse import LOCALITY_TIER
from ssrg_torch.utils import DeviceLike, resolve_device

_META_ENGINES = ("autotune", "reorder_banded", "reorder_tiled")


@dataclass
class Prepared:
    """Result of the precompute phase."""

    module: PrecomputeModel
    inputs: torch.Tensor        # [N, D], or the hop stack [K+1, N, F]
    hops_layout: bool           # True when inputs is the hop stack
    preprocess_seconds: float = 0.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
    engine = training_cfg.spmm_engine
    if engine in _META_ENGINES:
        raise NotImplementedError(
            f"spmm_engine {engine!r} is not ported yet: {LOCALITY_TIER}"
        )
    if spec.naive:
        raise NotImplementedError(f"the naive (in-head adjacency) path: {TRAINING_SLICE}")
    if spec.spectral:
        raise NotImplementedError(f"the spectral path: {SPECTRAL_SLICE}")
    t0 = time.perf_counter()
    adj_norm = spec.construct_adj(dataset.adj, model_cfg)
    hops = cached_propagate(
        adj_norm, np.asarray(dataset.x), spec.prop_steps,
        training_cfg.cache_dir, engine,
        tag=f"{spec.graph_op}:{model_cfg.r}", device=dev,
    )
    if spec.pre_msg_learnable:
        _sync(dev)
        return Prepared(spec.module, hops, True,
                        preprocess_seconds=time.perf_counter() - t0)

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
                    preprocess_seconds=time.perf_counter() - t0)


def slice_inputs(prepared: Prepared, idx: torch.Tensor) -> torch.Tensor:
    """The rows of ``prepared.inputs`` for node ids ``idx``, for either
    layout (hop stack ``[K+1, N, F]`` or aggregated ``[N, D]``)."""
    if prepared.hops_layout:
        return prepared.inputs[:, idx]
    return prepared.inputs[idx]
