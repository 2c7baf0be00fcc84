"""Serving (counterpart of ``ssrg_tpu/serve.py``): run the precompute once,
then answer node-id batches.

>>> pred = Predictor(ds, spec, mc, tc, params=state_dict)   # on cuda
>>> labels = pred.predict(node_ids)
>>> probs = pred.predict_proba(node_ids)

``params`` is a state dict of the model: ``PrecomputeModel.state_dict()``,
or :func:`ssrg_torch.convert.params_from_jax` of a flax parameter tree.
Reading flax msgpack checkpoints comes with the training slice
(ROADMAP.md).
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ssrg_torch.configs.config import ModelConfig, TrainingConfig
from ssrg_torch.models.zoo import ModelSpec
from ssrg_torch.train.node_classification import prepare, slice_inputs
from ssrg_torch.utils import DeviceLike, resolve_device


class Predictor:
    """Node-classification inference on ``device`` (``cuda`` by default).

    Without ``params`` the model keeps its own initialization."""

    def __init__(
        self,
        dataset,
        spec: ModelSpec,
        model_cfg: ModelConfig,
        training_cfg: Optional[TrainingConfig] = None,
        params: Optional[Mapping] = None,
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        self.prepared = prepare(spec, dataset, model_cfg,
                                training_cfg or TrainingConfig(), device=self.device)
        self.module = self.prepared.module.to(self.device).eval()
        if params is not None:
            self.module.load_state_dict(params, strict=True)
        self.num_nodes = int(self.prepared.inputs.shape[-2])

    @torch.no_grad()
    def logits(self, node_ids) -> torch.Tensor:
        ids = np.asarray(
            node_ids.cpu() if torch.is_tensor(node_ids) else node_ids
        ).reshape(-1).astype(np.int64)
        if ids.size and (ids.min() < 0 or ids.max() >= self.num_nodes):
            raise IndexError(f"node ids must lie in [0, {self.num_nodes})")
        idx = torch.as_tensor(ids, device=self.device)
        return self.module(slice_inputs(self.prepared, idx))

    def predict_proba(self, node_ids) -> torch.Tensor:
        return torch.softmax(self.logits(node_ids), dim=-1)

    def predict(self, node_ids) -> torch.Tensor:
        return torch.argmax(self.logits(node_ids), dim=-1)
