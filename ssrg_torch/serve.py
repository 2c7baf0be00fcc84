"""Serving (counterpart of ``ssrg_tpu/serve.py``): run the precompute once,
then answer node-id batches.

>>> task = NodeClassification(ds, spec, mc, tc)                  # writes tc.checkpoint_path
>>> pred = Predictor(ds, spec, mc, tc, checkpoint_path=tc.checkpoint_path)
>>> labels = pred.predict(node_ids)
>>> probs = pred.predict_proba(node_ids)

``checkpoint_path`` is a checkpoint of either package (flax msgpack and its
``.json`` sidecar); ``params`` a state dict of the model
(``PrecomputeModel.state_dict()``, or
:func:`ssrg_torch.convert.params_from_jax` of a flax parameter tree).
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ssrg_torch.configs.config import ModelConfig, TrainingConfig
from ssrg_torch.logger import count, span
from ssrg_torch.models.zoo import ModelSpec
from ssrg_torch.train.node_classification import load_checkpoint, prepare, slice_inputs
from ssrg_torch.utils import DeviceLike, resolve_device


class Predictor:
    """Node-classification inference on ``device`` (``cuda`` by default).

    Without ``params`` or ``checkpoint_path`` the model keeps its own
    initialization. A model with BatchNorm needs a checkpoint that holds its
    statistics (``ValueError`` otherwise, as in the reference). A naive
    model (GCN) or a spectral one (wavelet, on (Φ, Φ⁻¹)) runs on the whole
    graph and selects the asked rows; a complex model (magnet) takes the
    rows of its ``(re, im)`` pair."""

    def __init__(
        self,
        dataset,
        spec: ModelSpec,
        model_cfg: ModelConfig,
        training_cfg: Optional[TrainingConfig] = None,
        checkpoint_path: Optional[str] = None,
        params: Optional[Mapping] = None,
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        self.prepared = prepare(spec, dataset, model_cfg,
                                training_cfg or TrainingConfig(), device=self.device)
        self.module = self.prepared.module.to(self.device).eval()
        self.metadata = None
        if checkpoint_path:
            self.metadata = load_checkpoint(self.module, checkpoint_path)
        if params is not None:
            self.module.load_state_dict(params, strict=True)
        inputs = self.prepared.inputs
        self.num_nodes = int((inputs[0] if isinstance(inputs, tuple) else inputs).shape[-2])

    @torch.no_grad()
    def logits(self, node_ids) -> torch.Tensor:
        """The logits of ``node_ids``: the span ``serve.request`` around
        ``serve.ids`` (the ids checked and copied to the device) and
        ``serve.forward``; ``serve.rows`` counts the ids."""
        with span("serve.request"):
            with span("serve.ids"):
                ids = np.asarray(
                    node_ids.cpu() if torch.is_tensor(node_ids) else node_ids
                ).reshape(-1).astype(np.int64)
                count("serve.rows", int(ids.size))
                if ids.size and (ids.min() < 0 or ids.max() >= self.num_nodes):
                    raise IndexError(f"node ids must lie in [0, {self.num_nodes})")
                idx = torch.as_tensor(ids, device=self.device)
            with span("serve.forward"):
                p = self.prepared
                if p.adj_device is not None:
                    return self.module(p.inputs, p.adj_device)[idx]
                return self.module(slice_inputs(p, idx))

    def predict_proba(self, node_ids) -> torch.Tensor:
        return torch.softmax(self.logits(node_ids), dim=-1)

    def predict(self, node_ids) -> torch.Tensor:
        return torch.argmax(self.logits(node_ids), dim=-1)
