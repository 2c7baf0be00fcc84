"""The augmentation encoder's trainer (counterpart of
``ssrg_tpu/train/augment_train.py``): :class:`TrainModel` trains a model
whose head returns ``(hidden, logits)`` (``clean_train``'s
FeatureAugment2MLP) on the raw features, full batch, with cross entropy on
the training nodes; the epoch of best validation accuracy gives the
reported test accuracy and the snapshot :meth:`TrainModel.get_mid_dim`
evaluates.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from ssrg_torch.configs.config import ModelConfig, TrainingConfig
from ssrg_torch.models.zoo import ModelSpec
from ssrg_torch.train.common import accuracy, create_train_state, seed_everything
from ssrg_torch.utils import DeviceLike, resolve_device


class TrainModel:
    """Train ``spec``'s encoder on ``dataset.x`` on ``device`` (``cuda`` by
    default)."""

    def __init__(
        self,
        dataset,
        spec: ModelSpec,
        model_cfg: ModelConfig,
        training_cfg: TrainingConfig,
        verbose: bool = False,
        run: bool = True,
        device: DeviceLike = "cuda",
    ):
        self.device = resolve_device(device)
        self.dataset = dataset
        self.spec = spec
        self.cfg = training_cfg
        self.verbose = verbose
        self.module = spec.module

        def ids(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=self.device)

        self.x = torch.as_tensor(np.asarray(dataset.x), dtype=torch.float32, device=self.device)
        self.y = ids(dataset.y)
        self.train_idx, self.val_idx, self.test_idx = (
            ids(dataset.train_idx), ids(dataset.val_idx), ids(dataset.test_idx))
        self.best_val = self.best_test = 0.0
        if run:
            self.execute(training_cfg.seed)

    def execute(self, seed: int = 2023) -> Tuple[float, float]:
        cfg = self.cfg
        generator = seed_everything(seed, self.device)
        module = self.module.cpu()
        module.reset_parameters(torch.Generator().manual_seed(seed))
        module.to(self.device)
        state = create_train_state(module, generator, cfg.lr, cfg.weight_decay)
        best_val = best_test = 0.0
        idx = self.train_idx
        for epoch in range(cfg.num_epochs):
            _, logits = module.train()(self.x)
            loss = F.cross_entropy(logits[idx], self.y[idx])
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            state.apply_gradients()
            with torch.no_grad():
                _, logits = module.eval()(self.x)
                acc_val = float(accuracy(logits[self.val_idx], self.y[self.val_idx]))
                acc_test = float(accuracy(logits[self.test_idx], self.y[self.test_idx]))
            if self.verbose:
                print(f"Epoch {epoch + 1:03d} loss {float(loss):.4f} "
                      f"val {acc_val:.4f} test {acc_test:.4f}")
            if acc_val > best_val:
                best_val, best_test = acc_val, acc_test
                self.best_params = {k: v.detach().clone() for k, v in module.state_dict().items()}
        self.state = state
        self.best_val, self.best_test = best_val, best_test
        return best_val, best_test

    @torch.no_grad()
    def get_mid_dim(self) -> Tuple[np.ndarray, np.ndarray]:
        """The hidden representation and the logits of every node, from the
        best epoch's parameters."""
        mid, logits = functional_call(self.module.eval(), self.best_params, (self.x,))
        return mid.cpu().numpy(), logits.cpu().numpy()
