"""Link classification (counterpart of
``ssrg_tpu/train/link_classification.py``).

The dataset's adjacency is replaced by the observed edges
(``observed_edge_idx``/``observed_edge_weight``), ``prepare`` runs as for
node classification, and the head (a link head, ``load_model(...,
link=True)``) scores the ``query_edges`` pairs of each split. The
reference's protocol: best validation accuracy selects the reported test
accuracy, ``normalize_times`` runs each re-initialized from ``seed + i``
(their mean reported), full-batch or minibatch training over the training
pairs (the reference's ``batch_iterator``: shuffled, the last batch padded
with pairs that weigh 0). A batch is a slice of the pairs: the node inputs
stay on the device whole. Validation and test each take their own forward.
The reference's ``scan_epochs`` (all epochs in one ``lax.scan``) is
accepted and runs the same epoch loop.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ssrg_torch.configs.config import ModelConfig, TrainingConfig
from ssrg_torch.models.zoo import ModelSpec
from ssrg_torch.train.common import (
    TrainState,
    accuracy,
    batch_iterator,
    create_train_state,
    seed_everything,
    train_step,
)
from ssrg_torch.train.node_classification import prepare
from ssrg_torch.utils import DeviceLike, resolve_device

SPLITS = ("train", "val", "test")


class LinkClassification:
    """Train and evaluate a link head on ``device`` (``cuda`` by default).
    After a run, ``state`` holds the
    :class:`~ssrg_torch.train.common.TrainState` and ``history`` the
    per-epoch ``loss``, ``val_acc`` and ``test_acc`` of the last run."""

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
        if not spec.link:
            raise ValueError(f"model {spec.name!r} has a node head; build it with "
                             "load_model(..., link=True) to score query_edges")
        self.device = resolve_device(device)
        self.dataset = dataset
        self.spec = spec
        self.model_cfg = model_cfg
        self.cfg = training_cfg
        self.verbose = verbose
        self.record = {"val_acc": [], "test_acc": []}
        self.history: dict = {}
        self.state: Optional[TrainState] = None

        n = dataset.num_node
        dataset.adj = sp.csr_matrix(
            (dataset.observed_edge_weight,
             (dataset.observed_edge_idx[0], dataset.observed_edge_idx[1])),
            shape=(n, n),
        )
        self.pairs = {
            split: tuple(torch.as_tensor(np.asarray(getattr(dataset, f"{split}_edge_pairs_{k}")),
                                         dtype=torch.int64, device=self.device)
                         for k in ("idx", "label"))
            for split in SPLITS
        }
        self.prepared = prepare(spec, dataset, model_cfg, training_cfg, device=self.device)
        if run:
            for i in range(training_cfg.normalize_times):
                self.execute(seed=training_cfg.seed + i)

    @property
    def best_val(self) -> float:
        return float(np.mean(self.record["val_acc"]))

    @property
    def best_test(self) -> float:
        return float(np.mean(self.record["test_acc"]))

    def get_test_acc(self) -> float:
        return self.best_test

    def _step(self, state: TrainState, pairs: torch.Tensor, labels: torch.Tensor,
              weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        p = self.prepared
        return train_step(state, p.inputs, labels, weights, adj=p.adj_device, query_edges=pairs)

    @torch.no_grad()
    def logits(self, state: TrainState, pairs: torch.Tensor) -> torch.Tensor:
        """Evaluation-mode scores of the pairs ``[B, 2]``."""
        p = self.prepared
        module = state.module.eval()
        if p.adj_device is None:
            return module(p.inputs, query_edges=pairs)
        return module(p.inputs, p.adj_device, query_edges=pairs)

    def evaluate(self, state: TrainState) -> Tuple[torch.Tensor, torch.Tensor]:
        """Validation and test accuracy, as device scalars: one forward
        each."""
        return tuple(accuracy(self.logits(state, pairs), labels)
                     for pairs, labels in (self.pairs["val"], self.pairs["test"]))

    def train_epoch(self, state: TrainState, np_rng: np.random.Generator) -> torch.Tensor:
        """One epoch: a full-batch step over the training pairs, or the
        reference's minibatches of them. Returns the mean loss on the
        device."""
        pairs, labels = self.pairs["train"]
        if self.cfg.train_batch_size is None:
            return self._step(state, pairs, labels)
        losses = []
        for batch, w in batch_iterator(np.arange(pairs.shape[0]), self.cfg.train_batch_size,
                                       np_rng):
            b = torch.as_tensor(batch, device=self.device)
            losses.append(self._step(state, pairs[b], labels[b],
                                     torch.as_tensor(w, device=self.device)))
        return torch.stack(losses).mean()

    def execute(self, seed: int = 2023) -> Tuple[float, float]:
        """One training run from a fresh initialization drawn with ``seed``."""
        cfg = self.cfg
        generator = seed_everything(seed, self.device)
        np_rng = np.random.default_rng(seed)
        # initialized on the host from a CPU generator: one seed, one
        # initialization, whatever the device
        module = self.prepared.module.cpu()
        module.reset_parameters(torch.Generator().manual_seed(seed))
        module.to(self.device)
        state = create_train_state(module, generator, cfg.lr, cfg.weight_decay,
                                   cfg.warmup_epochs)
        best_val = best_test = 0.0
        history = []
        for epoch in range(cfg.num_epochs):
            loss = self.train_epoch(state, np_rng)
            acc_val, acc_test = (float(a) for a in self.evaluate(state))
            history.append((loss, acc_val, acc_test))
            if self.verbose:
                print(f"Epoch {epoch + 1:03d} loss {float(loss):.4f} "
                      f"val {acc_val:.4f} test {acc_test:.4f}")
            if acc_val > best_val:
                best_val, best_test = acc_val, acc_test
        self.history = {"loss": torch.stack([h[0] for h in history]).tolist() if history else [],
                        "val_acc": [h[1] for h in history], "test_acc": [h[2] for h in history]}
        self.record["val_acc"].append(best_val)
        self.record["test_acc"].append(best_test)
        self.state = state
        return best_val, best_test
