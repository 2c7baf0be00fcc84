"""Shared training utilities (counterpart of ``ssrg_tpu/train/common.py``):
seeding, metrics, the optimizer, the train state and one training step.

The reference's optimizer is optax ``add_decayed_weights`` then ``adam``,
which is ``torch.optim.Adam(weight_decay=wd)``: the L2 term goes into the
gradient before the moments, eps 1e-8 in both. Its warm-up is optax's
``linear_schedule(0, lr, warmup_epochs)`` read at the update count before
the update, so the first step runs at learning rate 0. ``batch_iterator``
is the reference's, line for line, so one seed gives both packages the same
minibatches.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ssrg_torch.logger import span
from ssrg_torch.models.heads import bind_generator
from ssrg_torch.utils import seed_everything  # noqa: F401  (its home is ssrg_torch.utils)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """argmax accuracy, a float32 scalar tensor."""
    return (logits.argmax(dim=-1) == labels).float().mean()


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean softmax cross entropy; with ``weights``, the weighted sum over
    ``max(sum(weights), 1)`` (padding rows of a minibatch weigh 0)."""
    losses = F.cross_entropy(logits, labels, reduction="none")
    if weights is None:
        return losses.mean()
    return (losses * weights).sum() / torch.clamp_min(weights.sum(), 1.0)


def learning_rate(step: int, lr: float, warmup_epochs: int = 0) -> float:
    """The rate of update number ``step`` (from 0): ``lr``, or with
    ``warmup_epochs`` the linear ramp ``lr * min(step, warmup) / warmup``."""
    if not warmup_epochs:
        return lr
    return lr * min(step, warmup_epochs) / warmup_epochs


def make_optimizer(params, lr: float, weight_decay: float) -> torch.optim.Adam:
    """Adam with L2 added to the gradient before the moment updates."""
    return torch.optim.Adam(params, lr=lr, weight_decay=weight_decay, eps=1e-8)


def split_labels(
    labels: np.ndarray,
    train_per_class: int = 20,
    num_val: int = 500,
    num_test: int = 1000,
    seed: int = 0,
):
    """Random class-balanced split: ``train_per_class`` per class, then
    ``num_val``/``num_test`` from the remainder."""
    rng = np.random.default_rng(seed)
    labels = np.asarray(labels)
    train = []
    for k in np.unique(labels):
        idx_k = np.where(labels == k)[0]
        train.extend(rng.permutation(idx_k)[:train_per_class])
    train = np.sort(np.asarray(train))
    rest = rng.permutation(np.setdiff1d(np.arange(labels.shape[0]), train))
    val = np.sort(rest[:num_val])
    test = np.sort(rest[num_val : num_val + num_test])
    return train, val, test


def add_labels(features: np.ndarray, labels: np.ndarray, idx: np.ndarray,
               num_classes: int) -> np.ndarray:
    """Concat one-hot labels of ``idx`` rows onto the features."""
    onehot = np.zeros((features.shape[0], num_classes), features.dtype)
    onehot[idx, labels[idx]] = 1
    return np.concatenate([features, onehot], axis=-1)


@dataclass
class TrainState:
    """What one training run carries: the module, its optimizer, the
    learning-rate settings, the number of updates taken and the generator
    its dropout draws from."""

    module: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    lr: float
    warmup_epochs: int = 0
    step: int = 0

    def apply_gradients(self) -> None:
        """One optimizer update at this step's learning rate."""
        rate = learning_rate(self.step, self.lr, self.warmup_epochs)
        for group in self.optimizer.param_groups:
            group["lr"] = rate
        self.optimizer.step()
        self.step += 1


def create_train_state(module: nn.Module, generator: torch.Generator, lr: float,
                       weight_decay: float, warmup_epochs: int = 0) -> TrainState:
    """A train state over ``module``'s parameters; its dropout layers draw
    from ``generator``."""
    bind_generator(module, generator)
    return TrainState(module, make_optimizer(module.parameters(), lr, weight_decay),
                      generator, lr, warmup_epochs)


def train_step(state: TrainState, inputs, labels: torch.Tensor,
               weights: Optional[torch.Tensor] = None, idx: Optional[torch.Tensor] = None,
               adj=None, query_edges: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One update on a batch (the reference's jitted ``train_step``): the
    module in training mode, the loss of its logits (rows ``idx`` of a
    full-graph forward when given; a link head's scores of
    ``query_edges``), backward, one optimizer update. Returns the loss,
    detached, on the device (no host sync). The spans ``step.forward``
    (the loss included), ``step.backward`` and ``step.optimizer``."""
    module = state.module.train()
    kwargs = {} if query_edges is None else {"query_edges": query_edges}
    with span("step.forward"):
        logits = module(inputs, **kwargs) if adj is None else module(inputs, adj, **kwargs)
        if idx is not None:
            logits = logits[idx]
        loss = cross_entropy_loss(logits, labels, weights)
    return backward_and_update(state, loss)


def backward_and_update(state: TrainState, loss: torch.Tensor) -> torch.Tensor:
    """The gradients of ``loss`` (the span ``step.backward``, the old
    gradients cleared first) and one optimizer update (``step.optimizer``);
    the loss, detached."""
    with span("step.backward"):
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
    with span("step.optimizer"):
        state.apply_gradients()
    return loss.detach()


def batch_iterator(idx: np.ndarray, batch_size: int, rng: np.random.Generator,
                   shuffle: bool = True):
    """Static-shape minibatch index iterator: shuffles, pads the last batch by
    wrapping, and yields (batch_idx [B], weight [B]) with weight 0 on padding
    so loss/metrics are exact. One compiled shape for all batches."""
    n = idx.shape[0]
    order = rng.permutation(n) if shuffle else np.arange(n)
    shuffled = idx[order]
    num_batches = -(-n // batch_size)
    for b in range(num_batches):
        lo = b * batch_size
        hi = min(lo + batch_size, n)
        batch = shuffled[lo:hi]
        w = np.ones(hi - lo, np.float32)
        if hi - lo < batch_size:
            pad = batch_size - (hi - lo)
            # np.resize wraps cyclically, so padding stays correct even when
            # the whole split is smaller than half a batch (pad > n)
            batch = np.concatenate([batch, np.resize(shuffled, pad)])
            w = np.concatenate([w, np.zeros(pad, np.float32)])
        yield batch, w
