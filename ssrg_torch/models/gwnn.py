"""Standalone GWNN pipeline (counterpart of ``ssrg_tpu/models/gwnn.py``):
the graph wavelet neural network's readers, sparsifier, network and trainer.

- Readers: an edge-list CSV (header row, two id columns) as a symmetric
  adjacency, a ``{node: [feature ids]}`` JSON as dense binary features, a
  ``id,target`` CSV as labels.
- :class:`WaveletSparsifier` builds (Φ, Φ⁻¹) with
  :func:`ssrg_torch.models.wavelet.calculate_wavelets`.
- :class:`GraphWaveletNeuralNetwork`: ``sparse_layer`` (ReLU, dropout) ->
  ``dense_layer`` -> log-softmax.
- :class:`GWNNTrainer`: the reference's train/test split (numpy
  ``default_rng(seed)``, so the same split), Adam with L2 in the gradient
  (:func:`ssrg_torch.train.common.make_optimizer`) on the NLL of the train
  rows, one log entry an epoch, and ``score``. ``fit(scan=True)`` is
  accepted and runs the same epoch loop (the reference's ``lax.scan`` over
  epochs has no eager counterpart).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from ssrg_torch.configs.config import WaveletConfig
from ssrg_torch.models.heads import bind_generator
from ssrg_torch.models.wavelet import GraphWaveletLayer, calculate_wavelets
from ssrg_torch.ops.sparse import differentiable_adjacency
from ssrg_torch.train.common import make_optimizer
from ssrg_torch.utils import DeviceLike, resolve_device


@dataclass
class GWNNConfig:
    """The GWNN sub-project's defaults (``ssrg_tpu/models/gwnn.py:43-55``)."""

    epochs: int = 200
    filters: int = 32
    approximation_order: int = 3
    tolerance: float = 1e-4
    scale: float = 1.0
    dropout: float = 0.5
    learning_rate: float = 0.01
    weight_decay: float = 1e-5
    test_size: float = 0.2
    seed: int = 42


# ---------------------------------------------------------------------------
# Data readers
# ---------------------------------------------------------------------------


def read_edges_csv(path: str) -> sp.csr_matrix:
    """Edge-list CSV (header row, two id columns) -> symmetric 0/1
    adjacency without self-loops."""
    raw = np.genfromtxt(path, delimiter=",", skip_header=1, dtype=np.int64)
    raw = raw.reshape(-1, raw.shape[-1])[:, :2]
    n = int(raw.max()) + 1
    rows = np.concatenate([raw[:, 0], raw[:, 1]])
    cols = np.concatenate([raw[:, 1], raw[:, 0]])
    adj = sp.csr_matrix((np.ones(rows.shape[0], np.float32), (rows, cols)), shape=(n, n))
    adj.data[:] = 1.0
    adj.setdiag(0)
    adj.eliminate_zeros()
    return adj


def read_features_json(path: str, num_nodes: Optional[int] = None) -> np.ndarray:
    """``{node: [active feature ids]}`` JSON -> dense binary float32
    features."""
    with open(path) as f:
        data = json.load(f)
    idx = {int(k): [int(v) for v in vs] for k, vs in data.items()}
    n = num_nodes or (max(idx) + 1)
    f_dim = max((max(v) for v in idx.values() if v), default=0) + 1
    x = np.zeros((n, f_dim), np.float32)
    for node, feats in idx.items():
        x[node, feats] = 1.0
    return x


def read_targets_csv(path: str) -> np.ndarray:
    """``id,target`` CSV (header row) -> int64 labels by id."""
    raw = np.genfromtxt(path, delimiter=",", skip_header=1, dtype=np.int64)
    raw = raw.reshape(-1, raw.shape[-1])
    out = np.zeros(int(raw[:, 0].max()) + 1, np.int64)
    out[raw[:, 0]] = raw[:, 1]
    return out


# ---------------------------------------------------------------------------
# Wavelet sparsifier
# ---------------------------------------------------------------------------


class WaveletSparsifier:
    """The heat-kernel wavelet basis: ``calculate_all_wavelets`` fills
    ``phi_matrices = [Φ, Φ⁻¹]`` (host CSR) and ``stats``."""

    def __init__(self, adj: sp.spmatrix, scale: float, approximation_order: int,
                 tolerance: float, engine: str = "auto", device: DeviceLike = "cuda"):
        self.adj = adj
        self.cfg = WaveletConfig(approximation_order=approximation_order,
                                 tolerance=tolerance, scale=scale)
        self.engine = engine
        self.device = resolve_device(device)
        self.phi_matrices: List[sp.csr_matrix] = []
        self.stats: Dict[str, float] = {}

    def calculate_all_wavelets(self, verbose: bool = False) -> None:
        phi, phi_inv, stats = calculate_wavelets(self.adj, self.cfg, self.engine,
                                                 verbose=verbose, device=self.device)
        self.phi_matrices = [phi, phi_inv]
        self.stats = stats


# ---------------------------------------------------------------------------
# Network and trainer
# ---------------------------------------------------------------------------


class GraphWaveletNeuralNetwork(nn.Module):
    """``sparse_layer`` -> ``dense_layer`` -> log-softmax over classes."""

    def __init__(self, feat_dim: int, filters: int, output_dim: int, num_nodes: int,
                 dropout: float = 0.5):
        super().__init__()
        self.sparse_layer = GraphWaveletLayer(feat_dim, filters, num_nodes, dropout)
        self.dense_layer = GraphWaveletLayer(filters, output_dim, num_nodes, apply_act=False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.sparse_layer.reset_parameters(generator)
        self.dense_layer.reset_parameters(generator)

    def forward(self, x, phi, phi_inv):
        h = self.sparse_layer(x, phi, phi_inv)
        return torch.log_softmax(self.dense_layer(h, phi, phi_inv), dim=1)


class GWNNTrainer:
    """Trains (``fit``) and scores the network on ``device`` (``cuda`` by
    default). Its weights are drawn from a CPU ``torch.Generator`` seeded
    with ``config.seed``, its dropout masks from one on ``device``."""

    def __init__(self, config: GWNNConfig, sparsifier: WaveletSparsifier,
                 features: np.ndarray, targets: np.ndarray, engine: str = "auto",
                 device: DeviceLike = "cuda"):
        self.cfg = config
        self.device = dev = resolve_device(device)
        self.x = torch.as_tensor(np.asarray(features), dtype=torch.float32, device=dev)
        self.y = torch.as_tensor(np.asarray(targets), dtype=torch.int64, device=dev)
        self.num_classes = int(np.asarray(targets).max()) + 1
        phi, phi_inv = sparsifier.phi_matrices
        self.phi = differentiable_adjacency(phi, engine, device=dev)
        self.phi_inv = differentiable_adjacency(phi_inv, engine, device=dev)
        n = features.shape[0]
        self.module = GraphWaveletNeuralNetwork(features.shape[1], config.filters,
                                                self.num_classes, n, config.dropout)
        rng = np.random.default_rng(config.seed)
        perm = rng.permutation(n)
        n_test = int(config.test_size * n)
        self.test_idx = torch.as_tensor(np.sort(perm[:n_test]), device=dev)
        self.train_idx = torch.as_tensor(np.sort(perm[n_test:]), device=dev)
        self.logs: List[Dict] = []

    def fit(self, verbose: bool = False, scan: bool = False) -> None:
        """Adam on the train rows' NLL for ``config.epochs`` epochs, from a
        fresh initialization; one log entry an epoch, its ``seconds`` on the
        host clock. ``scan`` is accepted and runs the same loop."""
        cfg = self.cfg
        module = self.module.cpu()
        module.reset_parameters(torch.Generator().manual_seed(cfg.seed))
        module.to(self.device).train()
        bind_generator(module, torch.Generator(device=self.device).manual_seed(cfg.seed))
        opt = make_optimizer(module.parameters(), cfg.learning_rate, cfg.weight_decay)
        y_train = self.y[self.train_idx]
        for epoch in range(cfg.epochs):
            t0 = time.perf_counter()
            logp = module(self.x, self.phi, self.phi_inv)
            loss = -logp[self.train_idx].gather(1, y_train[:, None]).mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            self.logs.append({"epoch": epoch, "loss": loss.item(),
                              "seconds": time.perf_counter() - t0})
            if verbose:
                print(f"epoch {epoch + 1}: nll {self.logs[-1]['loss']:.4f}")

    @torch.no_grad()
    def score(self) -> float:
        """Test accuracy of the trained network (evaluation mode)."""
        logp = self.module.eval()(self.x, self.phi, self.phi_inv)
        pred = logp[self.test_idx].argmax(dim=1)
        return float((pred == self.y[self.test_idx]).float().mean())
