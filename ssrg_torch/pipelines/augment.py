"""The robust augmentation pipeline: a learned feature repair, then edge
completion (counterpart of ``ssrg_tpu/pipelines/augment.py``).

1. :func:`feature_augment` trains a FeatureAugment2MLP encoder on the
   device, with the reference's protocol: the loss is cross entropy of the
   CLEAN features' logits on the training nodes (with ``l1_weight`` and
   ``sparse_ce_weight``, an L1 term between the sparse and clean logits
   and a cross entropy of the sparse logits join it, from a second forward
   with its own dropout draw); the epoch of best TEST accuracy on the
   SPARSE features is kept; the output is ``[hidden | softmax(logits)]``
   of the sparse features.
2. :func:`edge_augment` gives every node of degree below ``degree_level``
   its missing edges to the nearest (L2, in the augmented features) of
   ``deficit * candidates_per_deficit`` random candidates, then
   symmetrizes and deduplicates. It runs on the host in numpy, with the
   JAX package's draws, so one seed and one feature matrix give the same
   edges in both packages.
3. :func:`augment_dataset` writes the augmented 8-file raw directory.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from ssrg_torch.configs.config import DataAugmentConfig
from ssrg_torch.models.heads import FeatureAugment2MLP
from ssrg_torch.pipelines.sparsify import save_raw_dataset
from ssrg_torch.train.common import accuracy, create_train_state, seed_everything
from ssrg_torch.utils import DeviceLike, resolve_device


def train_feature_encoder(
    module: torch.nn.Module,
    dataset,
    cfg: DataAugmentConfig,
    seed: int = 2023,
    verbose: bool = False,
    device: DeviceLike = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Train ``module`` (which returns ``(hidden, logits)``) from its
    present parameters by :func:`feature_augment`'s protocol; its dropout
    draws from a generator seeded with ``seed``. Returns (augmented
    features ``[N, H + C]``, soft labels ``[N, C]``)."""
    dev = resolve_device(device)

    def tensor(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    x_clean = tensor(dataset.x)
    x_sparse = tensor(dataset.sparse_x) if hasattr(dataset, "sparse_x") else x_clean
    y = tensor(dataset.y, torch.int64)
    train_idx = tensor(dataset.train_idx, torch.int64)
    test_idx = tensor(dataset.test_idx, torch.int64)
    module.to(dev)
    state = create_train_state(module, seed_everything(seed, dev), cfg.lr, cfg.weight_decay)

    best_acc, best_params = -1.0, None
    for _ in range(cfg.epochs):
        module.train()
        _, logits = module(x_clean)
        loss = F.cross_entropy(logits[train_idx], y[train_idx])
        if cfg.l1_weight or cfg.sparse_ce_weight:
            _, sp_logits = module(x_sparse)
            if cfg.l1_weight:
                loss = loss + cfg.l1_weight * (sp_logits[train_idx] - logits[train_idx]).abs().mean()
            if cfg.sparse_ce_weight:
                loss = loss + cfg.sparse_ce_weight * F.cross_entropy(sp_logits[train_idx],
                                                                     y[train_idx])
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.apply_gradients()
        with torch.no_grad():
            _, logits = module.eval()(x_sparse)
            acc = float(accuracy(logits[test_idx], y[test_idx]))
        if acc > best_acc:
            best_acc = acc
            best_params = {k: v.detach().clone() for k, v in module.state_dict().items()}
    if verbose:
        print(f"best_acc: {best_acc:.4f}")

    with torch.no_grad():
        hidden, logits = functional_call(module.eval(), best_params, (x_sparse,))
        soft_label = torch.softmax(logits, dim=1)
        feature = torch.cat([hidden, soft_label], dim=1)
    return feature.cpu().numpy(), soft_label.cpu().numpy()


def feature_augment(
    dataset,
    cfg: DataAugmentConfig,
    seed: int = 2023,
    verbose: bool = False,
    device: DeviceLike = "cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Train the repair encoder (initialized from a CPU generator seeded
    with ``seed``) on ``device``; returns (augmented features ``[N, H +
    C]``, soft labels ``[N, C]``)."""
    module = FeatureAugment2MLP(np.asarray(dataset.x).shape[1], cfg.hidden_dim,
                                dataset.num_classes, dropout=cfg.dropout)
    module.reset_parameters(torch.Generator().manual_seed(seed))
    return train_feature_encoder(module, dataset, cfg, seed, verbose, device)


def edge_augment(
    dataset,
    feature: np.ndarray,
    cfg: DataAugmentConfig,
    seed: int = 2023,
) -> np.ndarray:
    """Low-degree edge completion; returns the symmetric, deduplicated
    edge_index ``[2, E']``. A node's degree counts its occurrences in the
    stored (single-direction) edge list; distances are taken in
    ``feature``'s space."""
    rng = np.random.default_rng(seed)
    row = np.asarray(dataset.edge.row, np.int64)
    col = np.asarray(dataset.edge.col, np.int64)
    n = dataset.x.shape[0]

    deg = np.bincount(np.concatenate([row, col]), minlength=n)
    need = np.where(deg < cfg.degree_level)[0]
    new_pairs = []
    if need.size:
        deficits = (cfg.degree_level - deg[need]).astype(np.int64)
        n_cand = int(deficits.max()) * cfg.candidates_per_deficit
        # candidates per needy node, redrawn where they hit the node itself
        cand = rng.integers(0, n, size=(need.size, n_cand))
        self_hit = cand == need[:, None]
        while self_hit.any():
            cand[self_hit] = rng.integers(0, n, size=int(self_hit.sum()))
            self_hit = cand == need[:, None]
        dist = np.linalg.norm(feature[cand] - feature[need][:, None, :], axis=2)
        order = np.argsort(dist, axis=1)
        for i, node in enumerate(need):
            k = int(deficits[i])
            chosen = cand[i, order[i, :k]]
            new_pairs.append(np.stack([np.full(k, node, np.int64), chosen.astype(np.int64)]))
    edge_index = np.concatenate([np.stack([row, col])] + new_pairs, axis=1)
    mirrored = np.concatenate([edge_index, edge_index[::-1]], axis=1)
    return np.unique(mirrored.T, axis=0).T


def augment_dataset(
    dataset,
    cfg: DataAugmentConfig,
    out_dir: str,
    seed: int = 2023,
    verbose: bool = False,
    device: DeviceLike = "cuda",
) -> str:
    """Feature repair on ``device``, edge completion on the host, then the
    raw directory under ``out_dir``; returns the raw directory."""
    feature, soft_label = feature_augment(dataset, cfg, seed, verbose, device)
    edge_index = edge_augment(dataset, feature, cfg, seed)
    return save_raw_dataset(
        out_dir, feature, edge_index, np.asarray(dataset.y),
        np.asarray(dataset.train_idx), np.asarray(dataset.val_idx),
        np.asarray(dataset.test_idx),
        np.asarray(dataset.feature_mask) if dataset.feature_mask is not None else None,
        np.asarray(dataset.edge_mask) if dataset.edge_mask is not None else None,
    )


def run_augment(args) -> None:
    """The ``ssrg-torch augment`` hook: repair ``--data_name`` under
    ``--data_root`` on ``--device`` into ``{data_save_path}/{data_name}``."""
    from ssrg_torch.data.sparsity import load_homo_simplex_sparsity_dataset

    cfg = DataAugmentConfig(
        data_name=args.data_name, data_root=args.data_root,
        hidden_dim=args.hidden_dim, dropout=args.dropout,
        weight_decay=args.weight_decay, lr=args.lr, epochs=args.epochs,
        degree_level=args.degree_level, data_save_path=args.data_save_path,
    )
    dataset = load_homo_simplex_sparsity_dataset(
        cfg.data_name, cfg.data_root, args.data_split,
        surrogate_features=getattr(args, "surrogate_features", False),
    )
    out = os.path.join(cfg.data_save_path, cfg.data_name)
    raw = augment_dataset(dataset, cfg, out, args.seed, verbose=True, device=args.device)
    print(f"augmented dataset written to {raw}")
