"""The graph sparsification pipeline (counterpart of
``ssrg_tpu/pipelines/sparsify.py``): a Bernoulli keep-mask over the
features (an entry survives when its draw exceeds the rate), random
deletion of a share of the ``col > row`` half of the edge list, and the
8-file raw ``.pt`` directory that
:class:`~ssrg_torch.data.sparsity.SparsityDataset` reads.

Host-only numpy. The draws are the JAX package's, from one
``np.random.default_rng(seed)`` in the same order, so one seed gives the
same masks and edges in both packages.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Tuple

import numpy as np


def feature_masked(x: np.ndarray, rate: float,
                   rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """(keep-mask int64 ``[N, F]``, 1 where ``uniform > rate``; the
    features as float32, unchanged)."""
    mask = (rng.uniform(size=x.shape) > rate).astype(np.int64)
    return mask, x.astype(np.float32)


def edge_masked(
    row: np.ndarray, col: np.ndarray, shading_rate: float,
    rng: np.random.Generator,
    labels: np.ndarray = None,
    target_heterophilous: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Keep the ``col > row`` half of the edge list and delete
    ``int(shading_rate * E_half)`` of it at random. With
    ``target_heterophilous`` (and ``labels``) the edges whose endpoints'
    labels differ go first, in random order, then the others. Returns (the
    surviving half-edges' positions in the half list, in random order; the
    half-directed edge_index ``[2, E']``)."""
    half = col > row
    row_h, col_h = row[half], col[half]
    e = row_h.shape[0]
    need_delete = int(e * shading_rate)
    if target_heterophilous and labels is not None and need_delete:
        hetero = np.where(labels[row_h] != labels[col_h])[0]
        homo = np.setdiff1d(np.arange(e), hetero)
        order = np.concatenate([rng.permutation(hetero), rng.permutation(homo)])
        mask = rng.permutation(np.setdiff1d(np.arange(e), order[:need_delete]))
    else:
        mask = rng.permutation(e)[need_delete:]
    return mask, np.stack([row_h[mask], col_h[mask]])


def save_raw_dataset(
    out_dir: str,
    feature: np.ndarray,
    edge_index: np.ndarray,
    label: np.ndarray,
    train_idx: np.ndarray,
    val_idx: np.ndarray,
    test_idx: np.ndarray,
    feature_mask,
    edge_mask,
) -> str:
    """Write the 8-file raw schema into ``out_dir/raw`` with
    ``torch.save`` (a missing mask as an empty tensor), so that either
    package and the reference read the directory. Returns the raw
    directory."""
    import torch

    raw = osp.join(out_dir, "raw")
    os.makedirs(raw, exist_ok=True)

    def t(arr):
        return torch.from_numpy(np.ascontiguousarray(arr).copy())

    blobs = {
        "feature.pt": t(feature),
        "edge_index.pt": t(edge_index),
        "label.pt": t(label),
        "train_idx.pt": t(train_idx),
        "val_idx.pt": t(val_idx),
        "test_idx.pt": t(test_idx),
        "feature_mask.pt": t(feature_mask) if feature_mask is not None else torch.zeros(0),
        "edge_mask.pt": t(edge_mask) if edge_mask is not None else torch.zeros(0),
    }
    for name, tensor in blobs.items():
        torch.save(tensor, osp.join(raw, name))
    return raw


def sparsify_dataset(
    dataset,
    feature_rate: float,
    edge_rate: float,
    out_dir: str,
    seed: int = 2023,
) -> str:
    """Mask the features, delete edges and write the raw directory.
    ``dataset`` exposes ``x, y, adj, train_idx, val_idx, test_idx``."""
    rng = np.random.default_rng(seed)
    feature_mask, feature = feature_masked(dataset.x, feature_rate, rng)
    coo = dataset.adj.tocoo()
    edge_mask, edge_index = edge_masked(coo.row, coo.col, edge_rate, rng)
    return save_raw_dataset(
        out_dir, feature, edge_index, dataset.y,
        np.asarray(dataset.train_idx), np.asarray(dataset.val_idx),
        np.asarray(dataset.test_idx), feature_mask, edge_mask,
    )


def run_sparsify(args) -> None:
    """The ``ssrg-torch sparsify`` hook: the SBM of ``planetoid_like`` for
    ``--synthetic`` or a dataset name starting with ``sbm``, else the named
    dataset's augmented ``.pt`` files; writes ``{out_root}/{name}_{fr}_{er}``."""
    if getattr(args, "synthetic", False) or args.dataset.startswith("sbm"):
        from ssrg_torch.data.synthetic import planetoid_like

        dataset = planetoid_like(seed=args.seed)
        name = "sbm"
    else:
        from ssrg_torch.data.sparsity import load_homo_simplex_sparsity_dataset

        dataset = load_homo_simplex_sparsity_dataset(
            args.dataset, args.dataroot, "official", is_augumented=True)
        name = args.dataset
    fr, er = args.sparse_rate
    out = osp.join(args.out_root, f"{name}_{fr}_{er}")
    raw = sparsify_dataset(dataset, fr, er, out, args.seed)
    print(f"sparsified dataset written to {raw}")
