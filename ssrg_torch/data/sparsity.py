"""Sparsity datasets over the 8-file ``.pt`` raw schema (counterpart of
``ssrg_tpu/data/sparsity.py``).

A raw directory holds ``feature.pt, edge_index.pt, label.pt, train_idx.pt,
val_idx.pt, test_idx.pt, feature_mask.pt, edge_mask.pt``, as
:func:`ssrg_torch.pipelines.sparsify.save_raw_dataset` (or either
package's pipeline, or the reference's) writes them. ``process()`` builds
the :class:`~ssrg_torch.data.graph.Graph` (the stored edge list may hold
one direction of each edge; ``.adj`` is symmetric), the official split is
the stored index tensors, and the three homophily statistics are computed
at load.

The files are read with ``torch.load(weights_only=True)``, which builds
tensors and plain containers only, with Python's ``range`` admitted: the
reference stores Planetoid split indices as ``range`` objects.
"""

from __future__ import annotations

import os.path as osp
from typing import Optional

import numpy as np

from ssrg_torch.data.base_dataset import NodeDataset
from ssrg_torch.data.graph import Graph
from ssrg_torch.data.utils import edge_homophily, linkx_homophily, node_homophily

RAW_FILES = [
    "feature.pt",
    "edge_index.pt",
    "label.pt",
    "train_idx.pt",
    "val_idx.pt",
    "test_idx.pt",
    "feature_mask.pt",
    "edge_mask.pt",
]


def _to_numpy(obj, dtype=None):
    """A tensor, ``range``, list or array as a numpy array."""
    if isinstance(obj, range):
        arr = np.asarray(list(obj))
    elif hasattr(obj, "numpy"):
        arr = obj.detach().cpu().numpy()
    else:
        arr = np.asarray(obj)
    return arr.astype(dtype) if dtype is not None else arr


def _torch_load(path: str):
    import torch

    with torch.serialization.safe_globals([range]):
        return torch.load(path, map_location="cpu", weights_only=True)


class SparsityDataset(NodeDataset):
    """A node dataset over a sparsified (or augmented) raw directory.

    ``is_augumented=True`` reads no masks (an augmented directory's
    features are the repaired ones). ``surrogate_features=True`` reads
    neither ``feature.pt`` nor ``feature_mask.pt`` and makes structural
    features from the edge list instead
    (:func:`~ssrg_torch.data.reference_compat.surrogate_node_features`), for
    raw directories whose feature files are truncated."""

    def __init__(
        self,
        name: str = "cora_0_0",
        root: str = "./sparsity_datasets/simhomo/Planetoid",
        split: str = "official",
        k=None,
        is_augumented: bool = False,
        surrogate_features: bool = False,
    ):
        super().__init__(root, name)
        self.k = k
        self.is_augumented = is_augumented
        self.surrogate_features = surrogate_features
        self.read_file()
        self.train_idx, self.val_idx, self.test_idx = self.generate_split(split)
        self.num_node_classes = self.num_classes
        self.num_edge_classes = None
        coo = self.adj.tocoo()
        self.edge_homophily = edge_homophily(coo.row, coo.col, self.y)
        self.node_homophily = node_homophily(coo.row, coo.col, self.y, self.num_node)
        self.linkx_homophily = linkx_homophily(coo.row, coo.col, self.y, self.num_node)

    @property
    def raw_file_names(self):
        if self.surrogate_features:
            return [f for f in RAW_FILES if f not in ("feature.pt", "feature_mask.pt")]
        return list(RAW_FILES)

    @property
    def processed_stem(self) -> str:
        return f"{self.name}.surrogate" if self.surrogate_features else self.name

    def download(self):
        raise FileNotFoundError(
            f"raw files for {self.name} not found under {self.raw_dir}; make them with "
            "ssrg_torch.pipelines.sparsify_dataset (no network egress available)"
        )

    def process(self) -> Graph:
        paths = {f: osp.join(self.raw_dir, f) for f in RAW_FILES}
        edge_index = _to_numpy(_torch_load(paths["edge_index.pt"]), np.int64)
        y = _to_numpy(_torch_load(paths["label.pt"]), np.int64).reshape(-1)
        row, col = edge_index
        num_node = y.shape[0]
        if self.surrogate_features:
            from ssrg_torch.data.reference_compat import surrogate_node_features

            x = surrogate_node_features(num_node, row, col)
            feature_mask = None
            edge_mask = (None if self.is_augumented
                         else _to_numpy(_torch_load(paths["edge_mask.pt"])))
        else:
            try:
                x = _to_numpy(_torch_load(paths["feature.pt"]), np.float32)
            except Exception as exc:
                raise ValueError(
                    f"{paths['feature.pt']} is unreadable ({exc}); if this is the reference "
                    "snapshot (feature blobs truncated at 2,359,296 bytes), load with "
                    "surrogate_features=True to train on the intact real topology with "
                    "deterministic structural features"
                ) from exc
            if self.is_augumented:
                feature_mask = edge_mask = None
            else:
                feature_mask = _to_numpy(_torch_load(paths["feature_mask.pt"]))
                edge_mask = _to_numpy(_torch_load(paths["edge_mask.pt"]))
        return Graph(row, col, np.ones(row.shape[0], np.float32), num_node, "UUU",
                     feature_mask=feature_mask, edge_mask=edge_mask, x=x, y=y)

    def generate_split(self, split: str):
        if split != "official":
            raise ValueError(f"split {split!r} not supported; use 'official'")
        return tuple(_to_numpy(_torch_load(osp.join(self.raw_dir, f)), np.int64)
                     for f in ("train_idx.pt", "val_idx.pt", "test_idx.pt"))

    @property
    def sparse_x(self) -> Optional[np.ndarray]:
        """The features with the sparsity mask applied (``x * feature_mask``)."""
        if self.feature_mask is None:
            return self.x
        return self.x * self.feature_mask.astype(np.float32)


def load_homo_simplex_sparsity_dataset(
    name: str,
    root: str,
    split: str = "official",
    k=None,
    is_augumented: bool = False,
    surrogate_features: bool = False,
) -> SparsityDataset:
    """The reference's factory for :class:`SparsityDataset`."""
    return SparsityDataset(name, root, split, k, is_augumented,
                           surrogate_features=surrogate_features)
