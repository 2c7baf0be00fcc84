"""Planetoid datasets from the ``ind.*`` raw files (counterpart of
``ssrg_tpu/data/planetoid.py``).

Parses the kimiyoung/planetoid files ``ind.<name>.{x,y,tx,ty,allx,ally,
graph,test.index}`` from ``<root>/<name>/raw/``, fills citeseer's missing
test rows with zeros, row-normalizes the features, drops self-loops and
duplicate edges, and gives the official split: the first 20 per class
(``20 * C`` rows) to train, the next 500 to validate, the test index file
to test. The raw pickles are read through
:class:`~ssrg_torch.data.utils.RestrictedUnpickler`; ``download()`` raises
(no network egress): place the raw files by hand.
"""

from __future__ import annotations

from typing import List

import numpy as np
import scipy.sparse as sp

from ssrg_torch.data.base_dataset import NodeDataset
from ssrg_torch.data.graph import Graph
from ssrg_torch.data.utils import (
    edge_homophily,
    linkx_homophily,
    node_homophily,
    pkl_read_file,
)


def _parse_index_file(path: str) -> np.ndarray:
    with open(path) as f:
        return np.asarray([int(line.strip()) for line in f], dtype=np.int64)


def row_normalize(features: sp.spmatrix) -> sp.csr_matrix:
    """Divide each row by its sum (rows that sum to 0 stay 0)."""
    rowsum = np.asarray(features.sum(axis=1)).reshape(-1)
    with np.errstate(divide="ignore"):
        r_inv = 1.0 / rowsum
    r_inv[~np.isfinite(r_inv)] = 0.0
    return (sp.diags(r_inv) @ features).tocsr()


class Planetoid(NodeDataset):
    """cora / citeseer / pubmed from the raw ``ind.*`` files."""

    def __init__(self, name: str = "cora", root: str = "./datasets/simhomo/Planetoid",
                 split: str = "official"):
        name = name.lower()
        if name not in ("cora", "citeseer", "pubmed"):
            raise ValueError(f"unknown planetoid dataset {name!r}")
        super().__init__(root, name)
        self.read_file()
        self.train_idx, self.val_idx, self.test_idx = self.generate_split(split)
        coo = self.adj.tocoo()
        self.edge_homophily = edge_homophily(coo.row, coo.col, self.y)
        self.node_homophily = node_homophily(coo.row, coo.col, self.y, self.num_node)
        self.linkx_homophily = linkx_homophily(coo.row, coo.col, self.y, self.num_node)

    @property
    def raw_file_names(self) -> List[str]:
        parts = ["x", "y", "tx", "ty", "allx", "ally", "graph", "test.index"]
        return [f"ind.{self.name}.{p}" for p in parts]

    def download(self):
        raise FileNotFoundError(
            f"planetoid raw files missing under {self.raw_dir}; with no network egress, "
            "copy the ind.* files of github.com/kimiyoung/planetoid (data/) there by hand"
        )

    def process(self) -> Graph:
        paths = self.raw_file_paths()
        x, y, tx, ty, allx, ally, graph = [pkl_read_file(p, encoding="latin1")
                                           for p in paths[:-1]]
        test_idx_reorder = _parse_index_file(paths[-1])
        test_idx_range = np.sort(test_idx_reorder)

        if self.name == "citeseer":
            # isolated test nodes: zero rows for the missing test indices
            full = np.arange(test_idx_range.min(), test_idx_range.max() + 1)
            tx_ext = sp.lil_matrix((full.shape[0], x.shape[1]))
            tx_ext[test_idx_range - full.min(), :] = tx
            tx = tx_ext
            ty_ext = np.zeros((full.shape[0], y.shape[1]))
            ty_ext[test_idx_range - full.min(), :] = ty
            ty = ty_ext

        features = sp.vstack((allx, tx)).tolil()
        features[test_idx_reorder, :] = features[test_idx_range, :]
        features = row_normalize(sp.csr_matrix(features))

        labels_onehot = np.vstack((ally, ty))
        labels_onehot[test_idx_reorder, :] = labels_onehot[test_idx_range, :]
        labels = labels_onehot.argmax(axis=1).astype(np.int64)

        num_node = features.shape[0]
        rows = np.asarray([src for src, dsts in graph.items() for _ in dsts], dtype=np.int64)
        cols = np.asarray([dst for dsts in graph.values() for dst in dsts], dtype=np.int64)
        keep = rows != cols
        # unique single-direction entries; Graph symmetrizes
        pairs = np.unique(np.stack([rows[keep], cols[keep]], axis=1), axis=0)
        return Graph(pairs[:, 0], pairs[:, 1], np.ones(pairs.shape[0], np.float32),
                     num_node, "UUU", x=np.asarray(features.todense(), np.float32), y=labels)

    def generate_split(self, split: str):
        if split != "official":
            raise ValueError("only the official planetoid split is supported")
        num_classes = self.num_classes
        train_idx = np.arange(num_classes * 20)
        val_idx = np.arange(num_classes * 20, num_classes * 20 + 500)
        test_idx = _parse_index_file(self.raw_file_paths()[-1])
        return train_idx, np.sort(val_idx), np.sort(test_idx)
