"""OGB, Reddit and Flickr datasets from staged ``.npz`` bundles
(counterpart of ``ssrg_tpu/data/ogbn.py``).

A bundle ``<root>/<name>/raw/<name>.npz`` holds ``x [N, F] f32, y [N]
i64, edge_index [2, E] i64, train_idx, val_idx, test_idx``. The reference's
other route, the ``ogb`` package, is not taken: the port reads the bundle
only, and without it raises ``FileNotFoundError`` naming the missing file.
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from ssrg_torch.data.base_dataset import NodeDataset
from ssrg_torch.data.graph import Graph


class NpzNodeDataset(NodeDataset):
    """A node dataset from ``<root>/<name>/raw/<name>.npz``; the official
    split is the bundle's."""

    def __init__(self, name: str, root: str, split: str = "official"):
        super().__init__(root, name)
        self.read_file()
        self.train_idx, self.val_idx, self.test_idx = self.generate_split(split)

    @property
    def raw_file_names(self):
        return [f"{self.name}.npz"]

    @property
    def bundle_path(self) -> str:
        return osp.join(self.raw_dir, f"{self.name}.npz")

    def download(self):
        raise FileNotFoundError(
            f"{self.bundle_path} not found: with no network egress, stage an npz bundle "
            "there with arrays x, y, edge_index, train_idx, val_idx, test_idx"
        )

    def _splits(self, z) -> tuple:
        return tuple(z[k].astype(np.int64) for k in ("train_idx", "val_idx", "test_idx"))

    def process(self) -> Graph:
        z = np.load(self.bundle_path, allow_pickle=False)
        row, col = z["edge_index"].astype(np.int64)
        keep = row != col
        g = Graph(row[keep], col[keep], np.ones(keep.sum(), np.float32), z["x"].shape[0],
                  "UUU", x=z["x"].astype(np.float32), y=z["y"].astype(np.int64).reshape(-1))
        g._splits = self._splits(z)
        return g

    def generate_split(self, split: str):
        if split != "official":
            raise ValueError("only the official split is supported")
        if getattr(self.graph, "_splits", None) is not None:
            return self.graph._splits
        return self._splits(np.load(self.bundle_path, allow_pickle=False))


class Ogbn(NpzNodeDataset):
    """ogbn-{arxiv, products, papers100M} from the staged bundle."""

    def __init__(self, name: str = "arxiv", root: str = "./datasets/simhomo/ogbn",
                 split: str = "official"):
        super().__init__(name, root, split)


def Reddit(root: str, split: str = "official") -> NpzNodeDataset:
    return NpzNodeDataset("reddit", root, split)


def Flickr(root: str, split: str = "official") -> NpzNodeDataset:
    return NpzNodeDataset("flickr", root, split)


def data_read(root: str, dataset: str):
    """Dataset by name: Planetoid for cora/citeseer/pubmed, the staged
    bundle for arxiv/products/papers100m and reddit/flickr."""
    name = dataset.lower()
    if name in ("cora", "citeseer", "pubmed"):
        from ssrg_torch.data.planetoid import Planetoid

        return Planetoid(name, root, "official")
    if name in ("arxiv", "products", "papers100m"):
        return Ogbn(name, root, "official")
    if name in ("reddit", "flickr"):
        return NpzNodeDataset(name, root, "official")
    raise ValueError(f"dataset not found: {dataset!r}")
