"""Node datasets with a raw/processed directory layout (counterpart of
``ssrg_tpu/data/base_dataset.py``).

The lifecycle: a graph cached in ``processed/`` is read back; otherwise
``download()`` runs when a raw file is missing, ``process()`` builds the
:class:`~ssrg_torch.data.graph.Graph` from the raw files and the result is
cached. ``generate_split()`` gives the index arrays.

The port caches under a name of its own, ``<name>.ssrg_torch.graph``, and
reads every pickle through
:class:`~ssrg_torch.data.utils.RestrictedUnpickler`: the ``<name>.graph``
that the JAX package or the reference wrote beside it is tried next (a
reference ``datasets.base_data`` pickle loads through
:mod:`ssrg_torch.data.reference_compat`; the JAX package's pickled
``ssrg_tpu`` objects are refused without importing that package), and
when neither loads the raw files are processed again.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Optional, Sequence

import numpy as np

from ssrg_torch.data.graph import Graph
from ssrg_torch.data.utils import UNPICKLE_ERRORS, pkl_read_file, pkl_write_file

CACHE_SUFFIX = ".ssrg_torch.graph"


class NodeDataset:
    """Abstract node-level dataset. Subclasses implement
    ``raw_file_names``, ``download()``, ``process() -> Graph`` and
    ``generate_split(split)``."""

    def __init__(self, root: str, name: str):
        self.root = root
        self.name = name
        self.graph: Optional[Graph] = None
        self.train_idx: Optional[np.ndarray] = None
        self.val_idx: Optional[np.ndarray] = None
        self.test_idx: Optional[np.ndarray] = None

    # -- directory layout --------------------------------------------------

    @property
    def raw_dir(self) -> str:
        return osp.join(self.root, self.name, "raw")

    @property
    def processed_dir(self) -> str:
        return osp.join(self.root, self.name, "processed")

    @property
    def raw_file_names(self) -> Sequence[str]:
        raise NotImplementedError

    @property
    def processed_stem(self) -> str:
        """The processed file's name less its ``.graph`` suffix."""
        return self.name

    @property
    def processed_file_path(self) -> str:
        """The port's own cache."""
        return osp.join(self.processed_dir, self.processed_stem + CACHE_SUFFIX)

    @property
    def reference_processed_path(self) -> str:
        """The file the JAX package and the reference cache to."""
        return osp.join(self.processed_dir, self.processed_stem + ".graph")

    def raw_file_paths(self) -> Sequence[str]:
        return [osp.join(self.raw_dir, f) for f in self.raw_file_names]

    # -- lifecycle ---------------------------------------------------------

    def download(self) -> None:
        raise NotImplementedError(
            f"Raw files for {self.name} not found under {self.raw_dir}; with no network "
            "egress, place the raw files there."
        )

    def process(self) -> Graph:
        raise NotImplementedError

    def _load_processed(self) -> Optional[Graph]:
        """The port's cache, else a reference-written ``<name>.graph``; None
        when neither is there or loads."""
        if osp.exists(self.processed_file_path):
            try:
                return pkl_read_file(self.processed_file_path)
            except UNPICKLE_ERRORS:
                pass
        if osp.exists(self.reference_processed_path):
            from ssrg_torch.data.reference_compat import load_reference_processed

            try:
                return load_reference_processed(self.reference_processed_path)
            except UNPICKLE_ERRORS:
                pass
        return None

    def read_file(self) -> Graph:
        graph = self._load_processed()
        if graph is None:
            if not all(osp.exists(p) for p in self.raw_file_paths()):
                os.makedirs(self.raw_dir, exist_ok=True)
                self.download()
            graph = self.process()
            try:
                os.makedirs(self.processed_dir, exist_ok=True)
                pkl_write_file(graph, self.processed_file_path)
            except OSError:
                pass  # a read-only dataset root: serve the graph from memory
        self.graph = graph
        return graph

    def generate_split(self, split: str) -> None:
        raise NotImplementedError

    # -- graph attribute passthrough --------------------------------------

    @property
    def adj(self):
        return self.graph.adj

    @property
    def x(self):
        return self.graph.x

    @property
    def y(self):
        return self.graph.y

    @property
    def edge(self):
        return self.graph.edge

    @property
    def num_node(self) -> int:
        return self.graph.num_node

    @property
    def num_edge(self) -> int:
        return self.graph.num_edge

    @property
    def num_features(self) -> int:
        return self.graph.num_features

    @property
    def num_classes(self) -> int:
        return self.graph.num_classes

    @property
    def feature_mask(self):
        return self.graph.feature_mask

    @property
    def edge_mask(self):
        return self.graph.edge_mask
