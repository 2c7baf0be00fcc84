"""Graph / Edge containers (counterpart of ``ssrg_tpu/data/graph.py``).

A host-side numpy/scipy structure: graph construction and normalization are
one-time O(E) work on the host, and the propagation loop consumes device
tensors built from the scipy CSR by :mod:`ssrg_torch.ops.sparse`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import scipy.sparse as sp

from ssrg_torch.logger import span


@dataclass
class Edge:
    """Edge list (COO) with weights."""

    row: np.ndarray            # int64 [E]
    col: np.ndarray            # int64 [E]
    edge_weight: np.ndarray    # float32 [E]
    edge_type: str = "UUU"     # unsigned-undirected-unweighted

    def __post_init__(self):
        self.row = np.asarray(self.row, dtype=np.int64).reshape(-1)
        self.col = np.asarray(self.col, dtype=np.int64).reshape(-1)
        self.edge_weight = np.asarray(self.edge_weight, dtype=np.float32).reshape(-1)

    @property
    def num_edge(self) -> int:
        return int(self.row.shape[0])


def symmetrize_edges(rows, cols, weights, num_nodes: int, clamp_unit: bool = True):
    """Symmetric, coalesced, self-loop-free scipy CSR from an edge list,
    with sorted indices, through :func:`ssrg_torch.native.symmetrize_edges`
    (the host library) as ``ssrg_tpu/data/graph.py:100-103`` does.

    Both directions of every edge are summed into one entry; unweighted
    ('..U') graphs clamp the sums to 1 so that symmetrizing an
    already-symmetric list is idempotent.
    """
    from ssrg_torch import native

    r, c, w = native.symmetrize_edges(rows, cols, weights, num_nodes, clamp_unit=clamp_unit)
    adj = sp.csr_matrix((w, (r, c)), shape=(num_nodes, num_nodes))
    adj.sort_indices()
    return adj


class Graph:
    """In-memory graph with features and labels; ``.adj`` is the scipy CSR
    adjacency, built lazily from the edge list (the span
    ``prepare.adjacency``): symmetric (both directions
    of every edge summed) by default, or, with ``symmetrize=False``, the
    directed edges as given (duplicates summed, self-loops dropped), which
    the directed operators (magnetic, two_dir, two_order) need. Unweighted
    ('..U') edge types clamp weights to 1."""

    def __init__(
        self,
        row,
        col,
        edge_weight,
        num_node: int,
        edge_type: str = "UUU",
        feature_mask: Optional[np.ndarray] = None,
        edge_mask: Optional[np.ndarray] = None,
        x: Optional[np.ndarray] = None,
        y: Optional[np.ndarray] = None,
        symmetrize: bool = True,
    ):
        self.edge = Edge(row, col, edge_weight, edge_type)
        self.edge_type = edge_type
        self.num_node = int(num_node)
        self.feature_mask = feature_mask
        self.edge_mask = edge_mask
        self.x = None if x is None else np.asarray(x, dtype=np.float32)
        self.y = None if y is None else np.asarray(y, dtype=np.int64).reshape(-1)
        self._symmetrize = symmetrize
        self._adj: Optional[sp.csr_matrix] = None

    @property
    def adj(self) -> sp.csr_matrix:
        if self._adj is None:
            with span("prepare.adjacency"):
                self._adj = self._build_adj()
        return self._adj

    def _build_adj(self) -> sp.csr_matrix:
        n = self.num_node
        r, c, w = self.edge.row, self.edge.col, self.edge.edge_weight
        clamp = self.edge_type.endswith("U")
        if self._symmetrize:
            return symmetrize_edges(r, c, w, n, clamp_unit=clamp)
        adj = sp.coo_matrix((w, (r, c)), shape=(n, n)).tocsr()
        if clamp:
            adj.data[:] = np.minimum(adj.data, 1.0)
        adj.setdiag(0)
        adj.eliminate_zeros()
        return adj

    @adj.setter
    def adj(self, value):
        self._adj = value.tocsr() if sp.issparse(value) else value

    @property
    def node(self) -> int:
        return self.num_node

    @property
    def num_edge(self) -> int:
        return int(self.adj.nnz)

    @property
    def num_features(self) -> int:
        return 0 if self.x is None else int(self.x.shape[1])

    @property
    def num_classes(self) -> int:
        if self.y is None:
            return 0
        return int(self.y.max()) + 1

    def degrees(self) -> np.ndarray:
        return np.asarray(self.adj.sum(axis=1)).reshape(-1)

    def __repr__(self):
        return (
            f"Graph(num_node={self.num_node}, num_edge={self.num_edge}, "
            f"num_features={self.num_features}, num_classes={self.num_classes}, "
            f"edge_type={self.edge_type!r})"
        )
