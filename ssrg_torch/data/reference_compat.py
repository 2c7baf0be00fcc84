"""Artifacts of the reference project (counterpart of
``ssrg_tpu/data/reference_compat.py``).

1. The reference's processed ``<name>.graph`` files pickle objects of its
   ``datasets.base_data`` module (``Graph``, ``Edge`` and more), a package
   neither this port nor the JAX package has.
   :class:`ReferenceUnpickler` builds those as attribute bags
   (:class:`ReferenceGraph`, :class:`ReferenceEdge`, or a class made for
   any other name) without touching ``sys.modules``, and
   :func:`load_reference_processed` turns the result into this port's
   :class:`~ssrg_torch.data.graph.Graph` through
   :func:`convert_reference_graph`.
2. :func:`surrogate_node_features` makes deterministic node features from
   the graph's structure alone, for raw directories whose feature files are
   truncated but whose edges, labels and splits are intact.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sp

from ssrg_torch.data.graph import Graph
from ssrg_torch.data.utils import (
    UNPICKLE_ERRORS,
    ForeignPickleError,
    RestrictedUnpickler,
    set_spectral_adjacency_reg_features,
)

REFERENCE_MODULE = "datasets.base_data"


class _ShimBase:
    """An attribute bag that takes any pickled object state."""

    def __init__(self, *args, **kwargs):
        self._ctor_args = args
        self._ctor_kwargs = kwargs

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif isinstance(state, tuple) and len(state) == 2:
            d, slots = state
            if d:
                self.__dict__.update(d)
            if slots:
                self.__dict__.update(slots)
        else:
            self.__dict__["_state"] = state


class ReferenceGraph(_ShimBase):
    """Stand-in for ``datasets.base_data.Graph``."""


class ReferenceEdge(_ShimBase):
    """Stand-in for ``datasets.base_data.Edge``."""


_SHIMS = {"Graph": ReferenceGraph, "Edge": ReferenceEdge}


class ReferenceUnpickler(RestrictedUnpickler):
    """:class:`~ssrg_torch.data.utils.RestrictedUnpickler` that also builds
    the reference's ``datasets.base_data`` classes as attribute bags."""

    def find_class(self, module: str, name: str):
        if module == REFERENCE_MODULE:
            if name not in _SHIMS:
                _SHIMS[name] = type(name, (_ShimBase,), {"__module__": __name__})
            return _SHIMS[name]
        return super().find_class(module, name)


def _as_numpy(v, dtype=None):
    if v is None:
        return None
    if isinstance(v, range):
        v = np.asarray(list(v))
    elif hasattr(v, "detach"):  # a torch tensor
        v = v.detach().cpu().numpy()
    elif sp.issparse(v):
        return v
    else:
        v = np.asarray(v)
    return v if dtype is None else v.astype(dtype)


def convert_reference_graph(obj) -> Graph:
    """A reference ``datasets.base_data.Graph`` (or any object of its
    attribute layout: ``.edge`` with ``.row``/``.col``/``.edge_weight``, or
    those on the object itself; ``.x``, ``.y``, ``.num_node``,
    ``.edge_type``, optional masks and ``.adj``; each also under a leading
    underscore) as this port's :class:`Graph`."""
    d = getattr(obj, "__dict__", {})

    def pick(*names):
        for n in names:
            if n in d and d[n] is not None:
                return d[n]
            if f"_{n}" in d and d[f"_{n}"] is not None:
                return d[f"_{n}"]
        return None

    edge = pick("edge")
    if edge is not None:
        ed = getattr(edge, "__dict__", {})
        row = _as_numpy(ed.get("row", ed.get("_row")), np.int64)
        col = _as_numpy(ed.get("col", ed.get("_col")), np.int64)
        w = _as_numpy(ed.get("edge_weight", ed.get("_edge_weight")), np.float32)
    else:
        row = _as_numpy(pick("row"), np.int64)
        col = _as_numpy(pick("col"), np.int64)
        w = _as_numpy(pick("edge_weight"), np.float32)
    if row is None or col is None:
        raise ValueError(
            f"reference Graph pickle has no edge list (attributes present: {sorted(d.keys())})"
        )
    if w is None:
        w = np.ones(row.shape[0], np.float32)
    x = _as_numpy(pick("x"))
    y = _as_numpy(pick("y"))
    num_node = pick("num_node", "node")
    if num_node is None:
        num_node = int(max(row.max(), col.max())) + 1 if row.size else 0
        if y is not None:
            num_node = max(num_node, int(np.asarray(y).shape[0]))
    g = Graph(
        row, col, w, int(num_node),
        edge_type=pick("edge_type") or "UUU",
        feature_mask=_as_numpy(pick("feature_mask")),
        edge_mask=_as_numpy(pick("edge_mask")),
        x=None if x is None else np.asarray(x, np.float32),
        y=y,
    )
    adj = pick("adj")
    if adj is not None and sp.issparse(adj):
        g.adj = adj.tocsr()
    return g


def load_reference_processed(path: str) -> Graph:
    """Load a reference-written ``<name>.graph`` and convert it. A
    truncated or corrupt file raises ``ValueError``; a pickle naming a
    class outside what :class:`ReferenceUnpickler` admits raises
    :class:`~ssrg_torch.data.utils.ForeignPickleError`."""
    try:
        with open(path, "rb") as f:
            obj = ReferenceUnpickler(f).load()
    except ForeignPickleError:
        raise
    except UNPICKLE_ERRORS as err:
        raise ValueError(
            f"{path} is not a complete pickle (the reference snapshot truncates .graph "
            f"blobs at 2,359,296 bytes): {err}. Rebuild the dataset from the intact raw "
            "files instead (SparsityDataset(surrogate_features=True) uses the intact "
            "edge/label/split files with deterministic structural features)."
        ) from err
    if isinstance(obj, Graph):
        return obj
    return convert_reference_graph(obj)


def surrogate_node_features(
    num_node: int,
    row: np.ndarray,
    col: np.ndarray,
    edge_weight: Optional[np.ndarray] = None,
    k: int = 32,
    seed: int = 0,
) -> np.ndarray:
    """Deterministic label-free node features from the graph's structure:
    the ``k`` smallest eigenvectors of the symmetric-normalized Laplacian,
    then log-degree and 2-hop log-degree, standardized and scaled by 0.1."""
    if edge_weight is None:
        edge_weight = np.ones(row.shape[0], np.float32)
    spec = set_spectral_adjacency_reg_features(num_node, row, col, edge_weight, k=k, seed=seed)
    adj = sp.coo_matrix((np.ones(row.shape[0]), (row, col)), shape=(num_node, num_node)).tocsr()
    adj = ((adj + adj.T) > 0).astype(np.float64)
    deg = np.asarray(adj.sum(axis=1)).reshape(-1)
    deg2 = adj @ deg
    extra = np.stack([np.log1p(deg), np.log1p(deg2)], axis=1).astype(np.float32)
    extra = (extra - extra.mean(axis=0)) / (extra.std(axis=0) + 1e-6)
    return np.concatenate([spec, extra * 0.1], axis=1)
