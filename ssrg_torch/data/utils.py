"""Graph and data utilities (counterpart of ``ssrg_tpu/data/utils.py``):
pickle IO, edge-list hygiene, homophily statistics and spectral
regularization features, all host-side numpy/scipy.

Pickles are read through :class:`RestrictedUnpickler`, which builds only
classes of this package, numpy, ``scipy.sparse`` and a few plain builtins:
a pickle that names a class of any other package (the JAX package's
``Graph``, say) raises :class:`ForeignPickleError` (an
:class:`pickle.UnpicklingError`) instead of importing that package.
"""

from __future__ import annotations

import os
import pickle
import urllib.error
import urllib.request
from typing import Tuple

import numpy as np
import scipy.sparse as sp

# the errors a truncated, corrupt or foreign pickle raises while loading
UNPICKLE_ERRORS = (EOFError, pickle.UnpicklingError, AttributeError, MemoryError,
                   IndexError, ValueError)

_ALLOWED_PACKAGES = ("ssrg_torch", "numpy", "scipy.sparse")
_ALLOWED_NAMES = {
    "builtins": {"range", "slice", "set", "frozenset", "dict", "list", "tuple", "complex",
                 "bytearray", "bytes", "str", "int", "float", "bool", "object"},
    "collections": {"defaultdict", "OrderedDict"},
    "copyreg": {"_reconstructor"},
}


class ForeignPickleError(pickle.UnpicklingError):
    """A pickle names a global that :class:`RestrictedUnpickler` refuses."""


class RestrictedUnpickler(pickle.Unpickler):
    """An unpickler that admits the classes of this package, numpy,
    ``scipy.sparse``, plain builtins (``range``, containers, scalars),
    ``collections.defaultdict`` and ``copyreg._reconstructor``, and refuses
    every other global with :class:`ForeignPickleError` before importing
    its module."""

    def find_class(self, module: str, name: str):
        allowed = any(module == p or module.startswith(p + ".") for p in _ALLOWED_PACKAGES)
        if allowed or name in _ALLOWED_NAMES.get(module, ()):
            return super().find_class(module, name)
        raise ForeignPickleError(f"refusing to load global {module}.{name}")


def pkl_read_file(path: str, encoding: str = "ASCII"):
    """Unpickle a file through :class:`RestrictedUnpickler`."""
    with open(path, "rb") as f:
        return RestrictedUnpickler(f, encoding=encoding).load()


def pkl_write_file(obj, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def remove_self_loops(row: np.ndarray, col: np.ndarray, *values) -> Tuple:
    """Drop i == j entries from an edge list (and from each of ``values``)."""
    keep = row != col
    return (row[keep], col[keep]) + tuple(v[keep] for v in values)


def to_undirected(row: np.ndarray, col: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetrize and deduplicate an unweighted edge list."""
    rr = np.concatenate([row, col])
    cc = np.concatenate([col, row])
    pairs = np.unique(np.stack([rr, cc], axis=1), axis=0)
    return pairs[:, 0], pairs[:, 1]


def download_to(url: str, path: str) -> None:
    """Fetch ``url`` into ``path``, creating its directory first. A failed
    fetch raises ``RuntimeError`` that names the path to stage the file at
    by hand."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    try:
        with urllib.request.urlopen(url, timeout=30) as r, open(path, "wb") as f:
            f.write(r.read())
    except (urllib.error.URLError, OSError, ValueError) as exc:
        raise RuntimeError(
            f"download of {url!r} failed ({exc!r}); with no network egress, stage the "
            f"file manually at {path!r}"
        ) from exc


def coomatrix_to_arrays(mat) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sparse matrix -> (row int64, col int64, data float32) numpy arrays."""
    coo = mat.tocoo()
    return coo.row.astype(np.int64), coo.col.astype(np.int64), coo.data.astype(np.float32)


# -- homophily statistics (computed at load, as the reference's loaders do) ---


def edge_homophily(row: np.ndarray, col: np.ndarray, y: np.ndarray) -> float:
    """Fraction of edges whose endpoints share a label."""
    if row.size == 0:
        return 0.0
    return float(np.mean(y[row] == y[col]))


def node_homophily(row: np.ndarray, col: np.ndarray, y: np.ndarray, num_node: int) -> float:
    """Mean over nodes with a neighbour of the same-label fraction among
    their neighbours."""
    same = (y[row] == y[col]).astype(np.float64)
    deg = np.bincount(row, minlength=num_node).astype(np.float64)
    same_sum = np.bincount(row, weights=same, minlength=num_node)
    has = deg > 0
    if not has.any():
        return 0.0
    return float(np.mean(same_sum[has] / deg[has]))


def linkx_homophily(row: np.ndarray, col: np.ndarray, y: np.ndarray, num_node: int) -> float:
    """Class-insensitive edge homophily (LINKX): the sum over classes k of
    ``max(0, h_k - |C_k| / n)`` over ``num_classes - 1``, ``h_k`` the
    same-label share of the edges leaving class k."""
    num_classes = int(y.max()) + 1
    total = 0.0
    counted = 0
    for k in range(num_classes):
        in_k = y[row] == k
        d_k = np.sum(in_k)
        if d_k == 0:
            continue
        h_k = float(np.sum(in_k & (y[col] == k)) / d_k)
        p_k = float(np.sum(y == k) / num_node)
        total += max(0.0, h_k - p_k)
        counted += 1
    if counted == 0:
        return 0.0
    return total / max(num_classes - 1, 1)


def set_spectral_adjacency_reg_features(
    num_node: int,
    row: np.ndarray,
    col: np.ndarray,
    edge_weight: np.ndarray,
    k: int = 16,
    seed: int = 0,
) -> np.ndarray:
    """The ``k`` smallest eigenvectors of the symmetric-normalized Laplacian
    of the unweighted, symmetrized graph (``eigsh`` from a vector of ones),
    float32 ``[num_node, k]``. When ARPACK does not converge, normal draws
    from ``default_rng(seed)`` take their place; any other failure raises."""
    from scipy.sparse.linalg import ArpackNoConvergence, eigsh

    adj = sp.coo_matrix(
        (edge_weight.astype(np.float64), (row, col)), shape=(num_node, num_node)
    ).tocsr()
    adj = ((adj + adj.T) > 0).astype(np.float64)
    deg = np.asarray(adj.sum(axis=1)).reshape(-1)
    d_mat = sp.diags(np.where(deg > 0, deg, 1.0) ** -0.5)
    lap = sp.eye(num_node) - d_mat @ adj @ d_mat
    k = min(k, num_node - 2)
    if k < 1:
        return np.zeros((num_node, 1), dtype=np.float32)
    try:
        _, vecs = eigsh(lap, k=k, which="SM", v0=np.ones(num_node))
    except ArpackNoConvergence:
        vecs = np.random.default_rng(seed).normal(size=(num_node, k))
    return vecs.astype(np.float32)
