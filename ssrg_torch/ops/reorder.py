"""Graph reordering for locality (counterpart of ``ssrg_tpu/ops/reorder.py``).

Host-side numpy/scipy. Renumbering nodes so that neighbours have nearby ids
turns a graph into a band (RCM, BFS) or into diagonal clusters (label
propagation), which the dense-block engines of :mod:`ssrg_torch.ops.sparse`
(``banded``, ``pallas_banded``, ``tiled``) need. Every reordering returns
what the reference returns on the same input, element for element.
:func:`reorder_plan` holds the choice of reordering and engine that the
reference makes in both ``prepare`` and the autotuner.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch


def reorder_plan(engine: str, device: torch.device, spmm_bf16: bool = False,
                 cluster_merge_target: int = 0) -> Tuple[str, str, int, dict]:
    """What the locality meta-engine ``engine`` (``reorder_banded`` or
    ``reorder_tiled``) runs on ``device``: the reorder method, the
    dense-block engine, the cluster merge target and the keyword arguments
    of its pack function. ``reorder_banded`` takes the banded kernel
    (``pallas_banded``) on the card and its plain version (``banded``) on
    the CPU; with ``spmm_bf16`` the blocks or tiles are bf16, the kernel's
    window is bf16 over 512-row blocks, and the tiled rest is the segmented
    one with bf16 gathers."""
    if engine == "reorder_banded":
        method = "rcm"
        dense_engine = "banded" if device.type == "cpu" else "pallas_banded"
    else:
        method = "cluster"
        dense_engine = "tiled"
    merge_target = cluster_merge_target if engine == "reorder_tiled" else 0
    engine_kwargs: dict = {}
    if spmm_bf16:
        engine_kwargs["dtype"] = torch.bfloat16
        if dense_engine == "pallas_banded":
            engine_kwargs.update(window_bf16=True, row_block=512)
        elif dense_engine == "tiled":
            engine_kwargs.update(rest_engine="onehot", rest_gather_bf16=True)
    return method, dense_engine, merge_target, engine_kwargs


def reorder_permutation(
    adj: sp.spmatrix, method: str = "rcm", merge_target: int = 0,
) -> np.ndarray:
    """Return ``perm`` with ``perm[new_id] = old_id``.

    Methods: ``degree`` (descending, stable), ``rcm`` (scipy's reverse
    Cuthill-McKee), ``bfs`` (breadth-first order, component by component),
    ``cluster``/``lpa`` (:func:`cluster_permutation`) and
    ``cluster2``/``hierarchical`` (the same with ``merge_target`` 1024 when
    unset)."""
    csr = adj.tocsr()
    n = csr.shape[0]
    if method == "degree":
        deg = np.diff(csr.indptr)
        return np.argsort(-deg, kind="stable")
    if method == "rcm":
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        return np.asarray(reverse_cuthill_mckee(csr, symmetric_mode=True))
    if method == "bfs":
        from scipy.sparse.csgraph import breadth_first_order

        seen = np.zeros(n, bool)
        order = []
        for start in range(n):
            if seen[start]:
                continue
            nodes = breadth_first_order(csr, start, return_predecessors=False)
            nodes = nodes[~seen[nodes]]
            seen[nodes] = True
            order.append(nodes)
        return np.concatenate(order) if order else np.arange(n)
    if method in ("cluster", "lpa"):
        return cluster_permutation(csr, merge_target=merge_target)
    if method in ("cluster2", "hierarchical"):
        return cluster_permutation(csr, merge_target=merge_target or 1024)
    raise ValueError(f"unknown reorder method {method!r}")


def merge_clusters(
    inv: np.ndarray,
    cluster_edges: "sp.csr_matrix",
    counts: np.ndarray,
    target: int,
    passes: int = 4,
) -> np.ndarray:
    """Heavy-edge-matching agglomeration of cluster labels.

    Each pass matches every cluster, smallest first, with the neighbour it
    shares the most edges with, and merges the pair while the merged node
    count stays <= ``target``. ``inv``: cluster id per node (0..k-1);
    ``cluster_edges``: k x k inter-cluster edge counts; ``counts``: nodes per
    cluster. Returns the merged cluster id per node, re-densified."""
    k = counts.shape[0]
    parent = np.arange(k)
    size = counts.astype(np.int64).copy()

    def find(u: int) -> int:
        while parent[u] != u:
            parent[u] = parent[parent[u]]
            u = parent[u]
        return u

    cg = cluster_edges.tocoo()
    for _ in range(passes):
        if cg.nnz == 0:
            break
        # heaviest neighbour per cluster (stable argmax via lexsort)
        order = np.lexsort((cg.data, cg.row))
        last = np.flatnonzero(
            np.r_[cg.row[order][1:] != cg.row[order][:-1], True]
        )
        heavy_of = np.full(k, -1, np.int64)
        heavy_of[cg.row[order][last]] = cg.col[order][last]

        merged_any = False
        for u in np.argsort(size, kind="stable"):   # smallest first
            v = heavy_of[u]
            if v < 0:
                continue
            ru, rv = find(int(u)), find(int(v))
            if ru == rv or size[ru] + size[rv] > target:
                continue
            parent[rv] = ru
            size[ru] += size[rv]
            merged_any = True
        if not merged_any:
            break
        # contract: re-densify merged ids, push labels down to nodes and
        # rebuild the cluster graph for the next pass
        root = np.fromiter((find(i) for i in range(k)), np.int64, k)
        uniq_roots, dense_of_old = np.unique(root, return_inverse=True)
        k2 = uniq_roots.shape[0]
        inv = dense_of_old[inv]
        ru, rv = dense_of_old[cg.row], dense_of_old[cg.col]
        keep = ru != rv
        cg = sp.coo_matrix(
            (cg.data[keep], (ru[keep], rv[keep])), shape=(k2, k2)
        )
        cg.sum_duplicates()
        size = size[uniq_roots]
        parent = np.arange(k2)
        k = k2
    return inv


def cluster_permutation(
    adj: sp.spmatrix, max_sweeps: int = 20, order: str = "affinity",
    merge_target: int = 0, merge_passes: int = 4,
) -> np.ndarray:
    """Community order for the tiled engine: label-propagation clusters
    (:func:`ssrg_torch.native.lpa_cluster`), optionally merged up to
    ``merge_target`` nodes (:func:`merge_clusters`), numbered cluster by
    cluster. ``order`` arranges the clusters: ``affinity`` (RCM over the
    contracted cluster graph, so strongly linked clusters sit side by side)
    or ``size`` (largest first). Returns ``perm`` with ``perm[new_id] =
    old_id``."""
    from ssrg_torch import native

    csr = adj.tocsr()
    n = csr.shape[0]
    labels = native.lpa_cluster(csr.indptr, csr.indices, max_sweeps)
    _, inv, counts = np.unique(labels, return_inverse=True, return_counts=True)
    k = counts.shape[0]

    def _cluster_graph(inv, k):
        coo = csr.tocoo()
        cu, cv = inv[coo.row], inv[coo.col]
        inter = cu != cv
        cg = sp.coo_matrix(
            (np.ones(int(inter.sum()), np.float32),
             (cu[inter], cv[inter])), shape=(k, k),
        ).tocsr()
        cg.sum_duplicates()
        return cg

    if merge_target > 0 and 1 < k < n:
        inv = merge_clusters(
            inv, _cluster_graph(inv, k), counts, merge_target,
            passes=merge_passes,
        )
        counts = np.bincount(inv)
        k = counts.shape[0]

    rank = np.empty(k, np.int64)
    if order == "affinity" and 1 < k < n:
        cg = _cluster_graph(inv, k)
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        order_of = np.asarray(reverse_cuthill_mckee(cg, symmetric_mode=True))
        rank[order_of] = np.arange(k)
    elif order in ("affinity", "size"):
        rank[np.argsort(-counts, kind="stable")] = np.arange(k)
    else:
        raise ValueError(f"unknown cluster order {order!r}")
    return np.lexsort((np.arange(n), rank[inv]))


def apply_permutation(
    adj: sp.spmatrix,
    perm: np.ndarray,
    x: Optional[np.ndarray] = None,
    y: Optional[np.ndarray] = None,
) -> Tuple[sp.csr_matrix, Optional[np.ndarray], Optional[np.ndarray], np.ndarray]:
    """Permute adjacency rows and columns (and features, labels). Returns
    ``(adj', x', y', inverse)`` with ``inverse[old_id] = new_id``."""
    n = adj.shape[0]
    inverse = np.empty(n, np.int64)
    inverse[perm] = np.arange(n)
    csr = adj.tocsr()[perm][:, perm].tocsr()
    x2 = None if x is None else np.asarray(x)[perm]
    y2 = None if y is None else np.asarray(y)[perm]
    return csr, x2, y2, inverse


def bandwidth(adj: sp.spmatrix) -> int:
    """Max ``|row - col|`` over the nonzeros."""
    coo = adj.tocoo()
    if coo.nnz == 0:
        return 0
    return int(np.abs(coo.row.astype(np.int64) - coo.col).max())
