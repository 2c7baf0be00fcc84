"""The link-classification dataset protocol and its generators
(counterpart of ``ssrg_tpu/data/link.py``).

:class:`~ssrg_torch.train.LinkClassification` reads a dataset's
``observed_edge_idx``/``observed_edge_weight`` (the graph it propagates
over) and ``{train,val,test}_edge_pairs_idx``/``_label`` (the pairs it
scores). :func:`link_dataset_from_graph` makes them from any graph
(held-out edges plus sampled non-edges), :func:`synthetic_link_dataset`
from an SBM. Both make the JAX package's numpy draws in the same order, so
one seed gives the same splits in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

from ssrg_torch.data.synthetic import sbm_graph


@dataclass
class LinkDataset:
    x: np.ndarray                   # [N, F]
    observed_edge_idx: np.ndarray   # [2, E] (directed entries)
    observed_edge_weight: np.ndarray
    train_edge_pairs_idx: np.ndarray   # [P, 2]
    train_edge_pairs_label: np.ndarray
    val_edge_pairs_idx: np.ndarray
    val_edge_pairs_label: np.ndarray
    test_edge_pairs_idx: np.ndarray
    test_edge_pairs_label: np.ndarray
    num_node: int
    num_classes: int

    @property
    def num_features(self) -> int:
        return int(self.x.shape[1])


def link_dataset_from_graph(
    dataset,
    val_frac: float = 0.1,
    test_frac: float = 0.2,
    neg_ratio: float = 1.0,
    seed: int = 0,
) -> LinkDataset:
    """Edge-pair splits from any node dataset or Graph, by the standard
    link-prediction recipe:

    - unique undirected edges are split into train/val/test by fraction;
    - the OBSERVED graph (what the model propagates over) contains only the
      train edges, symmetrized — val/test edges are truly held out;
    - every split gets ``neg_ratio`` sampled non-edges; pair label is
      1 = edge, 0 = non-edge (binary edge existence).

    Works with anything exposing ``.adj`` (scipy sparse), ``.x`` and
    ``.num_node``, e.g. :class:`~ssrg_torch.data.sparsity.SparsityDataset`.
    """
    adj = dataset.adj.tocoo()
    n = int(dataset.num_node)
    rng = np.random.default_rng(seed)

    # unique undirected edges (upper triangle)
    upper = adj.row < adj.col
    er, ec = adj.row[upper], adj.col[upper]
    m = er.shape[0]
    if m < 10:
        raise ValueError(f"graph has only {m} unique edges; too few to split")
    perm = rng.permutation(m)
    n_test = int(test_frac * m)
    n_val = int(val_frac * m)
    te, va, tr = np.split(perm, [n_test, n_test + n_val])

    def pairs_of(idx):
        return np.stack([er[idx], ec[idx]], axis=1)

    # observed graph: train edges only, symmetric
    obs_r = np.concatenate([er[tr], ec[tr]])
    obs_c = np.concatenate([ec[tr], er[tr]])
    obs_w = np.ones(obs_r.shape[0], np.float32)

    # negative sampling with rejection against the FULL edge set (a held-out
    # edge must never be a "negative")
    full = sp.csr_matrix(
        (np.ones(adj.nnz, np.int8), (adj.row, adj.col)), shape=(n, n)
    )

    def sample_negatives(k):
        out = np.zeros((0, 2), np.int64)
        while out.shape[0] < k:
            a = rng.integers(0, n, size=2 * k)
            b = rng.integers(0, n, size=2 * k)
            ok = a != b
            a, b = a[ok], b[ok]
            is_edge = np.asarray(full[a, b]).reshape(-1) > 0
            cand = np.stack([a[~is_edge], b[~is_edge]], axis=1)
            out = np.concatenate([out, cand])[:k]
        return out

    splits = {}
    for name, pos_idx in (("train", tr), ("val", va), ("test", te)):
        pos = pairs_of(pos_idx)
        neg = sample_negatives(int(round(neg_ratio * pos.shape[0])))
        pairs = np.concatenate([pos, neg])
        labels = np.concatenate(
            [np.ones(pos.shape[0], np.int64), np.zeros(neg.shape[0], np.int64)]
        )
        shuf = rng.permutation(pairs.shape[0])
        splits[name] = (pairs[shuf], labels[shuf])

    return LinkDataset(
        x=np.asarray(dataset.x, np.float32),
        observed_edge_idx=np.stack([obs_r, obs_c]),
        observed_edge_weight=obs_w,
        train_edge_pairs_idx=splits["train"][0],
        train_edge_pairs_label=splits["train"][1],
        val_edge_pairs_idx=splits["val"][0],
        val_edge_pairs_label=splits["val"][1],
        test_edge_pairs_idx=splits["test"][0],
        test_edge_pairs_label=splits["test"][1],
        num_node=n,
        num_classes=2,
    )


def synthetic_link_dataset(
    num_node: int = 600,
    num_classes: int = 3,
    num_features: int = 32,
    num_pairs: int = 900,
    seed: int = 0,
    label_mode: str = "source_class",
) -> LinkDataset:
    """SBM graph; query pairs labeled either by the source node's community
    (``source_class`` — linearly decodable from concatenated endpoint
    features, matching the reference heads' concat+linear edge scorer) or by
    same-community membership (``same_community`` — requires feature
    interaction, beyond a concat+linear scorer). Split 60/20/20."""
    g = sbm_graph(num_node, num_classes, num_features, seed=seed)
    rng = np.random.default_rng(seed + 1)
    coo = g.adj.tocoo()

    a = rng.integers(0, num_node, size=num_pairs * 2)
    b = rng.integers(0, num_node, size=num_pairs * 2)
    keep = a != b
    a, b = a[keep][:num_pairs], b[keep][:num_pairs]
    if label_mode == "source_class":
        labels = g.y[a].astype(np.int64)
        n_cls = num_classes
    elif label_mode == "same_community":
        labels = (g.y[a] == g.y[b]).astype(np.int64)
        n_cls = 2
    else:
        raise ValueError(label_mode)
    pairs = np.stack([a, b], axis=1)

    n_train = int(0.6 * num_pairs)
    n_val = int(0.2 * num_pairs)
    perm = rng.permutation(pairs.shape[0])
    tr, va, te = np.split(perm, [n_train, n_train + n_val])
    return LinkDataset(
        x=g.x,
        observed_edge_idx=np.stack([coo.row, coo.col]),
        observed_edge_weight=coo.data.astype(np.float32),
        train_edge_pairs_idx=pairs[tr],
        train_edge_pairs_label=labels[tr],
        val_edge_pairs_idx=pairs[va],
        val_edge_pairs_label=labels[va],
        test_edge_pairs_idx=pairs[te],
        test_edge_pairs_label=labels[te],
        num_node=num_node,
        num_classes=n_cls,
    )
