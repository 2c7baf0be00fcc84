"""Synthetic graph generators (counterpart of ``ssrg_tpu/data/synthetic.py``).

Every generator makes the same numpy ``default_rng`` draws in the same order
as the reference, so one seed gives the same graph in both packages.
"""

from __future__ import annotations

import numpy as np

from ssrg_torch.data.graph import Graph


class InMemoryDataset:
    """A Graph plus train/val/test splits; graph attributes (``adj``, ``x``,
    ``y``, ``num_node``, ...) are delegated to the graph."""

    def __init__(self, graph: Graph, train_idx, val_idx, test_idx, name="synthetic"):
        self.graph = graph
        self.name = name
        self.train_idx = np.asarray(train_idx, dtype=np.int64)
        self.val_idx = np.asarray(val_idx, dtype=np.int64)
        self.test_idx = np.asarray(test_idx, dtype=np.int64)

    def __getattr__(self, item):
        return getattr(self.__dict__["graph"], item)

    def __repr__(self):
        return f"InMemoryDataset({self.name}, {self.graph!r})"


def random_graph(
    num_node: int,
    avg_degree: float,
    num_features: int = 32,
    num_classes: int = 4,
    seed: int = 0,
    weighted: bool = False,
) -> Graph:
    """Erdos–Renyi-ish random graph with random features/labels."""
    rng = np.random.default_rng(seed)
    num_edges = int(num_node * avg_degree / 2)
    row = rng.integers(0, num_node, size=num_edges)
    col = rng.integers(0, num_node, size=num_edges)
    keep = row != col
    row, col = row[keep], col[keep]
    w = rng.uniform(0.5, 1.5, size=row.shape).astype(np.float32) if weighted else np.ones(row.shape, np.float32)
    x = rng.normal(size=(num_node, num_features)).astype(np.float32)
    y = rng.integers(0, num_classes, size=num_node)
    return Graph(row, col, w, num_node, "UUU" if not weighted else "UUW", x=x, y=y)


def powerlaw_graph(
    num_node: int,
    avg_degree: float,
    num_features: int = 32,
    num_classes: int = 4,
    exponent: float = 2.2,
    seed: int = 0,
) -> Graph:
    """Power-law random graph via degree-weighted endpoint sampling: the
    hub-heavy stress case for the hybrid format's COO tail."""
    rng = np.random.default_rng(seed)
    w = (np.arange(1, num_node + 1, dtype=np.float64)) ** (-1.0 / (exponent - 1.0))
    rng.shuffle(w)
    p = w / w.sum()
    num_edges = int(num_node * avg_degree / 2)
    row = rng.choice(num_node, size=num_edges, p=p)
    col = rng.choice(num_node, size=num_edges, p=p)
    keep = row != col
    row, col = row[keep], col[keep]
    x = rng.normal(size=(num_node, num_features)).astype(np.float32)
    y = rng.integers(0, num_classes, size=num_node)
    return Graph(row, col, np.ones(row.shape[0], np.float32), num_node, "UUU",
                 x=x, y=y)


def sbm_graph(
    num_node: int = 1200,
    num_classes: int = 4,
    num_features: int = 64,
    p_in: float = 0.02,
    p_out: float = 0.002,
    feature_signal: float = 1.0,
    seed: int = 0,
    feature_mode: str = "gaussian",
    words_per_node: int = 12,
) -> Graph:
    """Stochastic-block-model graph with class-correlated features
    (``feature_mode`` ``gaussian``: class mean plus unit noise; ``binary``:
    bag-of-words drawn from a class topic distribution)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=num_node)
    n_cand = int(num_node * num_node * max(p_in, p_out) * 1.2) + 1
    r = rng.integers(0, num_node, size=n_cand)
    c = rng.integers(0, num_node, size=n_cand)
    same = y[r] == y[c]
    u = rng.uniform(size=n_cand)
    p_max = max(p_in, p_out)
    accept = np.where(same, u < p_in / p_max, u < p_out / p_max)
    accept &= r != c
    rows, cols = r[accept], c[accept]
    if feature_mode == "binary":
        purity = float(np.clip(feature_signal, 0.0, 1.0))
        topic = np.full((num_classes, num_features), (1.0 - purity))
        per_class = max(num_features // num_classes, 1)
        for k in range(num_classes):
            lo = (k * per_class) % num_features
            idx = (lo + np.arange(per_class)) % num_features
            topic[k, idx] += purity * num_classes
        topic /= topic.sum(axis=1, keepdims=True)
        x = np.zeros((num_node, num_features))
        for k in range(num_classes):
            nodes_k = np.where(y == k)[0]
            if nodes_k.size == 0:
                continue
            draws = rng.choice(
                num_features, size=(nodes_k.size, words_per_node),
                p=topic[k],
            )
            x[nodes_k[:, None], draws] = 1.0
    elif feature_mode == "gaussian":
        means = rng.normal(
            scale=feature_signal, size=(num_classes, num_features)
        )
        x = means[y] + rng.normal(size=(num_node, num_features))
    else:
        raise ValueError(f"unknown feature_mode {feature_mode!r}")
    w = np.ones(rows.shape, np.float32)
    return Graph(rows, cols, w, num_node, "UUU", x=x.astype(np.float32), y=y)


def planetoid_like(
    num_node: int = 1200,
    num_classes: int = 4,
    num_features: int = 64,
    train_per_class: int = 20,
    num_val: int = 200,
    num_test: int = 400,
    seed: int = 0,
    **sbm_kwargs,
) -> InMemoryDataset:
    """SBM graph + the Planetoid split protocol: ``train_per_class`` per
    class, then ``num_val`` val and ``num_test`` test nodes (scaled down
    proportionally on small graphs)."""
    g = sbm_graph(num_node, num_classes, num_features, seed=seed, **sbm_kwargs)
    rng = np.random.default_rng(seed + 1)
    train = []
    for k in range(num_classes):
        idx_k = np.where(g.y == k)[0]
        train.extend(rng.permutation(idx_k)[:train_per_class])
    train = np.sort(np.asarray(train))
    rest = np.setdiff1d(np.arange(num_node), train)
    rest = rng.permutation(rest)
    if num_val + num_test > rest.shape[0]:
        if rest.shape[0] < 2:
            raise ValueError(
                f"only {rest.shape[0]} nodes left after the train split; "
                f"cannot form non-empty val and test sets"
            )
        scale = rest.shape[0] / (num_val + num_test)
        num_val = min(max(int(num_val * scale), 1), rest.shape[0] - 1)
        num_test = rest.shape[0] - num_val
    val = np.sort(rest[:num_val])
    test = np.sort(rest[num_val : num_val + num_test])
    return InMemoryDataset(g, train, val, test, name=f"sbm_{num_node}")


def community_graph(
    num_nodes: int, comm: int = 512, intra_deg: int = 10, inter_deg: int = 2,
    seed: int = 0,
):
    """Community graph with shuffled node ids: ``intra_deg`` edges a node
    inside its ``comm``-node community, ``inter_deg`` to uniform nodes. The
    input whose clustered structure the locality pipeline (LPA ->
    ``reorder_tiled``) must discover itself. Returns a symmetric scipy CSR
    with unit weights."""
    import scipy.sparse as sp

    n = num_nodes
    rng = np.random.default_rng(seed)
    base = (np.arange(n, dtype=np.int64) // comm) * comm
    r_in = np.repeat(np.arange(n, dtype=np.int64), intra_deg)
    # clip: the last community is truncated when comm does not divide n
    c_in = np.minimum(base[r_in] + rng.integers(0, comm, r_in.shape), n - 1)
    r_out = np.repeat(np.arange(n, dtype=np.int64), inter_deg)
    c_out = rng.integers(0, n, r_out.shape)
    r = np.concatenate([r_in, r_out])
    c = np.concatenate([c_in, c_out])
    keep = r != c
    shuf = rng.permutation(n)
    adj = sp.coo_matrix(
        (np.ones(keep.sum(), np.float32), (shuf[r[keep]], shuf[c[keep]])),
        shape=(n, n),
    )
    adj = (adj + adj.T).tocsr()
    adj.data[:] = 1.0
    return adj


def nested_community_graph(
    num_nodes: int, comm: int = 512, group: int = 4, intra_deg: int = 10,
    sib_deg: int = 2, uni_deg: int = 1, seed: int = 0,
):
    """Two-level community graph with shuffled ids: ``comm``-node
    communities nested in ``comm * group``-node super-communities. Edges of a
    node: ``intra_deg`` inside its community, ``sib_deg`` into a sibling
    community of its super-community, ``uni_deg`` to uniform nodes. Returns
    a symmetric scipy CSR with unit weights."""
    import scipy.sparse as sp

    n = num_nodes
    rng = np.random.default_rng(seed)
    cluster_of = np.arange(n, dtype=np.int64) // comm
    group_base = (cluster_of // group) * group
    r_in = np.repeat(np.arange(n, dtype=np.int64), intra_deg)
    c_in = np.minimum(
        cluster_of[r_in] * comm + rng.integers(0, comm, r_in.shape), n - 1
    )
    r_s = np.repeat(np.arange(n, dtype=np.int64), sib_deg)
    sib = group_base[r_s] + rng.integers(0, group, r_s.shape)
    sib = np.where(sib == cluster_of[r_s],
                   group_base[r_s] + (sib - group_base[r_s] + 1) % group, sib)
    c_s = np.minimum(sib * comm + rng.integers(0, comm, r_s.shape), n - 1)
    r_u = np.repeat(np.arange(n, dtype=np.int64), uni_deg)
    c_u = rng.integers(0, n, r_u.shape)
    r = np.concatenate([r_in, r_s, r_u])
    c = np.concatenate([c_in, c_s, c_u])
    keep = r != c
    shuf = rng.permutation(n)
    adj = sp.coo_matrix(
        (np.ones(keep.sum(), np.float32), (shuf[r[keep]], shuf[c[keep]])),
        shape=(n, n),
    )
    adj = (adj + adj.T).tocsr()
    adj.data[:] = 1.0
    return adj
