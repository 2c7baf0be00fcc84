"""The data of a run, drawn on the device from ``--seed``.

One generator serves every configuration: the power-law rule of the port's
``ssrg_torch/data/synthetic.py::powerlaw_graph`` (each endpoint drawn with
probability proportional to ``i ** (-1 / (exponent - 1))`` over shuffled
node ids), rewritten to draw on the device and to hit the dataset's edge
count exactly:

1. draw ``oversample * num_edges`` endpoint pairs by inverse CDF
   (``searchsorted`` on the cumulative weights, float64);
2. drop self-loops, order each pair ``(lo, hi)`` and keep the distinct
   pairs;
3. keep a uniform random ``num_edges`` of them.

So every seed gives a graph with the same number of nodes, undirected
edges, features and classes; only which node is a hub changes. Features are
unit normals, labels uniform over the classes, and the split sizes are the
dataset's, drawn as one permutation of the nodes.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

# seeds are any whole number up to a little over 2**31; the generators
# below take a 64-bit seed, so each stream gets its own offset
_STREAMS = {"graph": 0, "features": 1, "split": 2, "weights": 3, "dropout": 4,
            "traffic": 5, "sample": 6}


def stream_seed(seed: int, stream: str) -> int:
    """The seed of one named random stream of a run (a 64-bit mix of the
    run's seed and the stream's number)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + _STREAMS[stream] * 0xBF58476D1CE4E5B9)
    x &= (1 << 64) - 1
    x ^= x >> 31
    return x & ((1 << 63) - 1)


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


@dataclass
class GraphData:
    """One undirected graph, each edge once (``lo < hi``), with features,
    labels and the split, all on one device."""

    num_nodes: int
    lo: torch.Tensor         # int64 [E]
    hi: torch.Tensor         # int64 [E]
    x: torch.Tensor          # f32 [N, F]
    y: torch.Tensor          # int64 [N]
    train_idx: torch.Tensor  # int64, sorted
    val_idx: torch.Tensor
    test_idx: torch.Tensor

    @property
    def num_edges(self) -> int:
        return int(self.lo.numel())

    @property
    def nnz(self) -> int:
        """Nonzeros of the symmetric adjacency with self-loops, ``A + I``."""
        return 2 * self.num_edges + self.num_nodes

    def degrees(self) -> torch.Tensor:
        """Degree of each node in ``A`` (without its self-loop)."""
        n = self.num_nodes
        return (torch.bincount(self.lo, minlength=n) + torch.bincount(self.hi, minlength=n))


def powerlaw_edges(num_nodes: int, num_edges: int, exponent: float, oversample: float,
                   gen: torch.Generator, device) -> tuple:
    """``num_edges`` distinct undirected pairs ``(lo, hi)``, ``lo < hi``,
    sorted by ``(lo, hi)``; raises ``ValueError`` when the draws leave too
    few distinct pairs (raise ``oversample``)."""
    n = num_nodes
    w = torch.arange(1, n + 1, dtype=torch.float64, device=device) ** (-1.0 / (exponent - 1.0))
    w = w[torch.randperm(n, generator=gen, device=device)]
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    draws = int(num_edges * oversample)
    u = torch.rand((2, draws), generator=gen, dtype=torch.float64, device=device)
    ends = torch.searchsorted(cdf, u).clamp_(max=n - 1)
    del u, cdf, w
    a, b = ends[0], ends[1]
    keep = a != b
    key = torch.minimum(a, b)[keep] * n + torch.maximum(a, b)[keep]
    del ends, a, b, keep
    key = torch.unique(key)
    if key.numel() < num_edges:
        raise ValueError(f"only {key.numel()} distinct pairs in {draws} draws; "
                         f"{num_edges} wanted: raise oversample")
    pick = torch.randperm(key.numel(), generator=gen, device=device)[:num_edges]
    key = torch.sort(key[pick]).values
    return key // n, key % n


def make_graph(dataset: dict, graph: dict, seed: int, device) -> GraphData:
    """The configuration's graph (``dataset``: sizes; ``graph``: the
    generator's parameters), drawn from ``seed``."""
    n = int(dataset["num_nodes"])
    lo, hi = powerlaw_edges(n, int(dataset["num_edges"]), float(graph["exponent"]),
                            float(graph["oversample"]), generator(seed, "graph", device),
                            device)
    g = generator(seed, "features", device)
    x = torch.randn((n, int(dataset["num_features"])), generator=g, device=device)
    y = torch.randint(0, int(dataset["num_classes"]), (n,), generator=g, device=device)
    n_tr, n_va, n_te = (int(s) for s in dataset["split"])
    if n_tr + n_va + n_te > n:
        raise ValueError("the split holds more nodes than the graph")
    perm = torch.randperm(n, generator=generator(seed, "split", device), device=device)
    parts = [torch.sort(p).values for p in
             (perm[:n_tr], perm[n_tr:n_tr + n_va], perm[n_tr + n_va:n_tr + n_va + n_te])]
    return GraphData(n, lo, hi, x, y, *parts)
