"""Parity of the port's graph operators (``ssrg_torch/ops/normalize.py``,
``GRAPH_OPS``), of ``Graph(symmetrize=False)`` and of the complex and
multi-adjacency propagation with ``ssrg_tpu``, on the CPU.

Both packages compute every operator in float64 with numpy/scipy and store
it as float32 (``ppr_norm`` as float64 in both); the port's copy of the
code is the reference's, so the matrices agree entry for entry (1e-6
relative) and each size guard raises ``ValueError`` at the same size with
the same message. Propagation agrees at 1e-5 (K = 3 hops of float32 sums
in another order) on every engine, the Pallas one in interpret mode.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ssrg_tpu.configs.config import ModelConfig as RefModelConfig
from ssrg_tpu.data.graph import Graph as RefGraph
from ssrg_tpu.data.synthetic import sbm_graph as ref_sbm_graph
from ssrg_tpu.models.zoo import GRAPH_OPS as REF_GRAPH_OPS
from ssrg_tpu.ops import normalize as ref_normalize
from ssrg_tpu.ops import propagate as ref_propagate
from ssrg_tpu.ops.sparse import device_adjacency as ref_device_adjacency

from ssrg_torch.configs.config import ModelConfig
from ssrg_torch.data.graph import Graph
from ssrg_torch.data.synthetic import sbm_graph
from ssrg_torch.models.zoo import GRAPH_OPS
from ssrg_torch.ops import normalize, propagate
from ssrg_torch.ops.sparse import device_adjacency

CPU = "cpu"


def directed_edges(n=300, m=3000, c=3, seed=3):
    """The directed-signal graph of ``tests/test_end_to_end.py``: an edge
    mostly goes from class k to class k+1, with duplicates and self-loops
    left in for the graph to drop."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, c, n)
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    keep = ((y[src] + 1) % c == y[dst]) | (rng.uniform(size=m) < 0.1)
    return src[keep], dst[keep], y


@pytest.fixture(scope="module")
def graphs():
    """name -> adjacency, the same scipy matrix for both packages."""
    src, dst, _ = directed_edges()
    n = 300
    w = np.random.default_rng(4).uniform(0.5, 2.0, src.shape[0]).astype(np.float32)
    out = {
        "directed": Graph(src, dst, np.ones(src.shape[0], np.float32), n,
                          symmetrize=False).adj,
        "directed_weighted": Graph(src, dst, w, n, "UUW", symmetrize=False).adj,
        "sbm": sbm_graph(250, 3, 8, p_in=0.05, p_out=0.005, seed=1).adj,
    }
    # a node with no edge at all: zero degrees take the inf -> 0 guards
    lonely = out["directed"].tolil()
    lonely[7, :] = 0
    lonely[:, 7] = 0
    out["directed_isolated"] = lonely.tocsr()
    out["directed_isolated"].eliminate_zeros()
    return out


@pytest.fixture(scope="module")
def directed_small():
    """A 160-node directed graph with features, for the propagation tests."""
    src, dst, y = directed_edges(n=160, m=1600, seed=5)
    x = np.random.default_rng(5).normal(size=(160, 16)).astype(np.float32)
    return Graph(src, dst, np.ones(src.shape[0], np.float32), 160, x=x, y=y,
                 symmetrize=False)


def _assert_same(got, want):
    # (ppr_norm's sum with sp.eye is float64 in both packages)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got.toarray(), want.toarray(), rtol=1e-6, atol=1e-7)
    # stored entries too: explicit zeros (the magnetic imaginary part's) count
    assert got.nnz == want.nnz


OPERATORS = {  # name: (port call, reference call)
    "sym_r0.5": (lambda a: normalize.sym_norm(a, 0.5), lambda a: ref_normalize.sym_norm(a, 0.5)),
    "sym_r0.3": (lambda a: normalize.sym_norm(a, 0.3), lambda a: ref_normalize.sym_norm(a, 0.3)),
    "ppr": (lambda a: normalize.ppr_norm(a, 0.5, 0.15),
            lambda a: ref_normalize.ppr_norm(a, 0.5, 0.15)),
    "magnetic": (lambda a: normalize.magnetic_norm(a, 0.5, 0.05),
                 lambda a: ref_normalize.magnetic_norm(a, 0.5, 0.05)),
    "magnetic_q0.25_r0.3": (lambda a: normalize.magnetic_norm(a, 0.3, 0.25),
                            lambda a: ref_normalize.magnetic_norm(a, 0.3, 0.25)),
    "magnetic_pygsd": (lambda a: normalize.magnetic_pygsd_norm(a, 0.5, 0.05),
                       lambda a: ref_normalize.magnetic_pygsd_norm(a, 0.5, 0.05)),
    "magnetic_com_ppr": (lambda a: normalize.magnetic_com_ppr_norm(a, 0.5, 0.25, 0.15),
                         lambda a: ref_normalize.magnetic_com_ppr_norm(a, 0.5, 0.25, 0.15)),
    "un_in_out": (lambda a: normalize.un_in_out_norm(a, 0.5),
                  lambda a: ref_normalize.un_in_out_norm(a, 0.5)),
    "fast_ppr": (lambda a: normalize.fast_ppr_approx_norm(a, 0.5, 0.1),
                 lambda a: ref_normalize.fast_ppr_approx_norm(a, 0.5, 0.1)),
    "two_order": (lambda a: normalize.two_order_ppr_approx_norm(a, 0.5, 0.1),
                  lambda a: ref_normalize.two_order_ppr_approx_norm(a, 0.5, 0.1)),
}


@pytest.mark.parametrize("graph", ["directed", "directed_weighted", "directed_isolated", "sbm"])
@pytest.mark.parametrize("op", sorted(OPERATORS))
def test_operator_matches_reference(graphs, op, graph):
    ours, theirs = OPERATORS[op]
    got, want = ours(graphs[graph]), theirs(graphs[graph])
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    else:
        _assert_same(got, want)


def test_magnetic_imaginary_part_stores_its_zeros(graphs):
    """sin(0) = 0 on every reciprocal edge and self-loop is a stored entry:
    the imaginary part has the real part's pattern, zeros included."""
    re, im = normalize.magnetic_norm(graphs["directed"], 0.5, 0.05)
    assert re.nnz == im.nnz and np.array_equal(re.indices, im.indices)
    assert (im.data == 0).sum() >= graphs["directed"].shape[0]   # every self-loop
    assert (im.toarray() == -im.toarray().T).all()               # antisymmetric


@pytest.mark.parametrize("name", sorted(REF_GRAPH_OPS))
def test_graph_ops_registry_matches_reference(graphs, name):
    """Every graph op of the reference's registry, with non-default r, q and
    ppr_alpha read from the configs."""
    kw = dict(r=0.4, q=0.1, ppr_alpha=0.2)
    got = GRAPH_OPS[name](graphs["directed"], ModelConfig(**kw))
    want = REF_GRAPH_OPS[name](graphs["directed"], RefModelConfig(**kw))
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        _assert_same(g, w)
    assert set(GRAPH_OPS) == set(REF_GRAPH_OPS)


def test_two_order_guard_refuses_at_the_same_size(graphs):
    adj = graphs["sbm"]
    for fn in (normalize.two_order_ppr_approx_norm, ref_normalize.two_order_ppr_approx_norm):
        fn(adj, 0.5, 0.1, max_nodes=250)
    messages = []
    for fn in (normalize.two_order_ppr_approx_norm, ref_normalize.two_order_ppr_approx_norm):
        with pytest.raises(ValueError, match="max_nodes=249") as err:
            fn(adj, 0.5, 0.1, max_nodes=249)
        messages.append(str(err.value))
    assert messages[0] == messages[1] and "fast_ppr_approx_norm" in messages[0]


def test_un_in_out_guard_refuses_at_the_same_size(graphs):
    adj = graphs["directed"]
    a = (sp.csr_matrix((np.ones(adj.nnz), adj.nonzero()), shape=adj.shape)
         + sp.eye(adj.shape[0])).tocsr()
    est = int(max((np.asarray((a != 0).sum(axis=0)) ** 2).sum(),
                  (np.asarray((a != 0).sum(axis=1)) ** 2).sum()))
    for fn in (normalize.un_in_out_norm, ref_normalize.un_in_out_norm):
        fn(adj, 0.5, max_second_order_nnz=est)
    messages = []
    for fn in (normalize.un_in_out_norm, ref_normalize.un_in_out_norm):
        with pytest.raises(ValueError, match="max_second_order_nnz") as err:
            fn(adj, 0.5, max_second_order_nnz=est - 1)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("edge_type", ["UUU", "UUW"])
def test_directed_graph_matches_reference(edge_type):
    """``symmetrize=False`` keeps the edges as given: duplicates summed (and
    clamped to 1 for an unweighted type), self-loops dropped; the default
    still symmetrizes."""
    src, dst, y = directed_edges(n=200, m=1500, seed=7)
    src = np.concatenate([src, src[:20], np.arange(10)])          # duplicates, self-loops
    dst = np.concatenate([dst, dst[:20], np.arange(10)])
    w = np.random.default_rng(0).uniform(0.5, 2.0, src.shape[0]).astype(np.float32)
    for symmetrize in (False, True):
        got = Graph(src, dst, w, 200, edge_type, y=y, symmetrize=symmetrize).adj
        want = RefGraph(src, dst, w, 200, edge_type, y=y, symmetrize=symmetrize).adj
        np.testing.assert_array_equal(got.toarray(), want.toarray())
        assert got.diagonal().sum() == 0
        assert ((got != got.T).nnz == 0) == symmetrize


def test_sbm_graph_matches_reference():
    """The SBM the spectral tests use is the reference's, seed for seed."""
    got = sbm_graph(250, 3, 8, p_in=0.05, p_out=0.005, seed=1)
    want = ref_sbm_graph(250, 3, 8, p_in=0.05, p_out=0.005, seed=1)
    assert (got.adj != want.adj).nnz == 0 and np.array_equal(got.x, want.x)


# --- propagation ------------------------------------------------------------------

ENGINES = ["dense", "coo", "ell", "hybrid", "pallas"]


@pytest.mark.parametrize("engine", ENGINES)
def test_propagate_complex_matches_reference(directed_small, engine):
    """Four SpMMs a hop on the magnetic pair, whose imaginary part stores
    zeros; hop 0 of the imaginary stack is zeros."""
    ds = directed_small
    re_a, im_a = normalize.magnetic_norm(ds.adj, 0.5, 0.05)
    x = np.random.default_rng(0).normal(size=(ds.num_node, 16)).astype(np.float32)
    want = ref_propagate.propagate_complex(ref_device_adjacency(re_a, engine),
                                           ref_device_adjacency(im_a, engine), x, 3)
    got = propagate.propagate_complex(device_adjacency(re_a, engine, device=CPU),
                                      device_adjacency(im_a, engine, device=CPU), x, 3,
                                      device=CPU)
    for g, w in zip(got, want):
        assert g.shape == (4, ds.num_node, 16)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    assert not got[1][0].any() and torch.equal(got[0][0], torch.from_numpy(x))


@pytest.mark.parametrize("engine", ENGINES)
def test_propagate_multi_matches_reference(directed_small, engine):
    """The un/in/out triple, each with its own hop stack."""
    ds = directed_small
    triple = normalize.un_in_out_norm(ds.adj, 0.5)
    x = np.random.default_rng(1).normal(size=(ds.num_node, 16)).astype(np.float32)
    want = ref_propagate.propagate_multi(tuple(ref_device_adjacency(a, engine) for a in triple),
                                         x, 3)
    got = propagate.propagate_multi([device_adjacency(a, engine, device=CPU) for a in triple],
                                    x, 3, device=CPU)
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
