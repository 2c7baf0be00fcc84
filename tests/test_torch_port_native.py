"""The port's host library (``ssrg_torch/csrc/graphbuild.cpp`` through
``ssrg_torch.native``) against ``ssrg_tpu.native``, on the CPU.

``ssrg_tpu.native`` runs in both of its tiers, its C++ library and its numpy
fallback (forced as ``tests/test_native.py``'s ``tier`` fixture forces it),
and the port's numpy versions (``*_plain``) stand beside them. Labels, packs,
degrees and unweighted edge lists must be equal entry for entry; weighted
sums and normalization weights within 1e-6 relative (float32 sums in
another order or precision)."""

import os

import numpy as np
import pytest
import scipy.sparse as sp

from ssrg_tpu import native as ref_native
from ssrg_tpu.ops import normalize as ref_normalize

from ssrg_torch import native
from ssrg_torch.data import synthetic
from ssrg_torch.data.graph import Graph
from ssrg_torch.ops import _nvcc


@pytest.fixture(params=["native", "fallback"])
def ref_tier(request, monkeypatch):
    if request.param == "native":
        if not ref_native.available():
            pytest.skip("ssrg_tpu's native library unavailable")
    else:
        monkeypatch.setattr(ref_native, "load_library", lambda: None)
    return request.param


def _edges(n=300, e=2000, seed=0, weighted=True):
    """Random directed edges with duplicates and self loops."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, e)
    cols = rng.integers(0, n, e)
    rows[:20], cols[:20] = np.arange(20), np.arange(20)          # self loops
    rows[20:40], cols[20:40] = cols[40:60], rows[40:60]           # both directions
    w = rng.uniform(0.5, 2.0, e).astype(np.float32) if weighted else None
    return rows, cols, w


def _with_pair(adj: sp.csr_matrix) -> sp.csr_matrix:
    """``adj`` plus two nodes joined only to each other: under synchronous
    sweeps they swap labels forever, 2 changes a sweep."""
    pair = sp.csr_matrix(np.array([[0, 1], [1, 0]], np.float32))
    return sp.block_diag([adj, pair], format="csr")


def _empty_rows(adj: sp.csr_matrix, every: int = 7) -> sp.csr_matrix:
    keep = np.ones(adj.shape[0], np.float32)
    keep[::every] = 0.0
    d = sp.diags(keep)
    out = (d @ adj @ d).tocsr()
    out.eliminate_zeros()
    return out


LPA_GRAPHS = {
    "community": lambda: synthetic.community_graph(3000, comm=256, seed=1),
    "nested_community": lambda: synthetic.nested_community_graph(4000, comm=128, group=4,
                                                                  seed=5),
    "random": lambda: synthetic.random_graph(2000, 5.0, 4, seed=7).adj,
    "empty_rows": lambda: _empty_rows(synthetic.community_graph(2500, comm=200, seed=2)),
    # n = 3,000: once the communities settle, a sweep of 2 changes is <= n //
    # 1000 = 3, so the stop rule ends the run while the pair still swaps
    "pair_stops_at_n_over_1000": lambda: _with_pair(
        synthetic.community_graph(2998, comm=256, seed=3)),
    # n = 1,500: 2 changes > n // 1000 = 1, so the run goes on to max_sweeps
    "pair_runs_to_max_sweeps": lambda: _with_pair(
        synthetic.community_graph(1498, comm=256, seed=4)),
}


@pytest.mark.parametrize("max_sweeps", [1, 20])
@pytest.mark.parametrize("graph", sorted(LPA_GRAPHS))
def test_lpa_cluster_matches_reference(graph, max_sweeps, ref_tier):
    adj = LPA_GRAPHS[graph]()
    got = native.lpa_cluster(adj.indptr, adj.indices, max_sweeps)
    plain = native.lpa_cluster_plain(adj.indptr, adj.indices, max_sweeps)
    ref = ref_native.lpa_cluster(adj.indptr, adj.indices, max_sweeps)
    assert got.dtype == plain.dtype == ref.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(plain, ref)
    if max_sweeps > 1 and graph != "random":
        assert 1 < np.unique(got).size < adj.shape[0]


def _one_sweep(adj: sp.csr_matrix, labels: np.ndarray) -> np.ndarray:
    """One synchronous sweep, row by row: the most frequent neighbour label,
    ties to the smallest."""
    new = labels.copy()
    for v in range(adj.shape[0]):
        nb = labels[adj.indices[adj.indptr[v]:adj.indptr[v + 1]]]
        if nb.size:
            vals, counts = np.unique(nb, return_counts=True)
            new[v] = vals[np.argmax(counts)]
    return new


def test_lpa_cluster_stops_once_at_most_n_over_1000_labels_change():
    adj = LPA_GRAPHS["pair_stops_at_n_over_1000"]()
    labels = native.lpa_cluster(adj.indptr, adj.indices, 20)
    # stopped by the rule, not by convergence: one more sweep still changes
    # the pair's 2 labels (<= n // 1000), and nothing else
    assert int((_one_sweep(adj, labels) != labels).sum()) == 2 <= adj.shape[0] // 1000
    adj = LPA_GRAPHS["pair_runs_to_max_sweeps"]()
    at_cap = native.lpa_cluster(adj.indptr, adj.indices, 20)
    one_less = native.lpa_cluster(adj.indptr, adj.indices, 19)
    assert int((at_cap != one_less).sum()) == 2 > adj.shape[0] // 1000


@pytest.mark.parametrize("clamp_unit", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
def test_symmetrize_edges_matches_reference(weighted, clamp_unit, ref_tier):
    rows, cols, w = _edges(weighted=weighted)
    got = native.symmetrize_edges(rows, cols, w, 300, clamp_unit=clamp_unit)
    plain = native.symmetrize_edges_plain(rows, cols, w, 300, clamp_unit=clamp_unit)
    ref = ref_native.symmetrize_edges(rows, cols, w, 300, clamp_unit=clamp_unit)
    for out in (got, plain):
        np.testing.assert_array_equal(out[0], ref[0])
        np.testing.assert_array_equal(out[1], ref[1])
        assert [a.dtype for a in out] == [a.dtype for a in ref]
        if weighted and not clamp_unit:
            np.testing.assert_allclose(out[2], ref[2], rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(out[2], ref[2])
    assert not np.any(got[0] == got[1])
    key = got[0] * 300 + got[1]
    assert np.all(np.diff(key) > 0)          # sorted by (row, col), coalesced


def test_symmetrize_edges_of_no_edges():
    out = native.symmetrize_edges(np.zeros(0), np.zeros(0), None, 5)
    assert [a.size for a in out] == [0, 0, 0]


def test_graph_adj_symmetrizes_through_the_library():
    from ssrg_tpu.data.graph import Graph as RefGraph

    rows, cols, w = _edges(seed=4)
    for edge_type, weights in (("UUU", np.ones_like(w)), ("UUW", w)):
        got = Graph(rows, cols, weights, 300, edge_type).adj
        ref = RefGraph(rows, cols, weights, 300, edge_type).adj
        r, c, v = native.symmetrize_edges(rows, cols, weights, 300,
                                          clamp_unit=edge_type.endswith("U"))
        assert got.has_sorted_indices
        np.testing.assert_array_equal(got.indptr, np.searchsorted(r, np.arange(301)))
        np.testing.assert_array_equal(got.indices, c)
        np.testing.assert_array_equal(got.data, v)
        ref.sort_indices()
        np.testing.assert_array_equal(got.indptr, ref.indptr)
        np.testing.assert_array_equal(got.indices, ref.indices)
        np.testing.assert_allclose(got.data, ref.data, rtol=1e-6, atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_edge_degree_accumulate_matches_reference(seed, ref_tier):
    rows, cols, _ = _edges(n=500, e=5000, seed=seed)
    start = np.arange(500, dtype=np.int64)
    degs = {}
    for name, fn in (("got", native.edge_degree_accumulate),
                     ("plain", native.edge_degree_accumulate_plain),
                     ("ref", ref_native.edge_degree_accumulate)):
        deg = start.copy()
        fn(rows, cols, deg)
        degs[name] = deg
    np.testing.assert_array_equal(degs["got"], degs["ref"])
    np.testing.assert_array_equal(degs["plain"], degs["ref"])


def test_edge_degree_accumulate_refuses_other_degree_arrays():
    for fn in (native.edge_degree_accumulate, native.edge_degree_accumulate_plain):
        with pytest.raises(TypeError):
            fn(np.zeros(3), np.ones(3), np.zeros(4, np.int32))


@pytest.mark.parametrize("r", [0.5, 0.3])
def test_sym_norm_csr_matches_reference(r, ref_tier):
    rows, cols, w = _edges(n=200, e=1500, seed=3)
    adj = sp.csr_matrix((w, (rows, cols)), shape=(200, 200))
    adj = (adj + adj.T + sp.eye(200)).tocsr()
    adj = _empty_rows(adj, every=11)                     # rows with no entry: degree 0
    adj.sort_indices()
    ref = ref_native.sym_norm_csr(adj.indptr, adj.indices, adj.data.copy(), r)
    got = native.sym_norm_csr(adj.indptr, adj.indices, adj.data.copy(), r)
    plain = native.sym_norm_csr_plain(adj.indptr, adj.indices, adj.data.copy(), r)
    assert got.dtype == plain.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    np.testing.assert_allclose(plain, ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("width", [1, 4, 16])
def test_ell_hybrid_pack_matches_reference(width, ref_tier):
    csr = ref_normalize.sym_norm(synthetic.powerlaw_graph(600, 8.0, 4, seed=5).adj)
    n_pad = -(-csr.shape[0] // 8) * 8
    got = native.ell_hybrid_pack(csr.indptr, csr.indices, csr.data, width, n_pad)
    plain = native.ell_hybrid_pack_plain(csr.indptr, csr.indices, csr.data, width, n_pad)
    ref = ref_native.ell_hybrid_pack(csr.indptr, csr.indices, csr.data, width, n_pad)
    assert got[2].size > 0
    o_ref = np.argsort(ref[2], kind="stable")
    for out in (got, plain):
        for a, b in zip(out[:2], ref[:2]):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        # the C packers emit the tail in thread order: compare in row order
        o = np.argsort(out[2], kind="stable")
        for a, b in zip(out[2:], ref[2:]):
            np.testing.assert_array_equal(a[o], b[o_ref])
            assert a.dtype == b.dtype


@pytest.mark.parametrize("fn", [native.lpa_cluster, native.lpa_cluster_plain])
def test_lpa_cluster_refuses_more_than_int32_entries(fn):
    indices = np.broadcast_to(np.int32(0), (2**31,))     # no memory behind it
    with pytest.raises(ValueError, match="int32"):
        fn(np.zeros(2, np.int32), indices)


def test_a_missing_compiler_raises_without_a_fallback(tmp_path, monkeypatch):
    monkeypatch.setenv(_nvcc.CXX_ENV, str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(_nvcc, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    adj = synthetic.community_graph(600, comm=100, seed=0)
    with pytest.raises(RuntimeError, match="host build failed.*no-such-compiler"):
        native.lpa_cluster(adj.indptr, adj.indices)
    with pytest.raises(RuntimeError, match="host build failed"):
        native.available()
    with pytest.raises(RuntimeError, match="host build failed"):
        Graph(np.array([0, 1]), np.array([1, 2]), np.ones(2), 3).adj
    assert native._lib is None
    assert not (tmp_path / "build" / "libgraphbuild.so").exists()


def test_library_is_rebuilt_only_when_older_than_its_source(tmp_path, monkeypatch):
    monkeypatch.setattr(_nvcc, "BUILD_DIR", str(tmp_path))
    lib = tmp_path / "libgraphbuild.so"
    _nvcc.build_host(native.LIBRARY)
    built = lib.stat().st_ino
    _nvcc.build_host(native.LIBRARY)                     # up to date: kept
    assert lib.stat().st_ino == built
    src = os.path.getmtime(_nvcc.source(native.LIBRARY, ".cpp"))
    os.utime(lib, (src - 10, src - 10))
    _nvcc.build_host(native.LIBRARY)                     # stale: rebuilt, replaced
    assert lib.stat().st_ino != built and lib.stat().st_mtime >= src
    assert "-march=native" not in _nvcc.CXX_FLAGS


def test_omp_max_threads_is_positive():
    assert native.omp_max_threads() >= 1
