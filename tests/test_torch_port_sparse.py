"""Parity of the PyTorch port's graph data, packs, SpMM engines and K-hop
propagation with ``ssrg_tpu``, on the CPU.

Inputs come from numpy seeds and go through both packages; the JAX Pallas
engine runs in interpret mode, as ``tests/test_pallas_spmm.py`` runs it.
Packs must be equal entry for entry; SpMM agrees at rtol = atol = 3e-5
(float32 sums in another order), K = 3 hops at 1e-4.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ssrg_tpu import native as ref_native
from ssrg_tpu.cache import cached_propagate as ref_cached_propagate
from ssrg_tpu.data import synthetic as ref_synthetic
from ssrg_tpu.ops import normalize as ref_normalize
from ssrg_tpu.ops import sparse as ref_sparse
from ssrg_tpu.ops.pallas_spmm import build_pallas_csr as ref_build_pallas
from ssrg_tpu.ops.propagate import propagate as ref_propagate

from ssrg_torch import native
from ssrg_torch.cache import cached_propagate
from ssrg_torch.data import synthetic
from ssrg_torch.ops import normalize, sparse
from ssrg_torch.ops.pallas_spmm import PallasELLAdj, build_pallas_csr
from ssrg_torch.ops.propagate import propagate

CPU = "cpu"
ENGINES = ["dense", "coo", "ell", "hybrid", "pallas"]


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")


def _hub_csr(n=300, seed=3, hubs=(5, 17), hub_deg=60):
    """Random weighted CSR with a few hub rows far above the p95 degree."""
    rng = np.random.default_rng(seed)
    row = np.concatenate([rng.integers(0, n, 6 * n)]
                         + [np.full(hub_deg, h) for h in hubs])
    col = rng.integers(0, n, row.shape[0])
    val = rng.normal(size=row.shape[0]).astype(np.float32)
    adj = sp.csr_matrix((val, (row, col)), shape=(n, n))
    adj.sum_duplicates()
    return adj


def _arrays(obj):
    return [np.asarray(a) for a in obj]


GRAPHS = {
    "random": lambda m: m.random_graph(700, 9.0, 16, seed=1),
    "random_weighted": lambda m: m.random_graph(700, 9.0, 16, seed=2, weighted=True),
    "powerlaw": lambda m: m.powerlaw_graph(900, 8.0, 16, seed=3),
    "sbm": lambda m: m.sbm_graph(600, 4, 16, seed=4),
}


@pytest.mark.parametrize("kind", sorted(GRAPHS))
def test_graph_and_sym_norm_match_reference(kind):
    ref, got = GRAPHS[kind](ref_synthetic), GRAPHS[kind](synthetic)
    np.testing.assert_array_equal(got.x, ref.x)
    np.testing.assert_array_equal(got.y, ref.y)
    for a, b in ((got.adj, ref.adj),
                 (normalize.sym_norm(got.adj, 0.5), ref_normalize.sym_norm(ref.adj, 0.5))):
        b = b.tocsr()
        b.sort_indices()
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.data, b.data)


def test_planetoid_like_splits_match_reference():
    ref = ref_synthetic.planetoid_like(num_node=800, num_classes=4, num_features=48, seed=0)
    got = synthetic.planetoid_like(num_node=800, num_classes=4, num_features=48, seed=0)
    for name in ("train_idx", "val_idx", "test_idx"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ref, name))
    assert (got.adj != ref.adj).nnz == 0


@pytest.mark.parametrize("width", [1, 4, 16])
def test_ell_hybrid_pack_matches_native(width):
    csr = ref_normalize.sym_norm(ref_synthetic.powerlaw_graph(500, 8.0, 4, seed=5).adj)
    n_pad = -(-csr.shape[0] // 8) * 8
    got = native.ell_hybrid_pack(csr.indptr, csr.indices, csr.data, width, n_pad)
    ref = ref_native.ell_hybrid_pack(csr.indptr, csr.indices, csr.data, width, n_pad)
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    # the C packer emits the tail in thread order: compare in row order
    o_got = np.argsort(got[2], kind="stable")
    o_ref = np.argsort(ref[2], kind="stable")
    assert got[2].size > 0
    for a, b in zip(got[2:], ref[2:]):
        np.testing.assert_array_equal(a[o_got], b[o_ref])
        assert a.dtype == b.dtype


def _pack_arrays(adj):
    if isinstance(adj, (sparse.COOAdj, ref_sparse.COOAdj)):
        return _arrays((adj.row, adj.col, adj.val)) + [adj.n_rows, adj.n_cols, adj.chunk]
    if isinstance(adj, (sparse.ELLAdj, ref_sparse.ELLAdj)):
        return _arrays((adj.cols, adj.vals)) + [adj.n_rows, adj.n_cols, adj.row_block]
    if isinstance(adj, (sparse.HybridAdj, ref_sparse.HybridAdj)):
        return _pack_arrays(adj.ell) + _pack_arrays(adj.tail)
    return _arrays((adj.cols, adj.vals)) + [adj.n_rows, adj.n_cols] + _pack_arrays(adj.tail)


@pytest.mark.parametrize("engine", ["coo", "ell", "hybrid", "pallas"])
def test_packs_match_reference(engine):
    adj = _hub_csr()
    if engine == "pallas":
        ref, got = ref_build_pallas(adj, interpret=True), build_pallas_csr(adj)
    else:
        ref = getattr(ref_sparse, f"build_{engine}")(adj)
        got = getattr(sparse, f"build_{engine}")(adj)
    for a, b in zip(_pack_arrays(got), _pack_arrays(ref), strict=True):
        np.testing.assert_array_equal(a, b)


def _ref_adjacency(adj, engine):
    if engine == "pallas":
        return ref_build_pallas(adj, interpret=True)
    return ref_sparse.device_adjacency(adj, engine)


@pytest.mark.parametrize("f", [48, 128])
@pytest.mark.parametrize("engine", ENGINES)
def test_spmm_matches_reference(engine, f):
    adj = _hub_csr()
    x = np.random.default_rng(f).normal(size=(adj.shape[0], f)).astype(np.float32)
    got = sparse.device_adjacency(adj, engine, device=CPU)
    if engine in ("hybrid", "pallas"):
        assert int((got.tail.val != 0).sum()) > 0  # the hubs overflow into the tail
    ref = np.asarray(_ref_adjacency(adj, engine).spmm(x))
    out = got.spmm(torch.from_numpy(x))
    assert out.shape == (adj.shape[0], f) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(out.numpy(), adj @ x, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("engine", ENGINES)
def test_propagate_matches_reference(engine):
    ref_adj = ref_normalize.sym_norm(ref_synthetic.powerlaw_graph(400, 8.0, 4, seed=6).adj)
    x = np.random.default_rng(7).normal(size=(400, 48)).astype(np.float32)
    ref = np.asarray(ref_propagate(_ref_adjacency(ref_adj, engine), x, 3))
    hops = propagate(sparse.device_adjacency(ref_adj, engine, device=CPU), x, 3, device=CPU)
    assert hops.shape == (4, 400, 48)
    np.testing.assert_allclose(hops.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_device_adjacency_dispatch_and_refusals():
    adj = _hub_csr(n=64)
    assert isinstance(sparse.device_adjacency(adj, device=CPU), sparse.DenseAdj)
    assert isinstance(sparse.device_adjacency(adj, dense_threshold=32, device=CPU),
                      sparse.HybridAdj)
    assert isinstance(sparse.device_adjacency(adj, "pallas", device=CPU), PallasELLAdj)
    assert isinstance(sparse.device_adjacency(adj, "banded", device=CPU), sparse.BandedAdj)
    assert isinstance(sparse.device_adjacency(adj, "blockcoo", device=CPU), sparse.BlockCOOAdj)
    assert isinstance(sparse.device_adjacency(adj, "tiled", device=CPU), sparse.TiledAdj)
    with pytest.raises(ValueError):
        sparse.device_adjacency(adj, "nope", device=CPU)


def test_cached_propagate_shares_the_reference_cache(tmp_path):
    adj = ref_normalize.sym_norm(ref_synthetic.random_graph(300, 6.0, 4, seed=8).adj)
    x = np.random.default_rng(9).normal(size=(300, 16)).astype(np.float32)
    ours = cached_propagate(adj, x, 3, str(tmp_path), "hybrid", tag="sym:0.5", device=CPU)
    files = sorted(p.name for p in tmp_path.iterdir())
    assert len(files) == 1 and files[0].startswith("hops_")
    theirs = np.asarray(ref_cached_propagate(adj, x, 3, str(tmp_path), "hybrid", tag="sym:0.5"))
    assert sorted(p.name for p in tmp_path.iterdir()) == files  # read, not recomputed
    np.testing.assert_array_equal(theirs, ours.numpy())
    again = cached_propagate(adj, x, 3, str(tmp_path), "hybrid", tag="sym:0.5", device=CPU)
    np.testing.assert_array_equal(again.numpy(), ours.numpy())


def test_entry_points_default_to_cuda(no_cuda):
    adj = _hub_csr(n=64)
    x = np.ones((64, 4), np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        sparse.device_adjacency(adj, "hybrid")
    with pytest.raises(RuntimeError, match="cuda"):
        sparse.build_hybrid(adj).to("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        propagate(sparse.device_adjacency(adj, "hybrid", device=CPU), x, 2)
