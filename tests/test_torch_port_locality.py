"""Parity of the PyTorch port's locality tier with ``ssrg_tpu``, on the CPU:
the community generators, label propagation and the reorderings, the
banded, tiled, bucketed-COO and segmented-rest packs, their SpMM engines,
and ``prepare``/``Predictor`` under ``reorder_banded``, ``reorder_tiled``
and ``autotune``.

Inputs come from numpy seeds and go through both packages; the reference's
Pallas engines run in interpret mode, as ``tests/test_pallas_banded.py`` and
``tests/test_pallas_rest.py`` run them. Permutations and packs must be equal
entry for entry. One SpMM agrees at rtol = atol = 3e-5, in f32 and in bf16
alike: on the same input both packages round the same operands to bf16 at
the same points, and bf16 x bf16 products are exact in f32, so only the
order of the f32 sums differs. K = 3 hops agree at 1e-4 in f32 and at 2e-2
with ``spmm_bf16``: there the f32 sums of one hop, equal to about 1e-6, can
round to neighbouring bf16 values (2^-8 apart, relative) at the next hop;
2e-2 is the reference's own bf16 tolerance (``tests/test_pallas_banded.py``).
"""

import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ssrg_tpu import native as ref_native
from ssrg_tpu.configs.config import ModelConfig as RefModelConfig
from ssrg_tpu.configs.config import TrainingConfig as RefTrainingConfig
from ssrg_tpu.data import synthetic as ref_synthetic
from ssrg_tpu.models.zoo import load_model as ref_load_model
from ssrg_tpu.ops import autotune as ref_autotune
from ssrg_tpu.ops import normalize as ref_normalize
from ssrg_tpu.ops import reorder as ref_reorder
from ssrg_tpu.ops import sparse as ref_sparse
from ssrg_tpu.ops.pallas_banded import build_pallas_banded as ref_build_pallas_banded
from ssrg_tpu.ops.pallas_rest import RestSegmentedAdj as RefRestSegmentedAdj
from ssrg_tpu.ops.pallas_rest import build_rest_segmented as ref_build_rest
from ssrg_tpu.serve import Predictor as RefPredictor
from ssrg_tpu.train.node_classification import prepare as ref_prepare

from ssrg_torch import native
from ssrg_torch.configs.config import ModelConfig, TrainingConfig
from ssrg_torch.convert import params_from_jax
from ssrg_torch.data import synthetic
from ssrg_torch.models.zoo import load_model
from ssrg_torch.ops import autotune, reorder, sparse
from ssrg_torch.ops.pallas_banded import PallasBandedAdj, build_pallas_banded
from ssrg_torch.ops.pallas_rest import RestSegmentedAdj, build_rest_segmented
from ssrg_torch.serve import Predictor
from ssrg_torch.train.node_classification import prepare

CPU = "cpu"
F32_TOL = dict(rtol=3e-5, atol=3e-5)
HOPS_TOL = {False: dict(rtol=1e-4, atol=1e-4), True: dict(rtol=2e-2, atol=2e-2)}
BF16 = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _banded_graph(n=700, deg=5, bw=60, seed=0, shuffle=False):
    """The recipe of tests/test_pallas_banded.py, ids optionally shuffled."""
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(n), deg)
    c = np.clip(r + rng.integers(-bw, bw + 1, r.shape), 0, n - 1)
    v = rng.normal(size=r.shape).astype(np.float32)
    if shuffle:
        keep = r != c
        r, c = r[keep], c[keep]
        perm = rng.permutation(n)
        adj = sp.coo_matrix((np.ones(r.size, np.float32), (perm[r], perm[c])), shape=(n, n))
        adj = (adj + adj.T).tocsr()
        adj.data[:] = 1.0
        return adj
    return sp.csr_matrix((v, (r, c)), shape=(n, n))


def _rest_matrix(n=700, m=None, deg=3.0, seed=0):
    rng = np.random.default_rng(seed)
    m = n if m is None else m
    e = int(n * deg)
    adj = sp.csr_matrix(
        (rng.uniform(0.1, 1.0, e).astype(np.float32),
         (rng.integers(0, n, e), rng.integers(0, m, e))), shape=(n, m))
    adj.sum_duplicates()
    return adj


def _clustered(n=1500, seed=5):
    return ref_normalize.sym_norm(ref_synthetic.community_graph(n, comm=256, seed=seed), 0.5)


def _x(n, f, seed=1):
    return np.random.default_rng(seed).normal(size=(n, f)).astype(np.float32)


def _np(a):
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _assert_same(got, ref):
    g, r = _np(got), _np(ref)
    assert g.shape == r.shape
    np.testing.assert_array_equal(g, r)


def _assert_all_same(got, ref):
    """Field by field: arrays entry for entry, other fields equal."""
    for a, b in zip(got, ref, strict=True):
        if isinstance(a, torch.Tensor):
            _assert_same(a, b)
        else:
            assert a == b


# --- data, label propagation, reorderings --------------------------------


@pytest.mark.parametrize("gen,kwargs", [
    ("community_graph", dict(num_nodes=3000, comm=128, seed=3)),
    ("community_graph", dict(num_nodes=2049, seed=4)),
    ("nested_community_graph", dict(num_nodes=4000, comm=128, group=4, seed=5)),
])
def test_community_generators_match_reference(gen, kwargs):
    got = getattr(synthetic, gen)(**kwargs)
    ref = getattr(ref_synthetic, gen)(**kwargs)
    for name in ("indptr", "indices", "data"):
        _assert_same(getattr(got, name), getattr(ref, name))


def test_lpa_cluster_matches_reference():
    adj = ref_synthetic.community_graph(6000, comm=256, seed=6)
    got = native.lpa_cluster(adj.indptr, adj.indices)
    ref = ref_native.lpa_cluster(adj.indptr, adj.indices)
    assert got.dtype == ref.dtype == np.int32
    assert 1 < np.unique(got).size < adj.shape[0]
    _assert_same(got, ref)


@pytest.mark.parametrize("method", ["degree", "rcm", "bfs", "cluster", "lpa", "cluster2",
                                    "hierarchical"])
def test_reorder_permutation_matches_reference(method):
    adj = ref_synthetic.nested_community_graph(3000, comm=64, group=4, seed=7)
    got = reorder.reorder_permutation(adj, method)
    _assert_same(got, ref_reorder.reorder_permutation(adj, method))
    assert np.array_equal(np.sort(got), np.arange(adj.shape[0]))


@pytest.mark.parametrize("order,merge_target", [("affinity", 0), ("size", 0),
                                                ("affinity", 300), ("size", 200)])
def test_cluster_permutation_matches_reference(order, merge_target):
    adj = ref_synthetic.nested_community_graph(2500, comm=50, group=4, seed=8)
    kw = dict(order=order, merge_target=merge_target)
    _assert_same(reorder.cluster_permutation(adj, **kw),
                 ref_reorder.cluster_permutation(adj, **kw))


@pytest.mark.parametrize("target,passes", [(40, 1), (120, 4), (10_000, 4)])
def test_merge_clusters_matches_reference(target, passes):
    rng = np.random.default_rng(target)
    k, n = 60, 900
    inv = rng.integers(0, k, n)
    counts = np.bincount(inv, minlength=k)
    cu, cv = rng.integers(0, k, 400), rng.integers(0, k, 400)
    keep = cu != cv
    cg = sp.coo_matrix((np.ones(keep.sum(), np.float32), (cu[keep], cv[keep])),
                       shape=(k, k)).tocsr()
    cg = (cg + cg.T).tocsr()
    _assert_same(reorder.merge_clusters(inv, cg, counts, target, passes),
                 ref_reorder.merge_clusters(inv, cg, counts, target, passes))


_BF16_BANDED = {"dtype": torch.bfloat16, "window_bf16": True, "row_block": 512}
_BF16_TILED = {"dtype": torch.bfloat16, "rest_engine": "onehot", "rest_gather_bf16": True}


@pytest.mark.parametrize("engine,device,bf16,expected", [
    ("reorder_banded", "cpu", False, ("rcm", "banded", 0, {})),
    ("reorder_banded", "cuda", False, ("rcm", "pallas_banded", 0, {})),
    ("reorder_banded", "cpu", True, ("rcm", "banded", 0, {"dtype": torch.bfloat16})),
    ("reorder_banded", "cuda", True, ("rcm", "pallas_banded", 0, _BF16_BANDED)),
    ("reorder_tiled", "cpu", False, ("cluster", "tiled", 7, {})),
    ("reorder_tiled", "cuda", True, ("cluster", "tiled", 7, _BF16_TILED)),
])
def test_reorder_plan_makes_the_reference_choices(engine, device, bf16, expected):
    """``ssrg_tpu/train/node_classification.py:159-190``: RCM and the banded
    engine (Pallas off the CPU), or clusters and tiles; with ``spmm_bf16``
    bf16 storage, plus the 512-row bf16 window for the kernel and the
    segmented bf16 rest for tiles; the merge target for tiles only."""
    got = reorder.reorder_plan(engine, torch.device(device), bf16, cluster_merge_target=7)
    assert got == expected


def test_apply_permutation_and_bandwidth_match_reference():
    adj = _banded_graph(n=500, shuffle=True, seed=9)
    x = _x(500, 6)
    y = np.arange(500)
    perm = reorder.reorder_permutation(adj, "rcm")
    got = reorder.apply_permutation(adj, perm, x, y)
    ref = ref_reorder.apply_permutation(adj, perm, x, y)
    assert (got[0] != ref[0]).nnz == 0
    for a, b in zip(got[1:], ref[1:]):
        _assert_same(a, b)
    assert reorder.bandwidth(got[0]) == ref_reorder.bandwidth(ref[0]) < reorder.bandwidth(adj)


# --- packs ----------------------------------------------------------------


def _banded_arrays(p):
    return [p.blocks, p.los, p.n_rows, p.n_cols, p.row_block, p.pad_to]


@pytest.mark.parametrize("dtype", sorted(BF16))
@pytest.mark.parametrize("row_block,n", [(64, 700), (256, 700), (128, 1000)])
def test_banded_packs_match_reference(row_block, n, dtype):
    adj = _banded_graph(n=n, seed=n)
    tdt, jdt = BF16[dtype]
    got = sparse.build_banded(adj, row_block=row_block, dtype=tdt)
    ref = ref_sparse.build_banded(adj, row_block=row_block, dtype=jdt)
    assert got.blocks.dtype == tdt
    _assert_all_same(_banded_arrays(got), _banded_arrays(ref))
    pb = build_pallas_banded(adj, row_block=row_block, dtype=tdt, window_bf16=True)
    ref_pb = ref_build_pallas_banded(adj, row_block=row_block, dtype=jdt, interpret=True,
                                     window_bf16=True)
    _assert_all_same(_banded_arrays(pb), _banded_arrays(ref_pb))
    assert pb.window_bf16 and pb.window % 128 == 0


def test_banded_pack_refuses_an_unbanded_graph():
    adj = _rest_matrix(n=4096, deg=4.0, seed=7)
    for build in (sparse.build_banded, build_pallas_banded):
        with pytest.raises(ValueError, match="not banded"):
            build(adj, mem_budget_bytes=16 << 20)
    with pytest.raises(ValueError, match="not banded"):
        ref_sparse.build_banded(adj, mem_budget_bytes=16 << 20)


def _rest_arrays(p):
    return [p.rows, p.cols, p.vals, p.block_of, p.n_rows, p.n_cols, p.row_block,
            p.gather_bf16]


def _row_ptr_oracle(p):
    """Entry for entry: the rows of the real entries, found by walking the
    chunks, and the pad entries at the end of each block."""
    rows = p.rows.numpy().astype(np.int64)
    vals, cols = p.vals.numpy(), p.cols.numpy()
    grow = p.block_of.numpy()[:, None].astype(np.int64) * p.row_block + rows
    real = ~((cols == 0) & (vals == 0))
    flat_rows = grow.reshape(-1)
    row_ptr = p.row_ptr.numpy()
    assert row_ptr[0] == 0 and row_ptr[-1] == rows.size and np.all(np.diff(row_ptr) >= 0)
    owner = np.repeat(np.arange(row_ptr.size - 1), np.diff(row_ptr))
    np.testing.assert_array_equal(owner[real.reshape(-1)], flat_rows[real.reshape(-1)])


REST_PACK_CASES = ["square", "empty_blocks", "rectangular", "long_row"]


def _rest_pack_case(case):
    """``(adj, row_block, chunk)`` of a rest pack parity case."""
    if case == "square":
        return _rest_matrix(), 64, 128
    if case == "empty_blocks":
        adj = sp.csr_matrix((np.ones(4, np.float32), ([0, 1, 500, 500], [3, 4, 5, 6])),
                            shape=(512, 512))
        return adj, 64, 128
    if case == "rectangular":
        return _rest_matrix(n=200, m=350, seed=4), 64, 128
    # one row whose entries span several chunks
    adj = _rest_matrix(n=300, seed=5).tolil()
    adj[17, :] = np.linspace(0.1, 1.0, 300, dtype=np.float32)
    return adj.tocsr(), 32, 64


@pytest.mark.parametrize("case", REST_PACK_CASES)
@pytest.mark.parametrize("gather_bf16", [False, True])
def test_rest_packs_match_reference(case, gather_bf16):
    adj, rb, chunk = _rest_pack_case(case)
    got = build_rest_segmented(adj, row_block=rb, chunk=chunk, gather_bf16=gather_bf16,
                               device=CPU)
    ref = ref_build_rest(adj, row_block=rb, chunk=chunk, interpret=True,
                         gather_bf16=gather_bf16)
    _assert_all_same(_rest_arrays(got), _rest_arrays(ref))
    assert got.default_executor == ref.default_executor == "xla"
    assert build_rest_segmented(adj, row_block=rb, chunk=chunk,
                                device="cuda").default_executor == "pallas"
    _row_ptr_oracle(got)


@pytest.mark.parametrize("case", REST_PACK_CASES)
@pytest.mark.parametrize("gather_bf16", [False, True])
def test_rest_row_end_stops_at_each_rows_last_real_entry(case, gather_bf16):
    """``row_end``, which the port derives beside ``row_ptr``, against the
    reference's layout: one past each row's last real entry (``row_ptr[r]``
    for a row without one), ``row_ptr[r+1]`` on every row that is not its
    block's last, and only pad entries between it and ``row_ptr[r+1]``."""
    adj, rb, chunk = _rest_pack_case(case)
    got = build_rest_segmented(adj, row_block=rb, chunk=chunk, gather_bf16=gather_bf16,
                               device=CPU)
    ref = ref_build_rest(adj, row_block=rb, chunk=chunk, interpret=True,
                         gather_bf16=gather_bf16)
    rows, cols, vals = (np.asarray(a).reshape(-1) for a in (ref.rows, ref.cols, ref.vals))
    grow = (np.repeat(np.asarray(ref.block_of), ref.rows.shape[1]).astype(np.int64) * rb
            + rows)
    real = ~((cols == 0) & (vals == 0))
    row_ptr, row_end = got.row_ptr.numpy(), got.row_end.numpy()
    assert got.row_end.dtype == torch.int64 and row_end.shape == (row_ptr.size - 1,)
    want = row_ptr[:-1].copy()
    pos = np.flatnonzero(real)
    np.maximum.at(want, grow[pos], pos + 1)
    np.testing.assert_array_equal(row_end, want)
    last = np.arange(row_end.size) % rb == rb - 1
    np.testing.assert_array_equal(row_end[~last], row_ptr[1:][~last])
    tail = np.concatenate([np.arange(e, p) for e, p in zip(row_end, row_ptr[1:])]).astype(int)
    assert not real[tail].any()
    assert torch.equal(got.to(CPU).row_end, got.row_end)  # .to moves it too


def _tile_arrays(p):
    return [p.tiles, p.starts, p.block_of, p.n_rows, p.n_cols, p.tiled_fraction]


@pytest.mark.parametrize("rest_engine", ["hybrid", "blockcoo", "onehot"])
@pytest.mark.parametrize("dtype", sorted(BF16))
def test_tiled_packs_match_reference(rest_engine, dtype):
    adj = _clustered()
    adj_p, _, _, _ = ref_reorder.apply_permutation(
        adj, ref_reorder.reorder_permutation(adj, "cluster"))
    tdt, jdt = BF16[dtype]
    kw = dict(row_block=64, tile_cols=128, min_edges_per_tile=8, rest_engine=rest_engine,
              rest_gather_bf16=dtype == "bf16")
    got = sparse.build_tiled(adj_p, dtype=tdt, device=CPU, **kw)
    ref = ref_sparse.build_tiled(adj_p, dtype=jdt, **kw)
    assert got.tiles.dtype == tdt and 0.5 < got.tiled_fraction < 1.0
    _assert_all_same(_tile_arrays(got), _tile_arrays(ref))
    assert type(got.rest).__name__ == type(ref.rest).__name__
    if rest_engine == "onehot":
        _assert_all_same(_rest_arrays(got.rest), _rest_arrays(ref.rest))
    else:
        ref_rest = ref.rest.ell if rest_engine == "hybrid" else ref.rest
        got_rest = got.rest.ell if rest_engine == "hybrid" else got.rest
        for name in ("cols", "vals") if rest_engine == "hybrid" else ("rows", "cols", "vals"):
            _assert_same(getattr(got_rest, name), getattr(ref_rest, name))


def test_tiled_pack_refuses_an_unclustered_graph():
    adj = _rest_matrix(n=20_000, deg=3.0, seed=11)  # ~20 edges a 256x512 tile
    for build in (sparse.build_tiled, ref_sparse.build_tiled):
        with pytest.raises(ValueError, match="not clustered"):
            build(adj)


def test_tiled_auto_rest_follows_the_device():
    adj = _clustered(n=800)
    assert isinstance(sparse.build_tiled(adj, row_block=64, tile_cols=128,
                                         min_edges_per_tile=8, device=CPU).rest,
                      sparse.HybridAdj)


@pytest.mark.parametrize("buckets", [(1 << 18, 1 << 19), (128, 256), (100, 64)])
def test_blockcoo_pack_matches_reference(buckets):
    adj = _rest_matrix(n=500, m=420, seed=12)
    got = sparse.build_blockcoo(adj, *buckets)
    ref = ref_sparse.build_blockcoo(adj, *buckets)
    for name in ("rows", "cols", "vals"):
        _assert_same(getattr(got, name), getattr(ref, name))


# --- SpMM -------------------------------------------------------------------


@pytest.mark.parametrize("f", [8, 50])
@pytest.mark.parametrize("variant", ["f32", "bf16", "window_bf16"])
@pytest.mark.parametrize("row_block", [64, 256])
def test_banded_spmm_matches_reference(row_block, variant, f):
    adj = _banded_graph(n=700, seed=13)
    x = _x(700, f)
    tdt, jdt = BF16["bf16" if variant == "bf16" else "f32"]
    window_bf16 = variant == "window_bf16"
    got = build_pallas_banded(adj, row_block=row_block, dtype=tdt, window_bf16=window_bf16)
    assert isinstance(got, PallasBandedAdj)
    ref = ref_build_pallas_banded(adj, row_block=row_block, dtype=jdt, interpret=True,
                                  window_bf16=window_bf16)
    want = np.asarray(ref.spmm(jnp.asarray(x)))
    out = got.spmm(torch.from_numpy(x))
    assert out.shape == (700, f) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), want, **F32_TOL)
    if not window_bf16:  # the XLA engine on the same pack
        xla = sparse.build_banded(adj, row_block=row_block, dtype=tdt)
        ref_xla = ref_sparse.build_banded(adj, row_block=row_block, dtype=jdt)
        np.testing.assert_allclose(xla.spmm(torch.from_numpy(x)).numpy(),
                                   np.asarray(ref_xla.spmm(jnp.asarray(x))), **F32_TOL)
    if variant == "f32":
        np.testing.assert_allclose(out.numpy(), adj @ x, **F32_TOL)


@pytest.mark.parametrize("rest_engine", ["hybrid", "blockcoo", "onehot"])
@pytest.mark.parametrize("dtype", sorted(BF16))
def test_tiled_spmm_matches_reference(rest_engine, dtype):
    adj = _clustered(seed=14)
    x = _x(adj.shape[0], 24)
    tdt, jdt = BF16[dtype]
    kw = dict(row_block=64, tile_cols=128, min_edges_per_tile=8, rest_engine=rest_engine,
              rest_gather_bf16=dtype == "bf16")
    got = sparse.build_tiled(adj, dtype=tdt, device=CPU, min_tiled_fraction=0.0, **kw)
    ref = ref_sparse.build_tiled(adj, dtype=jdt, min_tiled_fraction=0.0, **kw)
    out = got.spmm(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref.spmm(jnp.asarray(x))), **F32_TOL)
    if dtype == "f32":
        np.testing.assert_allclose(out.numpy(), adj @ x, **F32_TOL)


@pytest.mark.parametrize("buckets", [(1 << 18, 1 << 19), (128, 256), (100, 64)])
def test_blockcoo_spmm_matches_reference(buckets):
    adj = _rest_matrix(n=500, m=420, seed=15)
    x = _x(420, 16)
    got = sparse.device_adjacency(adj, "blockcoo", device=CPU, row_bucket=buckets[0],
                                  col_bucket=buckets[1])
    ref = ref_sparse.build_blockcoo(adj, *buckets)
    out = got.spmm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref.spmm(jnp.asarray(x))), **F32_TOL)
    np.testing.assert_allclose(out, adj @ x, **F32_TOL)


@pytest.mark.parametrize("case", ["square", "empty_blocks", "rectangular", "long_row"])
@pytest.mark.parametrize("gather_bf16", [False, True])
@pytest.mark.parametrize("executor", ["xla", "pallas"])
def test_rest_spmm_matches_reference(case, gather_bf16, executor):
    rng = np.random.default_rng(16)
    if case == "square":
        adj, rb, chunk, f = _rest_matrix(seed=2), 64, 128, 64
    elif case == "empty_blocks":
        adj = sp.csr_matrix((np.ones(4, np.float32), ([0, 1, 500, 500], [3, 4, 5, 6])),
                            shape=(512, 512))
        rb, chunk, f = 64, 128, 16
    elif case == "rectangular":
        adj, rb, chunk, f = _rest_matrix(n=200, m=350, seed=4), 64, 128, 24
    else:
        adj = _rest_matrix(n=300, seed=5).tolil()
        adj[17, :] = rng.uniform(0.1, 1.0, 300).astype(np.float32)
        adj, rb, chunk, f = adj.tocsr(), 32, 64, 37
    x = rng.normal(size=(adj.shape[1], f)).astype(np.float32)
    got = build_rest_segmented(adj, row_block=rb, chunk=chunk, gather_bf16=gather_bf16,
                               device=CPU)
    ref = ref_build_rest(adj, row_block=rb, chunk=chunk, interpret=True,
                         gather_bf16=gather_bf16)
    out = getattr(got, f"spmm_{executor}")(torch.from_numpy(x))
    want = np.asarray(getattr(ref, f"spmm_{executor}")(jnp.asarray(x)))
    assert out.shape == (adj.shape[0], f)
    np.testing.assert_allclose(out.numpy(), want, **F32_TOL)
    if not gather_bf16:
        np.testing.assert_allclose(out.numpy(), adj @ x, **F32_TOL)


def test_rest_slab_guard_raises_at_the_reference_size(monkeypatch):
    adj = _rest_matrix(n=300, seed=11)
    got = build_rest_segmented(adj, row_block=64, chunk=128, device=CPU)
    ref = ref_build_rest(adj, row_block=64, chunk=128, interpret=True)
    slab = got.num_chunks * got.chunk * 128 * 4  # F = 16 pads to 128 lanes, f32
    x = np.zeros((300, 16), np.float32)
    for limit, raises in ((slab - 1, True), (slab, False)):
        monkeypatch.setattr(RestSegmentedAdj, "MAX_GATHER_BYTES", limit)
        monkeypatch.setattr(RefRestSegmentedAdj, "MAX_GATHER_BYTES", limit)
        for fn, arg in ((got.spmm_pallas, torch.from_numpy(x)),
                        (ref.spmm_pallas, jnp.asarray(x))):
            if raises:
                with pytest.raises(ValueError, match="gather_bf16"):
                    fn(arg)
            else:
                fn(arg)


def test_device_adjacency_moves_the_locality_packs():
    adj = _banded_graph(n=300, seed=17)
    for engine, cls in (("banded", sparse.BandedAdj), ("pallas_banded", PallasBandedAdj),
                        ("blockcoo", sparse.BlockCOOAdj)):
        got = sparse.device_adjacency(adj, engine, device=CPU)
        assert isinstance(got, cls) and got.shape == (300, 300)
    tiled = sparse.device_adjacency(_clustered(n=800), "tiled", device=CPU, row_block=64,
                                    tile_cols=128, min_edges_per_tile=8, rest_engine="onehot")
    assert isinstance(tiled.rest, RestSegmentedAdj) and tiled.rest.default_executor == "xla"


# --- prepare, Predictor, autotune --------------------------------------------


def _dataset(adj, f=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(adj.shape[0], f)).astype(np.float32)
    return types.SimpleNamespace(adj=adj, x=x)


@pytest.fixture(scope="module")
def locality_graphs():
    banded = _banded_graph(n=1200, deg=6, bw=80, seed=18, shuffle=True)
    clustered = ref_synthetic.community_graph(1500, comm=256, seed=19)
    return {"reorder_banded": _dataset(banded), "reorder_tiled": _dataset(clustered)}


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("engine", ["reorder_banded", "reorder_tiled"])
@pytest.mark.parametrize("name", ["sgc", "gamlp"])
def test_predictor_matches_reference_on_the_locality_engines(locality_graphs, name, engine,
                                                             bf16):
    ds = locality_graphs[engine]
    ref_cfg = RefModelConfig(model_name=name, hidden_dim=32)
    ref = RefPredictor(ds, ref_load_model(ref_cfg, 16, 4), ref_cfg,
                       RefTrainingConfig(spmm_engine=engine, spmm_bf16=bf16))
    cfg = ModelConfig(model_name=name, hidden_dim=32)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, ref.params))
    got = Predictor(ds, load_model(cfg, 16, 4), cfg,
                    TrainingConfig(spmm_engine=engine, spmm_bf16=bf16),
                    params=params, device=CPU)
    assert got.prepared.engine == ref.prepared.engine == "auto"
    assert got.prepared.hops_layout == ref.prepared.hops_layout
    np.testing.assert_allclose(got.prepared.inputs.numpy(),
                               np.asarray(ref.prepared.inputs), **HOPS_TOL[bf16])
    ids = np.arange(0, ds.adj.shape[0], 7)
    np.testing.assert_allclose(got.logits(ids).numpy(), ref.logits(ids), **HOPS_TOL[bf16])


def test_reorder_hops_equal_the_hybrid_hops_in_original_order(locality_graphs):
    """The un-permutation puts every node's hops back at its own id."""
    ds = locality_graphs["reorder_banded"]
    spec = load_model(ModelConfig(model_name="gamlp"), 16, 4)
    hops = {e: prepare(spec, ds, ModelConfig(), TrainingConfig(spmm_engine=e),
                       device=CPU).inputs for e in ("hybrid", "reorder_banded")}
    np.testing.assert_allclose(hops["reorder_banded"].numpy(), hops["hybrid"].numpy(),
                               rtol=1e-4, atol=1e-4)


def test_reorder_fallback_warns_and_propagates_on_hybrid(caplog):
    """A random graph stays wide after RCM: its banded pack would need
    3.32 GiB, over the 2 GiB budget, so both packages fall back to hybrid."""
    rng = np.random.default_rng(20)
    n, e = 40_000, 60_000
    adj = sp.csr_matrix((np.ones(e, np.float32), (rng.integers(0, n, e), rng.integers(0, n, e))),
                        shape=(n, n))
    ds = _dataset(((adj + adj.T) > 0).astype(np.float32).tocsr(), f=8)
    spec = load_model(ModelConfig(model_name="sgc"), 8, 4)
    with caplog.at_level(logging.WARNING, logger="ssrg_torch"):
        got = prepare(spec, ds, ModelConfig(), TrainingConfig(spmm_engine="reorder_banded"),
                      device=CPU)
    assert any(r.name == "ssrg_torch" and "reorder_banded fell back to hybrid" in r.getMessage()
               and "not banded" in r.getMessage() for r in caplog.records)
    hybrid = prepare(spec, ds, ModelConfig(), TrainingConfig(spmm_engine="hybrid"), device=CPU)
    np.testing.assert_array_equal(got.inputs.numpy(), hybrid.inputs.numpy())
    ref_spec = ref_load_model(RefModelConfig(model_name="sgc"), 8, 4)
    ref = ref_prepare(ref_spec, ds, RefModelConfig(),
                      RefTrainingConfig(spmm_engine="reorder_banded"))
    np.testing.assert_allclose(got.inputs.numpy(), np.asarray(ref.inputs), rtol=1e-4, atol=1e-4)


def test_autotune_times_the_reference_engines_and_prepare_matches(locality_graphs):
    ds = locality_graphs["reorder_tiled"]
    _, ref_timings = ref_autotune.autotune_engine(ds.adj, 16, reps=2)
    best, timings = autotune.autotune_engine(ds.adj, 16, reps=2, device=CPU)
    assert set(timings) == set(ref_timings)
    assert {"dense", "hybrid", "reorder_banded", "reorder_tiled"} <= set(timings)
    assert "pallas_banded" not in timings and best in timings
    assert all(t > 0 for t in timings.values())
    spec = load_model(ModelConfig(model_name="sgc"), 16, 4)
    got = prepare(spec, ds, ModelConfig(), TrainingConfig(spmm_engine="autotune"), device=CPU)
    ref_spec = ref_load_model(RefModelConfig(model_name="sgc"), 16, 4)
    ref = ref_prepare(ref_spec, ds, RefModelConfig(), RefTrainingConfig(spmm_engine="autotune"))
    assert got.engine in set(timings) - {"reorder_banded", "reorder_tiled"} | {"auto"}
    np.testing.assert_allclose(got.inputs.numpy(), np.asarray(ref.inputs), **HOPS_TOL[False])
