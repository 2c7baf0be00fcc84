"""Parity of the PyTorch port's host-side partitioners and streaming loader
with ``ssrg_tpu``, on the CPU.

Everything here is host numpy and scipy, so the port's outputs must EQUAL
the reference's, array for array: ``parallel/partition.py`` (row, hybrid
and tiled partitions, the halo plan, the cluster renumbering) and
``data/streaming.py`` (degrees, spool files byte for byte, the side files,
the assembled partition, feature blocks). The one reordering allowed: the
C packer writes each shard's COO tail in OpenMP thread order, so tails are
compared after a stable sort by row (``ROADMAP.md`` section 3).
"""

import json
import os.path as osp

import numpy as np
import pytest
import scipy.sparse as sp

from ssrg_tpu.data import streaming as ref_streaming
from ssrg_tpu.data.synthetic import sbm_graph as ref_sbm_graph
from ssrg_tpu.parallel import partition as ref_partition

import ssrg_torch.parallel as parallel
from ssrg_torch.data import streaming
from ssrg_torch.data.synthetic import sbm_graph
from ssrg_torch.ops.normalize import sym_norm
from ssrg_torch.parallel import partition

TOY_TILE_KW = dict(row_block=8, tile_cols=16, min_edges_per_tile=4)


def _random_graph(n=203, seed=0, hub=False):
    rng = np.random.default_rng(seed)
    a = (rng.uniform(size=(n, n)) < 0.06).astype(np.float32)
    if hub:
        a[0, :] = 1.0
    np.fill_diagonal(a, 0)
    a = np.maximum(a, a.T)
    return sym_norm(sp.csr_matrix(a), 0.5)


def _community_graph(n=256, classes=8, seed=3):
    g = sbm_graph(num_node=n, num_classes=classes, num_features=4, p_in=0.25, p_out=0.004,
                  seed=seed)
    adj, _, _, _ = partition.cluster_reorder_for_partition(g.adj)
    return sym_norm(adj, 0.5)


def _assert_fields_equal(got, want, fields):
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=f)
            assert g.dtype == w.dtype, f
        else:
            assert g == w, f


def _assert_tails_equal(got, want):
    """Each shard's tail in row order (stable), then the padding."""
    for d in range(want.tail_rows.shape[0]):
        arrays = []
        for part in (got, want):
            r, c, v = part.tail_rows[d], part.tail_cols[d], part.tail_vals[d]
            real = v != 0
            order = np.argsort(r[real], kind="stable")
            arrays.append((r[real][order], c[real][order], v[real][order]))
        for g, w in zip(*arrays):
            np.testing.assert_array_equal(g, w)
    assert got.tail_rows.shape == want.tail_rows.shape


@pytest.mark.parametrize("num_shards,row_align", [(1, 8), (3, 8), (8, 8), (4, 64)])
def test_partition_rows_equal(num_shards, row_align):
    p = _random_graph()
    got = partition.partition_rows(p, num_shards, row_align)
    want = ref_partition.partition_rows(p, num_shards, row_align)
    _assert_fields_equal(got, want, ("rows", "cols", "vals", "block", "n"))
    assert (got.num_shards, got.n_pad) == (want.num_shards, want.n_pad)
    x = np.random.default_rng(0).normal(size=(203, 5)).astype(np.float32)
    np.testing.assert_array_equal(partition.pad_features(x, got),
                                  ref_partition.pad_features(x, want))


@pytest.mark.parametrize("halo", [False, True], ids=["allgather", "halo"])
@pytest.mark.parametrize("width", [None, 8], ids=["p95", "w8"])
def test_partition_rows_hybrid_equal(halo, width):
    p = _random_graph(n=300, seed=9, hub=True)
    got = partition.partition_rows_hybrid(p, 4, width=width, halo=halo, row_align=8)
    want = ref_partition.partition_rows_hybrid(p, 4, width=width, halo=halo, row_align=8)
    _assert_fields_equal(got, want, ("ell_cols", "ell_vals", "block", "n", "width",
                                     "tail_chunk", "halo_pad", "halo_fraction"))
    if halo:
        np.testing.assert_array_equal(got.send_idx, want.send_idx)
    else:
        assert got.send_idx is None and want.send_idx is None
    assert got.local_table_rows == want.local_table_rows
    _assert_tails_equal(got, want)
    assert int((got.tail_vals != 0).sum()) > 0
    assert int((got.ell_vals != 0).sum() + (got.tail_vals != 0).sum()) == p.nnz


def test_halo_plan_and_column_remap_equal():
    p = _community_graph(seed=5)
    block = 64
    cols = [p.tocsr()[d * block:(d + 1) * block].indices for d in range(4)]
    got = partition._build_halo_plan(cols, 4, block, 8)
    want = ref_partition._build_halo_plan(cols, 4, block, 8)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:3] == want[1:3]
    for d in range(4):
        for g, w in zip(got[3][d], want[3][d]):
            np.testing.assert_array_equal(g, w)
        c = cols[d].astype(np.int64)
        np.testing.assert_array_equal(partition._remap_cols(c, d, block, got[3][d]),
                                      ref_partition._remap_cols(c, d, block, want[3][d]))


@pytest.mark.parametrize("num_shards,halo", [(4, True), (4, False), (8, True)])
def test_partition_rows_tiled_equal(num_shards, halo):
    p = _community_graph(n=256, classes=8, seed=7)
    got = partition.partition_rows_tiled(p, num_shards, halo=halo, **TOY_TILE_KW)
    want = ref_partition.partition_rows_tiled(p, num_shards, halo=halo, **TOY_TILE_KW)
    _assert_fields_equal(got, want, ("tiles", "starts", "block_of", "ell_cols", "ell_vals",
                                     "block", "n", "width", "tail_chunk", "row_block",
                                     "tile_cols", "tiled_fraction", "halo_pad",
                                     "halo_fraction"))
    if halo:
        np.testing.assert_array_equal(got.send_idx, want.send_idx)
    _assert_tails_equal(got, want)
    assert got.local_table_rows == want.local_table_rows
    assert got.tiled_fraction > 0.3
    total = int((got.tiles != 0).sum() + (got.ell_vals != 0).sum() + (got.tail_vals != 0).sum())
    assert total == p.nnz


@pytest.mark.parametrize("merge_target", [0, 64])
def test_cluster_reorder_for_partition_equal(merge_target):
    g = sbm_graph(num_node=512, num_classes=8, num_features=4, p_in=0.12, p_out=0.002, seed=3)
    ref_g = ref_sbm_graph(num_node=512, num_classes=8, num_features=4, p_in=0.12, p_out=0.002,
                          seed=3)
    perm = np.random.default_rng(0).permutation(512)
    shuffled = g.adj.tocsr()[perm][:, perm].tocsr()
    got = partition.cluster_reorder_for_partition(shuffled, g.x[perm], np.asarray(g.y)[perm],
                                                  merge_target=merge_target)
    want = ref_partition.cluster_reorder_for_partition(
        ref_g.adj.tocsr()[perm][:, perm].tocsr(), ref_g.x[perm], np.asarray(ref_g.y)[perm],
        merge_target=merge_target)
    assert (got[0] != want[0]).nnz == 0
    for g_arr, w_arr in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g_arr, w_arr)
    raw = partition.partition_rows_hybrid(shuffled, 8, halo=True, row_align=8)
    clustered = partition.partition_rows_hybrid(got[0], 8, halo=True, row_align=8)
    assert clustered.halo_fraction < 0.5 * raw.halo_fraction


def test_parallel_package_exposes_only_what_exists():
    """Every lazy export resolves to its module's object (the reference's
    names, the distributed ones included); others raise AttributeError."""
    assert parallel.partition_rows is partition.partition_rows
    assert parallel.RowPartition is partition.RowPartition
    from ssrg_torch.parallel.dist_spmm import ShardedAdj, dist_propagate
    from ssrg_torch.parallel.mesh import make_mesh
    from ssrg_torch.parallel.outofcore import outofcore_propagate

    assert parallel.outofcore_propagate is outofcore_propagate
    assert parallel.make_mesh is make_mesh
    assert parallel.ShardedAdj is ShardedAdj
    assert parallel.dist_propagate is dist_propagate
    from ssrg_tpu import parallel as ref_parallel

    assert set(ref_parallel.__all__) <= set(parallel.__all__)
    with pytest.raises(AttributeError):
        parallel.no_such_name


# --- data/streaming.py ----------------------------------------------------------


@pytest.fixture
def staged(tmp_path):
    rng = np.random.default_rng(0)
    n, e = 200, 800
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    keep = src != dst
    pairs = np.unique(np.sort(np.stack([src[keep], dst[keep]], axis=1), axis=1), axis=0)
    edges = pairs.T.astype(np.int64)
    x = rng.normal(size=(n, 12)).astype(np.float32)
    np.save(tmp_path / "edges.npy", edges)
    np.save(tmp_path / "features.npy", x)
    return str(tmp_path / "edges.npy"), str(tmp_path / "features.npy"), edges, x, n, tmp_path


@pytest.mark.parametrize("loops", [True, False])
def test_stream_degrees_equal(staged, loops):
    edges_path, _, edges, _, n, _ = staged
    got = streaming.stream_degrees(edges_path, n, chunk_edges=100, add_self_loops=loops)
    want = ref_streaming.stream_degrees(edges_path, n, chunk_edges=100, add_self_loops=loops)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


def _spool_files(d, num_shards):
    names = [f"shard_{i}.bin" for i in range(num_shards)]
    names += [f"halo_{i}.npy" for i in range(num_shards)] + ["fast_meta.json"]
    return {name: open(osp.join(d, name), "rb").read() for name in names}


@pytest.mark.parametrize("num_shards,r", [(4, 0.5), (3, 0.3)])
def test_stream_partition_spools_equal(staged, num_shards, r):
    """Every file of the spool directory equal byte for byte, the metadata
    equal, the assembled partition equal and equal to the in-memory one."""
    edges_path, _, edges, _, n, tmp = staged
    got = streaming.stream_partition(edges_path, n, num_shards, str(tmp / "port"), r=r,
                                     chunk_edges=128)
    want = ref_streaming.stream_partition(edges_path, n, num_shards, str(tmp / "ref"), r=r,
                                          chunk_edges=128)
    assert (got.num_nodes, got.num_edges, got.block, got.num_shards) == (
        want.num_nodes, want.num_edges, want.block, want.num_shards)
    assert _spool_files(got.spool_dir, num_shards) == _spool_files(want.spool_dir, num_shards)
    part = streaming.assemble_row_partition(got)
    _assert_fields_equal(part, ref_streaming.assemble_row_partition(want),
                         ("rows", "cols", "vals", "block", "n"))
    adj = sp.csr_matrix((np.ones(edges.shape[1]), (edges[0], edges[1])), shape=(n, n))
    norm = sym_norm(((adj + adj.T) > 0).astype(np.float64), r)
    d_idx = np.arange(num_shards)[:, None]
    rows_g = (part.rows + d_idx * part.block).reshape(-1)
    vals_g = part.vals.reshape(-1)
    nz = vals_g != 0
    stitched = sp.csr_matrix((vals_g[nz], (rows_g[nz], part.cols.reshape(-1)[nz])),
                             shape=(part.n_pad, part.n_pad))[:n, :n]
    np.testing.assert_allclose(stitched.toarray(), norm.toarray(), rtol=1e-6, atol=1e-7)


def test_spools_cross_between_the_packages(staged):
    """A spool the reference wrote is read by the port's loaders and the
    other way round; the side files are recomputed equal where missing."""
    edges_path, _, _, _, n, tmp = staged
    ref_meta = ref_streaming.stream_partition(edges_path, n, 3, str(tmp / "ref"),
                                              fast_layout=False)
    port_meta = streaming.stream_partition(edges_path, n, 3, str(tmp / "port"),
                                           fast_layout=False)
    as_port = streaming.StreamingGraphMeta(**vars(ref_meta))
    as_ref = ref_streaming.StreamingGraphMeta(**vars(port_meta))
    assert not osp.exists(osp.join(ref_meta.spool_dir, "fast_meta.json"))
    got = streaming.load_spool_fast_meta(as_port)
    want = ref_streaming.load_spool_fast_meta(as_ref)
    assert got == want
    with open(osp.join(ref_meta.spool_dir, "fast_meta.json")) as f:
        assert json.load(f) == got
    for g, w in zip(streaming.load_spool_halo_cols(as_port),
                    ref_streaming.load_spool_halo_cols(as_ref)):
        np.testing.assert_array_equal(g, w)
    for d in range(3):
        for g, w in zip(streaming.load_shard(as_port, d, nnz_pad=2048),
                        ref_streaming.load_shard(as_ref, d, nnz_pad=2048)):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="nnz_pad"):
        streaming.load_shard(as_port, 0, nnz_pad=1)


def test_shard_feature_blocks_equal(staged):
    edges_path, feat_path, _, x, n, tmp = staged
    meta = streaming.stream_partition(edges_path, n, 4, str(tmp / "spool"))
    for d in range(4):
        got = streaming.shard_feature_block(feat_path, meta, d)
        want = ref_streaming.shard_feature_block(feat_path, meta, d)
        np.testing.assert_array_equal(got, want)
        assert got.shape == (meta.block, x.shape[1])
    hi = n - 3 * meta.block
    np.testing.assert_array_equal(streaming.shard_feature_block(feat_path, meta, 3)[hi:], 0.0)
