"""Parity of the PyTorch port's message-passing baselines with ``ssrg_tpu``,
on the CPU.

The same seeded numpy inputs go through the reference and the port; flax
parameters are carried across with ``ssrg_torch.convert.params_from_jax``.
Tolerances, each with its reason:

- ``sddmm`` and ``sddmm_softmax_spmm``: 1e-5 (per-edge dot products and
  segment sums of f32 terms in another order);
- ``edge_softmax``: 1e-6 (the same exponentials, sums of a few terms);
- modules: outputs 1e-5 in training and evaluation mode (dropout 0, so that
  both packages compute the same function); gradients 1e-4 against
  ``jax.grad`` (backward sums in another order, over a few hundred nodes);
- ``EdgeList`` packs, ``mean_norm``, ``bfs_order``, cluster groups: equal;
- the triplet loss: 1e-5;
- ``BaselineTask``: best test accuracy within 0.06 of the reference's on
  the same configuration (other initial weights and dropout draws).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ssrg_tpu.configs.config import TrainingConfig as RefTrainingConfig
from ssrg_tpu.data.synthetic import planetoid_like as ref_planetoid_like
from ssrg_tpu.models import baselines as ref_bl
from ssrg_tpu.ops import sddmm as ref_sddmm
from ssrg_tpu.ops.normalize import sym_norm as ref_sym_norm
from ssrg_tpu.ops.sparse import device_adjacency as ref_device_adjacency
from ssrg_tpu.train import baseline_task as ref_bt
from ssrg_tpu.train.common import cross_entropy_loss as ref_cross_entropy

from ssrg_torch.configs.config import TrainingConfig
from ssrg_torch.convert import params_from_jax, params_to_jax
from ssrg_torch.data.synthetic import planetoid_like
from ssrg_torch.models import baselines as bl
from ssrg_torch.ops import sddmm
from ssrg_torch.ops.ell_spmm import ell_spmm
from ssrg_torch.ops.normalize import sym_norm
from ssrg_torch.ops.sparse import DenseAdj, DifferentiableAdj, differentiable_adjacency
from ssrg_torch.train import baseline_task as bt
from ssrg_torch.train.common import cross_entropy_loss

CPU = "cpu"
N, F, C = 160, 12, 3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def graph():
    kw = dict(num_node=N, num_classes=C, num_features=F, seed=4)
    return ref_planetoid_like(**kw), planetoid_like(**kw)


# --- sddmm and the segment softmax ------------------------------------------------


def _edges(n=70, e=400, f=9, seed=0):
    rng = np.random.default_rng(seed)
    row = rng.integers(0, n, e).astype(np.int32)
    col = rng.integers(0, n, e).astype(np.int32)
    u = rng.normal(size=(n, f)).astype(np.float32)
    v = rng.normal(size=(n, f)).astype(np.float32)
    return row, col, u, v


@pytest.mark.parametrize("chunk", [1 << 19, 64, 7], ids=["whole", "chunk64", "chunk7"])
def test_sddmm_matches_reference(chunk):
    row, col, u, v = _edges()
    want = np.asarray(ref_sddmm.sddmm(jnp.asarray(row), jnp.asarray(col), jnp.asarray(u),
                                      jnp.asarray(v), chunk=chunk))
    got = sddmm.sddmm(torch.from_numpy(row), torch.from_numpy(col), torch.from_numpy(u),
                      torch.from_numpy(v), chunk=chunk)
    assert got.shape == (row.shape[0],) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("chunk", [1 << 19, 50], ids=["whole", "chunk50"])
def test_sddmm_softmax_spmm_matches_reference(chunk, monkeypatch):
    """Rows with no edges and masked (padded) entries included; the chunked
    case forces the port's ``sddmm`` through its chunk loop."""
    row, col, u, v = _edges(n=60, e=300)
    mask = (np.random.default_rng(1).uniform(size=row.shape) > 0.2).astype(np.float32)
    row[row == 5] = 6          # row 5 has no edges at all
    mask[row == 7] = 0.0       # row 7 has only padded entries
    values = np.random.default_rng(2).normal(size=(60, 5)).astype(np.float32)
    want = np.asarray(ref_sddmm.sddmm_softmax_spmm(
        *(jnp.asarray(a) for a in (row, col, mask, u, v, values)), 60))
    real = sddmm.sddmm
    monkeypatch.setattr(sddmm, "sddmm", lambda *a: real(*a, chunk=chunk))
    got = sddmm.sddmm_softmax_spmm(*(torch.from_numpy(a) for a in (row, col, mask, u, v,
                                                                   values)), 60)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert np.all(got.numpy()[[5, 7]] == 0.0)


@pytest.mark.parametrize("heads", [1, 4])
def test_edge_softmax_matches_reference(heads):
    row, col, u, _ = _edges(n=50, e=256)
    rng = np.random.default_rng(3)
    scores = (5 * rng.normal(size=(row.shape[0], heads))).astype(np.float32)
    mask = (rng.uniform(size=row.shape) > 0.25).astype(np.float32)
    row[row == 9] = 10
    mask[row == 11] = 0.0
    want = np.asarray(ref_bl.edge_softmax(jnp.asarray(scores), jnp.asarray(row),
                                          jnp.asarray(mask), 50))
    got = bl.edge_softmax(torch.from_numpy(scores), torch.from_numpy(row),
                          torch.from_numpy(mask), 50).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.all(got[mask == 0] == 0.0)
    sums = np.zeros((50, heads))
    np.add.at(sums, row, got)
    live = np.unique(row[mask > 0])
    np.testing.assert_allclose(sums[live], 1.0, rtol=1e-6)


# --- the seven modules, with flax parameters carried over ------------------------


HIDDEN = 8


def _module_pair(name, graph, dropout=0.0):
    """(reference flax module, its call inputs, port module, its inputs,
    labels, train ids)."""
    ref_ds, ds = graph
    x = np.asarray(ds.x, np.float32)
    y = np.asarray(ds.y)
    train = np.asarray(ds.train_idx)
    if name in ("gcn", "sage"):
        norm = sym_norm(ds.adj, 0.5) if name == "gcn" else bt.mean_norm(ds.adj)
        ref_norm = ref_sym_norm(ref_ds.adj, 0.5) if name == "gcn" else ref_bt.mean_norm(ref_ds.adj)
        ref_adj = ref_device_adjacency(ref_norm, "hybrid")
        adj = differentiable_adjacency(norm, "hybrid", device=CPU)
        ref_cls = ref_bl.BaselineGCN if name == "gcn" else ref_bl.BaselineSAGE
        cls = bl.BaselineGCN if name == "gcn" else bl.BaselineSAGE
        return (ref_cls(HIDDEN, C, 3, dropout), (jnp.asarray(x), ref_adj),
                cls(F, HIDDEN, C, 3, dropout), (torch.from_numpy(x), adj), y, train)
    if name == "gat":
        ref_e = ref_bl.EdgeList.from_scipy(ref_ds.adj, pad_to=64)
        e = bl.EdgeList.from_scipy(ds.adj, pad_to=64)
        return (ref_bl.BaselineGAT(4, C, 2, heads=3, dropout=dropout), (jnp.asarray(x), ref_e),
                bl.BaselineGAT(F, 4, C, 2, heads=3, dropout=dropout), (torch.from_numpy(x), e),
                y, train)
    if name in ("sgc", "sign"):
        p = sym_norm(ds.adj, 0.5).toarray().astype(np.float64)
        hops = [x.astype(np.float64)]
        for _ in range(2):
            hops.append(p @ hops[-1])
        hops = np.stack(hops).astype(np.float32)
        if name == "sgc":
            return (ref_bl.BaselineSGC(C), (jnp.asarray(hops[-1]),), bl.BaselineSGC(F, C),
                    (torch.from_numpy(hops[-1]),), y, train)
        return (ref_bl.BaselineSIGN(HIDDEN, C, dropout), (jnp.asarray(hops),),
                bl.BaselineSIGN(F, HIDDEN, C, 3, dropout), (torch.from_numpy(hops),), y, train)
    ref_cls = ref_bl.BaselineMLP if name == "mlp" else ref_bl.RobustMLP
    cls = bl.BaselineMLP if name == "mlp" else bl.RobustMLP
    return (ref_cls(HIDDEN, C, 3, dropout), (jnp.asarray(x),), cls(F, HIDDEN, C, 3, dropout),
            (torch.from_numpy(x),), y, train)


MODULES = ("mlp", "robust_mlp", "gcn", "sage", "gat", "sgc", "sign")


def _ref_loss(name, out, y, train):
    if name == "robust_mlp":
        hidden, logp = out
        nll = -jnp.mean(jnp.take_along_axis(logp[train], jnp.asarray(y)[train][:, None], axis=1))
        return nll + 0.5 * ref_bl.triplet_loss(hidden, jnp.asarray(y), jnp.asarray(train), C)
    return ref_cross_entropy(out[train], jnp.asarray(y)[train])


def _loss(name, out, y, train):
    y, train = torch.from_numpy(y), torch.from_numpy(train)
    if name == "robust_mlp":
        hidden, logp = out
        nll = -logp[train].gather(1, y[train][:, None]).mean()
        return nll + 0.5 * bl.triplet_loss(hidden, y, train, C)
    return cross_entropy_loss(out[train], y[train])


def _carried(name, graph):
    ref_mod, ref_in, mod, inputs, y, train = _module_pair(name, graph)
    variables = ref_mod.init({"params": jax.random.PRNGKey(1), "dropout": jax.random.PRNGKey(2)},
                             *ref_in, train=False)
    mod.load_state_dict(params_from_jax(_np_tree(variables)), strict=True)
    return ref_mod, ref_in, variables, mod, inputs, y, train


def _outputs(out):
    return [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("name", MODULES)
def test_module_eval_outputs_match_reference(graph, name):
    ref_mod, ref_in, variables, mod, inputs, _, _ = _carried(name, graph)
    want = ref_mod.apply(variables, *ref_in, train=False)
    with torch.no_grad():
        got = mod.eval()(*inputs)
    for g, w in zip(_outputs(got), _outputs(want)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", MODULES)
def test_module_train_outputs_and_gradients_match_reference(graph, name):
    """Training mode (BatchNorm on batch statistics, dropout 0): outputs
    1e-5, the BatchNorm running statistics 1e-6, every parameter's gradient
    1e-4 against ``jax.grad``."""
    ref_mod, ref_in, variables, mod, inputs, y, train = _carried(name, graph)
    params = variables["params"]
    has_bn = "batch_stats" in variables

    def ref_fn(p):
        v = {**variables, "params": p}
        out = ref_mod.apply(v, *ref_in, train=True, rngs={"dropout": jax.random.PRNGKey(0)},
                            mutable=["batch_stats"] if has_bn else False)
        out, new_vars = out if has_bn else (out, {})
        return _ref_loss(name, out, y, train), (out, new_vars)

    (ref_loss, (ref_out, new_vars)), ref_grads = jax.value_and_grad(ref_fn, has_aux=True)(params)
    out = mod.train()(*inputs)
    for g, w in zip(_outputs(tuple(o.detach() for o in out) if isinstance(out, tuple)
                             else out.detach()), _outputs(ref_out)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    loss = _loss(name, out, y, train)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    grads = {k: v.grad for k, v in mod.named_parameters()}
    for k, v in params_from_jax(_np_tree(ref_grads)).items():
        assert grads[k] is not None, k
        np.testing.assert_allclose(grads[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-4, err_msg=k)
    if has_bn:
        for k, v in params_from_jax({"batch_stats": _np_tree(new_vars["batch_stats"]),
                                     "params": {}}).items():
            np.testing.assert_allclose(mod.state_dict()[k].numpy(), v.numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=k)


def test_gcn_and_sage_run_the_transposed_pack(graph):
    """GCN's symmetric pack is its own transpose; SAGE's row-mean pack is
    not, so its backward has a pack of A^T built on the host."""
    _, ds = graph
    gcn = differentiable_adjacency(sym_norm(ds.adj, 0.5), "hybrid", device=CPU)
    sage = differentiable_adjacency(bt.mean_norm(ds.adj), "hybrid", device=CPU)
    assert isinstance(gcn, DifferentiableAdj) and gcn.symmetric
    assert isinstance(sage, DifferentiableAdj) and not sage.symmetric
    dense = bt.mean_norm(ds.adj).toarray().T
    g = np.random.default_rng(0).normal(size=(N, 5)).astype(np.float32)
    np.testing.assert_allclose(sage.bwd.spmm(torch.from_numpy(g)).numpy(), dense @ g,
                               rtol=1e-5, atol=1e-5)


def test_convert_round_trips_the_gat_attention_vectors(graph):
    _, _, variables, mod, _, _, _ = _carried("gat", graph)
    assert tuple(mod.a_src_0.shape) == (1, 3, 4) and tuple(mod.a_dst_1.shape) == (1, 3, C)
    back = params_to_jax(mod.state_dict())
    ref = _np_tree(variables)
    for k in ("a_src_0", "a_dst_0", "a_src_1", "a_dst_1"):
        np.testing.assert_array_equal(back["params"][k], ref["params"][k])
    np.testing.assert_array_equal(back["params"]["w_1"]["kernel"], ref["params"]["w_1"]["kernel"])


def test_gat_matches_a_dense_attention_oracle():
    """One GAT layer against dense float64 attention with the same weights
    (the reference's own oracle)."""
    rng = np.random.default_rng(0)
    n, f, heads, d = 16, 6, 2, 3
    mask_dense = rng.uniform(size=(n, n)) < 0.4
    mask_dense[4] = False      # a node with no in-edges
    adj = sp.csr_matrix(mask_dense.astype(np.float32))
    x = rng.normal(size=(n, f)).astype(np.float32)
    gat = bl.BaselineGAT(f, d, d, num_layers=1, heads=heads, dropout=0.0)
    gat.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = gat.eval()(torch.from_numpy(x), bl.EdgeList.from_scipy(adj, pad_to=8)).numpy()
    w = gat.w_0.weight.detach().numpy().T.astype(np.float64)
    a_src = gat.a_src_0.detach().numpy()[0].astype(np.float64)
    a_dst = gat.a_dst_0.detach().numpy()[0].astype(np.float64)
    z = (x @ w).reshape(n, heads, d)
    s_src, s_dst = (z * a_src).sum(-1), (z * a_dst).sum(-1)
    outs = np.zeros((n, heads, d))
    for h in range(heads):
        scores = s_dst[:, h][:, None] + s_src[:, h][None, :]
        scores = np.where(scores > 0, scores, 0.2 * scores)
        scores = np.where(mask_dense, scores, -np.inf)
        top = np.max(np.where(mask_dense, scores, -1e300), axis=1, keepdims=True)
        e = np.where(mask_dense, np.exp(scores - top), 0.0)
        denom = np.maximum(e.sum(1, keepdims=True), 1e-300)
        outs[:, h] = (e / denom) @ z[:, h]
    np.testing.assert_allclose(out, outs.mean(axis=1), rtol=1e-5, atol=1e-5)
    assert np.all(out[4] == 0.0)


# --- host-side structures: equal --------------------------------------------------


@pytest.mark.parametrize("pad_to,e_pad", [(512, None), (64, None), (8, 2048)])
def test_edge_list_packs_equal(graph, pad_to, e_pad):
    ref_ds, ds = graph
    ref = ref_bl.EdgeList.from_scipy(ref_ds.adj, pad_to=pad_to, e_pad=e_pad)
    got = bl.EdgeList.from_scipy(ds.adj, pad_to=pad_to, e_pad=e_pad)
    assert got.num_nodes == ref.num_nodes
    for a in ("row", "col", "mask"):
        np.testing.assert_array_equal(getattr(got, a).numpy(), np.asarray(getattr(ref, a)))
    with pytest.raises(ValueError, match="e_pad"):
        bl.EdgeList.from_scipy(ds.adj, e_pad=1)


def test_mean_norm_and_bfs_order_equal(graph):
    ref_ds, ds = graph
    a, b = bt.mean_norm(ds.adj), ref_bt.mean_norm(ref_ds.adj)
    assert (a != b).nnz == 0 and a.dtype == b.dtype
    lonely = sp.csr_matrix(sp.block_diag([ds.adj, sp.csr_matrix((3, 3))]))
    np.testing.assert_array_equal(bt.bfs_order(lonely), ref_bt.bfs_order(lonely))
    np.testing.assert_array_equal(bt.bfs_order(ds.adj.tocsr()),
                                  ref_bt.bfs_order(ref_ds.adj.tocsr()))


@pytest.mark.parametrize("kind", ["gcn", "sage", "gat"])
def test_cluster_batches_of_equal_groups_equal_the_reference(graph, kind):
    """160 nodes in 8 parts of 20, 2 parts a batch: groups of one size, so
    the reference pads nothing and the two packages build the same batches."""
    ref_ds, ds = graph
    ref = ref_bt.build_cluster_batches(ref_ds.adj.tocsr(), 8, 2, "dense", seed=3, model_kind=kind)
    got = bt.build_cluster_batches(ds.adj, 8, 2, "dense", seed=3, model_kind=kind, device=CPU)
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.node_ids.numpy(), np.asarray(r.node_ids))
        assert np.all(np.asarray(r.valid) == 1.0)
        if kind == "gat":
            m = np.asarray(r.adj_dev.mask) > 0
            assert int(g.adj_dev.mask.sum()) == int(m.sum())
            np.testing.assert_array_equal(g.adj_dev.row.numpy()[: m.sum()],
                                          np.asarray(r.adj_dev.row)[m])
            np.testing.assert_array_equal(g.adj_dev.col.numpy()[: m.sum()],
                                          np.asarray(r.adj_dev.col)[m])
        else:
            assert isinstance(g.adj_dev, DenseAdj)
            np.testing.assert_array_equal(g.adj_dev.mat.numpy(), np.asarray(r.adj_dev.mat))


def test_reference_cluster_padding_duplicates_edges():
    """The reference pads each group to the largest by repeating its first
    node, and the copies keep that node's edges: its neighbours in the batch
    get its message 1 + pad times, and their degrees count it as often. The
    port pads nothing and keeps each edge once."""
    # 300 nodes in 8 parts of 38 or 37, 3 parts a batch: groups of 113, 112
    # and 75 nodes, whose first nodes have 2, 3 and 2 neighbours in the batch
    kw = dict(num_node=300, num_classes=3, num_features=8, seed=7)
    ref_ds, ds = ref_planetoid_like(**kw), planetoid_like(**kw)
    groups = bt.cluster_groups(ds.adj, 8, 3, seed=0)
    assert [g.size for g in groups] == [113, 112, 75]
    ref_gcn = ref_bt.build_cluster_batches(ref_ds.adj.tocsr(), 8, 3, "dense", seed=0)
    ref_gat = ref_bt.build_cluster_batches(ref_ds.adj.tocsr(), 8, 3, seed=0, model_kind="gat")
    port_gcn = bt.build_cluster_batches(ds.adj, 8, 3, "dense", seed=0, device=CPU)
    port_gat = bt.build_cluster_batches(ds.adj, 8, 3, seed=0, model_kind="gat", device=CPU)
    csr = ds.adj.tocsr()
    duplicated = 0
    for g, rg, rt, pg, pt in zip(groups, ref_gcn, ref_gat, port_gcn, port_gat):
        b, pad = g.size, int(np.asarray(rg.node_ids).size) - g.size
        sub = csr[g][:, g]
        np.testing.assert_array_equal(pg.node_ids.numpy(), g)
        np.testing.assert_allclose(pg.adj_dev.mat.numpy(), sym_norm(sub, 0.5).toarray(),
                                   rtol=0, atol=0)
        assert int(pt.adj_dev.mask.sum()) == sub.nnz
        if pad == 0:
            continue
        # the reference's edges into real nodes from the padded copies of g[0]
        m = np.asarray(rt.adj_dev.mask) > 0
        row, col = np.asarray(rt.adj_dev.row)[m], np.asarray(rt.adj_dev.col)[m]
        from_copies = int(((row < b) & (col >= b)).sum())
        neighbours = int(sub[:, 0].nnz) - int(sub[0, 0] != 0)
        assert from_copies == pad * neighbours > 0
        duplicated += from_copies
        # ... and the degrees count them: the reference's sub-degrees of the
        # real nodes (its induced subgraph, copies included) differ
        ids = np.asarray(rg.node_ids)
        ref_deg = np.asarray(ref_ds.adj.tocsr()[ids][:, ids].sum(axis=1)).ravel()[:b]
        deg = np.asarray(sub.sum(axis=1)).ravel()
        np.testing.assert_array_equal(ref_deg - deg, pad * (sub[:, 0].toarray().ravel() != 0))
        ref_block = np.asarray(rg.adj_dev.mat)[:b, :b]
        assert np.abs(ref_block - pg.adj_dev.mat.numpy()).max() > 1e-3
    assert duplicated > 0


def test_cluster_batches_cover_every_node_once(graph):
    _, ds = graph
    batches = bt.build_cluster_batches(ds.adj, 6, 4, seed=1, device=CPU)
    seen = np.concatenate([b.node_ids.numpy() for b in batches])
    np.testing.assert_array_equal(np.sort(seen), np.arange(N))


# --- the triplet loss and the reference's NaN gradients --------------------------


def test_triplet_loss_matches_reference():
    rng = np.random.default_rng(0)
    h = rng.normal(size=(40, 6)).astype(np.float32)
    y = rng.integers(0, 4, 40)
    idx = rng.choice(40, 25, replace=False)
    want = float(ref_bl.triplet_loss(jnp.asarray(h), jnp.asarray(y), jnp.asarray(idx), 4))
    got = bl.triplet_loss(torch.from_numpy(h), torch.from_numpy(y), torch.from_numpy(idx), 4)
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)


def test_triplet_loss_with_a_single_node_class_keeps_a_finite_gradient():
    """A class with one train node sits at distance 0 from its centroid:
    ``jnp.linalg.norm``'s gradient there is NaN, and it spreads through the
    centroids; torch's ``vector_norm`` gives 0."""
    rng = np.random.default_rng(1)
    h = rng.normal(size=(20, 5)).astype(np.float32)
    y = np.array([0] + [1] * 10 + [2] * 9)
    idx = np.arange(20)
    ref_grad = np.asarray(jax.grad(lambda a: ref_bl.triplet_loss(
        a, jnp.asarray(y), jnp.asarray(idx), 3))(jnp.asarray(h)))
    assert np.isnan(ref_grad).any()
    ht = torch.tensor(h, requires_grad=True)
    bl.triplet_loss(ht, torch.from_numpy(y), torch.from_numpy(idx), 3).backward()
    assert bool(torch.isfinite(ht.grad).all()) and bool(ht.grad.abs().sum() > 0)


def test_robust_mlp_zero_hidden_row_stops_at_the_relu(graph):
    """An all-zero hidden row (a node whose features are all zero: the
    layers give their biases, 0 at init) under the triplet term. The
    reference's norm gradient is NaN on that row, but ReLU's gradient at 0
    is a select that stops it: no parameter of either package gets a NaN."""
    ref_mod, ref_in, variables, mod, inputs, y, train = _carried("robust_mlp", graph)
    x = np.asarray(ref_in[0]).copy()
    x[train[0]] = 0.0
    hidden = np.asarray(ref_mod.apply(variables, jnp.asarray(x), train=False)[0])
    assert np.all(hidden[train[0]] == 0.0)
    # the reference's normalization (baselines.py:121) at these rows, which
    # it leaves as they are (unit rows and the zero row)
    def normalized(z):
        z = z / jnp.maximum(jnp.linalg.norm(z, axis=1, keepdims=True), 1e-12)
        return ref_bl.triplet_loss(z, jnp.asarray(y), jnp.asarray(train), C)

    row_grad = np.asarray(jax.grad(normalized)(jnp.asarray(hidden)))
    zero = np.abs(hidden).sum(axis=1) == 0
    assert np.isnan(row_grad[zero]).all() and np.isfinite(row_grad[~zero]).all()

    def ref_fn(p):
        return _ref_loss("robust_mlp", ref_mod.apply({"params": p}, jnp.asarray(x), train=True,
                                                     rngs={"dropout": jax.random.PRNGKey(0)}),
                         y, train)

    ref_grads = jax.grad(ref_fn)(variables["params"])
    assert all(np.isfinite(np.asarray(g)).all() for g in jax.tree_util.tree_leaves(ref_grads))
    loss = _loss("robust_mlp", mod.train()(torch.from_numpy(x)), y, train)
    loss.backward()
    grads = {k: v.grad for k, v in mod.named_parameters()}
    for k, v in params_from_jax(_np_tree(ref_grads)).items():
        np.testing.assert_allclose(grads[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-4, err_msg=k)


def test_robust_mlp_with_a_single_node_class_trains_where_the_reference_gets_nan(graph):
    """The triplet term over train ids holding a class of one node: every
    parameter of the reference's robust MLP but the output layer gets a NaN
    gradient; the port's stay finite."""
    ref_mod, ref_in, variables, mod, inputs, y, train = _carried("robust_mlp", graph)
    lone = train[y[train] == 0][:1]
    train = np.concatenate([lone, train[y[train] != 0]])

    def ref_fn(p):
        return _ref_loss("robust_mlp", ref_mod.apply({"params": p}, *ref_in, train=True,
                                                     rngs={"dropout": jax.random.PRNGKey(0)}),
                         y, train)

    nan = {k: bool(np.isnan(v.numpy()).any())
           for k, v in params_from_jax(_np_tree(jax.grad(ref_fn)(variables["params"]))).items()}
    assert nan["lin_0.weight"] and nan["lin_1.weight"], nan
    loss = _loss("robust_mlp", mod.train()(*inputs), y, train)
    loss.backward()
    assert all(bool(torch.isfinite(p.grad).all()) for p in mod.parameters())


# --- BaselineTask -----------------------------------------------------------------

TASKS = {  # name: keyword arguments of both packages' BaselineTask
    "mlp": dict(hidden_dim=32, dropout=0.3),
    "robust_mlp": dict(hidden_dim=32, dropout=0.3, triplet_weight=0.1),
    "gcn": dict(hidden_dim=32, dropout=0.3),
    "sage": dict(hidden_dim=32, dropout=0.3),
    "gat": dict(hidden_dim=8, dropout=0.3),
    "sgc": dict(),
    "sign": dict(hidden_dim=32, dropout=0.3),
    "gcn_cluster": dict(hidden_dim=32, dropout=0.3, cluster_parts=8, parts_per_batch=2),
}
TASK_GRAPH = dict(num_node=320, num_classes=4, num_features=24, seed=8)


@pytest.fixture(scope="module")
def reference_tasks():
    ds = ref_planetoid_like(**TASK_GRAPH)
    cfg = RefTrainingConfig(num_epochs=40, lr=0.01, seed=1)
    return {name: ref_bt.BaselineTask(ds, name.split("_cluster")[0], cfg, **kw).best_test
            for name, kw in TASKS.items()}


@pytest.mark.parametrize("name", sorted(TASKS))
def test_baseline_task_matches_reference_accuracy(reference_tasks, name):
    ds = planetoid_like(**TASK_GRAPH)
    task = bt.BaselineTask(ds, name.split("_cluster")[0],
                           TrainingConfig(num_epochs=40, lr=0.01, seed=1), device=CPU,
                           **TASKS[name])
    assert abs(task.best_test - reference_tasks[name]) <= 0.06, (task.best_test,
                                                                 reference_tasks[name])
    assert task.best_test > 0.5
    assert len(task.logger.results[0]) == 40 and len(task.history["loss"]) == 40
    assert all(np.isfinite(task.history["loss"]))


def test_baseline_task_runs_and_statistics(graph):
    _, ds = graph
    task = bt.BaselineTask(ds, "sgc", TrainingConfig(num_epochs=5, lr=0.01, seed=1), runs=2,
                           device=CPU)
    assert "±" in task.logger.print_statistics()
    assert len(task.logger.results[1]) == 5
    val, test = task.best_of_run(1)
    assert 0.0 <= test <= 1.0 and task.best_test == pytest.approx(
        np.mean([task.best_of_run(r)[1] for r in range(2)]))


def test_baseline_task_rejects_what_the_reference_rejects(graph):
    _, ds = graph
    with pytest.raises(ValueError, match="full-graph"):
        bt.BaselineTask(ds, "sgc", TrainingConfig(num_epochs=1), cluster_parts=4, run=False,
                        device=CPU)
    with pytest.raises(ValueError, match="unknown baseline"):
        bt.BaselineTask(ds, "gin", TrainingConfig(num_epochs=1), run=False, device=CPU)


@pytest.mark.parametrize("name", ["gcn", "sage"])
def test_gcn_and_sage_on_the_forward_only_pallas_engine_raise(graph, name):
    """The reference fails at its first step on the pallas engine (jax has
    no gradient for its pallas_call); the port raises at construction and
    launches nothing."""
    ref_ds, ds = graph
    with pytest.raises(Exception):
        ref_bt.BaselineTask(ref_ds, name, RefTrainingConfig(num_epochs=1,
                                                           spmm_engine="pallas"))
    before = ell_spmm.launches
    with pytest.raises(RuntimeError, match="forward only"):
        bt.BaselineTask(ds, name, TrainingConfig(num_epochs=1, spmm_engine="pallas"),
                        run=False, device=CPU)
    assert ell_spmm.launches == before


@pytest.mark.parametrize("engine", ["hybrid", "coo", "pallas", "ell"])
def test_sgc_and_sign_precompute_on_any_engine(graph, engine):
    """The precompute needs no gradient: every engine gives the dense
    engine's hops (1e-5)."""
    _, ds = graph
    cfg = TrainingConfig(num_epochs=1, spmm_engine=engine)
    dense = bt.BaselineTask(ds, "sign", TrainingConfig(num_epochs=1), run=False, device=CPU)
    for name in ("sgc", "sign"):
        task = bt.BaselineTask(ds, name, cfg, run=False, device=CPU)
        want = dense.inputs[-1] if name == "sgc" else dense.inputs
        np.testing.assert_allclose(task.inputs.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def test_entry_points_default_to_cuda(graph, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, ds = graph
    with pytest.raises(RuntimeError, match="cuda"):
        bt.BaselineTask(ds, "mlp", TrainingConfig(num_epochs=1), run=False)
    with pytest.raises(RuntimeError, match="cuda"):
        bt.build_cluster_batches(ds.adj, 4, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        bl.EdgeList.from_scipy(ds.adj).to("cuda")
