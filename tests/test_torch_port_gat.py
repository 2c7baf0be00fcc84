"""The port's GAT in its published form (PyG's ``GATConv`` stack of
``ogbn_products_gat.py``: heads, skip linears, a bias after the
aggregation, self-loops, attention dropout of its own) against the plain
reference of the benchmark (``portbench/reference/gat.py``), and the fused
attention of :mod:`ssrg_torch.ops.gat_attention`.

On the CPU the attention runs its plain versions through the same autograd
function the kernels use, so these cases check the steps the kernels take
(the softmax statistics, the weighted sum, ``delta = <g, out>`` and the one
pass over the transposed listing) against autograd through the written-out
equations. Tolerances, each with its reason:

- logits and the loss: 1e-5 relative (float32 sums of a few hundred terms
  in another order: the heads' dot products, the softmax's sums, the
  weighted sums);
- the gradient of every leaf: 1e-4 of the leaf's largest entry (the
  backward pass sums ``alpha * g`` by source and takes the softmax's
  gradient through ``delta = <g, out>``, not through each entry's
  ``dalpha``; cancellation in those sums costs a few more digits);
- on a card, the kernels against their plain versions on the same tensors:
  1e-5 of the largest value forward, 1e-4 backward (the order of the f32
  sums changes, and atomics change it from run to run).

This file imports neither jax nor ``ssrg_tpu``, so the ``cuda``-marked
cases also run where only the port is installed:

    python -m pytest tests/test_torch_port_gat.py -m cuda --noconftest
"""

import os
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from portbench.graphs import GraphData, generator
from portbench.programs import gat as program
from portbench.programs.common import make_weights
from portbench.reference import gat as reference
from portbench.reference.common import Precision, leaf_params
from ssrg_torch.configs.config import TrainingConfig
from ssrg_torch.data.graph import Graph
from ssrg_torch.data.synthetic import InMemoryDataset
from ssrg_torch.logger import counter_totals, reset_spans, span_totals
from ssrg_torch.models.baselines import BaselineGAT, EdgeList
from ssrg_torch.models.heads import bind_generator
from ssrg_torch.ops import gat_attention as ga
from ssrg_torch.train.baseline_task import BaselineTask, gat_edges
from ssrg_torch.train.common import cross_entropy_loss

# the full-size graph's sizes, as tools/kernels.py builds it (last on the
# path, so that no file of tools/ shadows another top-level name)
sys.path.append(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
import card  # noqa: E402  (tools/card.py)

N, F_IN = 400, 20
HUB, ISOLATED = 3, 11
SEED = 2**31 + 17


def _graph(n: int = N, hub_degree: int = 300, seed: int = 0) -> GraphData:
    """A random undirected graph, each edge once (``lo < hi``), with a hub
    whose row is longer than a warp's tile and a segment of the kernels
    (``hub_degree`` neighbours) and a node whose only entry is its
    self-loop."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n, 6 * n)
    b = rng.integers(0, n, 6 * n)
    hub_nb = rng.choice(np.arange(n), hub_degree, replace=False)
    a = np.concatenate([a, np.full(hub_degree, HUB)])
    b = np.concatenate([b, hub_nb])
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    keep = (lo != hi) & (lo != ISOLATED) & (hi != ISOLATED)
    key = np.unique(lo[keep] * n + hi[keep])
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, F_IN), generator=g)
    y = torch.randint(0, 47, (n,), generator=g)
    perm = torch.randperm(n, generator=g)
    parts = [torch.sort(p).values for p in (perm[:n // 3], perm[n // 3:n // 2],
                                            perm[n // 2:])]
    return GraphData(n, torch.from_numpy(key // n), torch.from_numpy(key % n), x, y, *parts)


def _cfg(heads: int, hidden: int = 8, classes: int = 47) -> dict:
    return {"model": "gat", "num_layers": 3, "hidden_channels": hidden, "heads": heads,
            "skip": True, "bias": True, "dropout": 0.5, "attn_dropout": 0.0,
            "negative_slope": 0.2, "self_loops": True, "lr": 0.001, "weight_decay": 0.0,
            "dataset": {"num_features": F_IN, "num_classes": classes}}


def _adj(data: GraphData) -> sp.csr_matrix:
    n = data.num_nodes
    lo, hi = data.lo.numpy(), data.hi.numpy()
    ones = np.ones(2 * lo.size, np.float32)
    return sp.csr_matrix((ones, (np.concatenate([lo, hi]), np.concatenate([hi, lo]))),
                         shape=(n, n))


def _module(cfg: dict, weights: dict) -> BaselineGAT:
    ds = cfg["dataset"]
    m = BaselineGAT(ds["num_features"], cfg["hidden_channels"], ds["num_classes"],
                    cfg["num_layers"], heads=cfg["heads"], dropout=cfg["dropout"],
                    published=True, attn_dropout=0.0)
    m.load_state_dict(weights, strict=True)
    return m


@pytest.fixture(scope="module")
def data():
    return _graph()


@pytest.mark.parametrize("heads", [1, 4])
def test_published_form_matches_the_reference(data, heads):
    """Logits, loss and the gradient of every leaf, in training mode (the
    dropout masks drawn from one stream by both), at heads 1 and 4 and a
    last layer of 47 classes."""
    cfg = _cfg(heads)
    weights = make_weights(program.weight_shapes(cfg), SEED, "cpu")
    module = _module(cfg, weights).train()
    bind_generator(module, generator(SEED, "dropout", "cpu"))
    edges = EdgeList.attention(_adj(data))
    logits = module(data.x, edges)
    tr = data.train_idx
    loss = cross_entropy_loss(logits[tr], data.y[tr])
    loss.backward()

    params = leaf_params(weights)
    row, col = reference.entries(data)
    want = reference.forward(data, cfg, params, Precision(), generator(SEED, "dropout", "cpu"),
                             row, col)
    want_loss = torch.nn.functional.cross_entropy(want[tr], data.y[tr])
    want_loss.backward()
    assert logits.shape == (N, 47)
    torch.testing.assert_close(logits.detach(), want.detach(), rtol=1e-5, atol=1e-5)
    assert abs(loss.item() - want_loss.item()) <= 1e-5 * abs(want_loss.item())
    grads = dict(module.named_parameters())
    assert set(grads) == set(params)
    for k, p in params.items():
        scale = float(p.grad.abs().max())
        gap = float((grads[k].grad - p.grad).abs().max())
        assert gap <= 1e-4 * scale, (k, gap, scale)


def test_the_published_parameter_count():
    """The configuration's widths give PyG's published 751,574 parameters."""
    cfg = _cfg(4, hidden=128)
    cfg["dataset"] = {"num_features": 100, "num_classes": 47}
    shapes = program.weight_shapes(cfg)
    assert sum(int(np.prod(s)) for _, s, _ in shapes) == 751_574
    m = BaselineGAT(100, 128, 47, 3, heads=4, published=True)
    assert sum(p.numel() for p in m.parameters()) == 751_574
    assert {k: tuple(p.shape) for k, p in m.named_parameters()} == {k: s for k, s, _ in shapes}


def test_no_draw_is_made_for_the_weights_at_attention_dropout_zero(data):
    """The dropout stream holds exactly the two feature masks of a training
    forward pass; with attention dropout of 0.5 it holds three draws a layer
    more (the plain path drops the weights)."""
    cfg = _cfg(4)
    module = _module(cfg, make_weights(program.weight_shapes(cfg), SEED, "cpu")).train()
    gen = torch.Generator().manual_seed(5)
    bind_generator(module, gen)
    edges = EdgeList.attention(_adj(data))
    module(data.x, edges)
    expect = torch.Generator().manual_seed(5)
    for _ in range(2):
        torch.rand((N, 4 * 8), generator=expect)
    assert torch.equal(gen.get_state(), expect.get_state())
    assert torch.equal(torch.rand(3, generator=gen), torch.rand(3, generator=expect))

    dropped = BaselineGAT(F_IN, 8, 47, 3, heads=4, published=True, attn_dropout=0.5)
    dropped.train()
    gen2 = torch.Generator().manual_seed(5)
    bind_generator(dropped, gen2)
    launches = ga.gat_attention.launches
    dropped(data.x, edges)
    assert not torch.equal(gen2.get_state(), expect.get_state())
    assert ga.gat_attention.launches == launches


def test_a_row_with_only_its_self_loop_takes_its_own_features(data):
    """The isolated node's one entry is its self-loop: weight 1, so its
    attention output is its own z."""
    edges = EdgeList.attention(_adj(data))
    assert int((edges.row == ISOLATED).sum()) == 1
    g = torch.Generator().manual_seed(0)
    z = torch.randn((N, 4, 6), generator=g)
    s_src, s_dst = torch.randn((N, 4), generator=g), torch.randn((N, 4), generator=g)
    out = ga.gat_attention(z, s_src, s_dst, edges)
    torch.testing.assert_close(out[ISOLATED], z[ISOLATED], rtol=0, atol=1e-7)
    hub = edges.row == HUB
    assert int(hub.sum()) > 256 + 1


def test_attention_listing_adds_self_loops_and_its_transpose():
    """Self-loops replace the diagonal; a symmetric structure's transposed
    listing is the same tensors, a directed one's is sorted by source."""
    a = sp.csr_matrix(np.array([[1, 1, 0], [0, 0, 1], [1, 0, 0]], np.float32))
    e = EdgeList.attention(a)
    assert e.nnz == 6 and e.mask is None
    assert e.row.tolist() == [0, 0, 1, 1, 2, 2] and e.col.tolist() == [0, 1, 1, 2, 0, 2]
    assert e.t_row.tolist() == [0, 0, 1, 1, 2, 2] and e.t_col.tolist() == [0, 2, 0, 1, 1, 2]
    sym = EdgeList.attention(a + a.T)
    assert sym.t_row is sym.row and sym.t_col is sym.col
    moved = sym.to("cpu")
    assert moved.t_row is moved.row
    with pytest.raises(ValueError, match="square"):
        EdgeList.attention(sp.csr_matrix((2, 3), dtype=np.float32))


def test_the_fused_backward_on_a_directed_structure():
    """Over a directed structure the backward pass walks a transposed
    listing of its own: its gradients against autograd through the plain
    equations."""
    rng = np.random.default_rng(3)
    n, h, c = 60, 2, 5
    a = sp.csr_matrix((rng.uniform(size=(n, n)) < 0.1).astype(np.float32))
    edges = EdgeList.attention(a)
    assert edges.t_row is not edges.row
    g = torch.Generator().manual_seed(1)
    z = torch.randn((n, h, c), generator=g, requires_grad=True)
    s_src = torch.randn((n, h), generator=g, requires_grad=True)
    s_dst = torch.randn((n, h), generator=g, requires_grad=True)
    w = torch.randn((n, h, c), generator=g)
    (ga.gat_attention(z, s_src, s_dst, edges) * w).sum().backward()
    got = [t.grad.clone() for t in (z, s_src, s_dst)]
    for t in (z, s_src, s_dst):
        t.grad = None
    row, col = edges.row.long(), edges.col.long()
    alpha = reference.softmax_weights(s_src, s_dst, row, col, n, 0.2)
    out = torch.zeros((n, h, c)).index_add(0, row, z[col] * alpha[..., None])
    (out * w).sum().backward()
    for t, gv in zip((z, s_src, s_dst), got):
        torch.testing.assert_close(gv, t.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("what", ["weighted_sum", "linear", "score"])
def test_the_reference_products_have_their_gradients(what, monkeypatch):
    """The reference's written-out products (the blocked weighted sum, the
    linear map, the scores) against ``gradcheck`` in float64, in blocks
    smaller than their inputs."""
    rng = np.random.default_rng(2)
    n, e, h, c = 9, 30, 2, 3
    monkeypatch.setattr(reference, "BLOCK", 7)
    monkeypatch.setattr(reference, "ROWS", 4)
    f64 = dict(dtype=torch.float64, requires_grad=True)
    z = torch.randn((n, h, c), **f64)
    if what == "weighted_sum":
        row = torch.from_numpy(rng.integers(0, n, e))
        col = torch.from_numpy(rng.integers(0, n, e))
        fn = lambda zz, aa: reference.weighted_sum(zz, aa, row, col, Precision())  # noqa: E731
        args = (z, torch.rand((e, h), **f64))
    elif what == "linear":
        fn = lambda xx, ww: reference._Linear.apply(xx, ww, Precision())  # noqa: E731
        args = (torch.randn((n, 5), **f64), torch.randn((4, 5), **f64))
    else:
        fn = lambda zz, aa: reference.score(zz, aa, Precision())  # noqa: E731
        args = (z, torch.randn((1, h, c), **f64))
    assert torch.autograd.gradcheck(fn, args)


def test_the_tf32_control_rounds_in_blocks(data, monkeypatch):
    """The reference's TF32 control gives the same step in blocks of rows as
    in one block: the rounding is elementwise."""
    cfg = _cfg(4)
    weights = make_weights(program.weight_shapes(cfg), SEED, "cpu")
    one = reference.train_steps(data, cfg, weights, SEED, 1, "tf32")
    monkeypatch.setattr(reference, "ROWS", 64)
    monkeypatch.setattr(reference, "BLOCK", 1000)
    blocked = reference.train_steps(data, cfg, weights, SEED, 1, "tf32")
    assert blocked["losses"] == pytest.approx(one["losses"], rel=1e-6)
    for k in one["grads"]:
        assert blocked["grads"][k] == pytest.approx(one["grads"][k], rel=1e-5, abs=1e-9)
    plain = reference.train_steps(data, cfg, weights, SEED, 1)
    assert plain["losses"] != one["losses"]


def _dataset(data: GraphData) -> InMemoryDataset:
    graph = Graph(data.lo.numpy(), data.hi.numpy(), np.ones(data.num_edges, np.float32),
                  data.num_nodes, "UUU", x=data.x.numpy(), y=data.y.numpy())
    return InMemoryDataset(graph, data.train_idx.numpy(), data.val_idx.numpy(),
                           data.test_idx.numpy(), name="gat")


def test_baseline_task_takes_the_published_options(data):
    """``BaselineTask`` passes heads and the published options to the
    module and builds the attention listing (span ``prepare.edges``); the
    forward and backward passes are the spans ``attn`` and ``attn.bwd``
    with their counters. Without the options it is the reference's form:
    8 heads, the padded list."""
    reset_spans()
    task = BaselineTask(_dataset(data), "gat", TrainingConfig(num_epochs=2, lr=0.01),
                        hidden_dim=8, num_layers=3, heads=4, published=True, device="cpu")
    m = task.module
    assert (m.heads, m.published, m.attn_dropout.rate) == (4, True, 0.0)
    assert task.adj_op.t_row is not None and task.adj_op.nnz == 2 * data.num_edges + N
    assert len(task.history["loss"]) == 2 and all(np.isfinite(task.history["loss"]))
    spans, counts = span_totals(), counter_totals()
    assert spans["prepare.edges"]["calls"] == 1
    # 2 epochs: 3 layers forward in training and evaluation, 3 backward
    assert spans["attn"]["calls"] == 12 and spans["attn.bwd"]["calls"] == 6
    assert counts["attn.edges"] == 18 * task.adj_op.nnz and counts["attn.heads"] == 18 * 4
    assert counts["attn.launches"] == 0 and counts["attn.row_launches"] == 0

    plain = BaselineTask(_dataset(data), "gat", TrainingConfig(num_epochs=1), hidden_dim=4,
                         run=False, device="cpu")
    assert plain.module.heads == 8 and plain.adj_op.t_row is None
    assert plain.adj_op.row.shape[0] % 512 == 0
    assert plain.module.attn_dropout is plain.module.dropout
    assert not plain.module.published and not hasattr(plain.module, "skip_0")
    looped = gat_edges(_adj(data), published=True)
    assert looped.mask is None and looped.nnz == 2 * data.num_edges + N


def test_cluster_batches_take_the_attention_listing(data):
    """Cluster minibatches of the published form: each batch's induced
    subgraph as an attention listing with its self-loops, trained through
    the fused attention."""
    task = BaselineTask(_dataset(data), "gat", TrainingConfig(num_epochs=1, lr=0.01),
                        hidden_dim=8, num_layers=3, heads=2, published=True,
                        cluster_parts=4, parts_per_batch=2,
                        device="cpu")
    adj = _adj(data)
    for batch in task.cluster_batches:
        g = batch.node_ids.numpy()
        edges = batch.adj_dev
        assert edges.t_row is edges.row
        assert edges.nnz == adj[g][:, g].nnz + g.size
    assert np.isfinite(task.history["loss"]).all()


@pytest.mark.parametrize("published,attn_dropout,rate", [
    (False, None, 0.5), (False, 0.0, 0.0), (True, None, 0.0), (True, 0.3, 0.3)])
def test_the_form_chooses_the_listing_and_the_rate_only_the_rate(data, published,
                                                                 attn_dropout, rate):
    """The published form takes the attention listing and the reference's
    form its padded list, whatever the attention's dropout rate; the rate
    (None: the form's own) drops only the weights."""
    task = BaselineTask(_dataset(data), "gat", TrainingConfig(num_epochs=1), hidden_dim=4,
                        num_layers=2, heads=2, dropout=0.5, published=published,
                        attn_dropout=attn_dropout, run=False, device="cpu")
    assert (task.adj_op.t_row is not None) == published
    assert (task.adj_op.mask is None) == published
    assert task.module.published == published
    assert task.module.attn_dropout.rate == rate


def test_cluster_batches_of_the_reference_form_keep_the_padded_list(data):
    task = BaselineTask(_dataset(data), "gat", TrainingConfig(num_epochs=1), hidden_dim=4,
                        num_layers=2, heads=2, attn_dropout=0.0, cluster_parts=4,
                        parts_per_batch=2, run=False, device="cpu")
    for batch in task.cluster_batches:
        assert batch.adj_dev.t_row is None and batch.adj_dev.mask is not None
        assert batch.adj_dev.row.shape[0] % 512 == 0


SCORE_SHAPES = [(h, c) for h in (1, 4) for c in (47, 128, 30)]  # 30: not whole float4s


def _score_inputs(n, h, c, dtype=torch.float32, seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    z = torch.randn((n, h, c), generator=g, dtype=dtype)
    a_src = torch.randn((1, h, c), generator=g, dtype=dtype)
    a_dst = torch.randn((1, h, c), generator=g, dtype=dtype)
    ds_src = torch.randn((n, h), generator=g, dtype=dtype)
    ds_dst = torch.randn((n, h), generator=g, dtype=dtype)
    return [t.to(device) for t in (z, a_src, a_dst, ds_src, ds_dst)]


@pytest.mark.parametrize("h,c", SCORE_SHAPES)
def test_the_plain_scores_are_the_expression_and_its_gradient(h, c):
    """``scores_plain`` is ``(z * a).sum(-1)`` bit for bit, and
    ``score_grad_plain`` is autograd's gradient of both scores."""
    z, a_src, a_dst, ds_src, ds_dst = _score_inputs(37, h, c)
    got = ga.scores_plain(z, a_src, a_dst)
    assert torch.equal(got[0], (z * a_src).sum(-1)) and torch.equal(got[1], (z * a_dst).sum(-1))
    leaves = [t.clone().requires_grad_(True) for t in (z, a_src, a_dst)]
    s_src, s_dst = (leaves[0] * leaves[1]).sum(-1), (leaves[0] * leaves[2]).sum(-1)
    want = torch.autograd.grad((s_src, s_dst), leaves, (ds_src, ds_dst))
    for g, w in zip(ga.score_grad_plain(z, a_src, a_dst, ds_src, ds_dst), want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("h,c", SCORE_SHAPES)
def test_gat_scores_on_the_cpu_takes_the_expression_under_autograd(h, c):
    """On the CPU ``gat_scores`` gives the expression's values and autograd's
    gradients of them, bit for bit, in the span ``attn.scores`` with no
    launch; the autograd function over the plain steps agrees."""
    z, a_src, a_dst, ds_src, ds_dst = _score_inputs(37, h, c)
    leaves = [t.clone().requires_grad_(True) for t in (z, a_src, a_dst)]
    reset_spans()
    got = ga.gat_scores(*leaves)
    assert span_totals()["attn.scores"]["calls"] == 1
    assert counter_totals()["attn.score_launches"] == 0
    got_grads = torch.autograd.grad(got, leaves, (ds_src, ds_dst))
    want = ((leaves[0] * leaves[1]).sum(-1), (leaves[0] * leaves[2]).sum(-1))
    want_grads = torch.autograd.grad(want, leaves, (ds_src, ds_dst))
    for g, w in zip((*got, *got_grads), (*want, *want_grads)):
        assert torch.equal(g, w)
    fn = ga._GATScores.apply(*leaves)
    fn_grads = torch.autograd.grad(fn, leaves, (ds_src, ds_dst))
    for g, w in zip((*fn, *fn_grads), (*want, *want_grads)):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def test_the_scores_function_passes_gradcheck():
    """The autograd function over the plain steps, in float64."""
    z, a_src, a_dst, _, _ = _score_inputs(5, 2, 3, dtype=torch.float64)
    args = [t.requires_grad_(True) for t in (z, a_src, a_dst)]
    assert torch.autograd.gradcheck(ga._GATScores.apply, args)


@pytest.mark.parametrize("published", [True, False])
def test_baseline_gat_scores_are_the_reference_expression_on_the_cpu(data, published,
                                                                      monkeypatch):
    """Both forms of ``BaselineGAT`` give, on the CPU, the output and
    gradients they gave with the scores written as ``(z * a).sum(-1)`` in
    the model, bit for bit."""
    from ssrg_torch.models import baselines

    def run():
        module = BaselineGAT(F_IN, 8, 47, 3, heads=4, published=published)
        module.reset_parameters(torch.Generator().manual_seed(2))
        bind_generator(module.train(), torch.Generator().manual_seed(3))
        edges = EdgeList.attention(_adj(data)) if published else EdgeList.from_scipy(_adj(data))
        out = module(data.x, edges)
        out.square().sum().backward()
        return [out.detach()] + [p.grad for _, p in sorted(module.named_parameters())]

    got = run()
    monkeypatch.setattr(baselines, "gat_scores",
                        lambda z, a_src, a_dst: ((z * a_src).sum(-1), (z * a_dst).sum(-1)))
    want = run()
    assert len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want))


def test_baseline_task_counts_the_score_spans(data):
    """Two epochs of the published form: the scores' span once a layer in
    each forward pass (training and evaluation), none of it inside the
    attention's; no launch on the CPU."""
    reset_spans()
    BaselineTask(_dataset(data), "gat", TrainingConfig(num_epochs=2, lr=0.01), hidden_dim=8,
                 num_layers=3, heads=4, published=True, device="cpu")
    spans, counts = span_totals(), counter_totals()
    assert spans["attn.scores"]["calls"] == 12 and spans["attn"]["calls"] == 12
    assert counts["attn.score_launches"] == 0


def test_the_score_reader_sums_the_score_spans(monkeypatch):
    """``score_device_ms.gat`` sums the capture's ``attn.scores`` and
    ``attn.scores.bwd`` device times over the epochs, and reads nothing where
    the program keeps no such span (the attention's own are not its)."""
    from portbench import manifest, spans
    from portbench.tracing import TraceView

    def rec(name, start, end, device_ms):
        return {"name": name, "start_us": start, "end_us": end, "device_ms": device_ms,
                "thread": 1, "parent": None, "counts": {}}

    records = [rec("attn.scores", 0, 5, 1.5), rec("attn", 5, 10, 30.0),
               rec("attn.scores.bwd", 20, 25, 2.5), rec("attn.bwd", 12, 18, 40.0)]
    monkeypatch.setattr(spans, "records", lambda: records)
    view = TraceView(2, 1.0, 0.5, [("kernel", "k", 0.0, 80.0)], [])
    reader = manifest.reader("score_device_ms.gat")
    assert reader.read(view, {}) == pytest.approx(2.0)
    records[:] = [r for r in records if not r["name"].startswith("attn.scores")]
    assert reader.read(view, {}) is None


@pytest.mark.parametrize("h,c,aligned,want", [
    (4, 47, True, ga.WHOLE_ROW),         # the GAT cell's last layer
    (2, 30, True, ga.WHOLE_ROW),         # a 60-float row, heads of 30
    (8, 47, True, ga.WHOLE_ROW),         # 376 floats
    (4, 127, True, ga.WHOLE_ROW),        # 508 floats, the longest such row the path holds
    (1, 47, True, ga.PER_HEAD_SCALAR),   # a row that is not whole float4s
    (4, 47, False, ga.PER_HEAD_SCALAR),  # an operand not 16-byte aligned
    (12, 47, True, ga.PER_HEAD_SCALAR),  # more heads than the path holds
    (8, 66, True, ga.PER_HEAD_SCALAR),   # 528 floats, longer than the path holds
    (4, 128, True, ga.PER_HEAD_FLOAT4),  # the hidden layers: heads of whole float4s
    (4, 128, False, ga.PER_HEAD_SCALAR),
    (1, 16, True, ga.PER_HEAD_FLOAT4),
])
def test_the_layout_follows_the_shape_and_the_alignment(h, c, aligned, want):
    """The whole-row path takes heads that are not whole float4s in rows
    that are, up to the path's heads and floats, when every operand is
    16-byte aligned; every other shape keeps the per-head lanes it had. The
    bounds are the kernel source's own constants."""
    assert ga.layout(h, c, aligned) == want
    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "ssrg_torch", "csrc", "gat_attention.cu")) as f:
        src = f.read()
    for const, value in (("kRowFloats", ga.ROW_MAX_FLOATS), ("kRowHeads", ga.ROW_MAX_HEADS)):
        assert f"constexpr int {const} = {value};" in src


# -- on a card -----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.device("cuda")


CARD_CASES = [  # (nodes, hub degree, heads, head width)
    (3000, 2000, 4, 128),   # float4 lanes, a hub of 8 segments
    (3000, 2000, 4, 47),    # whole rows: heads that straddle float4s, 3 float4s a lane
    (2000, 700, 1, 16),     # one head, groups of 8 lanes
    (2000, 700, 2, 300),    # 16 floats a lane
    (2000, 300, 3, 64),     # groups of 16 lanes
    (2000, 700, 2, 30),     # whole rows of 60 floats, heads of 30
    (2000, 700, 8, 47),     # whole rows of 376 floats, groups of 32 lanes
    (2000, 700, 1, 47),     # scalar lanes: a row that is not whole float4s
]
# and at full size: the power-law graph at ogbn-arxiv's 169,343 nodes (its
# attention listing, about 2.3 M entries), at the GAT cell's head widths
FULL_CARD_CASES = CARD_CASES + [(card.NUM_NODES, "powerlaw", 4, 128),
                                (card.NUM_NODES, "powerlaw", 4, 47)]


def _card_id(case):
    return "n{}_hub{}_h{}_c{}".format(*case)


def _card_inputs(case, device, seed=0):
    n, hub, h, c = case
    if hub == "powerlaw":
        from ssrg_torch.data.synthetic import powerlaw_graph

        edges = EdgeList.attention(powerlaw_graph(n, card.AVG_DEGREE, card.NUM_FEATURES,
                                                  seed=seed).adj).to(device)
    else:
        edges = EdgeList.attention(_adj(_graph(n, hub, seed))).to(device)
    g = torch.Generator().manual_seed(seed)
    z = torch.randn((n, h, c), generator=g).to(device)
    s_src = torch.randn((n, h), generator=g).to(device)
    s_dst = torch.randn((n, h), generator=g).to(device)
    grad = torch.randn((n, h, c), generator=g).to(device)
    return edges, z, s_src, s_dst, grad


def _gap(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FULL_CARD_CASES, ids=_card_id)
def test_kernels_match_their_plain_versions(cuda_device, case):
    """Each step's kernel against its plain version on the same card
    tensors, forward and backward, each launching its kernels once (the
    statistics two: maxima, sums); the row dot packs ``s_dst``, ``m`` and
    ``l`` as they are."""
    edges, z, s_src, s_dst, grad = _card_inputs(case, cuda_device)
    nnz, slope = edges.nnz, 0.2
    named = dict(ga.gat_attention.kernel_launches)
    m, l = ga.softmax_stats(edges.row, edges.col, s_src, s_dst, nnz, slope)
    out = ga.aggregate(edges.row, edges.col, s_src, s_dst, m, l, z, nnz, slope)
    q = ga.rowdot(grad, out, s_dst, m, l)
    dz, ds_src, ds_dst = ga.backward(edges.t_row, edges.t_col, q, s_src, z, grad, nnz, slope)
    m_p, l_p = ga.softmax_stats_plain(edges.row, edges.col, s_src, s_dst, nnz, slope)
    out_p = ga.aggregate_plain(edges.row, edges.col, s_src, s_dst, m_p, l_p, z, nnz, slope)
    q_p = ga.rowdot_plain(grad, out_p, s_dst, m_p, l_p)
    dz_p, ds_src_p, ds_dst_p = ga.backward_plain(edges.t_row, edges.t_col, q_p, s_src, z,
                                                 grad, nnz, slope)
    torch.cuda.synchronize()
    moved = {k: v - named[k] for k, v in ga.gat_attention.kernel_launches.items() if v != named[k]}
    row = {ga.ROW_PATH: 2} if ga.layout(*z.shape[1:], True) == ga.WHOLE_ROW else {}
    assert moved == {"gat_stats_kernel": 2, "gat_aggregate_kernel": 1, "gat_rowdot_kernel": 1,
                     "gat_backward_kernel": 1, **row}
    assert torch.equal(q[..., :3], torch.stack([s_dst, m, l], dim=-1))
    assert torch.equal(m, m_p)          # a maximum is exact in any order
    assert _gap(l, l_p) <= 1e-5
    assert _gap(out, out_p) <= 1e-5
    assert _gap(q, q_p) <= 1e-5
    for got, want in ((dz, dz_p), (ds_src, ds_src_p), (ds_dst, ds_dst_p)):
        assert _gap(got, want) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("case,offset", [(CARD_CASES[1], 0), (CARD_CASES[5], 0),
                                         (CARD_CASES[6], 0), (CARD_CASES[7], 0),
                                         (CARD_CASES[1], 1), (CARD_CASES[0], 0)],
                         ids=["h4_c47", "h2_c30", "h8_c47", "h1_c47", "h4_c47_unaligned",
                              "h4_c128"])
def test_the_whole_row_path_where_the_shape_allows_it(cuda_device, case, offset):
    """Forward and backward through the autograd function, z starting
    ``offset`` floats into its storage (1: not 16-byte aligned): the output
    and the gradients those of the plain versions on the CPU, and
    ``attn.row_launches`` 2 (the weighted sum and the backward pass) where
    the layout is the whole row, 0 elsewhere, beside the 5 launches."""
    edges, z, s_src, s_dst, grad = _card_inputs(case, cuda_device)
    n, h, c = z.shape
    storage = torch.zeros(n * h * c + offset, device=cuda_device)
    storage[offset:] = z.reshape(-1)
    storage.requires_grad_(True)
    zv = storage[offset:].view(n, h, c)
    leaves = [s_src.clone().requires_grad_(True), s_dst.clone().requires_grad_(True)]
    reset_spans()
    out = ga.gat_attention(zv, *leaves, edges)
    out.backward(grad)
    torch.cuda.synchronize()
    counts = counter_totals()
    rows = 2 if ga.layout(h, c, offset == 0) == ga.WHOLE_ROW else 0
    assert counts["attn.launches"] == ga.FORWARD_LAUNCHES + ga.BACKWARD_LAUNCHES
    assert counts["attn.row_launches"] == rows
    assert rows == 2 * (offset == 0 and c % 4 != 0 and h * c % 4 == 0)

    cpu = [t.detach().cpu().requires_grad_(True) for t in (z, s_src, s_dst)]
    want = ga.gat_attention(*cpu, edges.to("cpu"))
    want.backward(grad.cpu())
    assert _gap(out.detach().cpu(), want.detach()) <= 1e-5
    for got, leaf in zip((storage.grad[offset:].view(n, h, c), *(t.grad for t in leaves)), cpu):
        assert _gap(got.cpu(), leaf.grad) <= 1e-4


@pytest.mark.cuda
def test_the_autograd_function_on_the_card_counts_its_launches(cuda_device):
    edges, z, s_src, s_dst, grad = _card_inputs(CARD_CASES[0], cuda_device)
    z.requires_grad_(True)
    s_src.requires_grad_(True)
    s_dst.requires_grad_(True)
    before = ga.gat_attention.launches
    out = ga.gat_attention(z, s_src, s_dst, edges)
    assert ga.gat_attention.launches - before == ga.FORWARD_LAUNCHES
    out.backward(grad)
    torch.cuda.synchronize()
    assert ga.gat_attention.launches - before == ga.FORWARD_LAUNCHES + ga.BACKWARD_LAUNCHES
    assert z.grad.shape == z.shape and torch.isfinite(z.grad).all()


@pytest.mark.cuda
def test_memory_of_a_forward_and_backward_pass_holds_no_per_edge_message(cuda_device):
    """E about 4 M entries, 4 heads of 128: a forward and backward pass of
    the attention peaks far below one [E, H * C] float32 tensor (8 GB)."""
    n, deg, h, c = 100_000, 40, 4, 128
    rng = np.random.default_rng(0)
    a = rng.integers(0, n, n * deg // 2)
    b = rng.integers(0, n, n * deg // 2)
    adj = sp.csr_matrix((np.ones(a.size, np.float32), (a, b)), shape=(n, n))
    adj = ((adj + adj.T) > 0).astype(np.float32)
    edges = EdgeList.attention(adj).to(cuda_device)
    assert 3_500_000 <= edges.nnz <= 4_500_000
    g = torch.Generator(device=cuda_device).manual_seed(0)
    z = torch.randn((n, h, c), generator=g, device=cuda_device, requires_grad=True)
    s_src = torch.randn((n, h), generator=g, device=cuda_device, requires_grad=True)
    s_dst = torch.randn((n, h), generator=g, device=cuda_device, requires_grad=True)
    grad = torch.randn((n, h, c), generator=g, device=cuda_device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ga.gat_attention(z, s_src, s_dst, edges).backward(grad)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    per_edge_message = edges.nnz * h * c * 4
    assert peak < per_edge_message / 8, (peak, per_edge_message)


@pytest.mark.cuda
def test_baseline_task_trains_the_published_form_through_the_kernels(cuda_device):
    data = _graph(2000, 700, 1)
    before = ga.gat_attention.launches
    task = BaselineTask(_dataset(data), "gat", TrainingConfig(num_epochs=2, lr=0.01),
                        hidden_dim=16, num_layers=3, heads=4, published=True,
                        device=cuda_device)
    torch.cuda.synchronize()
    # an epoch: 3 layers' attention forward in training and in evaluation,
    # and 3 backward
    assert ga.gat_attention.launches - before == 2 * 3 * (2 * ga.FORWARD_LAUNCHES
                                                          + ga.BACKWARD_LAUNCHES)
    assert all(np.isfinite(task.history["loss"]))


@pytest.mark.cuda
def test_attention_dropout_above_zero_runs_the_kernels_on_the_card(cuda_device, data):
    """A card's training pass over the attention listing at a rate above 0
    draws each layer's mask and runs the kernels that read it (three
    launches a layer forward, by name the masked weighted sum's), with the
    output of the plain versions on the CPU given the same masks;
    evaluation draws none."""
    module = BaselineGAT(F_IN, 8, 47, 3, heads=4, dropout=0.0, published=True,
                         attn_dropout=0.6).to(cuda_device)
    edges = EdgeList.attention(_adj(data)).to(cuda_device)
    x = data.x.to(cuda_device)
    bind_generator(module.train(), torch.Generator(device=cuda_device).manual_seed(4))
    before = ga.gat_attention.launches
    out = module(x, edges)
    assert ga.gat_attention.launches - before == 3 * ga.FORWARD_LAUNCHES
    cpu = BaselineGAT(F_IN, 8, 47, 3, heads=4, dropout=0.0, published=True, attn_dropout=0.6)
    cpu.load_state_dict({k: v.cpu() for k, v in module.state_dict().items()})
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    masks = [torch.rand((4, edges.nnz), generator=gen, device=cuda_device) < 0.4
             for _ in range(3)]
    original = ga.gat_attention

    def with_masks(z, s_src, s_dst, edges_, slope, mask, rate):
        assert mask is not None
        return original(z, s_src, s_dst, edges_, slope, masks.pop(0).cpu(), rate)

    from ssrg_torch.models import baselines

    baselines.gat_attention = with_masks
    try:
        bind_generator(cpu.train(), torch.Generator().manual_seed(0))
        want = cpu(data.x, edges.to("cpu"))
    finally:
        baselines.gat_attention = original
    assert _gap(out.detach().cpu(), want.detach()) <= 1e-5
    before = ga.gat_attention.launches
    with torch.no_grad():
        out = module.eval()(x, edges)
    assert ga.gat_attention.launches - before == 3 * ga.FORWARD_LAUNCHES
    assert out.shape == (N, 47) and torch.isfinite(out).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", FULL_CARD_CASES, ids=_card_id)
def test_score_kernels_match_their_plain_versions(cuda_device, case):
    """Both score kernels against their plain versions on the same card
    tensors, and the gradient's bits the same in two runs (``da`` is summed
    in a fixed order, without atomics)."""
    n, _hub, h, c = case
    z, a_src, a_dst, ds_src, ds_dst = _score_inputs(n, h, c, device=cuda_device)
    got = ga.scores(z, a_src, a_dst)
    want = ga.scores_plain(z, a_src, a_dst)
    grads = ga.score_grad(z, a_src, a_dst, ds_src, ds_dst)
    again = ga.score_grad(z, a_src, a_dst, ds_src, ds_dst)
    want_grads = ga.score_grad_plain(z, a_src, a_dst, ds_src, ds_dst)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _gap(g, w) <= 1e-5
    for g, w in zip(grads, want_grads):
        assert g.shape == w.shape and _gap(g, w) <= 1e-5
    assert all(torch.equal(g, a) for g, a in zip(grads, again))


@pytest.mark.cuda
def test_the_score_function_on_the_card_counts_its_launches(cuda_device):
    """One launch forward and two backward (the gradient, the sum of ``da``),
    by name in ``gat_attention.kernel_launches``, none in the attention's
    count; the gradients those of the expression."""
    z, a_src, a_dst, ds_src, ds_dst = _score_inputs(3000, 4, 47, device=cuda_device)
    leaves = [t.clone().requires_grad_(True) for t in (z, a_src, a_dst)]
    before, attention = ga.gat_scores.launches, ga.gat_attention.launches
    named = dict(ga.gat_attention.kernel_launches)
    s = ga.gat_scores(*leaves)
    assert ga.gat_scores.launches - before == ga.SCORE_FORWARD_LAUNCHES
    grads = torch.autograd.grad(s, leaves, (ds_src, ds_dst))
    torch.cuda.synchronize()
    assert ga.gat_scores.launches - before == (ga.SCORE_FORWARD_LAUNCHES
                                               + ga.SCORE_BACKWARD_LAUNCHES)
    assert ga.gat_attention.launches == attention
    moved = {k: v - named[k] for k, v in ga.gat_attention.kernel_launches.items() if v != named[k]}
    assert moved == {"gat_scores_kernel": 1, "gat_score_grad_kernel": 1,
                     "gat_score_sum_kernel": 1}
    for g, w in zip(grads, ga.score_grad_plain(z, a_src, a_dst, ds_src, ds_dst)):
        assert _gap(g, w) <= 1e-5
