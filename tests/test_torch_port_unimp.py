"""The port's UniMP (PyG's ``TransformerConv(beta=True)`` stacked with
``MaskLabel`` as ``examples/unimp_arxiv.py`` stacks them) against the plain
reference of the benchmark (``portbench/reference/unimp.py``), and the
graph-transformer attention of
:func:`ssrg_torch.ops.gat_attention.dot_attention`.

On the CPU the attention runs its plain versions through the same autograd
function the kernels use, so these cases check the steps the kernels take
(the per-edge scores, their softmax statistics, the weighted sum with the
mask's dropped weights, ``delta = <g, out>``, the pass over the transposed
listing that gives dv and the scores' gradient, and the weighted sums that
give dq and dk) against autograd through the written-out equations.
Tolerances, each with its reason:

- logits and the loss: 1e-5 relative (float32 sums of a few hundred terms
  in another order: the heads' dot products, the softmax's sums, the
  weighted sums, the gate's product taken as two sums in place of three);
- the gradient of every leaf: 1e-4 of the leaf's largest entry (the
  backward pass sums by source and takes the softmax's gradient through
  ``delta = <g, out>``; cancellation in those sums costs a few digits);
- on a card, the kernels against their plain versions on the same tensors:
  1e-5 of the largest value forward, 1e-4 backward (the order of the f32
  sums changes, and atomics change it from run to run).

This file imports neither jax nor ``ssrg_tpu``:

    python -m pytest tests/test_torch_port_unimp.py -m cuda --noconftest
"""

import math

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from portbench import manifest
from portbench.graphs import GraphData, generator
from portbench.programs import unimp as program
from portbench.programs.common import make_weights
from portbench.reference import unimp as reference
from portbench.reference.common import Precision, leaf_params
from portbench.tracing import Kernel, TraceView
from ssrg_torch.configs.config import TrainingConfig
from ssrg_torch.data.graph import Graph
from ssrg_torch.data.synthetic import InMemoryDataset
from ssrg_torch.logger import counter_totals, reset_spans, span_totals
from ssrg_torch.models.baselines import BaselineGAT, BaselineUniMP, EdgeList
from ssrg_torch.models.heads import bind_generator
from ssrg_torch.ops import gat_attention as ga
from ssrg_torch.train.baseline_task import BaselineTask
from ssrg_torch.train.common import create_train_state, cross_entropy_loss

N, F_IN = 400, 20
HUB, ISOLATED = 3, 11
SEED = 2**31 + 23


def _graph(n: int = N, hub_degree: int = 300, seed: int = 0) -> GraphData:
    """A random undirected graph, each edge once (``lo < hi``), with a hub
    whose row is longer than a warp's tile and a segment of the kernels
    (``hub_degree`` neighbours) and a node with no edge at all."""
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


def _cfg(heads: int, hidden: int = 8, classes: int = 47, rate: float = 0.3) -> dict:
    return {"model": "unimp", "num_layers": 3, "hidden_channels": hidden, "heads": heads,
            "beta": True, "attn_dropout": rate, "label_rate": 0.625,
            "self_loops": False, "lr": 0.001, "weight_decay": 0.0,
            "dataset": {"num_features": F_IN, "num_classes": classes}}


def _adj(data: GraphData) -> sp.csr_matrix:
    n = data.num_nodes
    lo, hi = data.lo.numpy(), data.hi.numpy()
    ones = np.ones(2 * lo.size, np.float32)
    return sp.csr_matrix((ones, (np.concatenate([lo, hi]), np.concatenate([hi, lo]))),
                         shape=(n, n))


def _module(cfg: dict, weights: dict) -> BaselineUniMP:
    ds = cfg["dataset"]
    m = BaselineUniMP(ds["num_features"], cfg["hidden_channels"], ds["num_classes"],
                      cfg["num_layers"], heads=cfg["heads"], attn_dropout=cfg["attn_dropout"])
    m.load_state_dict(weights, strict=True)
    return m


def _dataset(data: GraphData) -> InMemoryDataset:
    graph = Graph(data.lo.numpy(), data.hi.numpy(), np.ones(data.num_edges, np.float32),
                  data.num_nodes, "UUU", x=data.x.numpy(), y=data.y.numpy())
    return InMemoryDataset(graph, data.train_idx.numpy(), data.val_idx.numpy(),
                           data.test_idx.numpy(), name="unimp")


@pytest.fixture(scope="module")
def data():
    return _graph()


def _close_grads(module, params) -> None:
    """Every leaf's gradient within 1e-4 of its largest entry. A key's bias
    shifts every score of a row alike, so its gradient is 0 but for
    round-off: it is held to its weight's scale."""
    grads = dict(module.named_parameters())
    assert set(grads) == set(params)
    for k, p in params.items():
        of = k.replace(".bias", ".weight") if k.startswith("key_") else k
        scale = float(params[of].grad.abs().max())
        gap = float((grads[k].grad - p.grad).abs().max())
        assert gap <= 1e-4 * max(scale, 1e-12), (k, gap, scale)


@pytest.mark.parametrize("heads", [1, 4])
def test_the_port_matches_the_reference(data, heads):
    """Logits, loss and the gradient of every leaf of one training step, at
    heads 1 and 4 and a last layer of 47 classes: the label split and each
    layer's mask drawn from one stream by both, in the same order; the
    layers checkpointed."""
    cfg = _cfg(heads)
    weights = make_weights(program.weight_shapes(cfg), SEED, "cpu")
    module = _module(cfg, weights).train()
    gen = generator(SEED, "dropout", "cpu")
    bind_generator(module, gen)
    edges = EdgeList.attention(_adj(data), self_loops=False)
    fed_mask = torch.rand(data.train_idx.shape, generator=gen) < cfg["label_rate"]
    fed, sup = data.train_idx[fed_mask], data.train_idx[~fed_mask]
    logits = module(data.x, edges, data.y, fed)
    loss = cross_entropy_loss(logits[sup], data.y[sup])
    loss.backward()

    params = leaf_params(weights)
    row, col = reference.entries(data)
    ref_gen = generator(SEED, "dropout", "cpu")
    want_fed, want_sup = reference.label_split(data, cfg["label_rate"], ref_gen)
    assert torch.equal(fed, want_fed) and torch.equal(sup, want_sup)
    want = reference.forward(data, cfg, params, Precision(), ref_gen, row, col, want_fed)
    want_loss = torch.nn.functional.cross_entropy(want[want_sup], data.y[want_sup])
    want_loss.backward()
    assert torch.equal(gen.get_state(), ref_gen.get_state())
    assert logits.shape == (N, 47)
    torch.testing.assert_close(logits.detach(), want.detach(), rtol=1e-5, atol=1e-5)
    assert abs(loss.item() - want_loss.item()) <= 1e-5 * abs(want_loss.item())
    _close_grads(module, params)


def test_a_last_layer_of_47_and_an_evaluation_forward(data):
    """Evaluation draws nothing and matches the reference's forward without
    masks, every train label fed."""
    cfg = _cfg(4)
    weights = make_weights(program.weight_shapes(cfg), SEED + 1, "cpu")
    module = _module(cfg, weights).eval()
    gen = torch.Generator().manual_seed(9)
    bind_generator(module, gen)
    state = gen.get_state()
    edges = EdgeList.attention(_adj(data), self_loops=False)
    with torch.no_grad():
        got = module(data.x, edges, data.y, data.train_idx)
        row, col = reference.entries(data)
        want = reference.forward(data, cfg, leaf_params(weights), Precision(), None, row, col,
                                 data.train_idx, train=False)
    assert torch.equal(gen.get_state(), state)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_the_parameter_count():
    """The configuration's widths give the count its ``assumed`` states."""
    with open(manifest.ROOT + "/portbench/configs/unimp-products.json") as f:
        import json

        cfg = json.load(f)
    shapes = program.weight_shapes(cfg)
    assert sum(int(np.prod(s)) for _, s, _ in shapes) == 1_580_876
    assert "1,580,876" in cfg["assumed"]["parameters"]
    m = BaselineUniMP(100, 128, 47, 3, heads=4)
    assert sum(p.numel() for p in m.parameters()) == 1_580_876
    assert {k: tuple(p.shape) for k, p in m.named_parameters()} == {k: s for k, s, _ in shapes}


def test_a_node_without_entries_gets_its_skip_alone(data):
    """The isolated node's row has no entry: its attention output is 0, so
    the gate mixes its skip with zeros; the statistics keep -inf and 0."""
    edges = EdgeList.attention(_adj(data), self_loops=False)
    assert int((edges.row == ISOLATED).sum()) == 0 and int((edges.t_row == ISOLATED).sum()) == 0
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((N, 4, 6), generator=g) for _ in range(3))
    out = ga.dot_attention(q, k, v, edges)
    assert torch.equal(out[ISOLATED], torch.zeros(4, 6))
    s = ga.sddmm_plain(edges.row, edges.col, q, k, edges.nnz, 1.0)
    m, l = ga.edge_stats_plain(edges.row, s, N, edges.nnz)
    assert torch.isinf(m[ISOLATED]).all() and torch.equal(l[ISOLATED], torch.zeros(4))


def test_the_hub_row_is_longer_than_a_segment(data):
    """The hub's row spans more than one segment of the kernels (256
    entries) and one warp's tile: the split row's softmax statistics join
    across segments, and the output matches the written-out equations."""
    edges = EdgeList.attention(_adj(data), self_loops=False)
    assert int((edges.row == HUB).sum()) > 256 + 32
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((N, 2, 5), generator=g) for _ in range(3))
    got = ga.dot_attention(q, k, v, edges)
    want = _written_out(q, k, v, edges, None, 1.0)
    torch.testing.assert_close(got[HUB], want[HUB], rtol=1e-5, atol=1e-6)


def _written_out(q, k, v, edges, mask, keep):
    """The attention written out with [E, H] weights, under autograd."""
    row, col = edges.row.long(), edges.col.long()
    n = q.shape[0]
    s = (q[row] * k[col]).sum(-1) / math.sqrt(q.shape[2])
    alpha = reference.softmax_weights(s, row, n)
    if mask is not None:
        alpha = alpha * mask.T * keep
    return torch.zeros_like(v).index_add(0, row, v[col] * alpha[..., None])


@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_the_backward_pass_on_a_directed_structure(rate):
    """Over a directed structure with rows without entries the backward pass
    walks a transposed listing of its own and finds each entry's place in
    the row listing: the gradients to q, k and v against autograd through
    the written-out equations, with and without a mask."""
    rng = np.random.default_rng(3)
    n, h, c = 60, 2, 5
    a = (rng.uniform(size=(n, n)) < 0.08).astype(np.float32)
    a[5] = 0.0  # a row without entries
    edges = EdgeList.attention(sp.csr_matrix(a), self_loops=False)
    assert edges.t_row is not edges.row
    assert (torch.bincount(edges.row.long(), minlength=n) == 0).any()
    g = torch.Generator().manual_seed(1)
    leaves = [torch.randn((n, h, c), generator=g, requires_grad=True) for _ in range(3)]
    w = torch.randn((n, h, c), generator=g)
    mask = (torch.rand((h, edges.nnz), generator=g) < 1 - rate) if rate else None
    (ga.dot_attention(*leaves, edges, mask, rate) * w).sum().backward()
    got = [t.grad.clone() for t in leaves]
    for t in leaves:
        t.grad = None
    (_written_out(*leaves, edges, mask, 1 / (1 - rate)) * w).sum().backward()
    for t, gv in zip(leaves, got):
        torch.testing.assert_close(gv, t.grad, rtol=1e-5, atol=1e-5)


def test_the_listing_without_self_loops_and_its_places():
    """Without self-loops the stored entries stay as they are, a diagonal
    entry included, rows without entries too; ``positions`` gives each
    transposed entry's place in the row listing."""
    a = sp.csr_matrix(np.array([[1, 1, 0, 0], [0, 0, 1, 0], [1, 0, 0, 0], [0, 0, 0, 0]],
                               np.float32))
    e = EdgeList.attention(a, self_loops=False)
    assert e.nnz == 4 and e.row.tolist() == [0, 0, 1, 2] and e.col.tolist() == [0, 1, 2, 0]
    assert e.t_row.tolist() == [0, 0, 1, 2] and e.t_col.tolist() == [0, 2, 0, 1]
    pos = e.positions()
    assert pos.dtype == torch.int32 and pos.tolist() == [0, 3, 1, 2]
    assert torch.equal(e.row[pos.long()], e.t_col) and torch.equal(e.col[pos.long()], e.t_row)
    assert e.positions() is pos and e.to("cpu").t_pos is not None
    sym = EdgeList.attention(a + a.T, self_loops=False)
    assert sym.t_row is sym.row
    p = sym.positions().long()
    assert torch.equal(sym.row[p], sym.t_col) and torch.equal(sym.col[p], sym.t_row)
    looped = EdgeList.attention(a)
    assert looped.nnz == 3 + 4 and looped.t_pos is None


def test_the_plain_steps_are_their_equations():
    """Each plain step against its equation on [E, H] tensors: the scores,
    the statistics, the weighted sum with a mask, the weighted sum at
    given places, and the backward pass's dv and ds."""
    rng = np.random.default_rng(7)
    n, h, c = 30, 3, 4
    edges = EdgeList.attention(sp.csr_matrix((rng.uniform(size=(n, n)) < 0.2)
                                             .astype(np.float32)), self_loops=False)
    e, row, col = edges.nnz, edges.row.long(), edges.col.long()
    g = torch.Generator().manual_seed(3)
    q, k, v, grad = (torch.randn((n, h, c), generator=g) for _ in range(4))
    mask = torch.rand((h, e), generator=g) < 0.7
    s = ga.sddmm_plain(edges.row, edges.col, q, k, e, 0.5)
    torch.testing.assert_close(s, 0.5 * (q[row] * k[col]).sum(-1).T)
    m, l = ga.edge_stats_plain(edges.row, s, n, e)
    alpha = reference.softmax_weights(s.T, row, n)
    out = ga.edge_aggregate_plain(edges.row, edges.col, s, m, l, v, e, mask, 2.0)
    want = torch.zeros_like(v).index_add(0, row, v[col] * (alpha * mask.T * 2.0)[..., None])
    torch.testing.assert_close(out, want)
    pos = edges.positions()
    w = torch.randn((h, e), generator=g)
    dk = ga.weighted_sum_plain(edges.t_row, edges.t_col, w, q, e, pos)
    torch.testing.assert_close(dk, torch.zeros_like(q).index_add(0, col, q[row] * w.T[..., None]))
    q4 = ga.rowdot_plain(grad, out, None, m, l)
    assert torch.equal(q4[..., 0], torch.zeros_like(m))
    dv, ds = ga.edge_backward_plain(edges.t_row, edges.t_col, pos, q4, s, v, grad, e, mask,
                                    2.0, 0.5)
    kept = mask.T * 2.0
    torch.testing.assert_close(dv, torch.zeros_like(v).index_add(
        0, col, grad[row] * (alpha * kept)[..., None]))
    dalpha = (grad[row] * v[col]).sum(-1)
    delta = (grad * out).sum(-1)
    torch.testing.assert_close(ds, (0.5 * alpha * (kept * dalpha - delta[row])).T)


def test_baseline_task_trains_unimp_with_its_spans_and_counters(data):
    """Two epochs through ``BaselineTask``: the listing without self-loops
    and its places built in ``prepare.edges``, the adjacency before it in
    ``prepare.adjacency`` (the set-up metric sums the two); a forward pass of the
    attention three times a layer and epoch (training, the checkpointed
    recomputation, evaluation), a backward once, each holding its scores'
    span; the masks' entries and the labels fed counted; no launch on the
    CPU."""
    reset_spans()
    task = BaselineTask(_dataset(data), "unimp", TrainingConfig(num_epochs=2, lr=0.01),
                        hidden_dim=8, num_layers=3, heads=2, attn_dropout=0.3, label_rate=0.5,
                        device="cpu")
    m = task.module
    assert isinstance(m, BaselineUniMP) and (m.heads, m.attn_dropout.rate) == (2, 0.3)
    edges = task.adj_op
    assert edges.nnz == 2 * data.num_edges and edges.t_pos is not None
    assert len(task.history["loss"]) == 2 and all(np.isfinite(task.history["loss"]))
    spans, counts = span_totals(), counter_totals()
    assert spans["prepare.edges"]["calls"] == 1 and spans["prepare.adjacency"]["calls"] == 1
    assert spans["prepare.edges"]["self_seconds"] == spans["prepare.edges"]["seconds"]
    assert spans["attn"]["calls"] == 18 and spans["attn.qk"]["calls"] == 18
    assert spans["attn.bwd"]["calls"] == 6 and spans["attn.qk.bwd"]["calls"] == 6
    assert counts["attn.edges"] == 24 * edges.nnz and counts["attn.heads"] == 24 * 2
    # masks in the training forward and its recomputation, none in evaluation
    assert counts["attn.masked"] == 12 * 2 * edges.nnz
    assert counts["attn.launches"] == 0 and counts["attn.qk_launches"] == 0
    assert 0 < counts["labels.fed"] < 2 * data.train_idx.numel()


def test_the_label_feed(data, monkeypatch):
    """A training step feeds the train nodes its generator's draw picks,
    each with probability ``label_rate``, and takes the loss over the
    others; evaluation feeds every train label and draws nothing."""
    task = BaselineTask(_dataset(data), "unimp", TrainingConfig(num_epochs=1, lr=0.01),
                        hidden_dim=4, num_layers=2, heads=1, attn_dropout=0.0, label_rate=0.625,
                        run=False, device="cpu")
    state = create_train_state(task.module, torch.Generator().manual_seed(4), 0.01, 0.0)
    seen = []
    forward = BaselineUniMP.forward

    def spy(module, x, edges, labels, fed):
        seen.append(fed.clone())
        return forward(module, x, edges, labels, fed)

    monkeypatch.setattr(BaselineUniMP, "forward", spy)
    expect = torch.Generator().manual_seed(4)
    tr = task.idx["train"]
    want = tr[torch.rand(tr.shape, generator=expect) < 0.625]
    task.train_step(state)
    assert torch.equal(seen[0], want)
    after = state.generator.get_state()
    task.evaluate(state)
    assert torch.equal(seen[1], tr) and torch.equal(state.generator.get_state(), after)
    # at a rate of 0 the step draws the label split alone
    assert torch.equal(after, expect.get_state())


@pytest.mark.parametrize("rate", [None, -0.1, 1.5])
def test_unimp_takes_its_label_rate_from_the_caller(data, rate):
    """UniMP's label rate has no default: a task without one, or with one
    outside [0, 1], is refused before anything is built."""
    with pytest.raises(ValueError, match="label_rate"):
        BaselineTask(_dataset(data), "unimp", TrainingConfig(num_epochs=1, lr=0.01),
                     hidden_dim=4, num_layers=2, heads=1, label_rate=rate, run=False,
                     device="cpu")


def test_the_masks_are_drawn_in_the_reference_order(data):
    """A training forward draws each layer's mask, [H, E], in layer order
    from the bound generator, exactly as the reference draws them; at a
    rate of 0 it draws nothing."""
    cfg = _cfg(2)
    weights = make_weights(program.weight_shapes(cfg), SEED, "cpu")
    edges = EdgeList.attention(_adj(data), self_loops=False)
    for rate, draws in ((0.3, 3), (0.0, 0)):
        cfg["attn_dropout"] = rate
        module = _module(cfg, weights).train()
        gen = torch.Generator().manual_seed(5)
        bind_generator(module, gen)
        module(data.x, edges, data.y, data.train_idx)
        expect = torch.Generator().manual_seed(5)
        for _ in range(draws):
            torch.rand((2, edges.nnz), generator=expect)
        assert torch.equal(gen.get_state(), expect.get_state())


def test_the_reference_scores_have_their_gradient(monkeypatch):
    """The reference's blocked scores against ``gradcheck`` in float64, in
    blocks smaller than their input."""
    from portbench.reference import gat

    rng = np.random.default_rng(2)
    n, e, h, c = 9, 30, 2, 3
    monkeypatch.setattr(gat, "BLOCK", 7)
    row = torch.from_numpy(rng.integers(0, n, e))
    col = torch.from_numpy(rng.integers(0, n, e))
    f64 = dict(dtype=torch.float64, requires_grad=True)
    args = (torch.randn((n, h, c), **f64), torch.randn((n, h, c), **f64))
    assert torch.autograd.gradcheck(
        lambda q, k: reference.scores(q, k, row, col, Precision()), args)


def test_the_tf32_control_moves_the_step(data):
    """The reference in its TF32 control gives another step than in
    float32, and a reference fed a configuration it does not write out
    refuses it."""
    cfg = _cfg(2)
    weights = make_weights(program.weight_shapes(cfg), SEED, "cpu")
    plain = reference.train_steps(data, cfg, weights, SEED, 1)
    tf32 = reference.train_steps(data, cfg, weights, SEED, 1, "tf32")
    assert plain["losses"] != tf32["losses"]
    with pytest.raises(ValueError, match="published stack"):
        reference.train_steps(data, {**cfg, "self_loops": True}, weights, SEED, 1)


def test_gat_drops_its_weights_through_the_fused_attention(data):
    """GAT's published form at an attention dropout above 0 runs the fused
    attention with a mask drawn as Dropout draws one, [H, E]: its output and
    gradients those of the written-out equations with that mask."""
    module = BaselineGAT(F_IN, 8, 47, 2, heads=2, dropout=0.0, published=True,
                         attn_dropout=0.4)
    module.reset_parameters(torch.Generator().manual_seed(2))
    bind_generator(module.train(), torch.Generator().manual_seed(3))
    edges = EdgeList.attention(_adj(data))
    reset_spans()
    out = module(data.x, edges)
    out.square().sum().backward()
    assert counter_totals()["attn.masked"] == 2 * 2 * edges.nnz
    got = [out.detach()] + [p.grad.clone() for _, p in sorted(module.named_parameters())]

    gen = torch.Generator().manual_seed(3)
    masks = [torch.rand((2, edges.nnz), generator=gen) < 0.6 for _ in range(2)]
    original = ga.gat_attention

    def written_out(z, s_src, s_dst, edges_, slope, mask, rate):
        assert torch.equal(mask, masks.pop(0))
        row, col = edges_.row.long(), edges_.col.long()
        a = torch.nn.functional.leaky_relu(s_dst[row] + s_src[col], slope)
        alpha = reference.softmax_weights(a, row, z.shape[0]) * mask.T / (1 - rate)
        return torch.zeros_like(z).index_add(0, row, z[col] * alpha[..., None])

    from ssrg_torch.models import baselines

    baselines.gat_attention = written_out
    try:
        for p in module.parameters():
            p.grad = None
        bind_generator(module, torch.Generator().manual_seed(3))
        out2 = module(data.x, edges)
        out2.square().sum().backward()
    finally:
        baselines.gat_attention = original
    want = [out2.detach()] + [p.grad for _, p in sorted(module.named_parameters())]
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_the_qk_reader_sums_the_score_spans(monkeypatch):
    """``qk_device_ms.unimp`` sums the capture's ``attn.qk`` and
    ``attn.qk.bwd`` device times over the epochs, and reads nothing where the
    program keeps no such span."""
    from portbench import spans

    def rec(name, start, end, device_ms):
        return {"name": name, "start_us": start, "end_us": end, "device_ms": device_ms,
                "thread": 1, "parent": None, "counts": {}}

    records = [rec("attn.qk", 0, 5, 1.5), rec("attn", 0, 10, 30.0),
               rec("attn.qk.bwd", 20, 25, 2.5), rec("attn.bwd", 12, 28, 40.0)]
    monkeypatch.setattr(spans, "records", lambda: records)
    view = TraceView(2, 1.0, 0.5, [("kernel", "k", 0.0, 80.0)], [])
    reader = manifest.reader("qk_device_ms.unimp")
    assert reader.read(view, {}) == pytest.approx(2.0)
    assert manifest.reader("attn_device_ms.unimp").read(view, {}) == pytest.approx(35.0)
    records[:] = [r for r in records if not r["name"].startswith("attn.qk")]
    assert reader.read(view, {}) is None


def _small(hidden=32):
    cfg = _cfg(4, hidden=hidden)
    cfg["dataset"].update(num_nodes=N)
    return cfg


def test_the_epoch_work_by_hand(data):
    """The products of an epoch, counted by hand: q, k, v and skip forward
    in training and evaluation, their dW in the backward pass and dX but at
    the first layer; the attention's forward passes twice (the recomputed
    one is not the model's work)."""
    cfg = _small()
    n, f, h, d, c, heads = N, F_IN, 32, 32, 47, 4
    assert program.layers(cfg) == [(f, d, heads * d), (heads * d, d, heads * d),
                                   (heads * d, c, c)]
    w = program.epoch_work(cfg, data)
    qkv = sum(p[1] for p in w.parts if p[0][0] in "qkv" and p[0][1].isdigit())
    fwd = 2 * n * 3 * (f * heads * h + heads * h * heads * h + heads * h * heads * c)
    dx = 2 * n * 3 * (heads * h * heads * h + heads * c * heads * h)
    assert qkv == 3 * fwd + dx
    sddmm = [p for p in w.parts if p[0].endswith(".sddmm")]
    e = 2 * data.num_edges
    assert len(sddmm) == 6 and sum(p[1] for p in sddmm) == 2 * 2 * e * heads * (d + d + c)
    adam = next(p for p in w.parts if p[0] == "adam")
    params = sum(int(np.prod(s)) for _, s, _ in program.weight_shapes(cfg))
    assert adam[1] == 12.0 * params


def test_each_kernel_least_time_sums_its_launches(data):
    """The kernels' least times over an epoch are the attention's parts of
    the epoch's work and the recomputed forward passes."""
    cfg = _small()
    total = sum(program.kernel_least_s(k, cfg, data) for k in program.KERNELS)
    attn = sum(p[3] for p in program.epoch_work(cfg, data).parts if p[0].startswith("attn"))
    e, h = 2 * data.num_edges, 4
    again = sum(program.attention_forward(program.W.Work(), "r", e, N, h, d, True).least_s
                for _, d, _ in program.layers(cfg))
    assert total == pytest.approx(attn + again)


def _capture(counts: dict, calls: int = 2, dur: float = 10.0) -> TraceView:
    kernels = [Kernel(f"void (anonymous namespace)::{name}<32, true, 1, 2>(int const*)", i,
                      dur, "") for name, k in counts.items() for i in range(k)]
    return TraceView(calls, 1.0, 0.5, [], kernels)


@pytest.mark.parametrize("kernel", list(program.KERNELS))
def test_a_kernel_roofline_reads_only_the_expected_launches(data, kernel):
    cfg = _small()
    reader = manifest.reader(f"{kernel[:-len('_kernel')]}_roofline.unimp")
    info = {"config": cfg, "data": data, "program": program}
    expected = 2 * program.KERNELS[kernel] * 3
    got = reader.read(_capture({kernel: expected}), info)
    least = 2 * program.kernel_least_s(kernel, cfg, data)
    assert got == pytest.approx(100.0 * least / (expected * 10.0 / 1e6))
    assert reader.read(_capture({kernel: expected - 1}), info) is None
    assert reader.read(_capture({kernel: expected}), {}) is None


# -- on a card -----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.device("cuda")


CARD_CASES = [  # (nodes, hub degree, heads, head width)
    (3000, 2000, 4, 128),   # float4 lanes, a hub of 8 segments
    (3000, 2000, 4, 47),    # scalar lanes: the last layer's heads
    (2000, 700, 1, 16),     # one head, groups of 8 lanes
    (2000, 700, 2, 300),    # 16 floats a lane
    (2000, 300, 3, 64),     # groups of 16 lanes
]


def _card_id(case):
    return "n{}_hub{}_h{}_c{}".format(*case)


def _gap(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def _card_inputs(case, device, seed=0, directed=False):
    n, hub, h, c = case
    adj = _adj(_graph(n, hub, seed))
    if directed:
        adj = sp.triu(adj).tocsr()
    edges = EdgeList.attention(adj, self_loops=False).to(device)
    edges.positions()
    g = torch.Generator().manual_seed(seed)
    q, k, v, grad = (torch.randn((n, h, c), generator=g).to(device) for _ in range(4))
    mask = (torch.rand((h, edges.nnz), generator=g) < 0.7).to(device)
    return edges, q, k, v, grad, mask


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("case", CARD_CASES, ids=_card_id)
def test_edge_kernels_match_their_plain_versions(cuda_device, case, masked):
    """Each per-edge step's kernel against its plain version on the same
    card tensors, forward and backward, each launching its kernels once
    (the statistics two): the scores, the statistics, the weighted sum of v,
    the row dot, the backward pass (dv, ds), the weighted sums for dq and
    dk."""
    edges, q, k, v, grad, mask = _card_inputs(case, cuda_device)
    mask = mask if masked else None
    e, n, pos = edges.nnz, edges.num_nodes, edges.t_pos
    scale, keep = 1.0 / math.sqrt(q.shape[2]), 1.0 / 0.7
    named = dict(ga.gat_attention.kernel_launches)
    s = ga.edge_sddmm(edges.row, edges.col, q, k, e, scale)
    m, l = ga.edge_stats(edges.row, s, n, e)
    out = ga.edge_aggregate(edges.row, edges.col, s, m, l, v, e, mask, keep)
    q4 = ga.rowdot(grad, out, None, m, l)
    dv, ds = ga.edge_backward(edges.t_row, edges.t_col, pos, q4, s, v, grad, e, mask, keep,
                              scale)
    dq = ga.weighted_sum(edges.row, edges.col, ds, k, e)
    dk = ga.weighted_sum(edges.t_row, edges.t_col, ds, q, e, pos)
    s_p = ga.sddmm_plain(edges.row, edges.col, q, k, e, scale)
    m_p, l_p = ga.edge_stats_plain(edges.row, s, n, e)
    out_p = ga.edge_aggregate_plain(edges.row, edges.col, s, m, l, v, e, mask, keep)
    dv_p, ds_p = ga.edge_backward_plain(edges.t_row, edges.t_col, pos, q4, s, v, grad, e, mask,
                                        keep, scale)
    dq_p = ga.weighted_sum_plain(edges.row, edges.col, ds, k, e)
    dk_p = ga.weighted_sum_plain(edges.t_row, edges.t_col, ds, q, e, pos)
    torch.cuda.synchronize()
    moved = {k_: v_ - named[k_] for k_, v_ in ga.gat_attention.kernel_launches.items()
             if v_ != named[k_]}
    assert moved == {"sddmm_kernel": 1, "gat_stats_kernel": 2, "gat_aggregate_kernel": 3,
                     "gat_rowdot_kernel": 1, "gat_backward_kernel": 1}
    assert _gap(s, s_p) <= 1e-5
    assert torch.equal(m, m_p)          # a maximum is exact in any order
    assert _gap(l, l_p) <= 1e-5
    assert _gap(out, out_p) <= 1e-5
    assert torch.equal(q4[..., 0], torch.zeros_like(m))
    for got, want in ((dv, dv_p), (ds, ds_p), (dq, dq_p), (dk, dk_p)):
        assert _gap(got, want) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("case", CARD_CASES[:2], ids=_card_id)
def test_the_attention_function_on_the_card(cuda_device, case):
    """Forward and backward through the autograd function on a directed
    structure (rows without entries, a transposed listing of its own), a
    mask given: the output and gradients those of the plain versions on the
    CPU, four launches each way, two of them the scores' and their
    gradient's."""
    edges, q, k, v, grad, mask = _card_inputs(case, cuda_device, directed=True)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    reset_spans()
    out = ga.dot_attention(*leaves, edges, mask, 0.3)
    out.backward(grad)
    torch.cuda.synchronize()
    counts = counter_totals()
    assert counts["attn.launches"] == 8 and counts["attn.qk_launches"] == 3
    cpu = [t.detach().cpu().requires_grad_(True) for t in (q, k, v)]
    want = ga.dot_attention(*cpu, edges.to("cpu"), mask.cpu(), 0.3)
    want.backward(grad.cpu())
    assert _gap(out.detach().cpu(), want.detach()) <= 1e-5
    for got, leaf in zip(leaves, cpu):
        assert _gap(got.grad.cpu(), leaf.grad) <= 1e-4


@pytest.mark.cuda
def test_memory_of_a_layer_holds_no_per_edge_message(cuda_device):
    """E about 4 M entries, 4 heads of 128: a forward and backward pass of
    the attention, its weights dropped, peaks far below one [E, H * C]
    float32 tensor (8 GB)."""
    n, deg, h, c = 100_000, 40, 4, 128
    rng = np.random.default_rng(0)
    a = rng.integers(0, n, n * deg // 2)
    b = rng.integers(0, n, n * deg // 2)
    adj = sp.csr_matrix((np.ones(a.size, np.float32), (a, b)), shape=(n, n))
    adj = ((adj + adj.T) > 0).astype(np.float32)
    edges = EdgeList.attention(adj, self_loops=False).to(cuda_device)
    edges.positions()
    assert 3_500_000 <= edges.nnz <= 4_500_000
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((n, h, c), generator=g, device=cuda_device, requires_grad=True)
               for _ in range(3))
    grad = torch.randn((n, h, c), generator=g, device=cuda_device)
    mask = torch.rand((h, edges.nnz), generator=g, device=cuda_device) < 0.7
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ga.dot_attention(q, k, v, edges, mask, 0.3).backward(grad)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    per_edge_message = edges.nnz * h * c * 4
    assert peak < per_edge_message / 8, (peak, per_edge_message)


@pytest.mark.cuda
def test_baseline_task_trains_unimp_through_the_kernels(cuda_device):
    """Two epochs on the card: each layer's attention forward three times an
    epoch (training, its recomputation, evaluation) and backward once."""
    data = _graph(2000, 700, 1)
    before = ga.gat_attention.launches
    task = BaselineTask(_dataset(data), "unimp", TrainingConfig(num_epochs=2, lr=0.01),
                        hidden_dim=16, num_layers=3, heads=4, attn_dropout=0.3, label_rate=0.625,
                        device=cuda_device)
    torch.cuda.synchronize()
    assert ga.gat_attention.launches - before == 2 * 3 * (3 * 4 + 4)
    assert all(np.isfinite(task.history["loss"]))


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(3000, 2000, 4, 128), (3000, 2000, 4, 47)], ids=_card_id)
def test_gat_masked_kernels_match_their_plain_versions(cuda_device, case):
    """GAT's weighted sum and backward pass with a mask, on the card against
    the plain versions with the same mask, and through the autograd
    function against the CPU."""
    n, hub, h, c = case
    edges = EdgeList.attention(_adj(_graph(n, hub, 0))).to(cuda_device)
    pos = edges.positions()
    g = torch.Generator().manual_seed(0)
    z, grad = (torch.randn((n, h, c), generator=g).to(cuda_device) for _ in range(2))
    s_src, s_dst = (torch.randn((n, h), generator=g).to(cuda_device) for _ in range(2))
    mask = (torch.rand((h, edges.nnz), generator=g) < 0.6).to(cuda_device)
    e, keep = edges.nnz, 1 / 0.6
    m, l = ga.softmax_stats(edges.row, edges.col, s_src, s_dst, e, 0.2)
    out = ga.aggregate(edges.row, edges.col, s_src, s_dst, m, l, z, e, 0.2, mask=mask, keep=keep)
    out_p = ga.aggregate_plain(edges.row, edges.col, s_src, s_dst, m, l, z, e, 0.2, mask, keep)
    q4 = ga.rowdot(grad, out, s_dst, m, l)
    got = ga.backward(edges.t_row, edges.t_col, q4, s_src, z, grad, e, 0.2, mask=mask, pos=pos,
                      keep=keep)
    want = ga.backward_plain(edges.t_row, edges.t_col, q4, s_src, z, grad, e, 0.2, mask, pos,
                             keep)
    torch.cuda.synchronize()
    assert _gap(out, out_p) <= 1e-5
    for a, b in zip(got, want):
        assert _gap(a, b) <= 1e-4
    leaves = [t.clone().requires_grad_(True) for t in (z, s_src, s_dst)]
    res = ga.gat_attention(*leaves, edges, 0.2, mask, 0.4)
    res.backward(grad)
    cpu = [t.detach().cpu().requires_grad_(True) for t in (z, s_src, s_dst)]
    ref = ga.gat_attention(*cpu, edges.to("cpu"), 0.2, mask.cpu(), 0.4)
    ref.backward(grad.cpu())
    assert _gap(res.detach().cpu(), ref.detach()) <= 1e-5
    for a, b in zip(leaves, cpu):
        assert _gap(a.grad.cpu(), b.grad) <= 1e-4
