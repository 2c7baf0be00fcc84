"""The ``gat-products-fullbatch`` cell's own pieces on small copies, on the
CPU: its timed path broken underneath comes out not correct (a step that
leaves its state unchanged, a loss over half of the batch, an attention
weight altered); its readers on hand-made captures (the attention's
CUDA-event time, each kernel's roofline share, read only when the profile
holds the expected launches); its work counts against counts made by hand.
The discovery, reference and manifest tests take the cell from
``BENCHMARK.json`` with the others."""

import pytest
import torch

from portbench import graphs, manifest
from portbench.programs import gat
from portbench.tests import small
from portbench.tests.test_portbench_spans import program, rec  # noqa: F401  (a fixture)
from portbench.tracing import Kernel, TraceView

CELL = "gat-products-fullbatch"


def not_correct() -> bool:
    _cell, outcome = small.execute(CELL)
    return not outcome.correct


def test_a_step_that_leaves_its_state_unchanged(monkeypatch):
    from ssrg_torch.train import common

    apply = common.TrainState.apply_gradients

    def unchanged(state):
        before = [p.detach().clone() for p in state.module.parameters()]
        apply(state)
        with torch.no_grad():
            for p, b in zip(state.module.parameters(), before):
                p.copy_(b)

    monkeypatch.setattr(common.TrainState, "apply_gradients", unchanged)
    assert not_correct()


def test_half_of_the_batch_left_out(monkeypatch):
    from ssrg_torch.train import baseline_task, common

    loss = common.cross_entropy_loss

    def half(logits, labels, weights=None):
        n = logits.shape[0] // 2
        return loss(logits[:n], labels[:n], None if weights is None else weights[:n])

    monkeypatch.setattr(baseline_task, "cross_entropy_loss", half)
    assert not_correct()


def test_an_attention_weight_altered(monkeypatch):
    """The weighted sum of one layer off by one entry's weight: the fused
    attention's plain aggregation drops the listing's last entry."""
    from ssrg_torch.ops import gat_attention as ga

    aggregate = ga.aggregate

    def altered(row, col, s_src, s_dst, m, l, z, nnz, slope):
        return aggregate(row, col, s_src, s_dst, m, l, z, nnz - 1, slope)

    monkeypatch.setattr(ga, "aggregate", altered)
    assert not_correct()


def test_the_small_copy_runs_the_fused_attention():
    from ssrg_torch.logger import counter_totals, reset_spans

    reset_spans()
    _cell, outcome = small.execute(CELL)
    assert outcome.correct
    counts = counter_totals()
    assert counts["attn.heads"] > 0 and counts["attn.edges"] > 0


def data_and_config():
    cfg = small.config(CELL)
    return cfg, graphs.make_graph(cfg["dataset"], cfg["graph"], 3, "cpu")


def test_gat_epoch_by_hand():
    cfg, d = data_and_config()
    n, e, f, h, c, heads = d.num_nodes, d.nnz, 16, 32, cfg["dataset"]["num_classes"], 4
    assert gat.layers(cfg) == [(f, h, heads * h), (heads * h, h, heads * h), (heads * h, c, c)]
    w = gat.epoch_work(cfg, d)
    lin = sum(p[1] for p in w.parts if p[0].startswith("lin"))
    # forward and evaluation each layer once; backward dW of each, dX of all but the first
    fwd = 2 * n * (f * heads * h + heads * h * heads * h + heads * h * heads * c)
    dx = 2 * n * (heads * h * heads * h + heads * c * heads * h)
    assert lin == 3 * fwd + dx
    agg = [p for p in w.parts if p[0].endswith(".aggregate")]
    assert len(agg) == 6
    assert sum(p[1] for p in agg) == 2 * 2 * e * heads * (h + h + c)
    adam = next(p for p in w.parts if p[0] == "adam")
    params = sum(int(torch.tensor(s).prod()) for _, s, _ in gat.weight_shapes(cfg))
    assert adam[1] == 12.0 * params


def test_each_kernel_least_time_sums_its_launches():
    cfg, d = data_and_config()
    total = sum(gat.kernel_least_s(k, cfg, d) for k in gat.KERNELS)
    attn = sum(p[3] for p in gat.epoch_work(cfg, d).parts if p[0].startswith("attn"))
    assert total == pytest.approx(attn)


def capture(counts: dict, calls: int = 2, dur: float = 10.0) -> TraceView:
    kernels = [Kernel(f"void (anonymous namespace)::{name}<32, true, 1>(int const*)", i, dur, "")
               for name, k in counts.items() for i in range(k)]
    return TraceView(calls, 1.0, 0.5, [], kernels)


@pytest.mark.parametrize("kernel", list(gat.KERNELS))
def test_a_kernel_roofline_reads_only_the_expected_launches(kernel):
    cfg, d = data_and_config()
    reader = manifest.reader(f"{kernel[:-len('_kernel')]}_roofline.gat")
    info = {"config": cfg, "data": d, "program": gat}
    expected = 2 * gat.KERNELS[kernel] * 3
    got = reader.read(capture({kernel: expected}), info)
    least = 2 * gat.kernel_least_s(kernel, cfg, d)
    assert got == pytest.approx(100.0 * least / (expected * 10.0 / 1e6))
    assert reader.read(capture({kernel: expected - 1}), info) is None
    assert reader.read(capture({kernel: expected}), {}) is None


def test_the_attention_device_time_reads_its_spans(program):  # noqa: F811
    program["records"] = [
        rec("attn", 0, 10, device_ms=3.0), rec("attn.bwd", 20, 30, thread=7, device_ms=5.0),
        rec("attn", 40, 50, device_ms=4.0), rec("spmm.tail", 60, 70, device_ms=100.0),
    ]
    view = TraceView(2, 1.0, 0.5, [("kernel", "k", 0.0, 80.0)], [])
    reader = manifest.reader("attn_device_ms.gat")
    assert reader.read(view, {}) == pytest.approx(6.0)
    program["records"][0]["device_ms"] = None
    assert reader.read(view, {}) is None


def test_the_gat_graph_build_adds_the_attention_listing(program):  # noqa: F811
    """``setup_graph_s.gat`` sums ``setup_graph_s``'s spans and
    ``prepare.edges``, and reads nothing without a listing or a capture."""
    program["totals"] = {name: {"calls": 1, "seconds": s, "self_seconds": s} for name, s in
                         [("prepare", 60.0), ("prepare.adjacency", 30.0),
                          ("prepare.edges", 20.0), ("prepare.copy", 0.5),
                          ("step.forward", 9.0)]}
    reader = manifest.reader("setup_graph_s.gat")
    busy = TraceView(2, 1.0, 0.5, [("kernel", "k", 0.0, 80.0)], [])
    assert reader.read(busy, {}) == pytest.approx(50.0)
    assert reader.read(TraceView(0, 1.0, 0.5, [], []), {}) is None
    del program["totals"]["prepare.edges"]
    assert reader.read(busy, {}) is None
