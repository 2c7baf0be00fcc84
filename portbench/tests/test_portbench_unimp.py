"""The ``unimp-products-fullbatch`` cell's own pieces on small copies, on the
CPU: its timed path broken underneath comes out not correct (a step that
leaves its state unchanged, a loss over half of the batch, an attention
weight altered, a mask not applied, the label split drawn otherwise); the
small copy runs the graph-transformer attention and counts what it feeds;
its readers on hand-made captures. The discovery, reference and manifest
tests take the cell from ``BENCHMARK.json`` with the others."""

import pytest
import torch

from portbench import graphs, manifest
from portbench.programs import unimp
from portbench.tests import small
from portbench.tests.test_portbench_spans import program, rec  # noqa: F401  (a fixture)
from portbench.tracing import Kernel, TraceView

CELL = "unimp-products-fullbatch"


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
    """The weighted sum of every layer off by one entry's weight: the plain
    aggregation drops the listing's last entry."""
    from ssrg_torch.ops import gat_attention as ga

    aggregate = ga.edge_aggregate

    def altered(row, col, s, m, l, z, nnz, mask=None, keep=1.0):
        return aggregate(row, col, s, m, l, z, nnz - 1, mask, keep)

    monkeypatch.setattr(ga, "edge_aggregate", altered)
    assert not_correct()


def test_the_mask_left_out(monkeypatch):
    """The weights dropped nowhere, though the masks are drawn."""
    from ssrg_torch.ops import gat_attention as ga

    aggregate = ga.edge_aggregate

    def unmasked(row, col, s, m, l, z, nnz, mask=None, keep=1.0):
        return aggregate(row, col, s, m, l, z, nnz, None, 1.0)

    monkeypatch.setattr(ga, "edge_aggregate", unmasked)
    assert not_correct()


def test_every_train_label_fed_in_training(monkeypatch):
    """The labels of the supervised rows fed too: the loss then sees its
    own answers."""
    from ssrg_torch.train.baseline_task import BaselineTask

    split = BaselineTask.label_split

    def leaky(self, state):
        _fed, sup = split(self, state)
        return self.idx["train"], sup

    monkeypatch.setattr(BaselineTask, "label_split", leaky)
    assert not_correct()


def test_the_small_copy_runs_the_attention_and_feeds_labels():
    from ssrg_torch.logger import counter_totals, reset_spans

    reset_spans()
    _cell, outcome = small.execute(CELL)
    assert outcome.correct
    counts = counter_totals()
    assert counts["attn.heads"] > 0 and counts["attn.edges"] > 0 and counts["attn.masked"] > 0
    assert counts["labels.fed"] > 0


def data_and_config():
    cfg = small.config(CELL)
    return cfg, graphs.make_graph(cfg["dataset"], cfg["graph"], 3, "cpu")


def capture(counts: dict, calls: int = 2, dur: float = 10.0) -> TraceView:
    kernels = [Kernel(f"void (anonymous namespace)::{name}<32, true, 1, 2>(int const*)", i, dur,
                      "") for name, k in counts.items() for i in range(k)]
    return TraceView(calls, 1.0, 0.5, [], kernels)


@pytest.mark.parametrize("kernel", list(unimp.KERNELS))
def test_a_kernel_roofline_reads_only_the_expected_launches(kernel):
    cfg, d = data_and_config()
    reader = manifest.reader(f"{kernel[:-len('_kernel')]}_roofline.unimp")
    info = {"config": cfg, "data": d, "program": unimp}
    expected = 2 * unimp.KERNELS[kernel] * 3
    got = reader.read(capture({kernel: expected}), info)
    least = 2 * unimp.kernel_least_s(kernel, cfg, d)
    assert got == pytest.approx(100.0 * least / (expected * 10.0 / 1e6))
    assert reader.read(capture({kernel: expected - 1}), info) is None
    assert reader.read(capture({kernel: expected}), {}) is None


def test_the_score_device_time_reads_its_spans(program):  # noqa: F811
    program["records"] = [
        rec("attn", 0, 10, device_ms=3.0), rec("attn.qk", 1, 4, device_ms=1.0),
        rec("attn.bwd", 20, 30, thread=7, device_ms=5.0),
        rec("attn.qk.bwd", 22, 28, thread=7, device_ms=2.0),
        rec("spmm.tail", 60, 70, device_ms=100.0),
    ]
    view = TraceView(2, 1.0, 0.5, [("kernel", "k", 0.0, 80.0)], [])
    assert manifest.reader("qk_device_ms.unimp").read(view, {}) == pytest.approx(1.5)
    assert manifest.reader("attn_device_ms.unimp").read(view, {}) == pytest.approx(4.0)
    program["records"][1]["device_ms"] = None
    assert manifest.reader("qk_device_ms.unimp").read(view, {}) is None


def test_the_set_up_and_row_launch_readers(program):  # noqa: F811
    """``setup_graph_s.unimp`` sums the graph build's spans with
    ``prepare.edges`` and reads nothing without the listing;
    ``row_launches_per_epoch.unimp`` reads the ``attn.row_launches``
    counter over the epochs (0 where the attention keeps the per-head
    lanes) and nothing where the program keeps no such counter."""
    program["totals"] = {name: {"calls": 1, "seconds": s, "self_seconds": s} for name, s in
                         [("prepare", 80.0), ("prepare.adjacency", 30.0),
                          ("prepare.edges", 40.0), ("step.forward", 9.0)]}
    busy = TraceView(2, 1.0, 0.5, [("kernel", "k", 0.0, 80.0)], [])
    setup = manifest.reader("setup_graph_s.unimp")
    assert setup.read(busy, {}) == pytest.approx(70.0)
    del program["totals"]["prepare.edges"]
    assert setup.read(busy, {}) is None
    rows = manifest.reader("row_launches_per_epoch.unimp")
    program["records"] = [rec("attn", 0, 10, counts={"attn.row_launches": 0}),
                          rec("attn.bwd", 20, 30, thread=7, counts={"attn.row_launches": 0})]
    assert rows.read(busy, {}) == 0.0
    program["records"][0]["counts"]["attn.row_launches"] = 4
    assert rows.read(busy, {}) == pytest.approx(2.0)
    program["records"] = [rec("attn", 0, 10, counts={"attn.launches": 4})]
    assert rows.read(busy, {}) is None
