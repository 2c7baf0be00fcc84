"""The port's logger (``ssrg_torch.logger``) against ``ssrg_tpu.logger``:
the cases of ``tests/test_aux.py`` for ``RunLogger``, ``MetricsWriter`` and
``PhaseTimer`` on both packages, and ``device_trace`` on ``torch.profiler``
(on the CPU here). Then the port's own spans and counters: totals, records
under a profiler, the trace's clock, and the spans of the hybrid SpMM, the
epoch, ``prepare`` and serving on tiny graphs."""

import json
import logging
import statistics
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ssrg_tpu import logger as ref_logger

from ssrg_torch import logger
from ssrg_torch.configs.config import ModelConfig, TrainingConfig
from ssrg_torch.data.synthetic import planetoid_like
from ssrg_torch.ops import sparse


@pytest.mark.parametrize("run", [None, 0, 1])
def test_run_logger_statistics_match_reference(run, capsys):
    msgs = []
    for mod in (logger, ref_logger):
        rl = mod.RunLogger(runs=2)
        rl.add_result(0, (0.9, 0.7, 0.6))
        rl.add_result(0, (0.95, 0.8, 0.75))
        rl.add_result(1, (0.9, 0.85, 0.7))
        msgs.append(rl.print_statistics(run))
    assert msgs[0] == msgs[1]
    out = capsys.readouterr().out.splitlines()
    assert out == [msgs[0], msgs[1]]
    if run is None:
        assert "test" in msgs[0]


def test_run_logger_best_of_run():
    rl = logger.RunLogger(runs=2)
    rl.add_result(0, (0.9, 0.7, 0.6))
    rl.add_result(0, (0.95, 0.8, 0.75))
    val, test = rl.best_of_run(0)
    assert val == 0.8 and test == 0.75


def test_metrics_writer(tmp_path):
    p = str(tmp_path / "m.jsonl")
    w = logger.MetricsWriter(p)
    w.write(epoch=1, loss=0.5)
    w.write(epoch=2, loss=0.25)
    w.close()
    lines = [json.loads(line) for line in open(p)]
    assert lines[1]["loss"] == 0.25 and "ts" in lines[0]
    assert [sorted(line) for line in lines] == [["epoch", "loss", "ts"]] * 2


def test_phase_timer():
    t = logger.PhaseTimer()
    with t.measure("work"):
        sum(range(1000))
    assert t.phases["work"] > 0
    assert t.rate("work", 100.0) > 0
    assert t.rate("missing", 100.0) == 0.0


def test_get_logger_is_the_ports(tmp_path):
    path = tmp_path / "run.log"
    log = logger.get_logger("ssrg_torch.test_logger", log_file=str(path))
    try:
        assert log.name == "ssrg_torch.test_logger" and log.level == logging.INFO
        assert logger.get_logger("ssrg_torch.test_logger") is log
        log.info("hello %d", 7)
        for h in log.handlers:
            h.flush()
        assert "INFO ssrg_torch.test_logger: hello 7" in path.read_text()
    finally:
        for h in list(log.handlers):
            h.close()
            log.removeHandler(h)
    assert logger.get_logger.__defaults__[0] == "ssrg_torch"


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    with logger.device_trace(str(tmp_path / "trace"), device="cpu") as trace:
        a = torch.randn(64, 64)
        (a @ a).sum()
    assert trace.path == str(tmp_path / "trace" / "trace.json")
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert trace.profile.key_averages()
    top = trace.top_ops(3)
    assert len(top) == 3 and all(r["ms"] >= 0.0 and r["calls"] >= 1 for r in top)
    assert any(r["name"] == "aten::mm" for r in trace.top_ops(10))
    assert not any(r["name"] == logger.device_trace.ANNOTATION for r in trace.top_ops(100))
    busy = trace.busy_share()
    assert busy["window_ms"] > 0 and busy["busy_ms"] == 0.0 and busy["device_events"] == 0
    assert busy["lead_ms"] is None


def test_device_trace_on_cuda_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        logger.device_trace(str(tmp_path))


def test_device_trace_writes_nothing_when_the_region_raises(tmp_path):
    with pytest.raises(ZeroDivisionError):
        with logger.device_trace(str(tmp_path), device="cpu"):
            1 / 0
    assert not (tmp_path / "trace.json").exists()


# -- spans and counters (the port's own; the reference has none) -------------

def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture
def spans():
    logger.reset_spans()
    yield logger
    logger.reset_spans()


def test_spans_nest_and_keep_their_self_time(spans):
    with logger.span("outer") as outer:
        with logger.span("inner") as inner:
            with logger.span("leaf") as leaf:
                sum(range(1000))
            sum(range(1000))
        with logger.span("inner") as inner2:
            pass
    totals = spans.span_totals()
    assert {k: v["calls"] for k, v in totals.items()} == {"outer": 1, "inner": 2, "leaf": 1}
    assert totals["outer"]["seconds"] == outer.seconds
    # self time: the duration less the children's, not the grandchildren's
    assert totals["outer"]["self_seconds"] == pytest.approx(
        outer.seconds - inner.seconds - inner2.seconds, abs=1e-12)
    assert totals["inner"]["self_seconds"] == pytest.approx(
        inner.seconds - leaf.seconds + inner2.seconds, abs=1e-12)
    assert totals["leaf"]["self_seconds"] == leaf.seconds > 0
    assert outer.seconds >= inner.seconds + inner2.seconds


def test_a_span_that_raises_still_closes(spans):
    with pytest.raises(ValueError):
        with logger.span("fails"):
            raise ValueError("x")
    with logger.span("after"):
        pass
    totals = spans.span_totals()
    assert totals["fails"]["calls"] == 1
    assert totals["after"]["self_seconds"] == totals["after"]["seconds"]


def test_counts_go_to_the_totals_and_to_the_innermost_record(spans):
    spans.count("outside", 2)
    with cpu_profile():
        with logger.span("outer"):
            spans.count("rows", 3)
            with logger.span("inner"):
                spans.count("rows", 4)
                spans.count("edges", 5)
    spans.count("outside", 1)
    assert spans.counter_totals() == {"outside": 3, "rows": 7, "edges": 5}
    recs = {r["name"]: r for r in spans.span_records()}
    assert recs["outer"]["counts"] == {"rows": 3}
    assert recs["inner"]["counts"] == {"rows": 4, "edges": 5}
    assert recs["inner"]["parent"] == "outer" and recs["outer"]["parent"] is None


def test_no_record_and_no_annotation_without_a_profiler(spans, monkeypatch):
    import torch.autograd.profiler as autograd_profiler

    class Refused:
        def __init__(self, *a, **k):
            raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(autograd_profiler, "record_function", Refused)
    with logger.span("quiet", device=True):
        spans.count("n", 1)
    assert spans.span_records() == []
    assert spans.span_totals()["quiet"]["calls"] == 1


def test_records_under_a_cpu_profiler(spans):
    with cpu_profile():
        with logger.span("a"):
            with logger.span("b", device=True):
                pass
    recs = spans.span_records()
    assert [(r["name"], r["parent"]) for r in recs] == [("a", None), ("b", "a")]
    main = threading.get_ident()
    for r in recs:
        assert r["thread"] == main and r["start_us"] < r["end_us"]
        # no CUDA work ran: a device span has no events to time
        assert r["device_ms"] is None
    assert recs[0]["start_us"] <= recs[1]["start_us"] and recs[1]["end_us"] <= recs[0]["end_us"]


def test_records_keep_the_thread_they_ran_on(spans):
    """The SpMM's backward runs on the autograd engine's thread on the card,
    with the caller's profiler; here a second thread runs a profiled hybrid
    SpMM forward and backward while the main thread holds a span open: its
    records name that thread, and the main thread's span is no parent of
    theirs."""
    adj = hybrid_pair(400)
    got = {}

    def worker():
        x = torch.randn(400, 8, requires_grad=True)
        with cpu_profile():
            with logger.span("step.backward"):
                adj.spmm(x).sum().backward()
        got["thread"] = threading.get_ident()

    with logger.span("main.open"):
        t = threading.Thread(target=worker)
        t.start()
        t.join()
    recs = spans.span_records()
    assert [r["name"] for r in recs if r["name"] == "spmm"] == ["spmm", "spmm"]
    assert all(r["thread"] == got["thread"] != threading.get_ident() for r in recs)
    assert {r["parent"] for r in recs if r["name"] == "spmm"} == {"step.backward"}
    assert not any(r["name"] == "main.open" for r in recs)
    totals = spans.span_totals()
    assert totals["spmm"]["calls"] == 2 and totals["main.open"]["calls"] == 1


def test_records_lie_on_the_trace_clock(spans, tmp_path):
    """Each record's start and end, stamped just outside its annotation,
    against the annotation the exported Chrome trace holds: the record holds
    it, a few microseconds wider (5 us of slack for the two clocks), and the
    median gap at either end is under 20 us."""
    with logger.device_trace(str(tmp_path), device="cpu"):
        for _ in range(50):
            with logger.span("probe.outer"):
                with logger.span("probe.inner"):
                    torch.ones(8).sum()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    recs = spans.span_records()
    assert len(recs) == 100
    starts, ends = [], []
    for name in ("probe.outer", "probe.inner"):
        ann = sorted((e for e in events if e.get("cat") == "user_annotation"
                      and e["name"] == name), key=lambda e: e["ts"])
        mine = [r for r in recs if r["name"] == name]
        assert len(ann) == len(mine) == 50
        for r, e in zip(mine, ann):
            starts.append(e["ts"] - r["start_us"])
            ends.append(r["end_us"] - (e["ts"] + e["dur"]))
    assert min(starts) > -5 and min(ends) > -5
    assert statistics.median(starts) < 20 and statistics.median(ends) < 20


def hybrid_pair(n: int):
    """The hybrid pack of a normalized ring whose node 0 is a hub joined to
    every node (its overflow fills the tail), under autograd."""
    import scipy.sparse as sp

    from ssrg_torch.ops.normalize import sym_norm

    ring = np.arange(n)
    rows = np.concatenate([ring, np.zeros(n - 2, np.int64)])
    cols = np.concatenate([(ring + 1) % n, np.arange(2, n)])
    a = sp.coo_matrix((np.ones(rows.size, np.float32), (rows, cols)), shape=(n, n))
    adj = sparse.differentiable_adjacency(sym_norm((a + a.T).tocsr(), 0.5), "hybrid",
                                          device="cpu")
    assert adj.symmetric and adj.fwd.tail.nnz > 0
    return adj


def test_the_hybrid_spmm_never_waits_for_the_device(spans, monkeypatch):
    adj = hybrid_pair(300)

    def refused(*a, **k):
        raise AssertionError("host sync")

    for name in ("item", "tolist"):
        monkeypatch.setattr(torch.Tensor, name, refused)
    monkeypatch.setattr(torch.cuda, "synchronize", refused)
    x = torch.randn(300, 4, requires_grad=True)
    with cpu_profile():
        adj.spmm(x).sum().backward()
    adj.spmm(x.detach())
    assert x.grad is not None
    assert spans.counter_totals()["spmm.tail_nnz"] == 3 * adj.fwd.tail.nnz


def test_the_hybrid_pack_counts_its_real_entries():
    adj = hybrid_pair(300).fwd
    ell_real = int((adj.ell.vals != 0).sum())
    assert adj.ell.nnz == ell_real
    assert adj.tail.nnz == int((adj.tail.val != 0).sum()) < adj.tail.nnz_padded
    assert adj.tail.chunks == 1
    moved = sparse._host_bytes(adj)
    assert moved == sum(t.nbytes for t in (adj.ell.cols, adj.ell.vals, adj.tail.row,
                                           adj.tail.col, adj.tail.val))


def test_a_gcn_epoch_gives_nine_spmm_spans(spans):
    from ssrg_torch.train.baseline_task import BaselineTask
    from ssrg_torch.train.common import create_train_state

    ds = planetoid_like(num_node=500, num_classes=4, num_features=16, seed=0)
    task = BaselineTask(ds, "gcn", TrainingConfig(lr=0.01, spmm_engine="hybrid"),
                        hidden_dim=16, num_layers=3, run=False, device="cpu")
    assert task.prepare_seconds == spans.span_totals()["prepare"]["seconds"]
    state = create_train_state(task.module, torch.Generator().manual_seed(0), 0.01, 0.0)
    spans.reset_spans()
    with cpu_profile():
        task.train_epoch(state)
        task.evaluate(state)
    recs = spans.span_records()
    names = [r["name"] for r in recs]
    pack = task.adj_op.fwd
    assert pack.tail.nnz > 0 and task.adj_op.symmetric
    assert names.count("spmm") == names.count("spmm.tail") == names.count("spmm.ell") == 9
    assert [r["parent"] for r in recs if r["name"] == "spmm"] == \
        ["step.forward"] * 3 + ["step.backward"] * 3 + ["eval.forward"] * 3
    counts = spans.counter_totals()
    assert counts["spmm.tail_nnz"] == 9 * pack.tail.nnz
    assert counts["spmm.ell_nnz"] == 9 * pack.ell.nnz
    assert counts["spmm.tail_chunks"] == 9 * pack.tail.chunks
    # the plain version on the CPU: three torch operations a chunk
    assert counts["spmm.tail_launches"] == 9 * 3 * pack.tail.chunks
    assert sum(r["counts"].get("spmm.tail_nnz", 0) for r in recs) == 9 * pack.tail.nnz
    top = [(r["name"], r["parent"]) for r in recs if r["name"] in
           ("epoch.train", "step.forward", "step.backward", "step.optimizer",
            "epoch.evaluate", "eval.forward")]
    assert top == [("epoch.train", None), ("step.forward", "epoch.train"),
                   ("step.backward", "epoch.train"), ("step.optimizer", "epoch.train"),
                   ("epoch.evaluate", None), ("eval.forward", "epoch.evaluate")]


def gamlp_task(num_node=300, **tc):
    from ssrg_torch.models.zoo import load_model
    from ssrg_torch.train import NodeClassification

    ds = planetoid_like(num_node=num_node, num_classes=3, num_features=8, seed=2)
    cfg = ModelConfig(model_name="gamlp", prop_steps=2)
    return ds, NodeClassification(ds, load_model(cfg, ds.num_features, ds.num_classes), cfg,
                                  TrainingConfig(num_epochs=1, lr=0.01, **tc), device="cpu")


def test_a_gamlp_epoch_gives_the_step_and_epoch_tree(spans):
    _, task = gamlp_task()
    state = task.state
    spans.reset_spans()
    with cpu_profile():
        task.train_epoch(state, np.random.default_rng(0))
        task.evaluate(state)
    tree = [(r["name"], r["parent"]) for r in spans.span_records()]
    assert tree == [("epoch.train", None), ("step.forward", "epoch.train"),
                    ("step.backward", "epoch.train"), ("step.optimizer", "epoch.train"),
                    ("epoch.evaluate", None), ("eval.forward", "epoch.evaluate"),
                    ("eval.forward", "epoch.evaluate")]


@pytest.mark.parametrize("engine", ["hybrid", "dense"])
def test_prepare_gives_its_children_in_order(spans, engine):
    with cpu_profile():
        ds, task = gamlp_task(spmm_engine=engine)
    recs = spans.span_records()
    children = [r["name"] for r in recs if r["parent"] == "prepare"]
    assert children == ["prepare.adjacency", "prepare.normalize", "prepare.pack",
                        "prepare.copy", "prepare.hops"]
    hops = [r["name"] for r in recs if r["parent"] == "prepare.hops"]
    assert hops == (["spmm"] * 2 if engine == "hybrid" else [])
    whole = next(r for r in recs if r["name"] == "prepare")
    assert whole["start_us"] <= recs[1]["start_us"]
    assert task.prepared.preprocess_seconds == spans.span_totals()["prepare"]["seconds"]
    # the copy to the host moves nothing, and counts nothing
    assert "prepare.h2d_bytes" not in spans.counter_totals()


def test_serving_spans_and_rows(spans):
    from ssrg_torch.serve import Predictor
    from ssrg_torch.models.zoo import load_model

    ds = planetoid_like(num_node=200, num_classes=3, num_features=8, seed=3)
    cfg = ModelConfig(model_name="sgc", prop_steps=2)
    pred = Predictor(ds, load_model(cfg, ds.num_features, ds.num_classes), cfg, device="cpu")
    spans.reset_spans()
    with cpu_profile():
        pred.logits(np.arange(17))
    assert [(r["name"], r["parent"]) for r in spans.span_records()] == [
        ("serve.request", None), ("serve.ids", "serve.request"),
        ("serve.forward", "serve.request")]
    assert spans.counter_totals() == {"serve.rows": 17}


def test_phase_timer_phases_are_spans(spans):
    t = logger.PhaseTimer()
    with t.measure("build"):
        with t.measure("reorder"):
            sum(range(100))
    totals = spans.span_totals()
    assert t.phases == {"build": totals["build"]["seconds"],
                        "reorder": totals["reorder"]["seconds"]}
    assert totals["build"]["self_seconds"] == pytest.approx(
        t.phases["build"] - t.phases["reorder"], abs=1e-12)


def test_threads_lose_no_span_or_count(spans):
    """More threads than cores, switching every microsecond: every span
    and count of every thread is in the totals."""
    import os
    import sys

    threads, each = 2 * (os.cpu_count() or 4), 500
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(each):
                with logger.span("stress.outer"):
                    with logger.span("stress.inner"):
                        spans.count("stress.n", 1)

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    totals = spans.span_totals()
    assert totals["stress.outer"]["calls"] == totals["stress.inner"]["calls"] == threads * each
    assert spans.counter_totals()["stress.n"] == threads * each
    assert totals["stress.outer"]["self_seconds"] <= totals["stress.outer"]["seconds"]
