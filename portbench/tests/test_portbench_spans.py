"""The readers of the program's spans and counters (``portbench/spans.py``
and the seven metrics that use it) on hand-made captures and records: the
tail's CUDA-event time and entry share, the head's idle time split by the
main thread's innermost span (the four parts add up to the idle time), the
host graph build from the span totals, and nothing read where the spans are
missing, as on a program that keeps none."""

import threading

import pytest

from portbench import manifest, spans
from portbench.tracing import TraceView

MAIN = threading.main_thread().ident
OTHER = MAIN + 1
IDLE = ["idle_in_step_ms.head", "idle_in_optimizer_ms.head", "idle_in_eval_ms.head",
        "idle_outside_ms.head"]
NEW = ["tail_device_ms.train", "tail_nnz_share.train", *IDLE, "setup_graph_s"]


def rec(name, start, end, thread=MAIN, counts=None, device_ms=None, parent=None):
    return {"name": name, "parent": parent, "thread": thread, "counts": counts or {},
            "start_us": float(start), "end_us": float(end), "device_ms": device_ms}


def view(busy, calls=2):
    """A capture whose device ran ``busy`` (start, end) intervals, in us."""
    device = [("kernel", f"k{i}", float(a), float(b - a)) for i, (a, b) in enumerate(busy)]
    return TraceView(calls, 1.0, 0.5, device, [])


def epochs():
    """Two epochs' spans on the main thread, a backward SpMM on another
    thread, and a span of an earlier capture."""
    return [
        rec("prepare", -500, -400),
        rec("epoch.train", 0, 50), rec("step.forward", 5, 20), rec("step.backward", 20, 35),
        rec("spmm", 21, 34, thread=OTHER), rec("step.optimizer", 35, 48),
        rec("epoch.evaluate", 55, 80), rec("eval.forward", 56, 70),
        rec("eval.forward", 71, 79), rec("epoch.train", 90, 100),
    ]


BUSY = [(2, 10), (22, 30), (40, 45), (60, 65), (72, 78), (92, 99)]


@pytest.fixture
def program(monkeypatch):
    """Hand the readers ``records`` and ``totals`` in place of the
    program's."""
    kept = {"records": [], "totals": {}}
    monkeypatch.setattr(spans, "records", lambda: kept["records"])
    monkeypatch.setattr(spans, "totals", lambda: kept["totals"])
    return kept


def read(name, v, info=None):
    return manifest.reader(name).read(v, info or {})


def test_the_idle_time_is_split_by_the_innermost_span(program):
    program["records"] = epochs()
    v = view(BUSY)
    got = {name: read(name, v) for name in IDLE}
    # by hand: step 2 + 10 + 2 + 5 + 2 + 2 + 1, optimizer 5 + 3, evaluate
    # 1 + 4 + 5 + 1 + 1 + 1 + 1, outside 5 + 10 (us, over 2 epochs)
    assert got == pytest.approx({"idle_in_step_ms.head": 24e-3 / 2,
                                 "idle_in_optimizer_ms.head": 8e-3 / 2,
                                 "idle_in_eval_ms.head": 14e-3 / 2,
                                 "idle_outside_ms.head": 15e-3 / 2})
    # the four add up to the idle time between the first span's start and
    # the last one's end
    busy = sum(b - a for a, b in BUSY)
    assert sum(got.values()) == pytest.approx((100 - busy) * 1e-3 / 2)


def test_the_idle_split_adds_up_on_ragged_captures(program):
    """Device events that overlap, start before the first span or end after
    the last, and spans that end where the next starts."""
    program["records"] = [rec("epoch.train", 10, 40), rec("step.forward", 10, 20),
                          rec("step.optimizer", 20, 40), rec("epoch.evaluate", 40, 60)]
    busy = [(0, 12), (11, 15), (30, 31), (30.5, 33), (59, 70)]
    v = view(busy, calls=1)
    split = spans.idle_by_span(v, {"a": ("epoch.train", "step.forward"),
                                   "b": ("step.optimizer",), "c": ("epoch.evaluate",)})
    assert split == pytest.approx({"a": 5.0, "b": 17.0, "c": 19.0, None: 0.0})
    assert sum(read(name, v) for name in IDLE) == pytest.approx(41e-3)


def test_the_tail_device_time_and_entry_share(program):
    program["records"] = [
        rec("spmm", 0, 10, counts={"spmm.ell_nnz": 90, "spmm.tail_nnz": 10,
                                   "spmm.tail_chunks": 1}),
        rec("spmm.ell", 1, 5, device_ms=1.5), rec("spmm.tail", 5, 9, device_ms=2.0),
        rec("spmm", 20, 30, thread=OTHER, counts={"spmm.ell_nnz": 90, "spmm.tail_nnz": 10}),
        rec("spmm.tail", 25, 29, thread=OTHER, device_ms=3.0),
        rec("spmm.tail", -90, -80, device_ms=100.0),      # an earlier capture's
    ]
    v = view([(1, 29)], calls=1)
    assert read("tail_device_ms.train", v) == pytest.approx(5.0)
    assert read("tail_nnz_share.train", v) == pytest.approx(10.0)
    # a tail span whose events were not both recorded: nothing to read
    program["records"].append(rec("spmm.tail", 12, 13, device_ms=None))
    assert read("tail_device_ms.train", v) is None


def test_setup_graph_s_sums_only_its_four_spans(program):
    program["totals"] = {name: {"calls": 1, "seconds": s, "self_seconds": s} for name, s in
                         [("prepare", 100.0), ("prepare.adjacency", 16.0),
                          ("prepare.normalize", 7.0), ("prepare.symmetry_test", 8.0),
                          ("prepare.pack", 1.0), ("prepare.copy", 0.5),
                          ("prepare.hops", 2.0), ("step.forward", 9.0)]}
    assert read("setup_graph_s", view(BUSY)) == pytest.approx(32.0)
    del program["totals"]["prepare.symmetry_test"]
    assert read("setup_graph_s", view(BUSY)) == pytest.approx(24.0)
    # no traced capture: nothing to read
    assert read("setup_graph_s", view(BUSY, calls=0)) is None


@pytest.mark.parametrize("name", NEW)
def test_each_reader_finds_nothing_without_its_spans(program, name):
    program["records"] = [rec("other", 0, 100)]
    program["totals"] = {"prepare.copy": {"calls": 1, "seconds": 1.0, "self_seconds": 1.0}}
    assert read(name, view(BUSY)) is None
    program["records"] = epochs()
    program["totals"] = {}
    # spans but no device events (a capture on the CPU)
    if name != "setup_graph_s":
        assert read(name, view([])) is None


@pytest.mark.parametrize("name", NEW)
def test_each_reader_finds_nothing_on_a_program_without_spans(monkeypatch, name):
    """A program whose logger has no spans (as before it kept any)."""
    monkeypatch.setattr(spans, "_logger", lambda: object())
    assert spans.records() is None and spans.totals() is None
    assert read(name, view(BUSY)) is None


def test_the_capture_keeps_the_records_that_overlap_its_device_events(program):
    program["records"] = epochs()
    kept = spans.capture_records(view(BUSY))
    assert [r["name"] for r in kept][0] == "epoch.train"
    assert "prepare" not in [r["name"] for r in kept] and len(kept) == 9
    assert spans.capture_records(view([])) == []


def test_the_program_records_its_spans_for_the_readers():
    """The readers' source, end to end on the CPU: the program's spans under
    a profiler reach ``spans.records``, with the fields the readers use."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ssrg_torch import logger

    logger.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        with logger.span("epoch.train"):
            logger.count("spmm.tail_nnz", 3)
            torch.ones(4).sum()
    got = spans.records()
    assert [r["name"] for r in got] == ["epoch.train"]
    assert set(got[0]) >= {"name", "parent", "thread", "counts", "start_us", "end_us",
                           "device_ms"}
    assert got[0]["thread"] == MAIN and got[0]["counts"] == {"spmm.tail_nnz": 3}
    assert spans.totals()["epoch.train"]["calls"] == 1
    logger.reset_spans()
