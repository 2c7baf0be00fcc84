"""The port's logger (``ssrg_torch.logger``) against ``ssrg_tpu.logger``:
the cases of ``tests/test_aux.py`` for ``RunLogger``, ``MetricsWriter`` and
``PhaseTimer`` on both packages, and ``device_trace`` on ``torch.profiler``
(on the CPU here)."""

import json
import logging

import pytest
import torch

from ssrg_tpu import logger as ref_logger

from ssrg_torch import logger


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
