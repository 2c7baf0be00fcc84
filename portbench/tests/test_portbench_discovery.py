"""A workload, a configuration, a traffic mix, its limits and a per-layer
metric written into a copy of the benchmark are found by name, with no
code edited."""

import json
import os
import pathlib

import torch

from portbench import manifest, run
from portbench.tests import small
from portbench.tracing import TraceView


def test_new_cell_config_and_metric_are_found(tmp_path):
    # the planned prepare cell's metric, prepare_s, is the one the new cell reports
    root = pathlib.Path(small.with_planned(tmp_path))
    bench = manifest.load(str(root))
    cfg = small.config("gamlp-arxiv-train")
    cfg["name"] = "gamlp-tiny"
    (root / "portbench" / "configs" / "gamlp-tiny.json").write_text(json.dumps(cfg))
    (root / "portbench" / "traffic" / "prepare_twice.json").write_text(json.dumps(
        {"driver": "prepare_loop", "warmup_calls": 1, "kept_calls": 1, "capture_calls": 1}))
    (root / "portbench" / "limits" / "gamlp-tiny-prepare.json").write_text(
        json.dumps({"hop_gap": 1e-4}))
    (root / "portbench" / "metrics" / "calls_seen.prepare.py").write_text(
        "def read(view, info):\n    return float(view.calls)\n")
    bench["configs"].append({"name": "gamlp-tiny", "source": "https://example.org",
                             "file": "portbench/configs/gamlp-tiny.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "gamlp-tiny-prepare", "config": "gamlp-tiny",
                               "traffic": "prepare_twice", "chips": 1, "why": "a test"})
    next(m for m in bench["end_to_end"] if m["name"] == "prepare_s")["workloads"].append(
        "gamlp-tiny-prepare")
    bench["per_layer"].append({"name": "calls_seen.prepare", "unit": "calls",
                               "better": "higher", "source": "device_trace", "layer": "test",
                               "moves": "prepare_s", "workloads": ["gamlp-tiny-prepare"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = manifest.cell("gamlp-tiny-prepare", str(root))
    assert cell.config["dataset"]["num_nodes"] == small.NODES
    assert sorted(m["name"] for m in cell.end_to_end) == ["prepare_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["calls_seen.prepare"]
    reader = manifest.reader("calls_seen.prepare", str(root))
    assert reader.read(TraceView(3, 1.0, 0.5, [], []), {}) == 3.0

    cell, outcome = run.execute("gamlp-tiny-prepare", 5, 0.2, False, torch.device("cpu"),
                                root=str(root))
    assert outcome.correct and outcome.attempted >= 1
    line = run.result_line(cell, outcome, torch.device("cpu"))
    assert set(line["metrics"]) == {"prepare_s", "setup_s"}
    assert list(line)[-1] == "checks"
    assert os.path.exists(root / "portbench" / "metrics" / "calls_seen.prepare.py")
