"""The benchmark's manifest, ``BENCHMARK.json`` at the checkout's root, and
what it names: a cell's configuration (``portbench/configs/<config>.json``),
its traffic (``portbench/traffic/<traffic>.json``, whose ``driver`` names
``portbench/drivers/<driver>.py``), its limits
(``portbench/limits/<cell>.json``) and its per-layer metrics' readers
(``portbench/metrics/<name>.py``, or the reader of the name's stem).
Everything is found by name: a cell, configuration, traffic mix or metric
is added by adding files and entries, never by editing code."""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "portbench")


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def read_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: str, name: str):
    """Import the file at ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: List[dict]   # the end-to-end metrics this cell reports
    per_layer: List[dict]    # the per-layer metrics read in its traced runs


def _applies(metric: dict, cell: str, reported: List[str]) -> bool:
    """A metric applies to the cells it lists; without a list, an
    end-to-end metric to every cell, a per-layer one to every cell that
    reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def cell(name: str, root: str = ROOT) -> Cell:
    """Resolve the cell ``name`` of the manifest under ``root``; raises
    ``KeyError`` for a name the manifest does not hold."""
    bench = load(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = read_json(os.path.join(root, conf["file"]))
    traffic = read_json(os.path.join(root, "portbench", "traffic", f"{entry['traffic']}.json"))
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, [])]
    reported = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name, int(entry["chips"]), entry["config"], config, entry["traffic"], traffic,
                e2e, per_layer)


def driver(name: str, root: str = ROOT):
    return load_module(os.path.join(root, "portbench", "drivers", f"{name}.py"),
                       f"portbench_driver_{name}")


def program(model: str, root: str = ROOT):
    return load_module(os.path.join(root, "portbench", "programs", f"{model}.py"),
                       f"portbench_program_{model}")


def reference(model: str, root: str = ROOT):
    return load_module(os.path.join(root, "portbench", "reference", f"{model}.py"),
                       f"portbench_reference_{model}")


def reader(metric: str, root: str = ROOT):
    """The reader of a per-layer metric: ``metrics/<name>.py``, or for a
    name with a suffix (``idle_share.train``) the reader of its stem
    (``metrics/idle_share.py``), which serves every suffix."""
    folder = os.path.join(root, "portbench", "metrics")
    path = os.path.join(folder, f"{metric}.py")
    if not os.path.exists(path):
        path = os.path.join(folder, f"{metric.split('.')[0]}.py")
    name = os.path.basename(path)[:-3]
    return load_module(path, f"portbench_metric_{name.replace('.', '_').replace('-', '_')}")
