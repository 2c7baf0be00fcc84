"""BENCHMARK.json against the manifest's rules: names and units in the
allowed characters, every metric's ``moves`` reported by the cells it
lists, every configuration used, every file that a name leads to present."""

import json
import os
import re

import pytest

from portbench import manifest

BENCH = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
E2E = {m["name"]: m for m in BENCH["end_to_end"]}


def reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [w["name"] for w in BENCH["workloads"]])


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) < 64 * 1024
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_plain(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metrics_fields():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in E2E and "workloads" not in E2E["setup_s"]
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 0 < len(m["layer"]) <= 200 and "\n" not in m["layer"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_moves_is_reported_where_listed():
    for m in BENCH["per_layer"]:
        assert m["moves"] in E2E
        for cell in m["workloads"]:
            assert reports(E2E[m["moves"]], cell), (m["name"], cell)


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = [m for m in BENCH["end_to_end"] if reports(m, w["name"])]
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200


def test_configs_are_used_and_their_files_exist():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/") and os.path.exists(
            os.path.join(manifest.ROOT, c["file"]))
        assert manifest.read_json(os.path.join(manifest.ROOT, c["file"]))["reduced"] == c["reduced"]


def test_every_name_leads_to_its_files():
    for w in BENCH["workloads"]:
        cell = manifest.cell(w["name"])
        assert os.path.exists(os.path.join(manifest.PACKAGE, "drivers",
                                           f"{cell.traffic['driver']}.py"))
        assert os.path.exists(os.path.join(manifest.PACKAGE, "limits", f"{w['name']}.json"))
        assert os.path.exists(os.path.join(manifest.PACKAGE, "programs",
                                           f"{cell.config['model']}.py"))
        assert os.path.exists(os.path.join(manifest.PACKAGE, "reference",
                                           f"{cell.config['model']}.py"))
    for m in BENCH["per_layer"]:
        assert callable(manifest.reader(m["name"]).read)


def test_planned_cells_name_their_files():
    from portbench.tests import small

    for name in small.planned():
        entries = manifest.read_json(os.path.join(small.PLANNED, f"{name}.json"))
        assert entries["workload"]["name"] == name
        assert entries["workload"]["name"] not in [w["name"] for w in BENCH["workloads"]]
        assert os.path.exists(os.path.join(manifest.PACKAGE, "traffic",
                                           f"{entries['workload']['traffic']}.json"))
        assert os.path.exists(os.path.join(manifest.PACKAGE, "limits", f"{name}.json"))
        for m in entries["per_layer"]:
            assert callable(manifest.reader(m["name"]).read)


def test_the_full_check_fits():
    cells = 24
    run = BENCH["run_seconds"]
    assert (2 + 14 * cells) * (run + 60) + cells * 2 * 90 + 1200 <= 43200
