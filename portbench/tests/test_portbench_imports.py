"""The harness loads nothing of JAX: a subprocess imports the harness,
every driver (the planned cells' too), program, reference and metric
reader, and no loaded module's top-level name, compared whole, is JAX's, a
JAX library's or the JAX package's. In a directory that holds only BENCHMARK.json and portbench/, a
run exits with an error and prints no result."""

import os
import shutil
import subprocess
import sys

from portbench import manifest

SCRIPT = """
import os, sys
sys.path.insert(0, {root!r})
from portbench import manifest, run, control, tracing, work, graphs
bench = manifest.load()
for w in bench["workloads"]:
    cell = manifest.cell(w["name"])
    manifest.driver(cell.traffic["driver"])
    manifest.program(cell.config["model"])
    manifest.reference(cell.config["model"])
for m in bench["per_layer"]:
    manifest.reader(m["name"])
for f in os.listdir(os.path.join(manifest.PACKAGE, "drivers")):
    if f.endswith(".py"):
        manifest.driver(f[:-3])
import ssrg_torch.train.baseline_task, ssrg_torch.train.node_classification, ssrg_torch.serve
print(" ".join(run.forbidden_modules()))
print(" ".join(sorted({{n.split(".")[0] for n in sys.modules}})))
"""


def test_no_jax_module_is_loaded():
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=manifest.ROOT)],
                         capture_output=True, text=True, timeout=240,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    forbidden, loaded = out.stdout.splitlines()[-2:]
    assert forbidden == ""
    assert not {"jax", "jaxlib", "flax", "optax", "ssrg_tpu"} & set(loaded.split())
    assert "ssrg_torch" in loaded.split()


def test_a_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(manifest.PACKAGE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "gamlp-arxiv-train",
                          "--seed", str(2**31 + 9), "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=240)
    assert out.returncode != 0
    assert out.stdout == ""


def test_an_unknown_workload_is_refused():
    out = subprocess.run([sys.executable, os.path.join(manifest.PACKAGE, "run.py"),
                          "--workload", "no-such-cell", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=240)
    assert out.returncode == 2 and out.stdout == ""
