"""The PyTorch port's examples (``examples/torch_*.py``) run end to end on
the CPU, each in a fresh interpreter that imports no JAX: node
classification, serving from a checkpoint, and SPMD training as a world of
one ``gloo`` rank (no ``torchrun``)."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCORE = r"best val ([0-9.]+), best test ([0-9.]+)"


def _run(script: str, *args: str, cwd: pathlib.Path) -> str:
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTHONPATH", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / script), *args,
                           "--device", "cpu"], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "jax" not in proc.stderr.lower()
    return proc.stdout


@pytest.mark.parametrize("model", ["sgc", "gamlp"])
def test_train_node_classification_example(model, tmp_path):
    out = _run("torch_train_node_classification.py", "--model", model, "--nodes", "400",
               "--epochs", "30", cwd=tmp_path)
    m = re.search(rf"{model}: {SCORE}", out)
    assert m, out
    assert float(m.group(2)) > 0.6


def test_serve_inference_example(tmp_path):
    out = _run("torch_serve_inference.py", "--nodes", "400", "--epochs", "30", cwd=tmp_path)
    assert re.search(r"trained: best val [0-9.]+, test [0-9.]+", out), out
    assert "checkpoint metadata: {" in out
    labels = re.search(r"labels for \[[0-9, ]+\]: \[([0-9, ]+)\]", out)
    assert labels and len(labels.group(1).split(",")) == 10, out
    proba = re.search(r"class probabilities for node [0-9]+: \[([0-9., e-]+)\]", out)
    assert proba, out
    values = [float(v) for v in proba.group(1).split(",")]
    assert len(values) == 5 and abs(sum(values) - 1.0) < 5e-3


def test_distributed_training_example_as_a_world_of_one(tmp_path):
    out = _run("torch_distributed_training.py", "--nodes", "600", "--steps", "10",
               cwd=tmp_path)
    assert "1-shard SPMD training (tiled/halo): 10 epochs" in out, out
    m = re.search(SCORE, out)
    assert m and float(m.group(2)) > 0.6, out
