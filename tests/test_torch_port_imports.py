"""The PyTorch port stands alone: no file of ``ssrg_torch``, no
``examples/torch_*.py``, no ``chip_smoke.py`` and neither ``tools/card.py``
nor ``tools/kernels.py`` imports jax, flax, optax, msgpack or ``ssrg_tpu``;
none of them, nor a source under ``ssrg_torch/csrc``, names a path under the
JAX package's ``native/`` directory; importing the port pulls none of them
in; and the scripts fail without a CUDA card (``tools/kernels.py`` for each
kernel of its table), ``chip_smoke.py`` also without the rest of the
repository."""

import ast
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "ssrg_tpu")
PACKAGE_FILES = sorted((ROOT / "ssrg_torch").rglob("*.py"))
EXAMPLE_FILES = sorted((ROOT / "examples").glob("torch_*.py"))
PORT_FILES = PACKAGE_FILES + EXAMPLE_FILES + [ROOT / "chip_smoke.py",
                                              ROOT / "tools" / "card.py",
                                              ROOT / "tools" / "kernels.py"]
SOURCES = sorted((ROOT / "ssrg_torch" / "csrc").iterdir())


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_nothing_of_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("path", PORT_FILES + SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_names_no_path_under_native(path):
    """The port builds its own host library from ``ssrg_torch/csrc``; it
    never reads the reference's ``native/`` directory (a path into it, or
    the directory's name joined into a path)."""
    hits = re.findall(r"\bnative/|join\(.*[\"']native[\"']", path.read_text())
    assert not hits, f"{path.relative_to(ROOT)} names {hits}"


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PACKAGE_FILES
    )
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    proc = _run(["-c", code], ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")


def test_chip_smoke_fails_without_a_card(no_cuda):
    proc = _run(["chip_smoke.py"], ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.mark.parametrize("kernel", ["ell", "coo", "banded", "rest", "gat"])
def test_kernels_tool_fails_without_a_card(no_cuda, kernel):
    proc = _run(["tools/kernels.py", "--kernel", kernel], ROOT)
    assert proc.returncode == 2, proc.stderr[-2000:]
    assert not proc.stdout


@pytest.mark.parametrize("kernel", ["ell", "coo", "banded", "rest", "gat"])
def test_kernels_tool_variants_set_constants_of_their_source(kernel, monkeypatch):
    """Each variant of ``tools/kernels.py``'s table, the source's own first,
    sets constants its kernel's source declares once each: a constant
    renamed or removed in the source fails here, before a card builds it."""
    import importlib

    from ssrg_torch.ops import _nvcc

    monkeypatch.syspath_prepend(str(ROOT / "tools"))
    kernels = importlib.import_module("kernels")
    entry = kernels.KERNELS[kernel]
    name = importlib.import_module(f"ssrg_torch.ops.{entry.module}").NAME
    text = pathlib.Path(_nvcc.source(name)).read_text()
    assert entry.variants[0] == ("source", {})
    for variant, changes in entry.variants:
        changed = kernels.card.variant_source(text, changes, name)
        assert all(f"constexpr int {c} = {v};" in changed for c, v in changes.items()), variant


def test_chip_smoke_fails_without_the_repository(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(["chip_smoke.py"], tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
