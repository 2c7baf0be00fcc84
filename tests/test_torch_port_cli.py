"""The port's command line (``ssrg_torch/cli.py``) against ``ssrg_tpu/cli.py``,
on the CPU.

Every test of ``tests/test_cli.py`` runs here against the port's ``main``
with ``--device cpu``. The multi-rank ``spmd`` runs are ``torchrun``-style
worlds of ``gloo`` processes (``python -m ssrg_torch.cli spmd ...`` with
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR`` and a free
``MASTER_PORT``), so that no process group is left in the test process; the
reference runs in this process on the conftest's eight fake devices.

Parity, each with its tolerance:

- flags: the two parsers turn the same argv, at the defaults and with every
  flag set, into equal namespaces (``fn`` and the port's ``--device`` apart):
  exact;
- configs: the ``ModelConfig`` and ``TrainingConfig`` that ``train`` builds
  equal the reference's field by field: exact;
- ``sparsify --synthetic``: the same directory name and, file by file, the
  same tensors: exact;
- checkpoints both ways: each package's ``predict`` on a checkpoint either
  package's ``train`` wrote gives the reference ``Predictor``'s labels on every
  node whose top-two logit gap exceeds ``GAP`` (nearer ties may round either
  way in float32);
- accuracy: ``train``, ``link``, ``baseline`` and ``spmd`` on the same argv
  give best val and best test within ``ACC_TOL`` of the reference CLI's (the
  packages draw their initial weights and dropout masks differently).
"""

import argparse
import json
import os
import pathlib
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import ssrg_tpu.cli as ref_cli
import ssrg_torch.cli as port_cli
from ssrg_torch.cli import main

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
ACC_TOL = 0.06
GAP = 1e-4
WORLD_TIMEOUT_S = 110      # a world that hangs fails instead of stalling the suite
BEST = re.compile(r"Best val: ([0-9.]+), best test: ([0-9.]+)")
SPMD_BEST = re.compile(r"best val ([0-9.]+), best test ([0-9.]+)")
ALL_RUNS = re.compile(r"All runs: val ([0-9.]+) ± [0-9.]+, test ([0-9.]+)")
COMMANDS = ("train", "spmd", "sparsify", "augment", "baseline", "link", "gwnn",
            "predict", "autotune", "ooc", "bench")


# --- helpers ---------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_spmd_world(argv: list, world: int, cwd: pathlib.Path) -> list:
    """``ssrg_torch.cli spmd`` on ``world`` gloo ranks, one process each,
    joined through ``torchrun``'s variables. Returns each rank's
    ``(returncode, stdout)``."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "PYTHONPATH")}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2", WORLD_SIZE=str(world),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    procs = [subprocess.Popen([sys.executable, "-m", "ssrg_torch.cli", "spmd", *argv, *CPU],
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=cwd,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    outs, errors = [], []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=WORLD_TIMEOUT_S)
            outs.append((p.returncode, out))
            if p.returncode != 0:
                errors.append(f"rank {r} exited {p.returncode}:\n{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not errors, "\n".join(errors)
    return outs


def _best(pattern, out: str) -> tuple:
    m = pattern.search(out)
    assert m, out
    return float(m.group(1)), float(m.group(2))


def _both(capsys, argv: list) -> tuple:
    """The reference's and the port's stdout for ``argv`` (the port's with
    ``--device cpu``)."""
    assert ref_cli.main(argv) == 0
    ref_out = capsys.readouterr().out
    assert main(argv + CPU) == 0
    return ref_out, capsys.readouterr().out


def _assert_close(pattern, ref_out: str, port_out: str) -> None:
    ref, got = _best(pattern, ref_out), _best(pattern, port_out)
    assert abs(got[0] - ref[0]) <= ACC_TOL and abs(got[1] - ref[1]) <= ACC_TOL, (got, ref)


# --- the reference's tests, on the port ------------------------------------------

TRAIN_ARGV = ["train", "--synthetic", "--synthetic_nodes", "300",
              "--synthetic_features", "48", "--num_epochs", "30",
              "--model_name", "sgc", "--hidden_dim", "32", "--lr", "0.05"]
LINK_ARGV = ["link", "--synthetic_nodes", "300", "--synthetic_features", "32",
             "--num_pairs", "400", "--num_epochs", "30", "--model_name", "sgc",
             "--hidden_dim", "32", "--lr", "0.05"]
BASELINE_ARGV = ["baseline", "--synthetic", "--synthetic_nodes", "250",
                 "--synthetic_features", "32", "--model_name", "gcn",
                 "--hidden_dim", "16", "--num_epochs", "20", "--lr", "0.05",
                 "--runs", "1"]
# the accuracy comparison's baseline run: at 250 nodes the seven classes' train
# split leaves 36 validation nodes, too few for best-val selection to be stable
BASELINE_ACC_ARGV = ["baseline", "--synthetic", "--synthetic_nodes", "800",
                     "--synthetic_features", "32", "--model_name", "gcn",
                     "--hidden_dim", "16", "--num_epochs", "30", "--lr", "0.05",
                     "--runs", "1"]
# the reference test's 4 x 2 mesh of eight devices becomes 2 x 2 on four ranks
SPMD_ARGV = ["--synthetic", "--synthetic_nodes", "256",
             "--synthetic_classes", "4", "--synthetic_features", "16",
             "--num_shards", "2", "--data_parallel", "2",
             "--local_engine", "tiled", "--comm", "halo", "--reorder", "cluster",
             "--hidden_dim", "16", "--prop_steps", "2", "--steps", "8",
             "--lr", "0.05"]
# the accuracy comparison's run: the same mesh, trained to a plateau
SPMD_ACC_ARGV = SPMD_ARGV[:-4] + ["--steps", "60", "--lr", "0.05"]


def test_cli_train_synthetic(capsys):
    assert main(TRAIN_ARGV + CPU) == 0
    out = capsys.readouterr().out
    assert "Best val:" in out and "best test:" in out


def test_cli_link_synthetic(capsys):
    assert main(LINK_ARGV + CPU) == 0
    assert "Best val:" in capsys.readouterr().out


def test_cli_gwnn_synthetic(tmp_path, capsys):
    log_path = tmp_path / "logs.json"
    rc = main([
        "gwnn", "--synthetic_nodes", "200", "--synthetic_features", "24",
        "--num_epochs", "15", "--filters", "8",
        "--log_path", str(log_path), *CPU,
    ])
    assert rc == 0
    assert "Test accuracy:" in capsys.readouterr().out
    logs = json.loads(log_path.read_text())
    assert len(logs) == 15 and {"epoch", "loss", "seconds"} <= set(logs[0])


def test_cli_sparsify_augment_train_roundtrip(tmp_path, capsys):
    sp_root = tmp_path / "sp"
    aug_root = tmp_path / "aug"
    rc = main([
        "sparsify", "--synthetic", "--sparse_rate", "0.5", "0.5",
        "--out_root", str(sp_root), "--seed", "7",
    ])
    assert rc == 0
    raws = list(sp_root.rglob("raw"))
    assert raws, "sparsify wrote no raw/ directory"
    name = raws[0].parent.name
    root = str(raws[0].parent.parent)
    rc = main([
        "augment", "--data_name", name, "--data_root", root,
        "--data_save_path", str(aug_root), "--epochs", "20",
        "--hidden_dim", "32", *CPU,
    ])
    assert rc == 0
    aug_raws = list(aug_root.rglob("raw"))
    assert aug_raws
    rc = main([
        "train", "--data_name", aug_raws[0].parent.name,
        "--data_root", str(aug_raws[0].parent.parent),
        "--num_epochs", "30", "--model_name", "sgc", "--hidden_dim", "32", *CPU,
    ])
    assert rc == 0
    assert "Best val:" in capsys.readouterr().out


@pytest.fixture(scope="module")
def spmd_worlds(tmp_path_factory):
    """The multi-rank ``spmd`` runs, each world once: rank 0's stdout, and
    every rank's return code."""
    cwd = tmp_path_factory.mktemp("spmd")
    runs = {
        "synthetic": run_spmd_world(SPMD_ARGV, 4, cwd),
        "accuracy": run_spmd_world(SPMD_ACC_ARGV, 4, cwd),
        "multi_run": run_spmd_world([
            "--synthetic", "--synthetic_nodes", "128",
            "--synthetic_classes", "3", "--synthetic_features", "8",
            "--num_shards", "2", "--local_engine", "hybrid",
            "--comm", "all_gather", "--reorder", "none",
            "--hidden_dim", "8", "--prop_steps", "1", "--steps", "5",
            "--num_runs", "2", "--lr", "0.05"], 2, cwd),
    }
    return runs


def test_cli_spmd_synthetic(spmd_worlds):
    """The SPMD subcommand end to end on four gloo ranks: cluster reorder ->
    tiled local engine -> halo exchange -> 2-D mesh; only rank 0 prints."""
    (rc0, out), *others = spmd_worlds["synthetic"]
    assert rc0 == 0 and all(rc == 0 for rc, _ in others)
    assert "spmd: mesh {'graph': 2, 'data': 2}" in out
    assert "engine tiled" in out and "comm halo" in out
    assert "best val" in out and "best test" in out
    assert all("spmd:" not in o for _, o in others)


def test_cli_spmd_multi_run(spmd_worlds):
    (rc0, out), (rc1, _) = spmd_worlds["multi_run"]
    assert rc0 == rc1 == 0
    assert "±" in out and "over 2 runs" in out


def test_cli_spmd_rejects_zero_steps(capsys):
    rc = main([
        "spmd", "--synthetic", "--synthetic_nodes", "64",
        "--num_shards", "2", "--steps", "0", *CPU,
    ])
    assert rc == 2
    assert "--steps must be >= 1" in capsys.readouterr().out
    assert not dist.is_initialized()


def test_cli_autotune(capsys):
    rc = main([
        "autotune", "--synthetic", "--synthetic_nodes", "400",
        "--synthetic_features", "32", "--features", "32", "--reps", "2", *CPU,
    ])
    assert rc == 0
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["best"] in payload["ms_per_hop"]


def test_cli_baseline_synthetic(capsys):
    assert main(BASELINE_ARGV + CPU) == 0
    assert "All runs:" in capsys.readouterr().out


def test_cli_train_checkpoint_then_predict(tmp_path, capsys):
    ckpt = tmp_path / "params.msgpack"
    rc = main([
        "train", "--synthetic", "--synthetic_nodes", "250",
        "--synthetic_features", "32", "--num_epochs", "20",
        "--model_name", "sgc", "--hidden_dim", "16", "--lr", "0.05",
        "--checkpoint_path", str(ckpt), *CPU,
    ])
    assert rc == 0 and ckpt.exists()
    out_npy = tmp_path / "labels.npy"
    rc = main([
        "predict", "--synthetic", "--synthetic_nodes", "250",
        "--synthetic_features", "32", "--model_name", "sgc",
        "--hidden_dim", "16", "--checkpoint", str(ckpt),
        "--nodes", "0,1,2,3", "--out", str(out_npy), *CPU,
    ])
    assert rc == 0
    assert np.load(out_npy).shape == (4,)
    assert "wrote 4 predictions" in capsys.readouterr().out


def test_cli_ooc(tmp_path, capsys):
    from ssrg_torch.data.synthetic import sbm_graph

    g = sbm_graph(num_node=200, num_classes=3, num_features=16,
                  p_in=0.06, p_out=0.003, feature_signal=1.2, seed=5)
    pairs = np.unique(
        np.sort(np.stack([g.edge.row, g.edge.col], axis=1), axis=1), axis=0
    )
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    np.save(tmp_path / "edges.npy", pairs.T.astype(np.int64))
    np.save(tmp_path / "features.npy", g.x.astype(np.float32))
    np.save(tmp_path / "labels.npy", np.asarray(g.y, np.int64))
    rc = main([
        "ooc", "--edges", str(tmp_path / "edges.npy"),
        "--features", str(tmp_path / "features.npy"),
        "--labels", str(tmp_path / "labels.npy"),
        "--work_dir", str(tmp_path / "work"), "--num_shards", "2",
        "--model_name", "sgc", "--prop_steps", "2", "--hidden_dim", "16",
        "--num_epochs", "15", "--lr", "0.05", "--train_batch_size", "64", *CPU,
    ])
    assert rc == 0
    assert "Best val:" in capsys.readouterr().out


def test_cli_bench_tiny(capsys):
    rc = main([
        "bench", "--nodes", "1500", "--degree", "6", "--features", "16",
        "--prop_steps", "2", *CPU,
    ])
    assert rc == 0
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert payload["metric"] == "khop_spmm_edges_per_s"
    assert payload["value"] > 0
    # the dense engine at this size: no gather-roofline fields
    assert "hbm_frac" not in payload and "achieved_gbps" not in payload


PLUMBING_ARGV = [
    "train", "--synthetic", "--synthetic_nodes", "120",
    "--synthetic_features", "8", "--model_name", "gamlp",
    "--hidden_dim", "24", "--prop_steps", "4", "--num_layers", "3",
    "--spmm_engine", "reorder_tiled", "--spmm_bf16",
    "--cluster_merge_target", "1024",
    "--scan_epochs", "--num_epochs", "17", "--lr", "0.02",
    "--weight_decay", "3e-4", "--warmup_epochs", "5",
    "--normalize_times", "2", "--seed", "99",
    "--train_batch_size", "32", "--eval_batch_size", "64",
    "--cache_dir", "/tmp/nope",
]


def _capture_train_configs(monkeypatch, module) -> dict:
    captured = {}

    class FakeTask:
        def __init__(self, dataset, spec, model_cfg, train_cfg, verbose=False, **kw):
            captured.update(model_cfg=model_cfg, train_cfg=train_cfg, kw=kw)
            self.best_val = self.best_test = 0.0

    monkeypatch.setattr(module, "NodeClassification", FakeTask)
    return captured


def test_cli_train_flag_plumbing(monkeypatch):
    """Parser -> TrainingConfig/ModelConfig plumbing: a typo'd argparse dest
    would silently drop a flag; capture the configs the train command builds
    (and the device it passes)."""
    import ssrg_torch.train.node_classification as nc

    captured = _capture_train_configs(monkeypatch, nc)
    assert main(PLUMBING_ARGV + CPU) == 0
    t = captured["train_cfg"]
    assert (t.spmm_engine, t.spmm_bf16, t.scan_epochs) == ("reorder_tiled", True, True)
    assert t.cluster_merge_target == 1024
    assert (t.num_epochs, t.lr, t.weight_decay, t.warmup_epochs) == (17, 0.02, 3e-4, 5)
    assert (t.normalize_times, t.seed) == (2, 99)
    assert (t.train_batch_size, t.eval_batch_size) == (32, 64)
    assert t.cache_dir == "/tmp/nope"
    m = captured["model_cfg"]
    assert (m.model_name, m.hidden_dim, m.prop_steps, m.num_layers) == ("gamlp", 24, 4, 3)
    assert captured["kw"] == {"device": "cpu"}


# --- parity with the reference CLI ------------------------------------------------


def _subparsers(monkeypatch, main_fn) -> dict:
    """The subcommand parsers that ``main_fn`` builds, taken from its call
    to ``parse_args``."""
    captured = {}

    class Stop(Exception):
        pass

    def grab(self, args=None, namespace=None):
        captured["parser"] = self
        raise Stop

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(Stop):
            main_fn(["train"])
    sub = next(a for a in captured["parser"]._actions
               if isinstance(a, argparse._SubParsersAction))
    return sub.choices


def _required_argv(parser) -> list:
    argv = []
    for a in parser._actions:
        if a.required and a.option_strings:
            argv += [a.option_strings[0], f"{a.dest}_given"]
    return argv


def _every_flag_argv(parser) -> list:
    """Each option of ``parser`` (but ``--help``) set to a value that is not
    its default."""
    argv = []
    for a in parser._actions:
        if not a.option_strings or a.dest == "help":
            continue
        flag = a.option_strings[0]
        if isinstance(a, argparse._StoreTrueAction):
            argv.append(flag)
        elif a.nargs == 2:
            argv += [flag, "0.25", "0.75"]
        elif a.type is int:
            argv += [flag, str((a.default or 0) + 7)]
        elif a.type is float:
            argv += [flag, repr((a.default or 0.0) + 0.125)]
        else:
            argv += [flag, f"{a.dest}_set"]
    return argv


def _namespaces(monkeypatch, argv: list) -> tuple:
    """The namespaces the reference's and the port's ``main`` hand their
    command function for ``argv`` (the command functions replaced by
    recorders)."""
    got = {}
    for name, module in (("ref", ref_cli), ("port", port_cli)):
        def record(args, name=name):
            got[name] = {k: v for k, v in vars(args).items() if k not in ("fn", "device")}
            return 0
        for command in COMMANDS:
            monkeypatch.setattr(module, f"cmd_{command}", record)
        assert module.main(list(argv)) == 0
    return got["ref"], got["port"]


@pytest.mark.parametrize("command", COMMANDS)
def test_cli_flags_match_the_reference(command, monkeypatch):
    ref_parsers = _subparsers(monkeypatch, ref_cli.main)
    port_parsers = _subparsers(monkeypatch, main)
    assert sorted(port_parsers) == sorted(ref_parsers) == sorted(COMMANDS)
    ref_p, port_p = ref_parsers[command], port_parsers[command]
    device = [a for a in port_p._actions if a.dest == "device"]
    if command == "sparsify":
        assert not device
    else:
        assert len(device) == 1 and device[0].default == "cuda"
    assert (sorted(a.dest for a in port_p._actions if a.dest != "device")
            == sorted(a.dest for a in ref_p._actions))
    at_defaults = [command] + _required_argv(ref_p)
    ref_ns, port_ns = _namespaces(monkeypatch, at_defaults)
    assert port_ns == ref_ns
    every = [command] + _every_flag_argv(ref_p)
    ref_ns, port_ns = _namespaces(monkeypatch, every)
    assert port_ns == ref_ns
    assert all(ref_ns[a.dest] != a.default for a in ref_p._actions
               if a.option_strings and a.dest != "help")


def test_cli_train_configs_match_the_reference(monkeypatch):
    import dataclasses

    import ssrg_tpu.train.node_classification as ref_nc
    import ssrg_torch.train.node_classification as nc

    ref = _capture_train_configs(monkeypatch, ref_nc)
    port = _capture_train_configs(monkeypatch, nc)
    assert ref_cli.main(PLUMBING_ARGV) == 0
    assert main(PLUMBING_ARGV + CPU) == 0
    for key in ("model_cfg", "train_cfg"):
        assert dataclasses.asdict(port[key]) == dataclasses.asdict(ref[key]), key


def test_cli_sparsify_writes_the_reference_files(tmp_path, capsys):
    argv = ["sparsify", "--synthetic", "--sparse_rate", "0.5", "0.5", "--seed", "7"]
    assert ref_cli.main(argv + ["--out_root", str(tmp_path / "ref")]) == 0
    assert main(argv + ["--out_root", str(tmp_path / "port")]) == 0
    ref_dirs = sorted(p.name for p in (tmp_path / "ref").iterdir())
    port_dirs = sorted(p.name for p in (tmp_path / "port").iterdir())
    assert port_dirs == ref_dirs == ["sbm_0.5_0.5"]
    ref_raw, port_raw = (tmp_path / side / "sbm_0.5_0.5" / "raw" for side in ("ref", "port"))
    names = sorted(p.name for p in ref_raw.iterdir())
    assert sorted(p.name for p in port_raw.iterdir()) == names and len(names) == 8
    for name in names:
        ref_t = torch.load(ref_raw / name)
        port_t = torch.load(port_raw / name)
        assert port_t.dtype == ref_t.dtype and torch.equal(port_t, ref_t), name
    out = capsys.readouterr().out
    assert out.count("sparsified dataset written to") == 2


CKPT_DATA = ["--synthetic", "--synthetic_nodes", "250", "--synthetic_features", "32"]
CKPT_MODEL = ["--model_name", "sgc", "--hidden_dim", "16"]


def test_cli_checkpoints_cross_both_ways(tmp_path, capsys):
    """A checkpoint each package's ``train`` wrote, served by each
    package's ``predict``: the reference ``Predictor``'s labels wherever the
    top-two logit gap exceeds ``GAP``."""
    from ssrg_tpu.configs.config import ModelConfig, TrainingConfig
    from ssrg_tpu.data.synthetic import planetoid_like
    from ssrg_tpu.models.zoo import load_model
    from ssrg_tpu.serve import Predictor

    ds = planetoid_like(num_node=250, num_classes=7, num_features=32, seed=2023)
    cfg = ModelConfig(model_name="sgc", hidden_dim=16)
    for writer, run in (("ref", ref_cli.main), ("port", main)):
        ckpt = tmp_path / f"{writer}.msgpack"
        extra = CPU if writer == "port" else []
        assert run(["train", *CKPT_DATA, *CKPT_MODEL, "--num_epochs", "20", "--lr", "0.05",
                    "--checkpoint_path", str(ckpt), *extra]) == 0
        pred = Predictor(ds, load_model(cfg, 32, 7), cfg, TrainingConfig(spmm_engine="dense"),
                         checkpoint_path=str(ckpt))
        logits = np.asarray(pred.logits(np.asarray(ds.test_idx)))
        top2 = np.sort(logits, axis=1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > GAP
        assert sure.mean() > 0.9
        for reader, serve in (("ref", ref_cli.main), ("port", main)):
            out = tmp_path / f"{writer}_by_{reader}.npy"
            extra = CPU if reader == "port" else []
            assert serve(["predict", *CKPT_DATA, *CKPT_MODEL, "--checkpoint", str(ckpt),
                          "--out", str(out), *extra]) == 0
            labels = np.load(out)
            assert labels.shape == (len(ds.test_idx),)
            np.testing.assert_array_equal(labels[sure], logits.argmax(axis=1)[sure],
                                          err_msg=f"{writer} checkpoint, {reader} predict")
    capsys.readouterr()


@pytest.mark.parametrize("argv,pattern", [(TRAIN_ARGV, BEST), (LINK_ARGV, BEST),
                                          (BASELINE_ACC_ARGV, ALL_RUNS)],
                         ids=["train", "link", "baseline"])
def test_cli_accuracy_matches_the_reference(argv, pattern, capsys):
    _assert_close(pattern, *_both(capsys, argv))


def test_cli_spmd_accuracy_matches_the_reference(spmd_worlds, capsys):
    assert ref_cli.main(["spmd", *SPMD_ACC_ARGV]) == 0
    ref_out = capsys.readouterr().out
    assert "spmd: mesh {'graph': 2, 'data': 2}" in ref_out
    _assert_close(SPMD_BEST, ref_out, spmd_worlds["accuracy"][0][1])


def test_cli_spmd_world_of_one_ends_its_world(capsys):
    """Without ``torchrun``, ``spmd`` starts a world of one rank and ends it,
    so a second call in the same process starts clean; a mesh larger than
    the world is refused with the reference's message."""
    argv = ["spmd", "--synthetic", "--synthetic_nodes", "128", "--synthetic_classes", "3",
            "--synthetic_features", "8", "--local_engine", "hybrid", "--comm", "all_gather",
            "--reorder", "none", "--hidden_dim", "8", "--prop_steps", "1", "--steps", "3",
            "--lr", "0.05", *CPU]
    for _ in range(2):
        assert main(argv) == 0
        assert not dist.is_initialized()
        assert "spmd: mesh {'graph': 1}" in capsys.readouterr().out
    assert main(argv + ["--num_shards", "2"]) == 2
    assert "mesh needs 2 devices (2 graph x 1 data), have 1" in capsys.readouterr().out
    assert not dist.is_initialized()


def test_cli_defaults_to_the_card():
    """No silent CPU path: without ``--device`` every device-bound
    subcommand asks for the card, and without one it raises."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main(TRAIN_ARGV)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main(["spmd", "--synthetic", "--synthetic_nodes", "256", "--synthetic_classes", "4",
              "--steps", "1"])
    assert not dist.is_initialized()


def test_cli_runs_as_a_module_and_a_console_script():
    """``python -m ssrg_torch.cli --help`` lists the eleven subcommands, and
    ``pyproject.toml`` registers ``ssrg-torch`` beside ``ssrg-tpu``."""
    import tomllib

    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "ssrg_torch.cli", "--help"], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "ssrg-torch" in proc.stdout
    for command in COMMANDS:
        assert re.search(rf"\b{command}\b", proc.stdout), command
    scripts = tomllib.loads((ROOT / "pyproject.toml").read_text())["project"]["scripts"]
    assert scripts == {"ssrg-tpu": "ssrg_tpu.cli:main", "ssrg-torch": "ssrg_torch.cli:main"}
    module, fn = scripts["ssrg-torch"].split(":")
    assert getattr(__import__(module, fromlist=[fn]), fn) is main
