"""Parity of the PyTorch port's out-of-core propagation and training with
``ssrg_tpu``, on the CPU.

A small SBM graph is dumped to ``.npy`` files; both packages spool it,
propagate it block at a time and train on the hop directories. Tolerances,
each with its reason:

- hop files: 1e-5 under both schedules and both local engines (the same
  f32 products summed in another order, a few dozen terms a row);
- the bf16 transfer: within ``K * 2^-7 * (|A|^K |X|)`` elementwise of the
  f32 hops (each hop rounds its source block to bf16, a relative 2^-8,
  and the rounding carries through the hops; twice that for slack);
- bucket packs: equal (the tails after a stable row sort: the C packer
  writes them in thread order);
- accuracy: within 0.06 of the reference's best test accuracy on the same
  configuration (other initial weights and dropout draws).
"""

import os
import os.path as osp
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ssrg_tpu import native as ref_native
from ssrg_tpu.configs.config import ModelConfig as RefModelConfig
from ssrg_tpu.configs.config import TrainingConfig as RefTrainingConfig
from ssrg_tpu.data.streaming import stream_partition as ref_stream_partition
from ssrg_tpu.parallel import outofcore as ref_outofcore
from ssrg_tpu.train import outofcore_task as ref_task

from ssrg_torch.configs.config import ModelConfig, TrainingConfig
from ssrg_torch.data.streaming import stream_partition
from ssrg_torch.data.synthetic import sbm_graph
from ssrg_torch.ops.normalize import sym_norm
from ssrg_torch.parallel import outofcore
from ssrg_torch.train import outofcore_task as task_mod
from ssrg_torch.train.common import batch_iterator, split_labels

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CPU = "cpu"
K = 2


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """The graph on disk (single-direction unique pairs, as the streaming
    loader expects), spooled by both packages into 3 shards."""
    root = tmp_path_factory.mktemp("ooc")
    g = sbm_graph(num_node=400, num_classes=4, num_features=32, p_in=0.04, p_out=0.002,
                  feature_signal=1.2, seed=3)
    pairs = np.unique(np.sort(np.stack([g.edge.row, g.edge.col], axis=1), axis=1), axis=0)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    # a hub, so that some buckets have a COO tail
    hub = np.stack([np.zeros(150, np.int64), np.arange(1, 151)], axis=1)
    pairs = np.unique(np.concatenate([pairs, hub]), axis=0)
    paths = {name: str(root / f"{name}.npy") for name in ("edges", "features", "labels")}
    np.save(paths["edges"], pairs.T.astype(np.int64))
    np.save(paths["features"], g.x.astype(np.float32))
    np.save(paths["labels"], np.asarray(g.y, np.int64))
    meta = stream_partition(paths["edges"], 400, 3, str(root / "spool"))
    ref_meta = ref_stream_partition(paths["edges"], 400, 3, str(root / "ref_spool"))
    return root, paths, meta, ref_meta, pairs


def _blocks(hop_dirs, num_shards):
    return [np.concatenate([np.load(osp.join(d, f"block{i}.npy")) for i in range(num_shards)])
            for d in hop_dirs]


@pytest.mark.parametrize("engine", ["hybrid", "coo"])
@pytest.mark.parametrize("mode", ["source_outer", "dest_outer"])
def test_hop_files_match_reference(staged, tmp_path, mode, engine):
    root, paths, meta, ref_meta, _ = staged
    ref_dirs = ref_outofcore.outofcore_propagate(ref_meta, paths["features"], K,
                                                 str(tmp_path / "ref"), mode=mode,
                                                 local_engine=engine)
    stats = {}
    dirs = outofcore.outofcore_propagate(meta, paths["features"], K, str(tmp_path / "port"),
                                         mode=mode, local_engine=engine, device=CPU,
                                         stats=stats)
    assert [osp.basename(d) for d in dirs] == [osp.basename(d) for d in ref_dirs]
    for got, want in zip(_blocks(dirs, 3), _blocks(ref_dirs, 3)):
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert stats["mode"] == mode and len(stats["hop_s"]) == K
    assert stats["nonempty_buckets"] == 9


def test_auto_schedule_follows_the_budget(staged, tmp_path):
    _, paths, meta, _, _ = staged
    for budget, mode in ((4 << 30, "source_outer"), (1024, "dest_outer")):
        stats = {}
        outofcore.outofcore_propagate(meta, paths["features"], 1, str(tmp_path / mode),
                                      acc_budget_bytes=budget, device=CPU, stats=stats)
        assert stats["mode"] == mode


def test_hops_match_in_memory_propagation(staged, tmp_path):
    """Against float64 scipy on the symmetrized graph with self loops."""
    _, paths, meta, _, pairs = staged
    dirs = outofcore.outofcore_propagate(meta, paths["features"], K, str(tmp_path), device=CPU)
    adj = sp.csr_matrix((np.ones(len(pairs)), (pairs[:, 0], pairs[:, 1])), shape=(400, 400))
    p = sym_norm(((adj + adj.T) > 0).astype(np.float64), 0.5).astype(np.float64)
    want = np.load(paths["features"]).astype(np.float64)
    for got in _blocks(dirs, 3):
        np.testing.assert_allclose(got[:400], want, rtol=1e-5, atol=1e-5)
        want = p @ want


def test_bf16_transfer_within_its_bound(staged, tmp_path):
    _, paths, meta, _, pairs = staged
    f32 = outofcore.outofcore_propagate(meta, paths["features"], K, str(tmp_path / "f32"),
                                        device=CPU)
    bf16 = outofcore.outofcore_propagate(meta, paths["features"], K, str(tmp_path / "bf16"),
                                         transfer_dtype="bfloat16", device=CPU)
    adj = sp.csr_matrix((np.ones(len(pairs)), (pairs[:, 0], pairs[:, 1])), shape=(400, 400))
    p = abs(sym_norm(((adj + adj.T) > 0).astype(np.float64), 0.5))
    mag = np.abs(np.load(paths["features"])).astype(np.float64)
    for k, (a, b) in enumerate(zip(_blocks(f32, 3), _blocks(bf16, 3))):
        if k:
            mag = p @ mag
            bound = k * 2.0 ** -7 * mag
            assert np.all(np.abs(a[:400] - b[:400]) <= bound + 1e-30)
            assert np.abs(a - b).max() > 0   # the rounding happened
        else:
            np.testing.assert_array_equal(a, b)


def test_bucket_packs_equal_the_reference(staged, tmp_path, monkeypatch):
    """The reference packs each bucket inside ``outofcore_propagate``; its
    packer's calls are recorded (``dest_outer`` packs bucket by bucket in
    the port's order) and held to :func:`outofcore.pack_bucket`."""
    _, paths, meta, ref_meta, _ = staged
    calls = []
    real = ref_native.ell_hybrid_pack

    def record(*args):
        out = real(*args)
        calls.append((args[3], out))
        return out

    monkeypatch.setattr(ref_native, "ell_hybrid_pack", record)
    ref_outofcore.outofcore_propagate(ref_meta, paths["features"], 1, str(tmp_path),
                                      mode="dest_outer")
    buckets = outofcore.bucket_edges(meta)
    packs = []
    for i, (r, c, v, off) in enumerate(buckets):
        for j in range(3):
            if off[j] != off[j + 1]:
                packs.append(outofcore.pack_bucket(r[off[j]:off[j + 1]], c[off[j]:off[j + 1]],
                                                   v[off[j]:off[j + 1]], meta.block))
    assert len(packs) == len(calls) == 9
    tails = 0
    for (ec, ev, tail), (w, (rec, rev, rtr, rtc, rtv)) in zip(packs, calls):
        assert ec.shape == (meta.block, w) and w >= 8 and (w & (w - 1)) == 0
        np.testing.assert_array_equal(ec, rec)
        np.testing.assert_array_equal(ev, rev)
        if tail is None:
            assert rtr.size == 0
            continue
        tails += 1
        real_t = tail[2] != 0
        assert int(real_t.sum()) == rtr.size and tail[0].size == outofcore._pow2_pad(
            rtr.size, floor=1 << 9)
        order, ref_order = np.argsort(tail[0][real_t], kind="stable"), np.argsort(rtr,
                                                                                   kind="stable")
        for a, b in zip(tail, (rtr, rtc, rtv)):
            np.testing.assert_array_equal(a[real_t][order], b[ref_order])
    assert tails > 0


def test_each_bucket_launches_the_ell_kernel_once_a_hop(staged, tmp_path, monkeypatch):
    """Every non-empty bucket goes through the ELL wrapper once a hop on a
    ``[block, F]`` source block (the coo engine never); the packs it gets
    are host copies moved one at a time."""
    _, paths, meta, _, _ = staged
    calls = []
    real = outofcore.ell_spmm

    def count(cols, vals, x):
        calls.append((tuple(cols.shape), tuple(x.shape)))
        return real(cols, vals, x)

    monkeypatch.setattr(outofcore, "ell_spmm", count)
    for mode in ("source_outer", "dest_outer"):
        calls.clear()
        stats = {}
        outofcore.outofcore_propagate(meta, paths["features"], K, str(tmp_path / mode),
                                      mode=mode, device=CPU, stats=stats)
        assert len(calls) == K * stats["nonempty_buckets"]
        assert all(c[0] == meta.block and x == (meta.block, 32) for c, x in calls)
        assert stats["max_pack_bytes"] > 0
    calls.clear()
    outofcore.outofcore_propagate(meta, paths["features"], K, str(tmp_path / "coo"),
                                  local_engine="coo", device=CPU)
    assert not calls


def test_load_hop_rows_and_staging_equal(staged, tmp_path):
    _, paths, meta, _, _ = staged
    outofcore.stage_feature_blocks(paths["features"], meta, str(tmp_path / "port"))
    ref_outofcore.stage_feature_blocks(paths["features"], meta, str(tmp_path / "ref"))
    for i in range(3):
        np.testing.assert_array_equal(np.load(tmp_path / "port" / "hop0" / f"block{i}.npy"),
                                      np.load(tmp_path / "ref" / "hop0" / f"block{i}.npy"))
    ids = np.asarray([0, 5, 399, 42, 200, 133, 134])
    hop0 = str(tmp_path / "port" / "hop0")
    np.testing.assert_array_equal(outofcore.load_hop_rows(hop0, meta, ids),
                                  ref_outofcore.load_hop_rows(hop0, meta, ids))
    np.testing.assert_array_equal(outofcore.load_hop_rows(hop0, meta, ids),
                                  np.load(paths["features"])[ids])


def test_unknown_engine_and_schedule_raise(staged, tmp_path):
    _, paths, meta, _, _ = staged
    with pytest.raises(ValueError, match="local engine"):
        outofcore.outofcore_propagate(meta, paths["features"], 1, str(tmp_path),
                                      local_engine="ell", device=CPU)
    with pytest.raises(ValueError, match="schedule"):
        outofcore.outofcore_propagate(meta, paths["features"], 1, str(tmp_path),
                                      mode="ring", device=CPU)


# --- training -------------------------------------------------------------------


def _ref_run(paths, work, model, lr, epochs):
    return ref_task.run_outofcore(
        paths["edges"], paths["features"], paths["labels"], work, num_shards=3,
        model_cfg=RefModelConfig(model_name=model, prop_steps=K, hidden_dim=64),
        train_cfg=RefTrainingConfig(num_epochs=epochs, lr=lr, train_batch_size=64, seed=7))


def _run(paths, work, model, lr, epochs):
    return task_mod.run_outofcore(
        paths["edges"], paths["features"], paths["labels"], work, num_shards=3,
        model_cfg=ModelConfig(model_name=model, prop_steps=K, hidden_dim=64),
        train_cfg=TrainingConfig(num_epochs=epochs, lr=lr, train_batch_size=64, seed=7),
        device=CPU)


@pytest.mark.parametrize("model,lr,epochs", [("sgc", 0.05, 30), ("gamlp", 0.01, 20)])
def test_run_outofcore_matches_reference_accuracy(staged, tmp_path, model, lr, epochs):
    _, paths, _, _, _ = staged
    want = _ref_run(paths, str(tmp_path / "ref"), model, lr, epochs)
    got = _run(paths, str(tmp_path / "port"), model, lr, epochs)
    assert got.best_test > 0.5
    assert abs(got.best_test - want.best_test) <= 0.06, (got.best_test, want.best_test)
    assert len(got.hop_dirs) == K + 1
    for a, b in zip(_blocks(got.hop_dirs, 3), _blocks(want.hop_dirs, 3)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def port_work(staged):
    """A work directory the port spooled and propagated."""
    root, paths, _, _, _ = staged
    work = str(root / "port_work")
    labels = np.load(paths["labels"])
    meta = task_mod.ensure_spooled(paths["edges"], labels.shape[0], 3, work)
    hop_dirs = task_mod.ensure_hops(meta, paths["features"], K, work, device=CPU)
    return work, meta, hop_dirs, labels


def test_artifacts_are_reused(staged, port_work):
    _, paths, _, _, _ = staged
    work, meta, _, labels = port_work
    hop_file = osp.join(work, f"hop{K}", "block0.npy")
    spool_file = osp.join(meta.spool_dir, "shard_0.bin")
    before = (osp.getmtime(hop_file), osp.getmtime(spool_file))
    meta2 = task_mod.ensure_spooled(paths["edges"], labels.shape[0], 3, work)
    dirs = task_mod.ensure_hops(meta2, paths["features"], K, work, device=CPU)
    assert (osp.getmtime(hop_file), osp.getmtime(spool_file)) == before
    assert meta2 == meta and len(dirs) == K + 1
    assert task_mod.load_meta(work) == meta


def _task(port_work, model="sgc", **tkw):
    _, meta, hop_dirs, labels = port_work
    tr, va, te = split_labels(labels, num_val=60, num_test=120, seed=0)
    return task_mod.OutOfCoreNodeClassification(
        meta, hop_dirs, labels, tr, va, te, ModelConfig(model_name=model, prop_steps=K),
        TrainingConfig(**{**dict(num_epochs=1, lr=0.05, train_batch_size=32, seed=7), **tkw}),
        device=CPU)


@pytest.mark.parametrize("model,kw", [("gcn", {}), ("wavelet", {}), ("magnet", {}),
                                      ("sgc", dict(use_bn=True))])
def test_unsupported_specs_are_rejected(port_work, model, kw):
    _, meta, hop_dirs, labels = port_work
    tr, va, te = split_labels(labels, num_val=40, num_test=60, seed=0)
    cfg = ModelConfig(model_name=model, prop_steps=K, **kw)
    match = "use_bn" if "use_bn" in kw else "sym-norm precompute"
    with pytest.raises(ValueError, match=match):
        task_mod.OutOfCoreNodeClassification(meta, hop_dirs, labels, tr, va, te, cfg,
                                             device=CPU)


def test_hop_count_must_match_prop_steps(port_work):
    _, meta, hop_dirs, labels = port_work
    tr, va, te = split_labels(labels, num_val=40, num_test=60, seed=0)
    with pytest.raises(ValueError, match="prop_steps"):
        task_mod.OutOfCoreNodeClassification(meta, hop_dirs, labels, tr, va, te,
                                             ModelConfig(model_name="sgc", prop_steps=K + 1),
                                             device=CPU)


def test_each_batch_draws_its_own_dropout(port_work, monkeypatch):
    """The run's generator moves on with every draw: the state before each
    batch of the first epoch differs, and so do the dropout masks."""
    task = _task(port_work, model="gamlp")
    masks = []
    real = torch.rand

    def keep(*args, **kwargs):
        out = real(*args, **kwargs)
        masks.append(out)
        return out

    monkeypatch.setattr(torch, "rand", keep)
    task.execute()
    monkeypatch.undo()
    keys = task.epoch0_batch_keys
    assert len(keys) > 1 and len(set(keys)) == len(keys)
    first = [m for m in masks if m.shape == masks[0].shape]
    assert len(first) > 1 and not torch.equal(first[0], first[1])


def test_prefetched_batches_equal_a_direct_gather(port_work):
    task = _task(port_work)
    tr = task.train_idx
    batches = list(batch_iterator(tr, 32, np.random.default_rng(0), shuffle=False))
    got = list(task._prefetched(iter(batches)))
    assert len(got) == len(batches) > 1
    for (stack, b, w), (b0, w0) in zip(got, batches):
        np.testing.assert_array_equal(b, b0)
        np.testing.assert_array_equal(w, w0)
        np.testing.assert_array_equal(stack, task._stack(b0))
        assert stack.shape == (K + 1, 32, 32)
    assert list(task._prefetched([])) == []


def test_a_work_dir_of_the_reference_trains_the_port_without_it(staged, tmp_path):
    """``ssrg_tpu`` spools and propagates; a fresh process of the port, which
    never imports ``ssrg_tpu`` or jax, reuses every file (no rewrite) and
    trains on them."""
    _, paths, _, _, _ = staged
    work = str(tmp_path / "ref_work")
    _ref_run(paths, work, "sgc", 0.05, 2)
    code = textwrap.dedent(f"""
        import os, sys
        import numpy as np
        from ssrg_torch.configs.config import ModelConfig, TrainingConfig
        from ssrg_torch.train.outofcore_task import run_outofcore
        work = {work!r}
        files = [os.path.join(d, f) for d, _, fs in os.walk(work) for f in fs]
        before = {{f: os.path.getmtime(f) for f in files}}
        r = run_outofcore({paths['edges']!r}, {paths['features']!r}, {paths['labels']!r},
                          work, num_shards=3,
                          model_cfg=ModelConfig(model_name="ssgc", prop_steps={K}),
                          train_cfg=TrainingConfig(num_epochs=20, lr=0.05,
                                                   train_batch_size=64, seed=7),
                          device="cpu")
        assert {{f: os.path.getmtime(f) for f in files}} == before
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "ssrg_tpu"))
        assert not bad, bad
        print("BEST", r.best_test)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    best = float(proc.stdout.split("BEST")[-1])
    assert best > 0.5


def test_entry_points_default_to_cuda(staged, port_work, tmp_path, monkeypatch):
    _, paths, meta, _, _ = staged
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        outofcore.outofcore_propagate(meta, paths["features"], 1, str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        task_mod.run_outofcore(paths["edges"], paths["features"], paths["labels"],
                               str(tmp_path / "w"), num_shards=3)
    _, meta2, hop_dirs, labels = port_work
    with pytest.raises(RuntimeError, match="cuda"):
        task_mod.OutOfCoreNodeClassification(meta2, hop_dirs, labels, [0], [1], [2],
                                             ModelConfig(prop_steps=K))
