"""The distributed tier of the PyTorch port (``ssrg_torch/parallel/mesh.py``,
``dist_spmm.py``, ``dist_train.py``) against ``ssrg_tpu.parallel``, on the CPU.

The JAX side runs here, on the conftest's eight fake CPU devices, with jax
imported inside the tests only. The torch side runs in worlds of 2 and 4
``gloo`` ranks: fresh interpreters that import torch, numpy, scipy and
``ssrg_torch`` only, join through a ``file://`` store in a temporary
directory, and run the cases whose sources :func:`run_world` sends them.
Each world runs all its cases once (a module fixture); the inputs go in and
the results come out through pickles in that directory. A card's case (a
world of one NCCL rank) runs in this process and skips without a card.
"""

import inspect
import os
import pathlib
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ssrg_torch.data.synthetic import planetoid_like, sbm_graph
from ssrg_torch.ops.normalize import sym_norm
from ssrg_torch.parallel import dist_spmm, partition

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOY_TILE_KW = dict(row_block=8, tile_cols=16, min_edges_per_tile=4)
WORLD_TIMEOUT_S = 110      # a world that hangs fails instead of stalling the suite
ENGINES = ("coo", "hybrid", "halo", "tiled", "ring", "ring_hybrid")

_HEADER = '''
import os, pickle, sys
from datetime import timedelta
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(2)
RANK, WORLD, ROOT = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
'''

_JOIN = '''
dist.init_process_group("gloo", init_method=f"file://{ROOT}/store", rank=RANK,
                        world_size=WORLD, timeout=timedelta(seconds=100))
'''

_RUN = '''
with open(os.path.join(ROOT, "in.pkl"), "rb") as f:
    INPUTS, CASES = pickle.load(f)
results = {label: globals()[fn](INPUTS, **kw) for label, fn, kw in CASES}
dist.destroy_process_group()
with open(os.path.join(ROOT, f"out_{RANK}.pkl"), "wb") as f:
    pickle.dump(results, f)
'''


def run_world(root: pathlib.Path, world: int, inputs: dict, cases: list, functions: list,
              join: str = _JOIN) -> list:
    """Run ``cases`` (``(label, function name, keywords)``) on ``world`` gloo
    ranks, each a fresh interpreter holding the sources of ``functions``
    (functions, or lines of code);
    every case is called as ``fn(inputs, **keywords)`` on every rank, in
    order. Returns each rank's ``{label: result}``."""
    sources = [f if isinstance(f, str) else textwrap.dedent(inspect.getsource(f))
               for f in functions]
    code = "\n".join([_HEADER, join] + sources + [_RUN])
    with open(root / "in.pkl", "wb") as f:
        pickle.dump((inputs, cases), f)
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(world), str(root)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=env, cwd=root)
             for r in range(world)]
    errors = []
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=WORLD_TIMEOUT_S)
            if p.returncode != 0:
                errors.append(f"rank {r} exited {p.returncode}:\n{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not errors, "\n".join(errors)
    outs = []
    for r in range(world):
        with open(root / f"out_{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs


# --- inputs (the reference tests' graphs, from the port's equal generators) ----------


def _graph(n=203, f=17, seed=0):
    rng = np.random.default_rng(seed)
    a = (rng.uniform(size=(n, n)) < 0.08).astype(np.float32)
    np.fill_diagonal(a, 0)
    a = np.maximum(a, a.T)
    x = rng.normal(size=(n, f)).astype(np.float32)
    return sym_norm(sp.csr_matrix(a), 0.5), x


def _community_graph(n=256, classes=8, seed=3):
    g = sbm_graph(num_node=n, num_classes=classes, num_features=4, p_in=0.25, p_out=0.004,
                  seed=seed)
    adj, _, _, _ = partition.cluster_reorder_for_partition(g.adj)
    x = np.random.default_rng(seed).normal(size=(n, 12)).astype(np.float32)
    return sym_norm(adj, 0.5), x


def _engine_input(engine: str, d: int):
    """``(adjacency, x)`` of an engine's parity case."""
    if engine == "tiled":
        return _community_graph()
    return _graph(seed={"coo": 1, "hybrid": 7, "halo": 8, "ring": 4, "ring_hybrid": 9}[engine])


def _partition(mod, engine: str, p, d: int):
    """The partition of ``engine`` at ``d`` shards by ``mod`` (the port's or
    the reference's functions, which take the same arguments)."""
    part_mod, ring_mod = mod
    if engine == "coo":
        return part_mod.partition_rows(p, d)
    if engine in ("hybrid", "halo"):
        return part_mod.partition_rows_hybrid(p, d, halo=engine == "halo", row_align=8)
    if engine == "tiled":
        return part_mod.partition_rows_tiled(p, d, halo=d == 4, **TOY_TILE_KW)
    if engine == "ring":
        return ring_mod.partition_rows_ring(p, d)
    return ring_mod.partition_rows_ring_hybrid(p, d)


# --- the torch side's cases (sources sent to the ranks) --------------------------------


def _engine_fns(D):
    """``engine -> (shard function, propagate function)`` of the port's
    ``dist_spmm`` module ``D``."""
    return {"coo": (D.shard_adjacency, D.dist_propagate),
            "hybrid": (D.shard_adjacency_hybrid, D.dist_propagate_hybrid),
            "halo": (D.shard_adjacency_hybrid, D.dist_propagate_hybrid),
            "tiled": (D.shard_adjacency_tiled, D.dist_propagate_tiled),
            "ring": (D.shard_adjacency_ring, D.dist_propagate_ring),
            "ring_hybrid": (D.shard_adjacency_ring_hybrid, D.dist_propagate_ring_hybrid)}


def propagate_all(inputs, d):
    """Every engine's K = 3 hops at ``d`` graph shards: the gathered hops,
    this rank's shard as numpy, and the exchange's byte count."""
    from ssrg_torch.parallel import dist_spmm as D
    from ssrg_torch.parallel import partition as P
    from ssrg_torch.parallel.mesh import make_mesh

    mesh = make_mesh((d,), ("graph",), device="cpu")
    out = {}
    for engine, (p, x) in inputs["graphs"][d].items():
        part = _partition((P, D), engine, p, d)
        place, fn = _engine_fns(D)[engine]
        adj = place(part, mesh)
        stats = {}
        hops = fn(adj, D.shard_features(x, part, mesh), 3, stats=stats)
        shard = {k: v.numpy() for k, v in vars(adj).items() if isinstance(v, torch.Tensor)}
        out[engine] = {"hops": D.all_gather_hops(hops, mesh).numpy(), "shard": shard,
                       "block_hops": hops.numpy(), "stats": stats}
    return out


def spmd_losses(inputs, engine, comm, reorder):
    """GAMLP on a (graph 2, data 2) mesh with the reference's initial
    parameters, dropout 0: five ``run_steps`` losses and the hops."""
    from ssrg_torch.convert import params_from_jax
    from ssrg_torch.models.zoo import load_model
    from ssrg_torch.parallel.dist_spmm import all_gather_hops
    from ssrg_torch.parallel.dist_train import build_spmd_context, ensure_hops, run_steps
    from ssrg_torch.parallel.mesh import make_mesh

    s = inputs["spmd"]
    mesh = make_mesh((2, 2), ("graph", "data"), device="cpu")
    module = load_model(s["cfg"], s["x"].shape[1], s["classes"]).module
    ctx = build_spmd_context(s["adj"], s["x"], s["y"], s["train_idx"], module, mesh, 2,
                             lr=0.05, data_axis="data", local_engine=engine, comm=comm,
                             reorder=reorder)
    ctx.module.load_state_dict(params_from_jax(s["params"][engine, comm]))
    losses = [run_steps(ctx, 1)[1] for _ in range(5)]
    return {"losses": losses, "hops": all_gather_hops(ensure_hops(ctx), mesh, axis=None).numpy(),
            "head_rows": ctx.head_rows, "rank": mesh.rank}


def spmd_epochs(inputs):
    """SGC trained by ``run_epochs_scan`` on a (2, 2) mesh from the
    reference's initial parameters, then ``evaluate`` and ``run_multi``."""
    from ssrg_torch.convert import params_from_jax
    from ssrg_torch.models.zoo import load_model
    from ssrg_torch.parallel.dist_train import (build_spmd_context, evaluate, run_epochs_scan,
                                                run_multi)
    from ssrg_torch.parallel.mesh import make_mesh

    s = inputs["epochs"]
    mesh = make_mesh((2, 2), ("graph", "data"), device="cpu")
    module = load_model(s["cfg"], s["x"].shape[1], s["classes"]).module
    ctx = build_spmd_context(s["adj"], s["x"], s["y"], s["train_idx"], module, mesh, 3,
                             lr=0.05, data_axis="data", val_idx=s["val_idx"],
                             test_idx=s["test_idx"])
    ctx.module.load_state_dict(params_from_jax(s["params"]))
    ctx, res = run_epochs_scan(ctx, 60, seed=0)
    accs = evaluate(ctx)
    ctx, multi = run_multi(ctx, 30, num_runs=2, seed=1)
    return {"best_val": res.best_val, "best_test": res.best_test, "best_epoch": res.best_epoch,
            "history": res.history, "final_loss": res.final_loss, "evaluate": accs,
            "runs": multi.runs, "mean_std": multi.mean_std}


def refusals(inputs):
    """The reference's errors and the port's BatchNorm refusal, each as the
    message it raised; ``run_steps(ctx, 0)``'s loss; the saturated-halo
    warning."""
    import logging

    from ssrg_torch.configs.config import ModelConfig
    from ssrg_torch.models.zoo import load_model
    from ssrg_torch.parallel import dist_spmm as D
    from ssrg_torch.parallel import partition as P
    from ssrg_torch.parallel.dist_train import build_spmd_context, run_epochs_scan, run_steps
    from ssrg_torch.parallel.mesh import make_mesh

    s = inputs["small"]
    mesh = make_mesh((2,), ("graph",), device="cpu")
    out = {}

    def message(fn):
        try:
            fn()
        except ValueError as exc:
            return str(exc)
        return None

    def build(cfg=ModelConfig(model_name="sgc", prop_steps=2, hidden_dim=8, num_layers=1),
              **kw):
        module = load_model(cfg, s["x"].shape[1], s["classes"]).module
        return build_spmd_context(s["adj"], s["x"], s["y"], s["train_idx"], module, mesh, 2,
                                  **kw)

    out["unknown_comm"] = message(lambda: build(comm="ring"))
    out["halo_coo"] = message(lambda: build(comm="halo", local_engine="coo"))
    out["unknown_engine"] = message(lambda: build(local_engine="dense"))
    out["unknown_reorder"] = message(lambda: build(reorder="rcm"))
    out["batch_norm"] = message(lambda: build(ModelConfig(model_name="gamlp", prop_steps=2,
                                                          num_layers=2, hidden_dim=8,
                                                          use_bn=True)))
    out["shape"] = message(lambda: make_mesh((3,), ("graph",), device="cpu"))
    out["names"] = message(lambda: make_mesh((2,), ("graph", "data"), device="cpu"))
    out["shards"] = message(lambda: D.shard_adjacency(P.partition_rows(s["adj"], 4), mesh))
    ctx = build()
    out["eval_masks"] = message(lambda: run_epochs_scan(ctx, 3))
    out["zero_steps"] = run_steps(ctx, 0)[1]
    out["one_step"] = run_steps(ctx, 1)[1]
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logging.getLogger("ssrg_torch").addHandler(handler)
    module = load_model(ModelConfig(model_name="sgc", prop_steps=1, hidden_dim=8, num_layers=1),
                        s["x"].shape[1], s["classes"]).module
    ctx = build_spmd_context(s["dense_adj"], s["x"], s["y"], s["train_idx"], module, mesh, 1,
                             local_engine="hybrid", comm="halo")
    out["saturated"] = (ctx.adj.halo_pad >= ctx.adj.block,
                        any("halo plan saturated" in r.getMessage() for r in records))
    return out


# --- the worlds ------------------------------------------------------------------------

SPMD_RUNS = (("hybrid", "all_gather", None), ("hybrid", "halo", "cluster"),
             ("tiled", "halo", "cluster"), ("coo", "all_gather", None))
CASE_SOURCES = [f"TOY_TILE_KW = {TOY_TILE_KW!r}", _partition, _engine_fns, propagate_all,
                spmd_losses, spmd_epochs, refusals]


def _ref_mesh(shape, names):
    import jax

    from ssrg_tpu.parallel.mesh import make_mesh

    return make_mesh(shape, names, jax.devices()[:int(np.prod(shape))])


def _spmd_dataset():
    ds = planetoid_like(num_node=256, num_classes=4, num_features=16, seed=2,
                        train_per_class=8, num_val=16, num_test=16)
    return ds, sym_norm(ds.adj, 0.5)


@pytest.fixture(scope="module")
def spmd_reference():
    """The reference's GAMLP contexts on a (2, 2) mesh, dropout 0: each
    run's initial parameters (numpy), five ``run_steps`` losses and its hops;
    and SGC's ``run_epochs_scan`` on the same mesh."""
    import jax

    from ssrg_tpu.configs.config import ModelConfig as RefModelConfig
    from ssrg_tpu.models.zoo import load_model as ref_load_model
    from ssrg_tpu.parallel import dist_train as R

    from ssrg_torch.configs.config import ModelConfig

    mesh = _ref_mesh((2, 2), ("graph", "data"))
    ds, adj = _spmd_dataset()
    kw = dict(model_name="gamlp", prop_steps=2, hidden_dim=16, num_layers=2, dropout=0.0)
    spmd = {"adj": adj, "x": ds.x, "y": np.asarray(ds.y), "train_idx": ds.train_idx,
            "classes": ds.num_classes, "cfg": ModelConfig(**kw), "params": {}}
    ref = {}
    for engine, comm, reorder in SPMD_RUNS:
        spec = ref_load_model(RefModelConfig(**kw), ds.num_features, ds.num_classes)
        ctx = R.build_spmd_context(adj, ds.x, ds.y, ds.train_idx, spec.module, mesh, 2,
                                   lr=0.05, data_axis="data", local_engine=engine, comm=comm,
                                   reorder=reorder)
        spmd["params"][engine, comm] = jax.tree_util.tree_map(np.asarray, ctx.params)
        losses = [R.run_steps(ctx, 1)[1] for _ in range(5)]
        ref[engine, comm] = {"losses": losses, "hops": np.asarray(R.ensure_hops(ctx))}

    e_ds = planetoid_like(num_node=600, num_classes=4, num_features=48, seed=0,
                          train_per_class=20, num_val=100, num_test=200)
    e_adj = sym_norm(e_ds.adj, 0.5)
    e_kw = dict(model_name="sgc", prop_steps=3, hidden_dim=32)
    spec = ref_load_model(RefModelConfig(**e_kw), e_ds.num_features, e_ds.num_classes)
    ctx = R.build_spmd_context(e_adj, e_ds.x, e_ds.y, e_ds.train_idx, spec.module, mesh, 3,
                               lr=0.05, data_axis="data", val_idx=e_ds.val_idx,
                               test_idx=e_ds.test_idx)
    epochs = {"adj": e_adj, "x": e_ds.x, "y": np.asarray(e_ds.y), "train_idx": e_ds.train_idx,
              "val_idx": e_ds.val_idx, "test_idx": e_ds.test_idx, "classes": e_ds.num_classes,
              "cfg": ModelConfig(**e_kw),
              "params": jax.tree_util.tree_map(np.asarray, ctx.params)}
    _, res = R.run_epochs_scan(ctx, 60, seed=0)
    ref["epochs"] = res
    return {"spmd": spmd, "epochs": epochs}, ref


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    ds = planetoid_like(num_node=128, num_classes=3, num_features=8, seed=1,
                        train_per_class=4, num_val=8, num_test=8)
    dense = (np.random.default_rng(0).random((128, 128)) < 0.5).astype(np.float32)
    inputs = {"graphs": {2: {e: _engine_input(e, 2) for e in ENGINES}},
              "small": {"adj": sym_norm(ds.adj, 0.5), "x": ds.x, "y": np.asarray(ds.y),
                        "train_idx": ds.train_idx, "classes": ds.num_classes,
                        "dense_adj": sym_norm(sp.csr_matrix(np.maximum(dense, dense.T)), 0.5)}}
    cases = [("prop", "propagate_all", {"d": 2}), ("refusals", "refusals", {})]
    return run_world(tmp_path_factory.mktemp("world2"), 2, inputs, cases, CASE_SOURCES)


@pytest.fixture(scope="module")
def world4(tmp_path_factory, spmd_reference):
    inputs, _ = spmd_reference
    inputs = {**inputs, "graphs": {4: {e: _engine_input(e, 4) for e in ENGINES}}}
    cases = [("prop", "propagate_all", {"d": 4}), ("epochs", "spmd_epochs", {})]
    cases += [(f"spmd_{e}_{c}", "spmd_losses", dict(engine=e, comm=c, reorder=r))
              for e, c, r in SPMD_RUNS]
    return run_world(tmp_path_factory.mktemp("world4"), 4, inputs, cases, CASE_SOURCES)


@pytest.fixture
def world(request):
    return lambda d: request.getfixturevalue({2: "world2", 4: "world4"}[d])


# --- propagation -----------------------------------------------------------------------


def _reference_hops(engine: str, d: int, p, x) -> np.ndarray:
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from ssrg_tpu.parallel import dist_spmm as R
    from ssrg_tpu.parallel import partition as RP

    mesh = _ref_mesh((d,), ("graph",))
    part = _partition((RP, R), engine, p, d)
    if engine == "ring_hybrid":
        xs = jax.device_put(RP.pad_features(x, part), NamedSharding(mesh, PartitionSpec("graph")))
        return np.asarray(R.dist_propagate_ring_hybrid(R.shard_adjacency_ring_hybrid(part, mesh),
                                                       xs, 3, row_block=8))
    xs = R.shard_features(x, part, mesh)
    if engine == "coo":
        return np.asarray(R.dist_propagate(R.shard_adjacency(part, mesh), xs, 3))
    if engine in ("hybrid", "halo"):
        return np.asarray(R.dist_propagate_hybrid(R.shard_adjacency_hybrid(part, mesh), xs, 3))
    if engine == "tiled":
        return np.asarray(R.dist_propagate_tiled(R.shard_adjacency_tiled(part, mesh), xs, 3,
                                                 row_block=8))
    return np.asarray(R.dist_propagate_ring(R.shard_adjacency_ring(part, mesh), xs, 3))


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("engine", ENGINES)
def test_dist_propagate_matches_reference(world, engine, d):
    """Every engine's K = 3 hops at D ranks against the reference's at D
    devices, within the reference's own tolerance against one device; the
    padding rows stay zero."""
    p, x = _engine_input(engine, d)
    got = world(d)[0]["prop"][engine]["hops"]
    want = _reference_hops(engine, d, p, x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(got[:, x.shape[0]:], 0.0, atol=1e-6)
    for r, out in enumerate(world(d)):   # every rank gathers the same, holds its block
        np.testing.assert_array_equal(out["prop"][engine]["hops"], got)
        block = out["prop"][engine]["block_hops"]
        np.testing.assert_array_equal(block, got[:, r * block.shape[1]:(r + 1) * block.shape[1]])


def _assert_tails_equal(got: dict, want, d: int):
    """The rank's tail rows in row order (the C packer writes them in thread
    order), then its padding."""
    arrays = []
    for r, c, v in ((got["tail_rows"], got["tail_cols"], got["tail_vals"]),
                    (want.tail_rows[d], want.tail_cols[d], want.tail_vals[d])):
        r, c, v = (a.reshape(-1, a.shape[-1]) for a in (r, c, v))
        per = []
        for row, col, val in zip(r, c, v):
            real = val != 0
            order = np.argsort(row[real], kind="stable")
            per.append((row[real][order], col[real][order], val[real][order]))
        arrays.append(per)
    for g, w in zip(*arrays):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert got["tail_rows"].shape == want.tail_rows[d].shape


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("engine", ENGINES)
def test_each_rank_holds_its_shard_of_the_reference_partition(world, engine, d):
    """Rank r holds entry r of the reference's partition, array for array."""
    from ssrg_tpu.parallel import dist_spmm as R
    from ssrg_tpu.parallel import partition as RP

    p, _ = _engine_input(engine, d)
    want = _partition((RP, R), engine, p, d)
    for r, out in enumerate(world(d)):
        shard = out["prop"][engine]["shard"]
        for name, got in shard.items():
            if name.startswith("tail_"):
                continue
            ref = getattr(want, name)[r]
            if name == "tiles":
                got = got.astype(np.float32)
            np.testing.assert_array_equal(got, ref, err_msg=f"{engine} rank {r} {name}")
        if "tail_rows" in shard:
            _assert_tails_equal(shard, want, r)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("engine", ENGINES)
def test_exchange_bytes_follow_comm_stats(world, engine, d):
    """The bytes each hop's exchange brings in from the other ranks:
    ``comm_stats``' volume, but for the ring, whose last rotation (the
    reference's, which only brings each block home) is not made."""
    from ssrg_tpu.parallel import dist_spmm as R
    from ssrg_tpu.parallel import partition as RP

    p, x = _engine_input(engine, d)
    part = _partition((RP, R), engine, p, d)
    mode = {"halo": "halo", "ring": "ring", "ring_hybrid": "ring"}.get(engine, "all_gather")
    if engine == "tiled" and d == 4:
        mode = "halo"
    stats = world(d)[0]["prop"][engine]["stats"]
    model = dist_spmm.comm_stats(d, part.block, x.shape[1], 3, mode=mode,
                                 halo_pad=getattr(part, "halo_pad", 0))
    per_hop = model["bytes_per_device_per_hop"]
    if mode == "ring":
        per_hop = per_hop * (d - 1) // d
    assert stats["mode"] == mode and stats["exchange_bytes_per_hop"] == per_hop
    assert len(stats["hop_ms"]) == len(stats["exchange_ms"]) == len(stats["spmm_ms"]) == 3
    assert all(h >= e + m - 1e-6 for h, e, m in zip(stats["hop_ms"], stats["exchange_ms"],
                                                    stats["spmm_ms"]))


# --- the host functions ----------------------------------------------------------------


@pytest.mark.parametrize("num_shards", [2, 4, 8])
def test_partition_rows_ring_equal(num_shards):
    from ssrg_tpu.parallel import dist_spmm as R

    p, _ = _graph(seed=5)
    got = dist_spmm.partition_rows_ring(p, num_shards)
    want = R.partition_rows_ring(p, num_shards)
    for name in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
        assert getattr(got, name).dtype == getattr(want, name).dtype
    assert (got.block, got.n, got.num_shards, got.n_pad) == (want.block, want.n,
                                                            want.num_shards, want.n_pad)
    assert int((got.vals != 0).sum()) == p.nnz


@pytest.mark.parametrize("width", [None, 8])
@pytest.mark.parametrize("num_shards", [2, 4])
def test_partition_rows_ring_hybrid_equal(num_shards, width):
    from ssrg_tpu.parallel import dist_spmm as R

    p, _ = _graph(seed=9)
    got = dist_spmm.partition_rows_ring_hybrid(p, num_shards, width=width)
    want = R.partition_rows_ring_hybrid(p, num_shards, width=width)
    for name in ("ell_cols", "ell_vals"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert (got.block, got.n, got.width, got.tail_chunk) == (want.block, want.n, want.width,
                                                             want.tail_chunk)
    for d in range(num_shards):
        _assert_tails_equal({k: getattr(got, k)[d] for k in ("tail_rows", "tail_cols",
                                                             "tail_vals")}, want, d)
    assert int((got.ell_vals != 0).sum() + (got.tail_vals != 0).sum()) == p.nnz


@pytest.mark.parametrize("mode,halo_pad", [("all_gather", 0), ("ring", 0), ("halo", 96),
                                           ("halo", 0)])
@pytest.mark.parametrize("num_shards,block,feature_dim,prop_steps,itemsize",
                         [(4, 1000, 64, 3, 4), (2, 104, 17, 2, 2), (1, 169_472, 128, 3, 4)])
def test_comm_stats_equal(mode, halo_pad, num_shards, block, feature_dim, prop_steps,
                          itemsize):
    from ssrg_tpu.parallel import dist_spmm as R

    args = (num_shards, block, feature_dim, prop_steps)
    kw = dict(mode=mode, itemsize=itemsize, halo_pad=halo_pad)
    assert dist_spmm.comm_stats(*args, **kw) == R.comm_stats(*args, **kw)


def test_comm_stats_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="unknown comm mode"):
        dist_spmm.comm_stats(2, 8, 4, 1, mode="ppermute")


@pytest.mark.parametrize("num", [0, 512, 1023, 1024, 81920, 3 * 2**20, 5 * 2**30, 7e12])
def test_format_bytes_equal(num):
    from ssrg_tpu.parallel import dist_spmm as R

    assert dist_spmm.format_bytes(num) == R.format_bytes(num)


@pytest.mark.parametrize("num_shards", [1, 3, 8])
def test_dist_propagate_reference_equal(num_shards):
    from ssrg_tpu.parallel import dist_spmm as R
    from ssrg_tpu.parallel import partition as RP

    p, x = _graph(seed=2)
    got = dist_spmm.dist_propagate_reference(partition.partition_rows(p, num_shards), x, 3)
    want = R.dist_propagate_reference(RP.partition_rows(p, num_shards), x, 3)
    np.testing.assert_array_equal(got, want)
    direct = [x]
    for _ in range(3):
        direct.append(p @ direct[-1])
    np.testing.assert_allclose(got[:, : x.shape[0]], np.stack(direct), rtol=3e-5, atol=3e-5)


# --- SPMD training ---------------------------------------------------------------------


@pytest.mark.parametrize("engine,comm,reorder", SPMD_RUNS)
def test_spmd_run_steps_match_the_reference(world4, spmd_reference, engine, comm, reorder):
    """GAMLP on a (graph 2, data 2) mesh from the reference's initial
    parameters, dropout 0: five full steps' losses within 1e-5 relative of
    the reference's, the same on every rank, and the hops the reference's."""
    ref = spmd_reference[1][engine, comm]
    outs = [o[f"spmd_{engine}_{comm}"] for o in world4]
    np.testing.assert_allclose(outs[0]["losses"], ref["losses"], rtol=1e-5)
    for out in outs[1:]:
        assert out["losses"] == outs[0]["losses"]
    np.testing.assert_allclose(outs[0]["hops"], ref["hops"], rtol=3e-5, atol=3e-5)
    # each rank trains on its quarter of the rows: (graph, data) in row-major order
    rows = [o["head_rows"] for o in outs]
    quarter = rows[0][1] - rows[0][0]
    assert rows == [((r % 2) * quarter, (r % 2 + 1) * quarter) for r in range(4)]


def test_spmd_epochs_match_the_reference(world4, spmd_reference):
    """``run_epochs_scan`` (SGC, 60 epochs, best val → test) within 0.06 of
    the reference's; ``evaluate`` and ``run_multi``'s protocol."""
    ref = spmd_reference[1]["epochs"]
    outs = [o["epochs"] for o in world4]
    got = outs[0]
    assert abs(got["best_val"] - ref.best_val) <= 0.06
    assert abs(got["best_test"] - ref.best_test) <= 0.06
    assert got["best_test"] > 0.8                         # the SBM is separable
    assert [h.shape for h in got["history"]] == [(60,)] * 3
    assert got["history"][0][-1] < got["history"][0][0]
    assert got["final_loss"] == got["history"][0][-1]
    assert got["best_val"] == got["history"][1].max()
    assert got["best_epoch"] == int(np.argmax(got["history"][1]))
    assert set(got["evaluate"]) == {"train_acc", "val_acc", "test_acc"}
    assert got["evaluate"]["train_acc"] > 0.8
    assert len(got["runs"]) == 2 and 0.0 < got["mean_std"][2] <= 1.0
    for out in outs[1:]:
        np.testing.assert_array_equal(out["history"][0], got["history"][0])
        assert out["evaluate"] == got["evaluate"]


@pytest.mark.parametrize("what,match", [
    ("unknown_comm", "unknown comm"),
    ("halo_coo", "requires local_engine"),
    ("unknown_engine", "unknown local_engine"),
    ("unknown_reorder", "unknown reorder"),
    ("eval_masks", "val_idx"),
    ("batch_norm", "BatchNorm"),
    ("shape", "does not cover"),
    ("names", "rank mismatch"),
    ("shards", "has size 2"),
])
def test_refusals(world2, what, match):
    """The reference's errors (``ValueError`` with its words), the mesh's,
    and the port's refusal of a BatchNorm head, on every rank."""
    for out in world2:
        assert out["refusals"][what] is not None and match in out["refusals"][what], what


def test_run_steps_zero_is_a_noop_and_one_step_is_finite(world2):
    for out in world2:
        assert np.isnan(out["refusals"]["zero_steps"])
        assert np.isfinite(out["refusals"]["one_step"])
    assert world2[0]["refusals"]["one_step"] == world2[1]["refusals"]["one_step"]


def test_saturated_halo_plan_warns(world2):
    """A density-0.5 graph saturates the halo plan (halo_pad == block), and
    ``build_spmd_context`` says so, as the reference does."""
    for out in world2:
        assert out["refusals"]["saturated"] == (True, True)


def test_bn_head_fails_in_the_reference_at_its_first_step():
    """What the port's refusal stands for: the reference builds the context
    of a BatchNorm head and fails at its first step."""
    from ssrg_tpu.configs.config import ModelConfig
    from ssrg_tpu.models.zoo import load_model
    from ssrg_tpu.parallel.dist_train import build_spmd_context, run_steps

    ds, adj = _spmd_dataset()
    spec = load_model(ModelConfig(model_name="gamlp", prop_steps=1, num_layers=2, hidden_dim=8,
                                  use_bn=True), ds.num_features, ds.num_classes)
    ctx = build_spmd_context(adj, ds.x, ds.y, ds.train_idx, spec.module,
                             _ref_mesh((2,), ("graph",)), 1)
    with pytest.raises(Exception, match="batch_stats"):
        run_steps(ctx, 1)


# --- on the card -----------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_world_of_one_nccl_rank_matches_propagate(cuda_device):
    """A world of one NCCL rank in this process: every engine's hops
    against in-core ``propagate`` on the card, and the ELL kernel launched
    once a hop by the hybrid engines."""
    import torch.distributed as dist

    from ssrg_torch.ops.ell_spmm import ell_spmm
    from ssrg_torch.ops.propagate import propagate
    from ssrg_torch.ops.sparse import device_adjacency
    from ssrg_torch.parallel.mesh import make_mesh

    p, x = _graph(n=20_000, f=32, seed=3)
    mesh = make_mesh((1,), ("graph",), device="cuda")
    assert dist.get_backend() == "nccl" and mesh.device.type == "cuda"
    want = propagate(device_adjacency(p, "hybrid", device="cuda"), x, 3, device="cuda")
    for engine in ("coo", "hybrid", "halo", "ring", "ring_hybrid"):
        part = _partition((partition, dist_spmm), engine, p, 1)
        place, fn = _engine_fns(dist_spmm)[engine]
        ell_spmm.launches = 0
        hops = fn(place(part, mesh), dist_spmm.shard_features(x, part, mesh), 3)
        torch.cuda.synchronize()
        assert ell_spmm.launches == (0 if engine in ("coo", "ring") else 3), engine
        assert float((hops[:, : x.shape[0]] - want).abs().max()) <= 1e-4, engine
    dist.destroy_process_group()
