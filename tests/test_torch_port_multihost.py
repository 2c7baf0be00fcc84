"""Per-rank spool loading into SPMD training (``ssrg_torch/parallel/multihost.py``)
against ``ssrg_tpu.parallel.multihost``, on the CPU.

A spool the reference wrote (4 shards) feeds the port's ranks in a world of 4
``gloo`` processes, and one the port wrote (2 shards) a world of 2 that joins
through :func:`initialize_multihost` itself; the JAX side runs here on the
conftest's fake CPU devices, jax imported inside the tests only. The worlds
come from :func:`test_torch_port_dist.run_world`.
"""

import os
import os.path as osp

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import torch.distributed as dist

from ssrg_torch.data import streaming
from ssrg_torch.data.synthetic import sbm_graph
from ssrg_torch.ops.normalize import sym_norm
from ssrg_torch.parallel import multihost

from test_torch_port_dist import run_world

SPOOL_RUNS = (("coo", "all_gather"), ("hybrid", "all_gather"), ("hybrid", "halo"))

_JOIN_MULTIHOST = '''
from ssrg_torch.parallel.multihost import initialize_multihost
assert initialize_multihost(f"file://{ROOT}/store", WORLD, RANK, device="cpu",
                            timeout=timedelta(seconds=100))
'''


# --- the torch side's cases (sources sent to the ranks) --------------------------------


def _meta(fields):
    from ssrg_torch.data.streaming import StreamingGraphMeta

    return StreamingGraphMeta(**fields)


def _module(num_classes, feat_dim):
    from ssrg_torch.models.heads import LogisticRegression
    from ssrg_torch.models.zoo import PrecomputeModel
    from ssrg_torch.ops.combine import make_message_op

    return PrecomputeModel(msg_op=make_message_op("mean"),
                           head=LogisticRegression(feat_dim, num_classes))


def spool_contexts(inputs, engine, comm):
    """The spool-fed and the in-memory contexts on a 4-rank graph mesh from
    the reference's initial parameters: three losses each, and the hops."""
    from ssrg_torch.convert import params_from_jax
    from ssrg_torch.parallel.dist_spmm import all_gather_hops
    from ssrg_torch.parallel.dist_train import build_spmd_context, ensure_hops, run_steps
    from ssrg_torch.parallel.mesh import make_mesh
    from ssrg_torch.parallel.multihost import build_spmd_context_from_spool

    s = inputs["spool4"]
    mesh = make_mesh((4,), ("graph",), device="cpu")
    classes, feat_dim = int(s["y"].max()) + 1, s["x"].shape[1]
    state = params_from_jax(s["params"][engine, comm])
    out = {}
    for kind in ("spool", "memory"):
        if kind == "spool":
            ctx = build_spmd_context_from_spool(
                _meta(s["meta"]), s["features"], s["y"], s["train_idx"],
                _module(classes, feat_dim), mesh, prop_steps=2, lr=0.05, seed=0,
                local_engine=engine, comm=comm)
            out["send_idx"] = getattr(ctx.adj, "halo_pad", 0) > 0
        else:
            ctx = build_spmd_context(s["adj"], s["x"], s["y"], s["train_idx"],
                                     _module(classes, feat_dim), mesh, prop_steps=2, lr=0.05,
                                     seed=0)
        ctx.module.load_state_dict(state)
        hops = all_gather_hops(ensure_hops(ctx), mesh, axis=None)[:, : s["x"].shape[0]]
        out[kind] = {"losses": [run_steps(ctx, 1, seed=0)[1] for _ in range(3)],
                     "hops": hops.numpy()}
    return out


def spool_epochs(inputs):
    """The spool-fed context (hybrid, halo) trained by ``run_epochs_scan``
    and evaluated."""
    from ssrg_torch.parallel.dist_train import evaluate, run_epochs_scan
    from ssrg_torch.parallel.mesh import make_mesh
    from ssrg_torch.parallel.multihost import build_spmd_context_from_spool

    s = inputs["spool4"]
    n = s["x"].shape[0]
    mesh = make_mesh((4,), ("graph",), device="cpu")
    ctx = build_spmd_context_from_spool(
        _meta(s["meta"]), s["features"], s["y"], np.arange(0, n, 3),
        _module(int(s["y"].max()) + 1, s["x"].shape[1]), mesh, prop_steps=2, lr=0.1, seed=0,
        local_engine="hybrid", comm="halo", val_idx=np.arange(1, n, 3),
        test_idx=np.arange(2, n, 3))
    ctx, res = run_epochs_scan(ctx, 30, seed=0)
    return {"best_val": res.best_val, "final_loss": res.final_loss, "evaluate": evaluate(ctx)}


def streamed_propagate(inputs):
    """The streamed partition, assembled on every rank, through
    ``shard_adjacency`` and ``dist_propagate`` on 4 ranks."""
    from ssrg_torch.data.streaming import assemble_row_partition
    from ssrg_torch.parallel.dist_spmm import (all_gather_hops, dist_propagate,
                                               shard_adjacency, shard_features)
    from ssrg_torch.parallel.mesh import make_mesh

    s = inputs["spool4"]
    mesh = make_mesh((4,), ("graph",), device="cpu")
    part = assemble_row_partition(_meta(s["meta"]))
    hops = dist_propagate(shard_adjacency(part, mesh), shard_features(s["x"], part, mesh), 2)
    return all_gather_hops(hops, mesh).numpy()


def node_values(inputs):
    """``shard_node_values`` over (graph, data) and over graph only, and
    ``replicate``, on a (2, 2) mesh."""
    from ssrg_torch.parallel.mesh import make_mesh
    from ssrg_torch.parallel.multihost import replicate, shard_node_values

    s = inputs["spool4"]
    meta = _meta({**s["meta"], "num_shards": 2, "block": s["meta"]["block"] * 2})
    mesh = make_mesh((2, 2), ("graph", "data"), device="cpu")
    tree = replicate({"a": np.arange(6.0).reshape(2, 3), "b": [np.ones(2), torch.zeros(1)]},
                     mesh)
    return {"both": shard_node_values(s["y"], meta, mesh, ("graph", "data")).numpy(),
            "graph": shard_node_values(s["y"], meta, mesh).numpy(),
            "coords": mesh.coords,
            "tree": {"a": tree["a"].numpy(), "b": [t.numpy() for t in tree["b"]]}}


def two_process_run(inputs):
    """The 2-process counterpart of the reference's multi-host run: each rank
    loads its own shard of a 2-shard spool (hybrid, halo) and takes two
    full steps; the spool against a mesh of the wrong size is refused."""
    from ssrg_torch.parallel.dist_train import run_steps
    from ssrg_torch.parallel.multihost import (build_spmd_context_from_spool, global_mesh,
                                               shard_adjacency_from_spool)

    s = inputs["spool2"]
    mesh = global_mesh((2,), ("graph",), device="cpu")
    ctx = build_spmd_context_from_spool(
        _meta(s["meta"]), s["features"], s["y"], np.arange(0, s["y"].shape[0], 3),
        _module(int(s["y"].max()) + 1, s["feat_dim"]), mesh, prop_steps=2, lr=0.05, seed=0,
        local_engine="hybrid", comm="halo")
    ctx, loss = run_steps(ctx, 2, seed=0)
    try:
        shard_adjacency_from_spool(_meta(inputs["spool4"]["meta"]), mesh)
        refused = None
    except ValueError as exc:
        refused = str(exc)
    return {"loss": loss, "halo": ctx.adj.send_idx is not None, "world": mesh.world_size,
            "refused": refused}


CASE_SOURCES = [_meta, _module, spool_contexts, spool_epochs, streamed_propagate, node_values,
                two_process_run]


# --- the spools and the worlds ---------------------------------------------------------


def _write_graph(root):
    g = sbm_graph(num_node=240, num_classes=3, num_features=16, p_in=0.05, p_out=0.005,
                  feature_signal=1.0, seed=1)
    pairs = np.unique(np.sort(np.stack([g.edge.row, g.edge.col], axis=1), axis=1), axis=0)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    np.save(root / "edges.npy", pairs.T.astype(np.int64))
    np.save(root / "features.npy", g.x.astype(np.float32))
    adj = sp.csr_matrix((np.ones(pairs.shape[0] * 2),
                         (np.concatenate([pairs[:, 0], pairs[:, 1]]),
                          np.concatenate([pairs[:, 1], pairs[:, 0]]))),
                        shape=(g.num_node, g.num_node))
    return g, pairs, sym_norm(adj, 0.5)


def _fields(meta):
    return dict(num_nodes=meta.num_nodes, num_edges=meta.num_edges, block=meta.block,
                num_shards=meta.num_shards, spool_dir=meta.spool_dir)


@pytest.fixture(scope="module")
def spooled(tmp_path_factory):
    """The reference's spool (4 shards) of the reference test's graph, its
    contexts' initial parameters and losses (mesh of 4), and the port's
    2-shard spool of the same graph."""
    import jax

    from ssrg_tpu.data.streaming import stream_partition as ref_stream_partition
    from ssrg_tpu.models.heads import LogisticRegression
    from ssrg_tpu.models.zoo import PrecomputeModel
    from ssrg_tpu.ops.combine import make_message_op
    from ssrg_tpu.parallel.dist_train import run_steps
    from ssrg_tpu.parallel.mesh import make_mesh
    from ssrg_tpu.parallel.multihost import build_spmd_context_from_spool

    root = tmp_path_factory.mktemp("spool")
    g, pairs, adj = _write_graph(root)
    meta = ref_stream_partition(str(root / "edges.npy"), g.num_node, 4, str(root / "spool4"))
    mesh = make_mesh((4,), ("graph",), jax.devices()[:4])
    train_idx = np.arange(0, g.num_node, 3)
    y = np.asarray(g.y, np.int64)
    params, ref = {}, {}
    for engine, comm in SPOOL_RUNS:
        module = PrecomputeModel(msg_op=make_message_op("mean"),
                                 head=LogisticRegression(output_dim=int(y.max()) + 1))
        ctx = build_spmd_context_from_spool(meta, str(root / "features.npy"), y, train_idx,
                                            module, mesh, prop_steps=2, lr=0.05, seed=0,
                                            local_engine=engine, comm=comm)
        params[engine, comm] = jax.tree_util.tree_map(np.asarray, ctx.params)
        ref[engine, comm] = [run_steps(ctx, 1, seed=0)[1] for _ in range(3)]
    meta2 = streaming.stream_partition(str(root / "edges.npy"), g.num_node, 2,
                                       str(root / "spool2"))
    inputs = {
        "spool4": {"meta": _fields(meta), "features": str(root / "features.npy"), "y": y,
                   "x": g.x.astype(np.float32), "adj": adj, "train_idx": train_idx,
                   "params": params},
        "spool2": {"meta": _fields(meta2), "features": str(root / "features.npy"), "y": y,
                   "feat_dim": g.x.shape[1]},
    }
    return root, inputs, ref, g, pairs


@pytest.fixture(scope="module")
def world4(tmp_path_factory, spooled):
    _, inputs, _, _, _ = spooled
    cases = [(f"{e}_{c}", "spool_contexts", dict(engine=e, comm=c)) for e, c in SPOOL_RUNS]
    cases += [("epochs", "spool_epochs", {}), ("streamed", "streamed_propagate", {}),
              ("values", "node_values", {})]
    return run_world(tmp_path_factory.mktemp("mh_world4"), 4, inputs, cases, CASE_SOURCES)


@pytest.fixture(scope="module")
def world2(tmp_path_factory, spooled):
    _, inputs, _, _, _ = spooled
    return run_world(tmp_path_factory.mktemp("mh_world2"), 2, inputs,
                     [("run", "two_process_run", {})], CASE_SOURCES, join=_JOIN_MULTIHOST)


# --- the tests -------------------------------------------------------------------------


@pytest.mark.parametrize("engine,comm", SPOOL_RUNS)
def test_spool_context_matches_the_reference(world4, spooled, engine, comm):
    """Each rank loads only its shard of the reference's spool; from the
    reference's initial parameters the three losses are the reference's
    within 1e-5 relative, and the same on every rank."""
    ref = spooled[2][engine, comm]
    outs = [o[f"{engine}_{comm}"] for o in world4]
    np.testing.assert_allclose(outs[0]["spool"]["losses"], ref, rtol=1e-5)
    for out in outs[1:]:
        assert out["spool"]["losses"] == outs[0]["spool"]["losses"]
    assert all(o["send_idx"] == (comm == "halo") for o in outs)


@pytest.mark.parametrize("engine,comm", SPOOL_RUNS)
def test_spool_context_matches_inmemory(world4, engine, comm):
    """The spool-fed context against the in-memory one on the same graph:
    hops within 1e-5, losses within the reference test's 2e-4."""
    out = world4[0][f"{engine}_{comm}"]
    np.testing.assert_allclose(out["spool"]["hops"], out["memory"]["hops"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(out["spool"]["losses"], out["memory"]["losses"], rtol=2e-4,
                               atol=2e-5)
    assert np.isfinite(out["spool"]["losses"]).all()


def test_spool_context_epoch_scan_eval(world4):
    for out in world4:
        got = out["epochs"]
        assert np.isfinite(got["final_loss"])
        assert got["best_val"] > 0.5                      # separable SBM
        assert got["evaluate"]["test_acc"] > 0.5
        assert got == world4[0]["epochs"]


def test_streamed_partition_feeds_dist_propagate(world4, spooled):
    """Spools -> the assembled partition -> ``dist_propagate`` on 4 ranks ==
    scipy on the normalized graph."""
    _, inputs, _, g, pairs = spooled
    n = g.num_node
    hops = world4[0]["streamed"]
    x = inputs["spool4"]["x"]
    direct = [x]
    for _ in range(2):
        direct.append((inputs["spool4"]["adj"] @ direct[-1]).astype(np.float32))
    for i in range(3):
        np.testing.assert_allclose(hops[i][:n], direct[i], rtol=2e-4, atol=2e-4)
    for out in world4[1:]:
        np.testing.assert_array_equal(out["streamed"], hops)


def test_shard_node_values_and_replicate(world4, spooled):
    y = spooled[1]["spool4"]["y"]
    block = spooled[1]["spool4"]["meta"]["block"] * 2
    y_pad = np.zeros(2 * block, y.dtype)
    y_pad[: y.shape[0]] = y
    quarter = block // 2
    for r, out in enumerate(world4):
        got = out["values"]
        assert got["coords"] == {"graph": r // 2, "data": r % 2}
        np.testing.assert_array_equal(got["both"], y_pad[r * quarter:(r + 1) * quarter])
        g = r // 2
        np.testing.assert_array_equal(got["graph"], y_pad[g * block:(g + 1) * block])
        np.testing.assert_array_equal(got["tree"]["a"], np.arange(6.0).reshape(2, 3))
        assert [t.tolist() for t in got["tree"]["b"]] == [[1.0, 1.0], [0.0]]


def test_two_process_run(world2):
    """Two processes joined by ``initialize_multihost`` through a ``file://``
    store, each loading its own shard of the port's spool: the same finite
    loss on both."""
    losses = [out["run"]["loss"] for out in world2]
    assert np.isfinite(losses[0]) and losses[0] == losses[1]
    assert all(out["run"]["halo"] and out["run"]["world"] == 2 for out in world2)


def test_shard_count_mismatch_raises(world2):
    for out in world2:
        assert "re-spool with num_shards=2" in out["run"]["refused"]


def test_spool_nnz_pad_equal(spooled):
    from ssrg_tpu.parallel.multihost import spool_nnz_pad as ref_spool_nnz_pad

    from ssrg_tpu.data.streaming import StreamingGraphMeta as RefMeta

    for key in ("spool4", "spool2"):
        fields = spooled[1][key]["meta"]
        for align in (8, 512):
            assert (multihost.spool_nnz_pad(streaming.StreamingGraphMeta(**fields), align)
                    == ref_spool_nnz_pad(RefMeta(**fields), align))


@pytest.fixture
def clean_env(monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK",
                 "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES"):
        monkeypatch.delenv(name, raising=False)
    assert not dist.is_initialized()


def test_initialize_multihost_single_process_noop(clean_env):
    assert multihost.initialize_multihost() is False
    assert multihost.initialize_multihost(num_processes=1) is False
    assert not dist.is_initialized()


def test_initialize_multihost_needs_the_whole_address(clean_env, monkeypatch):
    with pytest.raises(ValueError, match="coordinator address"):
        multihost.initialize_multihost(num_processes=2)
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "1")
    with pytest.raises(ValueError, match="coordinator address"):
        multihost.initialize_multihost()            # no WORLD_SIZE or RANK
    assert not dist.is_initialized()


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")


def test_cuda_without_a_card_raises(clean_env, no_cuda, tmp_path):
    """No fallback: asking for the card without one raises before any world
    is joined, from the mesh and from the multi-host entry."""
    from ssrg_torch.parallel.mesh import make_mesh

    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh((1,), ("graph",))
    with pytest.raises(RuntimeError, match="cuda"):
        multihost.initialize_multihost(f"file://{tmp_path}/store", 2, 0)
    assert not dist.is_initialized()
    assert not os.path.exists(osp.join(tmp_path, "store"))
