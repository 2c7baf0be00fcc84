#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ssrg_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--trace_dir DIR]

Phases, each printing JSON lines:

1. build    — ``nvcc`` builds every kernel of the port from
              ``ssrg_torch/csrc``, one process per source, all at once.
   native   — ``c++`` builds the host library (``csrc/graphbuild.cpp``);
              its label propagation on the 169,343-node community graph
              held equal to the numpy version's, its ELL/hybrid packer to
              the numpy packer's on the headline and power-law graphs, all
              timed, beside the OpenMP thread count.
   kernels  — every kernel of ``tools/kernels.py``'s table (ELL, COO,
              banded on both paths, rest, the GAT attention and score
              steps, the per-edge steps of UniMP's attention on its cell's
              listing) with the source's own constants, on each of the
              table's cases: each step held to its plain version within
              the kernel's sum-order tolerance, then timed beside it, a
              library call and its bound (the tool's records).
2. slice    — the serving path at full width: GAMLP (hidden 256, 3 layers,
              K = 3, 40 classes) on a 169,343-node, F = 128 random graph,
              through ``Predictor`` with ``engine="auto"`` (hybrid), random
              weights from a seeded ``torch.Generator``; the kernel's launch
              count, hop K against float64 scipy, and three request sizes,
              each asked once and then five times more.
3. locality — the locality tier on two 169,343-node, F = 128 graphs: a
              banded graph with shuffled ids (RCM finds the band) and
              ``community_graph`` (label propagation finds the clusters).
              Each layer of the reorder path timed alone; GAMLP through
              ``Predictor`` with ``reorder_banded`` (f32, bf16) and
              ``reorder_tiled`` + ``spmm_bf16``, each with its kernel's
              launch count (the banded kernel's by path), hop K against
              float64 scipy and the requests; each ``prepare`` beside the
              5 s limit.
4. train    — training through ``NodeClassification`` on a 169,343-node,
              F = 128, 40-class SBM with ogbn-arxiv's split sizes: GAMLP at
              full width (minibatches of 10,000, batched evaluation, a
              checkpoint at every new best, served again by ``Predictor``),
              and the naive GCN (hidden 256, full graph), whose two layers
              run the ELL kernel forward and, under autograd, backward on
              the pack of A^T. Checks: the kernel's launches in ``prepare``
              and per epoch, finite and falling losses, the accuracy the
              checkpoint recorded served again, and fc1's gradient against
              autograd through the plain version. Three more GCN epochs
              under ``device_trace``: their top device operations and the
              device-busy share.
5. spectral — the spectral and directed-operator models on the ELL kernel:
              a directed graph at ogbn-arxiv's size (169,343 nodes,
              1,166,243 directed edges, F = 128, 40 classes) trains magnet
              (complex propagation, 12 launches a ``prepare``, hop K held to
              float64 scipy, served through ``Predictor``) and two_dir
              (un/in/out packs, 9 launches); two_order at Cora's size (dense
              engine, its eigendecomposition timed); wavelet at PubMed's
              (19,717 nodes): the Chebyshev construction's 120 launches at
              F = 1,024, training with the kernel forward and backward on the
              packs of Φᵀ and Φ⁻ᵀ (8 launches an epoch, conv1's gradient held
              to the plain version within a first-order bound), and the GWNN
              trainer.
6. robust   — the robustness pipeline at ogbn-arxiv's size
              (``planetoid_like(**TRAIN_GRAPH)``): ``sparsify_dataset`` at
              ``DataProcessConfig``'s rates (0.6, 0.6) into a temporary
              directory (the masked share within 5 sigma, the kept
              half-edges exact), the port's ``.pt`` loader and homophily
              statistics, ``augment_dataset`` at ``DataAugmentConfig``'s
              defaults (the encoder on the card and the host's edge
              completion timed apart; F = 256 + 40, soft labels summing to
              1, every degree >= 1); GAMLP through ``NodeClassification`` on
              the augmented graph (3 launches at F = 296, hop K against
              float64 scipy); ``link_dataset_from_graph`` and two
              ``LinkClassification`` runs: the GCN's link head (both SpMMs
              at F = 256 on the observed-edge pack, 8 launches an epoch,
              fc1's gradient within its first-order bound) and GAMLP's (3 in
              ``prepare``).
7. baseline — the message-passing baselines through ``BaselineTask`` on the
              ``train`` graph: GCN and SAGE (3 layers x 256; the ELL kernel
              forward and, on the pack of A^T, backward: 9 and 8 launches an
              epoch, the first layer's gradient within its first-order
              bound), GAT (2 layers, 8 heads of 64, the score kernels and
              none of the attention's; held to a float64 dense oracle on a
              2,000-node subgraph), MLP, robust MLP with the
              triplet term, SGC and SIGN (K = 3 on the kernel in
              ``prepare``); the published GAT (3 layers, 4 heads of 128,
              skip linears, bias, self-loops) on the attention kernels, 12,
              6, 3 and 3 launches an epoch of the statistics, weighted sum,
              row dot and backward kernels, and 6, 3 and 3 of the scores,
              their gradient and its sum; then the GCN on 128 cluster
              parts, 8 a batch.
              Each: ``prepare`` seconds, epoch and evaluation times, peak
              device memory, launches checked, best val >= 0.25.
8. ooc      — single-card out-of-core: the ``train`` graph written as
              ``.npy`` files, spooled into 8 shards, K = 3 hops block at a
              time (both schedules, the ``coo`` engine, the bf16 transfer)
              held to the in-core hybrid ``propagate``, ELL launches per hop
              equal to the non-empty buckets, ``dest_outer``'s device memory
              within an O(block*F + bucket) bound; ``run_outofcore`` SGC and
              GAMLP on the artifacts.
9. dist     — the distributed tier on ``torch.distributed`` over the
              ``train`` graph, on a world of one NCCL rank in this process
              (``phase_dist(ranks=4)`` runs one process per card on four):
              K = 3 hops through ``dist_propagate`` (coo),
              ``dist_propagate_hybrid`` (all-gather and halo),
              ``dist_propagate_tiled`` (cluster-renumbered, halo),
              ``dist_propagate_ring`` and ``dist_propagate_ring_hybrid``, each
              held to in-core ``propagate`` with its ELL launches a hop
              checked and its hops timed (exchange and local SpMM apart,
              beside the bytes moved and ``comm_stats``); GAMLP through
              ``build_spmd_context`` + ``run_epochs_scan`` (20 epochs, hops
              against ``NodeClassification``'s precompute), and the graph
              spooled and loaded by ``build_spmd_context_from_spool``.
10. cli     — runs after ``dist`` (no process group live) and before
              ``bench``: ``ssrg_torch.cli.main`` in this process on the
              ``train`` graph written as a ``.pt`` dataset directory
              (``sparsify_dataset`` at rates 0, 0): ``train`` (GAMLP 3 x 256,
              minibatches of 10,000, 20 epochs, a checkpoint; best val >=
              0.25), ``predict`` from that checkpoint (the test split's
              48,603 labels equal to a ``Predictor`` built here), ``spmd`` at
              its defaults (tiled, halo, cluster) on a world of one NCCL rank
              that it ends, and ``bench`` at its defaults (nnz and every rate
              checked); each command's launches counted (ELL 3 for train,
              predict and spmd; the bench's three runs of each tier).
11. bench   — ``ssrg_torch.bench.run_bench()`` at its defaults (169,343
              nodes, degree 13.7, F = 128, K = 3, 10 iterations): its JSON
              line, each tier's kernel launches (headline and sharded: ELL,
              clustered: rest, banded: banded, all on its tensor-core path)
              and the headline hops traced with ``device_trace``.

The ``cuda`` tests hold the kernels on ragged and full-size cases too, and
``tools/kernels.py`` times variants of their constants. ``--trace_dir``
keeps the three Chrome traces (default: a temporary directory). Then a
``{"kernels": [...]}`` line (each step's time, plain time, bound and
largest error), the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Any failed check raises and the script
exits non-zero without that line; without a CUDA card it exits 2, and
without ``tools/card.py`` and the ``ssrg_torch`` package beside it, before
printing anything.
"""

from __future__ import annotations

import argparse
import copy
import json
import logging
import os
import platform
import sys
import tempfile
import time

import numpy as np

# last on the path, so that no file of tools/ shadows another top-level name
sys.path.append(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
from card import (  # noqa: E402  (tools/card.py)
    AVG_DEGREE, NUM_CLASSES, NUM_FEATURES, NUM_NODES, SEED, TRAIN_GRAPH, UNIT_ROUNDOFF,
    banded_dataset, card_line, check, community_dataset, cuda_ms, emit,
)

PREPARE_LIMIT_S = 5.0         # PERF.md section 2: prepare at 169,343 nodes
BENCH_NNZ = 2_489_237         # the headline graph's edges at the bench's defaults
KERNELS = ("ell_spmm", "banded_spmm", "rest_spmm")
# (run, graph, spmm_engine, spmm_bf16, the kernel the run's path launches)
LOCALITY_RUNS = (
    ("banded_f32", "banded", "reorder_banded", False, "banded_spmm"),
    ("banded_bf16", "banded", "reorder_banded", True, "banded_spmm"),
    ("tiled_bf16", "community", "reorder_tiled", True, "rest_spmm"),
)


def kernel_wrappers() -> dict:
    """Each kernel's wrapper by name; ``.launches`` is its launch count."""
    from ssrg_torch.ops.banded_spmm import banded_spmm
    from ssrg_torch.ops.ell_spmm import ell_spmm
    from ssrg_torch.ops.rest_spmm import rest_spmm

    return {"ell_spmm": ell_spmm, "banded_spmm": banded_spmm, "rest_spmm": rest_spmm}


def reset_launches() -> None:
    from ssrg_torch.ops.gat_attention import gat_attention

    for fn in kernel_wrappers().values():
        fn.launches = 0
    banded = kernel_wrappers()["banded_spmm"]
    banded.path_launches = dict.fromkeys(banded.path_launches, 0)
    gat_attention.kernel_launches = dict.fromkeys(gat_attention.kernel_launches, 0)


def read_launches() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def banded_paths() -> dict:
    """The banded kernel's launches by path (``stream``, ``tensor_core``)."""
    return dict(kernel_wrappers()["banded_spmm"].path_launches)


def check_banded_paths(what: str, got: dict, tensor_core: int, stream: int = 0) -> None:
    """Every bf16 pack goes through the tensor-core path, every f32 pack
    through the stream path."""
    want = {"stream": stream, "tensor_core": tensor_core}
    check(got == want, f"{what}: the banded kernel's launches by path {got}, expected {want}")


def seeded_gamlp(num_features: int):
    """GAMLP at ``ModelConfig`` defaults with weights from a seeded
    ``torch.Generator``: the config, the spec and a copy of its weights."""
    import torch

    from ssrg_torch.configs.config import ModelConfig
    from ssrg_torch.models.zoo import load_model

    cfg = ModelConfig(model_name="gamlp")
    spec = load_model(cfg, num_features, NUM_CLASSES)
    spec.module.reset_parameters(torch.Generator().manual_seed(SEED))
    return cfg, spec, {k: v.clone() for k, v in spec.module.state_dict().items()}


REPEATS = 5  # samples of each request size after its first


def serve_requests(pred, what: str) -> list:
    """Requests of 1, 1,000 and 4,096 random ids, each asked once and then
    ``REPEATS`` times more, every call timed on the host clock: shapes,
    finite logits, ``predict == argmax`` and bit-identical repeats checked."""
    import torch

    rng = np.random.default_rng(SEED)
    requests = []
    for n in (1, 1000, 4096):
        ids = rng.integers(0, NUM_NODES, size=n)
        t1 = time.perf_counter()
        logits = pred.logits(ids)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t1) * 1e3
        repeat_ms = []
        for _ in range(REPEATS):
            t1 = time.perf_counter()
            again = pred.logits(ids)
            torch.cuda.synchronize()
            repeat_ms.append((time.perf_counter() - t1) * 1e3)
            check(torch.equal(logits, again), f"{what}: a repeated request changed its logits")
        labels = pred.predict(ids)
        check(tuple(logits.shape) == (n, NUM_CLASSES),
              f"{what}: logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), f"{what}: logits not finite")
        check(torch.equal(labels, logits.argmax(dim=-1)), f"{what}: predict != argmax(logits)")
        requests.append({"n": n, "first_ms": first_ms, "repeat_ms": repeat_ms,
                         "repeat_median_ms": float(np.median(repeat_ms)),
                         "ids": ids, "logits": logits})
    return requests


def request_times(requests: list) -> list:
    return [{k: r[k] for k in ("n", "first_ms", "repeat_ms", "repeat_median_ms")}
            for r in requests]


def phase_build() -> None:
    """Build every kernel from its source, one ``nvcc`` each, all at once."""
    from ssrg_torch.ops import _nvcc

    names = (*KERNELS, "coo_spmm", "gat_attention")  # these two replace no TPU kernel
    t0 = time.perf_counter()
    logs = _nvcc.build(names, force=True, extra_flags=["-Xptxas=-v"])
    seconds = time.perf_counter() - t0
    for name in names:
        ptxas = [ln.strip() for ln in logs[name].splitlines()
                 if "registers" in ln or "spill" in ln]
        emit({"phase": "build", "source": f"ssrg_torch/csrc/{name}.cu",
              "seconds_all": seconds, "ptxas": ptxas})


def build_native() -> dict:
    """Build the host library from its source and load that build, before
    anything of the port has loaded a library (a copied tree may hold an
    older one): the ``native`` phase's first fields."""
    from ssrg_torch import native
    from ssrg_torch.ops import _nvcc

    check(native._lib is None, "the host library was loaded before its build")
    t0 = time.perf_counter()
    _nvcc.build_host(native.LIBRARY, force=True)
    native.load_library()
    return {"phase": "native", "source": f"ssrg_torch/csrc/{native.LIBRARY}.cpp",
            "build_s": time.perf_counter() - t0, "compiler_flags": _nvcc.CXX_FLAGS,
            "omp_max_threads": native.omp_max_threads(),
            # the host the host times were taken on
            "host": {"machine": platform.machine(), "cpus": os.cpu_count(),
                     "cpus_usable": len(os.sched_getaffinity(0))}}


def phase_native(rec: dict, packer_inputs: dict) -> None:
    """The host library (built by :func:`build_native`, whose fields
    ``rec`` holds) on the path's host work: its label propagation on the
    full community graph (normalized, as ``reorder_tiled``'s ``prepare``
    clusters it) held equal to ``lpa_cluster_plain``'s labels, and its
    ELL/hybrid packer held equal to ``ell_hybrid_pack_plain`` on each graph
    of ``packer_inputs`` (name -> (normalized CSR, ELL width)), the tail
    compared in row order. Each timed on the host clock beside the plain
    version."""
    from ssrg_torch import native
    from ssrg_torch.data.synthetic import community_graph
    from ssrg_torch.ops.normalize import sym_norm

    adj = sym_norm(community_graph(NUM_NODES, seed=SEED), 0.5)
    t0 = time.perf_counter()
    labels = native.lpa_cluster(adj.indptr, adj.indices)
    t1 = time.perf_counter()
    plain = native.lpa_cluster_plain(adj.indptr, adj.indices)
    t2 = time.perf_counter()
    check(np.array_equal(labels, plain), "lpa_cluster: labels differ from lpa_cluster_plain's "
          f"at {int((labels != plain).sum())} nodes")
    rec.update(lpa_nodes=NUM_NODES, lpa_nnz=int(adj.nnz), lpa_s=t1 - t0,
               lpa_plain_s=t2 - t1, lpa_clusters=int(np.unique(labels).size))
    for name, (csr, width) in packer_inputs.items():
        n_pad = -(-csr.shape[0] // 256) * 256
        t0 = time.perf_counter()
        got = native.ell_hybrid_pack(csr.indptr, csr.indices, csr.data, width, n_pad)
        t1 = time.perf_counter()
        want = native.ell_hybrid_pack_plain(csr.indptr, csr.indices, csr.data, width, n_pad)
        t2 = time.perf_counter()
        order = np.argsort(got[2], kind="stable")
        same = (all(np.array_equal(a, b) for a, b in zip(got[:2], want[:2]))
                and all(np.array_equal(a[order], b) for a, b in zip(got[2:], want[2:])))
        check(same, f"ell_hybrid_pack on {name}: the pack differs from the plain version's")
        rec[f"pack_{name}"] = {"width": width, "tail": int(got[2].size), "s": t1 - t0,
                               "plain_s": t2 - t1}
    emit(rec)


def phase_kernels() -> list:
    """The ``kernels`` phase: ``tools/kernels.py``'s table with only the
    libraries :func:`phase_build` built. Returns each step's summary."""
    import importlib

    import torch

    import kernels as table  # tools/kernels.py
    from ssrg_torch.ops import _nvcc

    args = argparse.Namespace(seed=SEED, parts="attention,scores,edges")
    summary = []
    for key, kernel in table.KERNELS.items():
        module = importlib.import_module(f"ssrg_torch.ops.{kernel.module}")
        libs = {"source": _nvcc.library(module.NAME, module._declare)}
        for case, steps in kernel.cases(args):
            for rec in table.measure(key, kernel, module, libs, case, steps):
                emit(rec)
                summary.append({"kernel": key, "case": case, "step": rec["step"],
                                **{k: rec[k] for k in ("ms", "plain_ms", "library_ms",
                                                       "bound_ms", "bound_share")},
                                **{k: rec[k]["source"] for k in ("max_abs_err",
                                                                 "max_err_over_tolerance")}})
            del steps
            torch.cuda.empty_cache()
    return summary


def phase_slice(ds, adj_norm) -> None:
    import torch

    from ssrg_torch.configs.config import TrainingConfig
    from ssrg_torch.serve import Predictor

    cfg, spec, params = seeded_gamlp(ds.num_features)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    pred = Predictor(ds, spec, cfg, TrainingConfig(spmm_engine="auto"),
                     params=params, device="cuda")
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    launches_prepare = read_launches()
    requests = serve_requests(pred, "slice")
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()

    k = cfg.prop_steps
    check(launches_prepare == {"ell_spmm": k, "banded_spmm": 0, "rest_spmm": 0},
          f"prepare launched {launches_prepare}, expected ell_spmm K={k} times and no other")
    check(launches == launches_prepare, f"requests launched kernels: {launches}")
    launches_prepare = launches_prepare["ell_spmm"]

    # hop K against float64 scipy: f32 sums of <= 38 terms per hop, 3 hops
    hops = pred.prepared.inputs
    ref = np.asarray(ds.x, np.float64)
    a64 = adj_norm.astype(np.float64)
    for _ in range(k):
        ref = a64 @ ref
    hop_err = float(np.abs(hops[k].cpu().numpy().astype(np.float64) - ref).max())
    check(hop_err <= 1e-4, f"hop {k} vs float64 scipy: max abs err {hop_err}")

    # the head on the host over the card's hops, for the largest request
    req = requests[-1]
    host_module = copy.deepcopy(pred.module).cpu()
    with torch.no_grad():
        host = host_module(hops[:, torch.as_tensor(req["ids"], device=hops.device)].cpu())
    head_err = float((req["logits"].cpu() - host).abs().max())
    check(head_err <= 1e-4 * (1.0 + float(host.abs().max())),
          f"card logits vs host logits: max abs err {head_err}")
    emit({"phase": "slice", "model": "gamlp", "hidden": cfg.hidden_dim,
          "num_layers": cfg.num_layers, "prop_steps": k, "classes": NUM_CLASSES,
          "nodes": NUM_NODES, "features": ds.num_features, "nnz": int(adj_norm.nnz),
          "engine": "auto", "prepare_s": prepare_s, "prepare_launches": launches_prepare,
          "hop_k_max_abs_err_vs_f64": hop_err, "head_max_abs_err_vs_host": head_err,
          "requests": request_times(requests), "peak_mem_bytes": peak})


def phase_layers(ds, prop_steps: int) -> None:
    """Each layer of ``prepare`` timed alone, on the slice's graph: host
    normalization, host packing, the copy to the card, and the K hops
    (CUDA events)."""
    import torch

    from ssrg_torch.ops.normalize import sym_norm
    from ssrg_torch.ops.propagate import propagate
    from ssrg_torch.ops.sparse import build_hybrid

    t0 = time.perf_counter()
    adj = sym_norm(ds.adj, 0.5)
    t1 = time.perf_counter()
    pack = build_hybrid(adj)
    t2 = time.perf_counter()
    dev_pack = pack.to("cuda")
    x = torch.as_tensor(ds.x, device="cuda")
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    emit({"phase": "layers", "normalize_s": t1 - t0, "pack_s": t2 - t1,
          "to_device_s": t3 - t2, "propagate_ms": cuda_ms(
              lambda: propagate(dev_pack, x, prop_steps, device="cuda"), iters=5, warmup=1)})


# --- the locality tier --------------------------------------------------------


def locality_layers(run: str, ds, engine: str, bf16: bool, prop_steps: int):
    """The layers of ``prepare``'s reorder path, each timed alone: host
    normalization, the permutation, renumbering the graph and features, the
    host pack, the copy to the card, the K hops (CUDA events) and the
    un-permutation of the hop stack: the record."""
    import torch

    from ssrg_torch.ops.normalize import sym_norm
    from ssrg_torch.ops.pallas_banded import build_pallas_banded
    from ssrg_torch.ops.pallas_rest import RestSegmentedAdj
    from ssrg_torch.ops.propagate import propagate
    from ssrg_torch.ops.reorder import (
        apply_permutation, bandwidth, reorder_permutation, reorder_plan,
    )
    from ssrg_torch.ops.sparse import build_tiled

    dev = torch.device("cuda")
    method, dense_engine, merge_target, kwargs = reorder_plan(engine, dev, bf16)
    t0 = time.perf_counter()
    adj = sym_norm(ds.adj, 0.5)
    t1 = time.perf_counter()
    perm = reorder_permutation(adj, method, merge_target=merge_target)
    t2 = time.perf_counter()
    adj_p, x_p, _, inverse = apply_permutation(adj, perm, ds.x)
    t3 = time.perf_counter()
    if dense_engine == "pallas_banded":
        pack = build_pallas_banded(adj_p, **kwargs)
    else:
        pack = build_tiled(adj_p, device=dev, **kwargs)
    t4 = time.perf_counter()
    pack_dev = pack.to(dev)
    x_dev = torch.as_tensor(x_p, device=dev)
    inv = torch.as_tensor(inverse, device=dev)
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    del pack
    hops = propagate(pack_dev, x_dev, prop_steps, device=dev)
    rec = {"phase": "locality_layers", "run": run, "engine": engine,
           "dense_engine": dense_engine, "spmm_bf16": bf16, "method": method,
           "nnz": int(adj.nnz), "bandwidth_before": bandwidth(adj),
           "bandwidth_after": bandwidth(adj_p),
           "normalize_s": t1 - t0, "reorder_s": t2 - t1, "renumber_s": t3 - t2,
           "pack_s": t4 - t3, "copy_s": t5 - t4,
           "hops_ms": cuda_ms(lambda: propagate(pack_dev, x_dev, prop_steps, device=dev),
                              iters=5, warmup=1),
           "unpermute_ms": cuda_ms(lambda: hops.index_select(1, inv), iters=5, warmup=1)}
    if dense_engine == "pallas_banded":
        nb, rb, w = pack_dev.blocks.shape
        rec.update(row_blocks=nb, row_block=rb, window=w, window_bf16=pack_dev.window_bf16,
                   blocks_dtype=str(pack_dev.blocks.dtype),
                   blocks_bytes=pack_dev.blocks.numel() * pack_dev.blocks.element_size())
    else:
        rest = pack_dev.rest
        check(isinstance(rest, RestSegmentedAdj) and rest.default_executor == "pallas",
              f"{run}: the tiled pack's rest is {type(rest).__name__}, not the rest kernel's")
        rec.update(tiles=int(pack_dev.tiles.shape[0]), tiled_fraction=pack_dev.tiled_fraction,
                   tiles_dtype=str(pack_dev.tiles.dtype),
                   tiles_bytes=pack_dev.tiles.numel() * pack_dev.tiles.element_size(),
                   rest_chunks=rest.num_chunks, rest_chunk=rest.chunk,
                   rest_row_blocks=rest.nb, rest_row_block=rest.row_block,
                   rest_gather_bf16=rest.gather_bf16)
    return rec


class WarningLog(logging.Handler):
    """Keeps the messages of the warnings logged while it is attached."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def locality_slice(run: str, ds, engine: str, bf16: bool, kernel: str) -> None:
    """GAMLP through ``Predictor`` with ``spmm_engine=engine`` on the card.

    Checks: ``prepare`` launched the path's kernel K times and no other
    kernel, and logged no fallback warning; hop K in the original node order
    against float64 scipy ``A^K X`` (f32: 1e-4; bf16: ``K * 2^-7 *
    (|A|^K |X|)`` elementwise, since each hop rounds the weights, the window
    and, in the rest, the products to bf16, 2^-9 relative each, at most
    three times a term); the requests; and, for the f32 banded run, the
    logits of a hybrid ``Predictor`` with the same weights within 1e-4
    relative, which shows the hops went back to their own node ids."""
    import torch

    from ssrg_torch.configs.config import TrainingConfig
    from ssrg_torch.ops.normalize import sym_norm
    from ssrg_torch.serve import Predictor

    cfg, spec, params = seeded_gamlp(ds.num_features)
    k = cfg.prop_steps
    warned = WarningLog()
    logger = logging.getLogger("ssrg_torch")
    logger.addHandler(warned)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    pred = Predictor(ds, spec, cfg, TrainingConfig(spmm_engine=engine, spmm_bf16=bf16),
                     params=params, device="cuda")
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    launches = read_launches()
    paths = banded_paths()
    logger.removeHandler(warned)
    expected = {name: (k if name == kernel else 0) for name in KERNELS}
    check(launches == expected, f"{run}: prepare launched {launches}, expected {expected}")
    banded = k if kernel == "banded_spmm" else 0
    check_banded_paths(run, paths, tensor_core=banded if bf16 else 0,
                       stream=0 if bf16 else banded)
    check(not warned.messages, f"{run}: prepare warned {warned.messages}")
    requests = serve_requests(pred, run)
    check(read_launches() == launches, f"{run}: requests launched kernels")
    peak = torch.cuda.max_memory_allocated()

    hops = pred.prepared.inputs
    check(pred.prepared.hops_layout and tuple(hops.shape) == (k + 1, NUM_NODES, NUM_FEATURES),
          f"{run}: hop stack {tuple(hops.shape)}")
    a64 = sym_norm(ds.adj, 0.5).astype(np.float64)
    ref = np.asarray(ds.x, np.float64)
    ref_abs, a_abs = np.abs(ref), abs(a64)
    for _ in range(k):
        ref, ref_abs = a64 @ ref, a_abs @ ref_abs
    err = np.abs(hops[k].cpu().numpy().astype(np.float64) - ref)
    if bf16:
        hop_tol = "K*2^-7*(|A|^K|X|) elementwise"
        check(bool((err <= k * 2.0 ** -7 * ref_abs + 1e-30).all()),
              f"{run}: hop {k} vs float64 scipy beyond {hop_tol} (max abs err {err.max()})")
    else:
        hop_tol = "1e-4 abs"
        check(err.max() <= 1e-4, f"{run}: hop {k} vs float64 scipy: max abs err {err.max()}")
    rec = {"phase": "locality_slice", "run": run, "model": "gamlp", "hidden": cfg.hidden_dim,
           "num_layers": cfg.num_layers, "prop_steps": k, "classes": NUM_CLASSES,
           "nodes": NUM_NODES, "features": NUM_FEATURES, "nnz": int(a64.nnz),
           "engine": engine, "spmm_bf16": bf16, "prepare_s": prepare_s,
           "prepare_limit_s": PREPARE_LIMIT_S,
           "prepare_within_limit": prepare_s <= PREPARE_LIMIT_S,
           "prepare_launches": launches, "prepare_banded_paths": paths,
           "hop_k_max_abs_err_vs_f64": float(err.max()),
           "hop_k_max_rel_err_vs_f64": float((err / (ref_abs + 1e-30)).max()),
           "hop_tolerance": hop_tol, "requests": request_times(requests),
           "peak_mem_bytes": peak}
    del pred, hops
    if run == "banded_f32":
        _, spec, _ = seeded_gamlp(ds.num_features)
        reset_launches()
        hybrid = Predictor(ds, spec, cfg, TrainingConfig(spmm_engine="hybrid"),
                           params=params, device="cuda")
        rec["hybrid_prepare_launches"] = read_launches()
        worst = 0.0
        for req in requests:
            want = hybrid.logits(req["ids"])
            gap = float((req["logits"] - want).abs().max()) / (1.0 + float(want.abs().max()))
            check(gap <= 1e-4, f"{run}: logits vs the hybrid Predictor's: {gap} relative")
            worst = max(worst, gap)
        rec["hybrid_logits_max_rel_err"] = worst
        del hybrid
    emit(rec)
    torch.cuda.empty_cache()


def phase_locality(prop_steps: int) -> None:
    """The locality tier: the layers of each run's reorder path, then the
    three ``Predictor`` runs."""
    import torch

    t0 = time.perf_counter()
    graphs = {"banded": banded_dataset(), "community": community_dataset()}
    emit({"phase": "locality_data", "host_s": time.perf_counter() - t0,
          "banded_edges": int(graphs["banded"].adj.nnz),
          "community_edges": int(graphs["community"].adj.nnz)})
    for run, graph, engine, bf16, _ in LOCALITY_RUNS:
        emit(locality_layers(run, graphs[graph], engine, bf16, prop_steps))
        torch.cuda.empty_cache()
    for run, graph, engine, bf16, kernel in LOCALITY_RUNS:
        locality_slice(run, graphs[graph], engine, bf16, kernel)


# --- the training slice -------------------------------------------------------

TRAIN_EPOCHS = 5
# a restored checkpoint's logits against the module's kept state on the same
# inputs: the same float32 operations, so rounding-level at most
CKPT_TOL = 1e-5


def time_epochs(task, attention: bool = False) -> dict:
    """Wrap ``task``'s ``train_epoch`` and ``evaluate`` so that each call
    in the run is timed on the host clock, ending in a synchronize (the
    host epoch loop waits for each epoch's accuracies anyway), its
    ``ell_spmm`` launches counted, and with ``attention`` the attention
    kernels' by kernel. Returns the lists the times and counts go into."""
    import torch

    from ssrg_torch.ops.gat_attention import gat_attention

    ell = kernel_wrappers()["ell_spmm"]
    times = {"train_epoch_ms": [], "eval_ms": [], "train_epoch_launches": [],
             "eval_launches": []}
    if attention:
        times.update(train_epoch_attention=[], eval_attention=[])

    def timed(fn, key):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            before, attn = ell.launches, dict(gat_attention.kernel_launches)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[f"{key}_ms"].append((time.perf_counter() - t0) * 1e3)
            times[f"{key}_launches"].append(ell.launches - before)
            if attention:
                times[f"{key}_attention"].append(
                    {k: v - attn[k] for k, v in gat_attention.kernel_launches.items()})
            return out
        return run

    task.train_epoch = timed(task.train_epoch, "train_epoch")
    task.evaluate = timed(task.evaluate, "eval")
    return times


def keep_checkpoints(task) -> list:
    """Wrap ``task``'s checkpoint writer so that each write also keeps, in
    memory, the epoch and a copy of the module's state it wrote. Returns the
    list the copies go into."""
    saved = []

    def save(module, has_bn, epoch, best_val, best_test):
        saved.append({"epoch": epoch, "state": {k: v.detach().clone()
                                                for k, v in module.state_dict().items()}})
        return write(module, has_bn, epoch, best_val, best_test)

    write = task._save
    task._save = save
    return saved


def train_run(ds, cfg, tc, num_classes: int = NUM_CLASSES) -> tuple:
    """``NodeClassification`` on the card, counted and timed: the counts set
    to 0 before it, ``prepare`` and the training run each timed and their
    launches read, every epoch's training and evaluation timed, a copy of
    the state kept at each checkpoint write."""
    import torch

    from ssrg_torch.models.zoo import load_model
    from ssrg_torch.train import NodeClassification

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    task = NodeClassification(ds, load_model(cfg, ds.num_features, num_classes), cfg, tc,
                              device="cuda", run=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    prepare_launches = read_launches()
    times = time_epochs(task)
    saved = keep_checkpoints(task)
    task.execute(seed=tc.seed)
    torch.cuda.synchronize()
    rec = {"prepare_s": t1 - t0, "train_s": time.perf_counter() - t1,
           "prepare_launches": prepare_launches, "launches": read_launches(),
           "epochs": tc.num_epochs, "losses": task.history["loss"],
           "val_acc": task.history["val_acc"], "best_val": task.best_val,
           "best_test": task.best_test, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           **times}
    return task, rec, saved


def plain_hybrid_spmm(hyb, x):
    """``A @ x`` for a hybrid pack through ``ell_spmm_plain`` and an
    out-of-place ``index_add`` of the tail: plain torch operations that
    autograd differentiates on its own."""
    from ssrg_torch.ops.ell_spmm import ell_spmm_plain

    out = ell_spmm_plain(hyb.ell.cols, hyb.ell.vals, x)[: hyb.ell.n_rows]
    t = hyb.tail
    return out.index_add(0, t.row, x.index_select(0, t.col) * t.val[:, None])


def max_terms(adj) -> int:
    """The most nonzeros in a row or a column of ``adj``: the most terms any
    output element of ``A x`` or ``A^T g`` sums."""
    return int(max(np.diff(adj.tocsr().indptr).max(), np.diff(adj.tocsc().indptr).max()))


def train_gamlp(ds, ckpt: str) -> dict:
    """GAMLP at full width through ``NodeClassification``: minibatches of
    10,000, batched evaluation, a checkpoint at every new best. Checks: 3
    ``ell_spmm`` launches (prepare's K hops) and no other kernel, every loss
    finite, best val >= 0.25 (ten times chance). Then ``Predictor`` restores
    the checkpoint: the file holds the first epoch of best val accuracy;
    its logits for the val ids are those of the module with the state kept
    in memory at that epoch's write, within ``CKPT_TOL`` (the same inputs,
    so rounding only); when that epoch is not the last, the last epoch's
    logits differ by more than that, so the check tells the two apart; and
    it serves the val ids at the accuracy the checkpoint recorded."""
    import torch

    from ssrg_torch.cache import load_metadata
    from ssrg_torch.configs.config import ModelConfig, TrainingConfig
    from ssrg_torch.models.zoo import load_model
    from ssrg_torch.serve import Predictor
    from ssrg_torch.train.node_classification import slice_inputs

    cfg = ModelConfig(model_name="gamlp")
    tc = TrainingConfig(num_epochs=TRAIN_EPOCHS, lr=0.01, train_batch_size=10_000,
                        eval_batch_size=50_000, checkpoint_path=ckpt)
    task, run, saved = train_run(ds, cfg, tc)
    k = cfg.prop_steps
    check(run["prepare_launches"] == {"ell_spmm": k, "banded_spmm": 0, "rest_spmm": 0}
          and run["launches"] == run["prepare_launches"],
          f"gamlp launched {run['prepare_launches']} in prepare and {run['launches']} in all, "
          f"expected ell_spmm K={k} times (prepare) and no other kernel")
    losses = run["losses"]
    check(len(losses) == TRAIN_EPOCHS and all(np.isfinite(losses)), f"gamlp losses {losses}")
    check(task.best_val >= 0.25, f"gamlp best val {task.best_val} < 0.25")

    meta = load_metadata(ckpt)
    best_epoch = int(np.argmax(run["val_acc"])) + 1
    check(meta["epoch"] == best_epoch and saved and saved[-1]["epoch"] == best_epoch,
          f"checkpoint epoch {meta['epoch']}, writes at {[s['epoch'] for s in saved]}, "
          f"expected the first best val epoch {best_epoch}")
    pred = Predictor(ds, load_model(cfg, ds.num_features, NUM_CLASSES), cfg, TrainingConfig(),
                     checkpoint_path=ckpt, device="cuda")
    served_logits = pred.logits(ds.val_idx)
    inputs = slice_inputs(pred.prepared, torch.as_tensor(np.asarray(ds.val_idx), device="cuda"))
    kept = load_model(cfg, ds.num_features, NUM_CLASSES).module.to("cuda").eval()
    kept.load_state_dict(saved[-1]["state"], strict=True)
    with torch.no_grad():
        kept_logits = kept(inputs)
        last_logits = task.state.module.eval()(inputs)
    scale = max(1.0, float(kept_logits.abs().max()))
    ckpt_err = float((served_logits - kept_logits).abs().max()) / scale
    last_diff = float((last_logits - kept_logits).abs().max()) / scale
    check(ckpt_err <= CKPT_TOL,
          f"restored logits off the best epoch's by {ckpt_err} (relative) > {CKPT_TOL}")
    check(best_epoch == TRAIN_EPOCHS or last_diff > CKPT_TOL,
          f"last epoch's logits within {last_diff} of best epoch {best_epoch}'s: the check "
          "cannot tell them apart")
    labels = served_logits.argmax(dim=-1).cpu().numpy()
    served = float((labels == np.asarray(ds.y)[ds.val_idx]).mean())
    check(abs(served - meta["val_acc"]) <= 1e-6,
          f"served val accuracy {served} vs the checkpoint's {meta['val_acc']}")
    rec = {"phase": "train", "run": "gamlp", "hidden": cfg.hidden_dim,
           "num_layers": cfg.num_layers, "prop_steps": k, "classes": NUM_CLASSES,
           "nodes": NUM_NODES, "features": ds.num_features, "engine": "auto",
           "train_batch_size": tc.train_batch_size, "eval_batch_size": tc.eval_batch_size,
           **run, "checkpoint_epoch": meta["epoch"], "served_val_acc": served,
           "checkpoint_logits_rel_err": ckpt_err, "last_epoch_logits_rel_diff": last_diff}
    emit(rec)
    return rec


def gcn_gradient_check(task, adj_norm) -> dict:
    """fc1's gradient for one step of the trained GCN (evaluation mode, so
    no dropout): through the model, whose SpMMs run the ELL kernel forward
    and backward, against the same function through ``ell_spmm_plain`` and
    autograd, with the model's ReLU mask (a pre-activation within rounding
    of 0 could flip its sign otherwise).

    Bound: only the SpMMs and the products fed by them differ. Each path's
    SpMM output is within ``c*u`` of its exact sum of |terms| (c the most
    terms of a row or column, u = 2^-24); a product over k terms fed by
    different inputs adds ``2*k*u`` of its |terms|; softmax moves the loss
    gradient by at most half the largest logit difference. These carried
    through the absolute values of every operand (first order) bound the
    difference of the gradient at fc1's output elementwise, and with
    ``2*N*u`` more for the sum over nodes, that of fc1's weight gradient."""
    import torch
    import torch.nn.functional as F

    u = UNIT_ROUNDOFF
    p, module = task.prepared, task.state.module.eval()
    head, adj, x = module.head, p.adj_device, p.inputs
    idx = task._split["train"]
    y = task.labels[idx]
    n, n_t, c = x.shape[0], idx.shape[0], max_terms(adj_norm)

    def fc1_grads(forward):
        grads = {}

        def keep_grad(module, inputs, out):
            out.register_hook(lambda g: grads.__setitem__("out", g))

        hook = head.fc1.register_forward_hook(keep_grad)
        head.zero_grad(set_to_none=True)
        logits = forward()
        F.cross_entropy(logits[idx], y).backward()
        hook.remove()
        return grads["out"].detach(), head.fc1.weight.grad.detach().clone(), logits.detach()

    reset_launches()
    g1_k, gw_k, z = fc1_grads(lambda: module(x, adj))
    torch.cuda.synchronize()
    launches = read_launches()["ell_spmm"]
    check(launches == 4, f"one GCN step launched ell_spmm {launches} times, expected 4 "
          "(2 forward, 2 backward)")
    with torch.no_grad():
        mask = (adj.spmm(head.fc1(x)) > 0).float()

    def plain_forward():
        h = plain_hybrid_spmm(adj.fwd, head.fc1(x)) * mask
        return plain_hybrid_spmm(adj.fwd, head.fc2(h))

    g1_p, gw_p, _ = fc1_grads(plain_forward)
    check(bool(gw_k.abs().sum() > 0), "fc1's gradient through the kernel is zero")

    with torch.no_grad():
        w1, b1 = head.fc1.weight.abs(), head.fc1.bias.abs()
        w2, b2 = head.fc2.weight.abs(), head.fc2.bias.abs()
        spmm_abs = lambda v: plain_hybrid_spmm(adj.fwd, v)  # noqa: E731 (weights >= 0)
        t1 = x.abs() @ w1.T + b1
        p1 = spmm_abs(t1)
        t2 = (mask * p1) @ w2.T + b2
        e_t2 = (mask * 2 * c * u * p1) @ w2.T + 2 * w2.shape[1] * u * t2
        e_z = spmm_abs(e_t2) + 2 * c * u * spmm_abs(t2)
        d = torch.zeros_like(z)
        d[idx] = (torch.softmax(z[idx], 1) - F.one_hot(y, z.shape[1])).abs() / n_t
        e_d = torch.zeros_like(z)
        e_d[idx] = (0.5 * e_z[idx].amax(dim=1, keepdim=True) + 4 * u) / n_t
        e2 = spmm_abs(d)
        f1 = e2 @ w2
        e_f1 = (spmm_abs(e_d) + 2 * c * u * e2) @ w2 + 2 * w2.shape[0] * u * f1
        g1 = spmm_abs(mask * f1)
        tol_g1 = spmm_abs(mask * e_f1) + 2 * c * u * g1
        tol_w = tol_g1.T @ x.abs() + 2 * n * u * (g1.T @ x.abs())
        err_g1 = (g1_k - g1_p).abs()
        err_w = (gw_k - gw_p).abs()
    check(bool((err_g1 <= tol_g1 + 1e-30).all()),
          f"GCN gradient at fc1's output: kernel vs plain beyond the bound "
          f"(max abs err {float(err_g1.max())})")
    check(bool((err_w <= tol_w + 1e-30).all()),
          f"GCN fc1 weight gradient: kernel vs plain beyond the bound "
          f"(max abs err {float(err_w.max())})")
    scale = float(gw_p.abs().max())
    return {"step_launches": launches, "terms_c": c,
            "fc1_grad_abs_sum": float(gw_k.abs().sum()),
            "fc1_out_grad_max_abs_err": float(err_g1.max()),
            "fc1_out_grad_err_over_bound_max": float((err_g1 / (tol_g1 + 1e-30)).max()),
            "fc1_weight_grad_max_abs_err": float(err_w.max()),
            "fc1_weight_grad_max_rel_err": float(err_w.max()) / scale,
            "fc1_weight_grad_err_over_bound_max": float((err_w / (tol_w + 1e-30)).max())}


TRACED_EPOCHS = 3


def check_trace(summary: dict, what: str) -> dict:
    """Check that a trace's summary (top operations and busy share) saw
    device work; returns the summary."""
    check(bool(summary["top_ops"]) and summary["device_events"] > 0
          and 0.0 < summary["busy_share"] <= 1.0,
          f"{what}: the trace holds no device work ({summary})")
    return summary


def trace_epochs(task, trace_dir: str, per_epoch: int, run: str) -> dict:
    """``TRACED_EPOCHS`` more epochs of a trained task (node or link), each
    as its epoch loop runs it (a training epoch, then an evaluation whose
    accuracies come to the host), under ``device_trace``; checks
    ``per_epoch`` ``ell_spmm`` launches an epoch."""
    import torch

    from ssrg_torch.logger import device_trace

    cls = type(task)  # the class's methods, not the timing wrappers on the task
    np_rng = np.random.default_rng(SEED)
    reset_launches()
    with device_trace(trace_dir, device="cuda") as trace:
        for _ in range(TRACED_EPOCHS):
            cls.train_epoch(task, task.state, np_rng)
            _ = [float(a) for a in cls.evaluate(task, task.state)]
        torch.cuda.synchronize()
    launches = read_launches()
    check(launches["ell_spmm"] == per_epoch * TRACED_EPOCHS,
          f"traced {run} epochs launched {launches}, expected ell_spmm {per_epoch} an epoch")
    summary = {"path": trace.path, "top_ops": trace.top_ops(5), **trace.busy_share()}
    return {"phase": "train_trace", "run": run, "epochs": TRACED_EPOCHS,
            "launches": launches, "trace": check_trace(summary, f"{run} epochs")}


def train_gcn(ds, adj_norm, trace_dir: str) -> dict:
    """The naive GCN (hidden 256) on the full graph with ``engine="auto"``
    (hybrid). Checks: ``prepare`` launches nothing; each epoch launches
    ``ell_spmm`` 6 times (the training forward 2, its backward 2, one
    evaluation forward 2); the loss falls from the first epoch to the last;
    the gradient check of :func:`gcn_gradient_check`. Then
    :func:`trace_epochs`."""
    from ssrg_torch.configs.config import ModelConfig, TrainingConfig
    from ssrg_torch.ops.sparse import DifferentiableAdj

    cfg = ModelConfig(model_name="gcn")
    tc = TrainingConfig(num_epochs=TRAIN_EPOCHS, lr=0.01)
    task, run, _ = train_run(ds, cfg, tc)
    adj = task.prepared.adj_device
    check(isinstance(adj, DifferentiableAdj) and adj.symmetric,
          f"GCN adjacency {type(adj).__name__}: expected the hybrid under autograd, "
          "its forward pack reused for A^T")
    none = {"ell_spmm": 0, "banded_spmm": 0, "rest_spmm": 0}
    per_epoch = 2 + 2 + 2
    check(run["prepare_launches"] == none, f"GCN prepare launched {run['prepare_launches']}")
    check(run["launches"] == {**none, "ell_spmm": per_epoch * TRAIN_EPOCHS},
          f"GCN training launched {run['launches']}, expected ell_spmm {per_epoch} times an "
          f"epoch for {TRAIN_EPOCHS} epochs")
    losses = run["losses"]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"GCN losses {losses}")
    rec = {"phase": "train", "run": "gcn", "hidden": cfg.hidden_dim, "classes": NUM_CLASSES,
           "nodes": NUM_NODES, "features": ds.num_features, "nnz": int(adj_norm.nnz),
           "engine": "auto", "width": adj.fwd.ell.width, **run,
           "launches_per_epoch": per_epoch}
    rec.update(gcn_gradient_check(task, adj_norm))
    emit(rec)
    emit(trace_epochs(task, trace_dir, 6, "gcn"))
    return rec


def phase_train(trace_root: str) -> None:
    """The training slice on one graph: GAMLP and the GCN (three of its
    epochs traced into ``trace_root``)."""
    import torch

    from ssrg_torch.data.synthetic import planetoid_like
    from ssrg_torch.ops.normalize import sym_norm

    stage_s = {}
    # a process's first torch.optim.Adam imports torch._dynamo and
    # torch.distributed.tensor: timed apart, so that it is not read as the
    # first training run's
    t0 = time.perf_counter()
    torch.optim.Adam([torch.zeros(1, device="cuda", requires_grad=True)])
    stage_s["first_optimizer"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = planetoid_like(**TRAIN_GRAPH)
    adj_norm = sym_norm(ds.adj, 0.5)
    stage_s["data"] = time.perf_counter() - t0
    emit({"phase": "train_data", "host_s": stage_s["data"],
          "first_optimizer_s": stage_s["first_optimizer"], "nnz": int(adj_norm.nnz),
          "split": [len(ds.train_idx), len(ds.val_idx), len(ds.test_idx)],
          "symmetric": bool((adj_norm != adj_norm.T).nnz == 0)})
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        train_gamlp(ds, os.path.join(tmp, "gamlp.ckpt"))
    torch.cuda.empty_cache()
    stage_s["gamlp_and_predictor"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    train_gcn(ds, adj_norm, os.path.join(trace_root, "gcn_epochs"))
    torch.cuda.empty_cache()
    stage_s["gcn_and_gradient_check"] = time.perf_counter() - t0
    emit({"phase": "train_stages", "seconds": stage_s})


# --- the spectral and directed-operator slice ----------------------------------

SPECTRAL_EPOCHS = 5
DIRECTED_EDGES = 1_166_243        # ogbn-arxiv's directed edge count
ARXIV_SPLIT = (90_941, 29_799, 48_603)
# planetoid_like at PubMed's and Cora's node count, width, classes and split
# sizes; p_in/p_out give their average degrees (4.5 and 3.9)
PUBMED = dict(num_node=19_717, num_classes=3, num_features=500, train_per_class=20,
              num_val=500, num_test=1000, p_in=2.4e-4, p_out=2.4e-5, seed=SEED)
CORA = dict(num_node=2_708, num_classes=7, num_features=1_433, train_per_class=20,
            num_val=500, num_test=1000, p_in=2.6e-3, p_out=2.6e-4, seed=SEED)
TWO_ORDER_MAX_NODES = 10_000      # two_order_ppr_approx_norm's own guard


def directed_dataset():
    """A directed graph at ogbn-arxiv's size: 169,343 nodes, exactly
    1,166,243 distinct directed edges without self-loops, 90 % of them from
    a node of class k to one of class k + 1 (mod 40) and the rest anywhere
    (the class sets the direction, as in ``tests/test_end_to_end.py``);
    F = 128 features, a class mean plus unit noise; ogbn-arxiv's split
    sizes; ``Graph(symmetrize=False)``."""
    from ssrg_torch.data.graph import Graph
    from ssrg_torch.data.synthetic import InMemoryDataset

    rng = np.random.default_rng(SEED)
    n, c = NUM_NODES, NUM_CLASSES
    y = rng.integers(0, c, n)
    by_class = np.argsort(y, kind="stable")
    starts = np.searchsorted(y[by_class], np.arange(c + 1))
    m = DIRECTED_EDGES + DIRECTED_EDGES // 20
    src = rng.integers(0, n, m)
    nxt = (y[src] + 1) % c
    lo, hi = starts[nxt], starts[nxt + 1]
    dst = by_class[lo + (rng.random(m) * (hi - lo)).astype(np.int64)]
    anywhere = rng.random(m) < 0.1
    dst[anywhere] = rng.integers(0, n, int(anywhere.sum()))
    keys = np.unique((src * n + dst)[src != dst])
    check(keys.size >= DIRECTED_EDGES, f"only {keys.size} distinct directed edges drawn")
    keys = rng.permutation(keys)[:DIRECTED_EDGES]
    x = (rng.normal(size=(c, NUM_FEATURES))[y]
         + rng.normal(size=(n, NUM_FEATURES))).astype(np.float32)
    g = Graph(keys // n, keys % n, np.ones(keys.size, np.float32), n, "UUU", x=x, y=y,
              symmetrize=False)
    perm = rng.permutation(n)
    a, b = ARXIV_SPLIT[0], ARXIV_SPLIT[0] + ARXIV_SPLIT[1]
    return InMemoryDataset(g, perm[:a], perm[a:b], perm[b:], name="directed_arxiv")


class Captured:
    """Replace ``owner[name]`` (a dict entry) or ``owner.name`` by a wrapper
    that keeps each call's result and its seconds on the host clock, until
    ``restore``. ``result`` is the first call's."""

    def __init__(self, owner, name: str):
        self.owner, self.name = owner, name
        self.fn = owner[name] if isinstance(owner, dict) else getattr(owner, name)
        self.seconds, self.results = [], []

        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = self.fn(*args, **kwargs)
            self.seconds.append(time.perf_counter() - t0)
            self.results.append(out)
            return out

        self._set(run)

    def _set(self, fn) -> None:
        if isinstance(self.owner, dict):
            self.owner[self.name] = fn
        else:
            setattr(self.owner, self.name, fn)

    @property
    def result(self):
        return self.results[0]

    def restore(self) -> None:
        self._set(self.fn)


def pack_stats(csr) -> dict:
    """The hybrid pack ``auto`` builds for ``csr``: nnz, stored zeros, ELL
    width, longest row, the share of padding slots, the tail's entries."""
    from ssrg_torch.ops.sparse import build_hybrid

    csr = csr.tocsr()
    pack = build_hybrid(csr)
    deg = np.diff(csr.indptr)
    width = pack.ell.width
    in_ell = int(np.minimum(deg, width).sum())
    return {"nnz": int(csr.nnz), "stored_zeros": int((csr.data == 0).sum()), "width": width,
            "longest_row": int(deg.max()), "slots": int(pack.ell.vals.numel()),
            "padding_share": 1.0 - in_ell / pack.ell.vals.numel(),
            "tail_nnz": int(csr.nnz) - in_ell}


def falling(losses, what: str) -> None:
    check(len(losses) == SPECTRAL_EPOCHS and all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{what} losses {losses}: expected {SPECTRAL_EPOCHS} finite, the last below the first")


def spectral_magnet(ds) -> None:
    """magnet at ``ModelConfig`` defaults (hidden 256, 3 layers, K = 3, q =
    0.05) on the directed graph: ``prepare`` launches ``ell_spmm`` 4 K = 12
    times (four real SpMMs a hop on the hybrid packs of the real and
    imaginary parts); hop K against float64 scipy ``(A_re + i A_im)^K X``
    within 1e-4 (both parts); 5 epochs with no launch and a falling loss;
    then ``Predictor`` with the trained weights serves 1 / 1,000 / 4,096 ids
    (no launch past its ``prepare``) and agrees with the task's logits."""
    import torch

    from ssrg_torch.configs.config import ModelConfig, TrainingConfig
    from ssrg_torch.models import zoo
    from ssrg_torch.models.zoo import load_model
    from ssrg_torch.serve import Predictor

    cfg = ModelConfig(model_name="magnet")
    k = cfg.prop_steps
    norm = Captured(zoo.GRAPH_OPS, "magnetic")
    try:
        task, run, _ = train_run(ds, cfg, TrainingConfig(num_epochs=SPECTRAL_EPOCHS, lr=0.01))
    finally:
        norm.restore()
    none = {name: 0 for name in KERNELS}
    check(run["prepare_launches"] == {**none, "ell_spmm": 4 * k},
          f"magnet prepare launched {run['prepare_launches']}, expected ell_spmm 4K = {4 * k}")
    check(run["launches"] == run["prepare_launches"], f"magnet training launched {run['launches']}")
    falling(run["losses"], "magnet")
    re_a, im_a = norm.result
    re_k, im_k = task.prepared.inputs
    a = (re_a.astype(np.complex128) + 1j * im_a.astype(np.float64)).tocsr()
    ref = np.asarray(ds.x, np.float64)
    for _ in range(k):
        ref = a @ ref
    hop_err = max(float(np.abs(re_k.cpu().numpy() - ref.real).max()),
                  float(np.abs(im_k.cpu().numpy() - ref.imag).max()))
    check(hop_err <= 1e-4, f"magnet hop {k} vs float64 scipy: max abs err {hop_err}")
    del a, ref, re_k, im_k

    params = {key: v.detach().clone() for key, v in task.state.module.state_dict().items()}
    reset_launches()
    t0 = time.perf_counter()
    pred = Predictor(ds, load_model(cfg, ds.num_features, NUM_CLASSES), cfg, TrainingConfig(),
                     params=params, device="cuda")
    torch.cuda.synchronize()
    serve_prepare_s = time.perf_counter() - t0
    serve_prepare = read_launches()
    requests = serve_requests(pred, "magnet")
    check(serve_prepare == run["prepare_launches"] and read_launches() == serve_prepare,
          f"magnet Predictor launched {serve_prepare} in prepare, {read_launches()} in all")
    want = task.logits(task.state, requests[-1]["ids"])
    gap = float((requests[-1]["logits"] - want).abs().max()) / (1.0 + float(want.abs().max()))
    check(gap <= 1e-4, f"magnet served logits vs the task's: {gap} relative")
    del pred, task, want
    torch.cuda.empty_cache()

    emit({"phase": "spectral", "run": "magnet", "hidden": cfg.hidden_dim,
          "num_layers": cfg.num_layers, "prop_steps": k, "q": cfg.q, "classes": NUM_CLASSES,
          "nodes": NUM_NODES, "features": NUM_FEATURES, "directed_edges": int(ds.adj.nnz),
          "normalize_s": norm.seconds,
          "packs": {"real": pack_stats(re_a), "imag": pack_stats(im_a)},
          **run, "hop_k_max_abs_err_vs_f64": hop_err, "hop_tolerance": "1e-4 abs",
          "serve_prepare_s": serve_prepare_s, "serve_logits_rel_err": gap,
          "requests": request_times(requests)})


def spectral_two_dir(ds) -> None:
    """two_dir at defaults on the directed graph: ``prepare`` launches
    ``ell_spmm`` 3 K = 9 times (the un, in and out packs, K hops each); each
    pack's nnz, width, padding and tail; 5 epochs with a falling loss."""
    import torch

    from ssrg_torch.configs.config import ModelConfig, TrainingConfig
    from ssrg_torch.models import zoo

    cfg = ModelConfig(model_name="two_dir")
    k = cfg.prop_steps
    norm = Captured(zoo.GRAPH_OPS, "two_dir")
    try:
        task, run, _ = train_run(ds, cfg, TrainingConfig(num_epochs=SPECTRAL_EPOCHS, lr=0.01))
    finally:
        norm.restore()
    none = {name: 0 for name in KERNELS}
    check(run["prepare_launches"] == {**none, "ell_spmm": 3 * k},
          f"two_dir prepare launched {run['prepare_launches']}, expected ell_spmm 3K = {3 * k}")
    check(run["launches"] == run["prepare_launches"],
          f"two_dir training launched {run['launches']}")
    falling(run["losses"], "two_dir")
    check(tuple(task.prepared.inputs.shape) == (NUM_NODES, 3 * NUM_FEATURES),
          f"two_dir inputs {tuple(task.prepared.inputs.shape)}")
    del task
    torch.cuda.empty_cache()
    un, in_l, out_l = norm.result
    packs = {name: pack_stats(m) for name, m in (("un", un), ("in", in_l), ("out", out_l))}
    emit({"phase": "spectral", "run": "two_dir", "hidden": cfg.hidden_dim,
          "num_layers": cfg.num_layers, "prop_steps": k, "classes": NUM_CLASSES,
          "nodes": NUM_NODES, "normalize_s": norm.seconds, "packs": packs, **run})


def spectral_two_order() -> None:
    """two_order at Cora's size (planetoid_like): below ``DENSE_THRESHOLD``,
    so the dense engine and no kernel launch; the host construction (an
    (N+1)^2 eigendecomposition) timed apart; 5 epochs at the default rate."""
    from ssrg_torch.configs.config import ModelConfig, TrainingConfig
    from ssrg_torch.data.synthetic import planetoid_like
    from ssrg_torch.models import zoo

    ds = planetoid_like(**CORA)
    cfg = ModelConfig(model_name="two_order")
    norm = Captured(zoo.GRAPH_OPS, "two_order")
    try:
        # the default rate: at 0.01 the MLP on 2 x 1,433 features overshoots
        _, run, _ = train_run(ds, cfg, TrainingConfig(num_epochs=SPECTRAL_EPOCHS),
                              num_classes=CORA["num_classes"])
    finally:
        norm.restore()
    none = {name: 0 for name in KERNELS}
    check(run["prepare_launches"] == none and run["launches"] == none,
          f"two_order launched {run['launches']}, expected nothing (dense engine)")
    falling(run["losses"], "two_order")
    one, two = norm.result
    emit({"phase": "spectral", "run": "two_order", "nodes": CORA["num_node"],
          "features": CORA["num_features"], "classes": CORA["num_classes"],
          "nnz": int(ds.adj.nnz), "engine": "auto (dense)", "construction_s": norm.seconds,
          "construction_guard_max_nodes": TWO_ORDER_MAX_NODES,
          "one_order_nnz": int(one.nnz), "two_order_nnz": int(two.nnz), **run})


def wavelet_gradient_check(task, phi_h, psi_h) -> dict:
    """conv1's weight gradient for one step of the wavelet model
    (evaluation mode, so no dropout), through the model, whose four SpMMs
    run the ELL kernel forward and, on the packs of Φᵀ and Φ⁻ᵀ, backward,
    against the same function through ``ell_spmm_plain`` and autograd with
    the model's ReLU mask; and the gradient at conv1's output.

    Bound, first order, as :func:`gcn_gradient_check`'s: an SpMM of at most
    c terms an output (c of Φ or Φ⁻¹, over rows and columns) differs between
    the paths by ``2 c u`` of its sum of |terms|, a product over k terms fed
    by different inputs by ``2 k u``, a product by θ by ``2 u``, and softmax
    moves the loss gradient by at most half the largest logit difference.
    Carried through the absolute values of every operand (Φ and Φ⁻¹ hold
    only positive entries: the threshold zeroes the rest), they bound the
    gradient's difference at conv1's output elementwise, and with ``2 N u``
    more for the sum over nodes, that of conv1's weight."""
    import torch
    import torch.nn.functional as F

    from ssrg_torch.ops.sparse import DifferentiableAdj, HybridAdj

    u = UNIT_ROUNDOFF
    p, module = task.prepared, task.state.module.eval()
    conv1, conv2 = module.head.conv1, module.head.conv2
    (phi, psi), x = p.adj_device, p.inputs
    check(all(isinstance(a, DifferentiableAdj) and isinstance(a.fwd, HybridAdj)
              and not a.symmetric for a in (phi, psi)),
          "wavelet adjacencies: expected hybrid packs under autograd, each with a pack of "
          "its transpose")
    check(phi_h.data.min() > 0 and psi_h.data.min() > 0, "Φ or Φ⁻¹ holds a non-positive entry")
    idx = task._split["train"]
    y = task.labels[idx]
    n, n_t = x.shape[0], idx.shape[0]
    c_phi, c_psi = max_terms(phi_h), max_terms(psi_h)

    def grads(forward):
        module.zero_grad(set_to_none=True)
        logits, h = forward()
        h.retain_grad()
        F.cross_entropy(logits[idx], y).backward()
        return h.grad.detach(), conv1.weight.grad.detach().clone(), logits.detach()

    def kernel_forward():
        h = conv1(x, phi, psi)
        return conv2(h, phi, psi), h

    reset_launches()
    gh_k, gw_k, z = grads(kernel_forward)
    torch.cuda.synchronize()
    launches = read_launches()["ell_spmm"]
    check(launches == 8, f"one wavelet step launched ell_spmm {launches} times, expected 8 "
          "(4 forward, 4 backward)")

    def plain(pack):
        return lambda v: plain_hybrid_spmm(pack, v)

    a_fwd, a_bwd, b_fwd, b_bwd = plain(phi.fwd), plain(phi.bwd), plain(psi.fwd), plain(psi.bwd)
    with torch.no_grad():
        mask = (a_fwd(conv1.theta * b_fwd(x @ conv1.weight)) > 0).float()

    def plain_forward():
        h = a_fwd(conv1.theta * b_fwd(x @ conv1.weight)) * mask
        return a_fwd(conv2.theta * b_fwd(h @ conv2.weight)), h

    gh_p, gw_p, _ = grads(plain_forward)
    check(bool(gw_k.abs().sum() > 0), "conv1's gradient through the kernel is zero")
    with torch.no_grad():
        w1, w2 = conv1.weight.abs(), conv2.weight.abs()
        th1, th2 = conv1.theta.abs(), conv2.theta.abs()
        k1, k2 = w2.shape
        # magnitudes of the forward values (m_*) and the paths' differences (e_*)
        m_u1 = b_fwd(x.abs() @ w1)
        m_v1 = th1 * m_u1
        m_p1 = a_fwd(m_v1)
        m_z2 = (mask * m_p1) @ w2
        m_u2 = b_fwd(m_z2)
        m_v2 = th2 * m_u2
        m_z = a_fwd(m_v2)
        e_v1 = th1 * (2 * c_psi * u * m_u1) + 2 * u * m_v1
        e_p1 = a_fwd(e_v1) + 2 * c_phi * u * m_p1
        e_z2 = (mask * e_p1) @ w2 + 2 * k1 * u * m_z2
        e_v2 = th2 * (b_fwd(e_z2) + 2 * c_psi * u * m_u2) + 2 * u * m_v2
        e_z = a_fwd(e_v2) + 2 * c_phi * u * m_z
        # the loss gradient at the logits and its difference
        d = torch.zeros_like(z)
        d[idx] = (torch.softmax(z[idx], 1) - F.one_hot(y, z.shape[1])).abs() / n_t
        e_d = torch.zeros_like(z)
        e_d[idx] = (0.5 * e_z[idx].amax(dim=1, keepdim=True) + 4 * u) / n_t
        # backward: magnitudes (m_g*) and differences (e_g*)
        m_gv2 = a_bwd(d)
        e_gv2 = a_bwd(e_d) + 2 * c_phi * u * m_gv2
        m_gu2 = th2 * m_gv2
        e_gu2 = th2 * e_gv2 + 2 * u * m_gu2
        m_gz2 = b_bwd(m_gu2)
        e_gz2 = b_bwd(e_gu2) + 2 * c_psi * u * m_gz2
        m_gh = m_gz2 @ w2.T
        tol_h = e_gz2 @ w2.T + 2 * k2 * u * m_gh
        m_gv1 = a_bwd(mask * m_gh)
        e_gv1 = a_bwd(mask * tol_h) + 2 * c_phi * u * m_gv1
        m_gu1 = th1 * m_gv1
        e_gu1 = th1 * e_gv1 + 2 * u * m_gu1
        m_gz1 = b_bwd(m_gu1)
        e_gz1 = b_bwd(e_gu1) + 2 * c_psi * u * m_gz1
        tol_w = x.abs().T @ e_gz1 + 2 * n * u * (x.abs().T @ m_gz1)
        err_h = (gh_k - gh_p).abs()
        err_w = (gw_k - gw_p).abs()
    check(bool((err_h <= tol_h + 1e-30).all()),
          f"wavelet gradient at conv1's output: kernel vs plain beyond the bound "
          f"(max abs err {float(err_h.max())})")
    check(bool((err_w <= tol_w + 1e-30).all()),
          f"wavelet conv1 weight gradient: kernel vs plain beyond the bound "
          f"(max abs err {float(err_w.max())})")
    return {"step_launches": launches, "terms_c_phi": c_phi, "terms_c_phi_inv": c_psi,
            "conv1_grad_abs_sum": float(gw_k.abs().sum()),
            "conv1_out_grad_max_abs_err": float(err_h.max()),
            "conv1_out_grad_err_over_bound_max": float((err_h / (tol_h + 1e-30)).max()),
            "conv1_weight_grad_max_abs_err": float(err_w.max()),
            "conv1_weight_grad_max_rel_err": float(err_w.max()) / float(gw_p.abs().max()),
            "conv1_weight_grad_err_over_bound_max": float((err_w / (tol_w + 1e-30)).max())}


def spectral_wavelet() -> None:
    """wavelet at PubMed's size (planetoid_like) with ``WaveletConfig`` and
    ``ModelConfig`` defaults. ``prepare`` builds (Φ, Φ⁻¹) with 2 scales x
    ceil(N / 1,024) impulse blocks x 3 Chebyshev orders ``ell_spmm``
    launches at F = 1,024 on the Laplacian's hybrid pack, the seconds split
    into the device recurrence and the host thresholding. 5 epochs: each
    training epoch launches 8 (4 forward, 4 backward on the host-built packs
    of Φᵀ and Φ⁻ᵀ), each evaluation 4, and the loss falls; then the
    gradient check of :func:`wavelet_gradient_check` at seeded initial
    weights, and ``GWNNTrainer`` at ``GWNNConfig`` defaults (5 epochs) fits
    and scores."""
    import torch

    from ssrg_torch.configs.config import ModelConfig, TrainingConfig
    from ssrg_torch.data.synthetic import planetoid_like
    from ssrg_torch.models import gwnn, wavelet

    ds = planetoid_like(**PUBMED)
    n, classes = PUBMED["num_node"], PUBMED["num_classes"]
    cfg = ModelConfig(model_name="wavelet")
    wcfg = cfg.wavelet
    blocks = -(-n // wcfg.impulse_batch)
    construction = 2 * blocks * wcfg.approximation_order
    built = Captured(wavelet, "calculate_wavelets")
    try:
        task, run, _ = train_run(ds, cfg, TrainingConfig(num_epochs=SPECTRAL_EPOCHS, lr=0.01),
                                 num_classes=classes)
    finally:
        built.restore()
    none = {name: 0 for name in KERNELS}
    check(run["prepare_launches"] == {**none, "ell_spmm": construction},
          f"wavelet prepare launched {run['prepare_launches']}, expected ell_spmm "
          f"2 x {blocks} x {wcfg.approximation_order} = {construction}")
    check(run["train_epoch_launches"] == [8] * SPECTRAL_EPOCHS
          and run["eval_launches"] == [4] * SPECTRAL_EPOCHS,
          f"wavelet epochs launched {run['train_epoch_launches']} (training) and "
          f"{run['eval_launches']} (evaluation): expected 8 and 4 each")
    falling(run["losses"], "wavelet")
    phi_h, psi_h, stats = built.result
    rec = {"phase": "spectral", "run": "wavelet", "hidden": cfg.hidden_dim,
           "classes": classes, "nodes": n, "features": PUBMED["num_features"],
           "nnz": int(ds.adj.nnz), "impulse_batch": wcfg.impulse_batch, "blocks": blocks,
           "order": wcfg.approximation_order, "scale": wcfg.scale,
           "construction_launches": construction, "construction_s": built.seconds,
           **{key: stats[key] for key in ("lmax", "phi_density", "phi_inv_density",
                                          "recurrence_s", "threshold_s")},
           "packs": {name: pack_stats(m) for name, m in
                     (("phi", phi_h), ("phi_t", phi_h.T), ("phi_inv", psi_h),
                      ("phi_inv_t", psi_h.T))},
           **run}
    # the check runs at seeded initial weights: after 5 epochs this
    # separable task's loss, and so its gradient, is about 0
    module = task.state.module.cpu()
    module.reset_parameters(torch.Generator().manual_seed(SEED))
    module.to("cuda")
    rec.update(wavelet_gradient_check(task, phi_h, psi_h))
    emit(rec)
    del task
    torch.cuda.empty_cache()

    gcfg = gwnn.GWNNConfig(epochs=SPECTRAL_EPOCHS)
    reset_launches()
    t0 = time.perf_counter()
    sparsifier = gwnn.WaveletSparsifier(ds.adj, gcfg.scale, gcfg.approximation_order,
                                        gcfg.tolerance, device="cuda")
    sparsifier.calculate_all_wavelets()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    sparsifier_launches = read_launches()["ell_spmm"]
    trainer = gwnn.GWNNTrainer(gcfg, sparsifier, ds.x, ds.y, device="cuda")
    reset_launches()
    t2 = time.perf_counter()
    trainer.fit()
    score = trainer.score()
    torch.cuda.synchronize()
    fit_launches = read_launches()["ell_spmm"]
    check(sparsifier_launches == construction and fit_launches == 8 * SPECTRAL_EPOCHS + 4,
          f"GWNN launched ell_spmm {sparsifier_launches} (sparsifier) and {fit_launches} "
          f"(fit and score): expected {construction} and {8 * SPECTRAL_EPOCHS + 4}")
    gwnn_losses = [entry["loss"] for entry in trainer.logs]
    falling(gwnn_losses, "GWNN")
    check(0.0 <= score <= 1.0, f"GWNN score {score}")
    emit({"phase": "spectral", "run": "gwnn", "filters": gcfg.filters, "scale": gcfg.scale,
          "epochs": gcfg.epochs, "sparsifier_s": t1 - t0,
          "sparsifier_launches": sparsifier_launches,
          "phi_density": sparsifier.stats["phi_density"],
          "phi_inv_density": sparsifier.stats["phi_inv_density"],
          "fit_and_score_s": time.perf_counter() - t2, "fit_and_score_launches": fit_launches,
          "losses": gwnn_losses, "epoch_s": [entry["seconds"] for entry in trainer.logs],
          "test_acc": score})


def phase_spectral() -> None:
    """The spectral and directed-operator slice: magnet and two_dir on the
    directed graph at ogbn-arxiv's size, two_order at Cora's, wavelet and
    GWNN at PubMed's."""
    import torch

    stage_s = {}
    t0 = time.perf_counter()
    ds = directed_dataset()
    check(ds.adj.nnz == DIRECTED_EDGES and ds.adj.diagonal().sum() == 0,
          f"directed graph: {ds.adj.nnz} edges")
    stage_s["directed_data"] = time.perf_counter() - t0
    emit({"phase": "spectral_data", "host_s": stage_s["directed_data"], "nodes": NUM_NODES,
          "directed_edges": int(ds.adj.nnz),
          "reciprocated_edges": int(ds.adj.multiply(ds.adj.T).nnz),
          "split": [len(ds.train_idx), len(ds.val_idx), len(ds.test_idx)]})
    t0 = time.perf_counter()
    spectral_magnet(ds)
    stage_s["magnet"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    spectral_two_dir(ds)
    stage_s["two_dir"] = time.perf_counter() - t0
    del ds
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spectral_two_order()
    stage_s["two_order"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    spectral_wavelet()
    stage_s["wavelet_and_gwnn"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    emit({"phase": "spectral_stages", "seconds": stage_s})


# --- the robustness pipeline ---------------------------------------------------

ROBUST_EPOCHS = 5


def robust_sparsify(ds, root: str) -> tuple:
    """``sparsify_dataset`` at ``DataProcessConfig``'s default rates into
    ``root``, then the port's loader. Checks: the masked share of the
    features within 5 sigma of the feature rate (binomial); exactly ``E -
    int(rate * E)`` of the ``E`` half-edges kept; the features unchanged.
    Returns (the loaded dataset, its record)."""
    from ssrg_torch.configs.config import DataProcessConfig
    from ssrg_torch.data.sparsity import load_homo_simplex_sparsity_dataset
    from ssrg_torch.data.utils import edge_homophily, linkx_homophily, node_homophily
    from ssrg_torch.pipelines import sparsify_dataset

    fr, er = DataProcessConfig().sparse_rate
    name = f"arxiv_like_{fr}_{er}"
    t0 = time.perf_counter()
    raw = sparsify_dataset(ds, fr, er, os.path.join(root, name), seed=SEED)
    t1 = time.perf_counter()
    sp_ds = load_homo_simplex_sparsity_dataset(name, root)
    t2 = time.perf_counter()
    coo = sp_ds.adj.tocoo()
    stats = (edge_homophily(coo.row, coo.col, sp_ds.y),
             node_homophily(coo.row, coo.col, sp_ds.y, sp_ds.num_node),
             linkx_homophily(coo.row, coo.col, sp_ds.y, sp_ds.num_node))
    t3 = time.perf_counter()
    check(stats == (sp_ds.edge_homophily, sp_ds.node_homophily, sp_ds.linkx_homophily),
          "homophily statistics differ from the loader's")
    mask = sp_ds.feature_mask
    masked = 1.0 - float(mask.mean())
    sigma = float(np.sqrt(fr * (1 - fr) / mask.size))
    check(abs(masked - fr) <= 5 * sigma,
          f"masked feature share {masked}, expected {fr} within 5 sigma ({5 * sigma})")
    full = ds.adj.tocoo()
    halves = int((full.col > full.row).sum())
    kept = int(sp_ds.edge.row.size)
    check(kept == halves - int(er * halves), f"kept {kept} of {halves} half-edges, expected "
          f"{halves - int(er * halves)}")
    check(np.array_equal(sp_ds.x, ds.x), "sparsify changed the features")
    raw_bytes = sum(os.path.getsize(os.path.join(raw, f)) for f in os.listdir(raw))
    return sp_ds, {"feature_rate": fr, "edge_rate": er, "write_s": t1 - t0,
                   "raw_bytes": raw_bytes, "load_s": t2 - t1, "homophily_s": t3 - t2,
                   "masked_share": masked, "masked_sigma": sigma, "half_edges": halves,
                   "kept_half_edges": kept, "nnz": int(sp_ds.adj.nnz),
                   "edge_homophily": stats[0], "node_homophily": stats[1],
                   "linkx_homophily": stats[2]}


def robust_augment(sp_ds, root: str) -> tuple:
    """``augment_dataset`` at ``DataAugmentConfig``'s defaults on the card,
    the encoder's training and the host's edge completion timed apart;
    then the augmented directory loaded. Checks: no kernel launched (the
    encoder is dense); finite features of width hidden + classes; soft
    labels summing to 1 (within 1e-4); every node of the augmented graph of
    degree >= ``degree_level``. Returns (the augmented dataset, its
    record)."""
    import torch

    from ssrg_torch.configs.config import DataAugmentConfig
    from ssrg_torch.data.sparsity import load_homo_simplex_sparsity_dataset
    from ssrg_torch.pipelines import augment

    cfg = DataAugmentConfig()
    row, col = sp_ds.edge.row, sp_ds.edge.col
    deg = np.bincount(np.concatenate([row, col]), minlength=sp_ds.num_node)
    needy = int((deg < cfg.degree_level).sum())
    name = sp_ds.name
    encoder = Captured(augment, "feature_augment")
    completion = Captured(augment, "edge_augment")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    try:
        augment.augment_dataset(sp_ds, cfg, os.path.join(root, "aug", name), seed=SEED,
                                device="cuda")
    finally:
        encoder.restore()
        completion.restore()
    t1 = time.perf_counter()
    launches = read_launches()
    check(launches == {k: 0 for k in KERNELS}, f"augmentation launched {launches}")
    feature, soft = encoder.result
    classes = sp_ds.num_classes
    check(feature.shape == (sp_ds.num_node, cfg.hidden_dim + classes) and np.isfinite(feature).all(),
          f"augmented features {feature.shape}, finite {bool(np.isfinite(feature).all())}")
    soft_err = float(np.abs(soft.sum(axis=1) - 1.0).max())
    check(soft_err <= 1e-4, f"soft labels sum to 1 within {soft_err}")
    t2 = time.perf_counter()
    aug_ds = load_homo_simplex_sparsity_dataset(name, os.path.join(root, "aug"),
                                                is_augumented=True)
    t3 = time.perf_counter()
    min_deg = int(np.diff(aug_ds.adj.indptr).min())
    check(min_deg >= cfg.degree_level, f"augmented graph's least degree {min_deg}")
    n_cand = (cfg.degree_level - int(deg.min())) * cfg.candidates_per_deficit if needy else 0
    return aug_ds, {
        "hidden": cfg.hidden_dim, "epochs": cfg.epochs, "lr": cfg.lr, "dropout": cfg.dropout,
        "degree_level": cfg.degree_level, "candidates_per_deficit": cfg.candidates_per_deficit,
        "augment_s": t1 - t0, "encoder_s": encoder.seconds[0],
        "encoder_ms_per_epoch": encoder.seconds[0] * 1e3 / cfg.epochs,
        "edge_completion_s": completion.seconds[0],
        "write_s": t1 - t0 - encoder.seconds[0] - completion.seconds[0],
        "needy_nodes": needy, "candidates": n_cand,
        # the [needy, candidates, F] float32 array of differences the completion takes norms of
        "distance_array_bytes": needy * n_cand * feature.shape[1] * 4,
        "features": int(feature.shape[1]), "soft_label_sum_max_err": soft_err,
        "load_s": t3 - t2, "nnz": int(aug_ds.adj.nnz), "min_degree": min_deg,
        "launches": launches}


def robust_node(aug_ds) -> None:
    """GAMLP at ``ModelConfig`` defaults through ``NodeClassification`` on
    the augmented graph (F = 296, ``auto``: the hybrid). Checks: 3
    ``ell_spmm`` launches in ``prepare`` and none in training; hop K
    against float64 scipy within 1e-4; finite losses."""
    from ssrg_torch.configs.config import ModelConfig, TrainingConfig
    from ssrg_torch.models import zoo

    cfg = ModelConfig(model_name="gamlp")
    k = cfg.prop_steps
    norm = Captured(zoo.GRAPH_OPS, "sym")
    try:
        task, run, _ = train_run(aug_ds, cfg, TrainingConfig(num_epochs=ROBUST_EPOCHS, lr=0.01),
                                 num_classes=aug_ds.num_classes)
    finally:
        norm.restore()
    none = {name: 0 for name in KERNELS}
    check(run["prepare_launches"] == {**none, "ell_spmm": k} and run["launches"] ==
          run["prepare_launches"], f"gamlp on the augmented graph launched "
          f"{run['prepare_launches']} in prepare, {run['launches']} in all: expected "
          f"ell_spmm K = {k} in prepare and nothing else")
    check(len(run["losses"]) == ROBUST_EPOCHS and all(np.isfinite(run["losses"])),
          f"gamlp losses {run['losses']}")
    adj_norm = norm.result
    ref = np.asarray(aug_ds.x, np.float64)
    a64 = adj_norm.astype(np.float64)
    for _ in range(k):
        ref = a64 @ ref
    hop_err = float(np.abs(task.prepared.inputs[k].cpu().numpy() - ref).max())
    check(hop_err <= 1e-4, f"hop {k} at F = {ref.shape[1]} vs float64 scipy: {hop_err}")
    rec = {"phase": "robust", "run": "node_gamlp", "hidden": cfg.hidden_dim,
           "num_layers": cfg.num_layers, "prop_steps": k, "features": int(ref.shape[1]),
           "nodes": int(aug_ds.num_node), "nnz": int(adj_norm.nnz), "engine": "auto", **run,
           "hop_k_max_abs_err_vs_f64": hop_err, "hop_tolerance": "1e-4 abs"}
    emit(rec)


def link_run(link, cfg, tc) -> tuple:
    """``LinkClassification`` of ``cfg``'s link head on the card, counted
    and timed as :func:`train_run` does a node task."""
    import torch

    from ssrg_torch.models.zoo import load_model
    from ssrg_torch.train import LinkClassification

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    task = LinkClassification(link, load_model(cfg, link.num_features, link.num_classes,
                                               link=True),
                              cfg, tc, device="cuda", run=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    prepare_launches = read_launches()
    times = time_epochs(task)
    task.execute(seed=tc.seed)
    torch.cuda.synchronize()
    return task, {"prepare_s": t1 - t0, "train_s": time.perf_counter() - t1,
                  "prepare_launches": prepare_launches, "launches": read_launches(),
                  "epochs": tc.num_epochs, "losses": task.history["loss"],
                  "val_acc": task.history["val_acc"], "best_val": task.best_val,
                  "best_test": task.best_test,
                  "peak_mem_bytes": torch.cuda.max_memory_allocated(), **times}


def link_gcn_gradient_check(task, adj_norm) -> dict:
    """fc1's gradient for one step of the trained link GCN (evaluation
    mode, so no dropout) over the training pairs: through the model, whose
    SpMMs run the ELL kernel forward and backward, against the same
    function through ``ell_spmm_plain`` and autograd with the model's ReLU
    mask.

    Bound, first order, as :func:`gcn_gradient_check`'s, with the pair
    readout between the second SpMM and the loss: an SpMM of at most c
    terms an output differs between the paths by ``2 c u`` of its sum of
    |terms|, a product over k terms fed by different inputs by ``2 k u``,
    the scatter of the pair gradients onto the nodes (at most m pairs a
    node) by ``2 m u``, and softmax moves the loss gradient by at most half
    the largest logit difference. Carried through the absolute values of
    every operand, they bound the gradient's difference at fc1's output
    elementwise, and with ``2 N u`` more for the sum over nodes, that of
    fc1's weight."""
    import torch
    import torch.nn.functional as F

    u = UNIT_ROUNDOFF
    p, module = task.prepared, task.state.module.eval()
    head, adj, x = module.head, p.adj_device, p.inputs
    pairs, y = task.pairs["train"]
    n, n_p, c = x.shape[0], pairs.shape[0], max_terms(adj_norm)
    hidden = head.fc1.out_features
    m = int(torch.bincount(pairs.reshape(-1), minlength=n).max())

    def fc1_grads(forward):
        grads = {}

        def keep_grad(module, inputs, out):
            out.register_hook(lambda g: grads.__setitem__("out", g))

        hook = head.fc1.register_forward_hook(keep_grad)
        head.zero_grad(set_to_none=True)
        logits = forward()
        F.cross_entropy(logits, y).backward()
        hook.remove()
        return grads["out"].detach(), head.fc1.weight.grad.detach().clone(), logits.detach()

    reset_launches()
    g1_k, gw_k, z = fc1_grads(lambda: module(x, adj, query_edges=pairs))
    torch.cuda.synchronize()
    launches = read_launches()["ell_spmm"]
    check(launches == 4, f"one link GCN step launched ell_spmm {launches} times, expected 4 "
          "(2 forward, 2 backward)")
    with torch.no_grad():
        mask = (adj.spmm(head.fc1(x)) > 0).float()

    def plain_forward():
        h = plain_hybrid_spmm(adj.fwd, head.fc1(x)) * mask
        q = plain_hybrid_spmm(adj.fwd, head.fc2_edge(h))
        return head.edge_fc(torch.cat([q[pairs[:, 0]], q[pairs[:, 1]]], dim=1))

    g1_p, gw_p, _ = fc1_grads(plain_forward)
    check(bool(gw_k.abs().sum() > 0), "fc1's gradient through the kernel is zero")

    def scatter(v):
        out = torch.zeros(n, hidden, device=v.device)
        out.index_add_(0, pairs[:, 0], v[:, :hidden])
        return out.index_add_(0, pairs[:, 1], v[:, hidden:])

    with torch.no_grad():
        w1, b1 = head.fc1.weight.abs(), head.fc1.bias.abs()
        w2, b2 = head.fc2_edge.weight.abs(), head.fc2_edge.bias.abs()
        we, be = head.edge_fc.weight.abs(), head.edge_fc.bias.abs()
        spmm_abs = lambda v: plain_hybrid_spmm(adj.fwd, v)  # noqa: E731 (weights >= 0)
        t1 = x.abs() @ w1.T + b1
        p1 = spmm_abs(t1)
        t2 = (mask * p1) @ w2.T + b2
        e_t2 = (mask * 2 * c * u * p1) @ w2.T + 2 * hidden * u * t2
        q = spmm_abs(t2)
        e_q = spmm_abs(e_t2) + 2 * c * u * q
        s = torch.cat([q[pairs[:, 0]], q[pairs[:, 1]]], dim=1)
        e_s = torch.cat([e_q[pairs[:, 0]], e_q[pairs[:, 1]]], dim=1)
        e_z = e_s @ we.T + 2 * s.shape[1] * u * (s @ we.T + be)
        del s, e_s
        d = (torch.softmax(z, 1) - F.one_hot(y, z.shape[1])).abs() / n_p
        e_d = ((0.5 * e_z.amax(dim=1, keepdim=True) + 4 * u) / n_p).expand_as(d)
        ds = d @ we
        e_ds = e_d @ we + 2 * we.shape[0] * u * ds
        dq = scatter(ds)
        e_dq = scatter(e_ds) + 2 * m * u * dq
        del ds, e_ds
        e2 = spmm_abs(dq)
        f1 = e2 @ w2
        e_f1 = (spmm_abs(e_dq) + 2 * c * u * e2) @ w2 + 2 * w2.shape[0] * u * f1
        g1 = spmm_abs(mask * f1)
        tol_g1 = spmm_abs(mask * e_f1) + 2 * c * u * g1
        tol_w = tol_g1.T @ x.abs() + 2 * n * u * (g1.T @ x.abs())
        err_g1 = (g1_k - g1_p).abs()
        err_w = (gw_k - gw_p).abs()
    check(bool((err_g1 <= tol_g1 + 1e-30).all()),
          f"link GCN gradient at fc1's output: kernel vs plain beyond the bound "
          f"(max abs err {float(err_g1.max())})")
    check(bool((err_w <= tol_w + 1e-30).all()),
          f"link GCN fc1 weight gradient: kernel vs plain beyond the bound "
          f"(max abs err {float(err_w.max())})")
    return {"step_launches": launches, "terms_c": c, "pairs_per_node_max": m,
            "fc1_grad_abs_sum": float(gw_k.abs().sum()),
            "fc1_out_grad_max_abs_err": float(err_g1.max()),
            "fc1_out_grad_err_over_bound_max": float((err_g1 / (tol_g1 + 1e-30)).max()),
            "fc1_weight_grad_max_abs_err": float(err_w.max()),
            "fc1_weight_grad_max_rel_err": float(err_w.max()) / float(gw_p.abs().max()),
            "fc1_weight_grad_err_over_bound_max": float((err_w / (tol_w + 1e-30)).max())}


def robust_link(aug_ds, trace_dir: str) -> None:
    """``link_dataset_from_graph`` on the augmented graph, then two
    ``LinkClassification`` runs of 5 full-batch epochs. The naive GCN's
    link head (hidden 256): both SpMMs at F = 256 on the pack of the
    observed training edges (symmetric, so the backward reuses it);
    ``prepare`` launches nothing and each epoch 8 (training forward 2 and
    backward 2, validation 2, test 2); finite, falling losses; the gradient
    check of :func:`link_gcn_gradient_check`; three more epochs traced into
    ``trace_dir``. GAMLP's link head: 3 launches in ``prepare``, none in
    training, finite losses."""
    from ssrg_torch.configs.config import ModelConfig, TrainingConfig
    from ssrg_torch.data.link import link_dataset_from_graph
    from ssrg_torch.models import zoo
    from ssrg_torch.ops.sparse import DifferentiableAdj

    t0 = time.perf_counter()
    link = link_dataset_from_graph(aug_ds, seed=SEED)
    split_s = time.perf_counter() - t0
    sizes = {s: int(getattr(link, f"{s}_edge_pairs_idx").shape[0])
             for s in ("train", "val", "test")}
    none = {name: 0 for name in KERNELS}
    # the rates: at 0.01 both heads overshoot in the first steps on this
    # task, and at 1e-3 the GCN's loss still rises after its first Adam step
    # (0.70 -> 0.93 at 12,000 nodes), so the GCN runs at 1e-4, GAMLP at
    # TrainingConfig's default
    tc = TrainingConfig(num_epochs=ROBUST_EPOCHS, lr=1e-4)

    cfg = ModelConfig(model_name="gcn")
    norm = Captured(zoo.GRAPH_OPS, "sym")
    try:
        task, run = link_run(link, cfg, tc)
    finally:
        norm.restore()
    adj = task.prepared.adj_device
    check(isinstance(adj, DifferentiableAdj) and adj.symmetric,
          f"link GCN adjacency {type(adj).__name__}: expected the hybrid under autograd, "
          "its forward pack reused for A^T")
    check(run["prepare_launches"] == none, f"link GCN prepare launched {run['prepare_launches']}")
    check(run["train_epoch_launches"] == [4] * ROBUST_EPOCHS
          and run["eval_launches"] == [4] * ROBUST_EPOCHS,
          f"link GCN epochs launched {run['train_epoch_launches']} (training) and "
          f"{run['eval_launches']} (evaluation): expected 4 and 4 each")
    losses = run["losses"]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"link GCN losses {losses}")
    gcn = {"phase": "robust", "run": "link_gcn", "hidden": cfg.hidden_dim,
           "nodes": int(link.num_node), "features": int(link.num_features),
           "observed_nnz": int(norm.result.nnz), "pairs": sizes, "split_s": split_s,
           "engine": "auto", "width": adj.fwd.ell.width, **run, "launches_per_epoch": 8}
    gcn.update(link_gcn_gradient_check(task, norm.result))
    emit(gcn)
    emit(trace_epochs(task, trace_dir, 8, "link_gcn"))

    cfg = ModelConfig(model_name="gamlp")
    g_task, g_run = link_run(link, cfg, TrainingConfig(num_epochs=ROBUST_EPOCHS))
    check(g_run["prepare_launches"] == {**none, "ell_spmm": cfg.prop_steps}
          and g_run["launches"] == g_run["prepare_launches"],
          f"link gamlp launched {g_run['prepare_launches']} in prepare, {g_run['launches']} "
          f"in all: expected ell_spmm K = {cfg.prop_steps} in prepare and nothing else")
    check(all(np.isfinite(g_run["losses"])), f"link gamlp losses {g_run['losses']}")
    emit({"phase": "robust", "run": "link_gamlp", "hidden": cfg.hidden_dim,
          "edge_mode": cfg.edge_mode, "pairs": sizes, **g_run})
    del g_task


def phase_robust(trace_root: str, graph: dict = None) -> None:
    """The robustness pipeline at ogbn-arxiv's size: sparsify
    ``planetoid_like(**TRAIN_GRAPH)`` into a temporary directory, load it,
    augment it on the card, train GAMLP on the augmented graph, then the
    link tasks (three link GCN epochs traced into ``trace_root``)."""
    import torch

    from ssrg_torch.data.synthetic import planetoid_like

    stage_s = {}
    t0 = time.perf_counter()
    ds = planetoid_like(**(graph or TRAIN_GRAPH))
    stage_s["data"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        sp_ds, sparse_rec = robust_sparsify(ds, root)
        stage_s["sparsify_and_load"] = time.perf_counter() - t0
        del ds
        t0 = time.perf_counter()
        aug_ds, aug_rec = robust_augment(sp_ds, root)
        stage_s["augment_and_load"] = time.perf_counter() - t0
    emit({"phase": "robust", "run": "sparsify", **sparse_rec})
    emit({"phase": "robust", "run": "augment", **aug_rec})
    del sp_ds
    t0 = time.perf_counter()
    robust_node(aug_ds)
    stage_s["node_gamlp"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    robust_link(aug_ds, os.path.join(trace_root, "link_gcn_epochs"))
    stage_s["link"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    emit({"phase": "robust_stages", "seconds": stage_s})


# --- the message-passing baselines ----------------------------------------------

BASELINE_EPOCHS = 10
# (model, BaselineTask keywords, ELL launches of its prepare, of an epoch).
# GCN: 3 forward, 3 backward, 3 evaluation; SAGE: its first SpMM multiplies
# the raw x, which takes no gradient, so 3 + 2 + 3; SGC and SIGN: K = 3 hops.
BASELINE_RUNS = (
    ("gcn", dict(hidden_dim=256, num_layers=3), 0, 9),
    ("sage", dict(hidden_dim=256, num_layers=3), 0, 8),
    ("gat", dict(hidden_dim=64, num_layers=2), 0, 0),
    ("mlp", dict(hidden_dim=256, num_layers=3), 0, 0),
    ("robust_mlp", dict(hidden_dim=256, num_layers=3, triplet_weight=0.1), 0, 0),
    ("sgc", dict(prop_steps=3), 3, 0),
    ("sign", dict(hidden_dim=256, prop_steps=3), 3, 0),
)
CLUSTER = dict(cluster_parts=128, parts_per_batch=8)
GAT_ORACLE_NODES = 2_000


def baseline_run(ds, name: str, kw: dict, tc) -> tuple:
    """``BaselineTask`` on the card, counted and timed as :func:`train_run`
    does a node task: the constructor (packing, propagation, cluster
    batches) and the run each timed and their launches read, every epoch's
    training and evaluation timed."""
    import torch

    from ssrg_torch.train.baseline_task import BaselineTask

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    task = BaselineTask(ds, name, tc, run=False, device="cuda", **kw)
    prepare_launches = read_launches()
    times = time_epochs(task, attention=name == "gat")
    t1 = time.perf_counter()
    task.execute(0, seed=tc.seed)
    torch.cuda.synchronize()
    best_val, best_test = task.best_of_run(0)
    rec = {"prepare_s": task.prepare_seconds, "train_s": time.perf_counter() - t1,
           "prepare_launches": prepare_launches, "launches": read_launches(),
           "epochs": tc.num_epochs, "losses": task.history["loss"],
           "val_acc": task.history["val_acc"], "best_val": float(best_val),
           "best_test": float(best_test),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(), **times,
           "epoch_ms_after_first": float(np.median(times["train_epoch_ms"][1:])),
           "eval_ms_after_first": float(np.median(times["eval_ms"][1:]))}
    return task, rec


def check_baseline_launches(name: str, rec: dict, prepare: int, per_epoch: int) -> None:
    none = {"ell_spmm": 0, "banded_spmm": 0, "rest_spmm": 0}
    epochs = [t + e for t, e in zip(rec["train_epoch_launches"], rec["eval_launches"])]
    check(rec["prepare_launches"] == {**none, "ell_spmm": prepare},
          f"{name}: prepare launched {rec['prepare_launches']}, expected ell_spmm {prepare}")
    check(epochs == [per_epoch] * rec["epochs"],
          f"{name}: epochs launched ell_spmm {epochs}, expected {per_epoch} each")
    check(rec["launches"] == {**none, "ell_spmm": prepare + per_epoch * rec["epochs"]},
          f"{name}: the run launched {rec['launches']}")


def layered_forward(name: str, module, x, spmm, masks=None):
    """The baseline GCN's or SAGE's evaluation-mode forward with ``spmm``
    as its graph product: ``(logits, first-layer output, ReLU masks)``.
    ``masks`` (from an earlier call) replaces the ReLUs, so that a
    pre-activation within rounding of 0 cannot flip its sign between two
    paths."""
    import torch

    keep, out_masks, h, first = masks, [], x, None
    layers = module.num_layers
    for i in range(layers):
        if name == "gcn":
            lin = getattr(module, f"conv_{i}" if i < layers - 1 else "conv_out")(h)
            if first is None:
                first = lin
            t = spmm(lin)
        else:
            t = getattr(module, f"self_{i}")(h) + getattr(module, f"nbr_{i}")(spmm(h))
            if first is None:
                first = t
        if i == layers - 1:
            return t, first, out_masks
        mask = keep[i] if keep is not None else (t > 0).float().detach()
        out_masks.append(mask)
        h = t * mask


def baseline_gradient_check(name: str, task, adj_norm) -> dict:
    """The first layer's gradient of the trained 3-layer GCN or SAGE for
    one step (evaluation mode, so no dropout): through the task's
    ``DifferentiableAdj`` (the ELL kernel forward, and backward on the pack
    of A^T: GCN's own pack, SAGE's pack of the transposed row-mean
    adjacency) against the same function through ``ell_spmm_plain`` and
    autograd, with the kernel path's ReLU masks.

    Bound, first order, the rule of :func:`gcn_gradient_check` carried
    through every layer: an SpMM output of either path is within ``c*u`` of
    its exact sum of |terms| (c the most terms of a row or column, u =
    2^-24), so the two differ by ``2*c*u`` of it; a product over k terms fed
    by different inputs adds ``2*k*u`` of its |terms| (the first layer's
    own product sees the same x in both paths and adds nothing); a sum of
    two adds ``2*u``; softmax moves the loss gradient by at most half the
    largest logit difference. The magnitudes |A|, |W|, |x| carry each
    difference through the layers, forward and then backward."""
    import torch
    import torch.nn.functional as F

    u = UNIT_ROUNDOFF
    module, adj, x = task.state.module.eval(), task.adj_op, task.inputs
    idx = task.idx["train"]
    y = task.labels[idx]
    n, n_t, c = x.shape[0], idx.shape[0], max_terms(adj_norm)
    first_w = module.conv_0.weight if name == "gcn" else module.nbr_0.weight
    a_abs = lambda v: plain_hybrid_spmm(adj.fwd, v)   # noqa: E731 (weights >= 0)
    at_abs = lambda v: plain_hybrid_spmm(adj.bwd, v)  # noqa: E731

    def grads(spmm, masks):
        module.zero_grad(set_to_none=True)
        z, first, out_masks = layered_forward(name, module, x, spmm, masks)
        first.retain_grad()
        F.cross_entropy(z[idx], y).backward()
        return (first.grad.detach(), first_w.grad.detach().clone(), z.detach(),
                out_masks)

    reset_launches()
    g_k, gw_k, z, masks = grads(adj.spmm, None)
    torch.cuda.synchronize()
    launches = read_launches()["ell_spmm"]
    expected = 6 if name == "gcn" else 5
    check(launches == expected, f"one {name} step launched ell_spmm {launches} times, "
          f"expected {expected}")
    with torch.no_grad():
        z_model = module(x, adj)
    g_p, gw_p, _, _ = grads(lambda v: plain_hybrid_spmm(adj.fwd, v), masks)
    check(bool(gw_k.abs().sum() > 0), f"{name}: the first layer's gradient is zero")

    with torch.no_grad():
        # forward: (magnitude, difference bound) of each layer's output
        m, e = x.abs(), torch.zeros_like(x)
        mags = []
        for i in range(module.num_layers):
            if name == "gcn":
                lin = getattr(module, f"conv_{i}" if i < module.num_layers - 1 else "conv_out")
                w, b = lin.weight.abs(), lin.bias.abs()
                t = m @ w.T + b
                e_t = e @ w.T + (2 * w.shape[1] * u * t if i else 0.0)
                p = a_abs(t)
                e_p = a_abs(e_t) + 2 * c * u * p
            else:
                lin_s, wn = getattr(module, f"self_{i}"), getattr(module, f"nbr_{i}").weight.abs()
                ws, bs = lin_s.weight.abs(), lin_s.bias.abs()
                nm = a_abs(m)
                e_n = a_abs(e) + 2 * c * u * nm
                mags.append(nm)
                p = m @ ws.T + bs + nm @ wn.T
                e_p = e @ ws.T + e_n @ wn.T + 2 * (ws.shape[1] + 1) * u * p
            if i < module.num_layers - 1:
                m, e = masks[i] * p, masks[i] * e_p
        e_z = e_p
        # the checked forward is the model's, up to the summation order of
        # the COO tail's atomics (not bitwise repeatable)
        check(bool(((z - z_model).abs() <= e_z + 1e-30).all()),
              f"{name}: the checked forward is not the model's")
        # backward, from the loss gradient at the logits
        d = torch.zeros_like(z)
        d[idx] = (torch.softmax(z[idx], 1) - F.one_hot(y, z.shape[1])).abs() / n_t
        e_d = torch.zeros_like(z)
        e_d[idx] = (0.5 * e_z[idx].amax(dim=1, keepdim=True) + 4 * u) / n_t
        g, e_g = d, e_d
        for i in range(module.num_layers - 1, 0, -1):
            if name == "gcn":
                g_t = at_abs(g)
                e_gt = at_abs(e_g) + 2 * c * u * g_t
                w = getattr(module, f"conv_{i}" if i < module.num_layers - 1 else "conv_out")
                w = w.weight.abs()
                g_h = g_t @ w
                e_gh = e_gt @ w + 2 * w.shape[0] * u * g_h
            else:
                ws = getattr(module, f"self_{i}").weight.abs()
                wn = getattr(module, f"nbr_{i}").weight.abs()
                a, bb = g @ ws, at_abs(g @ wn)
                e_a = e_g @ ws + 2 * ws.shape[0] * u * a
                e_bb = at_abs(e_g @ wn + 2 * wn.shape[0] * u * (g @ wn)) + 2 * c * u * bb
                g_h = a + bb
                e_gh = e_a + e_bb + 2 * u * g_h
            g, e_g = masks[i - 1] * g_h, masks[i - 1] * e_gh
        if name == "gcn":     # through the first SpMM to conv_0's output
            g0, tol0 = at_abs(g), at_abs(e_g) + 2 * c * u * at_abs(g)
            tol_w = tol0.T @ x.abs() + 2 * n * u * (g0.T @ x.abs())
        else:                 # the first layer's output; nbr_0 multiplies A x
            g0, tol0 = g, e_g
            ax, e_ax = mags[0], 2 * c * u * mags[0]
            tol_w = tol0.T @ ax + g0.T @ e_ax + 2 * n * u * (g0.T @ ax)
        err0 = (g_k - g_p).abs()
        err_w = (gw_k - gw_p).abs()
    check(bool((err0 <= tol0 + 1e-30).all()),
          f"{name} gradient at the first layer's output: kernel vs plain beyond the bound "
          f"(max abs err {float(err0.max())})")
    check(bool((err_w <= tol_w + 1e-30).all()),
          f"{name} first-layer weight gradient: kernel vs plain beyond the bound "
          f"(max abs err {float(err_w.max())})")
    return {"step_launches": launches, "terms_c": c,
            "first_grad_abs_sum": float(gw_k.abs().sum()),
            "first_out_grad_max_abs_err": float(err0.max()),
            "first_out_grad_err_over_bound_max": float((err0 / (tol0 + 1e-30)).max()),
            "first_weight_grad_max_abs_err": float(err_w.max()),
            "first_weight_grad_max_rel_err": float(err_w.max()) / float(gw_p.abs().max()),
            "first_weight_grad_err_over_bound_max": float((err_w / (tol_w + 1e-30)).max())}


# the published GAT (PyG's ogbn_products_gat.py widths) and each attention
# kernel's launches an epoch: 3 layers' forward in training and in evaluation
# (the statistics twice, the weighted sum once), 3 backward (row dot, pass)
GAT_PUBLISHED = dict(hidden_dim=128, num_layers=3, heads=4, published=True)
GAT_EPOCH_LAUNCHES = {"gat_stats_kernel": 12, "gat_aggregate_kernel": 6,
                      "gat_rowdot_kernel": 3, "gat_backward_kernel": 3,
                      # the scores: each layer's forward, and backward (the
                      # gradient, then the sum of da)
                      "gat_scores_kernel": 6, "gat_score_grad_kernel": 3,
                      "gat_score_sum_kernel": 3,
                      # heads of 128 and a last layer of 40: whole float4s a
                      # head, so no launch takes the whole-row path
                      "whole_row": 0,
                      # the per-edge scores are UniMP's, not GAT's
                      "sddmm_kernel": 0}


def gat_published_run(ds, tc) -> None:
    """The published GAT through ``BaselineTask`` on the card, as
    :func:`baseline_run` runs a baseline (every count set to 0 just before
    it): no ELL launch, none of the attention kernels in ``prepare``, and
    ``GAT_EPOCH_LAUNCHES`` an epoch, its training and evaluation together."""
    from ssrg_torch.ops.gat_attention import gat_attention

    task, rec = baseline_run(ds, "gat", GAT_PUBLISHED, tc)
    check_baseline_launches("gat published", rec, 0, 0)
    epochs = [{k: t[k] + v[k] for k in t}
              for t, v in zip(rec["train_epoch_attention"], rec["eval_attention"])]
    check(epochs == [GAT_EPOCH_LAUNCHES] * rec["epochs"],
          f"gat published: epochs launched {epochs}, expected {GAT_EPOCH_LAUNCHES} each")
    run = dict(gat_attention.kernel_launches)
    check(run == {k: n * rec["epochs"] for k, n in GAT_EPOCH_LAUNCHES.items()},
          f"gat published: the run launched {run} (prepare included)")
    check(all(np.isfinite(rec["losses"])), f"gat published losses {rec['losses']}")
    check(rec["best_val"] >= 0.25, f"gat published best val {rec['best_val']} < 0.25")
    check(task.adj_op.t_row is not None and task.adj_op.nnz == ds.adj.nnz + ds.num_node,
          "gat published: not the attention listing with its self-loops")
    rec.update(phase="baseline", run="gat_published", **GAT_PUBLISHED, nodes=ds.num_node,
               features=ds.num_features, entries=task.adj_op.nnz,
               attention_launches_per_epoch=GAT_EPOCH_LAUNCHES)
    emit(rec)


def gat_oracle_check(task, ds) -> dict:
    """The trained GAT's card forward on the subgraph induced by the first
    ``GAT_ORACLE_NODES`` nodes of BFS order (a connected neighbourhood)
    against dense float64 attention with the same weights: within 1e-4,
    elementwise."""
    import torch
    import torch.nn.functional as F

    from ssrg_torch.models.baselines import EdgeList
    from ssrg_torch.train.baseline_task import bfs_order

    module = task.state.module.eval()
    g = bfs_order(ds.adj.tocsr())[:GAT_ORACLE_NODES]
    sub = ds.adj.tocsr()[g][:, g]
    x = np.asarray(ds.x, np.float32)[g]
    with torch.no_grad():
        out = module(torch.as_tensor(x, device="cuda"),
                     EdgeList.from_scipy(sub).to("cuda")).cpu().numpy().astype(np.float64)
    mask = sub.toarray() != 0
    h = x.astype(np.float64)
    for i, d in enumerate(module.dims):
        w = getattr(module, f"w_{i}").weight.detach().cpu().numpy().T.astype(np.float64)
        a_src = getattr(module, f"a_src_{i}").detach().cpu().numpy()[0].astype(np.float64)
        a_dst = getattr(module, f"a_dst_{i}").detach().cpu().numpy()[0].astype(np.float64)
        z = (h @ w).reshape(len(g), module.heads, d)
        s_src, s_dst = (z * a_src).sum(-1), (z * a_dst).sum(-1)
        outs = np.zeros_like(z)
        for k in range(module.heads):
            s = s_dst[:, k][:, None] + s_src[:, k][None, :]
            s = np.where(s > 0, s, module.negative_slope * s)
            top = np.max(np.where(mask, s, -np.inf), axis=1, keepdims=True)
            e = np.where(mask, np.exp(s - np.where(np.isfinite(top), top, 0.0)), 0.0)
            outs[:, k] = e / np.maximum(e.sum(1, keepdims=True), 1e-300) @ z[:, k]
        if i == module.num_layers - 1:
            h = outs.mean(axis=1)
        else:
            h = F.elu(torch.from_numpy(outs.reshape(len(g), -1))).numpy()
    err = float(np.abs(out - h).max())
    check(np.isfinite(out).all() and err <= 1e-4,
          f"gat: card forward vs the float64 oracle {err} > 1e-4")
    return {"oracle_nodes": len(g), "oracle_edges": int(sub.nnz), "oracle_max_abs_err": err,
            "oracle_max_abs": float(np.abs(h).max())}


def phase_baseline(graph: dict = None) -> None:
    """The seven baselines through ``BaselineTask`` on the ``train`` cell's
    graph (``planetoid_like(**TRAIN_GRAPH)``, ogbn-arxiv's size and splits),
    ``BASELINE_EPOCHS`` epochs each, then the GCN on cluster minibatches.
    Checks: launches per ``prepare`` and per epoch (``BASELINE_RUNS``),
    finite losses (GCN and SAGE falling), best val >= 0.25, the first-layer
    gradients of GCN and SAGE within their bounds, GAT against its dense
    oracle."""
    import torch

    from ssrg_torch.configs.config import TrainingConfig
    from ssrg_torch.data.synthetic import planetoid_like
    from ssrg_torch.ops.normalize import sym_norm
    from ssrg_torch.ops.sparse import DifferentiableAdj
    from ssrg_torch.train.baseline_task import mean_norm

    stage_s = {}
    t0 = time.perf_counter()
    ds = planetoid_like(**(graph or TRAIN_GRAPH))
    stage_s["data"] = time.perf_counter() - t0
    tc = TrainingConfig(num_epochs=BASELINE_EPOCHS, lr=0.01, seed=SEED)
    for name, kw, prep, per_epoch in BASELINE_RUNS:
        t0 = time.perf_counter()
        task, rec = baseline_run(ds, name, kw, tc)
        check_baseline_launches(name, rec, prep, per_epoch)
        losses = rec["losses"]
        check(all(np.isfinite(losses)), f"{name} losses {losses}")
        if name in ("gcn", "sage"):
            check(losses[-1] < losses[0], f"{name} losses {losses}: not falling")
        check(rec["best_val"] >= 0.25, f"{name} best val {rec['best_val']} < 0.25")
        rec.update(phase="baseline", run=name, **kw, nodes=ds.num_node,
                   features=ds.num_features, launches_per_epoch=per_epoch)
        if name in ("gcn", "sage"):
            norm = sym_norm(ds.adj, 0.5) if name == "gcn" else mean_norm(ds.adj)
            rec["transposed_pack_reused"] = task.adj_op.symmetric
            rec["width"], rec["bwd_width"] = task.adj_op.fwd.ell.width, task.adj_op.bwd.ell.width
            rec.update(baseline_gradient_check(name, task, norm))
        if name == "gat":
            # the reference's form: the score kernels, none of the attention's
            layers = kw["num_layers"]
            scores = {"gat_scores_kernel": 2 * layers, "gat_score_grad_kernel": layers,
                      "gat_score_sum_kernel": layers}
            epochs = [{k: t[k] + v[k] for k in t if t[k] + v[k]}
                      for t, v in zip(rec.pop("train_epoch_attention"),
                                      rec.pop("eval_attention"))]
            check(epochs == [scores] * rec["epochs"],
                  f"gat: the reference's form launched {epochs}, expected {scores} an epoch")
            rec.update(gat_oracle_check(task, ds))
        emit(rec)
        stage_s[name] = time.perf_counter() - t0
        del task
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gat_published_run(ds, tc)
    stage_s["gat_published"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    task, rec = baseline_run(ds, "gcn", {**BASELINE_RUNS[0][1], **CLUSTER}, tc)
    per_batch = [6 if isinstance(cb.adj_dev, DifferentiableAdj) else 0
                 for cb in task.cluster_batches]
    per_epoch = sum(per_batch) + 3
    check_baseline_launches("cluster gcn", rec, 0, per_epoch)
    check(all(np.isfinite(rec["losses"])), f"cluster gcn losses {rec['losses']}")
    rec.update(phase="baseline", run="gcn_cluster", **BASELINE_RUNS[0][1], **CLUSTER,
               batches=len(per_batch), batches_on_the_kernel=sum(p > 0 for p in per_batch),
               batch_nodes=[int(cb.node_ids.numel()) for cb in task.cluster_batches],
               launches_per_epoch=per_epoch)
    emit(rec)
    stage_s["gcn_cluster"] = time.perf_counter() - t0
    del task
    torch.cuda.empty_cache()
    emit({"phase": "baseline_stages", "seconds": stage_s})


# --- single-card out-of-core propagation and training ---------------------------

OOC_SHARDS = 8
OOC_STEPS = 3
OOC_EPOCHS = 5
# a dest_outer run's device memory over its start: the accumulator, the
# source block (and its bf16 copy), the kernel's output and one spare block,
# plus the largest bucket (its pack, and the tail's gathered and scaled rows)
OOC_SPARE = 1 << 20


def ooc_memory_bound(meta, f: int) -> tuple:
    """(bound in bytes, the largest bucket's bytes) for a ``dest_outer``
    hop: ``4 * block * F * 4`` bytes of blocks, plus the largest bucket's
    pack and tail temporaries, plus ``OOC_SPARE``. Packs every bucket on
    the host, as the propagation does."""
    from ssrg_torch.parallel.outofcore import _CHUNK, bucket_edges, pack_bucket

    largest = 0
    for r, c, v, off in bucket_edges(meta):
        for j in range(meta.num_shards):
            if off[j] == off[j + 1]:
                continue
            ec, ev, tail = pack_bucket(r[off[j]:off[j + 1]], c[off[j]:off[j + 1]],
                                       v[off[j]:off[j + 1]], meta.block)
            nbytes = ec.nbytes + ev.nbytes
            if tail is not None:
                nbytes += sum(a.nbytes for a in tail) + 2 * min(tail[0].size, _CHUNK) * f * 4
            largest = max(largest, nbytes)
    return 4 * meta.block * f * 4 + largest + OOC_SPARE, largest


def ooc_hop(hop_dirs, meta) -> "np.ndarray":
    return np.concatenate([np.load(os.path.join(hop_dirs[-1], f"block{i}.npy"))
                           for i in range(meta.num_shards)])[: meta.num_nodes]


def phase_ooc(graph: dict = None) -> None:
    """Out-of-core propagation and training on the ``train`` cell's graph:
    its edges (one direction of each pair), features and labels written as
    ``.npy`` under a temporary directory, spooled into ``OOC_SHARDS``
    shards, K = 3 hops block at a time on the card under both schedules,
    the ``coo`` local engine and the bf16 transfer, each held to the
    in-core hybrid ``propagate`` (f32 1e-4 abs; bf16 within
    ``K*2^-7*(|A|^K|X|)``), ELL launches per hop equal to the non-empty
    buckets, ``dest_outer``'s device memory within
    :func:`ooc_memory_bound`; then ``run_outofcore`` SGC and GAMLP on the
    artifacts (reused, not rewritten), best val >= 0.25."""
    import shutil

    import scipy.sparse as sp
    import torch

    from ssrg_torch.configs.config import ModelConfig, TrainingConfig
    from ssrg_torch.data.synthetic import planetoid_like
    from ssrg_torch.ops.normalize import sym_norm
    from ssrg_torch.ops.propagate import propagate
    from ssrg_torch.ops.sparse import device_adjacency
    from ssrg_torch.parallel.outofcore import outofcore_propagate
    from ssrg_torch.train.outofcore_task import ensure_spooled, run_outofcore

    stage_s = {}
    t0 = time.perf_counter()
    ds = planetoid_like(**(graph or TRAIN_GRAPH))
    upper = sp.triu(ds.adj, k=1).tocoo()
    edges = np.stack([upper.row, upper.col]).astype(np.int64)
    adj = sp.csr_matrix((np.ones(edges.shape[1], np.float32), (edges[0], edges[1])),
                        shape=ds.adj.shape)
    adj_norm = sym_norm(((adj + adj.T) > 0).astype(np.float32), 0.5)
    x = np.asarray(ds.x, np.float32)
    n, f = x.shape
    stage_s["data"] = time.perf_counter() - t0
    runs = {}
    with tempfile.TemporaryDirectory() as root:
        paths = {k: os.path.join(root, f"{k}.npy") for k in ("edges", "features", "labels")}
        t0 = time.perf_counter()
        np.save(paths["edges"], edges)
        np.save(paths["features"], x)
        np.save(paths["labels"], np.asarray(ds.y, np.int64))
        stage_s["write_npy"] = time.perf_counter() - t0
        work = os.path.join(root, "work")
        t0 = time.perf_counter()
        meta = ensure_spooled(paths["edges"], n, OOC_SHARDS, work)
        spool_s = time.perf_counter() - t0
        check(meta.num_edges == adj_norm.nnz,
              f"ooc: {meta.num_edges} spooled entries, the in-core operator has {adj_norm.nnz}")
        t0 = time.perf_counter()
        incore = propagate(device_adjacency(adj_norm, "hybrid", device="cuda"), x, OOC_STEPS,
                           device="cuda")[-1].cpu().numpy()
        mag = np.abs(x).astype(np.float64)
        for _ in range(OOC_STEPS):
            mag = adj_norm @ mag
        stage_s["incore_and_magnitude"] = time.perf_counter() - t0
        bound_bytes, largest = ooc_memory_bound(meta, f)
        variants = (  # (name, work dir, keywords, ELL launches a hop?)
            ("source_outer_f32", work, dict(mode="source_outer"), True),
            ("dest_outer_f32", os.path.join(root, "dest"),
             dict(acc_budget_bytes=meta.block * f * 4), True),
            ("coo_f32", os.path.join(root, "coo"), dict(local_engine="coo"), False),
            ("source_outer_bf16", os.path.join(root, "bf16"),
             dict(mode="source_outer", transfer_dtype="bfloat16"), True),
        )
        for name, wdir, kw, on_kernel in variants:
            stats = {}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            reset_launches()
            t0 = time.perf_counter()
            hop_dirs = outofcore_propagate(meta, paths["features"], OOC_STEPS, wdir,
                                           device="cuda", stats=stats, **kw)
            seconds = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
            got = read_launches()
            hop = ooc_hop(hop_dirs, meta)
            err = np.abs(hop.astype(np.float64) - incore)
            if name.endswith("bf16"):
                tol = OOC_STEPS * 2.0 ** -7 * mag
                check(bool((err <= tol + 1e-30).all()),
                      f"ooc {name}: hop K beyond K*2^-7*(|A|^K|X|) (max abs err {err.max()})")
            else:
                check(float(err.max()) <= 1e-4, f"ooc {name}: hop K off in-core by {err.max()}")
            per_hop = stats["nonempty_buckets"] if on_kernel else 0
            check(got == {"ell_spmm": per_hop * OOC_STEPS, "banded_spmm": 0, "rest_spmm": 0},
                  f"ooc {name}: launched {got}, expected ell_spmm {per_hop} a hop "
                  f"({stats['nonempty_buckets']} non-empty buckets)")
            rec = {"phase": "ooc", "run": name, "nodes": n, "features": f, "shards": OOC_SHARDS,
                   "block": meta.block, "steps": OOC_STEPS, **kw, **stats, "seconds": seconds,
                   "hop_k_max_abs_err": float(err.max()), "launches": got,
                   "launches_per_hop": per_hop, "peak_mem_over_start_bytes": peak}
            if stats["mode"] == "dest_outer":
                check(peak <= bound_bytes,
                      f"ooc {name}: {peak} bytes of device memory over the start, above the "
                      f"O(block*F + bucket) bound of {bound_bytes}")
                rec.update(memory_bound_bytes=bound_bytes, largest_bucket_bytes=largest)
            emit(rec)
            runs[name] = rec
            if wdir != work:
                shutil.rmtree(wdir)
        check(runs["dest_outer_f32"]["mode"] == "dest_outer", "ooc: the small budget did not "
              "pick dest_outer")
        hop_file = os.path.join(work, f"hop{OOC_STEPS}", "block0.npy")
        spool_file = os.path.join(meta.spool_dir, "shard_0.bin")
        stamps = (os.path.getmtime(hop_file), os.path.getmtime(spool_file))
        for model, lr in (("sgc", 0.05), ("gamlp", 0.01)):
            t0 = time.perf_counter()
            result = run_outofcore(
                paths["edges"], paths["features"], paths["labels"], work,
                num_shards=OOC_SHARDS, model_cfg=ModelConfig(model_name=model,
                                                             prop_steps=OOC_STEPS),
                train_cfg=TrainingConfig(num_epochs=OOC_EPOCHS, lr=lr,
                                         train_batch_size=10_000, seed=SEED),
                train_idx=ds.train_idx, val_idx=ds.val_idx, test_idx=ds.test_idx,
                device="cuda")
            seconds = time.perf_counter() - t0
            check((os.path.getmtime(hop_file), os.path.getmtime(spool_file)) == stamps,
                  f"ooc {model}: the spool or the hops were written again")
            check(result.best_val >= 0.25, f"ooc {model}: best val {result.best_val} < 0.25")
            epoch_ms = [1e3 * t for t in result.history["epoch_s"]]
            check(all(np.isfinite(result.history["loss"])),
                  f"ooc {model} losses {result.history['loss']}")
            emit({"phase": "ooc", "run": f"train_{model}", "seconds": seconds,
                  "best_val": result.best_val, "best_test": result.best_test,
                  "epochs": OOC_EPOCHS, "train_batch_size": 10_000,
                  "losses": result.history["loss"], "epoch_ms": epoch_ms,
                  "epoch_ms_after_first": float(np.median(epoch_ms[1:]))})
            stage_s[f"train_{model}"] = seconds
    emit({"phase": "ooc_stages", "spool_s": spool_s, "seconds": stage_s})


# --- the distributed tier --------------------------------------------------------

DIST_STEPS = 3
DIST_EPOCHS = 20
DIST_TOL = 1e-4      # hop K against in-core propagate (the out-of-core check's limit)
DIST_SPOOL_TOL = 1e-5
DIST_TIMED_RUNS = 5  # timed K-hop runs of each engine after its checked one
# (run, its exchange, ELL launches a hop at D graph shards)
DIST_ENGINES = (
    ("coo", "all_gather", lambda d: 0),
    ("hybrid_all_gather", "all_gather", lambda d: 1),
    ("hybrid_halo", "halo", lambda d: 1),
    ("tiled_cluster_halo", "halo", lambda d: 1),   # the rest's ELL term
    ("ring", "ring", lambda d: 0),
    ("ring_hybrid", "ring", lambda d: d),          # one a (self, source) bucket
)


def dist_graph(graph: dict = None) -> tuple:
    """The ``train`` cell's graph, normalized: ``(ds, adj_norm, x)``."""
    from ssrg_torch.data.synthetic import planetoid_like
    from ssrg_torch.ops.normalize import sym_norm

    ds = planetoid_like(**(graph or TRAIN_GRAPH))
    return ds, sym_norm(ds.adj, 0.5), np.asarray(ds.x, np.float32)


def dist_engine(name: str, mesh, adj_norm, x):
    """``(sharded adjacency, this rank's features, propagate, extras)`` of
    one engine at the mesh's graph axis; the tiled engine runs on the
    cluster-renumbered graph, ``extras["inverse"]`` mapping old ids to new."""
    from ssrg_torch.parallel import dist_spmm as D
    from ssrg_torch.parallel.partition import (cluster_reorder_for_partition, partition_rows,
                                               partition_rows_hybrid, partition_rows_tiled)

    d = mesh.shape["graph"]
    extras = {}
    if name == "coo":
        part = partition_rows(adj_norm, d)
        adj, fn = D.shard_adjacency(part, mesh), D.dist_propagate
    elif name.startswith("hybrid"):
        part = partition_rows_hybrid(adj_norm, d, halo=name.endswith("halo"))
        adj, fn = D.shard_adjacency_hybrid(part, mesh), D.dist_propagate_hybrid
    elif name == "tiled_cluster_halo":
        adj_c, x, _, inverse = cluster_reorder_for_partition(adj_norm, x)
        part = partition_rows_tiled(adj_c, d, halo=True)
        adj, fn = D.shard_adjacency_tiled(part, mesh), D.dist_propagate_tiled
        extras.update(inverse=inverse, tiled_fraction=part.tiled_fraction)
    elif name == "ring":
        part = D.partition_rows_ring(adj_norm, d)
        adj, fn = D.shard_adjacency_ring(part, mesh), D.dist_propagate_ring
    else:
        part = D.partition_rows_ring_hybrid(adj_norm, d)
        adj, fn = D.shard_adjacency_ring_hybrid(part, mesh), D.dist_propagate_ring_hybrid
    extras.update(block=part.block, halo_pad=getattr(part, "halo_pad", 0))
    return adj, D.shard_features(x, part, mesh), fn, extras


def dist_propagation(mesh, adj_norm, x, incore) -> dict:
    """Every engine of the distributed tier at the mesh's graph axis: K hops
    once counted (ELL launches a hop against the design) and checked (hop K
    gathered to rank 0, within ``DIST_TOL`` of in-core ``propagate``), then
    ``DIST_TIMED_RUNS`` times more timed, each hop split by CUDA events into
    its exchange and its local SpMM (for the ring, the wait left exposed
    after the bucket's SpMM), beside the bytes the exchange moved and
    ``comm_stats``."""
    import torch

    from ssrg_torch.parallel.dist_spmm import all_gather_hops, comm_stats

    d = mesh.shape["graph"]
    n, f = x.shape
    launches, hops_by_engine = {}, {}
    for name, mode, per_hop in DIST_ENGINES:
        t0 = time.perf_counter()
        adj, xs, fn, extras = dist_engine(name, mesh, adj_norm, x)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        reset_launches()
        hops = fn(adj, xs, DIST_STEPS)
        torch.cuda.synchronize()
        got = read_launches()
        expected = {k: (per_hop(d) * DIST_STEPS if k == "ell_spmm" else 0) for k in KERNELS}
        check(got == expected, f"dist {name} at D={d}: launched {got}, expected {expected}")
        full = all_gather_hops(hops if name == "hybrid_all_gather" else hops[-1:], mesh)
        stats = {}
        for _ in range(DIST_TIMED_RUNS):
            run = {}
            fn(adj, xs, DIST_STEPS, stats=run)
            for key, value in run.items():
                stats[key] = stats.get(key, []) + value if isinstance(value, list) else value
        rec = {"phase": "dist", "ranks": mesh.world_size, "graph_shards": d, "engine": name,
               "nodes": n, "features": f, "steps": DIST_STEPS, "host_s": host_s,
               "launches": got, "launches_per_hop": per_hop(d), **extras, **stats}
        rec.pop("inverse", None)
        if mesh.rank == 0:
            hop_k = full[-1]
            if "inverse" in extras:
                hop_k = hop_k[torch.as_tensor(extras["inverse"], device=hop_k.device)]
            err = float((hop_k[:n] - incore[-1]).abs().max())
            check(err <= DIST_TOL, f"dist {name} at D={d}: hop K off in-core by {err}")
            model = comm_stats(d, extras["block"], f, DIST_STEPS, mode=mode,
                               halo_pad=extras["halo_pad"])
            rec.update(hop_k_max_abs_err=err,
                       comm_stats_bytes_per_hop=model["bytes_per_device_per_hop"],
                       hop_ms_median=float(np.median(stats["hop_ms"])),
                       exchange_ms_median=float(np.median(stats["exchange_ms"])),
                       spmm_ms_median=float(np.median(stats["spmm_ms"])))
            rec["exchange_gb_per_s"] = (stats["exchange_bytes_per_hop"]
                                        / max(rec["exchange_ms_median"], 1e-9) / 1e6)
            emit(rec)
        if per_hop(d):
            launches[f"dist_{name}"] = got["ell_spmm"]
        if name == "hybrid_all_gather":
            hops_by_engine[name] = full
        del adj, xs, hops, full
        torch.cuda.empty_cache()
    return {"launches": launches, "hops": hops_by_engine.get("hybrid_all_gather")}


def dist_training(mesh, ds, adj_norm, x, data_axis, graph_hops, workdir) -> dict:
    """GAMLP (``ModelConfig`` defaults: hidden 256, K = 3) through
    ``build_spmd_context`` on the mesh: 3 ELL launches a precompute and none
    an epoch, ``DIST_EPOCHS`` of ``run_epochs_scan`` (finite losses, the same
    on every rank; best val >= 0.25), ``run_steps(ctx, 2)`` finite, and the
    hops within ``DIST_TOL`` of one-card ``NodeClassification``'s precompute
    (and, given ``graph_hops``, of that earlier run's). Then the graph
    spooled into one shard per graph position and
    ``build_spmd_context_from_spool`` (hybrid, all-gather), whose hops are
    the in-memory context's within ``DIST_SPOOL_TOL``."""
    import scipy.sparse as sp
    import torch
    import torch.distributed as dist

    from ssrg_torch.configs.config import ModelConfig, TrainingConfig
    from ssrg_torch.data.streaming import StreamingGraphMeta, stream_partition
    from ssrg_torch.models.zoo import load_model
    from ssrg_torch.parallel.dist_spmm import all_gather_hops
    from ssrg_torch.parallel.dist_train import (build_spmd_context, ensure_hops, run_epochs_scan,
                                                run_steps)
    from ssrg_torch.parallel.multihost import build_spmd_context_from_spool
    from ssrg_torch.train import NodeClassification

    n, f = x.shape
    cfg = ModelConfig(model_name="gamlp")
    k = cfg.prop_steps
    launches = {}
    t0 = time.perf_counter()
    ctx = build_spmd_context(adj_norm, x, ds.y, ds.train_idx,
                             load_model(cfg, f, NUM_CLASSES).module, mesh, k, lr=0.01,
                             data_axis=data_axis, val_idx=ds.val_idx, test_idx=ds.test_idx,
                             seed=SEED)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    reset_launches()
    ensure_hops(ctx)
    torch.cuda.synchronize()
    launches["dist_spmd_precompute"] = read_launches()["ell_spmm"]
    check(read_launches() == {"ell_spmm": k, "banded_spmm": 0, "rest_spmm": 0},
          f"dist spmd: the precompute launched {read_launches()}, expected ell_spmm {k}")
    reset_launches()
    t0 = time.perf_counter()
    ctx, res = run_epochs_scan(ctx, DIST_EPOCHS, seed=SEED)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    check(read_launches() == {"ell_spmm": 0, "banded_spmm": 0, "rest_spmm": 0},
          f"dist spmd: the epochs launched {read_launches()}, expected none")
    losses = torch.as_tensor(res.history[0], device=mesh.device)
    every = losses.new_empty(mesh.world_size * losses.numel())
    dist.all_gather_into_tensor(every, losses)
    check(bool((every.view(mesh.world_size, -1) == losses).all()),
          "dist spmd: the ranks' losses differ")
    check(bool(np.isfinite(res.history[0]).all()), f"dist spmd losses {res.history[0]}")
    check(res.best_val >= 0.25, f"dist spmd best val {res.best_val} < 0.25")
    ctx, step_loss = run_steps(ctx, 2, seed=SEED)
    check(np.isfinite(step_loss), f"dist spmd run_steps loss {step_loss}")
    hops = all_gather_hops(ctx.hops, mesh, axis=None)[:, :n]
    rec = {"phase": "dist", "run": "spmd_gamlp", "mesh": mesh.shape, "hidden": cfg.hidden_dim,
           "prop_steps": k, "epochs": DIST_EPOCHS, "build_s": build_s, "train_s": train_s,
           "epoch_ms": train_s / DIST_EPOCHS * 1e3, "losses": res.history[0].tolist(),
           "best_val": res.best_val, "best_test": res.best_test, "best_epoch": res.best_epoch,
           "run_steps_loss": step_loss, "comm": ctx.comm}
    if mesh.rank == 0:
        task = NodeClassification(ds, load_model(cfg, f, NUM_CLASSES), cfg,
                                  TrainingConfig(num_epochs=1), device="cuda", run=False)
        err = float((hops - task.prepared.inputs).abs().max())
        check(err <= DIST_TOL, f"dist spmd hops off NodeClassification's by {err}")
        rec["hops_vs_node_classification"] = err
        if graph_hops is not None:
            err = float((hops - graph_hops[:, :n]).abs().max())
            check(err <= DIST_SPOOL_TOL, f"dist spmd hops off the graph-axis run's by {err}")
            rec["hops_vs_graph_run"] = err
        del task
        emit(rec)

    spool = os.path.join(workdir, "spool")
    d = mesh.shape["graph"]
    t0 = time.perf_counter()
    if mesh.rank == 0:
        upper = sp.triu(ds.adj, k=1).tocoo()
        np.save(os.path.join(workdir, "edges.npy"),
                np.stack([upper.row, upper.col]).astype(np.int64))
        np.save(os.path.join(workdir, "features.npy"), x)
        meta = stream_partition(os.path.join(workdir, "edges.npy"), n, d, spool)
        fields = [meta.num_edges, meta.block]
    else:
        fields = [0, 0]
    dist.broadcast_object_list(fields, src=0)
    meta = StreamingGraphMeta(n, fields[0], fields[1], d, spool)
    spool_s = time.perf_counter() - t0
    reset_launches()
    sctx = build_spmd_context_from_spool(meta, os.path.join(workdir, "features.npy"), ds.y,
                                         ds.train_idx, load_model(cfg, f, NUM_CLASSES).module,
                                         mesh, k, lr=0.01, data_axis=data_axis,
                                         val_idx=ds.val_idx, test_idx=ds.test_idx, seed=SEED)
    ensure_hops(sctx)
    torch.cuda.synchronize()
    launches["dist_spool_precompute"] = read_launches()["ell_spmm"]
    check(read_launches()["ell_spmm"] == k,
          f"dist spool: the precompute launched {read_launches()}, expected ell_spmm {k}")
    shops = all_gather_hops(sctx.hops, mesh, axis=None)[:, :n]
    err = float((shops - hops).abs().max())
    check(err <= DIST_SPOOL_TOL, f"dist spool hops off the in-memory context's by {err}")
    if mesh.rank == 0:
        emit({"phase": "dist", "run": "spool", "graph_shards": d, "spool_s": spool_s,
              "spooled_entries": meta.num_edges, "block": meta.block,
              "hops_vs_in_memory": err})
    return {"launches": launches}


def _dist_rank(rank: int, world: int, store: str, graph: dict, workdir: str) -> dict:
    """One rank of :func:`phase_dist`: joins the NCCL world (a world of one
    in the calling process when ``world`` is 1), then runs the propagation
    checks on a ``graph`` axis of every rank and GAMLP on a ``(graph,
    data)`` mesh (``(2, 2)`` at four ranks)."""
    import torch
    import torch.distributed as dist

    from ssrg_torch.ops.propagate import propagate
    from ssrg_torch.ops.sparse import device_adjacency
    from ssrg_torch.parallel.mesh import TIMEOUT, backend_for, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if world > 1:   # a world of one starts in make_mesh
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        dist.init_process_group(backend_for(dev), init_method=f"file://{store}", rank=rank,
                                world_size=world, timeout=TIMEOUT)
    t0 = time.perf_counter()
    ds, adj_norm, x = dist_graph(graph)
    data_s = time.perf_counter() - t0
    mesh = make_mesh((world,), ("graph",), device="cuda")
    incore = None
    if rank == 0:
        incore = propagate(device_adjacency(adj_norm, "hybrid", device="cuda"), x, DIST_STEPS,
                           device="cuda")
        emit({"phase": "dist", "ranks": world, "data_s": data_s, "nnz": int(adj_norm.nnz),
              "backend": dist.get_backend()})
    prop = dist_propagation(mesh, adj_norm, x, incore)
    del incore
    torch.cuda.empty_cache()
    if world == 1:
        train_mesh, data_axis, graph_hops = mesh, None, None
    else:
        train_mesh = make_mesh((world // 2, 2), ("graph", "data"), device="cuda")
        data_axis, graph_hops = "data", prop["hops"]
    train = dist_training(train_mesh, ds, adj_norm, x, data_axis, graph_hops, workdir)
    dist.destroy_process_group()
    return {"launches": {**prop["launches"], **train["launches"]}}


def phase_dist(ranks: int = 1, graph: dict = None) -> dict:
    """The distributed tier on ``planetoid_like(**TRAIN_GRAPH)`` (or
    ``graph``) at K = 3: with ``ranks=1`` a world of one NCCL rank in this
    process; with more, one process per card (``cuda:0..ranks-1``) joined
    through a ``file://`` store. Propagation (every engine, against in-core
    ``propagate``), SPMD GAMLP and spool ingestion, as :func:`_dist_rank`
    sets out. The process group ends with the phase. Returns rank 0's ELL
    launches by path (one rank in this process), else None."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    out = None
    with tempfile.TemporaryDirectory() as root:
        store = os.path.join(root, "store")
        if ranks == 1:
            out = _dist_rank(0, 1, store, graph, root)
        else:
            mp.start_processes(_dist_rank, args=(ranks, store, graph, root), nprocs=ranks,
                               join=True, start_method="spawn")
    emit({"phase": "dist", "ranks": ranks, "seconds": time.perf_counter() - t0})
    return out


# --- the command line ----------------------------------------------------------

CLI_EPOCHS = 20
CLI_SPMD_STEPS = 20
CLI_MIN_VAL = 0.25          # ten times chance over 40 classes
# a predicted label may differ from the directly built Predictor's only where
# that predictor's top two logits lie closer than this (float32 sums of the
# hybrid tail, added by atomics, may round either way there)
CLI_TIE_GAP = 1e-4
CLI_MODEL = ["--model_name", "gamlp", "--hidden_dim", "256", "--num_layers", "3",
             "--prop_steps", "3"]


def cli_call(step: str, argv: list) -> tuple:
    """``ssrg_torch.cli.main(argv)`` in this process, its standard output
    captured, the launch counts set to 0 just before it and read just
    after, timed on the host clock. Checks exit code 0. Returns (the
    output, the launches, the seconds)."""
    import contextlib
    import io

    import torch

    from ssrg_torch import cli

    buf = io.StringIO()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    out = buf.getvalue()
    check(rc == 0, f"cli {step}: exit code {rc}; its output ends {out[-2000:]!r}")
    return out, launches, seconds


def cli_launches(step: str, got: dict, expected: dict) -> None:
    want = {name: expected.get(name, 0) for name in KERNELS}
    check(got == want, f"cli {step} launched {got}, expected {want}")


def phase_cli() -> None:
    """``ssrg-torch`` on the card, through ``ssrg_torch.cli.main`` in this
    process: ``planetoid_like(**TRAIN_GRAPH)`` written as a dataset
    directory (``sparsify_dataset`` at rates 0, 0), then ``train`` (GAMLP at
    full width, minibatches of 10,000, a checkpoint), ``predict`` from that
    checkpoint, ``spmd`` at its defaults (tiled, halo, cluster) on a world of
    one NCCL rank, and ``bench`` at its defaults. Checks: each exit code 0;
    each command's launches (train, predict and spmd: the ELL kernel K = 3
    times; bench: the ELL kernel for the headline and sharded tiers, the rest
    kernel for the clustered tier and the banded kernel for the banded one,
    three runs of ``iters * K`` hops each); train's best val >= 0.25 and its
    checkpoint written; the predicted labels of the test split equal those
    of a ``Predictor`` built here from the same checkpoint (but at near
    ties, ``CLI_TIE_GAP``); spmd's best val finite and no process group left
    after it; the bench's nnz and every rate finite and positive."""
    import math
    import re

    import torch
    import torch.distributed as dist

    from ssrg_torch.configs.config import ModelConfig, TrainingConfig
    from ssrg_torch.data.sparsity import load_homo_simplex_sparsity_dataset
    from ssrg_torch.data.synthetic import planetoid_like
    from ssrg_torch.models.zoo import load_model
    from ssrg_torch.pipelines import sparsify_dataset
    from ssrg_torch.serve import Predictor

    t0 = time.perf_counter()
    name = "arxiv_like_0.0_0.0"
    with tempfile.TemporaryDirectory() as root:
        ds = planetoid_like(**TRAIN_GRAPH)
        sparsify_dataset(ds, 0.0, 0.0, os.path.join(root, name), seed=SEED)
        test_size = len(ds.test_idx)
        del ds
        data = ["--data_name", name, "--data_root", root]
        emit({"phase": "cli", "step": "data", "seconds": time.perf_counter() - t0,
              "nodes": NUM_NODES, "test_nodes": test_size})

        ckpt = os.path.join(root, "gamlp.ckpt")
        argv = ["train", *data, *CLI_MODEL, "--train_batch_size", "10000",
                "--num_epochs", str(CLI_EPOCHS), "--checkpoint_path", ckpt]
        out, got, seconds = cli_call("train", argv)
        m = re.search(r"Best val: ([0-9.]+), best test: ([0-9.]+)", out)
        check(m is not None, f"cli train printed no best val: {out[-2000:]!r}")
        best_val, best_test = float(m.group(1)), float(m.group(2))
        check(best_val >= CLI_MIN_VAL, f"cli train best val {best_val} < {CLI_MIN_VAL}")
        check(os.path.isfile(ckpt), f"cli train wrote no checkpoint at {ckpt}")
        cli_launches("train", got, {"ell_spmm": 3})
        emit({"phase": "cli", "step": "train", "argv": argv, "seconds": seconds,
              "launches": got, "best_val": best_val, "best_test": best_test})

        labels_path = os.path.join(root, "labels.npy")
        argv = ["predict", *data, *CLI_MODEL, "--checkpoint", ckpt, "--out", labels_path]
        out, got, seconds = cli_call("predict", argv)
        cli_launches("predict", got, {"ell_spmm": 3})
        labels = np.load(labels_path)
        check(labels.shape == (test_size,),
              f"cli predict wrote labels of shape {labels.shape}, expected ({test_size},)")
        check(f"wrote {test_size} predictions" in out, f"cli predict printed {out[-500:]!r}")
        sp_ds = load_homo_simplex_sparsity_dataset(name, root)
        cfg = ModelConfig(model_name="gamlp", hidden_dim=256, num_layers=3, prop_steps=3)
        pred = Predictor(sp_ds, load_model(cfg, sp_ds.num_features, sp_ds.num_classes), cfg,
                         TrainingConfig(), checkpoint_path=ckpt, device="cuda")
        logits = pred.logits(np.asarray(sp_ds.test_idx))
        direct = logits.argmax(dim=-1).cpu().numpy()
        top2 = torch.topk(logits, 2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        differ = labels != direct
        check(not differ[gap > CLI_TIE_GAP].any(),
              f"cli predict's labels differ from Predictor's at {int(differ.sum())} nodes, "
              f"{int(differ[gap > CLI_TIE_GAP].sum())} of them beyond a gap of {CLI_TIE_GAP}")
        emit({"phase": "cli", "step": "predict", "argv": argv, "seconds": seconds,
              "launches": got, "labels": int(labels.size),
              "labels_differing": int(differ.sum()),
              "near_ties": int((gap <= CLI_TIE_GAP).sum())})
        del pred, logits, sp_ds
        torch.cuda.empty_cache()

        check(not dist.is_initialized(), "a process group is live before cli spmd")
        argv = ["spmd", *data, "--steps", str(CLI_SPMD_STEPS)]
        out, got, seconds = cli_call("spmd", argv)
        check(not dist.is_initialized(), "cli spmd left its process group behind")
        m = re.search(r"best val ([0-9.naif]+), best test ([0-9.naif]+)", out)
        check(m is not None, f"cli spmd printed no best val: {out[-2000:]!r}")
        spmd_val, spmd_test = float(m.group(1)), float(m.group(2))
        check(math.isfinite(spmd_val) and math.isfinite(spmd_test),
              f"cli spmd best val {spmd_val}, best test {spmd_test}")
        check("spmd: mesh {'graph': 1}, engine tiled, comm halo" in out,
              f"cli spmd printed {out[-2000:]!r}")
        cli_launches("spmd", got, {"ell_spmm": 3})
        emit({"phase": "cli", "step": "spmd", "argv": argv, "seconds": seconds,
              "launches": got, "best_val": spmd_val, "best_test": spmd_test,
              "line": out.strip().splitlines()[-1]})
    torch.cuda.empty_cache()

    out, got, seconds = cli_call("bench", ["bench"])
    result = json.loads(out.strip().splitlines()[-1])
    check(result["nnz"] == BENCH_NNZ, f"cli bench: nnz {result['nnz']}, expected {BENCH_NNZ}")
    rates = {k: v for k, v in result.items()
             if k == "value" or k.startswith("vs_") or k.endswith(("_edges_per_s", "_vs_bare"))}
    check(all(isinstance(v, (int, float)) and math.isfinite(v) and v > 0
              for v in rates.values()), f"cli bench rates {rates}")
    hops = result["iters"] * result["prop_steps"]
    # a warm run and two timed runs of each tier; no trace here
    cli_launches("bench", got, {"ell_spmm": 2 * 3 * hops, "rest_spmm": 3 * hops,
                                "banded_spmm": 3 * hops})
    check_banded_paths("cli bench", banded_paths(), tensor_core=3 * hops)
    emit({"phase": "cli", "step": "bench", "seconds": seconds, "launches": got,
          "rates": rates})
    emit({"phase": "cli", "seconds": time.perf_counter() - t0})


# --- the bench entry point -----------------------------------------------------

# the bench's functions that each drive one tier, and the kernel each launches
BENCH_TIERS = (("device_edges_per_s", "headline", "ell_spmm"),
               ("sharded_tier_metrics", "sharded", "ell_spmm"),
               ("clustered_tier_metrics", "clustered", "rest_spmm"),
               ("banded_tier_metrics", "banded", "banded_spmm"))


def phase_bench(trace_dir: str) -> None:
    """``run_bench()`` at its defaults on the card, its headline hops traced.
    Each tier's function is wrapped so that the launch counts are set to 0
    just before it and read just after. Checks: the headline, library,
    clustered and banded rates finite and positive; the headline graph's
    nnz; the sharded rate and its ratio to the headline's finite and
    positive; each tier launched only its kernel, once a hop of each of its
    runs (a warm run and two timed runs, and the traced run of the headline)."""
    import math

    import torch

    from ssrg_torch import bench

    counted, counted_paths = {}, {}
    originals = {name: getattr(bench, name) for name, _, _ in BENCH_TIERS}

    def counting(fn, tier):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            reset_launches()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            counted[tier] = read_launches()
            counted_paths[tier] = banded_paths()
            return out
        return run

    for name, tier, _ in BENCH_TIERS:
        setattr(bench, name, counting(originals[name], tier))
    t0 = time.perf_counter()
    result = bench.run_bench(trace_dir=trace_dir)
    seconds = time.perf_counter() - t0
    for name, _, _ in BENCH_TIERS:
        setattr(bench, name, originals[name])

    for key in ("value", "library_edges_per_s", "sharded_edges_per_s", "sharded_vs_bare",
                "clustered_edges_per_s", "banded_pallas_edges_per_s"):
        check(math.isfinite(result[key]) and result[key] > 0, f"bench: {key} = {result[key]}")
    check(result["nnz"] == BENCH_NNZ, f"bench: nnz {result['nnz']}, expected {BENCH_NNZ}")
    hops = result["iters"] * result["prop_steps"]
    for _, tier, kernel in BENCH_TIERS:
        runs = 4 if tier == "headline" else 3
        expected = {name: (runs * hops if name == kernel else 0) for name in KERNELS}
        check(counted.get(tier) == expected,
              f"bench {tier} tier launched {counted.get(tier)}, expected {expected}")
        # the banded tier's pack is bf16: the tensor-core path
        check_banded_paths(f"bench {tier} tier", counted_paths[tier],
                           tensor_core=expected["banded_spmm"])
    emit({"phase": "bench", "seconds": seconds, "launches_by_tier": counted,
          "trace": check_trace(result["trace"], "bench headline")})


def main() -> int:
    parser = argparse.ArgumentParser(description="Drive ssrg_torch on one CUDA card.")
    parser.add_argument("--trace_dir", default=None,
                        help="keep the device traces here (default: a temporary directory)")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a "
              "CUDA card", file=sys.stderr)
        return 2
    # the port must come from this checkout, not from an installed copy
    import ssrg_torch

    here = os.path.dirname(os.path.abspath(__file__))
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(ssrg_torch.__file__)))
    if pkg_root != here:
        print(f"chip_smoke: ssrg_torch was imported from {pkg_root}, not from the "
              f"checkout at {here}", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    trace_tmp = None if args.trace_dir else tempfile.TemporaryDirectory()
    trace_root = args.trace_dir or trace_tmp.name

    from ssrg_torch.data.synthetic import powerlaw_graph, random_graph
    from ssrg_torch.ops.normalize import sym_norm
    from ssrg_torch.ops.sparse import build_hybrid

    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0)})
    phase_build()
    native_rec = build_native()

    t0 = time.perf_counter()
    ds = random_graph(NUM_NODES, AVG_DEGREE, NUM_FEATURES, num_classes=NUM_CLASSES,
                      seed=SEED)
    adj_norm = sym_norm(ds.adj, 0.5)
    pg = powerlaw_graph(NUM_NODES, AVG_DEGREE, NUM_FEATURES, seed=SEED)
    normalized = {name: (adj, build_hybrid(adj).ell.width)
                  for name, adj in (("headline", adj_norm), ("powerlaw", sym_norm(pg.adj, 0.5)))}
    del pg
    emit({"phase": "data", "host_s": time.perf_counter() - t0, "nnz": int(adj_norm.nnz),
          "width": normalized["headline"][1], "powerlaw_width": normalized["powerlaw"][1]})
    phase_native(native_rec, normalized)
    del normalized

    kernel_summary = phase_kernels()
    phase_slice(ds, adj_norm)
    phase_layers(ds, prop_steps=3)
    del ds, adj_norm
    torch.cuda.empty_cache()
    phase_locality(prop_steps=3)
    torch.cuda.empty_cache()
    phase_train(trace_root)
    torch.cuda.empty_cache()
    phase_spectral()
    torch.cuda.empty_cache()
    phase_robust(trace_root)
    torch.cuda.empty_cache()
    phase_baseline()
    torch.cuda.empty_cache()
    phase_ooc()
    torch.cuda.empty_cache()
    phase_dist()
    torch.cuda.empty_cache()
    phase_cli()
    torch.cuda.empty_cache()
    phase_bench(os.path.join(trace_root, "bench_headline"))
    emit({"kernels": kernel_summary})
    print(card_line(), flush=True)
    if trace_tmp is not None:
        trace_tmp.cleanup()
    # the run drives one card, whatever else the machine holds
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": 1}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
