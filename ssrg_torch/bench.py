"""K-hop SpMM precompute benchmark (counterpart of ``ssrg_tpu/bench.py``):
the framework's headline metric, ``khop_spmm_edges_per_s``, on the card.

    python -m ssrg_torch.bench [--nodes N] [--degree D] [--features F]
                               [--prop_steps K] [--spmm_engine E] [--device cuda|cpu]

prints one JSON line. edges/s = hops * nnz / seconds, where the hops of a
tier are issued back to back and timed between two CUDA events (the host
clock on the CPU), best of two timed runs after a warm one. Tiers:

- the headline: ``device_adjacency(engine)`` (``auto``: hybrid at the
  default size, so the ELL kernel ``csrc/ell_spmm.cu`` plus the COO tail) on
  ``make_benchmark_graph``; beside it the same hops through
  ``torch.sparse.mm`` on the CSR (``library_edges_per_s``) and, on the host,
  scipy CSR @ dense or the reference's C kernel (``baseline_edges_per_s``);
- clustered: ``community_graph`` -> label propagation
  (``cluster_permutation``) -> ``build_tiled`` in bf16 with the segmented
  rest, as ``reorder_tiled`` + ``spmm_bf16`` packs it: ``torch.bmm`` tiles
  and the rest kernel ``csrc/rest_spmm.cu``;
- banded: ``PallasBandedAdj`` over seeded random bf16 blocks with a bf16
  window, on the banded kernel ``csrc/banded_spmm.cu``;
- sharded: the headline graph through the distributed tier's hybrid engine
  on a mesh of one rank (``sharded_edges_per_s``; ``sharded_vs_bare`` is its
  rate over the headline's).

On the CPU the tiers shrink, and the numbers are only liveness checks. A
tier that fails raises: the run fails with it.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import scipy.sparse as sp
import torch

from ssrg_torch.logger import PhaseTimer, device_trace
from ssrg_torch.utils import DeviceLike, resolve_device, synchronize

# the reference's prebuilt C OpenMP CSR kernel (``libmatmul.so``), when this
# environment variable names one
REFERENCE_SO_ENV = "SSRG_REFERENCE_MATMUL_SO"
H100_HBM_GB_PER_S = 3350.0   # H100 SXM device memory (data sheet)
CPU_CLUSTERED_NODES = 32_768  # the clustered tier's size cap on the CPU
SEED = 0                      # the benchmark graph's and every tier's data


def make_benchmark_graph(
    num_nodes: int, avg_degree: float, num_features: int, seed: int = 0,
    kind: str = "uniform",
):
    """Random graph with ogbn-arxiv-like statistics, sym-normalized, and
    its features. ``kind='powerlaw'`` is the hub-heavy degree distribution
    (the stress case of the hybrid format's overflow tail)."""
    from ssrg_torch.data.synthetic import powerlaw_graph, random_graph
    from ssrg_torch.ops.normalize import sym_norm

    if kind == "powerlaw":
        g = powerlaw_graph(num_nodes, avg_degree, num_features, seed=seed)
    else:
        g = random_graph(num_nodes, avg_degree, num_features, seed=seed)
    return sym_norm(g.adj, 0.5), g.x


def _reference_kernel(adj: sp.csr_matrix, path: Optional[str] = None):
    """The reference's OMP CSR kernel as ``spmm(x)``, or None when ``path``
    (default: ``$SSRG_REFERENCE_MATMUL_SO``) names no file. A file that
    exists but does not load raises."""
    import ctypes

    import numpy.ctypeslib as ctl

    path = os.environ.get(REFERENCE_SO_ENV, "") if path is None else path
    if not path or not os.path.exists(path):
        return None
    lib = ctypes.CDLL(path)
    arr_f = ctl.ndpointer(dtype=np.float32, ndim=1, flags="CONTIGUOUS")
    arr_i = ctl.ndpointer(dtype=np.int32, ndim=1, flags="CONTIGUOUS")
    fn = lib.FloatCSRMulDenseOMP
    fn.argtypes = [arr_f, arr_f, arr_i, arr_i, arr_f, ctypes.c_int, ctypes.c_int]
    fn.restype = None
    data = adj.data.astype(np.float32)
    indices = adj.indices.astype(np.int32)
    indptr = adj.indptr.astype(np.int32)

    def spmm(x: np.ndarray) -> np.ndarray:
        out = np.zeros(x.size, np.float32)
        fn(out, data, indices, indptr, np.ascontiguousarray(x, np.float32).reshape(-1),
           x.shape[0], x.shape[1])
        return out.reshape(x.shape)

    return spmm


def seeded_features(n: int, f: int, device: DeviceLike, seed: int = 0) -> torch.Tensor:
    """``[n, f]`` standard normal features drawn on ``device`` from a
    seeded generator (nothing crosses from the host)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((n, f), generator=gen, device=dev, dtype=torch.float32)


@torch.no_grad()
def sgc_precompute(adj_dev, x, prop_steps: int,
                   device: DeviceLike = "cuda") -> tuple[torch.Tensor, list]:
    """K hops of ``adj_dev`` (an adjacency already on ``device``) from
    ``x``, each timed on the host clock after a synchronize of the card:
    the per-hop timing hook. Returns (hop K, [seconds of each hop])."""
    dev = resolve_device(device)
    h = torch.as_tensor(x, dtype=torch.float32, device=dev)
    times = []
    for _ in range(prop_steps):
        t0 = time.perf_counter()
        h = adj_dev.spmm(h)
        synchronize(dev)
        times.append(time.perf_counter() - t0)
    return h, times


def baseline_edges_per_s(
    adj: sp.csr_matrix, x: np.ndarray, prop_steps: int, iters: int = 2
) -> tuple[float, str]:
    """Host baseline: the reference's C kernel when one is named, else
    scipy CSR @ dense."""
    kernel = _reference_kernel(adj)
    name = "reference_c_omp" if kernel is not None else "scipy_csr"
    if kernel is None:
        kernel = lambda h: adj @ h  # noqa: E731
    h = kernel(x)  # warm-up
    t0 = time.perf_counter()
    for _ in range(iters):
        h = x
        for _ in range(prop_steps):
            h = kernel(h)
    dt = time.perf_counter() - t0
    return iters * prop_steps * adj.nnz / dt, name


@torch.no_grad()
def _time_hops(spmm: Callable, x: torch.Tensor, hops: int) -> float:
    """Seconds for ``hops`` SpMMs issued back to back from ``x``: between two
    CUDA events on the card, on the host clock (the hops run eagerly) on the
    CPU."""
    if x.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        h = x
        for _ in range(hops):
            h = spmm(h)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    h = x
    for _ in range(hops):
        h = spmm(h)
    return time.perf_counter() - t0


def _best_rate(spmm: Callable, x: torch.Tensor, nnz: int, total_hops: int,
               reps: int = 2) -> tuple[float, float]:
    """``(best edges/s, relative spread)`` of ``reps`` timed runs."""
    rates = [total_hops * nnz / _time_hops(spmm, x, total_hops) for _ in range(max(reps, 1))]
    best = max(rates)
    return best, (best - min(rates)) / best


def _scan_hops_edges_per_s(
    spmm: Callable, x_dev: torch.Tensor, nnz: int, total_hops: int, reps: int = 2,
) -> tuple[float, float]:
    """Throughput of ``total_hops`` hops: one warm run, then the best of
    ``reps`` timed runs and their relative spread."""
    _time_hops(spmm, x_dev, total_hops)
    return _best_rate(spmm, x_dev, nnz, total_hops, reps)


def device_edges_per_s(
    adj: sp.csr_matrix, x: Optional[np.ndarray], prop_steps: int,
    engine: str = "auto", iters: int = 10, num_features: Optional[int] = None,
    diag: Optional[dict] = None, device: DeviceLike = "cuda",
    trace_dir: Optional[str] = None,
) -> float:
    """K-hop propagation throughput of ``engine`` on ``device``: a warm run,
    then ``iters * prop_steps`` hops back to back, timed twice; the best.

    When ``x is None`` the features are drawn on the device
    (``num_features`` columns, seed 0). ``diag`` (if given) collects the
    phases' seconds, the spread, the same hops through ``torch.sparse.mm``
    (``library_edges_per_s``), the gather engines' traffic model and, on an
    H100, the share of device memory's rate it reaches. ``trace_dir`` traces
    one more run of the hops with :class:`ssrg_torch.logger.device_trace`
    and adds its top operations and device-busy share to ``diag``."""
    from ssrg_torch.ops.sparse import DENSE_THRESHOLD, device_adjacency

    dev = resolve_device(device)
    timer = PhaseTimer()
    with timer.measure("build_transfer"):
        adj_dev = device_adjacency(adj, engine, device=dev)
        if x is not None:
            x_dev = torch.as_tensor(np.asarray(x, np.float32), device=dev)
        else:
            x_dev = seeded_features(adj.shape[1], int(num_features), dev)
        synchronize(dev)
    f = int(x_dev.shape[1])
    total_hops = iters * prop_steps
    with timer.measure("first_exec"):
        _time_hops(adj_dev.spmm, x_dev, total_hops)
    rate, spread = _best_rate(adj_dev.spmm, x_dev, adj.nnz, total_hops)
    dt = total_hops * adj.nnz / rate
    if diag is None:
        return rate
    diag.update(headline_spread=spread, build_transfer_s=timer.phases["build_transfer"],
                first_exec_s=timer.phases["first_exec"], measure_s=dt, device=dev.type)
    if trace_dir is not None:
        with device_trace(trace_dir, device=dev) as trace:
            _time_hops(adj_dev.spmm, x_dev, total_hops)
            synchronize(dev)
        diag["trace"] = {"path": trace.path, "hops": total_hops,
                         "top_ops": trace.top_ops(5), **trace.busy_share()}
    del adj_dev
    csr = sp.csr_matrix(adj)
    lib = torch.sparse_csr_tensor(
        torch.as_tensor(csr.indptr, dtype=torch.int64), torch.as_tensor(csr.indices,
                                                                        dtype=torch.int64),
        torch.as_tensor(csr.data, dtype=torch.float32), size=csr.shape).to(dev)
    lib_rate, lib_spread = _scan_hops_edges_per_s(
        lambda h: torch.sparse.mm(lib, h), x_dev, adj.nnz, total_hops)
    diag.update(library_edges_per_s=lib_rate, library_spread=lib_spread,
                library="torch.sparse.mm, f32 CSR")
    # the gather engines' traffic model (per hop: one F-row read per edge,
    # the edge's index and weight, the output written once); it does not
    # describe the dense engine. It counts gathers, not device-memory
    # traffic: L2 serves many of the gathered rows. hbm_frac counts the
    # compulsory bytes instead (x read once, each edge's index and weight,
    # the output written once)
    resolved = engine
    if engine == "auto":
        resolved = "dense" if adj.shape[0] <= DENSE_THRESHOLD else "hybrid"
    if resolved in ("coo", "ell", "hybrid"):
        bytes_per_hop = adj.nnz * (f * 4 + 8) + adj.shape[0] * f * 4
        flops_per_hop = 2 * adj.nnz * f
        diag["achieved_gbps"] = bytes_per_hop * total_hops / dt / 1e9
        diag["achieved_gflops"] = flops_per_hop * total_hops / dt / 1e9
        if dev.type == "cuda" and "H100" in torch.cuda.get_device_name(dev):
            compulsory = adj.nnz * 8 + (adj.shape[0] + adj.shape[1]) * f * 4
            diag["hbm_frac"] = compulsory * total_hops / dt / 1e9 / H100_HBM_GB_PER_S
    return rate


def clustered_tier_metrics(num_nodes: int, num_features: int, prop_steps: int, iters: int,
                           device: DeviceLike = "cuda") -> dict:
    """The clustered pipeline from a raw shuffled community graph: label
    propagation, renumbering, the bf16 tiled pack with the segmented rest
    (as ``reorder_tiled`` + ``spmm_bf16``), then the K-hop rate. Capped at
    ``CPU_CLUSTERED_NODES`` nodes on the CPU."""
    from ssrg_torch.data.synthetic import community_graph
    from ssrg_torch.ops.normalize import sym_norm
    from ssrg_torch.ops.reorder import apply_permutation, cluster_permutation, reorder_plan
    from ssrg_torch.ops.sparse import build_tiled

    dev = resolve_device(device)
    n_c = num_nodes if dev.type == "cuda" else min(num_nodes, CPU_CLUSTERED_NODES)
    adj = sym_norm(community_graph(n_c), 0.5)
    _, _, _, kwargs = reorder_plan("reorder_tiled", dev, spmm_bf16=True)
    timer = PhaseTimer()
    with timer.measure("build"):
        with timer.measure("reorder"):
            perm = cluster_permutation(adj)
        adj_p, _, _, _ = apply_permutation(adj, perm)
        tiled = build_tiled(adj_p, device=dev, mem_budget_bytes=8 << 30, **kwargs).to(dev)
        synchronize(dev)
    x = seeded_features(n_c, num_features, dev)
    rate, spread = _scan_hops_edges_per_s(tiled.spmm, x, adj.nnz, iters * prop_steps)
    return {"clustered_build_s": timer.phases["build"],
            "clustered_reorder_s": timer.phases["reorder"],
            "clustered_edges_per_s": rate, "clustered_spread": spread,
            "clustered_hop_ms": adj.nnz / rate * 1e3,
            "clustered_tiled_fraction": tiled.tiled_fraction, "clustered_num_nodes": n_c,
            "clustered_nnz": int(adj.nnz)}


def banded_tier_inputs(num_features: int, device: DeviceLike = "cuda") -> tuple:
    """The banded tier's pack and x, drawn on ``device`` from seeded
    generators: ``(blocks, los, x)``. A bandwidth-1000 band at 512-row
    blocks: random bf16 blocks of 330 x 512 x 2,432, every entry nonzero;
    on the CPU 2 blocks and a window that fits."""
    dev = resolve_device(device)
    row_block, window = 512, 2432
    nb = 330 if dev.type == "cuda" else 2
    n = nb * row_block
    window = min(window, (n // 16) * 16)
    los = np.maximum(0, np.minimum(np.arange(nb) * row_block - window // 2, n - window))
    los = ((los // 16) * 16).astype(np.int32)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    blocks = torch.randn((nb, row_block, window), generator=gen, device=dev).bfloat16()
    x = seeded_features(n, num_features, dev, seed=SEED + 1)
    return blocks, torch.as_tensor(los, device=dev), x


def banded_tier_metrics(num_features: int, prop_steps: int, iters: int,
                        device: DeviceLike = "cuda") -> dict:
    """The banded kernel on :func:`banded_tier_inputs` with a bf16 window,
    edges/s counted at the headline graph's 2,489,237 edges. The blocks are
    bf16, so the kernel's tensor-core path takes them, a dense product of
    every entry. On the CPU: 10,000 model edges, 2 hops."""
    from ssrg_torch.ops.pallas_banded import PallasBandedAdj

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    nnz_model = 2_489_237 if on_card else 10_000
    blocks, los, x = banded_tier_inputs(num_features, dev)
    nb, row_block, window = blocks.shape
    n = nb * row_block
    banded = PallasBandedAdj(blocks, los, n, n, row_block, window_bf16=True)
    hops = iters * prop_steps if on_card else 2
    rate, spread = _scan_hops_edges_per_s(banded.spmm, x, nnz_model, hops)
    return {"banded_pallas_edges_per_s": rate, "banded_pallas_spread": spread,
            "banded_pallas_hop_ms": nnz_model / rate * 1e3,
            # every entry is nonzero: a multiply-add per entry and feature
            "banded_pallas_flops_per_hop": 2.0 * nb * row_block * window * num_features,
            "banded_pallas_blocks": [nb, row_block, window]}


def fast_tier_metrics(
    num_nodes: int = 169_343, num_features: int = 128, prop_steps: int = 3,
    iters: int = 10, device: DeviceLike = "cuda",
) -> dict:
    """The locality engines' rows: :func:`clustered_tier_metrics` and
    :func:`banded_tier_metrics`, in the headline's process."""
    out = clustered_tier_metrics(num_nodes, num_features, prop_steps, iters, device)
    if resolve_device(device).type == "cuda":
        torch.cuda.empty_cache()
    out.update(banded_tier_metrics(num_features, prop_steps, iters, device))
    return out


def sharded_tier_metrics(adj, num_features: int, prop_steps: int, iters: int = 10,
                         device: DeviceLike = "cuda") -> dict:
    """The hybrid engine under the distributed tier, on a mesh of one rank
    over the headline graph in this process (a world of one is started when
    none runs, and ended after): :func:`dist_propagate_hybrid` one hop at a
    time, ``iters * prop_steps`` hops timed as the headline's are, so that
    ``sharded_edges_per_s`` over the headline ``value`` is the distributed
    wrapper's overhead (its all-gather and hop stacking)."""
    import torch.distributed as dist

    from ssrg_torch.parallel.dist_spmm import dist_propagate_hybrid, shard_adjacency_hybrid
    from ssrg_torch.parallel.mesh import make_mesh
    from ssrg_torch.parallel.partition import partition_rows_hybrid

    dev = resolve_device(device)
    started = not dist.is_initialized()
    mesh = make_mesh((1,), ("graph",), device=dev)
    part = partition_rows_hybrid(adj, 1)
    sharded = shard_adjacency_hybrid(part, mesh)
    x = seeded_features(part.n_pad, num_features, dev, seed=2)
    rate, spread = _scan_hops_edges_per_s(lambda h: dist_propagate_hybrid(sharded, h, 1)[1],
                                          x, adj.nnz, iters * prop_steps)
    del sharded, x
    if started:
        dist.destroy_process_group()
    return {"sharded_edges_per_s": rate, "sharded_spread": spread}


def run_bench(
    num_nodes: int = 169_343,
    avg_degree: float = 13.7,
    num_features: int = 128,
    prop_steps: int = 3,
    engine: str = "auto",
    iters: int = 10,
    emit: bool = True,
    device: DeviceLike = "cuda",
    trace_dir: Optional[str] = None,
) -> dict:
    """The headline, the host baseline and the sharded, clustered and banded
    tiers; prints the result as one JSON line when ``emit``."""
    dev = resolve_device(device)
    adj, x = make_benchmark_graph(num_nodes, avg_degree, num_features, SEED)
    diag: dict = {}
    rate = device_edges_per_s(adj, None, prop_steps, engine, iters,
                              num_features=num_features, diag=diag, device=dev,
                              trace_dir=trace_dir)
    base, base_name = baseline_edges_per_s(adj, x, prop_steps)
    result = {
        "metric": "khop_spmm_edges_per_s",
        "value": rate,
        "unit": "edges/s",
        "vs_baseline": rate / base,
        "vs_library": rate / diag["library_edges_per_s"],
        "baseline": base_name,
        "baseline_edges_per_s": base,
        "nnz": int(adj.nnz),
        "num_nodes": num_nodes,
        "num_features": num_features,
        "prop_steps": prop_steps,
        "iters": iters,
        "engine": engine,
        **diag,
    }
    if dev.type == "cuda":
        result["device_name"] = torch.cuda.get_device_name(dev)
    result.update(sharded_tier_metrics(adj, num_features, prop_steps, iters, dev))
    result["sharded_vs_bare"] = result["sharded_edges_per_s"] / rate
    del adj, x
    result.update(fast_tier_metrics(num_nodes, num_features, prop_steps, iters, dev))
    if emit:
        print(json.dumps(result), flush=True)
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m ssrg_torch.bench",
                                     description="K-hop SpMM precompute benchmark")
    parser.add_argument("--nodes", type=int, default=169_343)
    parser.add_argument("--degree", type=float, default=13.7)
    parser.add_argument("--features", type=int, default=128)
    parser.add_argument("--prop_steps", type=int, default=3)
    parser.add_argument("--spmm_engine", default="auto")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    run_bench(num_nodes=args.nodes, avg_degree=args.degree, num_features=args.features,
              prop_steps=args.prop_steps, engine=args.spmm_engine, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
