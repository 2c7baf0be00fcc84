"""SpMM engine autotuner (counterpart of ``ssrg_tpu/ops/autotune.py``).

Packs each candidate engine for the graph, times a chain of hops on random
features and returns the fastest engine with every engine's seconds per
hop. On the card the hops are timed with CUDA events, on the CPU with the
host clock.

One difference by design: the reference skips a candidate on any
exception; the port skips it only on ``ValueError``, the pack functions'
"this graph does not suit the engine" refusal, so that a kernel fault
raises.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Sequence, Tuple

import scipy.sparse as sp
import torch

from ssrg_torch.ops.sparse import Adjacency, device_adjacency
from ssrg_torch.utils import DeviceLike, resolve_device

log = logging.getLogger("ssrg_torch")


def _time_engine(adj_dev: Adjacency, x: torch.Tensor, reps: int) -> float:
    """Seconds per hop over ``reps`` chained hops, after one warm-up hop.
    The carry is chained (``h = A h``) as in the reference."""
    adj_dev.spmm(x)
    if x.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        h = x
        for _ in range(reps):
            h = adj_dev.spmm(h)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    h = x
    for _ in range(reps):
        h = adj_dev.spmm(h)
    return (time.perf_counter() - t0) / reps


def autotune_engine(
    adj: sp.spmatrix,
    feature_dim: int,
    candidates: Sequence[str] = (
        "dense", "coo", "ell", "hybrid", "banded", "tiled", "pallas_banded",
        "reorder_banded", "reorder_tiled",
    ),
    reps: int = 8,
    dense_limit: int = 16384,
    seed: int = 0,
    verbose: bool = False,
    dense_block_budget_bytes: int = 256 << 20,
    device: DeviceLike = "cuda",
) -> Tuple[str, Dict[str, float]]:
    """Return ``(best_engine_name, seconds per hop by engine)``.

    ``dense_block_budget_bytes`` caps the banded candidates: a timing sample
    needs no multi-GiB pack, and a graph whose banded pack exceeds it skips
    them. ``pallas_banded`` is not timed on the CPU, where it would time the
    kernel's plain version. The meta-engines time their dense-block engine
    on the reordered graph (a hop costs the same in either numbering)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((adj.shape[1], feature_dim), generator=gen, device=dev)
    timings: Dict[str, float] = {}
    for name in candidates:
        if name == "dense" and adj.shape[0] > dense_limit:
            continue
        if name == "pallas_banded" and dev.type == "cpu":
            continue
        if name in ("tiled", "reorder_tiled"):
            kwargs = {"device_scatter": True}
        elif name in ("banded", "pallas_banded", "reorder_banded"):
            kwargs = {"mem_budget_bytes": dense_block_budget_bytes}
        else:
            kwargs = {}
        try:
            if name in ("reorder_banded", "reorder_tiled"):
                from ssrg_torch.ops.reorder import (
                    apply_permutation, reorder_permutation, reorder_plan,
                )

                method, base, _, _ = reorder_plan(name, dev)
                adj_p, _, _, _ = apply_permutation(adj, reorder_permutation(adj, method))
                adj_dev = device_adjacency(adj_p, base, device=dev, **kwargs)
            else:
                adj_dev = device_adjacency(adj, name, device=dev, **kwargs)
            timings[name] = _time_engine(adj_dev, x, reps)
        except ValueError as exc:  # the engine does not suit this graph
            if verbose:
                log.info("autotune: %s refused: %s", name, exc)
    if not timings:
        raise RuntimeError("no SpMM engine could be timed")
    best = min(timings, key=timings.get)
    if verbose:
        for k, v in sorted(timings.items(), key=lambda kv: kv[1]):
            log.info("autotune: %s: %.2f ms/hop", k, v * 1e3)
    return best, timings
