"""What ``chip_smoke.py`` and ``tools/kernels.py`` share on one NVIDIA GPU:
JSON lines and checks, CUDA-event times, the least time the card could take
for some work, the kernels' sum-order tolerances, the full-size graphs both
build (the ``cuda`` tests build theirs here too, with tolerances of their
own), and a kernel source rebuilt with other ``constexpr`` constants,
launched through its wrapper in place of the source's own library.

Nothing here runs at import: the CPU tests import it, and the scripts that
import it.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import statistics
import subprocess

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
F32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
UNIT_ROUNDOFF = 2.0 ** -24    # float32
# |kernel - plain| <= factor * c * u * sum|a * x| for a row of c nonzero
# entries, by path (banded_tolerance has the derivations)
BANDED_TOLERANCE = {"stream": 2.0, "tensor_core": 7.0}

# the 169,343-node graphs (ogbn-arxiv's node count, width and classes)
NUM_NODES, AVG_DEGREE, NUM_FEATURES, NUM_CLASSES = 169_343, 13.7, 128, 40
BANDED_NEIGHBOURS, BANDED_REACH = 7, 1000
L2_ROWS = 16_384  # rows of x once the headline pack's columns are folded onto them: x stays in L2
SEED = 0
# planetoid_like at ogbn-arxiv's node count, width, classes and split sizes
TRAIN_GRAPH = dict(num_node=NUM_NODES, num_classes=NUM_CLASSES, num_features=NUM_FEATURES,
                   train_per_class=2_273, num_val=29_799, num_test=48_603, p_in=1e-3,
                   p_out=1e-5, seed=SEED)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return " | ".join(ln.strip() for ln in smi.stdout.splitlines() if ln.strip())


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` calls, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def hold(name: str, out_k, out_p, tol) -> float:
    """Check a kernel's output: finite, and within ``tol`` of its plain
    version elementwise. Returns the largest absolute difference."""
    import torch

    diff = (out_k - out_p).abs_()  # in place: an operand may be several GB
    max_abs_err = float(diff.max()) if diff.numel() else 0.0
    check(bool(torch.isfinite(out_k).all()), f"{name}: kernel output not finite")
    check(bool((diff <= tol).all()), f"{name}: kernel vs plain beyond the sum-order bound "
          f"(max abs err {max_abs_err})")
    return max_abs_err


def bound(nbytes: int, flops: float, flops_per_s: float) -> dict:
    """The least time the card could take for the work: the compulsory
    bytes over device memory's rate or the operations over the peak rate of
    their type, whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "operations_ms": t_ops,
            "compulsory_bytes": nbytes, "flops": flops}


def against_bound(name: str, rec: dict) -> dict:
    """A timed record's share of its bound and the rate of device memory it
    reaches (compulsory bytes over its time); a time below the bound means
    the bound counts more bytes or operations than the kernel needs, and
    fails the run."""
    check(rec["ms"] >= rec["bound_ms"],
          f"{name}: {rec['ms']} ms is below its bound of {rec['bound_ms']} ms")
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    rec["achieved_gb_per_s"] = rec["compulsory_bytes"] / rec["ms"] / 1e6
    return rec


# --- the kernels' sum-order tolerances (elementwise, u = 2^-24) ---------------


def ell_tolerance(cols, vals, x):
    """The ELL kernel (only the nonzero slots, fma in slot order) and its
    plain version (every slot, one batched product) sum the same nonzero
    products in another order, each within ``W u sum|v x|`` of the exact
    sum, so they differ by at most twice that."""
    from ssrg_torch.ops.ell_spmm import ell_spmm_plain

    return 2.0 * cols.shape[1] * UNIT_ROUNDOFF * ell_spmm_plain(cols, vals.abs(), x.abs()) + 1e-30


def coo_tolerance(row, col, val, x, out, nnz):
    """The COO kernel sums a row's terms in entry order within a segment and
    the segments' partial sums by atomics, the plain version in its own
    order: each within ``(c + 1) u (|out| + sum|v x|)`` of the exact sum, c
    the row's entries, so they differ by at most twice that."""
    import torch

    from ssrg_torch.ops.coo_spmm import coo_accumulate_plain

    n = row.shape[0] if nnz is None else nnz
    counts = torch.bincount(row[:n].long(), minlength=out.shape[0])[:, None]
    mag = coo_accumulate_plain(row, col, val.abs(), x.abs(), out.abs(), nnz)
    return 2.0 * (counts + 1) * UNIT_ROUNDOFF * mag + 1e-30


def banded_tolerance(blocks, los, x, round_x):
    """For a row of c nonzero entries, S = sum|a x| (both versions take the
    same products, and a bf16 x bf16 product is exact in f32). Stream path:
    it sums the nonzero products in another order than the plain version,
    each within ``c u S`` of the exact sum, so ``2 c u S`` apart. Tensor-core
    path (the source note of ``csrc/banded_spmm.cu``): on Fasi et al.'s
    model of an MMA's sum (PeerJ CS 2021, measured on Volta to Ampere,
    assumed for Hopper's wgmma) an MMA aligns its terms to the largest and
    truncates, so a group of g nonzero products loses less than ``(g + 2) 2u
    S``, a zero group nothing, the row less than ``3c 2u S``; with the plain
    version's ``c u S``: ``7 c u S``."""
    from ssrg_torch.ops.banded_spmm import banded_spmm_plain, path

    counts = (blocks != 0).sum(dim=2).reshape(-1, 1)
    factor = BANDED_TOLERANCE[path(blocks)]
    return (factor * counts * UNIT_ROUNDOFF * banded_spmm_plain(blocks.abs(), los, x.abs(), round_x)
            + 1e-30)


def rest_tolerance(rp, re_, cols, vals, x, gather_bf16):
    """Both take the same terms of a row (with ``gather_bf16`` both round
    the same operands and products) and sum them in another order, the
    plain version's ``index_add_`` in no fixed one: for a row of c real
    entries each within ``c u sum|term|`` of the exact sum, so twice that
    apart."""
    from ssrg_torch.ops.rest_spmm import rest_spmm_plain

    counts = (re_ - rp[:-1])[:, None]
    return (2.0 * counts * UNIT_ROUNDOFF
            * rest_spmm_plain(rp, re_, cols, vals.abs(), x.abs(), gather_bf16) + 1e-30)


# --- the graphs ----------------------------------------------------------------


def banded_dataset():
    """Every node gets ``BANDED_NEIGHBOURS`` neighbours at offsets uniform in
    [-BANDED_REACH, BANDED_REACH] (clipped to the id range), unit weights,
    symmetrized without self-loops; the ids are shuffled, so RCM has to find
    the band again. F = 128 normal features, 40 labels."""
    from ssrg_torch.data.graph import Graph

    rng = np.random.default_rng(SEED)
    n = NUM_NODES
    r = np.repeat(np.arange(n), BANDED_NEIGHBOURS)
    c = np.clip(r + rng.integers(-BANDED_REACH, BANDED_REACH + 1, r.shape), 0, n - 1)
    shuf = rng.permutation(n)
    x = rng.normal(size=(n, NUM_FEATURES)).astype(np.float32)
    y = rng.integers(0, NUM_CLASSES, n)
    return Graph(shuf[r], shuf[c], np.ones(r.size, np.float32), n, "UUU", x=x, y=y)


def community_dataset():
    """``community_graph(169_343)`` (512-node communities, ids shuffled)
    with F = 128 normal features and 40 labels from numpy seed 0."""
    from ssrg_torch.data.graph import Graph
    from ssrg_torch.data.synthetic import community_graph

    rng = np.random.default_rng(SEED)
    x = rng.normal(size=(NUM_NODES, NUM_FEATURES)).astype(np.float32)
    y = rng.integers(0, NUM_CLASSES, NUM_NODES)
    g = Graph(np.zeros(0), np.zeros(0), np.zeros(0), NUM_NODES, "UUU", x=x, y=y)
    g.adj = community_graph(NUM_NODES, seed=SEED)
    return g


def locality_pack(ds, engine: str, bf16: bool, device="cuda"):
    """``prepare``'s reorder path for ``engine`` (``reorder_banded``: the
    banded pack; ``reorder_tiled``: the tiled pack and its rest): the pack on
    ``device`` and the renumbered features there."""
    import torch

    from ssrg_torch.ops.normalize import sym_norm
    from ssrg_torch.ops.pallas_banded import build_pallas_banded
    from ssrg_torch.ops.reorder import apply_permutation, reorder_permutation, reorder_plan
    from ssrg_torch.ops.sparse import build_tiled

    dev = torch.device(device)
    method, dense_engine, merge_target, kwargs = reorder_plan(engine, dev, bf16)
    adj = sym_norm(ds.adj, 0.5)
    adj_p, x_p, _, _ = apply_permutation(
        adj, reorder_permutation(adj, method, merge_target=merge_target), ds.x)
    if dense_engine == "pallas_banded":
        pack = build_pallas_banded(adj_p, **kwargs).to(dev)
    else:
        pack = build_tiled(adj_p, device=dev, **kwargs).to(dev)
    return pack, torch.as_tensor(x_p, device=dev)


# --- a kernel rebuilt with other constants -------------------------------------


def variant_source(text: str, changes: dict, name: str) -> str:
    """``text`` with each ``constexpr int <const> = N;`` of ``changes`` set
    to its value; each must occur exactly once."""
    for const, value in changes.items():
        text, n = re.subn(rf"constexpr int {const} = \d+;", f"constexpr int {const} = {value};",
                          text)
        check(n == 1, f"{name}.cu has no single 'constexpr int {const} = ...;'")
    return text


def build_variants(module, variants) -> dict:
    """Each ``(name, changes)`` of ``variants`` built from the source of
    ``module`` (an ``ssrg_torch.ops`` wrapper with ``NAME`` and
    ``_declare``) into ``ssrg_torch/build/variants/<NAME>/``, all ``nvcc``
    processes started together: the loaded and declared libraries by name.
    Emits each build's ``ptxas`` lines (registers, spills)."""
    from ssrg_torch.ops import _nvcc

    out_dir = os.path.join(_nvcc.BUILD_DIR, "variants", module.NAME)
    os.makedirs(out_dir, exist_ok=True)
    with open(_nvcc.source(module.NAME)) as f:
        text = f.read()
    procs = {}
    for name, changes in variants:
        stem = os.path.join(out_dir, re.sub(r"\W", "_", name))
        with open(f"{stem}.cu", "w") as f:
            f.write(variant_source(text, changes, module.NAME))
        cmd = [_nvcc.nvcc(), *_nvcc.NVCC_FLAGS, "-Xptxas=-v", "-o", f"{stem}.so", f"{stem}.cu"]
        procs[name] = (f"{stem}.so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        out, err = proc.communicate()
        check(proc.returncode == 0, f"nvcc failed for {module.NAME} {name}:\n{err}")
        emit({"phase": "build", "kernel": module.NAME, "variant": name,
              "ptxas": [ln.strip() for ln in (out + err).splitlines()
                        if "registers" in ln or "spill" in ln]})
        libs[name] = ctypes.CDLL(path)
        module._declare(libs[name])
    return libs


def use(module, lib) -> None:
    """Make ``module``'s wrappers launch ``lib``'s kernels: they take the
    library ``_nvcc`` has loaded under the module's name."""
    from ssrg_torch.ops import _nvcc

    _nvcc._libs[module.NAME] = lib


def in_turns(module, libs: dict, fns: dict, rounds: int) -> dict:
    """Each callable of ``fns`` timed (:func:`cuda_ms`) with each library of
    ``libs`` in use, ``rounds`` times, the libraries in order in one round
    and in reverse in the next: the median milliseconds by library and
    callable. A round before them warms the card and is not kept: without
    it the first variant of a short kernel read up to 13.5 % slow."""
    ms = {v: {k: [] for k in fns} for v in libs}
    order = list(libs)
    for r in range(-1, rounds):
        for v in (order if r % 2 == 0 else order[::-1]):
            use(module, libs[v])
            for k, fn in fns.items():
                t = cuda_ms(fn)
                if r >= 0:
                    ms[v][k].append(t)
    return {v: {k: statistics.median(t) for k, t in by.items()} for v, by in ms.items()}
