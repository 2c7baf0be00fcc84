#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ssrg_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. build   — ``nvcc`` builds every kernel of the port from ``ssrg_torch/csrc``.
2. kernels — each kernel against its plain PyTorch version on the card: the
             headline hybrid pack (the serving path's own shapes), the
             power-law pack and ragged packs; times from CUDA events for the
             kernel, the plain version and one PyTorch library call.
3. slice   — the serving path at full width: GAMLP (hidden 256, 3 layers,
             K = 3, 40 classes) on a 169,343-node, F = 128 random graph,
             through ``Predictor`` with ``engine="auto"`` (hybrid), random
             weights from a seeded ``torch.Generator``; the kernel's launch
             count, hop K against float64 scipy, and three requests.

Then a ``{"kernels": [...]}`` line, the card's name and power limit, and as
the last line ``{"ok": true, "device": {...}}``. Any failed check raises and
the script exits non-zero without that line; without a CUDA card it exits 2,
and without the ``ssrg_torch`` package beside it, before printing anything.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
F32_FLOPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
UNIT_ROUNDOFF = 2.0 ** -24    # float32
NUM_NODES, AVG_DEGREE, NUM_FEATURES, NUM_CLASSES = 169_343, 13.7, 128, 40
SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


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


def phase_build() -> None:
    from ssrg_torch.ops import ell_spmm as kernel_module

    t0 = time.perf_counter()
    log = kernel_module.build(force=True, extra_flags=["-Xptxas=-v"])
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "source": "ssrg_torch/csrc/ell_spmm.cu",
          "seconds": seconds, "ptxas": ptxas})


def ell_case(name: str, cols, vals, x, timed: bool, tail=None) -> dict:
    """Hold ``ell_spmm`` against ``ell_spmm_plain`` on card tensors.

    Tolerance: the kernel (fma in slot order) and the plain version (one
    batched product) sum the same ``W`` products in a different order, so
    each is within ``W * u * sum|v * x|`` of the exact sum (u = 2^-24) and
    they differ by at most twice that, elementwise."""
    import torch

    from ssrg_torch.ops.ell_spmm import ell_spmm, ell_spmm_plain

    out_k = ell_spmm(cols, vals, x)
    out_p = ell_spmm_plain(cols, vals, x)
    torch.cuda.synchronize()
    width = cols.shape[1]
    magnitude = ell_spmm_plain(cols, vals.abs(), x.abs())
    tol = 2.0 * width * UNIT_ROUNDOFF * magnitude + 1e-30
    diff = (out_k - out_p).abs()
    max_abs_err = float(diff.max()) if diff.numel() else 0.0
    check(bool(torch.isfinite(out_k).all()), f"{name}: kernel output not finite")
    check(bool((diff <= tol).all()), f"{name}: kernel vs plain beyond the sum-order bound "
          f"(max abs err {max_abs_err})")
    rec = {"phase": "kernels", "case": name, "kernel": "ell_spmm",
           "rows": int(cols.shape[0]), "width": int(width), "n": int(x.shape[0]),
           "f": int(x.shape[1]), "vec4": bool(x.shape[1] % 4 == 0 and x.data_ptr() % 16 == 0),
           "max_abs_err": max_abs_err, "tolerance": "2*W*2^-24*sum|v*x| elementwise"}
    if not timed:
        return rec
    # the bound counts the pack, x and out each moved once, and one multiply-add
    # per F for each real (nonzero) slot: the padding slots are not work
    real = vals != 0
    counts = real.sum(dim=1)
    nbytes = (cols.numel() * 4 + vals.numel() * 4 + x.numel() * 4
              + out_k.numel() * 4)
    flops = 2.0 * int(counts.sum()) * x.shape[1]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    crow = torch.zeros(cols.shape[0] + 1, dtype=torch.int64, device=x.device)
    crow[1:] = torch.cumsum(counts, 0)
    csr = torch.sparse_csr_tensor(crow, cols[real].to(torch.int64), vals[real],
                                  size=(cols.shape[0], x.shape[0]))
    lib_err = float((torch.sparse.mm(csr, x) - out_p).abs().max())
    rec.update({
        "ms": cuda_ms(lambda: ell_spmm(cols, vals, x)),
        "plain_ms": cuda_ms(lambda: ell_spmm_plain(cols, vals, x)),
        "library_ms": cuda_ms(lambda: torch.sparse.mm(csr, x)),
        "library": "torch.sparse.mm on the CSR of the pack's nonzero slots",
        "library_max_abs_err": lib_err,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "compulsory_bytes": nbytes, "flops": flops,
        "real_slots": int(counts.sum()), "slots": int(cols.numel()),
    })
    if tail is not None:
        acc = torch.zeros((tail.n_rows, x.shape[1]), dtype=torch.float32, device=x.device)
        rec["tail_nnz"] = int((tail.val != 0).sum())
        rec["tail_index_add_ms"] = cuda_ms(lambda: tail.accumulate(acc, x))
    return rec


def phase_kernels(headline, powerlaw) -> dict:
    """Every ported kernel against its plain version; returns the headline
    record of each kernel."""
    import torch

    dev = torch.device("cuda")
    recs = {}
    for name, (hyb, x) in (("headline", headline), ("powerlaw", powerlaw)):
        rec = ell_case(name, hyb.ell.cols, hyb.ell.vals, x, timed=True, tail=hyb.tail)
        emit(rec)
        recs[name] = rec
    gen = torch.Generator().manual_seed(SEED)
    ragged = [  # (name, rows, n, width, f, misalign)
        ("f50_scalar", 1003, 777, 7, 50, False),
        ("width1", 1003, 512, 1, 128, False),
        ("width40_f300", 2001, 1500, 40, 300, False),
        ("f48_misaligned", 999, 600, 9, 48, True),
    ]
    for name, rows, n, width, f, misalign in ragged:
        cols = torch.randint(0, n, (rows, width), generator=gen, dtype=torch.int32)
        vals = torch.randn(rows, width, generator=gen)
        empty = torch.rand(rows, generator=gen) < 0.1   # rows with no neighbour
        cols[empty], vals[empty] = 0, 0.0
        x_host = torch.randn(n, f, generator=gen)
        if misalign:  # contiguous, but 4 bytes off 16-byte alignment
            x = torch.empty(n * f + 1, device=dev)[1:].view(n, f).copy_(x_host)
            check(x.data_ptr() % 16 != 0, "misaligned case is aligned")
        else:
            x = x_host.to(dev)
        emit(ell_case(name, cols.to(dev), vals.to(dev), x, timed=False))
    return recs


def phase_slice(ds, adj_norm) -> dict:
    import torch

    from ssrg_torch.configs.config import ModelConfig, TrainingConfig
    from ssrg_torch.models.zoo import load_model
    from ssrg_torch.ops.ell_spmm import ell_spmm
    from ssrg_torch.serve import Predictor

    cfg = ModelConfig(model_name="gamlp")
    spec = load_model(cfg, ds.num_features, NUM_CLASSES)
    spec.module.reset_parameters(torch.Generator().manual_seed(SEED))
    params = {k: v.clone() for k, v in spec.module.state_dict().items()}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ell_spmm.launches = 0
    t0 = time.perf_counter()
    pred = Predictor(ds, spec, cfg, TrainingConfig(spmm_engine="auto"),
                     params=params, device="cuda")
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    launches_prepare = ell_spmm.launches

    rng = np.random.default_rng(SEED)
    requests = []
    for n in (1, 1000, 4096):
        ids = rng.integers(0, NUM_NODES, size=n)
        t1 = time.perf_counter()
        logits = pred.logits(ids)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        again = pred.logits(ids)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        labels = pred.predict(ids)
        check(tuple(logits.shape) == (n, NUM_CLASSES), f"logits shape {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), "logits not finite")
        check(torch.equal(labels, logits.argmax(dim=-1)), "predict != argmax(logits)")
        check(torch.equal(logits, again), "a repeated request changed its logits")
        requests.append({"n": n, "first_ms": (t2 - t1) * 1e3, "repeat_ms": (t3 - t2) * 1e3,
                         "ids": ids, "logits": logits})
    launches = ell_spmm.launches
    peak = torch.cuda.max_memory_allocated()

    k = cfg.prop_steps
    check(launches_prepare == k, f"ell_spmm launched {launches_prepare} times in prepare, "
          f"expected K={k}")
    check(launches == k, f"requests launched ell_spmm ({launches - k} times)")

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
          "requests": [{k: r[k] for k in ("n", "first_ms", "repeat_ms")}
                       for r in requests],
          "peak_mem_bytes": peak})
    return {"ell_spmm": launches}


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


def main() -> int:
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

    from ssrg_torch.data.synthetic import powerlaw_graph, random_graph
    from ssrg_torch.ops.normalize import sym_norm
    from ssrg_torch.ops.sparse import build_hybrid

    emit({"phase": "env", "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0)})
    phase_build()

    t0 = time.perf_counter()
    ds = random_graph(NUM_NODES, AVG_DEGREE, NUM_FEATURES, num_classes=NUM_CLASSES,
                      seed=SEED)
    adj_norm = sym_norm(ds.adj, 0.5)
    pg = powerlaw_graph(NUM_NODES, AVG_DEGREE, NUM_FEATURES, seed=SEED)
    packs = {}
    for name, adj, feats in (("headline", adj_norm, ds.x),
                             ("powerlaw", sym_norm(pg.adj, 0.5), pg.x)):
        packs[name] = (build_hybrid(adj).to("cuda"),
                       torch.as_tensor(feats, device="cuda"))
    emit({"phase": "data", "host_s": time.perf_counter() - t0, "nnz": int(adj_norm.nnz),
          "width": packs["headline"][0].ell.width,
          "powerlaw_width": packs["powerlaw"][0].ell.width})

    recs = phase_kernels(packs["headline"], packs["powerlaw"])
    del packs
    launches = phase_slice(ds, adj_norm)
    phase_layers(ds, prop_steps=3)

    head = recs["headline"]
    emit({"kernels": [{
        "name": "ell_spmm", "route": "cuda", "source": "ssrg_torch/csrc/ell_spmm.cu",
        "replaces": "ssrg_tpu/ops/pallas_spmm.py:47",
        "launches": launches["ell_spmm"], "max_abs_err": head["max_abs_err"],
        "ms": head["ms"], "kernel_ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
    }]})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True)
    print(" | ".join(ln.strip() for ln in smi.stdout.splitlines() if ln.strip()), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
