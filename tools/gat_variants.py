#!/usr/bin/env python3
"""Time variants of the GAT attention kernels, and the design that would
reuse the hybrid SpMM's kernels, on one NVIDIA GPU.

    python3 tools/gat_variants.py [--seed N] [--variants NAME,NAME,...]

Builds ``ssrg_torch/csrc/gat_attention.cu`` as it stands and once for each
entry of ``VARIANTS`` with one of its ``constexpr`` constants changed: the
entries of a group's segment (``kSeg``), the rows a lane requests before it
adds any (``kBatch``) and the warps of a block (``kWarps``). All ``nvcc``
processes start together; the libraries go to
``ssrg_torch/build/gat_variants/``.

Then it draws the ``gat-products-fullbatch`` cell's graph from ``--seed``
(``portbench/configs/gat-products.json``: ogbn-products' 2,449,029 nodes and
61,859,140 edges on the benchmark's power-law rule), lists ``A`` with one
self-loop a node sorted by row (the attention listing; symmetric, so it is
its own transposed listing), and at the cell's head widths, 4 heads of 128
(float4 lanes) and 4 of 47 (scalar lanes), times every variant's four steps
(``softmax_stats``, ``aggregate``, ``rowdot``, ``backward``) through the
wrappers in turns (each round in order, the next in reverse), each held to
the source's outputs, and each step's plain version once. Beside them, the
design that reuses the hybrid
SpMM's kernels: alpha formed as ``[E, H]`` from the same statistics (torch),
an ELL pack of the first W entries of each row (W the p95 degree rounded up
to 8, as ``build_hybrid``) and a COO tail of the rest, alpha as their values,
and per head the ELL kernel and the COO tail kernel on a contiguous copy of
the head's z; its kernels' time, the time of forming alpha and of the
copies, each apart. Prints a JSON line per build and per width, then the
card's name and power limit. Without a CUDA card it exits 2.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402

VARIANTS = (  # (name, the constants changed from the source's)
    ("source", {}),
    ("kBatch=2", {"kBatch": 2}),
    ("kBatch=8", {"kBatch": 8}),
    ("kSeg=128", {"kSeg": 128}),
    ("kSeg=512", {"kSeg": 512}),
    ("kWarps=8", {"kWarps": 8}),
)
ROUNDS = 2
SHAPES = ((4, 128), (4, 47))  # (heads, head width): the hidden layers', the last layer's
CONFIG = os.path.join(ROOT, "portbench", "configs", "gat-products.json")
SLOPE = 0.2


def variant_source(text: str, changes: dict) -> str:
    for const, value in changes.items():
        text, n = re.subn(rf"constexpr int {const} = \d+;", f"constexpr int {const} = {value};",
                          text)
        smoke.check(n == 1, f"gat_attention.cu has no single 'constexpr int {const} = ...;'")
    return text


def build_variants(names) -> dict:
    """Every variant's library of ``names``, loaded and declared, by name."""
    from ssrg_torch.ops import _nvcc
    from ssrg_torch.ops import gat_attention as ga

    out_dir = os.path.join(_nvcc.BUILD_DIR, "gat_variants")
    os.makedirs(out_dir, exist_ok=True)
    with open(_nvcc.source(ga.NAME)) as f:
        text = f.read()
    procs = {}
    for name, changes in VARIANTS:
        if name not in names:
            continue
        stem = os.path.join(out_dir, re.sub(r"\W", "_", name))
        with open(f"{stem}.cu", "w") as f:
            f.write(variant_source(text, changes))
        cmd = [_nvcc.nvcc(), *_nvcc.NVCC_FLAGS, "-Xptxas=-v", "-o", f"{stem}.so", f"{stem}.cu"]
        procs[name] = (f"{stem}.so", subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        out, err = proc.communicate()
        smoke.check(proc.returncode == 0, f"nvcc failed for {name}:\n{err}")
        smoke.emit({"phase": "build", "variant": name,
                    "ptxas": [ln.strip() for ln in (out + err).splitlines()
                              if "registers" in ln and ("aggregate" in ln or "backward" in ln
                                                        or "Used" in ln)][:40]})
        libs[name] = ctypes.CDLL(path)
        ga._declare(libs[name])
    return libs


def use(lib) -> None:
    """Make the wrappers launch ``lib``'s kernels."""
    from ssrg_torch.ops import _nvcc
    from ssrg_torch.ops import gat_attention as ga

    _nvcc._libs[ga.NAME] = lib


def cell_listing(seed: int):
    """The cell's attention listing on the card: ``(row, col)`` int32 of
    ``A + I`` sorted by row, and the node count."""
    import torch

    from portbench.graphs import make_graph

    with open(CONFIG) as f:
        cfg = json.load(f)
    data = make_graph(cfg["dataset"], cfg["graph"], seed, "cuda")
    n = data.num_nodes
    loops = torch.arange(n, device="cuda")
    key = torch.sort(torch.cat([data.lo * n + data.hi, data.hi * n + data.lo,
                                loops * n + loops])).values
    del data, loops
    row, col = (key // n).int(), (key % n).int()
    del key
    torch.cuda.empty_cache()
    return row, col, n


def steps(row, col, s_src, s_dst, z, g):
    """The four steps of a forward and a backward pass, as callables, with
    the forward's outputs the backward takes."""
    from ssrg_torch.ops import gat_attention as ga

    nnz = int(row.numel())
    m, l = ga.softmax_stats(row, col, s_src, s_dst, nnz, SLOPE)
    out = ga.aggregate(row, col, s_src, s_dst, m, l, z, nnz, SLOPE)
    q = ga.rowdot(g, out, s_dst, m, l)
    return {
        "stats": lambda: ga.softmax_stats(row, col, s_src, s_dst, nnz, SLOPE),
        "aggregate": lambda: ga.aggregate(row, col, s_src, s_dst, m, l, z, nnz, SLOPE),
        "rowdot": lambda: ga.rowdot(g, out, s_dst, m, l),
        "backward": lambda: ga.backward(row, col, q, s_src, z, g, nnz, SLOPE),
    }, (m, l, out, q)


def plain_ms(row, col, s_src, s_dst, z, g, m, l, out, q) -> dict:
    """Each step's plain version (``ops/gat_attention.py``, chunked torch) on
    the card, one timed call after one warm-up."""
    from ssrg_torch.ops import gat_attention as ga

    nnz = int(row.numel())
    steps = {
        "stats": lambda: ga.softmax_stats_plain(row, col, s_src, s_dst, nnz, SLOPE),
        "aggregate": lambda: ga.aggregate_plain(row, col, s_src, s_dst, m, l, z, nnz, SLOPE),
        "rowdot": lambda: ga.rowdot_plain(g, out, s_dst, m, l),
        "backward": lambda: ga.backward_plain(row, col, q, s_src, z, g, nnz, SLOPE),
    }
    return {name: smoke.cuda_ms(fn, iters=1, warmup=1) for name, fn in steps.items()}


def reuse_design(row, col, n: int, s_src, s_dst, m, l, z, want):
    """The aggregation on the ELL kernel and the COO tail kernel, alpha as
    their values, one head at a time: its times and its largest gap to the
    fused kernel's output ``want`` over ``want``'s largest value."""
    import torch

    from ssrg_torch.ops.coo_spmm import coo_accumulate
    from ssrg_torch.ops.ell_spmm import ell_spmm

    h, c = z.shape[1], z.shape[2]
    r, cl = row.long(), col.long()
    deg = torch.bincount(r, minlength=n)
    width = int(torch.quantile(deg.double(), 0.95, interpolation="lower"))
    width = -(-max(width, 1) // 8) * 8
    start = torch.zeros(n + 1, dtype=torch.int64, device="cuda")
    start[1:] = torch.cumsum(deg, 0)
    pos = torch.arange(r.numel(), device="cuda") - start[r]
    in_ell = pos < width
    n_pad = -(-n // 256) * 256
    slot = r[in_ell] * width + pos[in_ell]
    cols = torch.zeros(n_pad * width, dtype=torch.int32, device="cuda")
    cols[slot] = col[in_ell]
    cols = cols.view(n_pad, width)
    t_row, t_col = row[~in_ell].contiguous(), col[~in_ell].contiguous()

    def alpha():
        a = torch.nn.functional.leaky_relu(s_dst[r] + s_src[cl], SLOPE)
        return torch.exp(a - m[r]) / l[r]

    alpha_ms = smoke.cuda_ms(alpha, iters=3, warmup=1)
    al = alpha()
    vals = []
    for k in range(h):
        v = torch.zeros(n_pad * width, dtype=torch.float32, device="cuda")
        v[slot] = al[in_ell, k]
        vals.append((v.view(n_pad, width), al[~in_ell, k].contiguous()))
    del al
    z_heads = [z[:, k].contiguous() for k in range(h)]

    def spmm():
        outs = []
        for k in range(h):
            o = ell_spmm(cols, vals[k][0], z_heads[k])[:n]
            coo_accumulate(t_row, t_col, vals[k][1], z_heads[k], o)
            outs.append(o)
        return outs

    outs = spmm()
    gap = max(float((outs[k] - want[:, k]).abs().max()) for k in range(h))
    gap /= float(want.abs().max())
    del outs
    spmm_ms = smoke.cuda_ms(spmm, iters=3, warmup=1)
    copies_ms = smoke.cuda_ms(lambda: [z[:, k].contiguous() for k in range(h)], iters=3,
                              warmup=1)
    return {"ell_width": width, "tail_entries": int(t_row.numel()), "alpha_ms": alpha_ms,
            "spmm_ms": spmm_ms, "head_copies_ms": copies_ms, "gap_to_fused": gap}


def measure(row, col, n: int, h: int, c: int, libs: dict, seed: int) -> dict:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    z = torch.randn((n, h, c), generator=gen, device="cuda")
    s_src = torch.randn((n, h), generator=gen, device="cuda")
    s_dst = torch.randn((n, h), generator=gen, device="cuda")
    g = torch.randn((n, h, c), generator=gen, device="cuda")
    use(libs["source"])
    fns, (m, l, out, q) = steps(row, col, s_src, s_dst, z, g)
    want_bwd = fns["backward"]()
    gaps = {}
    for variant, lib in libs.items():
        use(lib)
        got_out = fns["aggregate"]()
        got_bwd = fns["backward"]()
        torch.cuda.synchronize()
        gaps[variant] = max(
            float((got_out - out).abs().max()) / float(out.abs().max()),
            *(float((a - b).abs().max()) / float(b.abs().max())
              for a, b in zip(got_bwd, want_bwd)))
        smoke.check(gaps[variant] <= 1e-4, f"{variant}: off the source by {gaps[variant]}")
        del got_out, got_bwd
    del want_bwd
    torch.cuda.empty_cache()
    ms = {v: {step: [] for step in fns} for v in libs}
    order = list(libs)
    for rnd in range(ROUNDS):
        for variant in (order if rnd % 2 == 0 else order[::-1]):
            use(libs[variant])
            for step, fn in fns.items():
                ms[variant][step].append(smoke.cuda_ms(fn, iters=5, warmup=1))
    use(libs["source"])
    plain = plain_ms(row, col, s_src, s_dst, z, g, m, l, out, q)
    reuse = reuse_design(row, col, n, s_src, s_dst, m, l, z, out)
    mean = {v: {s: sum(t) / len(t) for s, t in by.items()} for v, by in ms.items()}
    e = int(row.numel())
    return {"phase": "variants", "heads": h, "head_width": c, "n": n, "entries": e,
            "gap_to_source": gaps, "ms": ms, "ms_mean": mean, "plain_ms": plain,
            "reuse_hybrid_kernels": reuse,
            "gather_bytes": e * h * c * 4,
            "aggregate_gather_gb_per_s": e * h * c * 4 / mean["source"]["aggregate"] / 1e6,
            "backward_gather_gb_per_s": e * h * c * 4 / mean["source"]["backward"] / 1e6}


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--variants", default=",".join(name for name, _ in VARIANTS))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("gat_variants: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    names = args.variants.split(",")
    smoke.check("source" in names, "the variants are held to 'source': name it")
    libs = build_variants(names)
    row, col, n = cell_listing(args.seed)
    smoke.emit({"phase": "listing", "seed": args.seed, "n": n, "entries": int(row.numel())})
    for h, c in SHAPES:
        smoke.emit(measure(row, col, n, h, c, libs, args.seed))
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(" | ".join(ln.strip() for ln in smi.stdout.splitlines() if ln.strip()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
