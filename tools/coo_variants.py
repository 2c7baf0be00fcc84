#!/usr/bin/env python3
"""Time variants of the COO kernel's constants on one NVIDIA GPU.

    python3 tools/coo_variants.py [--seed N] [--variants NAME,NAME,...]

Builds ``ssrg_torch/csrc/coo_spmm.cu`` as it stands and once for each entry
of ``VARIANTS`` with one of its ``constexpr`` constants changed: the entries
of a warp's segment (``kSeg``), the entries whose x rows a lane requests
before it adds any (``kBatch``), the float4 a lane holds of a feature tile
(``kQuads``, so the tile is 128 or 256 floats) and the warps of a block
(``kWarps``). All ``nvcc`` processes start together; the libraries go to
``ssrg_torch/build/coo_variants/``.

Then it draws the ``gcn-products-fullbatch`` cell's graph from ``--seed``
(``portbench/configs/gcn-products.json``: ogbn-products' 2,449,029 nodes and
61,859,140 edges on the benchmark's power-law rule), builds the hybrid pack
of ``D^-1/2 (A + I) D^-1/2`` as ``BaselineTask`` does (``build_hybrid``: the
p95 width and the COO tail of the hub rows), and at the epoch's two widths,
F = 256 (float4 lanes) and F = 47 (scalar lanes), holds every variant
against ``coo_accumulate_plain`` within the sum-order bound and times them
through the ``coo_accumulate`` wrapper in turns: each round runs the
variants in order, the next in reverse. Beside them it times the plain
version and ``torch.sparse.mm`` on the CSR of the same entries, and gives the
tail's bound: the entries, every x row and out row they touch, each moved
once over 3.35 TB/s. Prints a JSON line per build and per width, then the
card's name and power limit.

``coo_accumulate`` itself always runs the source's own constants; this
script only measures that choice. Without a CUDA card it exits 2.
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
    ("kSeg=128", {"kSeg": 128}),
    ("kSeg=512", {"kSeg": 512}),
    ("kBatch=2", {"kBatch": 2}),
    ("kBatch=8", {"kBatch": 8}),
    ("kQuads=2", {"kQuads": 2}),
    ("kWarps=8", {"kWarps": 8}),
)
ROUNDS = 4
WIDTHS = (256, 47)  # the GCN epoch's SpMM widths: hidden (float4 lanes), classes (scalar)
CONFIG = os.path.join(ROOT, "portbench", "configs", "gcn-products.json")


def variant_source(text: str, changes: dict) -> str:
    for const, value in changes.items():
        text, n = re.subn(rf"constexpr int {const} = \d+;", f"constexpr int {const} = {value};",
                          text)
        smoke.check(n == 1, f"coo_spmm.cu has no single 'constexpr int {const} = ...;'")
    return text


def build_variants(names) -> dict:
    """Every variant's library of ``names``, loaded and declared, by name."""
    from ssrg_torch.ops import _nvcc
    from ssrg_torch.ops import coo_spmm as coo

    out_dir = os.path.join(_nvcc.BUILD_DIR, "coo_variants")
    os.makedirs(out_dir, exist_ok=True)
    with open(_nvcc.source(coo.NAME)) as f:
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
                              if "registers" in ln or "spill" in ln]})
        libs[name] = ctypes.CDLL(path)
        coo._declare(libs[name])
    return libs


def use(lib) -> None:
    """Make ``coo_accumulate`` launch ``lib``'s kernel: the wrapper takes the
    library ``_nvcc`` has loaded under its name."""
    from ssrg_torch.ops import _nvcc
    from ssrg_torch.ops import coo_spmm as coo

    _nvcc._libs[coo.NAME] = lib


def cell_tail(seed: int):
    """The GCN cell's hybrid pack of ``D^-1/2 (A + I) D^-1/2`` on the card:
    the CSR built on the card, packed on the host by ``build_hybrid``."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    from portbench.graphs import make_graph
    from ssrg_torch.ops.sparse import build_hybrid

    with open(CONFIG) as f:
        cfg = json.load(f)
    data = make_graph(cfg["dataset"], cfg["graph"], seed, "cuda")
    n = data.num_nodes
    loops = torch.arange(n, device="cuda")
    key = torch.sort(torch.cat([data.lo * n + data.hi, data.hi * n + data.lo,
                                loops * n + loops])).values
    del data
    rows, cols = key // n, key % n
    del key
    deg = torch.bincount(rows, minlength=n)
    dinv = deg.double().rsqrt()
    vals = (dinv[rows] * dinv[cols]).float()
    indptr = torch.zeros(n + 1, dtype=torch.int64, device="cuda")
    indptr[1:] = torch.cumsum(deg, 0)
    csr = sp.csr_matrix((vals.cpu().numpy(), cols.int().cpu().numpy(), indptr.cpu().numpy()),
                        shape=(n, n))
    del rows, cols, vals
    torch.cuda.empty_cache()
    pack = build_hybrid(csr)
    return pack.tail.to("cuda"), pack.ell.width, int(csr.nnz), n


def measure(tail, f: int, n: int, libs: dict, seed: int) -> dict:
    import torch

    from ssrg_torch.ops.coo_spmm import coo_accumulate, coo_accumulate_plain

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n, f), generator=gen, device="cuda")
    out0 = torch.randn((n, f), generator=gen, device="cuda")
    row, col, val, nnz = tail.row, tail.col, tail.val, tail.nnz
    want = coo_accumulate_plain(row, col, val, x, out0.clone(), nnz)
    counts = torch.bincount(row[:nnz].long(), minlength=n)[:, None]
    tol = 2.0 * (counts + 1) * smoke.UNIT_ROUNDOFF * coo_accumulate_plain(
        row, col, val.abs(), x.abs(), out0.abs(), nnz) + 1e-30
    errs = {}
    for variant, lib in libs.items():
        use(lib)
        got = coo_accumulate(row, col, val, x, out0.clone(), nnz)
        errs[variant] = smoke.hold(f"tail F={f} ({variant})", got, want, tol)
        del got
    del want, tol, counts
    torch.cuda.empty_cache()

    out = out0.clone()
    ms = {variant: [] for variant in libs}
    order = list(libs)
    for r in range(ROUNDS):
        for variant in (order if r % 2 == 0 else order[::-1]):
            use(libs[variant])
            ms[variant].append(smoke.cuda_ms(lambda: coo_accumulate(row, col, val, x, out, nnz)))
    plain_ms = smoke.cuda_ms(lambda: coo_accumulate_plain(row, col, val, x, out, nnz), iters=5)
    crow = torch.zeros(n + 1, dtype=torch.int64, device="cuda")
    crow[1:] = torch.cumsum(torch.bincount(row[:nnz].long(), minlength=n), 0)
    csr = torch.sparse_csr_tensor(crow, col[:nnz].long(), val[:nnz], size=(n, n))
    library_ms = smoke.cuda_ms(lambda: torch.sparse.mm(csr, x))
    x_rows = int(torch.unique(col[:nnz]).numel())
    out_rows = int(torch.unique(row[:nnz]).numel())
    nbytes = nnz * 12 + (x_rows + out_rows) * f * 4
    rec = {"phase": "variants", "f": f, "n": n, "entries": nnz, "x_rows": x_rows,
           "out_rows": out_rows, "max_abs_err": errs, "ms": ms,
           "ms_mean": {v: sum(t) / len(t) for v, t in ms.items()},
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library": "torch.sparse.mm on the CSR of the same entries (no add into out)",
           **smoke.bound(nbytes, 2.0 * nnz * f, smoke.F32_FLOPS_PER_S),
           "gather_bytes": nnz * f * 4}
    src = rec["ms_mean"].get("source")
    if src:
        rec["bound_share"] = rec["bound_ms"] / src
        rec["gather_gb_per_s"] = rec["gather_bytes"] / src / 1e6
    return rec


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--variants", default=",".join(name for name, _ in VARIANTS))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("coo_variants: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    libs = build_variants(args.variants.split(","))
    tail, width, nnz_all, n = cell_tail(args.seed)
    smoke.emit({"phase": "pack", "seed": args.seed, "n": n, "nnz": nnz_all, "ell_width": width,
                "tail_entries": tail.nnz, "tail_chunks": tail.chunks,
                "tail_share": tail.nnz / nnz_all})
    for f in WIDTHS:
        smoke.emit(measure(tail, f, n, libs, args.seed))
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(" | ".join(ln.strip() for ln in smi.stdout.splitlines() if ln.strip()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
