#!/usr/bin/env python3
"""Time variants of the ELL kernel's constants on one NVIDIA GPU.

    python3 tools/ell_variants.py

Builds ``ssrg_torch/csrc/ell_spmm.cu`` as it stands and once for each entry
of ``VARIANTS`` with one of its ``constexpr`` constants changed: the feature
tile ``kTile``, the neighbour rows a lane requests before it adds any
(``kBatch``) and the warps of a block (``kWarps``). All ``nvcc`` processes
start together; the libraries go to ``ssrg_torch/build/ell_variants/``.
Then, on the headline and power-law hybrid packs of ``chip_smoke.py`` and on
its L2-resident case (the headline columns taken modulo ``L2_ROWS``), every
variant is held against ``ell_spmm_plain`` within the sum-order bound and
timed through the ``ell_spmm`` wrapper, one call and three chained hops, in
turns: each round runs the variants in order, the next in reverse. Prints a
JSON line per build and per pack, then the card's name and power limit.

``ell_spmm`` itself always runs the source's own constants; this script
only measures that choice. Without a CUDA card it exits 2.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402

VARIANTS = (  # (name, the constants changed from the source's)
    ("source", {}),
    ("kTile=32", {"kTile": 32}),
    ("kTile=128", {"kTile": 128}),
    ("kBatch=4", {"kBatch": 4}),
    ("kBatch=8", {"kBatch": 8}),
    ("kWarps=8", {"kWarps": 8}),
)
ROUNDS = 4


def variant_source(text: str, changes: dict) -> str:
    for const, value in changes.items():
        text, n = re.subn(rf"constexpr int {const} = \d+;", f"constexpr int {const} = {value};",
                          text)
        smoke.check(n == 1, f"ell_spmm.cu has no single 'constexpr int {const} = ...;'")
    return text


def build_variants() -> dict:
    """Every variant's library, loaded and declared, by name."""
    from ssrg_torch.ops import _nvcc
    from ssrg_torch.ops import ell_spmm as ell

    out_dir = os.path.join(_nvcc.BUILD_DIR, "ell_variants")
    os.makedirs(out_dir, exist_ok=True)
    with open(_nvcc.source(ell.NAME)) as f:
        text = f.read()
    procs = {}
    for name, changes in VARIANTS:
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
        ell._declare(libs[name])
    return libs


def use(lib) -> None:
    """Make ``ell_spmm`` launch ``lib``'s kernel: the wrapper takes the
    library ``_nvcc`` has loaded under its name."""
    from ssrg_torch.ops import _nvcc
    from ssrg_torch.ops import ell_spmm as ell

    _nvcc._libs[ell.NAME] = lib


def measure(name: str, cols, vals, x, libs: dict) -> None:
    import torch

    from ssrg_torch.ops.ell_spmm import ell_spmm, ell_spmm_plain

    n = x.shape[0]
    out_p = ell_spmm_plain(cols, vals, x)
    tol = (2.0 * cols.shape[1] * smoke.UNIT_ROUNDOFF * ell_spmm_plain(cols, vals.abs(), x.abs())
           + 1e-30)
    errs = {}
    for variant, lib in libs.items():
        use(lib)
        errs[variant] = smoke.hold(f"{name} ({variant})", ell_spmm(cols, vals, x), out_p, tol)
    del out_p, tol
    torch.cuda.empty_cache()

    def hops():  # K = 3 hops in a chain, each hop's output the next x
        y = x
        for _ in range(3):
            y = ell_spmm(cols, vals, y)[:n]
        return y

    ms = {variant: [] for variant in libs}
    hops_ms = {variant: [] for variant in libs}
    order = list(libs)
    for r in range(ROUNDS):
        for variant in (order if r % 2 == 0 else order[::-1]):
            use(libs[variant])
            ms[variant].append(smoke.cuda_ms(lambda: ell_spmm(cols, vals, x)))
            hops_ms[variant].append(smoke.cuda_ms(hops, iters=5, warmup=1))
    smoke.emit({"phase": "variants", "pack": name, "rows": int(cols.shape[0]),
                "width": int(cols.shape[1]), "n": n, "f": int(x.shape[1]),
                "real_slots": int((vals != 0).sum()), "slots": int(cols.numel()),
                "max_abs_err": errs, "ms": ms, "three_hops_ms": hops_ms,
                "ms_mean": {v: sum(t) / len(t) for v, t in ms.items()},
                "three_hops_ms_mean": {v: sum(t) / len(t) for v, t in hops_ms.items()}})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ell_variants: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    from ssrg_torch.data.synthetic import powerlaw_graph, random_graph
    from ssrg_torch.ops.normalize import sym_norm
    from ssrg_torch.ops.sparse import build_hybrid

    libs = build_variants()
    headline = random_graph(smoke.NUM_NODES, smoke.AVG_DEGREE, smoke.NUM_FEATURES,
                            num_classes=smoke.NUM_CLASSES, seed=smoke.SEED)
    powerlaw = powerlaw_graph(smoke.NUM_NODES, smoke.AVG_DEGREE, smoke.NUM_FEATURES,
                              seed=smoke.SEED)
    for name, g in (("headline", headline), ("powerlaw", powerlaw)):
        pack = build_hybrid(sym_norm(g.adj, 0.5)).ell.to("cuda")
        x = torch.as_tensor(g.x, device="cuda")
        measure(name, pack.cols, pack.vals, x, libs)
        if name == "headline":
            measure("headline_l2_resident", torch.remainder(pack.cols, smoke.L2_ROWS),
                    pack.vals, x[:smoke.L2_ROWS], libs)
        del pack, x
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(" | ".join(ln.strip() for ln in smi.stdout.splitlines() if ln.strip()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
