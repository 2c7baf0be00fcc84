#!/usr/bin/env python3
"""Time variants of the banded kernel's tensor-core tiles on one NVIDIA GPU.

    python3 tools/banded_variants.py

Builds ``ssrg_torch/csrc/banded_spmm.cu`` as it stands and once for each
entry of ``VARIANTS`` with some of its ``constexpr`` tile constants changed:
for F <= 128 the window rows of a stage (``kTcDepth``), the ring's stages
(``kTcStages``) and the stages of ``wgmma`` left in flight across the next
stage's barrier (``kTcInFlight``); for F > 128 the features of a tile
(``kTcWideFeatures``: 256 reads the pack once for F <= 256, 128 once for
every 128 features) and its ``kTcWideInFlight``.
All ``nvcc`` processes start together; the libraries go to
``ssrg_torch/build/banded_variants/``. Then, on the bf16 pack of
``chip_smoke.py``'s banded graph (``reorder_banded`` with ``spmm_bf16``) at
F = 128 and at F = 256, and on the bench's dense bf16 pack, every variant is
held against ``banded_spmm_plain`` within the tensor-core bound
(``chip_smoke.py``'s ``BANDED_TOLERANCE``) and timed through the
``banded_spmm`` wrapper, in turns: each round runs the variants in order,
the next in reverse (the median of ``ROUNDS`` is reported). Last,
``torch.profiler`` splits the source's time on each pack into its two
kernels (the rounding pass and the product), beside one f32 -> bf16 cast of
x as a yardstick for the rounding pass, and the plain version and one
``torch.bmm`` over the windows gathered beforehand are timed. Prints a
JSON line per build and per pack, then the card's name and power limit.

``banded_spmm`` itself always runs the source's own constants; this script
only measures that choice. Without a CUDA card it exits 2.
"""

from __future__ import annotations

import ctypes
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402

VARIANTS = (  # (name, the constants changed from the source's)
    ("source", {}),
    ("kTcInFlight=1", {"kTcInFlight": 1}),
    ("kTcDepth=64,kTcStages=6,kTcInFlight=1", {"kTcDepth": 64, "kTcStages": 6, "kTcInFlight": 1}),
    ("kTcWideInFlight=0", {"kTcWideInFlight": 0}),
    ("kTcWideFeatures=128", {"kTcWideFeatures": 128}),
)
ROUNDS = 4


def variant_source(text: str, changes: dict) -> str:
    for const, value in changes.items():
        text, n = re.subn(rf"constexpr int {const} = \d+;", f"constexpr int {const} = {value};",
                          text)
        smoke.check(n == 1, f"banded_spmm.cu has no single 'constexpr int {const} = ...;'")
    return text


def build_variants() -> dict:
    """Every variant's library, loaded and declared, by name."""
    from ssrg_torch.ops import _nvcc
    from ssrg_torch.ops import banded_spmm as banded

    out_dir = os.path.join(_nvcc.BUILD_DIR, "banded_variants")
    os.makedirs(out_dir, exist_ok=True)
    with open(_nvcc.source(banded.NAME)) as f:
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
                              if "registers" in ln or "spill" in ln or "Compiling" in ln
                              or "arning" in ln]})
        libs[name] = ctypes.CDLL(path)
        banded._declare(libs[name])
    return libs


def use(lib) -> None:
    """Make ``banded_spmm`` launch ``lib``'s kernel: the wrapper takes the
    library ``_nvcc`` has loaded under its name."""
    from ssrg_torch.ops import _nvcc
    from ssrg_torch.ops import banded_spmm as banded

    _nvcc._libs[banded.NAME] = lib


def profile_kernels(fn, calls: int = 20) -> dict:
    """Mean device microseconds a call of each CUDA kernel that ``fn``
    launches, from ``torch.profiler``, or None if it saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", 0.0)
        if us and ev.count >= calls and "kernel" in ev.key:
            out[ev.key] = us / calls
    return out or None


def measure(name: str, blocks, los, x, libs: dict) -> None:
    import torch

    from ssrg_torch.ops.banded_spmm import banded_spmm, banded_spmm_plain

    def call(variant):
        use(libs[variant])
        return banded_spmm(blocks, los, x, True)

    out_p = banded_spmm_plain(blocks, los, x, True)
    counts = (blocks != 0).sum(dim=2).reshape(-1, 1)
    tol = (smoke.BANDED_TOLERANCE["tensor_core"] * counts * smoke.UNIT_ROUNDOFF
           * banded_spmm_plain(blocks.abs(), los, x.abs(), True) + 1e-30)
    order = list(libs)
    errs = {v: smoke.hold(f"{name} ({v})", call(v), out_p, tol) for v in order}
    del out_p, tol
    torch.cuda.empty_cache()
    ms = {v: [] for v in order}
    for r in range(ROUNDS):
        for v in (order if r % 2 == 0 else order[::-1]):
            ms[v].append(smoke.cuda_ms(lambda: call(v)))
    use(libs["source"])
    kernels_us = profile_kernels(lambda: call("source"))
    nb, rb, w = blocks.shape
    f = x.shape[1]
    # the yardsticks of chip_smoke.banded_case: the plain version, and one
    # torch.bmm over the bf16 windows gathered beforehand
    plain_ms = smoke.cuda_ms(lambda: banded_spmm_plain(blocks, los, x, True), iters=5)
    xp = torch.cat([x, x.new_zeros((max(int(los.max()) + w - x.shape[0], 0), f))])
    windows = xp[los.long()[:, None] + torch.arange(w, device=x.device)].bfloat16()
    del xp
    library_ms = smoke.cuda_ms(lambda: torch.bmm(blocks, windows))
    del windows
    nbytes = blocks.numel() * 2 + los.numel() * 4 + x.numel() * 4 + nb * rb * f * 4
    bound_ms = nbytes / smoke.HBM_BYTES_PER_S * 1e3
    median = {v: statistics.median(t) for v, t in ms.items()}
    smoke.emit({"phase": "variants", "pack": name, "blocks": [nb, rb, w], "n": int(x.shape[0]),
                "f": f, "nonzeros": int(counts.sum()), "max_abs_err": errs, "ms": ms,
                # a yardstick for the tensor-core path's rounding pass
                "x_to_bf16_ms": smoke.cuda_ms(lambda: x.to(torch.bfloat16)),
                "ms_median": median, "bytes_bound_ms": bound_ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                # the source's device time by kernel, one call (None: no device events)
                "source_kernels_us": kernels_us,
                "bound_share": {v: bound_ms / t for v, t in median.items()},
                "dense_tflops_per_s": {v: 2.0 * nb * rb * w * f / t / 1e9
                                       for v, t in median.items()}})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("banded_variants: torch.cuda.is_available() is False; this script needs a "
              "CUDA card", file=sys.stderr)
        return 2
    from ssrg_torch import bench

    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_variants()
    _, pack, x = smoke.locality_layers("banded_bf16", smoke.banded_dataset(), "reorder_banded",
                                       True, 3)
    measure("banded_bf16_pack", pack.blocks, pack.los, x, libs)
    gen = torch.Generator(device=x.device).manual_seed(smoke.SEED)
    x = torch.randn((x.shape[0], 256), generator=gen, device=x.device)
    measure("banded_bf16_pack_f256", pack.blocks, pack.los, x, libs)
    del pack, x
    torch.cuda.empty_cache()
    blocks, los, x = bench.banded_tier_inputs(smoke.NUM_FEATURES, "cuda")
    measure("bench_banded_dense", blocks, los, x, libs)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(" | ".join(ln.strip() for ln in smi.stdout.splitlines() if ln.strip()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
