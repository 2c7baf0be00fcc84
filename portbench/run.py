"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the port, ``ssrg_torch/``. The run makes its data and weights on the
card from ``--seed``, hands them to the port, warms up (set-up, timed as
``setup_s``), measures the cell's traffic for ``--seconds`` with nothing
traced, and then, with ``--trace 1``, profiles a few calls of the same
entry for the per-layer metrics. Last, with the port's state freed, the
plain reference of ``portbench/reference/`` computes again what the timed
path produced and decides ``correct``; each number compared is printed
beside its limit (``portbench/limits/<cell>.json``), as the last lines of
standard error and as the result's last key. The result is the last line
of standard output.

Exit codes: 0 a result was printed; 2 the arguments or the manifest are
wrong; 3 no card, or fewer than the cell asks for; 4 the port is not in
the checkout; 5 a JAX module was loaded. Only 0 prints a result.
"""

from __future__ import annotations

import os
import sys
import time

T0 = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# run as a script, the script's directory comes first on the path; the
# checkout's root takes its place, so that portbench's modules never
# shadow another top-level name
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# kernel caches of torch's own compilers, at fixed paths inside the
# checkout (the port builds its kernels into ssrg_torch/build/)
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".portbench_cache", "triton")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(ROOT, ".portbench_cache", "inductor")

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ssrg_tpu")


def forbidden_modules() -> list:
    """The loaded modules whose top-level name, compared whole, is JAX's,
    one of its libraries' or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit() -> str:
    """``name, power.limit`` of the card as ``nvidia-smi`` reads them, or
    '' where it cannot."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else ""


def result_line(cell, outcome, device) -> dict:
    """The result line: end-to-end metrics, or with a trace the
    per-layer ones, the device, the breakdown, and the checks last."""
    import torch

    from portbench import manifest

    metrics = {}
    if outcome.view is None:
        for m in cell.end_to_end:
            if m["name"] in outcome.metrics:
                metrics[m["name"]] = {"value": outcome.metrics[m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            value = manifest.reader(m["name"]).read(outcome.view, outcome.info)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": outcome.memory_peak_bytes}
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": dev}
    if outcome.view is not None:
        dev["busy_s"] = outcome.view.busy_s
        dev["window_s"] = outcome.view.window_s
        line["breakdown"] = {"device_ops": outcome.view.top_device_ops(10),
                             "idle_gaps": outcome.view.idle_gaps(10)}
    if cuda:
        dev["card"] = power_limit()
    # a number that is not finite (a check with nothing to compare) is
    # written as null: the line stays strict JSON
    line["checks"] = {c.name: {"value": c.value if math.isfinite(c.value) else None,
                               "limit": c.limit} for c in outcome.checks}
    return line


def execute(workload: str, seed: int, seconds: float, trace: bool, device, t0: float = T0,
            root: str = ROOT, config: dict = None):
    """Run the cell's driver; the outcome (see ``portbench.driving``).
    ``config`` replaces the cell's configuration (the CPU tests run small
    copies)."""
    from portbench import manifest
    from portbench.driving import Context

    cell = manifest.cell(workload, root)
    if config is not None:
        cell.config = config
    ctx = Context(cell, seed, seconds, trace, device, t0, root)
    return cell, manifest.driver(cell.traffic["driver"], root).run(ctx)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import manifest

    try:
        cell = manifest.cell(args.workload)
    except (KeyError, OSError, ValueError) as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        import ssrg_torch
    except ImportError as exc:
        print(f"portbench: the port is not in this checkout: {exc}", file=sys.stderr)
        return 4
    if not os.path.abspath(ssrg_torch.__file__).startswith(ROOT + os.sep):
        print(f"portbench: ssrg_torch was found outside the checkout: {ssrg_torch.__file__}",
              file=sys.stderr)
        return 4
    # the configurations state float32 with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    cell, outcome = execute(args.workload, args.seed, args.seconds, bool(args.trace), device)
    print(f"run {time.perf_counter() - T0:.3f}", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: JAX modules loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 5
    line = result_line(cell, outcome, device)
    for c in outcome.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
