"""Whole ``prepare`` calls back to back on one graph: the snapshot refresh
a serving user pays (host normalize, pack, copy, the K hops), each ending
in a synchronize, with no disk cache of the hops.

Set-up converts the benchmark's graph into the port's dataset and runs
``warmup_calls`` calls. The window runs calls until ``--seconds`` have
passed: ``prepare_s`` is its time over the calls completed. The hop stacks
of ``kept_calls`` of them, drawn from the seed (a reservoir sample), are
held to the reference's hops: ``hop_gap`` is the largest absolute gap of
any hop over that hop's largest reference value, worst over the kept
calls. With a trace, ``capture_calls`` calls are profiled after the window.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import graphs, manifest, tracing
from portbench.driving import Outcome
from portbench.programs.common import port_dataset
from portbench.reference.common import relative_gap


def run(ctx) -> Outcome:
    cfg, traffic = ctx.config, ctx.traffic
    prog, ref = ctx.program(), ctx.reference()
    data = graphs.make_graph(cfg["dataset"], cfg["graph"], ctx.seed, ctx.device)
    ctx.mark("data")
    dataset = port_dataset(data)
    spec = prog.spec(cfg)
    for _ in range(int(traffic["warmup_calls"])):
        prog.prepare(cfg, dataset, spec, ctx.device)

    ctx.mark("warmup")
    keep = int(traffic["kept_calls"])
    rng = np.random.default_rng(graphs.stream_seed(ctx.seed, "sample"))
    kept = []
    t0 = ctx.open_window()
    calls = 0
    while True:
        out = prog.prepare(cfg, dataset, spec, ctx.device).inputs
        calls += 1
        if len(kept) < keep:
            kept.append(out)
        else:
            j = int(rng.integers(0, calls))
            if j < keep:
                kept[j] = out
        del out
        elapsed = time.perf_counter() - t0
        if elapsed >= ctx.seconds:
            break
    peak = ctx.memory_peak()

    view, info = None, {}
    if ctx.trace:
        view = tracing.capture(lambda: prog.prepare(cfg, dataset, spec, ctx.device),
                               int(traffic["capture_calls"]), ctx.device,
                               ctx.device.type == "cuda")
        info = {"wall_s_per_call": elapsed / calls}
    kept = [k.cpu() for k in kept]
    del dataset, spec
    ctx.free()

    expect = ref.hops(data, cfg).cpu()
    return Outcome({"prepare_s": elapsed / calls, "setup_s": ctx.setup_s}, calls, 0, peak,
                   ctx.checks(compare(kept, expect)), view, info)


def compare(kept: list, expect) -> dict:
    """``hop_gap`` of the kept hop stacks against the reference's."""
    return {"hop_gap": max(relative_gap(k[h], expect[h]) for k in kept
                           for h in range(expect.shape[0]))}


def control(cell, cfg: dict, seed: int, device, seconds: float, fault: str = None) -> dict:
    """``hop_gap`` of the reference's hops computed in TF32."""
    if fault is not None:
        raise ValueError(f"{fault!r} is a fault of training cells")
    ref = manifest.reference(cfg["model"])
    data = graphs.make_graph(cfg["dataset"], cfg["graph"], seed, device)
    return compare([ref.hops(data, cfg, "tf32").cpu()], ref.hops(data, cfg).cpu())
