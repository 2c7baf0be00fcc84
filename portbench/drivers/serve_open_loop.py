"""An open loop of requests for the labels of node ids, as independent users
send them: each request is due at a fixed time and is sent then, or as soon
as the one before it is answered, and is timed from when it was due until
its logits are on the host.

The traffic file fixes ``rate_per_s`` and the request sizes, log-uniform
from ``batch_min`` to ``batch_max`` ids. Every seed gets the same set of
gaps (the exponential distribution's quantiles at ``rate_per_s``) and the
same set of sizes (the log-uniform quantiles), in an order drawn from the
seed; the ids are uniform over the nodes. ``--seconds`` times the rate
requests are due in the window.

Set-up builds the program's server (its ``prepare`` included) and sends
one request of every size the window will send. Below the server's
capacity the end-to-end metric is ``request_p95_ms``, the 95th percentile
of all due requests' latencies; a request that fails, or is not answered
within ``give_up_s`` after the window closes, counts as missing (answered
when the run gave up) and as failed. Above it the queue grows all through
the window, and the metric is ``requests_per_s``: the requests answered
before the window closed, over its length; the backlog is still answered
after the close. The answers of ``checked_requests`` requests drawn from
the seed, and of the longest, are held to the reference's logits: ``logit_gap`` is the largest absolute gap
over the largest reference logit of that request, worst over the checked
ones. With a trace, ``capture_requests`` of the window's requests are sent
back to back and profiled.
"""

from __future__ import annotations

import itertools
import math
import sys
import time

import numpy as np

from portbench import graphs, manifest, tracing
from portbench.driving import Outcome
from portbench.programs.common import make_weights, port_dataset
from portbench.reference.common import relative_gap


def schedule(traffic: dict, seconds: float, seed: int, num_nodes: int):
    """Due times (s from the window's start), sizes and id arrays."""
    rate = float(traffic["rate_per_s"])
    m = max(1, int(round(rate * seconds)))
    q = (np.arange(m) + 0.5) / m
    rng = np.random.default_rng(graphs.stream_seed(seed, "traffic"))
    gaps = rng.permutation(-np.log1p(-q) / rate)
    due = (np.cumsum(gaps) - gaps) * (seconds / gaps.sum())
    lo, hi = math.log(int(traffic["batch_min"])), math.log(int(traffic["batch_max"]) + 1)
    sizes = np.minimum(np.floor(np.exp(lo + (hi - lo) * q)).astype(np.int64),
                       int(traffic["batch_max"]))
    sizes = rng.permutation(sizes)
    ids = [rng.integers(0, num_nodes, s) for s in sizes]
    return due, sizes, ids


def checked_requests(traffic: dict, sizes, seed: int) -> set:
    """The requests whose answers are held to the reference: a sample drawn
    from the seed, and the longest."""
    m = len(sizes)
    rng = np.random.default_rng(graphs.stream_seed(seed, "sample"))
    checked = set(rng.choice(m, min(m, int(traffic["checked_requests"])), replace=False).tolist())
    checked.add(int(np.argmax(sizes)))
    return checked


def compare(answers: dict, expect, ids) -> dict:
    """``logit_gap`` of the answered requests (index -> logits) against the
    reference's logits of every node."""
    return {"logit_gap": max((relative_gap(out, expect[ids[i]]) for i, out in answers.items()),
                             default=float("inf"))}


def run(ctx) -> Outcome:
    cfg, traffic = ctx.config, ctx.traffic
    prog, ref = ctx.program(), ctx.reference()
    data = graphs.make_graph(cfg["dataset"], cfg["graph"], ctx.seed, ctx.device)
    ctx.mark("data")
    weights = make_weights(prog.weight_shapes(cfg), ctx.seed, ctx.device)
    server = prog.Server(data, cfg, weights, ctx.device, dataset=port_dataset(data))
    ctx.mark("program")
    due, sizes, ids = schedule(traffic, ctx.seconds, ctx.seed, data.num_nodes)
    warm = np.random.default_rng(0)
    for s in np.unique(sizes):
        server.request(warm.integers(0, data.num_nodes, s))

    ctx.mark("warmup")
    m = len(due)
    checked = checked_requests(traffic, sizes, ctx.seed)
    answers = {}
    latency = np.full(m, np.inf)
    failed = answered = 0
    give_up = float(traffic["give_up_s"])
    t0 = ctx.open_window()
    for i in range(m):
        at = t0 + due[i]
        wait = at - time.perf_counter()
        if wait > 0.002:
            time.sleep(wait - 0.001)
        while time.perf_counter() < at:
            pass
        if time.perf_counter() > t0 + ctx.seconds + give_up:
            failed += m - i
            break
        try:
            out = server.request(ids[i])
        except Exception as exc:  # a request that raises is answered by no one
            failed += 1
            print(f"request {i} failed: {exc!r}", file=sys.stderr)
            continue
        done = time.perf_counter()
        latency[i] = done - at
        answered += done <= t0 + ctx.seconds
        if i in checked:
            answers[i] = out
    peak = ctx.memory_peak()
    # a request never answered counts as answered when the run gave up
    latency = np.minimum(latency, ctx.seconds + give_up - due)

    view, info = None, {}
    if ctx.trace:
        order = itertools.count()
        view = tracing.capture(lambda: server.request(ids[next(order) % m]),
                               int(traffic["capture_requests"]), ctx.device,
                               ctx.device.type == "cuda")
        info = {}
    server.close()
    del server
    ctx.free()

    stack = ref.hops(data, cfg)
    expect = ref.logits(stack, weights, cfg).cpu()
    del stack
    return Outcome({"request_p95_ms": 1e3 * float(np.percentile(latency, 95)),
                    "requests_per_s": answered / ctx.seconds,
                    "setup_s": ctx.setup_s}, m, failed, peak,
                   ctx.checks(compare(answers, expect, ids)), view, info)


def control(cell, cfg: dict, seed: int, device, seconds: float, fault: str = None) -> dict:
    """``logit_gap`` of the requests a run checks, answered by the
    reference computed in TF32."""
    if fault is not None:
        raise ValueError(f"{fault!r} is a fault of training cells")
    prog, ref = manifest.program(cfg["model"]), manifest.reference(cfg["model"])
    data = graphs.make_graph(cfg["dataset"], cfg["graph"], seed, device)
    weights = make_weights(prog.weight_shapes(cfg), seed, device)
    _due, sizes, ids = schedule(cell.traffic, seconds, seed, data.num_nodes)
    low = ref.logits(ref.hops(data, cfg, "tf32"), weights, cfg, "tf32").cpu()
    answers = {i: low[ids[i]] for i in checked_requests(cell.traffic, sizes, seed)}
    return compare(answers, ref.logits(ref.hops(data, cfg), weights, cfg).cpu(), ids)
