"""The knee of a serving cell: its traffic offered at several fixed rates,
one window each, to one server built once.

    python3 portbench/sweep.py --workload gamlp-arxiv-serve --rates 600,800,1000 [--seconds 8]

Prints one JSON line a rate: the 50th, 95th and 99th percentile latencies
(ms, from when each request was due), the share of requests answered late
by more than the window's median service time, and the backlog's growth
(the median latency of the window's last fifth over its first fifth). The
highest rate whose backlog does not grow is the knee; a cell runs at about
four fifths of it. Needs a card.
"""

from __future__ import annotations

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path[0] = ROOT

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402


def offer(server, traffic: dict, rate: float, seconds: float, seed: int, num_nodes: int,
          driver) -> dict:
    import numpy as np

    due, _sizes, ids = driver.schedule({**traffic, "rate_per_s": rate}, seconds, seed,
                                       num_nodes)
    latency, service = np.empty(len(due)), np.empty(len(due))
    t0 = time.perf_counter() + 0.05
    for i in range(len(due)):
        at = t0 + due[i]
        while time.perf_counter() < at:
            pass
        start = time.perf_counter()
        server.request(ids[i])
        end = time.perf_counter()
        latency[i], service[i] = end - at, end - start
    fifth = max(1, len(due) // 5)
    return {"rate_per_s": rate, "requests": len(due),
            "p50_ms": 1e3 * float(np.percentile(latency, 50)),
            "p95_ms": 1e3 * float(np.percentile(latency, 95)),
            "p99_ms": 1e3 * float(np.percentile(latency, 99)),
            "service_p50_ms": 1e3 * float(np.median(service)),
            "late_share": float(np.mean(latency - service > np.median(service))),
            "backlog_growth": float(np.median(latency[-fifth:]) / np.median(latency[:fifth]))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--seed", type=int, default=2**31 + 101)
    args = p.parse_args(argv)
    import numpy as np
    import torch

    from portbench import graphs, manifest
    from portbench.programs.common import make_weights, port_dataset

    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    cell = manifest.cell(args.workload)
    cfg, driver = cell.config, manifest.driver(cell.traffic["driver"])
    prog = manifest.program(cfg["model"])
    data = graphs.make_graph(cfg["dataset"], cfg["graph"], args.seed, device)
    weights = make_weights(prog.weight_shapes(cfg), args.seed, device)
    server = prog.Server(data, cfg, weights, device, dataset=port_dataset(data))
    warm = np.random.default_rng(0)
    for s in range(1, int(cell.traffic["batch_max"]) + 1):
        server.request(warm.integers(0, data.num_nodes, s))
    for rate in (float(r) for r in args.rates.split(",")):
        print(json.dumps(offer(server, cell.traffic, rate, args.seconds, args.seed,
                               data.num_nodes, driver)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
