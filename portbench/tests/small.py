"""Small copies of the configurations, for runs on the CPU: the widths cut
so that a test holds them, 9,000 nodes so that the port packs the graph as
at full size (hybrid above 8,192). ``with_planned`` makes a copy of the
benchmark whose manifest also holds the cells of ``portbench/planned/``."""

import copy
import json
import os
import shutil

import torch

from portbench import manifest, run

NODES = 9000
PLANNED = os.path.join(manifest.PACKAGE, "planned")


def planned() -> list:
    return sorted(f[:-5] for f in os.listdir(PLANNED) if f.endswith(".json"))


def with_planned(where) -> str:
    """A checkout of the benchmark under ``where`` whose manifest holds the
    planned cells too; its root."""
    root = os.path.join(str(where), "checkout")
    shutil.copytree(manifest.PACKAGE, os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = manifest.load()
    for name in planned():
        entries = manifest.read_json(os.path.join(PLANNED, f"{name}.json"))
        bench["workloads"].append(entries["workload"])
        bench["end_to_end"] += entries["end_to_end"]
        bench["per_layer"] += entries["per_layer"]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)
    return root


def config(workload: str, root: str = manifest.ROOT) -> dict:
    cfg = copy.deepcopy(manifest.cell(workload, root).config)
    cfg["dataset"].update(num_nodes=NODES, num_edges=5 * NODES, num_features=16,
                          split=[NODES // 3, NODES // 9, NODES // 4])
    cfg["hidden_channels" if "hidden_channels" in cfg else "hidden_dim"] = 32
    return cfg


def execute(workload: str, seed: int = 2**31 + 11, seconds: float = 0.3, trace: bool = False,
            root: str = manifest.ROOT):
    """One run of ``workload`` on the CPU at the small size: (cell, outcome)."""
    return run.execute(workload, seed, seconds, trace, torch.device("cpu"),
                       config=config(workload, root), root=root)
