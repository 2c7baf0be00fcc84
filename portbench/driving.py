"""What every driver of ``portbench/drivers/`` is handed and hands back."""

from __future__ import annotations

import gc
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from portbench import manifest


@dataclass
class Check:
    """One number compared with the reference, beside its limit: the run
    is correct only if the number is at most the limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclass
class Outcome:
    metrics: Dict[str, float]
    attempted: int
    failed: int
    memory_peak_bytes: int
    checks: List[Check]
    view: object = None               # tracing.TraceView of a --trace 1 run
    info: dict = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and bool(self.checks) and all(c.ok for c in self.checks)


class Context:
    """A run's settings and clocks. ``config`` and ``traffic`` are the
    cell's files; ``limits`` its ``portbench/limits/<cell>.json``."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device, t0: float,
                 root: str):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device, self.t0, self.root = device, t0, root
        self.config, self.traffic = cell.config, cell.traffic
        self.limits = manifest.read_json(os.path.join(root, "portbench", "limits",
                                                      f"{cell.name}.json"))
        self.setup_s: Optional[float] = None

    def program(self):
        return manifest.program(self.config["model"], self.root)

    def reference(self):
        return manifest.reference(self.config["model"], self.root)

    def mark(self, what: str) -> None:
        """Note on standard error how far set-up has come (seconds since
        the process started)."""
        self.synchronize()
        print(f"setup {what} {time.perf_counter() - self.t0:.3f}", file=sys.stderr, flush=True)

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def open_window(self) -> float:
        """End set-up: everything the window uses is warm. Returns the
        window's start on the host clock."""
        self.synchronize()
        now = time.perf_counter()
        self.setup_s = now - self.t0
        return now

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        """Give back what the program's state held, before the reference
        runs."""
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def checks(self, values: Dict[str, float]) -> List[Check]:
        return [Check(name, float(values[name]), float(self.limits[name]))
                for name in self.limits]
