"""Structured logging, run statistics and tracing (counterpart of
``ssrg_tpu/logger.py``).

- :func:`get_logger`: a file and stdout ``logging`` logger (``ssrg_torch``).
- :class:`RunLogger`: multi-run best-val -> final-test statistics.
- :class:`MetricsWriter`: an append-only JSONL sink.
- :class:`device_trace`: a ``torch.profiler`` trace of a code region, written
  as a Chrome trace, with the region's top device operations and the share
  of it in which the device was busy.
- :class:`PhaseTimer`: named host-clock phases and rates.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import List, Optional

import numpy as np

from ssrg_torch.utils import DeviceLike, resolve_device


def get_logger(name: str = "ssrg_torch", log_file: Optional[str] = None,
               level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(level)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
    stream = logging.StreamHandler(sys.stdout)
    stream.setFormatter(fmt)
    logger.addHandler(stream)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class RunLogger:
    """Per-run (best-val, final-test) tracking with a mean ± std summary."""

    def __init__(self, runs: int):
        self.results = [[] for _ in range(runs)]

    def add_result(self, run: int, result) -> None:
        # result = (train_acc, val_acc, test_acc)
        self.results[run].append(tuple(result))

    def best_of_run(self, run: int):
        r = np.asarray(self.results[run])
        best_epoch = int(r[:, 1].argmax())
        return r[best_epoch, 1], r[best_epoch, 2]

    def print_statistics(self, run: Optional[int] = None) -> str:
        if run is not None:
            val, test = self.best_of_run(run)
            msg = f"Run {run + 1:02d}: best val {val:.4f}, final test {test:.4f}"
        else:
            pairs = [self.best_of_run(i) for i in range(len(self.results)) if self.results[i]]
            vals = np.asarray([p[0] for p in pairs])
            tests = np.asarray([p[1] for p in pairs])
            std_v = vals.std(ddof=1) if len(vals) > 1 else 0.0
            std_t = tests.std(ddof=1) if len(tests) > 1 else 0.0
            msg = (
                f"All runs: val {vals.mean():.4f} ± {std_v:.4f}, "
                f"test {tests.mean():.4f} ± {std_t:.4f}"
            )
        print(msg)
        return msg


class MetricsWriter:
    """Append-only JSONL metrics sink."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "a")

    def write(self, **metrics) -> None:
        metrics.setdefault("ts", time.time())
        self._fh.write(json.dumps(metrics) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


# the device-side events of a Chrome trace: kernels, copies and fills
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


class device_trace:
    """Trace a code region with ``torch.profiler`` (CPU activity, and CUDA
    activity when ``device`` is a CUDA device, the default):

    >>> with device_trace("traces/hops") as trace:
    ...     hops = propagate(adj_dev, x, 3)
    ...     torch.cuda.synchronize()
    >>> trace.top_ops(5), trace.busy_share()

    On exit it writes the Chrome trace ``log_dir/trace.json`` (``path``) and
    keeps the profile (``profile``) for ``key_averages()``. The region is
    marked in the trace by the annotation ``ANNOTATION``, whose host span is
    the window of :meth:`busy_share`; end the region with a synchronize so
    that its device work falls inside it. A trace that cannot start raises;
    it is never skipped."""

    ANNOTATION = "ssrg_torch.device_trace"

    def __init__(self, log_dir: str, device: DeviceLike = "cuda"):
        self.log_dir = log_dir
        self.device = resolve_device(device)
        self.path = os.path.join(log_dir, "trace.json")
        self.profile = None
        self._region = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(self.log_dir, exist_ok=True)
        self.profile = profile(activities=activities)
        self.profile.__enter__()
        self._region = record_function(self.ANNOTATION)
        self._region.__enter__()
        return self

    def __exit__(self, *exc):
        self._region.__exit__(*exc)
        self.profile.__exit__(*exc)
        if exc[0] is None:
            self.profile.export_chrome_trace(self.path)
        return False

    def _events(self) -> List[dict]:
        with open(self.path) as fh:
            return json.load(fh)["traceEvents"]

    def top_ops(self, k: int = 5) -> List[dict]:
        """The ``k`` operations of the region that took the most time, as
        ``{"name", "calls", "ms"}``: on a CUDA trace the device's own
        events (kernels, copies, fills) of the written trace, summed by name;
        on a CPU trace the host operators by their self time (annotations
        left out)."""
        if self.device.type == "cuda":
            by_name: dict = {}
            for e in self._events():
                if e.get("cat") in _DEVICE_CATEGORIES:
                    row = by_name.setdefault(e["name"], {"name": e["name"], "calls": 0,
                                                         "ms": 0.0})
                    row["calls"] += 1
                    row["ms"] += float(e.get("dur", 0)) / 1e3
            rows = list(by_name.values())
        else:
            rows = [{"name": ev.key, "calls": int(ev.count), "ms": ev.self_cpu_time_total / 1e3}
                    for ev in self.profile.key_averages()
                    if not getattr(ev, "is_user_annotation", False)]
        rows.sort(key=lambda r: r["ms"], reverse=True)
        return rows[:k]

    def busy_share(self) -> dict:
        """The share of the region's host span in which the device ran
        something: the union of the kernel, copy and fill intervals of the
        written trace, clipped to the span, over the span. ``lead_ms`` is
        the time from the span's start to the first device event (the
        profiler's start and the first launch)."""
        events = self._events()
        spans = [e for e in events if e.get("name") == self.ANNOTATION
                 and e.get("cat") == "user_annotation"]
        if len(spans) != 1:
            raise RuntimeError(f"device_trace: {len(spans)} region annotations in {self.path}")
        lo = float(spans[0]["ts"])
        hi = lo + float(spans[0]["dur"])
        intervals = sorted(
            (max(float(e["ts"]), lo), min(float(e["ts"]) + float(e.get("dur", 0)), hi))
            for e in events if e.get("cat") in _DEVICE_CATEGORIES)
        busy, end = 0.0, lo
        for a, b in intervals:
            a = max(a, end)
            if b > a:
                busy += b - a
                end = b
        return {"window_ms": (hi - lo) / 1e3, "busy_ms": busy / 1e3,
                "busy_share": busy / (hi - lo) if hi > lo else 0.0,
                "lead_ms": (intervals[0][0] - lo) / 1e3 if intervals else None,
                "device_events": len(intervals)}


class PhaseTimer:
    """Named phase timing on the host clock; also edges/s given a work
    count."""

    def __init__(self):
        self.phases = {}

    def measure(self, name: str):
        timer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                timer.phases[name] = time.perf_counter() - self.t0

        return _Ctx()

    def rate(self, name: str, work: float) -> float:
        return work / self.phases[name] if self.phases.get(name) else 0.0
