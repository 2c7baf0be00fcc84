"""Structured logging, run statistics and tracing (counterpart of
``ssrg_tpu/logger.py``).

- :func:`get_logger`: a file and stdout ``logging`` logger (``ssrg_torch``).
- :class:`RunLogger`: multi-run best-val -> final-test statistics.
- :class:`MetricsWriter`: an append-only JSONL sink.
- :class:`device_trace`: a ``torch.profiler`` trace of a code region, written
  as a Chrome trace, with the region's top device operations and the share
  of it in which the device was busy.
- :class:`span` and :func:`count`: the program's own spans and counters,
  always summed per name (:func:`span_totals`, :func:`counter_totals`) and,
  while a ``torch.profiler`` runs, also recorded one by one
  (:func:`span_records`) and shown in the profiler's trace.
- :class:`PhaseTimer`: named phases, each a span, and rates.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

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


# -- spans and counters ------------------------------------------------------

# whether a torch.profiler runs on this thread (about 0.1-0.2 us a call)
_profiling = torch._C._autograd._profiler_enabled
_clock = time.perf_counter
_thread_id = threading.get_ident
# records kept while profilers run, at most; the rest are counted as dropped
RECORD_CAP = 1 << 17
# the profiler's Chrome trace writes ``ts`` in us from Unix time rounded
# down to a multiple of this many seconds (its ``baseTimeNanoseconds``)
_TRACE_BASE_S = 7_889_238
_RECORDS: list = []
_DROPPED = "spans.dropped"


class _ThreadSums:
    """One thread's span totals and counters (kept per thread, so that no
    update races), the self time of the spans it has closed, and its
    innermost open record."""

    __slots__ = ("totals", "counts", "closed", "record")

    def __init__(self):
        self.totals: Dict[str, list] = {}   # name -> [calls, seconds, self seconds]
        self.counts: Dict[str, int] = {}
        self.closed = 0.0
        self.record = None


# by thread id: a thread that ends leaves its sums to the next thread that
# gets its id
_THREADS: Dict[int, _ThreadSums] = {}


def _new_sums() -> _ThreadSums:
    return _THREADS.setdefault(_thread_id(), _ThreadSums())


class _Record:
    __slots__ = ("name", "parent", "thread", "counts", "start_ns", "end_ns", "events",
                 "annotation", "up")

    def __init__(self, name, up, thread, start_ns):
        self.name, self.up, self.thread, self.start_ns = name, up, thread, start_ns
        self.parent = None if up is None else up.name
        self.counts: Dict[str, int] = {}
        self.end_ns = self.events = self.annotation = None


def _device_event():
    """A timing event recorded on the current CUDA stream, or None where no
    CUDA work can have run or the stream is capturing a graph."""
    if not torch.cuda.is_initialized() or torch.cuda.is_current_stream_capturing():
        return None
    event = torch.cuda.Event(enable_timing=True)
    event.record()
    return event


class span:
    """A named span of the program, on the host clock:

    >>> with span("prepare.pack"):
    ...     pack = build_hybrid(adj)

    Always: on exit its duration and its self time (the duration less that
    of the spans closed inside it on the same thread) are added to the
    name's totals (:func:`span_totals`), and ``seconds`` holds the
    duration. While a ``torch.profiler`` runs on the thread, the span also
    enters ``record_function(name)``, so that it shows in the profiler's
    trace, and keeps a record (:func:`span_records`): its parent, thread,
    the counts made inside it, and its start and end on the trace's clock,
    stamped just before the profiler's event opens and just after it
    closes; with ``device=True`` also a CUDA event on the current stream at
    entry and at exit (none while the stream captures a graph), read once
    the caller has synchronized. A span never waits for the device."""

    __slots__ = ("name", "device", "seconds", "_t0", "_closed0", "_record", "_sums")

    def __init__(self, name: str, device: bool = False):
        self.name = name
        self.device = device

    def __enter__(self) -> "span":
        sums = self._sums = _THREADS.get(_thread_id()) or _new_sums()
        self._record = self._open_record(sums) if _profiling() else None
        self._closed0 = sums.closed
        self._t0 = _clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        seconds = self.seconds = _clock() - self._t0
        sums = self._sums
        own = seconds - (sums.closed - self._closed0)
        sums.closed += own
        entry = sums.totals.get(self.name)
        if entry is None:
            entry = sums.totals[self.name] = [0, 0.0, 0.0]
        entry[0] += 1
        entry[1] += seconds
        entry[2] += own
        if self._record is not None:
            self._close_record(sums, exc_type, exc, tb)
        return False

    def _open_record(self, sums: _ThreadSums) -> _Record:
        from torch.autograd.profiler import record_function

        rec = _Record(self.name, sums.record, _thread_id(), time.time_ns())
        rec.annotation = record_function(self.name)
        rec.annotation.__enter__()
        if self.device:
            rec.events = (_device_event(), None)
        sums.record = rec
        return rec

    def _close_record(self, sums: _ThreadSums, exc_type, exc, tb) -> None:
        rec = self._record
        if rec.events is not None:
            rec.events = (rec.events[0], _device_event())
        rec.annotation.__exit__(exc_type, exc, tb)
        # stamped after the annotation closes: the profiler's own work at
        # its exit lies inside its event
        rec.end_ns = time.time_ns()
        sums.record, rec.up, rec.annotation = rec.up, None, None
        if len(_RECORDS) < RECORD_CAP:
            _RECORDS.append(rec)
        else:
            count(_DROPPED, 1)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` (:func:`counter_totals`); while a
    profiler runs, also to the record of the innermost recorded span open
    on the thread. ``n`` is a host number: never a value read back from the
    device."""
    sums = _THREADS.get(_thread_id()) or _new_sums()
    sums.counts[name] = sums.counts.get(name, 0) + n
    rec = sums.record
    if rec is not None:
        rec.counts[name] = rec.counts.get(name, 0) + n


def span_totals() -> Dict[str, dict]:
    """Every span name closed since the last :func:`reset_spans`, on any
    thread: ``{"calls", "seconds", "self_seconds"}``."""
    out: Dict[str, dict] = {}
    for sums in list(_THREADS.values()):
        for name, (calls, seconds, own) in list(sums.totals.items()):
            row = out.setdefault(name, {"calls": 0, "seconds": 0.0, "self_seconds": 0.0})
            row["calls"] += calls
            row["seconds"] += seconds
            row["self_seconds"] += own
    return out


def counter_totals() -> Dict[str, int]:
    """Every counter's sum since the last :func:`reset_spans`, on any
    thread; ``spans.dropped`` counts the records not kept past
    ``RECORD_CAP``."""
    out: Dict[str, int] = {}
    for sums in list(_THREADS.values()):
        for name, n in list(sums.counts.items()):
            out[name] = out.get(name, 0) + n
    return out


def trace_clock_us(unix_ns: int) -> float:
    """Unix time in ns on the clock of ``torch.profiler``'s Chrome trace:
    microseconds from its ``baseTimeNanoseconds``."""
    base = int(time.time()) // _TRACE_BASE_S * _TRACE_BASE_S * 1_000_000_000
    return (unix_ns - base) / 1e3


def span_records() -> List[dict]:
    """The spans closed while profilers ran, in the order they opened:
    ``name``, ``parent`` (the innermost recorded span open around it on the
    same thread, or None), ``thread`` (``threading.get_ident()``),
    ``counts``, ``start_us`` and ``end_us`` on the trace's clock
    (:func:`trace_clock_us`) and ``device_ms``, the time between a
    ``device=True`` span's two events once both have completed (else None;
    reading it never waits for the device)."""
    out = []
    for rec in sorted(list(_RECORDS), key=lambda r: r.start_ns):
        device_ms = None
        if rec.events is not None and None not in rec.events and all(
                e.query() for e in rec.events):
            device_ms = rec.events[0].elapsed_time(rec.events[1])
        out.append({"name": rec.name, "parent": rec.parent, "thread": rec.thread,
                    "counts": dict(rec.counts), "start_us": trace_clock_us(rec.start_ns),
                    "end_us": trace_clock_us(rec.end_ns), "device_ms": device_ms})
    return out


def reset_spans() -> None:
    """Clear the totals, the counters and the records."""
    for sums in list(_THREADS.values()):
        sums.totals.clear()
        sums.counts.clear()
    _RECORDS.clear()


class PhaseTimer:
    """Named phases, each a :class:`span` of that name; also edges/s given
    a work count."""

    def __init__(self):
        self.phases = {}

    def measure(self, name: str) -> span:
        timer = self

        class _Phase(span):
            __slots__ = ()

            def __exit__(self, exc_type, exc, tb):
                super().__exit__(exc_type, exc, tb)
                timer.phases[name] = self.seconds
                return False

        return _Phase(name)

    def rate(self, name: str, work: float) -> float:
        return work / self.phases[name] if self.phases.get(name) else 0.0
