"""The program's own spans and counters, as the per-layer readers take them
(``ssrg_torch/logger.py``): the records the program kept while the trace's
profiler ran (``span_records``: name, parent, thread, counts, host start
and end on the trace's clock, a device span's CUDA-event time) and its
per-process totals (``span_totals``). A program that keeps none gives
nothing here, and every reader then finds nothing.

- :func:`capture_records`: the records of a ``--trace 1`` capture, those
  whose host span overlaps the capture's device events;
- :func:`idle_by_span`: the device's idle time inside the capture's first
  and last program span on the main thread, split by the innermost span of
  a given set that the main thread was in (``None`` for none of them).
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional


def _logger():
    try:
        from ssrg_torch import logger
    except ImportError:
        return None
    return logger


def records() -> Optional[List[dict]]:
    """Every record the program kept, or None where it keeps none."""
    read = getattr(_logger(), "span_records", None)
    return None if read is None else read()


def totals() -> Optional[Dict[str, dict]]:
    """The program's span totals in this process, or None where it keeps
    none."""
    read = getattr(_logger(), "span_totals", None)
    return None if read is None else read()


def capture_records(view) -> List[dict]:
    """The closed records of the capture ``view`` reduces: those that
    overlap its device events (clipped to the capture); none where the
    capture ran nothing on the device."""
    kept = records()
    if not kept or not view.device:
        return []
    lo = min(ts for _c, _n, ts, _d in view.device)
    hi = max(ts + dur for _c, _n, ts, dur in view.device)
    return [r for r in kept if r["end_us"] is not None and r["start_us"] < hi and r["end_us"] > lo]


def _busy(view) -> List[tuple]:
    """The union of the device events' intervals, in order."""
    merged: List[list] = []
    for a, b in sorted((ts, ts + dur) for _c, _n, ts, dur in view.device):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def idle_by_span(view, kinds: Dict[str, Iterable[str]],
                 thread: Optional[int] = None) -> Optional[Dict[Optional[str], float]]:
    """The device's idle microseconds inside the capture's program spans on
    ``thread`` (the main thread by default), from the start of the first to
    the end of the last, split by kind: each idle moment goes to the kind of
    the innermost span of the thread, among those ``kinds`` names, open at
    that moment, or to ``None`` where none of them was open. The kinds
    partition the idle time. None where the capture has no such spans or no
    device events."""
    thread = threading.main_thread().ident if thread is None else thread
    kind_of = {name: kind for kind, names in kinds.items() for name in names}
    spans = sorted((r["start_us"], r["end_us"], kind_of[r["name"]])
                   for r in capture_records(view)
                   if r["thread"] == thread and r["name"] in kind_of)
    if not spans:
        return None
    lo, hi = spans[0][0], max(s[1] for s in spans)
    # the idle intervals inside [lo, hi]
    idle, at = [], lo
    for a, b in _busy(view):
        if a > at:
            idle.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        idle.append((at, hi))
    # who the innermost open span is between consecutive starts and ends
    # (a thread's spans nest: ends are taken before starts at one moment)
    points = sorted([(a, 1, i) for i, (a, _b, _k) in enumerate(spans)]
                    + [(b, 0, i) for i, (_a, b, _k) in enumerate(spans)])
    owner, active, prev = [], [], lo
    for t, opens, i in points:
        if t > prev:
            owner.append((prev, t, spans[active[-1]][2] if active else None))
        if opens:
            active.append(i)
        else:
            active.remove(i)
        prev = t
    out: Dict[Optional[str], float] = {kind: 0.0 for kind in kinds}
    out[None] = 0.0
    j = 0
    for a, b in idle:
        while j < len(owner) and owner[j][1] <= a:
            j += 1
        k = j
        while k < len(owner) and owner[k][0] < b:
            left, right, kind = owner[k]
            out[kind] += max(0.0, min(b, right) - max(a, left))
            k += 1
    return out
