"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a few
calls of the window's own entry, and the reduction of its events.

The benchmark's own spans mark the capture (``portbench.capture``) and each
call in it (``portbench.call``). The profiler's Chrome trace is written to
``TMPDIR`` and deleted once read. From it:

- device events: kernels, copies and fills, clipped to the capture;
- busy: the union of their intervals (``busy_s``), over the capture's host
  span (``window_s``);
- each kernel's launching operator: the innermost ``aten::`` operator on
  the launching thread whose host span holds the launch;
- ``device_ops``: device time summed by name, the largest first;
- ``idle_gaps``: the device's idle time inside the capture, summed by what
  the host thread that opened the capture was running at each gap's middle
  (its innermost operator, else ``python``).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
CAPTURE = "portbench.capture"
CALL = "portbench.call"


@dataclass
class Kernel:
    name: str
    ts: float      # microseconds
    dur: float
    op: str        # the launching aten operator, '' if none


@dataclass
class TraceView:
    calls: int
    window_s: float
    busy_s: float
    device: List[tuple]                  # (category, name, ts, dur), clipped
    kernels: List[Kernel]
    host_gaps: Dict[str, float] = field(default_factory=dict)

    def kernels_named(self, part: str) -> List[Kernel]:
        return [k for k in self.kernels if part in k.name]

    def top_device_ops(self, k: int = 10) -> List[list]:
        by_name: Dict[str, float] = defaultdict(float)
        for _cat, name, _ts, dur in self.device:
            by_name[name] += dur / 1e6
        return [[n, s] for n, s in sorted(by_name.items(), key=lambda r: -r[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        return [[n, s] for n, s in sorted(self.host_gaps.items(), key=lambda r: -r[1])[:k]]


def capture(fn: Callable[[], None], calls: int, device, with_cuda: bool = True) -> TraceView:
    """Profile ``calls`` calls of ``fn`` (each ends in a synchronize) and
    reduce the trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if with_cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(CAPTURE):
            for _ in range(calls):
                with record_function(CALL):
                    fn()
            if with_cuda:
                torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce_events(events, calls)


def _innermost(intervals: List[tuple], starts: List[float], reach: List[float],
               t: float) -> Optional[str]:
    """The innermost interval ``(start, end, name)`` holding ``t``, among
    intervals sorted by start (nested ones start later); ``reach[i]`` is
    the latest end among the first ``i + 1``."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0 and reach[i] >= t:
        a, b, name = intervals[i]
        if a <= t <= b:
            # scanning back from t, the first that holds t starts last
            return name
        i -= 1
    return None


def reduce_events(events: List[dict], calls: int) -> TraceView:
    spans = [e for e in events if e.get("name") == CAPTURE and e.get("cat") == "user_annotation"]
    if len(spans) != 1:
        raise RuntimeError(f"{len(spans)} capture spans in the trace")
    lo = float(spans[0]["ts"])
    hi = lo + float(spans[0]["dur"])
    main_tid = spans[0].get("tid")

    ops: Dict[object, List[tuple]] = defaultdict(list)
    for e in events:
        if e.get("cat") == "cpu_op" and "dur" in e:
            a = float(e["ts"])
            ops[e.get("tid")].append((a, a + float(e["dur"]), e["name"]))
    starts, reach = {}, {}
    for tid, lst in ops.items():
        lst.sort(key=lambda r: r[0])
        starts[tid] = [r[0] for r in lst]
        ends, latest = [], float("-inf")
        for r in lst:
            latest = max(latest, r[1])
            ends.append(latest)
        reach[tid] = ends

    launches = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (float(e["ts"]), e.get("tid"))

    device, kernels, intervals = [], [], []
    for e in events:
        if e.get("cat") not in DEVICE_CATEGORIES:
            continue
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        device.append((e["cat"], e["name"], a, b - a))
        intervals.append((a, b))
        if e["cat"] == "kernel":
            op = ""
            launch = launches.get(e.get("args", {}).get("correlation"))
            if launch is not None and launch[1] in ops:
                tid = launch[1]
                op = _innermost(ops[tid], starts[tid], reach[tid], launch[0]) or ""
            kernels.append(Kernel(e["name"], a, b - a, op))

    intervals.sort()
    busy, end = 0.0, lo
    gaps = []
    for a, b in intervals:
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if hi > end:
        gaps.append((end, hi))
    host_gaps: Dict[str, float] = defaultdict(float)
    main = (ops.get(main_tid, []), starts.get(main_tid, []), reach.get(main_tid, []))
    for a, b in gaps:
        name = _innermost(*main, (a + b) / 2) or "python"
        host_gaps[name] += (b - a) / 1e6
    return TraceView(calls, (hi - lo) / 1e6, busy / 1e6, device, kernels, dict(host_gaps))
