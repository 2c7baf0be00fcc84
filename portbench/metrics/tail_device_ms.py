"""Device time of the hybrid SpMM's COO tail in one training epoch, from the
program's own span: the CUDA-event time of every ``spmm.tail`` span of the
capture (``ssrg_torch/ops/sparse.py::HybridAdj.spmm``, forward, backward on
the autograd thread, and evaluation), over the epochs. It measures the tail
whatever kernels implement it."""

from portbench import spans


def read(view, info):
    times = [r["device_ms"] for r in spans.capture_records(view) if r["name"] == "spmm.tail"]
    if not times or not view.calls or any(t is None for t in times):
        return None
    return sum(times) / view.calls
