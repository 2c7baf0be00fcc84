"""Device time of the GAT's edge attention in one training epoch, from the
program's own spans: the CUDA-event time of every ``attn`` span (each
layer's attention forward, in training and in evaluation) and ``attn.bwd``
span (its backward, on the autograd thread) of the capture
(``ssrg_torch/ops/gat_attention.py``), over the epochs. It measures the
attention whatever kernels implement it."""

from portbench import spans

NAMES = ("attn", "attn.bwd")


def read(view, info):
    times = [r["device_ms"] for r in spans.capture_records(view) if r["name"] in NAMES]
    if not times or not view.calls or any(t is None for t in times):
        return None
    return sum(times) / view.calls
