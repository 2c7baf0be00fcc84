"""Device time of the graph-transformer attention's per-edge scores and
their gradient in one training epoch, from the program's own spans: the
CUDA-event time of every ``attn.qk`` span (each layer's q.k scores, in
training, in the backward pass's recomputation and in evaluation) and
``attn.qk.bwd`` span (their gradient into q and k, on the autograd thread)
of the capture (``ssrg_torch/ops/gat_attention.py::dot_attention``), over
the epochs. A program without those spans gives nothing."""

from portbench import spans

NAMES = ("attn.qk", "attn.qk.bwd")


def read(view, info):
    times = [r["device_ms"] for r in spans.capture_records(view) if r["name"] in NAMES]
    if not times or not view.calls or any(t is None for t in times):
        return None
    return sum(times) / view.calls
