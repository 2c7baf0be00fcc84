"""Device time of the GAT's attention scores in one training epoch, from the
program's own spans: the CUDA-event time of every ``attn.scores`` span (each
layer's scores forward, in training and in evaluation) and
``attn.scores.bwd`` span (their backward, on the autograd thread) of the
capture (``ssrg_torch/ops/gat_attention.py::gat_scores``), over the epochs.
A program without those spans gives nothing."""

from portbench import spans

NAMES = ("attn.scores", "attn.scores.bwd")


def read(view, info):
    times = [r["device_ms"] for r in spans.capture_records(view) if r["name"] in NAMES]
    if not times or not view.calls or any(t is None for t in times):
        return None
    return sum(times) / view.calls
