"""Launches of the GAT attention's whole-row path in one epoch: its weighted
sum and backward pass where a head is not whole float4s but the row of all
heads is (``ssrg_torch/ops/gat_attention.py::layout``), from the program's
counter ``attn.row_launches`` in the capture's ``attn`` and ``attn.bwd``
spans, over the epochs. Nothing where the program keeps no such counter."""

from portbench import spans

COUNTER = "attn.row_launches"


def read(view, info):
    counts = [r["counts"][COUNTER] for r in spans.capture_records(view)
              if COUNTER in r["counts"]]
    if not counts or not view.calls:
        return None
    return sum(counts) / view.calls
