"""The epoch's share of the card's peak: the least time of its model work
(``portbench/work.py``: every product, SpMM and fused elementwise pass at
the larger of its operations over the float32 peak and its compulsory bytes
over the memory's bandwidth, SpMMs counted from the graph) over the wall
time of an epoch in the untraced window."""


def read(view, info):
    work, wall = info.get("work"), info.get("wall_s_per_call")
    if work is None or not wall or work.least_s <= 0:
        return None
    return 100.0 * work.least_s / wall
