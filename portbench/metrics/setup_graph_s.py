"""The host's graph build in the run's process, from the program's span
totals: ``prepare.adjacency`` (the edge list symmetrized), ``prepare.normalize``,
``prepare.symmetry_test`` and ``prepare.pack``, summed. Read after a traced
capture; none of these spans runs inside an epoch."""

from portbench import spans

PHASES = ("prepare.adjacency", "prepare.normalize", "prepare.symmetry_test", "prepare.pack")


def read(view, info):
    totals = spans.totals()
    if not view.calls or not totals or not any(p in totals for p in PHASES):
        return None
    return sum(totals[p]["seconds"] for p in PHASES if p in totals)
