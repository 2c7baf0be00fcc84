"""The host's graph build of a GAT cell in the run's process, from the
program's span totals: the spans that ``setup_graph_s`` sums (here
``prepare.adjacency``, the edge list symmetrized) and ``prepare.edges``, the
attention listing with its self-loops and its transposed listing. Read after
a traced capture; none of these spans runs inside an epoch."""

from portbench import spans

PHASES = ("prepare.adjacency", "prepare.normalize", "prepare.symmetry_test", "prepare.pack",
          "prepare.edges")


def read(view, info):
    totals = spans.totals()
    if not view.calls or not totals or "prepare.edges" not in totals:
        return None
    return sum(totals[p]["seconds"] for p in PHASES if p in totals)
