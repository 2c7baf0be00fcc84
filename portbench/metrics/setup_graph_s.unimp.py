"""The host's graph build of the UniMP cell in the run's process: the spans
``setup_graph_s.gat`` sums, read by that reader. Here ``prepare.edges``
holds the attention listing without self-loops, its transposed listing and
the places of the transposed entries in the row listing. Read after a
traced capture; none of these spans runs inside an epoch."""

from portbench import manifest

read = manifest.reader("setup_graph_s.gat").read
