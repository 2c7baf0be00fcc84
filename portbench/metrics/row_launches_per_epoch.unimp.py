"""Launches of the attention's whole-row path in one UniMP epoch, from the
program's counter ``attn.row_launches`` in the capture's ``attn`` and
``attn.bwd`` spans, over the epochs, read by ``row_launches_per_epoch.gat``'s
reader. The per-edge modes take the per-head lanes only, so it reads 0
until they take whole rows; nothing where the program keeps no such
counter."""

from portbench import manifest

read = manifest.reader("row_launches_per_epoch.gat").read
