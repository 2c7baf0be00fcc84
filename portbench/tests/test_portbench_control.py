"""The control: the plain reference computed in TF32 in the program's
place, read by each cell's own numbers, exceeds at least one of the cell's
limits (here at small sizes on the CPU; ``portbench/control.py`` reads it
at the cells' own sizes on the card)."""

import os

import pytest
import torch

from portbench import control, manifest
from portbench.tests import small


@pytest.mark.parametrize("workload", [w["name"] for w in manifest.load()["workloads"]]
                         + small.planned())
def test_control_is_caught(workload, tmp_path):
    root = small.with_planned(tmp_path)
    limits = manifest.read_json(os.path.join(manifest.PACKAGE, "limits", f"{workload}.json"))
    worst = []
    for seed in (1, 2, 2**31 + 5):
        values = control.readings(workload, seed, torch.device("cpu"), 1.0,
                                  config=small.config(workload, root), root=root)
        assert set(values) == set(limits)
        worst.append(max(values[k] / limits[k] for k in limits))
    assert min(worst) > 1.0, worst
