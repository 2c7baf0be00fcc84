"""Carry parameters of the reference's flax modules over to the port.

``params_from_jax`` turns a flax parameter tree (nested mappings of
arrays, e.g. ``jax.tree_util.tree_map(np.asarray, params)``) into a state
dict of the port's modules, whose submodules carry the flax names
(``msg_op/jk``, ``head/fc_0``, ``head/prelu_0``, ``head/fc_out``, ...).
A ``Dense`` ``kernel`` ``[in, out]`` becomes the Linear ``weight``
``[out, in]``; ``bias``, ``slope`` and ``hop_weight`` carry over as they are.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch

_VERBATIM = ("bias", "slope", "hop_weight")


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flax parameter tree -> state dict (float32 tensors on the CPU). A
    top-level ``{"params": ...}`` variables dict is unwrapped."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        for name, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{name}.")
                continue
            arr = np.asarray(value, dtype=np.float32)
            if name == "kernel":
                if arr.ndim != 2:
                    raise ValueError(f"{prefix}{name}: expected a 2-D Dense kernel")
                out[f"{prefix}weight"] = torch.tensor(arr.T)
            elif name in _VERBATIM:
                out[f"{prefix}{name}"] = torch.tensor(arr)
            else:
                raise KeyError(f"no port mapping for flax parameter {prefix}{name}")

    walk(tree, "")
    return out
