"""Carry parameters between the reference's flax modules and the port.

``params_from_jax`` turns a flax parameter tree (nested mappings of
arrays, e.g. ``jax.tree_util.tree_map(np.asarray, params)``) or a flax
variables dict (``{"params": ..., "batch_stats": ...}``) into a state dict
of the port's modules, whose submodules carry the flax names (``msg_op/jk``,
``head/fc_0``, ``head/bn_0``, ``head/prelu_0``, ``head/fc_out``, ...):

- a ``Dense`` ``kernel`` ``[in, out]`` becomes the Linear ``weight``
  ``[out, in]``;
- a ``BatchNorm``'s ``scale`` becomes ``weight``, and its statistics
  ``mean``/``var`` (in ``batch_stats``) ``running_mean``/``running_var``;
- ``bias``, ``slope``, ``hop_weight``, ``hop_node_weight``,
  ``subgraph_weight``, the complex layers' ``w_re``, ``w_im``, ``b_re`` and
  ``b_im`` (``[in, out]`` in both packages) and the wavelet layer's
  ``theta`` carry over as they are;
- the wavelet layer's ``weight`` (``[in, out]`` in both packages) carries
  over as it is, under the same name;
- a link head's tree (``edge_fc``, and the GCN's ``fc2_edge``, both
  ``Dense``) carries over as any other: the port's link heads
  (``load_model(..., link=True)``) hold the same submodules;
- the baseline GAT's attention vectors ``a_src_{i}``/``a_dst_{i}`` (``[1,
  H, D]`` in both packages) carry over as they are.

``params_to_jax`` is the inverse: it turns a state dict into the variables
dict, so that the port writes checkpoints the reference reads. There a
``weight`` is the wavelet layer's when its module also holds a ``theta``,
else a Dense kernel (2-D, transposed) or a BatchNorm ``scale`` (1-D).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import re

import numpy as np
import torch

_VERBATIM = ("bias", "slope", "hop_weight", "hop_node_weight", "subgraph_weight",
             "w_re", "w_im", "b_re", "b_im", "theta")
# a module holding this parameter is a wavelet layer, whose ``weight`` is
# flax's ``weight`` [in, out], not a Dense kernel
_WAVELET_MARK = "theta"
# the baseline GAT's per-layer attention vectors
_ATTENTION = re.compile(r"a_(src|dst)_\d+")
_STATS = {"mean": "running_mean", "var": "running_var"}


def _walk(node: Mapping, prefix: str, out: Dict[str, torch.Tensor], stats: bool) -> None:
    for name, value in node.items():
        if isinstance(value, Mapping):
            _walk(value, f"{prefix}{name}.", out, stats)
            continue
        arr = np.asarray(value, dtype=np.float32)
        if stats and name in _STATS:
            out[f"{prefix}{_STATS[name]}"] = torch.tensor(arr)
        elif stats:
            raise KeyError(f"no port mapping for flax batch statistic {prefix}{name}")
        elif name == "kernel":
            if arr.ndim != 2:
                raise ValueError(f"{prefix}{name}: expected a 2-D Dense kernel")
            out[f"{prefix}weight"] = torch.tensor(arr.T)
        elif name == "scale":
            out[f"{prefix}weight"] = torch.tensor(arr)
        elif (name in _VERBATIM or _ATTENTION.fullmatch(name)
              or (name == "weight" and _WAVELET_MARK in node)):
            out[f"{prefix}{name}"] = torch.tensor(arr)
        else:
            raise KeyError(f"no port mapping for flax parameter {prefix}{name}")


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flax parameter tree or variables dict -> state dict (float32 tensors
    on the CPU)."""
    out: Dict[str, torch.Tensor] = {}
    if "params" in tree and set(tree) <= {"params", "batch_stats"}:
        _walk(tree["params"], "", out, stats=False)
        _walk(tree.get("batch_stats", {}), "", out, stats=True)
    else:
        _walk(tree, "", out, stats=False)
    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """State dict -> flax variables dict ``{"params": tree}``, with
    ``"batch_stats"`` when the model holds BatchNorm statistics; leaves are
    float32 numpy arrays. A ``weight`` beside a ``theta`` is the wavelet
    layer's (as it is); any other 2-D ``weight`` is a Dense kernel
    (transposed), a 1-D one a BatchNorm ``scale``."""
    variables: dict = {"params": {}}
    wavelet_layers = {key.rpartition(".")[0] for key in state_dict
                      if key.rpartition(".")[2] == _WAVELET_MARK}
    for key, value in state_dict.items():
        *path, name = key.split(".")
        arr = value.detach().cpu().to(torch.float32).numpy()
        collection = "params"
        if name in ("running_mean", "running_var"):
            collection, name = "batch_stats", name.removeprefix("running_")
        elif name == "weight" and ".".join(path) in wavelet_layers:
            pass
        elif name == "weight":
            name, arr = ("kernel", arr.T) if arr.ndim == 2 else ("scale", arr)
        elif name not in _VERBATIM and not _ATTENTION.fullmatch(name):
            raise KeyError(f"no flax mapping for state-dict entry {key}")
        node = variables.setdefault(collection, {})
        for part in path:
            node = node.setdefault(part, {})
        node[name] = np.array(arr, order="C")
    return variables
