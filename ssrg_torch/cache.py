"""Disk cache of the propagated hop stack and parameter checkpoints
(counterpart of ``ssrg_tpu/cache.py``).

The file name ``hops_<key>.npz`` and the fingerprint that makes ``<key>``
are the reference's, so the two packages read each other's caches.
Checkpoints are the reference's too: a flax-msgpack file of a parameter tree
(nested string-keyed maps of arrays, flax names, ``[in, out]`` Dense
kernels) beside a ``.json`` sidecar of metadata, written and read with the
port's own codec (:mod:`ssrg_torch._msgpack`). A state dict goes to and from
that tree through :mod:`ssrg_torch.convert`.
"""

from __future__ import annotations

import hashlib
import json
import os
import os.path as osp
from collections.abc import Mapping
from typing import Any, Optional

import numpy as np
import scipy.sparse as sp
import torch

from ssrg_torch import _msgpack
from ssrg_torch.logger import span
from ssrg_torch.utils import DeviceLike, resolve_device


def _graph_fingerprint(adj: sp.spmatrix, x: np.ndarray, extra: str) -> str:
    csr = adj.tocsr()
    h = hashlib.sha256()
    h.update(str(csr.shape).encode())
    h.update(csr.indptr[:: max(1, len(csr.indptr) // 1024)].tobytes())
    h.update(csr.indices[:: max(1, len(csr.indices) // 4096)].tobytes())
    h.update(np.asarray(csr.data[:4096], np.float32).tobytes())
    xs = np.asarray(x, np.float32)
    h.update(xs[:: max(1, xs.shape[0] // 256)].tobytes())
    h.update(extra.encode())
    return h.hexdigest()[:24]


def cached_propagate(
    adj_norm: sp.spmatrix,
    x: np.ndarray,
    prop_steps: int,
    cache_dir: Optional[str],
    engine: str = "auto",
    tag: str = "",
    device: DeviceLike = "cuda",
    engine_kwargs: Optional[dict] = None,
) -> torch.Tensor:
    """K-hop propagation with a disk cache of the result; returns the hop
    stack ``[K+1, N, F]`` on ``device``. ``engine_kwargs`` go to the
    engine's pack function; whatever of them changes the numbers (bf16
    storage, say) the caller folds into ``tag``, as the reference does."""
    from ssrg_torch.ops.propagate import propagate
    from ssrg_torch.ops.sparse import device_adjacency

    dev = resolve_device(device)
    path = None
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
        key = _graph_fingerprint(adj_norm, x, f"{prop_steps}|{tag}")
        path = osp.join(cache_dir, f"hops_{key}.npz")
        if osp.exists(path):
            with np.load(path) as z:
                return torch.as_tensor(z["hops"], device=dev)
    adj_dev = device_adjacency(adj_norm, engine, device=dev, **(engine_kwargs or {}))
    with span("prepare.hops"):
        hops = propagate(adj_dev, x, prop_steps, device=dev)
    if path is not None:
        np.savez(path, hops=hops.cpu().numpy())
    return hops


def _numpy_tree(tree: Mapping) -> dict:
    return {str(k): _numpy_tree(v) if isinstance(v, Mapping)
            else np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)
            for k, v in tree.items()}


def save_params(params: Mapping, path: str, metadata: Optional[dict] = None) -> None:
    """Write a parameter tree (nested mappings of arrays or tensors, e.g.
    :func:`ssrg_torch.convert.params_to_jax` of a state dict) as flax
    msgpack, and ``metadata`` as ``<path>.json``: the reference's
    ``save_params`` format, which ``ssrg_tpu.cache.load_params`` reads."""
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(_msgpack.packb(_numpy_tree(params)))
    if metadata is not None:
        with open(path + ".json", "w") as f:
            json.dump(metadata, f)


def load_params(path: str) -> Any:
    """Read a checkpoint of either package: the parameter tree as nested
    dicts of numpy arrays (:func:`ssrg_torch.convert.params_from_jax` turns
    it into a state dict)."""
    with open(path, "rb") as f:
        return _msgpack.unpackb(f.read())


def load_metadata(path: str) -> Optional[dict]:
    """The ``.json`` sidecar of a checkpoint, or None when there is none."""
    if osp.exists(path + ".json"):
        with open(path + ".json") as f:
            return json.load(f)
    return None
