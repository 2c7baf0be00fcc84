"""K-hop propagation (counterpart of ``ssrg_tpu/ops/propagate.py``).

The reference scans the SpMM under ``jax.lax.scan``; PyTorch runs eagerly,
so the port loops over the hops in Python, one SpMM per hop. The magnetic
and multi-adjacency variants come with the spectral/complex slice
(ROADMAP.md).
"""

from __future__ import annotations

import torch

from ssrg_torch.ops.sparse import Adjacency
from ssrg_torch.utils import DeviceLike, resolve_device


@torch.no_grad()
def propagate(adj: Adjacency, feature, prop_steps: int,
              device: DeviceLike = "cuda") -> torch.Tensor:
    """Return the stacked hops ``[prop_steps+1, N, F]``:
    ``[X, PX, P^2 X, ..., P^K X]``. ``adj`` must already be on ``device``."""
    x = torch.as_tensor(feature, dtype=torch.float32, device=resolve_device(device))
    hops = torch.empty((prop_steps + 1, *x.shape), dtype=torch.float32,
                       device=x.device)
    hops[0] = x
    for k in range(prop_steps):
        hops[k + 1] = adj.spmm(hops[k])
    return hops
