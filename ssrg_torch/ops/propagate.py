"""K-hop propagation (counterpart of ``ssrg_tpu/ops/propagate.py``).

The reference scans the SpMM under ``jax.lax.scan``; PyTorch runs eagerly,
so the port loops over the hops in Python, one SpMM per hop and adjacency:

- ``propagate``          — one adjacency (sgc, ssgc, sign, gbp, gamlp, nafs)
- ``propagate_complex``  — the magnetic ``(A_re + i A_im)^k X`` as four
  real SpMMs a hop, on float32 tensors (the kernel is float32; no complex
  dtype)
- ``propagate_multi``    — independent hop stacks over a tuple of
  adjacencies (two_dir's un/in/out triple, two_order's pair)

Every adjacency must already be on ``device``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ssrg_torch.ops.sparse import Adjacency
from ssrg_torch.utils import DeviceLike, resolve_device


def _features(feature, device: DeviceLike) -> torch.Tensor:
    return torch.as_tensor(feature, dtype=torch.float32, device=resolve_device(device))


@torch.no_grad()
def propagate(adj: Adjacency, feature, prop_steps: int,
              device: DeviceLike = "cuda") -> torch.Tensor:
    """Return the stacked hops ``[prop_steps+1, N, F]``:
    ``[X, PX, P^2 X, ..., P^K X]``."""
    x = _features(feature, device)
    hops = torch.empty((prop_steps + 1, *x.shape), dtype=torch.float32,
                       device=x.device)
    hops[0] = x
    for k in range(prop_steps):
        hops[k + 1] = adj.spmm(hops[k])
    return hops


@torch.no_grad()
def propagate_complex(real_adj: Adjacency, imag_adj: Adjacency, feature, prop_steps: int,
                      device: DeviceLike = "cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """Magnetic propagation, hop k = ``(A_re + i A_im)^k X`` for a real X.

    Returns ``(real_hops, imag_hops)``, each ``[prop_steps+1, N, F]``; hop 0
    of the imaginary stack is zeros. A hop is the complex product
    ``re' = A_re re - A_im im``, ``im' = A_re im + A_im re``: four SpMMs."""
    x = _features(feature, device)
    re_hops = torch.empty((prop_steps + 1, *x.shape), dtype=torch.float32, device=x.device)
    im_hops = torch.empty_like(re_hops)
    re_hops[0] = x
    im_hops[0] = 0.0
    for k in range(prop_steps):
        re, im = re_hops[k], im_hops[k]
        torch.sub(real_adj.spmm(re), imag_adj.spmm(im), out=re_hops[k + 1])
        torch.add(real_adj.spmm(im), imag_adj.spmm(re), out=im_hops[k + 1])
    return re_hops, im_hops


@torch.no_grad()
def propagate_multi(adjs: Sequence[Adjacency], feature, prop_steps: int,
                    device: DeviceLike = "cuda") -> Tuple[torch.Tensor, ...]:
    """Independent hop stacks ``[prop_steps+1, N, F]``, one for each
    adjacency of ``adjs``, all from the same X."""
    x = _features(feature, device)
    return tuple(propagate(a, x, prop_steps, device=x.device) for a in adjs)
