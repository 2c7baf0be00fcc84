"""Process meshes on ``torch.distributed`` (counterpart of
``ssrg_tpu/parallel/mesh.py``).

One rank drives one device: ``cuda:{local rank}`` on the NCCL backend, or
the host on gloo (``device="cpu"``, the tests). A :class:`Mesh` lays the
world's ranks out on named axes in row-major order, as the reference
reshapes its device list: a ``graph`` axis over which adjacency rows and
node features are partitioned, and an optional ``data`` axis for the head's
data parallelism. Each axis has a process group per line of the grid (the
ranks that differ only on that axis), made with
``torch.distributed.new_group`` by every rank in the same order.

In a process with no process group, :func:`make_mesh` starts a world of one
rank on the requested device, joined through a ``file://`` store in a
temporary directory: the reference's one-device mesh. NCCL puts no two ranks
of one communicator on the same card, so a larger world takes one process
per card (``torchrun``, or :func:`ssrg_torch.parallel.multihost.initialize_multihost`).
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ssrg_torch.utils import DeviceLike, resolve_device

# how long a collective, or joining a world, may wait for a peer
TIMEOUT = timedelta(seconds=300)


@dataclass
class Mesh:
    """This rank's view of a named grid of ranks."""

    shape: Dict[str, int]                 # axis name -> size, in axis order
    axis_names: Tuple[str, ...]
    coords: Dict[str, int]                # this rank's coordinate on each axis
    groups: Dict[str, Any]                # axis -> this rank's group along it
    ranks: Dict[str, Tuple[int, ...]]     # axis -> that group's global ranks, by coordinate
    device: torch.device
    rank: int
    world_size: int


def backend_for(device: torch.device) -> str:
    """The backend a rank on ``device`` talks through: NCCL for a card, gloo
    for the host. Asking for a card without NCCL raises."""
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("device 'cuda' needs the NCCL backend, which this torch lacks")
        return "nccl"
    return "gloo"


def local_cuda_device() -> torch.device:
    """The card of this process: ``LOCAL_RANK`` when a launcher set it, else
    the current device."""
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return torch.device("cuda", torch.cuda.current_device())


def _world_device(device: Optional[DeviceLike]) -> torch.device:
    """The device of this rank in the running world, whose backend must
    match it."""
    backend = dist.get_backend()
    if device is None:
        dev = resolve_device("cuda" if backend == "nccl" else "cpu")
    else:
        dev = resolve_device(device)
    if backend_for(dev) != backend:
        raise ValueError(f"the running world's backend is {backend!r}, which does not "
                         f"serve device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = local_cuda_device()
    return dev


def _start_world_of_one(device: Optional[DeviceLike]) -> torch.device:
    dev = resolve_device("cuda" if device is None else device)
    backend = backend_for(dev)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0 if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    store_dir = tempfile.mkdtemp(prefix="ssrg_torch_world_")
    atexit.register(shutil.rmtree, store_dir, ignore_errors=True)
    dist.init_process_group(backend, init_method=f"file://{store_dir}/store", rank=0,
                            world_size=1, timeout=TIMEOUT)
    return dev


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("graph",),
    device: Optional[DeviceLike] = None,
) -> Mesh:
    """A mesh over every rank of the world, ``shape=None`` putting them all
    on one ``graph`` axis. ``device`` defaults to the card (or, in a running
    gloo world, the host); without a process group, a world of one rank is
    started on it. Collective: every rank of the world calls it with the
    same shape and names."""
    dev = _world_device(device) if dist.is_initialized() else _start_world_of_one(device)
    world, rank = dist.get_world_size(), dist.get_rank()
    shape = (world,) if shape is None else tuple(int(s) for s in shape)
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} does not cover {world} devices")
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError("shape and axis_names rank mismatch")
    grid = np.arange(world).reshape(shape)
    groups, ranks = {}, {}
    for a, name in enumerate(axis_names):
        for line in np.moveaxis(grid, a, -1).reshape(-1, shape[a]):
            members = tuple(int(r) for r in line)
            group = dist.group.WORLD if len(members) == world else dist.new_group(list(members))
            if rank in members:
                groups[name], ranks[name] = group, members
    coords = dict(zip(axis_names, (int(c) for c in np.unravel_index(rank, shape))))
    return Mesh(shape=dict(zip(axis_names, shape)), axis_names=axis_names, coords=coords,
                groups=groups, ranks=ranks, device=dev, rank=rank, world_size=world)


def node_slice(mesh: Mesh, axes: Sequence[str], n_pad: int) -> Tuple[int, int]:
    """The rows ``[lo, hi)`` of an ``n_pad``-row node axis that this rank
    holds when the axis is split over ``axes``, in their order (the
    reference's ``PartitionSpec(axes)``)."""
    sizes = [mesh.shape[a] for a in axes]
    parts = int(np.prod(sizes))
    if n_pad % parts:
        raise ValueError(f"{n_pad} rows do not split evenly over axes {tuple(axes)} "
                         f"of sizes {tuple(sizes)}")
    idx = int(np.ravel_multi_index([mesh.coords[a] for a in axes], sizes))
    part = n_pad // parts
    return idx * part, (idx + 1) * part
