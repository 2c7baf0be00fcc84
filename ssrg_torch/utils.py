"""Small helpers shared by the port: device resolution, the parameter
initializers of the reference's flax modules, drawn from an explicit
``torch.Generator``, and the reference's run utilities (``seed_everything``,
``get_params``, ``generate_numbers``, ``compute_distance``)."""

from __future__ import annotations

import math
import random
from typing import Iterable, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

DeviceLike = Union[str, torch.device]

# std of a unit normal truncated to [-2, 2] (jax.nn.initializers' constant)
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def variance_scaling_(
    t: torch.Tensor, scale: float, mode: str, distribution: str,
    fan_in: int, fan_out: int, generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """In-place ``jax.nn.initializers.variance_scaling``: variance
    ``scale / fan`` with fan ``fan_in`` or the mean of ``fan_in`` and
    ``fan_out``, drawn ``uniform`` or ``truncated_normal`` (at two
    standard deviations)."""
    fan = {"fan_in": fan_in, "fan_avg": (fan_in + fan_out) / 2}[mode]
    var = scale / max(1.0, fan)
    if distribution == "uniform":
        lim = math.sqrt(3.0 * var)
        return t.uniform_(-lim, lim, generator=generator)
    if distribution == "truncated_normal":
        std = math.sqrt(var) / _TRUNC_STD
        edge = math.erf(2.0 / math.sqrt(2.0))  # 2 * Phi(2) - 1
        t.uniform_(-edge, edge, generator=generator).erfinv_()
        return t.mul_(std * math.sqrt(2.0))
    raise ValueError(f"unknown distribution {distribution!r}")


def init_dense_(layer: nn.Linear, scale: float = 1.0, mode: str = "fan_in",
                distribution: str = "truncated_normal",
                generator: Optional[torch.Generator] = None) -> None:
    """Initialize a Linear as a flax ``Dense``: variance-scaled kernel
    (default lecun_normal, flax's own default) and zero bias (if any)."""
    variance_scaling_(layer.weight, scale, mode, distribution,
                      fan_in=layer.in_features, fan_out=layer.out_features,
                      generator=generator)
    if layer.bias is not None:
        with torch.no_grad():
            layer.bias.zero_()


def init_dense_xavier_relu_(layer: nn.Linear,
                            generator: Optional[torch.Generator] = None) -> None:
    """Xavier-uniform with the relu gain, the heads' kernel init (the
    reference's ``reset_parameters``)."""
    init_dense_(layer, 2.0, "fan_avg", "uniform", generator)


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """The device an entry point runs on. ``cuda`` is the default of every
    entry point; asking for it without a usable card raises instead of
    running on the host."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def seed_everything(seed: int, device: DeviceLike = "cpu") -> torch.Generator:
    """Seed python and numpy and return a ``torch.Generator`` on ``device``
    seeded with ``seed`` (the reference returns a JAX key in its place)."""
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator(device=device).manual_seed(seed)


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device`` (nothing to wait for on the
    CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def get_params(params: Union[nn.Module, Iterable[torch.Tensor]]) -> int:
    """The number of parameters of a module, or of an iterable of tensors
    (a state dict's ``values()``, say)."""
    tensors = params.parameters() if isinstance(params, nn.Module) else params
    return sum(int(t.numel()) for t in tensors)


def generate_numbers(n: int, exclude: int, pool: Sequence[int],
                     rng: Optional[np.random.Generator] = None) -> List[int]:
    """``n`` draws, with replacement, from ``pool`` less the value
    ``exclude``."""
    rng = rng or np.random.default_rng()
    pool_arr = np.asarray(pool)
    pool_arr = pool_arr[pool_arr != exclude]
    return rng.choice(pool_arr, size=n, replace=True).tolist()


def compute_distance(candidates: np.ndarray, target: np.ndarray) -> np.ndarray:
    """The L2 distance of each row of ``candidates`` to ``target``."""
    return np.linalg.norm(np.asarray(candidates) - np.asarray(target)[None, :], axis=1)
