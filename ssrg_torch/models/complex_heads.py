"""Complex-valued heads for the magnetic-Laplacian models (counterpart of
``ssrg_tpu/models/complex_heads.py``).

A complex tensor is a ``(re, im)`` pair of float32 tensors, as
:func:`ssrg_torch.ops.propagate.propagate_complex` returns it:

- :func:`complex_relu` — MagNet's complex ReLU: both parts pass where the
  real part is nonnegative, zero elsewhere.
- :class:`ComplexLinear` — ``(re + i im) (W_re + i W_im) + (b_re + i b_im)``
  as four real matrix products. Its parameters keep the flax names and
  layout (``w_re``, ``w_im`` ``[in, out]``, xavier-uniform from the
  generator; ``b_re``, ``b_im`` zeros), so :mod:`ssrg_torch.convert`
  carries them over as they are.
- :class:`ComLogisticRegression` (``fc``) and :class:`ComMLP` (``fc_0`` …,
  ``fc_out``, complex ReLU and dropout between) end in the magnitude
  readout ``sqrt(re^2 + im^2 + 1e-12)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ssrg_torch.models.heads import Dropout
from ssrg_torch.utils import variance_scaling_


def complex_relu(re: torch.Tensor, im: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask both parts by ``re >= 0``."""
    mask = (re >= 0).to(re.dtype)
    return re * mask, im * mask


def magnitude(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """The readout ``|z| = sqrt(re^2 + im^2 + 1e-12)``."""
    return torch.sqrt(re * re + im * im + 1e-12)


class ComplexLinear(nn.Module):
    """``(re + i im) @ (w_re + i w_im) + (b_re + i b_im)``."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.in_features, self.features = in_features, features
        self.w_re = nn.Parameter(torch.empty(in_features, features))
        self.w_im = nn.Parameter(torch.empty(in_features, features))
        self.b_re = nn.Parameter(torch.zeros(features))
        self.b_im = nn.Parameter(torch.zeros(features))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for w in (self.w_re, self.w_im):
            variance_scaling_(w, 1.0, "fan_avg", "uniform", fan_in=self.in_features,
                              fan_out=self.features, generator=generator)
        with torch.no_grad():
            self.b_re.zero_()
            self.b_im.zero_()

    def forward(self, re: torch.Tensor, im: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        out_re = re @ self.w_re - im @ self.w_im + self.b_re
        out_im = re @ self.w_im + im @ self.w_re + self.b_im
        return out_re, out_im


class ComLogisticRegression(nn.Module):
    """One complex linear layer with the magnitude readout."""

    def __init__(self, feat_dim: int, output_dim: int):
        super().__init__()
        self.fc = ComplexLinear(feat_dim, output_dim)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self.fc.reset_parameters(generator)

    def forward(self, re_im):
        return magnitude(*self.fc(*re_im))


class ComMLP(nn.Module):
    """(num_layers-1) x [ComplexLinear -> complex ReLU -> Dropout] ->
    ComplexLinear -> magnitude. Dropout draws one mask for the real part and
    another for the imaginary part, as the reference's two calls do."""

    def __init__(self, feat_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 2, dropout: float = 0.5):
        super().__init__()
        self.num_layers = num_layers
        dims = [feat_dim] + [hidden_dim] * (num_layers - 1)
        for i in range(num_layers - 1):
            self.add_module(f"fc_{i}", ComplexLinear(dims[i], hidden_dim))
        self.fc_out = ComplexLinear(dims[-1], output_dim)
        self.dropout = Dropout(dropout)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for i in range(self.num_layers - 1):
            getattr(self, f"fc_{i}").reset_parameters(generator)
        self.fc_out.reset_parameters(generator)

    def forward(self, re_im):
        re, im = re_im
        for i in range(self.num_layers - 1):
            re, im = complex_relu(*getattr(self, f"fc_{i}")(re, im))
            re, im = self.dropout(re), self.dropout(im)
        return magnitude(*self.fc_out(re, im))
