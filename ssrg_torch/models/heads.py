"""NN heads (counterpart of ``ssrg_tpu/models/heads.py``).

The node-classification heads of the serving path: ``PReLU``,
``LogisticRegression`` and ``MultiLayerPerceptron``. Submodule and
parameter names are the flax names (``fc``, ``fc_<i>``, ``prelu_<i>``,
``fc_out``, ``slope``). BatchNorm, the bfloat16 compute type and the other
heads come with the training slice, the ``query_edges`` link scorer with
the link slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ssrg_torch.utils import init_dense_xavier_relu_

TRAINING_SLICE = "ROADMAP.md queue, training slice"


class PReLU(nn.Module):
    """Parametric ReLU with one learnable slope."""

    def __init__(self, init_slope: float = 0.25):
        super().__init__()
        self.init_slope = init_slope
        self.slope = nn.Parameter(torch.tensor(init_slope, dtype=torch.float32))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.slope.fill_(self.init_slope)

    def forward(self, x):
        return torch.where(x >= 0, x, self.slope * x)


class LogisticRegression(nn.Module):
    """Linear head."""

    def __init__(self, feat_dim: int, output_dim: int):
        super().__init__()
        self.fc = nn.Linear(feat_dim, output_dim)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        init_dense_xavier_relu_(self.fc, generator)

    def forward(self, feature):
        return self.fc(feature)


class MultiLayerPerceptron(nn.Module):
    """(num_layers-1) x [Linear -> PReLU -> Dropout] -> Linear, in float32."""

    def __init__(self, feat_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int = 2, dropout: float = 0.5, bn: bool = False,
                 dtype: str = "float32"):
        super().__init__()
        if num_layers < 2:
            raise ValueError("MLP must have at least two layers!")
        if bn:
            raise NotImplementedError(f"BatchNorm heads: {TRAINING_SLICE}")
        if dtype != "float32":
            raise NotImplementedError(f"head compute dtype {dtype!r}: {TRAINING_SLICE}")
        self.output_dim, self.num_layers = output_dim, num_layers
        dims = [feat_dim] + [hidden_dim] * (num_layers - 1)
        for i in range(num_layers - 1):
            self.add_module(f"fc_{i}", nn.Linear(dims[i], hidden_dim))
            self.add_module(f"prelu_{i}", PReLU())
        self.fc_out = nn.Linear(hidden_dim, output_dim)
        self.dropout = nn.Dropout(dropout)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for i in range(self.num_layers - 1):
            init_dense_xavier_relu_(getattr(self, f"fc_{i}"), generator)
            getattr(self, f"prelu_{i}").reset_parameters()
        init_dense_xavier_relu_(self.fc_out, generator)

    def forward(self, feature):
        x = feature
        for i in range(self.num_layers - 1):
            x = getattr(self, f"fc_{i}")(x)
            x = getattr(self, f"prelu_{i}")(x)
            x = self.dropout(x)
        return self.fc_out(x)
