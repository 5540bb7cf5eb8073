"""SimSiam heads (port of declip_tpu/models/heads.py:27-65).

prototype/model/declip.py:33-130: ``projection_MLP`` with BatchNorm after
every fc and no ReLU after the last, and the ``prediction_MLP`` bottleneck
with BatchNorm on its hidden layer only. The BatchNorm is
``layers.BatchNorm``, the ResNet tower's (flax semantics, statistics over the [B, D] batch axis, pending until the
train step commits them). ``train`` chooses batch or running statistics for
one call; None follows the module's training mode.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from declip_tpu_torch.models.layers import (
    BatchNorm,
    dense,
    lecun_normal_,
    linear,
)


class _Head(nn.Module):
    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype

    def init_weights(self, generator: torch.Generator) -> None:
        """flax's inits: lecun-normal kernels, zero biases, BN scale 1."""
        for m in self.children():
            if isinstance(m, nn.Linear):
                lecun_normal_(m.weight, generator)
                nn.init.zeros_(m.bias)
            else:
                m.init_weights()

    def _dense(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return dense(x, layer.weight, layer.bias, self.dtype)

    def _bn(self, bn: BatchNorm, x: torch.Tensor,
            train: Optional[bool]) -> torch.Tensor:
        return bn(x, use_running_average=None if train is None else not train)


class ProjectionMLP(_Head):
    """3-layer SimSiam projector (``linear1``/``bn1``, ``linear2``/``bn2``,
    ``linear3``/``bn3``); 2 layers with ``num_layers=2``."""

    def __init__(self, in_dim: int, hidden_dim: int = 1024,
                 out_dim: int = 1024, num_layers: int = 3,
                 out_bn: bool = True, dtype=torch.float32, device=None):
        super().__init__(dtype)
        self.num_layers = num_layers
        self.linear1 = linear(in_dim, hidden_dim, device)
        self.bn1 = BatchNorm(hidden_dim, device=device)
        self.linear2 = linear(hidden_dim, hidden_dim, device)
        self.bn2 = BatchNorm(hidden_dim, device=device)
        if num_layers == 3:
            self.linear3 = linear(hidden_dim, out_dim, device)
            if out_bn:
                self.bn3 = BatchNorm(out_dim, device=device)
        self.out_bn = out_bn

    def forward(self, x: torch.Tensor,
                train: Optional[bool] = None) -> torch.Tensor:
        x = F.relu(self._bn(self.bn1, self._dense(self.linear1, x), train))
        x = self._bn(self.bn2, self._dense(self.linear2, x), train)
        if self.num_layers == 3:
            x = self._dense(self.linear3, F.relu(x))
            if self.out_bn:
                x = self._bn(self.bn3, x, train)
        return x


class PredictionMLP(_Head):
    """2-layer SimSiam predictor bottleneck: ``linear1``/``bn1``, ReLU,
    ``layer2``."""

    def __init__(self, in_dim: int, hidden_dim: int = 512,
                 out_dim: int = 1024, dtype=torch.float32, device=None):
        super().__init__(dtype)
        self.linear1 = linear(in_dim, hidden_dim, device)
        self.bn1 = BatchNorm(hidden_dim, device=device)
        self.layer2 = linear(hidden_dim, out_dim, device)

    def forward(self, x: torch.Tensor,
                train: Optional[bool] = None) -> torch.Tensor:
        x = F.relu(self._bn(self.bn1, self._dense(self.linear1, x), train))
        return self._dense(self.layer2, x)
