"""Highway network (port of ``case_rg_tpu/ops/highway.py``):
x <- sigmoid(G x) * f(N x) + (1 - sigmoid(G x)) * (L x), repeated
``num_layers`` times; f is tanh (or ReLU)."""

from __future__ import annotations

import torch
from torch import nn


class Highway(nn.Module):
    def __init__(self, input_size: int, output_size: int,
                 num_layers: int = 1, activation: str = "tanh", *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_layers = num_layers
        self.activation = activation
        for i in range(num_layers):
            in_size = input_size if i == 0 else output_size
            for name in ("gate", "nonlinear", "linear"):
                self.add_module(f"{name}{i}",
                                nn.Linear(in_size, output_size, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = torch.tanh if self.activation == "tanh" else torch.relu
        for i in range(self.num_layers):
            gate = torch.sigmoid(getattr(self, f"gate{i}")(x))
            nonlin = f(getattr(self, f"nonlinear{i}")(x))
            lin = getattr(self, f"linear{i}")(x)
            x = gate * nonlin + (1.0 - gate) * lin
        return x
