"""Token embedding gated on ``ids != 0`` (port of
``case_rg_tpu/ops/embedding.py``).

The lookup output is zeroed at PAD positions rather than relying on a zero
row 0: a table bridged from the JAX package has a random row 0, so
``padding_idx=0`` alone would give the wrong output."""

from __future__ import annotations

import torch
from torch import nn


class Embedding(nn.Module):
    def __init__(self, vocab_size: int, features: int, *, device=None,
                 dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(vocab_size, features,
                                               device=device, dtype=dtype))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        out = self.weight[ids]
        return torch.where((ids != 0)[..., None], out,
                           torch.zeros((), dtype=out.dtype, device=out.device))
