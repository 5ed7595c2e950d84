"""Sinusoidal positional embedding (port of
``case_rg_tpu/ops/positional.py``): ``x * sqrt(d) + PE`` in x's dtype,
then dropout when a generator is given (training)."""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch import nn

from .dropout import dropout


def sinusoid_table(max_len: int, dim: int, dtype=np.float32) -> np.ndarray:
    """[max_len, dim] table; pe[:, 0::2]=sin, pe[:, 1::2]=cos, computed in
    float64 then cast (ref: common/PositionalEmbedding.py:27-31)."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, dim, 2, dtype=np.float64)
                      * (-np.log(10000.0) / dim))
    pe = np.zeros((max_len, dim), dtype=np.float64)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term[: pe[:, 1::2].shape[1]])
    return pe.astype(dtype)


@functools.lru_cache(maxsize=None)
def _scale(dim: int, dtype) -> float:
    """sqrt(dim) rounded to ``dtype``, once per (dim, dtype). A Python
    float: a 0-dim tensor built on the card per call would be a blocking
    host-to-device copy, a synchronisation of the stream every step."""
    return float(torch.tensor(np.sqrt(dim), dtype=dtype))


class PositionalEmbedding(nn.Module):
    """Works on [..., L, D]. ``offset`` is the absolute position of the
    first token: an int, or a [B] tensor of per-row positions."""

    def __init__(self, dim: int, dropout: float = 0.0, max_len: int = 1000,
                 *, device=None):
        super().__init__()
        self.dim = dim
        self.dropout = dropout
        self.register_buffer(
            "table", torch.from_numpy(sinusoid_table(max_len, dim)).to(device),
            persistent=False)

    def forward(self, x: torch.Tensor, *, offset=0,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        table = self.table.to(x.dtype)
        length = x.shape[-2]
        if isinstance(offset, torch.Tensor) and offset.ndim == 1:
            # per-row positions (continuous batching); rows that are done
            # sit past the end and are clamped into the table (their
            # outputs are discarded), since an index out of range raises
            pos = offset[:, None] + torch.arange(length, device=x.device)
            pe = table[pos.clamp(max=table.shape[0] - 1)]     # [B, L, D]
        else:
            pe = table[int(offset):int(offset) + length]
        return dropout(x * _scale(self.dim, x.dtype) + pe, self.dropout, gen)
