"""4-D transformer block for the ranking towers (port of
``case_rg_tpu/ops/blocks.py``): the residual is only around the attention,
the ReLU FFN may change the width and *replaces* the stream, and padded
positions are zeroed on the way out. Dropout (with a generator ``gen``) on
the attention output and the FFN hidden layer."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .attention import MultiHeadAttention
from .dropout import dropout

_LN_EPS = 1e-5


class TransformerBlock(nn.Module):
    def __init__(self, num_heads: int, input_size: int, output_size: int,
                 dropout: float = 0.0, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.output_size = output_size
        self.dropout = dropout
        self.norm1 = nn.LayerNorm(input_size, eps=_LN_EPS, **kw)
        self.self_attn = MultiHeadAttention(input_size, num_heads, dropout,
                                            **kw)
        self.norm2 = nn.LayerNorm(input_size, eps=_LN_EPS, **kw)
        self.linear1 = nn.Linear(input_size, output_size, **kw)
        self.linear2 = nn.Linear(output_size, output_size, **kw)

    def forward(self, x: torch.Tensor, keep: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: [B, n, L, Din]; keep: [B, n, L] bool -> [B, n, L, Dout]."""
        b, n, l, d = x.shape
        h = x.reshape(b * n, l, d)
        normed = self.norm1(h)
        a, _ = self.self_attn(normed, normed, normed,
                              key_keep=keep.reshape(b * n, l), gen=gen)
        h = self.norm2(h + dropout(a, self.dropout, gen))
        h = F.relu(self.linear1(h))
        h = self.linear2(dropout(h, self.dropout, gen))
        h = h.reshape(b, n, l, self.output_size)
        return torch.where(keep[..., None], h,
                           torch.zeros((), dtype=h.dtype, device=h.device))
