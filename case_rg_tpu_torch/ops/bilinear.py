"""Additive (Bahdanau-style) attention (port of
``case_rg_tpu/ops/bilinear.py``): score = v . tanh(W q + U k). Query
[.., Lq, Dq], key [.., Lk, Dk], mask [.., Lq, Lk]."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .masking import masked_softmax, neg_inf


class BilinearAttention(nn.Module):
    def __init__(self, query_size: int, key_size: int, hidden_size: int, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.linear_key = nn.Linear(key_size, hidden_size, bias=False, **kw)
        self.linear_query = nn.Linear(query_size, hidden_size, bias=True, **kw)
        self.v = nn.Linear(hidden_size, 1, bias=False, **kw)

    def key_proj(self, key: torch.Tensor) -> torch.Tensor:
        """U k for a fixed memory (hoisted out of the decode loop)."""
        return self.linear_key(key)

    def matching_from_proj(self, query: torch.Tensor, uh: torch.Tensor,
                           mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
        """Raw scores [.., Lq, Lk] given ``uh = linear_key(key)``."""
        wq = self.linear_query(query)[..., :, None, :]
        attn = self.v(torch.tanh(wq + uh[..., None, :, :]))[..., 0]
        if mask is not None:
            attn = torch.where(mask, attn, torch.full(
                (), neg_inf(attn.dtype), dtype=attn.dtype, device=attn.device))
        return attn

    def attend_from_proj(self, query, uh, value, mask=None):
        """(context [.., Lq, Dv], raw scores, normalized scores) given the
        precomputed key projection."""
        raw = self.matching_from_proj(query, uh)
        norm = masked_softmax(raw, mask, dim=-1)
        return torch.matmul(norm, value), raw, norm

    def forward(self, query, key, value, mask=None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(context, raw scores with masked entries at -1e20, normalized
        scores)."""
        ctx, raw, norm = self.attend_from_proj(query, self.key_proj(key),
                                               value, mask)
        if mask is not None:
            raw = torch.where(mask, raw, torch.full(
                (), neg_inf(raw.dtype), dtype=raw.dtype, device=raw.device))
        return ctx, raw, norm
