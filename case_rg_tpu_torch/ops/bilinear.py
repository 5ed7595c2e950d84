"""Additive (Bahdanau-style) attention (port of
``case_rg_tpu/ops/bilinear.py``): score = v . tanh(W q + U k). Query
[.., Lq, Dq], key [.., Lk, Dk], mask [.., Lq, Lk].

The scores go through ``kernels/additive_attention.additive_scores`` (the
CUDA kernels on the card, forward and backward, without the [.., Lq, Lk,
H] tensor) when ``set_additive_kernel`` routes them there: None = auto
(bf16 on the card), True = always, False = never (the dense tanh + linear
path)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..kernels.additive_attention import additive_scores
from .masking import masked_softmax, neg_inf

_ADDITIVE_KERNEL = None


def set_additive_kernel(on) -> None:
    """True=force, False=off, None=auto (bf16 on the card)."""
    global _ADDITIVE_KERNEL
    _ADDITIVE_KERNEL = on


def _additive_kernel_ok(wq: torch.Tensor, uh: torch.Tensor) -> bool:
    if _ADDITIVE_KERNEL is False or wq.shape[:-2] != uh.shape[:-2]:
        return False
    if _ADDITIVE_KERNEL:
        return True
    return wq.dtype == torch.bfloat16 and wq.device.type == "cuda"


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
        wq = self.linear_query(query)
        if _additive_kernel_ok(wq, uh):
            lead, (lq, h), lk = wq.shape[:-2], wq.shape[-2:], uh.shape[-2]
            attn = additive_scores(wq.reshape(-1, lq, h).contiguous(),
                                   uh.reshape(-1, lk, h).contiguous(),
                                   self.v.weight[0]).reshape(*lead, lq, lk)
        else:
            attn = self.v(torch.tanh(wq[..., :, None, :]
                                     + uh[..., None, :, :]))[..., 0]
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
