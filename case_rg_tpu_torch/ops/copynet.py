"""Copy-distribution scatter (port of ``case_rg_tpu/ops/copynet.py``)."""

from __future__ import annotations

import torch


def copy_scatter(weights: torch.Tensor, src_ids: torch.Tensor,
                 vocab_size: int) -> torch.Tensor:
    """Scatter attention mass onto the vocabulary.

    weights: [B, T, L] (or [B, L]); src_ids: [B, L] int vocab ids.
    Returns [B, T, V] (or [B, V]) with out[b, t, v] = sum_{l: ids[b,l]=v} w.
    bf16/f16 weights accumulate in f32 and are cast back once.
    """
    squeeze = weights.ndim == 2
    if squeeze:
        weights = weights[:, None, :]
    b, t, l = weights.shape
    acc = torch.float32 if weights.dtype in (torch.bfloat16, torch.float16) \
        else weights.dtype
    out = torch.zeros((b, t, vocab_size), dtype=acc, device=weights.device)
    idx = src_ids[:, None, :].expand(b, t, l).long()
    out.scatter_add_(2, idx, weights.to(acc))
    out = out.to(weights.dtype)
    if squeeze:
        out = out[:, 0]
    return out
