"""Mask / numerics helpers shared across ops (port of
``case_rg_tpu/ops/masking.py``)."""

from __future__ import annotations

import torch

# A representable finite stand-in for -inf (ref: common/Utils.py:14-21).
NEG_INF = -1e20


def neg_inf(dtype) -> float:
    if dtype == torch.float16:
        return -65504.0
    return NEG_INF


def padding_mask(ids: torch.Tensor) -> torch.Tensor:
    """True where a token is real (id != 0)."""
    return ids != 0


def causal_mask(length: int, dtype=torch.float32, device=None
                ) -> torch.Tensor:
    """[L, L] additive mask: 0 on and below the diagonal, -1e20 above."""
    i = torch.arange(length, device=device)[:, None]
    j = torch.arange(length, device=device)[None, :]
    return torch.where(j <= i, 0.0, neg_inf(dtype)).to(dtype)


def softmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    """exp(x - max) / sum in x's dtype, op for op as the JAX helper."""
    unnorm = torch.exp(x - x.amax(dim=dim, keepdim=True))
    return unnorm / unnorm.sum(dim=dim, keepdim=True)


def masked_softmax(logits: torch.Tensor, mask, dim: int = -1,
                   zero_fully_masked: bool = True) -> torch.Tensor:
    """Softmax over ``dim`` with boolean ``mask`` (True = keep). Masked
    entries get zero probability, and a row whose every entry is masked
    gives zeros (torch's -inf fill would give NaN)."""
    if mask is None:
        return softmax(logits, dim)
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    masked = torch.where(mask, logits,
                         torch.full((), neg_inf(logits.dtype),
                                    dtype=logits.dtype, device=logits.device))
    out = torch.where(mask, softmax(masked, dim), zero)
    if zero_fully_masked:
        out = torch.where(mask.any(dim=dim, keepdim=True), out, zero)
    return out


def masked_mean(x: torch.Tensor, mask: torch.Tensor, sqrt: bool = False,
                eps: float = 0.0) -> torch.Tensor:
    """Mean (or sum/sqrt(n)) pool over the length axis. x: [..., L, D],
    mask: [..., L] -> [..., D]."""
    m = mask.to(x.dtype)[..., None]
    total = (x * m).sum(dim=-2)
    count = m.sum(dim=-2)
    if sqrt:
        count = torch.sqrt(count)
    return total / (count + eps)
