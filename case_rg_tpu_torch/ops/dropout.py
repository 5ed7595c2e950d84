"""Dropout (port of ``case_rg_tpu/ops/dropout.py``, its default mode).

The flax formula ``select(keep, x / keep_prob, 0)``, with the keep mask
drawn from an explicit ``torch.Generator`` that the caller threads through
every site, in the role of flax's ``make_rng("dropout")``. Torch's global RNG
is never used. ``gen=None`` means deterministic (evaluation): every site is
the identity. The JAX package's seeded-recompute mode (a memory option, off
by default) is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch


def keep_mask(shape, rate: float, gen: torch.Generator,
              device) -> torch.Tensor:
    """Bernoulli(1 - rate) bool mask of ``shape`` drawn from ``gen``. The
    dense attention's probs dropout and the fused training attention's
    caller-drawn mask both use this draw, so they see the same bits."""
    return torch.rand(shape, generator=gen, device=device) < (1.0 - rate)


def dropout(x: torch.Tensor, rate: float,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """``x`` with each element kept with probability 1 - rate and scaled by
    1 / (1 - rate); the identity when ``gen`` is None or ``rate`` is 0."""
    if gen is None or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = keep_mask(x.shape, rate, gen, x.device)
    return torch.where(keep, x / (1.0 - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device))
