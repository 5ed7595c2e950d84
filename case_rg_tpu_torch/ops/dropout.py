"""Dropout (port of ``case_rg_tpu/ops/dropout.py``).

The flax formula ``select(keep, x / keep_prob, 0)``, with the keep mask
drawn from an explicit ``torch.Generator`` that the caller threads through
every site, in the role of flax's ``make_rng("dropout")``. Torch's global RNG
is never used. ``gen=None`` means deterministic (evaluation): every site is
the identity.

Seeded-recompute mode (``set_seeded_dropout(True)``, ``cli/run
--seeded_dropout``; off by default) keeps the generator's state before the
draw instead of the mask: the backward regenerates the same mask from a
fresh generator set to that state and returns ``where(keep, g / keep_prob,
0)``. Autograd of the default path gives ``where(keep, g, 0) / keep_prob``,
and 0 / keep_prob == 0, so losses and gradients are the same bit for bit;
only the mask (a byte an element) no longer waits in memory for the
backward. It covers every site that goes through ``dropout``: the module
sites (embedding and positional, residual, feed-forward, the towers and the
decoders) and the dense attention's probability dropout
(``ops/attention.attend``). The caller-drawn mask of the fused training
attention (``fused_train_mha``, ``--no-kernel_rng_dropout``) is drawn
outside ``dropout``, as the JAX package draws it outside ``dropout_apply``,
and is not seeded; the in-kernel variant (``fused_train_mha_rng``, the bf16
default) stores no mask to begin with. So in bf16 training with the default
attention the mode reaches the residual, feed-forward, embedding and
decoder sites and the decoder's causal self-attention probabilities (it
has a bias, so it takes the dense ``attend``).
"""

from __future__ import annotations

from typing import Optional

import torch

_SEEDED = False


def set_seeded_dropout(on: bool) -> None:
    """Process-wide switch (``cli/run`` sets it both ways on every
    ``main()``)."""
    global _SEEDED
    _SEEDED = bool(on)


def seeded_dropout_enabled() -> bool:
    return _SEEDED


def keep_mask(shape, rate: float, gen: torch.Generator,
              device) -> torch.Tensor:
    """Bernoulli(1 - rate) bool mask of ``shape`` drawn from ``gen``. The
    dense attention's probs dropout and the fused training attention's
    caller-drawn mask both use this draw, so they see the same bits."""
    return torch.rand(shape, generator=gen, device=device) < (1.0 - rate)


def _apply(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    return torch.where(keep, x / (1.0 - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device))


class _SeededDropout(torch.autograd.Function):
    """The default formula forward; the only residual is ``gen``'s state
    before the draw, from which the backward draws the mask again."""

    @staticmethod
    def forward(ctx, x, rate, gen):
        ctx.state = gen.get_state()
        ctx.rate, ctx.shape, ctx.device = rate, x.shape, x.device
        return _apply(x, keep_mask(x.shape, rate, gen, x.device), rate)

    @staticmethod
    def backward(ctx, g):
        again = torch.Generator(device=ctx.device)
        again.set_state(ctx.state)
        keep = keep_mask(ctx.shape, ctx.rate, again, ctx.device)
        return _apply(g, keep, ctx.rate), None, None


def dropout(x: torch.Tensor, rate: float,
            gen: Optional[torch.Generator]) -> torch.Tensor:
    """``x`` with each element kept with probability 1 - rate and scaled by
    1 / (1 - rate); the identity when ``gen`` is None or ``rate`` is 0."""
    if gen is None or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    if _SEEDED:
        return _SeededDropout.apply(x, rate, gen)
    return _apply(x, keep_mask(x.shape, rate, gen, x.device), rate)
