"""The train step (port of the step of ``case_rg_tpu/train/trainer.py``).

losses = model.train_losses(batch, gen) -> their f32 sum -> gradients ->
global-norm clip -> Adam on a cosine-hard-restarts schedule -> EMA, with
optax's semantics, which differ from ``torch.optim``'s defaults:

* the clip scales by ``max_norm / norm`` only when ``norm >= max_norm``, with
  no epsilon (``clip_by_global_norm``);
* Adam's eps is added outside the square root, after bias correction;
* the schedule is read at the pre-increment count, so the first step of a
  warmup runs at lr = 0;
* with ``accumulation_steps`` = k > 1 the gradients are averaged over k
  calls (a running mean, as ``optax.MultiSteps``) and the update, the EMA
  and the step count move only on every k-th call.

With ``compute_dtype="bfloat16"`` the f32 masters are cast to bf16 inside
the differentiated function (``train/precision.py``) and the whole forward
and backward run in bf16; losses are cast to f32 before the sum.

The state's tensors are updated in place (the masters are the model's own
parameters), which saves a copy of every state tensor per step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from ..config import TrainConfig
from ..device import batch_to_device, resolve_device
from .precision import cast_params
from .schedule import cosine_hard_restarts_with_warmup

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


@dataclass
class TrainState:
    params: Dict[str, torch.Tensor]    # f32 masters: the model's parameters
    mu: Dict[str, torch.Tensor]        # Adam moments
    nu: Dict[str, torch.Tensor]
    ema: Dict[str, torch.Tensor]
    acc: Dict[str, torch.Tensor]       # running mean of the accumulated grads
    count: int = 0                     # updates applied (Adam's count)
    mini_step: int = 0                 # calls since the last update
    step: int = 0                      # effective (post-accumulation) steps


class _Losses(nn.Module):
    """``model.train_losses`` as a module's forward, for functional_call."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, batch, gen):
        return self.model.train_losses(batch, gen)


class Trainer:
    def __init__(self, model: nn.Module, train_cfg: TrainConfig,
                 total_steps: int, *, device="cuda"):
        """``model``: f32 parameters on ``device``. Raises without a card
        unless ``device="cpu"``."""
        dev = resolve_device(device)
        where = next(model.parameters()).device
        if where.type != dev.type:
            raise ValueError(f"model lives on {where}, not on {dev}")
        if any(p.dtype != torch.float32 for p in model.parameters()):
            raise ValueError("the train step keeps f32 master parameters: "
                             "build the model with param_dtype='float32'")
        self.model = model
        self.tc = train_cfg
        self.device = where
        self.schedule = cosine_hard_restarts_with_warmup(
            train_cfg.learning_rate, train_cfg.warmup_steps, total_steps,
            train_cfg.num_cycles)
        self._losses = _Losses(model)
        self._bf16 = train_cfg.compute_dtype == "bfloat16"

    def init_state(self) -> TrainState:
        params = dict(self.model.named_parameters())
        zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}
        return TrainState(params=params, mu=zeros(), nu=zeros(),
                          ema={k: v.detach().clone()
                               for k, v in params.items()},
                          acc=zeros())

    def _run(self, params, batch, gen):
        if self._bf16:
            params = cast_params(params, torch.bfloat16)
        losses = torch.func.functional_call(
            self._losses, {f"model.{k}": v for k, v in params.items()},
            (batch, gen))
        return {k: v.float() for k, v in losses.items()}

    def loss_and_grads(self, state: TrainState, batch,
                       gen: Optional[torch.Generator]):
        """(losses with "total", gradients of the total by parameter name)
        at the state's parameters; nothing is updated."""
        batch = batch_to_device(batch, self.device)
        losses = self._run(state.params, batch, gen)
        total = sum(losses.values())
        grads = torch.autograd.grad(total, list(state.params.values()),
                                    allow_unused=True, materialize_grads=True)
        losses = {k: v.detach() for k, v in losses.items()}
        losses["total"] = total.detach()
        return losses, dict(zip(state.params, grads))

    @torch.no_grad()
    def eval_losses(self, state: TrainState, batch) -> Dict[str, torch.Tensor]:
        """The losses of one batch with dropout off (deterministic)."""
        batch = batch_to_device(batch, self.device)
        losses = self._run(state.params, batch, None)
        losses["total"] = sum(losses.values())
        return losses

    def train_step(self, state: TrainState, batch,
                   gen: torch.Generator) -> Dict[str, torch.Tensor]:
        """One step on ``batch`` with dropout drawn from ``gen``; updates
        ``state`` in place and returns the losses, their "total" and the
        gradients' global norm before the clip ("grad_norm"), as device
        tensors (no host sync)."""
        losses, grads = self.loss_and_grads(state, batch, gen)
        tc = self.tc
        names = list(state.params)
        g = [grads[k] for k in names]
        with torch.no_grad():
            k = tc.accumulation_steps
            acc = [state.acc[n] for n in names]
            if k > 1:   # running mean over the k calls
                torch._foreach_add_(acc, torch._foreach_sub(g, acc),
                                    alpha=1.0 / (state.mini_step + 1))
                g = acc
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
            losses["grad_norm"] = norm
            state.mini_step += 1
            if state.mini_step < k:
                return losses
            state.mini_step = 0
            # clip_by_global_norm: g / norm * max_norm unless norm < max_norm
            clip = torch.where(norm < tc.grad_clip, torch.ones_like(norm),
                               tc.grad_clip / norm)
            g = torch._foreach_mul(g, clip)
            # Adam (optax.scale_by_adam), lr at the pre-increment count
            lr = self.schedule(state.count)
            state.count += 1
            mu = [state.mu[n] for n in names]
            nu = [state.nu[n] for n in names]
            torch._foreach_lerp_(mu, g, 1.0 - _B1)
            torch._foreach_mul_(nu, _B2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - _B2)
            denom = torch._foreach_div(nu, 1.0 - _B2 ** state.count)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, _EPS)
            upd = torch._foreach_div(mu, denom)
            params = [state.params[n] for n in names]
            torch._foreach_add_(params, upd,
                                alpha=-lr / (1.0 - _B1 ** state.count))
            # EMA of the updated parameters
            decay = tc.ema_decay
            ema = [state.ema[n] for n in names]
            torch._foreach_lerp_(ema, params, 1.0 - decay)
            if k > 1:
                torch._foreach_zero_(acc)
            state.step += 1
        return losses
