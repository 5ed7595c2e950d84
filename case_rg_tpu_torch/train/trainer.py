"""The trainer (port of ``case_rg_tpu/train/trainer.py``): the train step,
the epoch loop with salvage checkpoints, ``fit`` with per-epoch dev loss,
``resume_or_init``, the dev evaluation and the pipelined ``predict``.

The step: losses = model.train_losses(batch, gen) -> their f32 sum ->
gradients -> global-norm clip -> Adam on a cosine-hard-restarts schedule
-> EMA, with optax's semantics, which differ from ``torch.optim``'s
defaults:

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
and backward run in bf16; losses are cast to f32 before the sum. The dev
evaluation runs in f32, as the JAX package's does.

``TrainConfig.remat`` recomputes the forward in the backward, as the JAX
package's ``jax.checkpoint`` of the whole differentiated function (the
bf16 cast and the model's losses) does: the step runs that function under
``torch.utils.checkpoint.checkpoint(use_reentrant=False)`` with the policy
of ``REMAT_POLICIES``. Losses are the same bit for bit and gradients are
those of the same function; only what waits in memory for the backward
changes. The hand-written kernels' autograd Functions (the training
attention, the additive scores) are not aten products, so every policy
runs their forward again, as JAX's policies do with a ``pallas_call``.

The state's tensors are updated in place (the masters are the model's own
parameters), which saves a copy of every state tensor per step.

Dropout: every mask of a step is drawn in order from one ``torch.Generator``
on the device (``ops/dropout.py``, the training-attention seeds). Under
remat the forward runs twice, so both runs draw from a generator rewound
to the step's starting state (``_rewinder``), and the step's generator is
then left where one forward leaves it: the recompute sees the forward's
masks and seeds, and the next step draws what it draws without remat. ``fit``
makes each epoch's generator from ``(seed, epoch)`` (``epoch_generator``),
so a run resumed at epoch e draws what an unbroken run draws there, and a
resume is bit-exact. The JAX loop instead splits one key chain from
``PRNGKey(seed)`` anew at ``start_epoch`` (``case_rg_tpu/train/trainer.py:
273-281``), so its resumed epochs draw other masks than its unbroken ones;
and its streams (threefry or rbg) cannot be matched by Philox anyway.

Data parallelism (``runtime/mesh``, one process a card under torchrun; the
JAX package's ``--multihost`` data axis). Every rank holds the whole state
and a shard of each global batch (``Batcher`` with the rank and count,
every rank padded to the same batch count):

* the state is broadcast from rank 0 at ``init_state`` and after a
  resume;
* the step runs under ``mesh.global_batch``: each loss divides the rank's
  numerator by the denominator summed over the ranks (one small all-reduce
  a loss term), so the rank gradients summed over the ranks (one
  all-reduce of one flat buffer, the losses riding in it) are the gradient
  of the global batch's loss, as under the JAX package's sharded program;
  the reported losses and ``grad_norm`` are the global batch's. The clip,
  Adam and the EMA then run on the summed gradient on every rank, so the
  ranks stay bit-identical (``mesh.check_replicas`` at every epoch's
  checkpoint);
* with ``accumulation_steps`` > 1 the gradient is reduced at every call
  (each mini-step's global gradient, then the same running mean as one
  process): the state moves exactly as one process's on the concatenated
  batches of each mini-step;
* each rank's dropout generator folds in its rank (``epoch_generator``),
  so the ranks draw different masks and in-kernel seeds;
* the ranks agree on a preemption at every batch boundary (``mesh.agree``:
  a MAX of the flag over a gloo group of the host, which waits on no card
  work, so the loop's "a host read only at log points" holds); a signal
  seen by any rank stops every rank before the same step, and one
  salvage checkpoint is written;
* checkpoints and ``best.json`` are written by rank 0, behind a barrier;
  ``eval_losses`` reduces its sums, so every rank sees one dev loss; the
  logs and metrics come from rank 0;
* ``predict`` runs per rank, on rows ``[rank::count]``.
"""

from __future__ import annotations

import os
import signal
import sys
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from ..bridge import load_state
from ..config import TrainConfig
from ..data.batching import Batcher
from ..device import batch_to_device, resolve_device
from ..runtime import mesh
from ..runtime.continuous.base import HostCopy
from .checkpoint import (best_epoch_record, checkpoint_exists, latest_epoch,
                         load_checkpoint, save_best, save_checkpoint)
from .precision import cast_params
from .schedule import cosine_hard_restarts_with_warmup

_B1, _B2, _EPS = 0.9, 0.999, 1e-8

# TrainConfig.remat -> the aten products whose outputs the backward keeps
# (torch.utils.checkpoint's selective policy); everything else in the
# differentiated function is recomputed. On the port's shapes F.linear
# reaches aten.addmm (aten.mm without a bias or on a non-contiguous input)
# and torch.matmul / einsum of stacked operands aten.bmm (checked on the
# CPU with a dispatch mode). "dots" keeps the unbatched products, as
# jax.checkpoint_policies.dots_with_no_batch_dims_saveable; "dots_batch"
# the batched ones too (dots_saveable); "nothing" keeps none
# (nothing_saveable).
REMAT_POLICIES = {
    "": None,
    "dots": ("mm", "addmm"),
    "dots_batch": ("mm", "addmm", "bmm", "baddbmm"),
    "nothing": (),
}


@dataclass
class TrainState:
    params: Dict[str, torch.Tensor]    # f32 masters: the model's parameters
    mu: Dict[str, torch.Tensor]        # Adam moments
    nu: Dict[str, torch.Tensor]
    ema: Dict[str, torch.Tensor]
    acc: Optional[Dict[str, torch.Tensor]]   # the accumulated grads'
    #                                  running mean (k > 1), else None
    count: int = 0                     # updates applied (Adam's count)
    mini_step: int = 0                 # calls since the last update
    step: int = 0                      # effective (post-accumulation) steps


def epoch_generator(seed: int, epoch: int, device,
                    rank: int = 0) -> torch.Generator:
    """The dropout generator of epoch ``epoch`` on rank ``rank``: Philox
    (or the CPU's generator) seeded from ``(seed, epoch, rank)`` through
    numpy's SeedSequence, which ignores trailing zeros, so rank 0 (and one
    process) draws from ``(seed, epoch)``'s stream."""
    s = np.random.SeedSequence([seed, epoch, rank]).generate_state(
        2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        int(s[0]) << 32 | int(s[1]))


class PreemptionGuard:
    """Graceful preemption: SIGTERM and SIGINT set a flag; the epoch loop
    saves a salvage checkpoint at the next batch boundary and stops
    cleanly. Handlers are installed only on the main thread (elsewhere
    ``signal.signal`` raises and the guard stays inert)."""

    def __init__(self):
        self.requested = False
        self._prev = {}

    def __enter__(self):
        def handler(signum, frame):
            self.requested = True
            print(f"[train] signal {signum}: will checkpoint and stop at the "
                  "next batch boundary", flush=True)

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, handler)
            except ValueError:   # not the main thread
                pass
        return self

    def __exit__(self, *exc):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        return False


def _remat_context(saved: tuple):
    """``checkpoint``'s ``context_fn`` that keeps the outputs of the aten
    ops named in ``saved`` and recomputes the rest; None for none kept."""
    if not saved:
        return None
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    keep = {getattr(torch.ops.aten, n).default for n in saved}

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in keep
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return lambda: create_selective_checkpoint_contexts(policy)


def _rewinder(gen: Optional[torch.Generator]):
    """(rewind, work): ``rewind()`` sets the generator ``work`` to ``gen``'s
    state at this call and returns it, so each run of a checkpointed
    forward draws the same masks and seeds from ``work``."""
    if gen is None:
        return (lambda: None), None
    snap = gen.get_state()
    work = torch.Generator(device=gen.device)

    def rewind():
        work.set_state(snap)
        return work
    return rewind, work


class _Losses(nn.Module):
    """``model.train_losses`` as a module's forward, for functional_call."""

    def __init__(self, model: nn.Module, kwargs: dict):
        super().__init__()
        self.model = model
        self.kwargs = kwargs

    def forward(self, batch, gen):
        return self.model.train_losses(batch, gen, **self.kwargs)


class Trainer:
    def __init__(self, model: nn.Module, train_cfg: TrainConfig,
                 total_steps: int, *, device="cuda",
                 loss_method_kwargs: Optional[dict] = None):
        """``model``: f32 parameters on ``device``. ``loss_method_kwargs``
        go to every ``train_losses`` call, training and evaluation (GLKS's
        ``mode="ds_mle_mce_train"``, ``mode="ps_train"`` for Masque and
        TMemNet). Raises without a card unless ``device="cpu"``."""
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
        self._losses = _Losses(model, dict(loss_method_kwargs or {}))
        self._bf16 = train_cfg.compute_dtype == "bfloat16"
        if train_cfg.remat not in REMAT_POLICIES:
            raise ValueError(f"remat {train_cfg.remat!r} not in "
                             f"{tuple(REMAT_POLICIES)}")
        if train_cfg.pool_shard:
            raise ValueError("pool_shard: the pool axis over a 'model' mesh "
                             f"axis is not ported yet ({mesh.MODEL_AXIS_ITEM})")
        if train_cfg.mesh_shape:
            mesh.parse_mesh_shape(",".join(map(str, train_cfg.mesh_shape)))
        self._dp = mesh.is_distributed()
        self._main = mesh.process_index() == 0

    def _log(self, msg: str) -> None:
        if self._main:
            print(msg, flush=True)

    def init_state(self) -> TrainState:
        """A fresh state over the model's current parameters: zero moments,
        EMA equal to the parameters."""
        params = dict(self.model.named_parameters())
        mesh.broadcast(params.values())
        zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}
        return TrainState(params=params, mu=zeros(), nu=zeros(),
                          ema={k: v.detach().clone()
                               for k, v in params.items()},
                          acc=zeros() if self.tc.accumulation_steps > 1
                          else None)

    def restore(self, state: TrainState, ck: dict) -> TrainState:
        """Copy a loaded checkpoint (``checkpoint.load_checkpoint``) into
        ``state`` in place: parameters, EMA, Adam moments, counts and, when
        accumulating, the running mean. Raises for a checkpoint without
        optimiser state, or with a part-accumulated mean this trainer does
        not accumulate."""
        opt = ck.get("opt_state")
        if opt is None:
            raise ValueError("checkpoint has no optimiser state to resume "
                             "from (a weights-only checkpoint)")
        if opt.get("mini_step", 0) and state.acc is None:
            raise ValueError("checkpoint was saved mid-accumulation; resume "
                             "with the same --accumulation_steps")
        load_state(self.model, ck["params"])
        with torch.no_grad():
            for name, into in (("ema", state.ema), ("mu", state.mu),
                               ("nu", state.nu), ("acc", state.acc)):
                if into is None:
                    continue
                src = ck["ema"] if name == "ema" else opt.get(name)
                for k, t in into.items():
                    if src is None:         # acc of a k = 1 checkpoint
                        t.zero_()
                    else:
                        t.copy_(src[k])
        state.count = int(opt["count"])
        state.mini_step = int(opt.get("mini_step", 0))
        state.step = int(ck["step"])
        return state

    def _run(self, params, batch, gen, bf16: bool):
        if bf16:
            params = cast_params(params, torch.bfloat16)
        losses = torch.func.functional_call(
            self._losses, {f"model.{k}": v for k, v in params.items()},
            (batch, gen))
        return {k: v.float() for k, v in losses.items()}

    def _run_remat(self, params, batch, gen):
        """``_run`` under ``checkpoint`` with the ``TrainConfig.remat``
        policy, both runs of the forward drawing from ``gen`` rewound to its
        state here; ``gen`` is left where the forward left it."""
        from torch.utils.checkpoint import checkpoint
        rewind, work = _rewinder(gen)
        ctx = _remat_context(REMAT_POLICIES[self.tc.remat])
        kw = {} if ctx is None else {"context_fn": ctx}
        losses = checkpoint(
            lambda: self._run(params, batch, rewind(), self._bf16),
            use_reentrant=False, **kw)
        if work is not gen:
            gen.set_state(work.get_state())
        return losses

    def loss_and_grads(self, state: TrainState, batch,
                       gen: Optional[torch.Generator]):
        """(losses with "total", gradients of the total by parameter name)
        at the state's parameters; nothing is updated. In a process group:
        the global batch's losses and gradients (summed over the ranks)."""
        batch = batch_to_device(_device_fields(batch), self.device)
        with mesh.global_batch():     # the recompute under remat too
            if self.tc.remat:
                losses = self._run_remat(state.params, batch, gen)
            else:
                losses = self._run(state.params, batch, gen, self._bf16)
            total = sum(losses.values())
            grads = torch.autograd.grad(total, list(state.params.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
        losses = {k: v.detach() for k, v in losses.items()}
        if not self._dp:
            losses["total"] = total.detach()
            return losses, dict(zip(state.params, grads))
        names = list(losses)
        *grads, vals = mesh.all_reduce_sum(
            list(grads) + [torch.stack([losses[k] for k in names])])
        losses = dict(zip(names, vals.unbind()))
        losses["total"] = sum(losses.values())
        return losses, dict(zip(state.params, grads))

    @torch.no_grad()
    def eval_batch(self, state: TrainState, batch, ema: bool = False
                   ) -> Dict[str, torch.Tensor]:
        """The losses of one batch with dropout off (deterministic), in
        f32, at the state's parameters (or its EMA), as device tensors."""
        batch = batch_to_device(_device_fields(batch), self.device)
        losses = self._run(state.ema if ema else state.params, batch, None,
                           bf16=False)
        losses["total"] = sum(losses.values())
        return losses

    def train_step(self, state: TrainState, batch,
                   gen: torch.Generator) -> Dict[str, torch.Tensor]:
        """One step on ``batch`` with dropout drawn from ``gen``; updates
        ``state`` in place and returns the losses, their "total" and the
        gradients' global norm before the clip ("grad_norm"), as device
        tensors (no host sync)."""
        losses, grads = self.loss_and_grads(state, batch, gen)
        losses["grad_norm"] = self.apply_gradients(state, grads)
        return losses

    @torch.no_grad()
    def apply_gradients(self, state: TrainState,
                        grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The optimiser's part of a step (accumulation, clip, Adam, EMA) on
        ``grads`` (parameter name -> gradient); updates ``state`` in place
        and returns the global norm before the clip, a device tensor."""
        tc = self.tc
        names = list(state.params)
        g = [grads[n] for n in names]
        k = tc.accumulation_steps
        if k > 1:   # running mean over the k calls
            acc = [state.acc[n] for n in names]
            torch._foreach_add_(acc, torch._foreach_sub(g, acc),
                                alpha=1.0 / (state.mini_step + 1))
            g = acc
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        state.mini_step += 1
        if state.mini_step < k:
            return norm
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
        return norm

    # ---- epoch loops ----

    def _save(self, output_path: str, tag, state: TrainState,
              update_latest: bool = True) -> None:
        with torch.profiler.record_function(f"checkpoint {tag}"):
            save_checkpoint(output_path, tag, state, update_latest)

    def _state_tensors(self, state: TrainState):
        return [t for part in (state.params, state.ema, state.mu, state.nu,
                               state.acc or {}) for t in part.values()]

    def train_epoch(self, state: TrainState, batcher: Batcher, epoch: int,
                    gen: torch.Generator, metrics_logger=None,
                    output_path: str = "", checkpoint_every: int = 0,
                    guard=None) -> TrainState:
        """One epoch of ``batcher``'s batches, dropout drawn from ``gen``.
        With a guard whose ``requested`` is set, writes the salvage
        checkpoint ``{epoch}.preempt`` at the next batch boundary and
        raises KeyboardInterrupt; every ``checkpoint_every`` steps writes
        ``{epoch}.mid``; neither marks the epoch complete. The host reads
        the losses (a sync with the card) only every ``log_every`` steps
        and at the epoch's end."""
        from ..runtime.profiling import StepMeter

        start = time.time()
        meter = StepMeter()
        last_losses = {}
        for j, batch in enumerate(batcher.epoch(epoch)):
            stop = guard is not None and (mesh.agree(guard.requested)
                                          if self._dp else guard.requested)
            if stop:
                if output_path:
                    self._save(output_path, f"{epoch}.preempt", state,
                               update_latest=False)
                    self._log(f"[train] preempted at epoch {epoch} batch "
                              f"{j}; salvage checkpoint {epoch}.preempt "
                              "written")
                raise KeyboardInterrupt("preempted")
            meter.start()
            losses = self.train_step(state, batch, gen)
            last_losses = losses
            if checkpoint_every and output_path and j > 0 and \
                    j % checkpoint_every == 0:
                # mid-epoch salvage checkpoint: does not mark the epoch
                # complete (resume stays epoch-granular)
                self._save(output_path, f"{epoch}.mid", state,
                           update_latest=False)
            if j > 0 and j % self.tc.log_every == 0:
                vals = {k: float(v) for k, v in losses.items()}
                meter.stop()
                self._log(f"[train] epoch {epoch} batch {j} loss {vals} "
                          f"time {time.time() - start:.1f}s "
                          f"({meter.steps_per_sec():.2f} steps/s)")
                if metrics_logger is not None:
                    metrics_logger.log(state.step, vals)
        vals = {k: float(v) for k, v in last_losses.items()}
        self._log(f"[train] epoch {epoch} done ({batcher.num_batches(epoch)} "
                  f"batches) loss {vals} time {time.time() - start:.1f}s")
        sys.stdout.flush()
        return state

    def fit(self, state: TrainState, arrays: Dict[str, np.ndarray],
            epochs: int, output_path: str, seed: int = 0,
            start_epoch: int = 0, profile_dir: Optional[str] = None,
            eval_arrays: Optional[Dict[str, np.ndarray]] = None,
            early_stop: int = 0) -> TrainState:
        """Train epochs ``start_epoch`` .. ``epochs - 1`` of ``arrays``
        (shuffled by ``seed`` and the epoch), writing ``model/{epoch}.pt``
        after each. With ``eval_arrays``: the dev loss after each epoch
        (``dev_*`` in metrics.jsonl), ``model/best.json`` whenever it
        improves, and with ``early_stop`` > 0 a stop once it has not
        improved for that many epochs. A resumed run starts from the best
        that ``best.json`` records (the JAX loop forgets it at a resume and
        may name a worse epoch). SIGTERM/SIGINT salvage the epoch in
        progress (``PreemptionGuard``) and return. ``profile_dir``: the
        whole loop under ``runtime.profiling.trace``."""
        from ..runtime.profiling import MetricsLogger, trace

        rank, count = mesh.process_index(), mesh.process_count()
        batcher = Batcher(arrays, self.tc.batch_size, shuffle=True, seed=seed,
                          process_index=rank, process_count=count)
        logger = MetricsLogger(os.path.join(output_path, "metrics.jsonl")
                               if output_path and self._main else None)
        best = best_epoch_record(output_path) if start_epoch else None
        stale = 0
        try:
            with trace(profile_dir), PreemptionGuard() as guard:
                for epoch in range(start_epoch, epochs):
                    gen = epoch_generator(seed, epoch, self.device, rank)
                    with torch.profiler.record_function(f"train_epoch "
                                                        f"{epoch}"):
                        state = self.train_epoch(
                            state, batcher, epoch, gen,
                            metrics_logger=logger, output_path=output_path,
                            checkpoint_every=self.tc.checkpoint_every_steps,
                            guard=guard)
                    self._save(output_path, epoch, state)
                    if self._dp:
                        self._log(f"[train] epoch {epoch}: the {count} "
                                  "replicas agree bit for bit (checksum "
                                  f"{self.check_replicas(state)})")
                    if eval_arrays is None:
                        continue
                    with torch.profiler.record_function(f"dev_eval {epoch}"):
                        dev = self.eval_losses(state, eval_arrays)
                    vals = {k: round(v, 6) for k, v in dev.items()}
                    self._log(f"[train] epoch {epoch} dev loss {vals}")
                    logger.log(state.step,
                               {f"dev_{k}": v for k, v in dev.items()})
                    total = float(dev.get("total", next(iter(dev.values()))))
                    if best is None or total < best[0]:
                        best = (total, epoch)
                        stale = 0
                        if output_path:
                            save_best(output_path, epoch, total)
                    else:
                        stale += 1
                        if early_stop and stale >= early_stop:
                            self._log(f"[train] early stop after epoch "
                                      f"{epoch}: no dev improvement for "
                                      f"{early_stop} epochs (best epoch "
                                      f"{best[1]}, dev {best[0]:.6f})")
                            break
        except KeyboardInterrupt:
            # preemption (or ctrl-c routed through the guard): the state was
            # salvaged by train_epoch; leave the loop cleanly
            pass
        logger.close()
        return state

    def check_replicas(self, state: TrainState) -> int:
        """``mesh.check_replicas`` over the whole state (parameters, EMA,
        moments, the accumulated mean): raises unless every rank's is
        bit-identical; returns its checksum."""
        return mesh.check_replicas(self._state_tensors(state),
                                   "train state")

    def resume_or_init(self, output_path: str):
        """(state, start_epoch): a fresh state over the model's parameters,
        or, with ``resume`` on and a completed epoch in ``latest.json``,
        that epoch's checkpoint restored and the next epoch to train. A
        latest pointer whose checkpoint is missing walks back to the newest
        epoch that exists on disk. In a process group every rank reads the
        checkpoint and rank 0's state is broadcast."""
        state = self.init_state()
        last = latest_epoch(output_path)
        if self.tc.resume and last is not None:
            while last >= 0 and not checkpoint_exists(output_path, last):
                self._log(f"[train] checkpoint for epoch {last} missing; "
                          "falling back")
                last -= 1
            if last >= 0:
                self.restore(state, load_checkpoint(output_path, last))
                mesh.broadcast(self._state_tensors(state))
                return state, last + 1
        return state, 0

    # ---- per-epoch dev evaluation ----

    def eval_losses(self, state: TrainState, arrays: Dict[str, np.ndarray],
                    batch_size: int = 0, ema_eval: bool = False
                    ) -> Dict[str, float]:
        """Deterministic f32 losses over an eval split: the mean of batch
        losses weighted by each batch's real-sample count (``sample_weight``
        masks the padded final batch, and the losses weight by it too, so
        the mean is exact for per-sample-mean losses). Sums stay on the
        device; the host reads them once. In a process group each batch is
        the global batch of the ranks' shards: its losses and real-sample
        count are summed over the ranks (one small all-reduce a batch), so
        every rank returns the same dev loss, the one process's over
        batches of ``batch_size`` times the ranks."""
        bs = batch_size or self.tc.batch_size
        totals: Dict[str, torch.Tensor] = {}
        weight = 0.0
        for batch in Batcher(arrays, bs, shuffle=False,
                             process_index=mesh.process_index(),
                             process_count=mesh.process_count()).epoch(0):
            w = float(batch["sample_weight"].sum())
            with mesh.global_batch():
                losses = self.eval_batch(state, batch, ema=ema_eval)
            losses.pop("total")
            if self._dp:
                names = list(losses)
                vec = torch.stack([losses[k] for k in names]
                                  + [torch.tensor(w, device=self.device)])
                *vals, w = mesh.all_reduce_sum([vec])[0].double().unbind()
                losses = dict(zip(names, vals))
            for k, v in losses.items():
                totals[k] = totals.get(k, 0.0) + v.double() * w
            weight += w
        weight = float(weight)
        out = {k: float(v) / max(weight, 1.0) for k, v in totals.items()}
        out["total"] = sum(out.values())
        return out


def _device_fields(batch: dict) -> dict:
    """A batch without its host-side bookkeeping ("_indices")."""
    return {k: v for k, v in batch.items() if not k.startswith("_")}


def predict(arrays: Dict[str, np.ndarray],
            predict_fn: Callable[[dict], Dict[str, torch.Tensor]],
            batch_size: int, pipeline_depth: int = 4) -> Iterable[tuple]:
    """Yields (host_batch, outputs as numpy) over ``arrays`` in order
    (``Batcher`` without shuffle, the final batch padded). ``predict_fn``
    (``runtime.inference.make_predict_fn``) holds the model, so the weights
    (parameters or EMA, cast or not) are chosen when it is loaded; the JAX
    method takes them from a train state. Up to ``pipeline_depth`` batches
    are in flight: each batch's outputs start their copy into pinned host
    memory at dispatch (``HostCopy``) and are read ``pipeline_depth``
    batches later, as ``cli/serve`` fetches them. In a process group each
    rank predicts its own rows, ``[rank::count]``."""
    inflight: deque = deque()
    for batch in Batcher(arrays, batch_size, shuffle=False,
                         process_index=mesh.process_index(),
                         process_count=mesh.process_count()).epoch(0):
        out = predict_fn(_device_fields(batch))
        keys = list(out)
        inflight.append((batch, keys, HostCopy([out[k] for k in keys])))
        if len(inflight) >= max(pipeline_depth, 1):
            b, ks, hc = inflight.popleft()
            yield b, dict(zip(ks, hc.get()))
    while inflight:
        b, ks, hc = inflight.popleft()
        yield b, dict(zip(ks, hc.get()))
