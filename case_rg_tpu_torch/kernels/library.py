"""The five serving kernels as ``torch.library`` custom ops, in the
``case_rg_torch`` namespace.

Each op has three implementations:

* CUDA: the wrapper module's ``*_cuda`` function, the ``ctypes`` launch of
  the hand-written kernel with all its checks; it counts the launch in the
  module's ``LAUNCHES`` and raises where the kernel cannot run. It never
  falls back to the plain version.
* CPU: the plain PyTorch version.
* fake (``register_fake``): the output's shape and dtype, for tracing.

The wrappers in ``kernels/*.py`` call the op on both devices, so a graph
traced by ``torch.export`` on either device holds the op itself, and an
exported program launches the kernels when it runs (the counters count
those launches, never a trace).

* ``fused_mha(q, k, v, keep, num_heads)``;
* ``stack_step(x, t, caches, m, mem_keep, hist_keep, folded, num_heads)``:
  mutates ``caches`` and returns only x_out; ``t`` is the [B] int32 step
  tensor and ``folded`` the list of operands in
  ``decoder_stack.WEIGHT_KEYS`` order (a schema takes no dict);
* ``single_query_mha(q, k, v, keep, num_heads)``;
* ``combine_copy_mass(cw, src_ids)``;
* ``additive_scores(wq, uh, v)``: the forward only; the backward stays in
  ``additive_attention._AdditiveScores``, which calls this op.

The training attention (``kernels/train_attention.py``) and the additive
backward are on no exported path and are not registered.

``kernels/__init__.py`` imports this module, so importing any kernel
module registers the ops.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import Tensor

from . import (additive_attention, copy_argmax, decode_attention,
               decoder_stack, encoder_attention)

NAMESPACE = "case_rg_torch"
OPS = ("fused_mha", "stack_step", "single_query_mha", "combine_copy_mass",
       "additive_scores")


@torch.library.custom_op(f"{NAMESPACE}::fused_mha", mutates_args=(),
                         device_types="cpu")
def fused_mha(q: Tensor, k: Tensor, v: Tensor, keep: Optional[Tensor],
              num_heads: int) -> Tensor:
    return encoder_attention.fused_mha_plain(q, k, v, keep, num_heads)


fused_mha.register_kernel("cuda")(encoder_attention.fused_mha_cuda)


@fused_mha.register_fake
def _(q, k, v, keep, num_heads):
    return q.new_empty(q.shape)


@torch.library.custom_op(f"{NAMESPACE}::stack_step", mutates_args=("caches",),
                         device_types="cpu")
def stack_step(x: Tensor, t: Tensor, caches: Tensor, m: Tensor,
               mem_keep: Tensor, hist_keep: Tensor, folded: List[Tensor],
               num_heads: int) -> Tensor:
    return decoder_stack.stack_step_plain(
        x, t, caches, m, mem_keep, hist_keep,
        dict(zip(decoder_stack.WEIGHT_KEYS, folded)), num_heads)[0]


@stack_step.register_kernel("cuda")
def _(x, t, caches, m, mem_keep, hist_keep, folded, num_heads):
    return decoder_stack.stack_step_cuda(
        x, t, caches, m, mem_keep, hist_keep,
        dict(zip(decoder_stack.WEIGHT_KEYS, folded)), num_heads)


@stack_step.register_fake
def _(x, t, caches, m, mem_keep, hist_keep, folded, num_heads):
    return x.new_empty(x.shape)


@torch.library.custom_op(f"{NAMESPACE}::single_query_mha", mutates_args=(),
                         device_types="cpu")
def single_query_mha(q: Tensor, k: Tensor, v: Tensor, keep: Optional[Tensor],
                     num_heads: int) -> Tensor:
    return decode_attention.single_query_mha_plain(q, k, v, keep, num_heads)


single_query_mha.register_kernel("cuda")(
    decode_attention.single_query_mha_cuda)


@single_query_mha.register_fake
def _(q, k, v, keep, num_heads):
    return q.new_empty(q.shape)


@torch.library.custom_op(f"{NAMESPACE}::combine_copy_mass", mutates_args=(),
                         device_types="cpu")
def combine_copy_mass(cw: Tensor, src_ids: Tensor) -> Tensor:
    return copy_argmax.combine_copy_mass_plain(cw, src_ids)


combine_copy_mass.register_kernel("cuda")(copy_argmax.combine_copy_mass_cuda)


@combine_copy_mass.register_fake
def _(cw, src_ids):
    return cw.new_empty(cw.shape, dtype=torch.float32)


@torch.library.custom_op(f"{NAMESPACE}::additive_scores", mutates_args=(),
                         device_types="cpu")
def additive_scores(wq: Tensor, uh: Tensor, v: Tensor) -> Tensor:
    return additive_attention.additive_scores_plain(wq, uh, v)


additive_scores.register_kernel("cuda")(
    additive_attention.additive_scores_cuda)


@additive_scores.register_fake
def _(wq, uh, v):
    return wq.new_empty(wq.shape[0], wq.shape[1], uh.shape[1])
