"""Multi-head attention with a packed QKV projection and KV-cache support
(port of ``case_rg_tpu/ops/attention.py``).

The packed in-projection ``in_proj_weight`` [3E, E] is the JAX package's
``qkv_kernel`` [E, 3E] transposed (q | k | v blocks). Scores and softmax run
in f32 by default; ``set_bf16_scores(True)`` (``--bf16_scores``) keeps them
in bf16 for bf16 inputs in the dense ``attend`` and the plain single-query
path, where the JAX package's ``_score_dtype`` applies, while f32 inputs
always get f32 scores. The kernel sites (``fused_mha``,
``fused_train_mha{,_rng}``, ``stack_step``, ``single_query_mha``) keep f32
scores under the switch, as the JAX package's Pallas kernels do: their
gates are decided before any score dtype. ``single_query_mha`` runs where
the JAX package has no kernel (its XLA single-query path does follow the
switch), so on the card a bf16 decode step's single-query attention keeps
f32 scores where the JAX package's would take bf16 ones. Probabilities are
cast to v's dtype before the PV product. Rows whose keys are all masked
produce zeros. In training (a dropout generator is given) the
probabilities go through dropout before the PV product.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.decode_attention import (single_query_mha,
                                       single_query_mha_plain)
from ..kernels.encoder_attention import fused_mha
from ..kernels.train_attention import (draw_seed, fused_train_mha,
                                       fused_train_mha_rng)
from .dropout import dropout, keep_mask
from .masking import neg_inf

# Routing of deterministic, no-bias, no-weights sites to the fused kernel
# (kernels/encoder_attention.fused_mha): None = auto (bf16 inputs),
# True = always, False = never (the dense ``attend`` path).
_FUSED_ATTN = None
# Routing of training sites (dropout generator given) without bias or
# weights to the fused training attention (kernels/train_attention): None =
# auto (bf16 inputs and dropout > 0, the gate the JAX package's CLI sets for
# --bf16_train), True = always, False = never (the dense ``attend`` path
# with probs dropout).
_FUSED_TRAIN_ATTN = None
# Which of its two variants: True = the mask is drawn inside the kernel from
# a per-site seed (fused_train_mha_rng, the --bf16_train default), False =
# the caller draws the [R, H, Lq, Lk] mask with the dense path's draw
# (fused_train_mha; --no-kernel_rng_dropout).
_FUSED_TRAIN_ATTN_RNG = True
# Routing of single-query decode attention (``attend_with_kv_merged`` with
# one query: every unfused decoder stack's self- and cross-attention in a
# decode step) to the kernel (kernels/decode_attention.single_query_mha):
# None = auto (bf16 on the card), True = always, False = never (the dense
# ``single_query_mha_plain`` path).
_SINGLE_QUERY_ATTN = None
# Attention scores for bf16 inputs: False = f32 (the default), True = bf16
# (``_score_dtype``).
_BF16_SCORES = False


def set_bf16_scores(on: bool) -> None:
    """bf16 attention scores for bf16 inputs in the dense paths
    (process-wide; the CLIs set it at startup)."""
    global _BF16_SCORES
    _BF16_SCORES = bool(on)


def _score_dtype(in_dtype) -> torch.dtype:
    """The JAX package's rule: f32 inputs always get f32 scores; other
    inputs keep their dtype only when the switch is on."""
    if in_dtype == torch.float32 or not _BF16_SCORES:
        return torch.float32
    return in_dtype


def set_fused_attention(on) -> None:
    """True=force, False=off, None=auto (bf16 only)."""
    global _FUSED_ATTN
    _FUSED_ATTN = on


def set_fused_train_attention(on) -> None:
    """True=force, False=off, None=auto (bf16 and dropout > 0)."""
    global _FUSED_TRAIN_ATTN
    _FUSED_TRAIN_ATTN = on


def set_fused_train_attn_rng(on: bool) -> None:
    """True: in-kernel Philox mask; False: caller-drawn mask."""
    global _FUSED_TRAIN_ATTN_RNG
    _FUSED_TRAIN_ATTN_RNG = bool(on)


def set_single_query_attention(on) -> None:
    """True=force, False=off, None=auto (bf16 on the card)."""
    global _SINGLE_QUERY_ATTN
    _SINGLE_QUERY_ATTN = on


def _single_query_ok(q: torch.Tensor) -> bool:
    if _SINGLE_QUERY_ATTN is False or q.shape[1] != 1:
        return False
    if _SINGLE_QUERY_ATTN:
        return True
    return q.dtype == torch.bfloat16 and q.device.type == "cuda"


def _fused_attention_ok(dtype, attn_bias, need_weights) -> bool:
    if _FUSED_ATTN is False or attn_bias is not None or need_weights:
        return False
    if _FUSED_ATTN:
        return True
    return dtype == torch.bfloat16   # f32, the parity dtype, stays dense


def _fused_train_attention_ok(dtype, attn_bias, need_weights,
                              rate: float) -> bool:
    if _FUSED_TRAIN_ATTN is False or attn_bias is not None or need_weights:
        return False
    if _FUSED_TRAIN_ATTN:
        return True
    return dtype == torch.bfloat16 and rate > 0.0


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, l, e = x.shape
    return x.reshape(b, l, num_heads, e // num_heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


def _mask_scores(scores, key_keep):
    return torch.where(key_keep[:, None, None, :], scores,
                       torch.full((), neg_inf(scores.dtype),
                                  device=scores.device))


@functools.lru_cache(maxsize=None)
def _attend_scale(d: int, dtype) -> float:
    """1/sqrt(d) in f32 rounded to ``dtype``, once per (d, dtype). A Python
    float: a 0-dim CPU tensor moved to the card per call would be a
    blocking copy, a synchronisation of the stream in every train step."""
    return float(torch.tensor(1.0 / np.sqrt(np.float32(d)),
                              dtype=torch.float32).to(dtype))


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           attn_bias: Optional[torch.Tensor] = None,
           key_keep: Optional[torch.Tensor] = None,
           dropout_rate: float = 0.0,
           gen: Optional[torch.Generator] = None,
           need_weights: bool = False
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Scaled dot-product attention on [B, H, L, d] tensors. ``attn_bias``:
    additive [Lq, Lk]; ``key_keep``: bool [B, Lk], True = attend; with a
    generator ``gen``, dropout at ``dropout_rate`` on the probabilities.
    Scores, softmax and probabilities in ``_score_dtype(q.dtype)``."""
    scale = _attend_scale(q.shape[-1], q.dtype)
    sd = _score_dtype(q.dtype)
    scores = torch.matmul((q * scale).to(sd), k.to(sd).transpose(-1, -2))
    if attn_bias is not None:
        scores = scores + attn_bias.to(sd)[None, None]
    if key_keep is not None:
        scores = _mask_scores(scores, key_keep)
    probs = torch.softmax(scores, dim=-1)
    if key_keep is not None:
        probs = probs * key_keep.any(-1).to(probs.dtype)[:, None, None, None]
    weights = probs.mean(1) if need_weights else None
    probs = dropout(probs, dropout_rate, gen)
    return torch.matmul(probs.to(v.dtype), v), weights


class MultiHeadAttention(nn.Module):
    """Torch-style MHA (same embed dim for q/k/v, packed projection)."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 *, device=None, dtype=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(
            torch.empty(3 * embed_dim, embed_dim, device=device, dtype=dtype))
        self.in_proj_bias = nn.Parameter(
            torch.empty(3 * embed_dim, device=device, dtype=dtype))
        self.out = nn.Linear(embed_dim, embed_dim, device=device, dtype=dtype)

    def _proj(self, x: torch.Tensor, which: str) -> torch.Tensor:
        e = self.embed_dim
        i = {"q": 0, "k": 1, "v": 2}[which]
        return F.linear(x, self.in_proj_weight[i * e:(i + 1) * e],
                        self.in_proj_bias[i * e:(i + 1) * e])

    def project_q(self, x: torch.Tensor) -> torch.Tensor:
        return self._proj(x, "q")

    def project_kv(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Precompute K/V (merged-head layout [B, L, E]) for cached decoding."""
        return self._proj(x, "k"), self._proj(x, "v")

    def project_qkv(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """All three projections in one product. Returns (q [B, L, E],
        kv [B, L, 2E]); the packed kv half goes to the cache as one buffer."""
        qkv = F.linear(x, self.in_proj_weight, self.in_proj_bias)
        e = self.embed_dim
        return qkv[..., :e], qkv[..., e:]

    def attend_with_kv_merged(self, q_in: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, key_keep=None,
                              q_projected: bool = False):
        """Decode attention over merged-layout K/V [B, L, E] (strided views
        of a packed cache are read in place). ``q_projected=True`` skips
        the query projection."""
        q = q_in if q_projected else self.project_q(q_in)
        if _single_query_ok(q):
            ctx = single_query_mha(q, k, v, key_keep, self.num_heads)
        else:
            ctx = single_query_mha_plain(q, k, v, key_keep, self.num_heads,
                                         _score_dtype(q.dtype))
        return self.out(ctx), None

    def attend_with_kv(self, q_in: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, *, attn_bias=None, key_keep=None,
                       need_weights: bool = False,
                       gen: Optional[torch.Generator] = None):
        """Attention where K/V are already projected ([B, Lk, E]). ``gen``:
        the dropout generator (training); None = deterministic."""
        h = self.num_heads
        if gen is None and _fused_attention_ok(q_in.dtype, attn_bias,
                                               need_weights):
            ctx = fused_mha(self.project_q(q_in), k, v, key_keep, h)
            return self.out(ctx), None
        if gen is not None and _fused_train_attention_ok(
                q_in.dtype, attn_bias, need_weights, self.dropout):
            # every encoder/tower self-attention site and the teacher-forced
            # decoder cross-attentions (Lq != Lk); the causal decoder
            # self-attention has a bias and stays dense
            q = self.project_q(q_in)
            r, lq, _ = q.shape
            if _FUSED_TRAIN_ATTN_RNG:
                ctx = fused_train_mha_rng(q, k, v, key_keep,
                                          draw_seed(gen, q.device), h,
                                          self.dropout)
            else:
                # the dense path's draw, same shape and generator: the
                # same mask bits
                mask = keep_mask((r, h, lq, k.shape[1]), self.dropout, gen,
                                 q.device)
                ctx = fused_train_mha(q, k, v, key_keep, mask, h,
                                      self.dropout)
            return self.out(ctx), None
        ctx, w = attend(split_heads(self.project_q(q_in), h),
                        split_heads(k, h), split_heads(v, h),
                        attn_bias=attn_bias, key_keep=key_keep,
                        dropout_rate=self.dropout, gen=gen,
                        need_weights=need_weights)
        return self.out(merge_heads(ctx)), w

    def forward(self, q_in: torch.Tensor, k_in: torch.Tensor,
                v_in: torch.Tensor, *, attn_bias=None, key_keep=None,
                need_weights: bool = False,
                gen: Optional[torch.Generator] = None):
        return self.attend_with_kv(q_in, self._proj(k_in, "k"),
                                   self._proj(v_in, "v"), attn_bias=attn_bias,
                                   key_keep=key_keep,
                                   need_weights=need_weights, gen=gen)
