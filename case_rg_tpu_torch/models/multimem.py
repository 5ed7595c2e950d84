"""Multi-memory transformer decoder with copy extension (port of
``case_rg_tpu/models/multimem.py``: teacher forcing for training, and greedy
decoding with the dense copy-scatter + argmax epilogue).

M chained per-memory decoder stacks; the copy attention for memory i
queries the stream after stack i, before the final norm; per-memory copy
attention is prior-weighted and renormalized with the 1e-8 guard; the
``mix`` head splits probability mass between generation and the M copy
distributions. Training gathers the target's probability directly (no
[B, T, V_ext] copy tensor).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from ..kernels.decoder_stack import fold_stack_weights, stack_step
from ..ops.bilinear import BilinearAttention
from ..ops.cache import write_step
from ..ops.copynet import copy_scatter
from ..ops.dropout import dropout
from ..ops.embedding import Embedding
from ..ops.masking import softmax
from ..ops.positional import PositionalEmbedding
from ..ops.transformer import Decoder

_LN_EPS = 1e-5

# Fused decoder-stack decode step (kernels/decoder_stack.py): one kernel
# launch per stack per step instead of the per-layer chain, with the cross
# K/V caches folded away. None = auto (bf16 and memories of at least
# _FUSED_MIN_L positions), True = always, False = never.
_FUSED_STACK = None
# The JAX package's threshold, kept for this first slice; it is to be
# decided again by measurement on the H100.
_FUSED_MIN_L = 512


def set_fused_stack(on) -> None:
    """True=force, False=off, None=auto."""
    global _FUSED_STACK
    _FUSED_STACK = on


class MultiMemoryDecoder(nn.Module):
    def __init__(self, vocab_size: int, hidden_size: int, num_heads: int,
                 num_layers: int, num_memories: int = 2,
                 use_feature: bool = False, dropout: float = 0.0,
                 bos_id: int = 1, eos_id: int = 3, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d, v = hidden_size, vocab_size
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.num_memories = num_memories
        self.use_feature = use_feature
        self.dropout = dropout
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.embedding = Embedding(v, d, **kw)
        self.pos = PositionalEmbedding(d, dropout, max_len=1000, device=device)
        q_size = 2 * d if use_feature else d
        for i in range(num_memories):
            self.add_module(f"dec{i}", Decoder(num_layers, d, num_heads,
                                               d_ff=d, dropout=dropout,
                                               activation="gelu", **kw))
            self.add_module(f"attn{i}", BilinearAttention(q_size, d, d, **kw))
        self.norm1 = nn.LayerNorm(d, eps=_LN_EPS, **kw)
        if use_feature:
            self.norm2 = nn.LayerNorm(d, eps=_LN_EPS, **kw)
        self.gen1 = nn.Linear((3 if use_feature else 2) * d, d, **kw)
        self.gen2 = nn.Linear(d, v, bias=False, **kw)
        self.mix = nn.Linear((1 + num_memories) * d, num_memories + 1, **kw)

    @property
    def decs(self) -> List[Decoder]:
        return [getattr(self, f"dec{i}") for i in range(self.num_memories)]

    @property
    def attns(self) -> List[BilinearAttention]:
        return [getattr(self, f"attn{i}") for i in range(self.num_memories)]

    # ---- shared per-position math ----

    def _generator_parts(self, dec_input, dec_normed, feature, gen=None):
        """(pre-softmax hidden h [.., d], vocabulary logits [.., V])."""
        parts = [dec_input, dec_normed]
        if self.use_feature:
            parts.append(feature)
        h = self.gen1(torch.cat(parts, dim=-1))
        if self.use_feature:   # CaSE has a dropout inside the generator
            h = dropout(h, self.dropout, gen)
        return h, self.gen2(h)

    def _memory_attend(self, i, stream, feature, memory, mem_keep, weight,
                       tgt_keep, uh=None):
        """Prior-weighted renormalized copy attention for memory i.
        stream: [B, T, D]; returns (context [B, T, D], p [B, T, Lm]).
        ``uh``: the precomputed key projection (decoding), or None."""
        q = torch.cat([stream, feature], -1) if self.use_feature else stream
        mask = tgt_keep[:, :, None] & mem_keep[:, None, :]
        if uh is None:
            uh = self.attns[i].key_proj(memory)
        ctx, _, nw = self.attns[i].attend_from_proj(q, uh, memory, mask=mask)
        p = weight[:, None, :] * nw
        p = p / (1e-8 + p.sum(dim=-1, keepdim=True))
        return ctx, p

    # ---- training ----

    def teacher_force(self, memories: Sequence[torch.Tensor],
                      mem_keeps: Sequence[torch.Tensor],
                      weights: Sequence[torch.Tensor],
                      src_ids: Sequence[torch.Tensor],
                      targets: torch.Tensor,
                      feature: Optional[torch.Tensor] = None,
                      gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """prob_at_target [B, T]: the copy-extended probability of each
        target token, the decoder fed the shifted targets. ``gen``: the
        dropout generator (None = deterministic)."""
        b, t = targets.shape
        bos = torch.full((b, 1), self.bos_id, dtype=targets.dtype,
                         device=targets.device)
        inputs = torch.cat([bos, targets[:, :-1]], dim=1)
        tgt_keep = inputs != 0
        dec_input = self.pos(self.embedding(inputs), gen=gen)
        feat = None
        if self.use_feature:
            feat = self.norm2(feature)[:, None, :].expand(b, t, -1)
            feat = dropout(feat, self.dropout, gen)
        x = dec_input
        ctxs, ps = [], []
        for i in range(self.num_memories):
            x = self.decs[i](x, memories[i], tgt_keep, mem_keeps[i], gen)
            ctx, p = self._memory_attend(i, x, feat, memories[i], mem_keeps[i],
                                         weights[i], tgt_keep)
            ctxs.append(ctx)
            ps.append(p)
        x = self.norm1(x)
        gen_p = torch.softmax(
            self._generator_parts(dec_input, x, feat, gen)[1], dim=-1)
        mix_p = torch.softmax(self.mix(torch.cat([x] + ctxs, dim=-1)), dim=-1)
        prob_at = mix_p[..., 0] * torch.gather(gen_p, -1,
                                               targets[..., None])[..., 0]
        for i in range(self.num_memories):
            match = (src_ids[i][:, None, :] == targets[:, :, None]).to(
                ps[i].dtype)
            copy_at = torch.einsum("btl,btl->bt", ps[i], match)
            prob_at = prob_at + mix_p[..., i + 1] * copy_at
        return prob_at

    # ---- decode machinery ----

    def _fused_stack(self, memory: torch.Tensor) -> bool:
        """Whether this memory's stack decodes through the fused stack
        step (kernels/decoder_stack.py)."""
        if _FUSED_STACK is not None:
            return bool(_FUSED_STACK)
        return memory.dtype == torch.bfloat16 and memory.shape[1] >= _FUSED_MIN_L

    def _decode_precompute(self, memories, feature):
        """Per-sequence precomputes: per-stack cross K/V (or, for fused
        stacks, the folded weight dict: the kernel reads the raw memory),
        copy-attention key projections, and the normed feature vector."""
        cross = [fold_stack_weights(self.decs[i], self.num_layers,
                                    self.num_heads, memories[i].dtype)
                 if self._fused_stack(memories[i])
                 else self.decs[i].precompute_memory(memories[i])
                 for i in range(self.num_memories)]
        key_projs = [self.attns[i].key_proj(memories[i])
                     for i in range(self.num_memories)]
        feat = self.norm2(feature)[:, None, :] if self.use_feature else None
        return cross, key_projs, feat

    def _init_caches(self, b, max_len, memories):
        """Per-stack KV caches: per-layer [B, T, 2E] lists for the layer
        chain, one batch-leading [B, n_layers, T, 2E] tensor for fused
        stacks."""
        return [torch.zeros(b, self.num_layers, max_len, 2 * self.hidden_size,
                            dtype=m.dtype, device=m.device)
                if self._fused_stack(m)
                else self.decs[i].init_cache(b, max_len, m.dtype, m.device)
                for i, m in enumerate(memories)]

    def _step_core(self, caches, prev, hist, t, cross, key_projs, feat,
                   memories, mem_keeps, weights):
        """One decode step through the stacks, copy attentions, generator
        and mix gate. ``t`` is an int (or [B] per-row positions). Caches and
        ``hist`` are updated in place. Returns (gen [B,1,V], mix_p
        [B,1,M+1], ps: per-memory copy probs [B,1,Lm])."""
        write_step(hist, (prev != 0)[:, None], t)
        emb = self.pos(self.embedding(prev[:, None]), offset=t)
        x = emb
        ctxs, ps = [], []
        tgt_keep_t = (prev != 0)[:, None]
        for i in range(self.num_memories):
            if isinstance(cross[i], dict):   # fused stack: folded weights
                y, _ = stack_step(x[:, 0], t, caches[i], memories[i],
                                  mem_keeps[i], hist, cross[i], self.num_heads)
                x = y[:, None, :]
            else:
                x, _ = self.decs[i].step(x, t, caches[i], cross[i], hist,
                                         mem_keeps[i])
            ctx, p = self._memory_attend(i, x, feat, memories[i],
                                         mem_keeps[i], weights[i],
                                         tgt_keep_t, key_projs[i])
            ctxs.append(ctx)
            ps.append(p)
        x = self.norm1(x)
        _, gen_logits = self._generator_parts(emb, x, feat)
        gen = softmax(gen_logits, dim=-1)
        mix_p = softmax(self.mix(torch.cat([x] + ctxs, dim=-1)), dim=-1)
        return gen, mix_p, ps

    def _extend_dist(self, gen, mix_p, ps, src_ids):
        """Copy-extended distribution."""
        dist = mix_p[..., 0:1] * gen
        for i in range(self.num_memories):
            dist = dist + mix_p[..., i + 1:i + 2] * copy_scatter(
                ps[i], src_ids[i], self.vocab_size)
        return dist

    def _greedy_next(self, gen, mix_p, ps, src_ids) -> torch.Tensor:
        """Dense argmax over the copy-extended distribution. Returns [B]."""
        dist = self._extend_dist(gen, mix_p, ps, src_ids)
        return dist[:, 0].argmax(dim=-1)

    def decode(self, memories: Sequence[torch.Tensor],
               mem_keeps: Sequence[torch.Tensor],
               weights: Sequence[torch.Tensor],
               src_ids: Sequence[torch.Tensor], max_len: int,
               feature: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Greedy decoding: argmax over the extended distribution for
        ``max_len`` steps, no EOS bookkeeping (ref CaSE/Model.py:119-123).
        Returns [B, max_len] int32."""
        b = memories[0].shape[0]
        dev = memories[0].device
        cross, key_projs, feat = self._decode_precompute(memories, feature)
        caches = self._init_caches(b, max_len, memories)
        prev = torch.full((b,), self.bos_id, dtype=torch.long, device=dev)
        hist = torch.zeros(b, max_len, dtype=torch.bool, device=dev)
        out = []
        for t in range(max_len):
            gen, mix_p, ps = self._step_core(caches, prev, hist, t, cross,
                                             key_projs, feat, memories,
                                             mem_keeps, weights)
            prev = self._greedy_next(gen, mix_p, ps, src_ids)
            out.append(prev)
        return torch.stack(out, dim=1).to(torch.int32)
