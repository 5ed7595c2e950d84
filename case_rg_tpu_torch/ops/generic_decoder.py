"""Highway-gated multi-memory decoder layer (port of
``case_rg_tpu/ops/generic_decoder.py``).

``GenericTransformerDecoderLayer`` of the reference
(common/TransformerDecoder.py:95-164): self-attention and N chained memory
attentions, each fused into the stream with a Highway gate over
[stream ; dropout(attn_out)], followed by a residual FFN. No model builds
it, in the reference or in either package; it is part of the ops surface.
Parameter names are the JAX module's (``self_attn``, ``self_norm``,
``self_highway``, ``memory_attn{i}``, ``memory_norm{i}``,
``memory_highway{i}``, ``linear1``, ``linear2``), so ``bridge`` carries its
params across one for one. ``gen`` is the dropout generator: None (the
default) is deterministic.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .attention import MultiHeadAttention
from .dropout import dropout
from .highway import Highway
from .masking import causal_mask

_LN_EPS = 1e-5


class GenericDecoderLayer(nn.Module):
    def __init__(self, num_memories: int, d_model: int, num_heads: int,
                 d_ff: int, dropout: float = 0.1, activation: str = "gelu",
                 *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d = d_model
        self.num_memories = num_memories
        self.dropout = dropout
        self.activation = activation
        self.self_attn = MultiHeadAttention(d, num_heads, dropout, **kw)
        self.self_norm = nn.LayerNorm(d, eps=_LN_EPS, **kw)
        self.self_highway = Highway(2 * d, d, **kw)
        for i in range(num_memories):
            self.add_module(f"memory_attn{i}",
                            MultiHeadAttention(d, num_heads, dropout, **kw))
            self.add_module(f"memory_norm{i}",
                            nn.LayerNorm(d, eps=_LN_EPS, **kw))
            self.add_module(f"memory_highway{i}", Highway(2 * d, d, **kw))
        self.linear1 = nn.Linear(d, d_ff, **kw)
        self.linear2 = nn.Linear(d_ff, d, **kw)

    def forward(self, tgt: torch.Tensor, memories: Sequence[torch.Tensor],
                tgt_keep: Optional[torch.Tensor] = None,
                mem_keeps: Optional[Sequence[torch.Tensor]] = None, *,
                causal: bool = True,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        rate = self.dropout
        bias = causal_mask(tgt.shape[1], tgt.dtype, tgt.device) \
            if causal else None
        x = self.self_norm(tgt)
        a, _ = self.self_attn(x, x, x, attn_bias=bias, key_keep=tgt_keep,
                              gen=gen)
        x = self.self_highway(torch.cat([x, dropout(a, rate, gen)], dim=-1))
        for i in range(self.num_memories):
            x = getattr(self, f"memory_norm{i}")(x)
            mk = mem_keeps[i] if mem_keeps is not None else None
            a, _ = getattr(self, f"memory_attn{i}")(
                x, memories[i], memories[i], key_keep=mk, gen=gen)
            x = getattr(self, f"memory_highway{i}")(
                torch.cat([x, dropout(a, rate, gen)], dim=-1))
        h = self.linear1(x)
        h = F.gelu(h) if self.activation == "gelu" else F.relu(h)
        f = self.linear2(dropout(h, rate, gen))
        return x + dropout(f, rate, gen)
