"""Pre-norm transformer encoder/decoder layers and stacks (port of
``case_rg_tpu/ops/transformer.py``).

The residual is taken around the *normalized* stream, as in the reference::

    src = norm1(src); src = src + drop(attn(src))
    src = norm2(src); src = src + drop(ffn(src))

Training runs the decoder teacher-forced over the whole target (``forward``,
causal self-attention); decoding runs one ``step`` at a time against a
packed K|V cache per layer ([B, T_max, 2E]) written in place at step ``t``.
Every ``gen`` argument is the dropout generator: None (the default) is
deterministic.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .attention import MultiHeadAttention
from .cache import write_step
from .dropout import dropout
from .masking import causal_mask

_LN_EPS = 1e-5  # torch LayerNorm default


class FeedForward(nn.Module):
    """linear1 -> exact-erf GELU (or ReLU) -> dropout -> linear2."""

    def __init__(self, d_model: int, d_ff: int, dropout: float = 0.0,
                 activation: str = "gelu", *, device=None, dtype=None):
        super().__init__()
        self.activation = activation
        self.dropout = dropout
        self.linear1 = nn.Linear(d_model, d_ff, device=device, dtype=dtype)
        self.linear2 = nn.Linear(d_ff, d_model, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.linear1(x)
        h = F.gelu(h) if self.activation == "gelu" else F.relu(h)
        return self.linear2(dropout(h, self.dropout, gen))


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, d_ff: int,
                 dropout: float = 0.0, activation: str = "gelu", *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.dropout = dropout
        self.norm1 = nn.LayerNorm(d_model, eps=_LN_EPS, **kw)
        self.self_attn = MultiHeadAttention(d_model, num_heads, dropout, **kw)
        self.norm2 = nn.LayerNorm(d_model, eps=_LN_EPS, **kw)
        self.ffn = FeedForward(d_model, d_ff, dropout, activation, **kw)

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.norm1(x)
        a, _ = self.self_attn(x, x, x, key_keep=keep, gen=gen)
        x = self.norm2(x + dropout(a, self.dropout, gen))
        return x + dropout(self.ffn(x, gen), self.dropout, gen)


class Encoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, num_heads: int,
                 d_ff: int, dropout: float = 0.0, activation: str = "gelu", *,
                 device=None, dtype=None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer{i}", EncoderLayer(
                d_model, num_heads, d_ff, dropout, activation, device=device,
                dtype=dtype))

    @property
    def layers(self) -> List[EncoderLayer]:
        return [getattr(self, f"layer{i}") for i in range(self.num_layers)]

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x, keep, gen)
        return x


class DecoderLayer(nn.Module):
    """Self-attn + cross-attn + FFN: teacher-forced (``forward``) or stepped
    one token at a time (``step``)."""

    def __init__(self, d_model: int, num_heads: int, d_ff: int,
                 dropout: float = 0.0, activation: str = "gelu", *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.d_model = d_model
        self.dropout = dropout
        self.norm1 = nn.LayerNorm(d_model, eps=_LN_EPS, **kw)
        self.norm2 = nn.LayerNorm(d_model, eps=_LN_EPS, **kw)
        self.norm3 = nn.LayerNorm(d_model, eps=_LN_EPS, **kw)
        self.self_attn = MultiHeadAttention(d_model, num_heads, dropout, **kw)
        self.cross_attn = MultiHeadAttention(d_model, num_heads, dropout, **kw)
        self.ffn = FeedForward(d_model, d_ff, dropout, activation, **kw)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor,
                tgt_keep: Optional[torch.Tensor] = None,
                mem_keep: Optional[torch.Tensor] = None,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """Teacher-forced over the whole target [B, T, E]; the
        self-attention is causal (an additive bias, so it stays dense)."""
        bias = causal_mask(tgt.shape[1], tgt.dtype, tgt.device)
        drop = lambda x: dropout(x, self.dropout, gen)
        tgt = self.norm1(tgt)
        a, _ = self.self_attn(tgt, tgt, tgt, attn_bias=bias,
                              key_keep=tgt_keep, gen=gen)
        tgt = self.norm2(tgt + drop(a))
        c, _ = self.cross_attn(tgt, memory, memory, key_keep=mem_keep,
                               gen=gen)
        tgt = self.norm3(tgt + drop(c))
        return tgt + drop(self.ffn(tgt, gen))

    def precompute_memory(self, memory: torch.Tensor):
        """Project the encoder memory to K/V once per sequence."""
        return self.cross_attn.project_kv(memory)

    def step(self, x_t: torch.Tensor, t, cache: torch.Tensor,
             hist_keep: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
             mem_keep: Optional[torch.Tensor]):
        """One decode step. x_t: [B, 1, E]; ``cache``: packed K|V buffer
        [B, T_max, 2E], written in place at ``t`` (int, or [B] per-row);
        hist_keep: [B, T_max] True for valid positions *including* t.
        Returns (y_t, cache)."""
        e = self.d_model
        x = self.norm1(x_t)
        q, kv_t = self.self_attn.project_qkv(x)
        write_step(cache, kv_t, t)
        a, _ = self.self_attn.attend_with_kv_merged(
            q, cache[..., :e], cache[..., e:], key_keep=hist_keep,
            q_projected=True)
        x = self.norm2(x + a)   # residual around the normalized stream
        c, _ = self.cross_attn.attend_with_kv_merged(x, ck, cv,
                                                     key_keep=mem_keep)
        x = self.norm3(x + c)
        return x + self.ffn(x), cache


class Decoder(nn.Module):
    """Stack of decoder layers over one memory."""

    def __init__(self, num_layers: int, d_model: int, num_heads: int,
                 d_ff: int, dropout: float = 0.0, activation: str = "gelu", *,
                 device=None, dtype=None):
        super().__init__()
        self.num_layers = num_layers
        self.d_model = d_model
        for i in range(num_layers):
            self.add_module(f"layer{i}", DecoderLayer(
                d_model, num_heads, d_ff, dropout, activation, device=device,
                dtype=dtype))

    @property
    def layers(self) -> List[DecoderLayer]:
        return [getattr(self, f"layer{i}") for i in range(self.num_layers)]

    def forward(self, tgt, memory, tgt_keep=None, mem_keep=None, gen=None):
        """Teacher-forced pass of the stack over the target [B, T, E]."""
        for layer in self.layers:
            tgt = layer(tgt, memory, tgt_keep, mem_keep, gen)
        return tgt

    def precompute_memory(self, memory: torch.Tensor
                          ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        return [layer.precompute_memory(memory) for layer in self.layers]

    def init_cache(self, batch: int, max_len: int, dtype=torch.float32,
                   device=None) -> List[torch.Tensor]:
        """One packed K|V buffer [B, T_max, 2E] per layer."""
        return [torch.zeros(batch, max_len, 2 * self.d_model, dtype=dtype,
                            device=device) for _ in range(self.num_layers)]

    def step(self, x_t, t, cache, cross_kv, hist_keep, mem_keep):
        """x_t: [B, 1, E]; cache: list of packed K|V buffers per layer;
        cross_kv: list of (ck, cv) per layer. Returns (y_t, cache)."""
        for layer, c, (ck, cv) in zip(self.layers, cache, cross_kv):
            x_t, _ = layer.step(x_t, t, c, hist_keep, ck, cv, mem_keep)
        return x_t, cache
