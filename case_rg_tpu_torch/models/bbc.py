"""Background-context (BBC) GRU decoder core shared by S2SA and GTTP (port of
``case_rg_tpu/models/bbc.py``): per step, additive attention from the
previous decoder state over the context and background encodings, a GRU
cell over [embedded, src_context, bg_context], and a readout feature."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..ops.bilinear import BilinearAttention
from ..ops.dropout import dropout
from ..ops.embedding import Embedding
from ..ops.gru import GRU


class BBCCore(nn.Module):
    def __init__(self, vocab_size: int, embedding_size: int, hidden_size: int,
                 num_layers: int = 1, dropout: float = 0.5, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        e, h = embedding_size, hidden_size
        self.dropout = dropout
        self.embedding = Embedding(vocab_size, e, **kw)
        self.src_attn = BilinearAttention(h, 2 * h, h, **kw)
        self.bg_attn = BilinearAttention(h, 2 * h, h, **kw)
        self.gru = GRU(4 * h + e, h, num_layers=num_layers, **kw)
        self.readout = nn.Linear(4 * h + e + h, h, **kw)

    def embed(self, ids: torch.Tensor,
              gen: Optional[torch.Generator] = None) -> torch.Tensor:
        return dropout(self.embedding(ids), self.dropout, gen)

    def key_projs(self, src_out: torch.Tensor, bg_out: torch.Tensor):
        """The attention key projections of the fixed encodings, hoisted
        out of the decode and teacher-forcing loops."""
        return self.src_attn.key_proj(src_out), self.bg_attn.key_proj(bg_out)

    def step(self, emb: torch.Tensor, state: torch.Tensor,
             src_out: torch.Tensor, bg_out: torch.Tensor,
             src_keep: torch.Tensor, bg_keep: torch.Tensor,
             src_uh: Optional[torch.Tensor] = None,
             bg_uh: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor]:
        """emb: [B, E] (dropout already applied); state: [B, layers, H].
        Returns (feature [B, H], new state, src_attn [B, Lc], bg_attn
        [B, Lb])."""
        q = state[:, -1:]                               # [B, 1, H]
        if src_uh is None or bg_uh is None:
            src_uh, bg_uh = self.key_projs(src_out, bg_out)
        src_ctx, _, src_w = self.src_attn.attend_from_proj(
            q, src_uh, src_out, mask=src_keep[:, None, :])
        bg_ctx, _, bg_w = self.bg_attn.attend_from_proj(
            q, bg_uh, bg_out, mask=bg_keep[:, None, :])
        src_ctx, bg_ctx = src_ctx[:, 0], bg_ctx[:, 0]
        gru_in = torch.cat([emb, src_ctx, bg_ctx], dim=-1)
        _, state = self.gru.step(gru_in, state)
        concat = torch.cat([emb, state[:, -1], src_ctx, bg_ctx], dim=-1)
        return self.readout(concat), state, src_w[:, 0], bg_w[:, 0]


class BBCEncoders(nn.Module):
    """Context and background bi-GRU encoders over one shared embedding."""

    def __init__(self, vocab_size: int, embedding_size: int, hidden_size: int,
                 dropout: float = 0.5, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        e, h = embedding_size, hidden_size
        self.dropout = dropout
        self.embedding = Embedding(vocab_size, e, **kw)
        self.c_enc = GRU(e, h, bidirectional=True, **kw)
        self.b_enc = GRU(e, h, bidirectional=True, **kw)
        self.enc2dec = nn.Linear(2 * h, h, **kw)

    def forward(self, context: torch.Tensor, background: torch.Tensor,
                gen: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        c_keep, b_keep = context != 0, background != 0
        c_emb = dropout(self.embedding(context), self.dropout, gen)
        b_emb = dropout(self.embedding(background), self.dropout, gen)
        c_out, c_state = self.c_enc(c_emb, c_keep)
        b_out, _ = self.b_enc(b_emb, b_keep)
        init = self.enc2dec(c_state.reshape(context.shape[0], -1))[:, None]
        return {"c_out": c_out, "b_out": b_out, "c_keep": c_keep,
                "b_keep": b_keep, "init_state": init}
