"""Shared encoder components (port of ``case_rg_tpu/models/components.py``;
only ``TransformerSeqEncoder`` is on CaSE's path)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.embedding import Embedding
from ..ops.masking import masked_mean, padding_mask
from ..ops.positional import PositionalEmbedding
from ..ops.transformer import Encoder


class TransformerSeqEncoder(nn.Module):
    """Embed + sinusoidal PE + pre-norm encoder over [B, num_seq, L] ids,
    with masked-mean sequence states; dropout after the positional
    embedding and inside the encoder when a generator is given."""

    def __init__(self, num_layers: int, num_heads: int, vocab_size: int,
                 hidden_size: int, dropout: float = 0.0, max_len: int = 1000,
                 *, device=None, dtype=None):
        super().__init__()
        self.embedding = Embedding(vocab_size, hidden_size, device=device,
                                   dtype=dtype)
        self.pos = PositionalEmbedding(hidden_size, dropout, max_len=max_len,
                                       device=device)
        self.enc = Encoder(num_layers, hidden_size, num_heads, d_ff=hidden_size,
                           dropout=dropout, activation="gelu", device=device,
                           dtype=dtype)

    def forward(self, ids: torch.Tensor,
                gen: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """ids: [B, num_seq, L] -> (output [B, num_seq, L, D],
        state [B, num_seq, D])."""
        b, n, l = ids.shape
        flat = ids.reshape(b * n, l)
        keep = padding_mask(flat)
        out = self.enc(self.pos(self.embedding(flat), gen=gen), keep, gen)
        state = masked_mean(out, keep)
        return out.reshape(b, n, l, -1), state.reshape(b, n, -1)
