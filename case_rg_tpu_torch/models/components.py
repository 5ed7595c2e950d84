"""Shared encoder components (port of ``case_rg_tpu/models/components.py``):
``TransformerSeqEncoder`` (CaSE, Masque) and ``GRUSeqEncoder`` (GLKS)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.dropout import dropout
from ..ops.embedding import Embedding
from ..ops.gru import GRU
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


class GRUSeqEncoder(nn.Module):
    """n stacked one-layer bi-GRUs (H/2 a direction) where every layer after
    the first re-concatenates a freshly dropped-out embedding of the inputs
    (one shared embedding, or one a layer with
    ``share_embedding_per_layer=False``). Dropout on the embeddings when a
    generator is given."""

    def __init__(self, num_layers: int, vocab_size: int, embedding_size: int,
                 hidden_size: int, dropout: float = 0.5,
                 share_embedding_per_layer: bool = True, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.num_layers = num_layers
        self.dropout = dropout
        self.share = share_embedding_per_layer
        for i in range(1 if share_embedding_per_layer else num_layers):
            self.add_module(f"embedding{i}",
                            Embedding(vocab_size, embedding_size, **kw))
        for i in range(num_layers):
            in_size = embedding_size if i == 0 \
                else embedding_size + hidden_size
            self.add_module(f"gru{i}", GRU(in_size, hidden_size // 2,
                                           num_layers=1, bidirectional=True,
                                           **kw))

    def _emb(self, i: int, ids, gen):
        e = getattr(self, f"embedding{0 if self.share else i}")
        return dropout(e(ids), self.dropout, gen)

    def forward(self, ids: torch.Tensor,
                gen: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """ids: [B, L] -> (outputs [B, n_layers, L, H], states
        [B, n_layers, H])."""
        mask = padding_mask(ids)
        outs, states = [], []
        cur = self._emb(0, ids, gen)
        for i in range(self.num_layers):
            if i > 0:
                cur = torch.cat([cur, self._emb(i, ids, gen)], dim=-1)
            cur, st = getattr(self, f"gru{i}")(cur, mask)
            outs.append(cur)
            states.append(st.reshape(st.shape[0], -1))   # [B, 2*(H/2)]
        return torch.stack(outs, dim=1), torch.stack(states, dim=1)
