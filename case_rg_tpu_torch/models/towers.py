"""Interaction ranking towers (port of ``case_rg_tpu/models/towers.py``):
dual query<->passage interaction producing 5D features, then a stack of
4-D transformer blocks (first block 5D -> D) over each side."""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from ..ops.blocks import TransformerBlock
from ..ops.interaction import Interaction


class InteractionTower(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, query_blocks: int,
                 passage_blocks: int, dropout: float = 0.0, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d, h = hidden_size, num_heads
        self.query_blocks = query_blocks
        self.passage_blocks = passage_blocks
        self.interaction = Interaction(d, **kw)
        for side, n in (("q", query_blocks), ("p", passage_blocks)):
            for i in range(n):
                self.add_module(f"{side}_block{i}", TransformerBlock(
                    h, 5 * d if i == 0 else d, d, dropout, **kw))

    def _blocks(self, side: str, n: int) -> List[TransformerBlock]:
        return [getattr(self, f"{side}_block{i}") for i in range(n)]

    def forward(self, enc_query: torch.Tensor, enc_passage: torch.Tensor,
                query_keep: torch.Tensor, passage_keep: torch.Tensor,
                gen: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """enc_query: [B, 1, Lq, D], enc_passage: [B, P, Lp, D] ->
        (query_reps [B, 1, Lq, D], passage_reps [B, P, Lp, D])."""
        q, p = self.interaction(enc_query, enc_passage, query_keep,
                                passage_keep)
        for blk in self._blocks("q", self.query_blocks):
            q = blk(q, query_keep, gen)
        for blk in self._blocks("p", self.passage_blocks):
            p = blk(p, passage_keep, gen)
        return q, p
