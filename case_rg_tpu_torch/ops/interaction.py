"""Dual (BiDAF-style) query<->passage interaction (port of
``case_rg_tpu/ops/interaction.py``).

The trilinear score is decomposed as
``U[l, m] = Ep[l].w_p + Eq[m].w_q + (Ep[l] * w_x).Eq[m]`` so the only
O(Lp*Lq) tensor is U itself. ``dual_att`` holds the reference's
``dual_att_linear`` weight [1, 3D] in the order [w_q; w_p; w_x].

With one query sequence against P passages the query side is max-pooled
over the passages. Over a device group (the pool axis, ``models/case.
PooledCaSE``) that pool is two steps: ``forward`` on each shard's passages
pools over them, and ``join`` takes the maximum over the shards' results.
A maximum is exact, so the two steps give the unsplit pool bit for bit.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch
from torch import nn

from .masking import masked_softmax


class Interaction(nn.Module):
    def __init__(self, hidden_size: int, *, device=None, dtype=None):
        super().__init__()
        self.dual_att = nn.Linear(3 * hidden_size, 1, bias=False,
                                  device=device, dtype=dtype)

    def forward(self, enc1: torch.Tensor, enc2: torch.Tensor,
                mask1: torch.Tensor, mask2: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """enc1 (query): [B, nq, Lq, D]; enc2 (passage): [B, np, Lp, D];
        masks bool [B, n, L]. Returns (G_p_q [B, nq, Lq, 5D],
        G_q_p [B, np, Lp, 5D])."""
        b, nq, lq, d = enc1.shape
        np_ = enc2.shape[1]
        w = self.dual_att.weight[0]
        w_q, w_p, w_x = w[:d], w[d:2 * d], w[2 * d:]
        if nq != np_:
            if nq != 1:
                raise ValueError("query side must have one sequence or match "
                                 "the passages")
            e_q = enc1.expand(b, np_, lq, d)
            m_q = mask1.expand(b, np_, lq)
        else:
            e_q, m_q = enc1, mask1
        e_p, m_p = enc2, mask2

        # U: [B, n, Lp, Lq]
        u = (torch.einsum("bnpd,d->bnp", e_p, w_p)[..., :, None]
             + torch.einsum("bnqd,d->bnq", e_q, w_q)[..., None, :]
             + torch.einsum("bnpd,bnqd->bnpq", e_p * w_x, e_q))
        pair_mask = m_p[..., :, None] & m_q[..., None, :]
        a_p = masked_softmax(u, pair_mask, dim=3)   # over query positions
        b_p = masked_softmax(u, pair_mask, dim=2)   # over passage positions

        a1 = torch.einsum("bnpq,bnqd->bnpd", a_p, e_q)
        b1 = torch.einsum("bnpq,bnpd->bnqd", b_p, e_p)
        a2 = torch.einsum("bnpq,bnqd->bnpd", a_p, b1)
        b2 = torch.einsum("bnpq,bnpd->bnqd", b_p, a1)

        zero = torch.zeros((), dtype=u.dtype, device=u.device)
        g_q_p = torch.where(m_p[..., None], torch.cat(
            [e_p, a1, a2, e_p * a1, e_p * a2], dim=-1), zero)
        g_p_q = torch.where(m_q[..., None], torch.cat(
            [e_q, b1, b2, e_q * b1, e_q * b2], dim=-1), zero)
        if nq != np_:
            g_p_q = g_p_q.amax(dim=1, keepdim=True)
        return g_p_q, g_q_p

    @staticmethod
    def join(parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The query side pooled over a whole pool from ``forward``'s query
        sides over its shards ([B, 1, Lq, 5D] each, on one device): their
        elementwise maximum."""
        return functools.reduce(torch.maximum, parts)
