"""CaSE — the paper model: relevant passage selection, supporting token
identification, and copy-augmented response generation (port of
``case_rg_tpu/models/case.py``).

The three stages share one 3-layer transformer encoder; the decoder is the
2-memory copy decoder with the answer-vector feature. ``train_losses`` gives
the three training losses; with a dropout generator ``gen`` every dropout
site is live (training), with None the losses are deterministic.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..config import ModelConfig
from ..decode.loops import keys_from_seed
from ..ops.masking import padding_mask
from .base import bce_with_logits, nll_from_probs, one_hot_labels
from .components import TransformerSeqEncoder
from .multimem import MultiMemoryDecoder
from .towers import InteractionTower

_LN_EPS = 1e-5


class CaSEModel(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        c = cfg
        self.cfg = cfg
        d = c.hidden_size
        self.encoder = TransformerSeqEncoder(c.enc_layers, c.num_heads,
                                             c.vocab_size, d, c.dropout, **kw)
        self.ps_tower = InteractionTower(d, c.num_heads, query_blocks=3,
                                         passage_blocks=5, dropout=c.dropout,
                                         **kw)
        self.ps_scorer = nn.Linear(d, 1, **kw)
        self.sti_tower = InteractionTower(d, c.num_heads, query_blocks=2,
                                          passage_blocks=3, dropout=c.dropout,
                                          **kw)
        self.sti_scorer = nn.Linear(d, 1, **kw)
        self.sti_norm_q = nn.LayerNorm(d, eps=_LN_EPS, **kw)
        self.sti_norm_p = nn.LayerNorm(d, eps=_LN_EPS, **kw)
        self.decoder = MultiMemoryDecoder(
            c.vocab_size, d, c.num_heads, c.dec_layers, num_memories=2,
            use_feature=True, dropout=c.dropout, bos_id=c.bos_id,
            eos_id=c.eos_id, **kw)

    def _encode_select(self, batch, gen=None):
        q_ids, p_ids = batch["query"], batch["passage"]
        q_keep, p_keep = padding_mask(q_ids), padding_mask(p_ids)
        enc_q, _ = self.encoder(q_ids, gen)
        enc_p, _ = self.encoder(p_ids, gen)
        q1, p1 = self.ps_tower(enc_q, enc_p, q_keep, p_keep, gen)
        passage_score = self.ps_scorer(p1[:, :, 0])[..., 0]      # [B, P]
        return q1, p1, q_keep, p_keep, passage_score

    def stages(self, batch, gen: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
        """Encode + passage selection + token identification. Returns
        passage_score [B, P], token_score [B, P, Lp], and the updated reps
        feeding generation."""
        q1, p1, q_keep, p_keep, passage_score = self._encode_select(batch,
                                                                    gen)
        q2, p2 = self.sti_tower(q1, p1, q_keep, p_keep, gen)
        token_score = self.sti_scorer(p2)[..., 0]                # [B, P, Lp]
        token_score = torch.where(p_keep, token_score, torch.full(
            (), -1e6, dtype=token_score.dtype, device=token_score.device))
        token_score = token_score.clamp(-1e6, 1e6)
        return {"passage_score": passage_score, "token_score": token_score,
                "q_reps": self.sti_norm_q(q1 + q2),
                "p_reps": self.sti_norm_p(p1 + p2),
                "q_keep": q_keep, "p_keep": p_keep}

    def _decoder_inputs(self, batch, st):
        """Prior construction + answer vector (ref: ResponseGeneration.action,
        CaSE/Model.py:230-253)."""
        b = batch["query"].shape[0]
        d = self.cfg.hidden_size
        prior_p = (torch.sigmoid(st["passage_score"])[:, :, None]
                   * torch.sigmoid(st["token_score"]))         # [B, P, Lp]
        flat = prior_p.reshape(b, -1)
        flat = flat / (1e-8 + flat.sum(dim=-1, keepdim=True))
        p_flat = st["p_reps"].reshape(b, -1, d)
        answer_rep = torch.einsum("bl,bld->bd", flat, p_flat)

        q_ids = batch["query"][:, 0]
        p_ids = batch["passage"].reshape(b, -1)
        memories = [st["q_reps"].reshape(b, -1, d), p_flat]
        keeps = [q_ids != 0, p_ids != 0]
        prior_q = torch.ones(q_ids.shape, dtype=torch.float32,
                             device=q_ids.device)
        return memories, keeps, [prior_q, flat], [q_ids, p_ids], answer_rep

    def train_losses(self, batch, gen: Optional[torch.Generator] = None
                     ) -> Dict[str, torch.Tensor]:
        """{"select", "token", "gen"} losses (ref: CaSE/Model.py:273-311
        do_train). ``batch`` holds query, passage, response,
        passage_label, token_label, token_weight and optionally
        sample_weight."""
        w = batch.get("sample_weight")
        st = self.stages(batch, gen)
        label_1h = one_hot_labels(batch["passage_label"],
                                  st["passage_score"].shape[-1])
        loss_ps = bce_with_logits(st["passage_score"], label_1h, w)

        # weighted token BCE (CaSE/Model.py:290-293)
        ts, lab = st["token_score"], batch["token_label"]
        per = ts.clamp_min(0) - ts * lab + torch.log1p(torch.exp(-ts.abs()))
        mask = st["p_keep"].float()
        if w is not None:
            mask = mask * w.float()[:, None, None]
        loss_se = (mask * per * batch["token_weight"]).sum() / \
            mask.sum().clamp_min(1.0)

        memories, keeps, weights, src_ids, answer_rep = \
            self._decoder_inputs(batch, st)
        prob_at = self.decoder.teacher_force(
            memories, keeps, weights, src_ids, batch["response"],
            feature=answer_rep, gen=gen)
        loss_rg = nll_from_probs(prob_at, batch["response"], w)
        return {"select": loss_ps, "token": loss_se, "gen": loss_rg}

    def rank(self, batch) -> torch.Tensor:
        """Passage scores only (rank-only serving): encoder + selection
        tower, without the token tower and the decoder."""
        return self._encode_select(batch)[-1]

    def predict(self, batch, *, max_len: int, early_exit: bool = False,
                fast_argmax=None, beam_width: int = 1,
                sample_keys: Optional[torch.Tensor] = None,
                sample_seed: Optional[int] = None,
                temperature: float = 1.0, top_k: int = 0,
                top_p: float = 1.0) -> Dict[str, torch.Tensor]:
        """Response generation plus pool scores (ref: CaSE/Model.py:313-331
        do_test). Greedy by default (``early_exit`` and ``fast_argmax`` as
        on ``MultiMemoryDecoder.decode``); ``beam_width > 1``: beam search;
        categorical sampling (beyond the reference) when ``sample_keys``
        ([B, 2] per-row keys) or ``sample_seed`` (derives them:
        ``decode.loops.keys_from_seed``) is given, the keys first, with the
        temperature/top_k/top_p controls."""
        st = self.stages(batch)
        memories, keeps, weights, src_ids, answer_rep = \
            self._decoder_inputs(batch, st)
        if sample_seed is not None and sample_keys is None:
            sample_keys = keys_from_seed(sample_seed, memories[0].shape[0])
        if sample_keys is not None:
            if beam_width > 1:
                raise ValueError("sampling and beam_width > 1 exclude each "
                                 "other (pick one decode strategy)")
            ids = self.decoder.sample(memories, keeps, weights, src_ids,
                                      max_len, sample_keys, feature=answer_rep,
                                      unk_id=self.cfg.unk_id,
                                      temperature=temperature, top_k=top_k,
                                      top_p=top_p)
        elif beam_width > 1:
            ids = self.decoder.beam(memories, keeps, weights, src_ids,
                                    max_len, beam_width, feature=answer_rep)
        else:
            ids = self.decoder.decode(memories, keeps, weights, src_ids,
                                      max_len, feature=answer_rep,
                                      early_exit=early_exit,
                                      fast_argmax=fast_argmax)
        return {"answer": ids, "rank": st["passage_score"]}

    # ---- continuous-batching serving (runtime/continuous): encode + the
    #      per-row decode state, advanced in chunks with rows refilled
    #      mid-flight; each request's answer is the one ``predict`` gives ----

    def decode_init(self, batch, *, max_len: int, fast_argmax=None):
        """(state, rank): the chunk-decode state of this batch and its pool
        scores. ``batch["response_cap"]`` [B], if present, caps each row's
        answer; ``batch["sample_key"]`` [B, 2] and ``batch["sample_ctl"]``
        [B, 3], if present, are the rows' sampling keys and controls
        (``MultiMemoryDecoder.chunk_init``)."""
        st = self.stages(batch)
        memories, keeps, weights, src_ids, answer_rep = \
            self._decoder_inputs(batch, st)
        state = self.decoder.chunk_init(memories, keeps, weights, src_ids,
                                        max_len, feature=answer_rep,
                                        fast_argmax=fast_argmax,
                                        row_max=batch.get("response_cap"),
                                        row_keys=batch.get("sample_key"),
                                        row_ctl=batch.get("sample_ctl"))
        return state, st["passage_score"]

    def decode_chunk(self, state, *, n_steps: int, fast_argmax=None,
                     sampling: bool = False, temperature: float = 1.0,
                     top_k: int = 0, top_p: float = 1.0):
        return self.decoder.chunk_step(state, n_steps,
                                       fast_argmax=fast_argmax,
                                       sampling=sampling,
                                       unk_id=self.cfg.unk_id,
                                       temperature=temperature, top_k=top_k,
                                       top_p=top_p)
