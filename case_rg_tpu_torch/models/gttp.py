"""GTTP: the Get-To-The-Point pointer-generator over background passages
(port of ``case_rg_tpu/models/gttp.py``). The copy mixture is a
scatter-add of the background attention onto the background's token ids
(``ops/copynet``); training gathers the target's probability directly, so
the extended distribution is never held whole. ``decode_step_fast`` feeds
the candidate argmax of ``decode.loops.run_greedy_copy`` (through the
``combine_copy_mass`` kernel on the card)."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..config import ModelConfig
from ..kernels.copy_argmax import gather_weight_columns
from ..ops.copynet import copy_scatter
from ..ops.masking import neg_inf, softmax
from .base import nll_from_probs
from .bbc import BBCCore, BBCEncoders


def mask_pad_logit(logits: torch.Tensor) -> torch.Tensor:
    """``logits`` with the PAD column (id 0) at -1e20 (a fill with a
    scalar: a traced ``while_loop`` body may hold no tensor constant)."""
    out = logits.clone()
    out[:, 0].fill_(neg_inf(logits.dtype))
    return out


class GTTPModel(nn.Module):
    STEP_EMITS_PROBS = True   # decode_step returns the normalized mixture

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        c = cfg
        self.cfg = cfg
        self.encoders = BBCEncoders(c.vocab_size, c.embedding_size,
                                    c.hidden_size, dropout=c.gru_dropout, **kw)
        self.dec = BBCCore(c.vocab_size, c.embedding_size, c.hidden_size,
                           num_layers=1, dropout=c.gru_dropout, **kw)
        self.gen_linear = nn.Linear(c.hidden_size, c.vocab_size, **kw)
        self.copy_linear = nn.Linear(c.hidden_size, 1, **kw)

    def encode(self, batch, gen: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
        enc = self.encoders(batch["context"], batch["background"], gen)
        enc["background"] = batch["background"]
        enc["src_uh"], enc["bg_uh"] = self.dec.key_projs(enc["c_out"],
                                                         enc["b_out"])
        return enc

    def _core(self, enc, state, emb):
        return self.dec.step(emb, state, enc["c_out"], enc["b_out"],
                             enc["c_keep"], enc["b_keep"], enc["src_uh"],
                             enc["bg_uh"])

    def _gen_logits_and_gate(self, feature):
        """(PAD-masked vocabulary logits [B, V], p_copy [B, 1])."""
        return (mask_pad_logit(self.gen_linear(feature)),
                torch.sigmoid(self.copy_linear(feature)))

    def _vocab_and_copy(self, feature):
        """(vocabulary softmax scaled by 1 - p_copy, p_copy)."""
        logits, p_copy = self._gen_logits_and_gate(feature)
        return softmax(logits, dim=-1) * (1.0 - p_copy), p_copy

    def decode_step(self, enc, state, prev_ids):
        """(mixture probabilities over V [B, V], new state)."""
        feature, state, _, bg_attn = self._core(enc, state,
                                                self.dec.embed(prev_ids))
        out_prob, p_copy = self._vocab_and_copy(feature)
        copied = copy_scatter(bg_attn, enc["background"], self.cfg.vocab_size)
        return out_prob + copied * p_copy, state

    def decode_step_parts(self, enc, state, prev_ids):
        """(vocabulary mass [B, V], copy mass [B, Lb], state) with the
        distribution = vocab + scatter_add(copy, background): the math the
        fast step rests on."""
        feature, state, _, bg_attn = self._core(enc, state,
                                                self.dec.embed(prev_ids))
        out_prob, p_copy = self._vocab_and_copy(feature)
        return out_prob, bg_attn * p_copy, state

    def prepare_fast_decode(self, enc):
        """The generator's weight rows and biases at the background ids,
        gathered once a batch."""
        w_at, b_at = gather_weight_columns(self.gen_linear.weight,
                                           enc["background"],
                                           self.gen_linear.bias)
        return {"w_at": w_at, "b_at": b_at}

    def decode_step_fast(self, enc, fast, state, prev_ids):
        """(logits [B, V], logits at the background ids [B, Lb], vocabulary
        gate [B, 1], copy mass [B, Lb], state) for
        ``candidate_argmax_from_logits``."""
        feature, state, _, bg_attn = self._core(enc, state,
                                                self.dec.embed(prev_ids))
        logits, p_copy = self._gen_logits_and_gate(feature)
        w_at = fast["w_at"]
        l_at = torch.einsum("bld,bd->bl", w_at,
                            feature.to(w_at.dtype)) + fast["b_at"]
        l_at = torch.where(enc["background"] == 0, torch.full(
            (), neg_inf(l_at.dtype), dtype=l_at.dtype, device=l_at.device),
            l_at)
        return logits, l_at, 1.0 - p_copy, bg_attn * p_copy, state

    def train_losses(self, batch, gen: Optional[torch.Generator] = None
                     ) -> Dict[str, torch.Tensor]:
        """{"mle"}: the NLL of the mixture at the gold tokens."""
        resp = batch["response"]
        b, t = resp.shape
        bos = torch.full((b, 1), self.cfg.bos_id, dtype=resp.dtype,
                         device=resp.device)
        embs = self.dec.embed(torch.cat([bos, resp[:, :-1]], dim=1), gen)
        enc = self.encode(batch, gen)
        state = enc["init_state"]
        prob_at = []
        for i in range(t):
            feature, state, _, bg_attn = self._core(enc, state, embs[:, i])
            out_prob, p_copy = self._vocab_and_copy(feature)
            resp_t = resp[:, i:i + 1]
            vocab_at = out_prob.gather(-1, resp_t.long())[:, 0]
            match = (batch["background"] == resp_t).to(bg_attn.dtype)
            copy_at = (bg_attn * match).sum(-1) * p_copy[:, 0]
            prob_at.append(vocab_at + copy_at)
        return {"mle": nll_from_probs(torch.stack(prob_at, dim=1), resp,
                                      batch.get("sample_weight"))}
