"""S2SA: GRU seq2seq with attention over context and background (port of
``case_rg_tpu/models/s2sa.py``). Training runs the teacher-forced decode
as a loop over the target; inference goes through the step protocol of
``models/predict.py`` (``encode`` + ``decode_step``)."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..config import ModelConfig
from .base import batch_mean
from .bbc import BBCCore, BBCEncoders


class S2SAModel(nn.Module):
    # The reference's generate() ignores its softmax flag and hands RAW
    # logits to the beam's -log(p + 1e-10) cost; beam_predict keeps that.
    BEAM_RAW_SCORES = True

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        c = cfg
        self.cfg = cfg
        self.encoders = BBCEncoders(c.vocab_size, c.embedding_size,
                                    c.hidden_size, dropout=c.gru_dropout, **kw)
        self.dec = BBCCore(c.vocab_size, c.embedding_size, c.hidden_size,
                           num_layers=1, dropout=c.gru_dropout, **kw)
        self.gen = nn.Linear(c.hidden_size, c.vocab_size, **kw)

    def encode(self, batch, gen: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
        enc = self.encoders(batch["context"], batch["background"], gen)
        enc["src_uh"], enc["bg_uh"] = self.dec.key_projs(enc["c_out"],
                                                         enc["b_out"])
        return enc

    def decode_step(self, enc, state, prev_ids):
        """One step: (logits [B, V], new state)."""
        feature, state, _, _ = self.dec.step(
            self.dec.embed(prev_ids), state, enc["c_out"], enc["b_out"],
            enc["c_keep"], enc["b_keep"], enc["src_uh"], enc["bg_uh"])
        return self.gen(feature), state

    def train_losses(self, batch, gen: Optional[torch.Generator] = None
                     ) -> Dict[str, torch.Tensor]:
        """{"mle"}: the teacher-forced cross entropy over non-PAD targets;
        each step's target log-probability is taken inside the loop, so the
        [B, T, V] logits are never held whole."""
        resp = batch["response"]
        b, t = resp.shape
        bos = torch.full((b, 1), self.cfg.bos_id, dtype=resp.dtype,
                         device=resp.device)
        embs = self.dec.embed(torch.cat([bos, resp[:, :-1]], dim=1), gen)
        enc = self.encode(batch, gen)
        state = enc["init_state"]
        logp = []
        for i in range(t):
            feature, state, _, _ = self.dec.step(
                embs[:, i], state, enc["c_out"], enc["b_out"], enc["c_keep"],
                enc["b_keep"], enc["src_uh"], enc["bg_uh"])
            logits = self.gen(feature)
            logp.append(logits.gather(-1, resp[:, i:i + 1].long())[:, 0]
                        - torch.logsumexp(logits, dim=-1))
        logp = torch.stack(logp, dim=1)                 # [B, T]
        w = batch.get("sample_weight")
        w = torch.ones(b, device=resp.device) if w is None else w.float()
        tok_w = (resp != 0).float() * w[:, None]
        return {"mle": -batch_mean((logp * tok_w).sum(), tok_w.sum())}
