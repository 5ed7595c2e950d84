"""GLKS: Global-to-Local Knowledge Selection (port of
``case_rg_tpu/models/glks.py``).

* one-layer bi-GRU encoders with embedding dropout for the background and
  the context (``components.GRUSeqEncoder``);
* ``KnowledgeSelector``: a highway-transformed matching matrix, its
  per-token max, and sliding-window segment attention pooled by the
  context state (windows gathered by an index matrix);
* the state tracker GRU, the copy and vocabulary generators and the
  sigmoid mixture;
* losses chosen by substrings of ``mode``: "mle", "mce" and "ds"
  (the default ``ds_mle_mce_train``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..config import ModelConfig
from ..kernels.copy_argmax import gather_weight_columns
from ..ops.bilinear import BilinearAttention
from ..ops.copynet import copy_scatter
from ..ops.dropout import dropout
from ..ops.embedding import Embedding
from ..ops.gru import GRU
from ..ops.highway import Highway
from ..ops.masking import masked_softmax, neg_inf, softmax
from .components import GRUSeqEncoder


def _window_index(length: int, size: int, step: int, device) -> torch.Tensor:
    """[n_w, size] positions of the windows of ``size`` every ``step``."""
    n = max((length - size) // step + 1, 0)
    starts = torch.arange(n, device=device) * step
    return starts[:, None] + torch.arange(size, device=device)[None, :]


class KnowledgeSelector(nn.Module):
    def __init__(self, hidden_size: int, min_window_size: int = 5,
                 n_windows: int = 4, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        h = hidden_size
        self.min_window_size = min_window_size
        self.n_windows = n_windows
        self.b_highway = Highway(2 * h, 2 * h, num_layers=2, **kw)
        self.c_highway = Highway(2 * h, 2 * h, num_layers=2, **kw)
        self.match_attn = BilinearAttention(2 * h, 2 * h, 2 * h, **kw)
        self.area_attn = BilinearAttention(h, h, h, **kw)

    def match(self, b_out, c_out, c_state, b_keep, c_keep) -> torch.Tensor:
        """Each background token's best matching score over the context
        [B, Lb]; c_state: [B, 1, H]."""
        lb, lc = b_out.shape[1], c_out.shape[1]
        b_h = self.b_highway(torch.cat(
            [b_out, c_state.expand(-1, lb, -1)], dim=-1))
        c_h = self.c_highway(torch.cat(
            [c_out, c_state.expand(-1, lc, -1)], dim=-1))
        m = self.match_attn.matching_from_proj(
            b_h, self.match_attn.key_proj(c_h))             # [B, Lb, Lc]
        m = torch.where(c_keep[:, None, :], m, torch.full(
            (), neg_inf(m.dtype), dtype=m.dtype, device=m.device))
        m = torch.where(b_keep[:, :, None], m,
                        torch.zeros((), dtype=m.dtype, device=m.device))
        return m.amax(dim=-1)

    def segments(self, b_out, b_score, c_state
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Window pooling: (segments [B, W, H], window scores [B, W])."""
        segs, scores = [], []
        size = self.min_window_size
        for _ in range(self.n_windows):
            idx = _window_index(b_out.shape[1], size, self.min_window_size,
                                b_out.device)
            windows = b_out[:, idx]                          # [B, n_w, ws, H]
            ctx, _, _ = self.area_attn(c_state[:, None, None, :], windows,
                                       windows)
            segs.append(ctx[:, :, 0])
            scores.append(b_score[:, idx].sum(dim=-1))
            size += self.min_window_size
        return torch.cat(segs, dim=1), torch.cat(scores, dim=1)

    def forward(self, b_out, c_out, c_state_1, b_keep, c_keep):
        """c_state_1: [B, 1, H]. Returns (segment [B, 1, H], p_s [B, W],
        b_score [B, Lb])."""
        b_score = self.match(b_out, c_out, c_state_1, b_keep, c_keep)
        segs, s_score = self.segments(b_out, b_score, c_state_1[:, 0])
        p_s = softmax(s_score, dim=-1)
        segment = torch.einsum("bw,bwh->bh", p_s, segs)[:, None, :]
        return segment, p_s, b_score


class GLKSModel(nn.Module):
    STEP_EMITS_PROBS = True

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        c = cfg
        e, h, v = c.embedding_size, c.hidden_size, c.vocab_size
        self.cfg = cfg
        self.b_encoder = GRUSeqEncoder(1, v, e, h, dropout=0.5,
                                       share_embedding_per_layer=False, **kw)
        self.c_encoder = GRUSeqEncoder(1, v, e, h, dropout=0.5,
                                       share_embedding_per_layer=False, **kw)
        self.embedding = Embedding(v, e, **kw)
        self.k_selector = KnowledgeSelector(h, c.min_window_size,
                                            c.num_windows, **kw)
        # the state tracker
        self.st_linear = nn.Linear(2 * h, h, **kw)
        self.st_gru = GRU(e, h, num_layers=1, **kw)
        # the copy generator
        self.copy_attn = BilinearAttention(e + 2 * h, h, h, **kw)
        # the vocabulary generator
        self.vg_c_attn = BilinearAttention(e + 2 * h, h, h, **kw)
        self.vg_b_attn = BilinearAttention(e + 2 * h, h, h, **kw)
        self.vg_readout = nn.Linear(e + 4 * h, h, **kw)
        self.vg_generator = nn.Linear(h, v, **kw)
        # the mixture
        self.mix_linear = nn.Linear(h, 1, **kw)

    def _embed(self, ids, gen=None):
        return dropout(self.embedding(ids), 0.5, gen)

    def encode(self, batch, gen: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
        b_ids, c_ids = batch["background"], batch["context"]
        b_outs, _ = self.b_encoder(b_ids, gen)
        c_outs, c_states = self.c_encoder(c_ids, gen)
        b_out, c_out = b_outs[:, -1], c_outs[:, -1]
        c_state = c_states[:, -1][:, None, :]
        b_keep, c_keep = b_ids != 0, c_ids != 0
        segment, p_s, _ = self.k_selector(b_out, c_out, c_state, b_keep,
                                          c_keep)
        init_state = self.st_linear(torch.cat([c_state, segment], dim=-1))
        return {"b_out": b_out, "c_out": c_out, "b_keep": b_keep,
                "c_keep": c_keep, "segment": segment, "p_s": p_s,
                "background": b_ids, "init_state": init_state,
                # key projections hoisted out of the decode and training
                # loops
                "copy_b_uh": self.copy_attn.key_proj(b_out),
                "vg_c_uh": self.vg_c_attn.key_proj(c_out),
                "vg_b_uh": self.vg_b_attn.key_proj(b_out)}

    def _generate_core(self, word_emb, state, enc):
        """(vocabulary logits [B, V], the readout r [B, H] that feeds the
        generator, copy attention p_k [B, Lb], mixture gate p_mix [B, 1])."""
        seg = enc["segment"]
        q = torch.cat([word_emb, state, seg], dim=-1)         # [B, 1, E+2H]
        p_k = masked_softmax(
            self.copy_attn.matching_from_proj(q, enc["copy_b_uh"]),
            enc["b_keep"][:, None, :])[:, 0]
        c_ctx, _, _ = self.vg_c_attn.attend_from_proj(
            q, enc["vg_c_uh"], enc["c_out"], mask=enc["c_keep"][:, None, :])
        b_ctx, _, _ = self.vg_b_attn.attend_from_proj(
            q, enc["vg_b_uh"], enc["b_out"], mask=enc["b_keep"][:, None, :])
        r = self.vg_readout(torch.cat(
            [word_emb[:, 0], state[:, 0], seg[:, 0], c_ctx[:, 0],
             b_ctx[:, 0]], dim=-1))
        p_mix = torch.sigmoid(self.mix_linear(state[:, 0]))   # [B, 1]
        return self.vg_generator(r), r, p_k, p_mix

    def _generate(self, word_emb, state, enc) -> torch.Tensor:
        """The step's mixture distribution [B, V]."""
        logits, _, p_k, p_mix = self._generate_core(word_emb, state, enc)
        copied = copy_scatter(p_k, enc["background"], self.cfg.vocab_size)
        return p_mix * softmax(logits, dim=-1) + (1.0 - p_mix) * copied

    def _track(self, state, prev_ids):
        emb = self._embed(prev_ids)[:, None]
        _, state = self.st_gru.step(emb[:, 0], state)
        return emb, state

    def decode_step(self, enc, state, prev_ids):
        """state: [B, 1, H] (the one-layer tracker GRU)."""
        emb, state = self._track(state, prev_ids)
        return self._generate(emb, state, enc), state

    def decode_step_parts(self, enc, state, prev_ids):
        """(vocabulary mass [B, V], copy mass [B, Lb], state) with the
        distribution = vocab + scatter_add(copy, background)."""
        emb, state = self._track(state, prev_ids)
        logits, _, p_k, p_mix = self._generate_core(emb, state, enc)
        return p_mix * softmax(logits, dim=-1), (1.0 - p_mix) * p_k, state

    def prepare_fast_decode(self, enc):
        """The generator's weight rows and biases at the background ids,
        gathered once a batch."""
        w_at, b_at = gather_weight_columns(self.vg_generator.weight,
                                           enc["background"],
                                           self.vg_generator.bias)
        return {"w_at": w_at, "b_at": b_at}

    def decode_step_fast(self, enc, fast, state, prev_ids):
        """(logits [B, V], logits at the background ids [B, Lb], vocabulary
        gate [B, 1], copy mass [B, Lb], state) for
        ``candidate_argmax_from_logits``."""
        emb, state = self._track(state, prev_ids)
        logits, r, p_k, p_mix = self._generate_core(emb, state, enc)
        w_at = fast["w_at"]
        l_at = torch.einsum("bld,bd->bl", w_at, r.to(w_at.dtype)) \
            + fast["b_at"]
        return logits, l_at, p_mix, (1.0 - p_mix) * p_k, state

    def train_losses(self, batch, gen: Optional[torch.Generator] = None,
                     mode: str = "ds_mle_mce_train"
                     ) -> Dict[str, torch.Tensor]:
        """"mle": the NLL at the gold tokens; "mce": 1 - 0.1 x the mean
        entropy of the step distributions; "ds": the batch-mean KL of the
        gold window selection from p_s."""
        resp = batch["response"]
        b, t = resp.shape
        bos = torch.full((b, 1), self.cfg.bos_id, dtype=resp.dtype,
                         device=resp.device)
        embs = self._embed(torch.cat([bos, resp[:, :-1]], dim=1), gen)
        enc = self.encode(batch, gen)
        eps = 1e-10
        state = enc["init_state"]
        p_at, entropy = [], []
        for i in range(t):
            _, state = self.st_gru.step(embs[:, i], state)
            probs = self._generate(embs[:, i:i + 1], state, enc)
            p_at.append(probs.gather(-1, resp[:, i:i + 1].long())[:, 0])
            q = (probs + eps) / (probs + eps).sum(dim=-1, keepdim=True)
            entropy.append(-(q * torch.log(q)).sum(dim=-1))
        p_at, entropy = torch.stack(p_at, dim=1), torch.stack(entropy, dim=1)
        w = batch.get("sample_weight")
        w = torch.ones(b, device=resp.device) if w is None else w.float()
        losses: Dict[str, torch.Tensor] = {}
        if "mle" in mode:
            tok_w = (resp != 0).float() * w[:, None]
            losses["mle"] = -(torch.log(p_at + 1e-8) * tok_w).sum() / \
                tok_w.sum().clamp_min(1.0)
        if "mce" in mode:
            losses["mce"] = 1.0 - 0.1 * (entropy * w[:, None]).sum() / \
                (w.sum() * t).clamp_min(1.0)
        if "ds" in mode:
            p_s = enc["p_s"] + 1e-10
            target = batch["selection"] + 1e-10
            kl = (target * (torch.log(target) - torch.log(p_s))).sum(dim=-1)
            losses["ds"] = (kl * w).sum() / w.sum().clamp_min(1.0)
        return losses
