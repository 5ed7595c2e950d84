"""Masque: passage selection and multi-memory copy generation (port of
``case_rg_tpu/models/masque.py``). A shared 3-layer transformer encoder, the
interaction ranking tower, and the 2-memory copy decoder without the
answer-vector feature (``models/multimem.py``). The passages' prior weights
are sigmoid(score) repeated over each passage's positions, and 1 over the
query memory. ``train_losses(mode="ps_train")`` trains the ranker alone."""

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


class MasqueModel(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        c = cfg
        d = c.hidden_size
        self.cfg = cfg
        self.encoder = TransformerSeqEncoder(c.enc_layers, c.num_heads,
                                             c.vocab_size, d, c.dropout, **kw)
        self.tower = InteractionTower(d, c.num_heads, query_blocks=3,
                                      passage_blocks=5, dropout=c.dropout,
                                      **kw)
        self.scorer = nn.Linear(d, 1, **kw)
        self.decoder = MultiMemoryDecoder(
            c.vocab_size, d, c.num_heads, c.dec_layers, num_memories=2,
            use_feature=False, dropout=c.dropout, bos_id=c.bos_id,
            eos_id=c.eos_id, **kw)

    def _select(self, batch, gen=None):
        """(passage scores [B, P], query reps, passage reps)."""
        q_ids, p_ids = batch["query"], batch["passage"]
        enc_q, _ = self.encoder(q_ids, gen)
        enc_p, _ = self.encoder(p_ids, gen)
        q_reps, p_reps = self.tower(enc_q, enc_p, padding_mask(q_ids),
                                    padding_mask(p_ids), gen)
        score = self.scorer(p_reps[:, :, 0])[..., 0]     # CLS position
        return score, q_reps, p_reps

    def _decoder_inputs(self, batch, score, q_reps, p_reps):
        b = batch["query"].shape[0]
        d = self.cfg.hidden_size
        q_ids = batch["query"][:, 0]                     # [B, Lq]
        p_ids = batch["passage"].reshape(b, -1)          # [B, P*Lp]
        memories = [q_reps.reshape(b, -1, d), p_reps.reshape(b, -1, d)]
        prior_q = torch.ones(q_ids.shape, dtype=torch.float32,
                             device=q_ids.device)
        prior_p = torch.sigmoid(score).repeat_interleave(
            batch["passage"].shape[2], dim=-1)
        return (memories, [q_ids != 0, p_ids != 0], [prior_q, prior_p],
                [q_ids, p_ids])

    def train_losses(self, batch, gen: Optional[torch.Generator] = None,
                     mode: str = "train") -> Dict[str, torch.Tensor]:
        """{"select": 0.25 x the passage BCE, "gen": the copy decoder's
        NLL}; with ``mode="ps_train"`` {"select": the unscaled BCE}
        alone."""
        w = batch.get("sample_weight")
        score, q_reps, p_reps = self._select(batch, gen)
        label_1h = one_hot_labels(batch["passage_label"], score.shape[-1])
        loss_ps = bce_with_logits(score, label_1h, w)
        if mode == "ps_train":
            return {"select": loss_ps}
        memories, keeps, weights, src_ids = self._decoder_inputs(
            batch, score, q_reps, p_reps)
        prob_at = self.decoder.teacher_force(memories, keeps, weights,
                                             src_ids, batch["response"],
                                             gen=gen)
        loss_rg = nll_from_probs(prob_at, batch["response"], w)
        return {"select": 0.25 * loss_ps, "gen": loss_rg}

    def over_pool(self, shards, devices):
        """Refused: Masque's batches carry a passage pool too, but its split
        is not ported yet (the JAX package's GSPMD shards it)."""
        from ..runtime.mesh import POOL_MODELS_ITEM
        raise ValueError(f"--pool_shard: Masque's pool split is not ported "
                         f"yet ({POOL_MODELS_ITEM}); serve it without "
                         f"--pool_shard")

    def rank(self, batch) -> torch.Tensor:
        """Passage scores only (rank-only serving): the encoder and the
        tower, without the decoder."""
        return self._select(batch)[0]

    def predict(self, batch, *, max_len: int, early_exit: bool = False,
                fast_argmax=None, beam_width: int = 1,
                sample_keys: Optional[torch.Tensor] = None,
                sample_seed: Optional[int] = None,
                temperature: float = 1.0, top_k: int = 0,
                top_p: float = 1.0) -> Dict[str, torch.Tensor]:
        """Answers and pool scores, with ``CaSEModel.predict``'s decode
        strategies and arguments."""
        score, q_reps, p_reps = self._select(batch)
        memories, keeps, weights, src_ids = self._decoder_inputs(
            batch, score, q_reps, p_reps)
        if sample_seed is not None and sample_keys is None:
            sample_keys = keys_from_seed(sample_seed, memories[0].shape[0])
        if sample_keys is not None:
            if beam_width > 1:
                raise ValueError("sampling and beam_width > 1 exclude each "
                                 "other (pick one decode strategy)")
            ids = self.decoder.sample(memories, keeps, weights, src_ids,
                                      max_len, sample_keys,
                                      unk_id=self.cfg.unk_id,
                                      temperature=temperature, top_k=top_k,
                                      top_p=top_p)
        elif beam_width > 1:
            ids = self.decoder.beam(memories, keeps, weights, src_ids,
                                    max_len, beam_width)
        else:
            ids = self.decoder.decode(memories, keeps, weights, src_ids,
                                      max_len, early_exit=early_exit,
                                      fast_argmax=fast_argmax)
        return {"answer": ids, "rank": score}

    # ---- continuous-batching serving (runtime/continuous) ----

    def decode_init(self, batch, *, max_len: int, fast_argmax=None):
        """(chunk-decode state, pool scores), as ``CaSEModel.decode_init``."""
        score, q_reps, p_reps = self._select(batch)
        memories, keeps, weights, src_ids = self._decoder_inputs(
            batch, score, q_reps, p_reps)
        state = self.decoder.chunk_init(memories, keeps, weights, src_ids,
                                        max_len, fast_argmax=fast_argmax,
                                        row_max=batch.get("response_cap"),
                                        row_keys=batch.get("sample_key"),
                                        row_ctl=batch.get("sample_ctl"))
        return state, score

    def decode_chunk(self, state, *, n_steps: int, fast_argmax=None,
                     sampling: bool = False, temperature: float = 1.0,
                     top_k: int = 0, top_p: float = 1.0):
        return self.decoder.chunk_step(state, n_steps,
                                       fast_argmax=fast_argmax,
                                       sampling=sampling,
                                       unk_id=self.cfg.unk_id,
                                       temperature=temperature, top_k=top_k,
                                       top_p=top_p)
