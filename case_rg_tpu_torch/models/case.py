"""CaSE — the paper model: relevant passage selection, supporting token
identification, and copy-augmented response generation (port of
``case_rg_tpu/models/case.py``).

The three stages share one 3-layer transformer encoder; the decoder is the
2-memory copy decoder with the answer-vector feature. ``train_losses`` gives
the three training losses; with a dropout generator ``gen`` every dropout
site is live (training), with None the losses are deterministic.

``PooledCaSE`` is CaSE over a device group: each row's passage pool split
M ways for testing and serving (the JAX package's pool sharding over the
'model' axis of ``local_mesh``, ``runtime/mesh.local_groups``).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import torch
from torch import nn

from ..config import ModelConfig
from ..decode.loops import keys_from_seed
from ..ops.masking import padding_mask
from ..runtime.mesh import POOL_TRAINING_ITEM, split_pool
from .base import (batch_mean, bce_with_logits, nll_from_probs,
                   one_hot_labels)
from .components import TransformerSeqEncoder
from .multimem import MultiMemoryDecoder
from .towers import InteractionTower

_LN_EPS = 1e-5
_NO_POOL_TRAINING = (f"training over a pool group is not ported yet "
                     f"({POOL_TRAINING_ITEM})")


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
        return {"passage_score": passage_score,
                "token_score": self._token_score(p2, p_keep),
                "q_reps": self.sti_norm_q(q1 + q2),
                "p_reps": self.sti_norm_p(p1 + p2),
                "q_keep": q_keep, "p_keep": p_keep}

    def _token_score(self, p2, p_keep):
        token_score = self.sti_scorer(p2)[..., 0]                # [B, P, Lp]
        token_score = torch.where(p_keep, token_score, torch.full(
            (), -1e6, dtype=token_score.dtype, device=token_score.device))
        return token_score.clamp(-1e6, 1e6)

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
        loss_se = batch_mean((mask * per * batch["token_weight"]).sum(),
                             mask.sum())

        memories, keeps, weights, src_ids, answer_rep = \
            self._decoder_inputs(batch, st)
        prob_at = self.decoder.teacher_force(
            memories, keeps, weights, src_ids, batch["response"],
            feature=answer_rep, gen=gen)
        loss_rg = nll_from_probs(prob_at, batch["response"], w)
        return {"select": loss_ps, "token": loss_se, "gen": loss_rg}

    def over_pool(self, shards: Sequence["CaSEModel"], devices
                  ) -> "PooledCaSE":
        """This model over a device group: ``shards[j]`` is its copy on
        ``devices[j]`` (``shards[0]`` is this model)."""
        return PooledCaSE(shards, devices)

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


class PooledCaSE(CaSEModel):
    """CaSE over a device group of M devices (a replica of
    ``runtime/replicas.Replicas``): each row's passage pool split M ways
    for ``rank``, ``predict`` and ``decode_init``/``decode_chunk`` (the
    JAX package shards ``POOL_AXIS_KEYS`` over the 'model' axis and lets
    GSPMD place the joins; here they are explicit).

    * The query side (its encoder, each tower's query blocks) runs once, on
      the group's first device, and its reps are copied to each shard's.
    * Shard j (``shards[j]``, the model's copy on ``devices[j]``) runs the
      per-passage work on passages [j*P/M, (j+1)*P/M) of every row: the
      encoder, each tower's interaction and passage blocks, both scorers
      and the passage-side LayerNorm.
    * Three joins run on the first device, each exact or in the unsplit
      order: the Interaction's max-pool over passages (a maximum over the
      shards' maxima, ``Interaction.join``); the concatenation of the
      passage scores, token scores and passage reps along the pool axis;
      and, over the joined tensors, the prior's normalisation, the answer
      vector and the decode memory of all P*Lp tokens (``_decoder_inputs``,
      unchanged).
    * The decode (greedy, beam, sampling, the chunked decode) runs on the
      first device over the joined memory, with the first model's decoder.

    Devices may repeat (``cpu,cpu``, ``cuda:0,cuda:0``): a group on one
    device runs the split there with one model. Work for different cards
    is issued from the calling thread without waiting on either card; the
    copies between cards order themselves on the cards' current streams.
    Training over a group is refused (``runtime/mesh.POOL_TRAINING_ITEM``).
    The module's parameters are the first model's: ``Replicas.sync``
    copies new weights into the shards' copies."""

    def __init__(self, shards: Sequence[CaSEModel], devices):
        nn.Module.__init__(self)
        if len(shards) != len(devices) or len(shards) < 2:
            raise ValueError(f"a pool group needs a model on each of its 2 "
                             f"or more devices; got {len(shards)} models "
                             f"for {len(devices)} devices")
        first = shards[0]
        self.cfg = first.cfg
        for name, mod in first.named_children():
            self.add_module(name, mod)
        # not submodules: the shards' copies are reached through the group
        self.shards: List[CaSEModel] = list(shards)
        self.devices = [torch.device(d) for d in devices]

    def train_losses(self, batch, gen=None):
        raise NotImplementedError(_NO_POOL_TRAINING)

    def _pool_sides(self, batch):
        """The query side on the first device and each shard's passages:
        (q_ids' keep mask, the encoded query, [(shard model, device,
        passage keep mask, encoded passages)])."""
        q_keep = padding_mask(batch["query"])
        enc_q, _ = self.encoder(batch["query"])
        shards = []
        for model, dev, part in zip(self.shards, self.devices,
                                    split_pool(batch, len(self.devices))):
            p_ids = part["passage"].to(dev, non_blocking=True)
            enc_p, _ = model.encoder(p_ids)
            shards.append((model, dev, padding_mask(p_ids), enc_p))
        return q_keep, enc_q, shards

    def _tower(self, name: str, q, q_keep, shards, reps):
        """One tower over the group: each shard's ``pool_side`` on the
        query reps ``q`` (copied to its device) and its passage reps
        ``reps[j]``, then the joined query side on the first device.
        Returns (query reps, [each shard's passage reps])."""
        qs, ps = [], []
        for (model, dev, p_keep, _), r in zip(shards, reps):
            g, p = getattr(model, name).pool_side(
                q.to(dev, non_blocking=True), r,
                q_keep.to(dev, non_blocking=True), p_keep)
            qs.append(g)
            ps.append(p)
        dev0 = q_keep.device
        return getattr(self, name).query_side(
            [g.to(dev0, non_blocking=True) for g in qs], q_keep), ps

    @staticmethod
    def _cat(parts):
        """Shards' tensors joined along the pool axis on the first's device."""
        dev0 = parts[0].device
        return torch.cat([x.to(dev0, non_blocking=True) for x in parts], 1)

    def _split_select(self, batch) -> "_Selected":
        """The encoder and the selection tower over the group, and the
        passage scores joined."""
        q_keep, enc_q, shards = self._pool_sides(batch)
        q1, p1 = self._tower("ps_tower", enc_q, q_keep, shards,
                             [s[3] for s in shards])
        passage_score = self._cat([m.ps_scorer(p[:, :, 0])[..., 0]
                                   for (m, *_), p in zip(shards, p1)])
        return _Selected(q1, q_keep, shards, p1, passage_score)

    def rank(self, batch) -> torch.Tensor:
        return self._split_select(batch).passage_score

    def stages(self, batch, gen=None) -> Dict[str, torch.Tensor]:
        if gen is not None:
            raise NotImplementedError(_NO_POOL_TRAINING)
        sel = self._split_select(batch)
        q2, p2 = self._tower("sti_tower", sel.q1, sel.q_keep, sel.shards,
                             sel.p1)
        token_score, p_reps = [], []
        for (model, _, p_keep, _), a, b in zip(sel.shards, sel.p1, p2):
            token_score.append(model._token_score(b, p_keep))
            p_reps.append(model.sti_norm_p(a + b))
        return {"passage_score": sel.passage_score,
                "token_score": self._cat(token_score),
                "q_reps": self.sti_norm_q(sel.q1 + q2),
                "p_reps": self._cat(p_reps),
                "q_keep": sel.q_keep,
                "p_keep": padding_mask(batch["passage"])}


class _Selected(NamedTuple):
    """``PooledCaSE._split_select``'s parts: the query reps after the
    selection tower and their keep mask on the group's first device; each
    shard's (model, device, passage keep mask, encoded passages) and its
    passage reps after the tower; the joined passage scores [B, P]."""
    q1: torch.Tensor
    q_keep: torch.Tensor
    shards: list
    p1: list
    passage_score: torch.Tensor
