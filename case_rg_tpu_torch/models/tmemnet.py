"""TMemNet: the Transformer Memory Network (port of
``case_rg_tpu/models/tmemnet.py``). A shared 8-layer encoder over the
context and K passages, dot-product knowledge attention on sqrt-pooled,
scaled sentence embeddings, hard selection (the gold passage in training,
the argmax in inference), and an 8-layer decoder over [chosen knowledge ;
context], decoded step by step against packed K|V caches.

The decode state's position ``t`` is a Python int in one-shot decoding
(every row at the same step) and a [B, 1] tensor in continuous decoding,
where rows sit at their own positions (``models/predict.
continuous_decode_init`` makes it one)."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..config import ModelConfig
from ..ops.cache import write_step
from ..ops.embedding import Embedding
from ..ops.masking import masked_mean, padding_mask
from ..ops.positional import PositionalEmbedding, _scale
from ..ops.transformer import Decoder, Encoder
from .base import bce_with_logits, cross_entropy, one_hot_labels


class TMemNetModel(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        c = cfg
        h = c.hidden_size
        self.cfg = cfg
        self.enc_embedding = Embedding(c.vocab_size, c.embedding_size, **kw)
        self.enc_pos = PositionalEmbedding(c.embedding_size, c.dropout,
                                           max_len=5000, device=device)
        self.encoder = Encoder(c.tmemnet_layers, h, c.num_heads, d_ff=h,
                               dropout=c.dropout, activation="gelu", **kw)
        self.dec_embedding = Embedding(c.vocab_size, c.embedding_size, **kw)
        self.dec_pos = PositionalEmbedding(c.embedding_size, c.dropout,
                                           max_len=5000, device=device)
        self.decoder = Decoder(c.tmemnet_layers, h, c.num_heads, d_ff=h,
                               dropout=c.dropout, activation="gelu", **kw)
        self.gen = nn.Linear(h, c.vocab_size, **kw)

    def _knowledge(self, batch, gen=None):
        """(context encoding, its keep mask, passage encodings [B*K, Lp, H],
        their keep mask, knowledge attention ck_attn [B, K])."""
        c_ids, p_ids = batch["context"], batch["passage"]
        b, k, lp = p_ids.shape
        h = self.cfg.hidden_size
        c_keep = padding_mask(c_ids)
        ctx_enc = self.encoder(self.enc_pos(self.enc_embedding(c_ids),
                                            gen=gen), c_keep, gen)
        p_flat = p_ids.reshape(b * k, lp)
        p_keep = padding_mask(p_flat)
        know_enc = self.encoder(self.enc_pos(self.enc_embedding(p_flat),
                                             gen=gen), p_keep, gen)
        scale = _scale(h, ctx_enc.dtype)
        ctx_use = masked_mean(ctx_enc, c_keep, sqrt=True) / scale
        know_use = masked_mean(know_enc, p_keep, sqrt=True).reshape(
            b, k, h) / scale
        ck_attn = torch.einsum("bkh,bh->bk", know_use, ctx_use)
        return ctx_enc, c_keep, know_enc, p_keep, ck_attn

    def _memory(self, batch, label=None, gen=None):
        """(decoder memory [chosen passage ; context] [B, Lp+Lc, H], its
        keep mask, ck_attn): the gold passage when ``label`` is given, else
        the best-scored one."""
        ctx_enc, c_keep, know_enc, p_keep, ck_attn = self._knowledge(batch,
                                                                     gen)
        b, k, lp = batch["passage"].shape
        cs = ck_attn.argmax(dim=-1) if label is None else label.long()
        rows = torch.arange(b, device=cs.device)
        # a gold index past the pool (prepared with more candidates than
        # num_passage) selects NaNs and an all-True mask, as JAX's
        # take_along_axis fills it, instead of an out-of-range gather
        inside = (cs >= 0) & (cs < k)
        at = cs.clamp(0, k - 1)
        cs_enc = torch.where(inside[:, None, None],
                             know_enc.reshape(b, k, lp, -1)[rows, at],
                             torch.full((), float("nan"),
                                        dtype=know_enc.dtype,
                                        device=know_enc.device))
        cs_keep = p_keep.reshape(b, k, lp)[rows, at] | ~inside[:, None]
        return (torch.cat([cs_enc, ctx_enc], dim=1),
                torch.cat([cs_keep, c_keep], dim=1), ck_attn)

    def encode(self, batch, label: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
        """Everything the decode steps read, the per-layer cross K/V
        projected once, and the initial state (zero caches of
        ``max_dec_len + 1`` positions, an empty history, t = 0)."""
        memory, mem_keep, ck_attn = self._memory(batch, label)
        b, t_max = memory.shape[0], self.cfg.max_dec_len + 1
        init_state = {
            "cache": self.decoder.init_cache(b, t_max, memory.dtype,
                                             memory.device),
            "hist": torch.zeros(b, t_max, dtype=torch.bool,
                                device=memory.device),
            "t": 0,
        }
        return {"memory": memory, "mem_keep": mem_keep, "ck_attn": ck_attn,
                "cross_kv": self.decoder.precompute_memory(memory),
                "init_state": init_state}

    def decode_step(self, enc, state, prev_ids):
        """One cached decode step: (logits [B, V], new state). The cache and
        the history are written in place at ``state["t"]`` (an int, or [B,
        1] per-row positions, whose out-of-range rows write nothing)."""
        t = state["t"]
        t_now = t[:, 0] if isinstance(t, torch.Tensor) else t
        emb = self.dec_pos(self.dec_embedding(prev_ids[:, None]),
                           offset=t_now)
        hist = write_step(state["hist"], (prev_ids != 0)[:, None], t_now)
        y, cache = self.decoder.step(emb, t_now, state["cache"],
                                     enc["cross_kv"], hist, enc["mem_keep"])
        return self.gen(y[:, 0]), {"cache": cache, "hist": hist, "t": t + 1}

    def train_losses(self, batch, gen: Optional[torch.Generator] = None,
                     mode: str = "train") -> Dict[str, torch.Tensor]:
        """{"select": 0.25 x the knowledge BCE, "gen": the decoder's cross
        entropy}, the gold passage selected; ``mode="ps_train"``:
        {"select": the unscaled BCE} alone."""
        resp = batch["response"]
        b = resp.shape[0]
        w = batch.get("sample_weight")
        memory, mem_keep, ck_attn = self._memory(
            batch, batch["passage_label"], gen)
        label_1h = one_hot_labels(batch["passage_label"], ck_attn.shape[-1])
        if mode == "ps_train":
            return {"select": bce_with_logits(ck_attn, label_1h, w)}
        bos = torch.full((b, 1), self.cfg.bos_id, dtype=resp.dtype,
                         device=resp.device)
        tgt_in = torch.cat([bos, resp], dim=1)               # [B, T+1]
        tgt_out = torch.cat([resp, torch.zeros_like(bos)], dim=1)
        emb = self.dec_pos(self.dec_embedding(tgt_in), gen=gen)
        out = self.decoder(emb, memory, padding_mask(tgt_in), mem_keep, gen)
        return {"select": 0.25 * bce_with_logits(ck_attn, label_1h, w),
                "gen": cross_entropy(self.gen(out), tgt_out, w)}

    def over_pool(self, shards, devices):
        """Refused: TMemNet's batches carry a passage pool too, but its split
        is not ported yet (the JAX package's GSPMD shards it)."""
        from ..runtime.mesh import POOL_MODELS_ITEM
        raise ValueError(f"--pool_shard: TMemNet's pool split is not ported "
                         f"yet ({POOL_MODELS_ITEM}); serve it without "
                         f"--pool_shard")

    def rank(self, batch) -> torch.Tensor:
        """The knowledge attention [B, K] alone (no decoder memory)."""
        return self._knowledge(batch)[-1]
