"""Multi-memory transformer decoder with copy extension (port of
``case_rg_tpu/models/multimem.py``: teacher forcing for training, greedy
decoding in one shot or in chunks with per-row progress for continuous
batching, the three argmax epilogues (the dense copy scatter, and the
candidate argmax with its duplicate-id combine by a batched product or by
the ``combine_copy_mass`` kernel), categorical sampling in one shot or in
chunks, and beam search).

M chained per-memory decoder stacks; the copy attention for memory i
queries the stream after stack i, before the final norm; per-memory copy
attention is prior-weighted and renormalized with the 1e-8 guard; the
``mix`` head splits probability mass between generation and the M copy
distributions. Training gathers the target's probability directly (no
[B, T, V_ext] copy tensor).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..decode.loops import (pick_by_uniform, run_beam, sample_uniforms,
                            sampling_controls, sampling_controls_rows,
                            tile_state, validate_controls)
from ..kernels import copy_argmax
from ..kernels.copy_argmax import gather_weight_columns
from ..kernels.decoder_stack import fold_stack_weights, stack_step
from ..ops.bilinear import BilinearAttention
from ..ops.cache import write_step
from ..ops.copynet import copy_scatter
from ..ops.dropout import dropout
from ..ops.embedding import Embedding
from ..ops.masking import softmax
from ..ops.positional import PositionalEmbedding
from ..ops.transformer import Decoder

_LN_EPS = 1e-5

# Fused decoder-stack decode step (kernels/decoder_stack.py): one kernel
# launch per stack per step instead of the per-layer chain, with the cross
# K/V caches folded away. None = auto (bf16 and memories of at least
# _FUSED_MIN_L positions), True = always, False = never.
_FUSED_STACK = None
# The JAX package's threshold, kept for this first slice; it is to be
# decided again by measurement on the H100.
_FUSED_MIN_L = 512


def set_fused_stack(on) -> None:
    """True=force, False=off, None=auto."""
    global _FUSED_STACK
    _FUSED_STACK = on


class MultiMemoryDecoder(nn.Module):
    def __init__(self, vocab_size: int, hidden_size: int, num_heads: int,
                 num_layers: int, num_memories: int = 2,
                 use_feature: bool = False, dropout: float = 0.0,
                 bos_id: int = 1, eos_id: int = 3, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        d, v = hidden_size, vocab_size
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_heads = num_heads
        self.num_layers = num_layers
        self.num_memories = num_memories
        self.use_feature = use_feature
        self.dropout = dropout
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.embedding = Embedding(v, d, **kw)
        self.pos = PositionalEmbedding(d, dropout, max_len=1000, device=device)
        q_size = 2 * d if use_feature else d
        for i in range(num_memories):
            self.add_module(f"dec{i}", Decoder(num_layers, d, num_heads,
                                               d_ff=d, dropout=dropout,
                                               activation="gelu", **kw))
            self.add_module(f"attn{i}", BilinearAttention(q_size, d, d, **kw))
        self.norm1 = nn.LayerNorm(d, eps=_LN_EPS, **kw)
        if use_feature:
            self.norm2 = nn.LayerNorm(d, eps=_LN_EPS, **kw)
        self.gen1 = nn.Linear((3 if use_feature else 2) * d, d, **kw)
        self.gen2 = nn.Linear(d, v, bias=False, **kw)
        self.mix = nn.Linear((1 + num_memories) * d, num_memories + 1, **kw)
        self._fold_cache: Dict[tuple, tuple] = {}

    @property
    def decs(self) -> List[Decoder]:
        return [getattr(self, f"dec{i}") for i in range(self.num_memories)]

    @property
    def attns(self) -> List[BilinearAttention]:
        return [getattr(self, f"attn{i}") for i in range(self.num_memories)]

    # ---- shared per-position math ----

    def _generator_parts(self, dec_input, dec_normed, feature, gen=None):
        """(pre-softmax hidden h [.., d], vocabulary logits [.., V])."""
        parts = [dec_input, dec_normed]
        if self.use_feature:
            parts.append(feature)
        h = self.gen1(torch.cat(parts, dim=-1))
        if self.use_feature:   # CaSE has a dropout inside the generator
            h = dropout(h, self.dropout, gen)
        return h, self.gen2(h)

    def _memory_attend(self, i, stream, feature, memory, mem_keep, weight,
                       tgt_keep, uh=None):
        """Prior-weighted renormalized copy attention for memory i.
        stream: [B, T, D]; returns (context [B, T, D], p [B, T, Lm]).
        ``uh``: the precomputed key projection (decoding), or None."""
        q = torch.cat([stream, feature], -1) if self.use_feature else stream
        mask = tgt_keep[:, :, None] & mem_keep[:, None, :]
        if uh is None:
            uh = self.attns[i].key_proj(memory)
        ctx, _, nw = self.attns[i].attend_from_proj(q, uh, memory, mask=mask)
        p = weight[:, None, :] * nw
        p = p / (1e-8 + p.sum(dim=-1, keepdim=True))
        return ctx, p

    # ---- training ----

    def teacher_force(self, memories: Sequence[torch.Tensor],
                      mem_keeps: Sequence[torch.Tensor],
                      weights: Sequence[torch.Tensor],
                      src_ids: Sequence[torch.Tensor],
                      targets: torch.Tensor,
                      feature: Optional[torch.Tensor] = None,
                      gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """prob_at_target [B, T]: the copy-extended probability of each
        target token, the decoder fed the shifted targets. ``gen``: the
        dropout generator (None = deterministic)."""
        b, t = targets.shape
        bos = torch.full((b, 1), self.bos_id, dtype=targets.dtype,
                         device=targets.device)
        inputs = torch.cat([bos, targets[:, :-1]], dim=1)
        tgt_keep = inputs != 0
        dec_input = self.pos(self.embedding(inputs), gen=gen)
        feat = None
        if self.use_feature:
            feat = self.norm2(feature)[:, None, :].expand(b, t, -1)
            feat = dropout(feat, self.dropout, gen)
        x = dec_input
        ctxs, ps = [], []
        for i in range(self.num_memories):
            x = self.decs[i](x, memories[i], tgt_keep, mem_keeps[i], gen)
            ctx, p = self._memory_attend(i, x, feat, memories[i], mem_keeps[i],
                                         weights[i], tgt_keep)
            ctxs.append(ctx)
            ps.append(p)
        x = self.norm1(x)
        gen_p = torch.softmax(
            self._generator_parts(dec_input, x, feat, gen)[1], dim=-1)
        mix_p = torch.softmax(self.mix(torch.cat([x] + ctxs, dim=-1)), dim=-1)
        prob_at = mix_p[..., 0] * torch.gather(gen_p, -1,
                                               targets[..., None])[..., 0]
        for i in range(self.num_memories):
            match = (src_ids[i][:, None, :] == targets[:, :, None]).to(
                ps[i].dtype)
            copy_at = torch.einsum("btl,btl->bt", ps[i], match)
            prob_at = prob_at + mix_p[..., i + 1] * copy_at
        return prob_at

    # ---- decode machinery ----

    def _fused_stack(self, memory: torch.Tensor) -> bool:
        """Whether this memory's stack decodes through the fused stack
        step (kernels/decoder_stack.py)."""
        if _FUSED_STACK is not None:
            return bool(_FUSED_STACK)
        return memory.dtype == torch.bfloat16 and memory.shape[1] >= _FUSED_MIN_L

    def _folded(self, i: int, dtype) -> Dict[str, torch.Tensor]:
        """Folded fused-stack operands of stack ``i`` ([n_layers, ...],
        derived from the parameters alone, so they never ride in the
        per-row decode state). Cached per dtype; the key holds each
        parameter's storage and version, so new weights fold again. While
        ``torch.export`` traces, the parameters are fake tensors without
        storage: the fold must already be cached (``runtime/exported``
        runs a live predict first), and the graph holds it as constants."""
        hit = self._fold_cache.get((i, dtype))
        if torch.compiler.is_exporting():
            if hit is None:
                raise RuntimeError("MultiMemoryDecoder: fold the stack "
                                   "weights (run a live predict) before "
                                   "torch.export traces the decoder")
            return hit[1]
        dec = self.decs[i]
        key = tuple((p.data_ptr(), p._version) for p in dec.parameters())
        if hit is None or hit[0] != key:
            hit = (key, fold_stack_weights(dec, self.num_layers,
                                           self.num_heads, dtype))
            self._fold_cache[(i, dtype)] = hit
        return hit[1]

    def _decode_precompute(self, memories, feature):
        """Per-sequence precomputes: per-stack cross K/V (or, for fused
        stacks, the folded weight dict: the kernel reads the raw memory),
        copy-attention key projections, and the normed feature vector."""
        cross = [self._folded(i, memories[i].dtype)
                 if self._fused_stack(memories[i])
                 else self.decs[i].precompute_memory(memories[i])
                 for i in range(self.num_memories)]
        key_projs = [self.attns[i].key_proj(memories[i])
                     for i in range(self.num_memories)]
        feat = self.norm2(feature)[:, None, :] if self.use_feature else None
        return cross, key_projs, feat

    def _init_caches(self, b, max_len, memories):
        """Per-stack KV caches: per-layer [B, T, 2E] lists for the layer
        chain, one batch-leading [B, n_layers, T, 2E] tensor for fused
        stacks."""
        return [torch.zeros(b, self.num_layers, max_len, 2 * self.hidden_size,
                            dtype=m.dtype, device=m.device)
                if self._fused_stack(m)
                else self.decs[i].init_cache(b, max_len, m.dtype, m.device)
                for i, m in enumerate(memories)]

    def _step_core(self, caches, prev, hist, t, cross, key_projs, feat,
                   memories, mem_keeps, weights):
        """One decode step through the stacks, copy attentions, generator
        and mix gate. ``t`` is an int (or [B] per-row positions). Caches and
        ``hist`` are updated in place. Returns (mix_p [B,1,M+1], ps:
        per-memory copy probs [B,1,Lm], gen_h [B,1,d], gen_logits [B,1,V]);
        the generator's softmax is left to the argmax modes that read it."""
        write_step(hist, (prev != 0)[:, None], t)
        emb = self.pos(self.embedding(prev[:, None]), offset=t)
        x = emb
        ctxs, ps = [], []
        tgt_keep_t = (prev != 0)[:, None]
        for i in range(self.num_memories):
            if isinstance(cross[i], dict):   # fused stack: folded weights
                y, _ = stack_step(x[:, 0], t, caches[i], memories[i],
                                  mem_keeps[i], hist, cross[i], self.num_heads)
                x = y[:, None, :]
            else:
                x, _ = self.decs[i].step(x, t, caches[i], cross[i], hist,
                                         mem_keeps[i])
            ctx, p = self._memory_attend(i, x, feat, memories[i],
                                         mem_keeps[i], weights[i],
                                         tgt_keep_t, key_projs[i])
            ctxs.append(ctx)
            ps.append(p)
        x = self.norm1(x)
        gen_h, gen_logits = self._generator_parts(emb, x, feat)
        mix_p = softmax(self.mix(torch.cat([x] + ctxs, dim=-1)), dim=-1)
        return mix_p, ps, gen_h, gen_logits

    def _extend_dist(self, gen, mix_p, ps, src_ids):
        """Copy-extended distribution."""
        dist = mix_p[..., 0:1] * gen
        for i in range(self.num_memories):
            dist = dist + mix_p[..., i + 1:i + 2] * copy_scatter(
                ps[i], src_ids[i], self.vocab_size)
        return dist

    @staticmethod
    def _resolve_fast_argmax(fast_argmax) -> Tuple[bool, bool]:
        """(fast_argmax, use_kernel_comb) for a ``fast_argmax`` mode, with
        the JAX package's mode names (its ``--fast_argmax`` values):

        * ``None``/"auto": dense, as the JAX package decided on the TPU (to
          be decided again from the H100's times of the three modes);
        * ``False``/"dense": the [B, V] copy scatter + argmax;
        * "mxu": the candidate argmax, duplicate-id copy mass combined by one
          batched product against a first-occurrence matrix built per batch;
        * "pallas" (or ``True``): the candidate argmax, the combine through
          ``kernels/copy_argmax.combine_copy_mass`` (the CUDA kernel on the
          card, its plain version on the CPU). Unlike the JAX package, it
          never quietly becomes "mxu"."""
        if isinstance(fast_argmax, str):
            mode = fast_argmax.lower()
            if mode not in ("auto", "dense", "mxu", "pallas"):
                raise ValueError(f"fast_argmax mode {fast_argmax!r} not in "
                                 "(auto, dense, mxu, pallas)")
            if mode == "mxu":
                return True, False
            return (True, True) if mode == "pallas" else (False, False)
        on = bool(fast_argmax)      # None (auto) stays dense
        return on, on

    def _argmax_precompute(self, src_ids, dtype, fast_argmax: bool,
                           use_kernel_comb: bool):
        """Step-invariant operands of the greedy argmax: the concatenated
        source ids [B, Ls], plus per-mode [B, ...] tensors (so they ride in
        the chunk-decode state and refill row by row)."""
        ids_cat = torch.cat(list(src_ids), dim=-1)
        extras = {}
        if use_kernel_comb:
            # the generator's weight rows at the source ids: per step, the
            # logits there are one [B, Ls, d] x [B, d] product instead of a
            # [B, V] gather
            extras["w_at"], _ = gather_weight_columns(self.gen2.weight,
                                                      ids_cat)
            extras["ids32"] = ids_cat.to(torch.int32)
        elif fast_argmax:
            # for each source position, the first position with the same id
            # (argmax returns the first maximum); comb_m[b, k, l] = 1 iff
            # the first occurrence of ids[b, l] is k
            ls = ids_cat.shape[1]
            eq = ids_cat[:, :, None] == ids_cat[:, None, :]
            first_occ = eq.to(torch.uint8).argmax(dim=-1)
            pos = torch.arange(ls, device=ids_cat.device)
            extras["comb_m"] = (first_occ[:, None, :]
                                == pos[None, :, None]).to(dtype)
            extras["is_first"] = first_occ == pos[None, :]
        return ids_cat, extras

    def _greedy_next(self, mix_p, ps, gen_h, gen_logits, src_ids,
                     ids_cat, extras, fast_argmax: bool,
                     use_kernel_comb: bool) -> torch.Tensor:
        """Argmax over the copy-extended distribution for one step (modes
        on ``_resolve_fast_argmax``). Returns [B] int32. The kernel mode
        rebuilds the softmax in f32 from the logits, so only the dense and
        mxu modes take the [B, V] softmax."""
        if not fast_argmax:
            dist = self._extend_dist(softmax(gen_logits, dim=-1), mix_p, ps,
                                     src_ids)
            return dist[:, 0].argmax(dim=-1).to(torch.int32)
        cw = torch.cat([mix_p[:, 0, i + 1:i + 2] * ps[i][:, 0]
                        for i in range(self.num_memories)], dim=-1)  # [B, Ls]
        if use_kernel_comb:
            w_at = extras["w_at"]
            l_at = torch.einsum("bld,bd->bl", w_at, gen_h[:, 0].to(w_at.dtype))
            return copy_argmax.candidate_argmax_from_logits(
                gen_logits[:, 0], l_at, mix_p[:, 0, 0], cw, extras["ids32"])
        gen = softmax(gen_logits, dim=-1)
        comb_m, is_first = extras["comb_m"], extras["is_first"]
        g = mix_p[:, 0, 0:1] * gen[:, 0]                 # [B, V]
        g_idx = g.argmax(dim=-1, keepdim=True)
        g_val = g.gather(-1, g_idx)[:, 0]
        g_at = g.gather(-1, ids_cat)
        comb = torch.einsum("bkl,bl->bk", comb_m, cw.to(comb_m.dtype))
        cand = g_at + comb
        cand = torch.where(is_first, cand,
                           torch.full((), -1.0, dtype=cand.dtype,
                                      device=cand.device))
        c_pos = cand.argmax(dim=-1, keepdim=True)
        c_val = cand.gather(-1, c_pos)[:, 0]
        c_idx = ids_cat.gather(-1, c_pos)[:, 0]
        return torch.where(c_val > g_val, c_idx, g_idx[:, 0]).to(torch.int32)

    def _sample_next(self, mix_p, ps, gen_logits, src_ids, u,
                     controls) -> torch.Tensor:
        """A draw from the copy-extended distribution for one step, at the
        rows' uniforms ``u`` [B]: the log of the distribution (+1e-10) in
        f32 under the sampling controls, ``controls`` either a
        (temperature, top_k, top_p) triple for every row or a [B, 3] f32
        tensor of per-row controls. Returns [B] int32."""
        dist = self._extend_dist(softmax(gen_logits, dim=-1), mix_p, ps,
                                 src_ids)
        logits = torch.log(dist[:, 0].float() + 1e-10)
        if isinstance(controls, torch.Tensor):
            logits = sampling_controls_rows(logits, controls[:, 0],
                                            controls[:, 1].long(),
                                            controls[:, 2])
        else:
            logits = sampling_controls(logits, *controls)
        return pick_by_uniform(logits, u)

    # ---- chunked greedy decoding with per-row progress (continuous
    #      batching: rows refilled mid-flight sit at different absolute
    #      positions; the decode math is row-independent, so a request's
    #      answer is the one-shot decode's) ----

    def chunk_init(self, memories, mem_keeps, weights, src_ids, max_len: int,
                   feature: Optional[torch.Tensor] = None,
                   fast_argmax=None,
                   row_max: Optional[torch.Tensor] = None,
                   row_keys: Optional[torch.Tensor] = None,
                   row_ctl: Optional[torch.Tensor] = None) -> dict:
        """The per-row decode state that ``chunk_step`` advances. Every
        tensor in it is [B, ...], so a serving driver can scatter fresh rows
        (from a ``chunk_init`` on new requests) into a live state with
        ``runtime.continuous.refill_rows``. Fused stacks keep their folded
        weights on the decoder (``_folded``) and a None in ``cross``.

        ``row_max`` [B]: per-row response caps; a row ends at its own cap
        instead of ``max_len``.

        ``row_keys`` [B, 2]: per-row sampling keys (two u32 words) for
        sampled chunks (``chunk_step(sampling=True)``). The key rides with
        its row; the state keeps the row's uniforms for every step
        (``decode.loops.sample_uniforms``), and step ``trow`` draws at its
        own, so a request's sampled tokens depend only on its inputs and
        key, not on its batch, the chunk size or refill timing.
        ``row_ctl`` [B, 3] f32: per-row sampling controls (temperature,
        top_k, top_p), applied by ``decode.loops.sampling_controls_rows``
        instead of the chunk's batch-wide controls."""
        b = memories[0].shape[0]
        dev = memories[0].device
        fast_argmax, use_kernel_comb = self._resolve_fast_argmax(fast_argmax)
        cross, key_projs, feat = self._decode_precompute(memories, feature)
        cross = [None if isinstance(c, dict) else c for c in cross]
        ids_cat, extras = self._argmax_precompute(
            src_ids, memories[0].dtype, fast_argmax, use_kernel_comb)
        if row_max is None:
            row_max = torch.full((b,), max_len, dtype=torch.long, device=dev)
        else:
            row_max = row_max.to(device=dev, dtype=torch.long).clamp(1, max_len)
        state = {
            "caches": self._init_caches(b, max_len, memories),
            "cross": cross, "key_projs": key_projs, "feat": feat,
            "memories": list(memories), "mem_keeps": list(mem_keeps),
            "weights": list(weights), "src_ids": list(src_ids),
            "ids_cat": ids_cat, "extras": extras,
            "prev": torch.full((b,), self.bos_id, dtype=torch.int32,
                               device=dev),
            "trow": torch.zeros(b, dtype=torch.long, device=dev),
            "done": torch.zeros(b, dtype=torch.bool, device=dev),
            "hist": torch.zeros(b, max_len, dtype=torch.bool, device=dev),
            "out": torch.zeros(b, max_len, dtype=torch.int32, device=dev),
            "row_max": row_max,
        }
        if row_keys is not None:
            state["u"] = sample_uniforms(
                row_keys.to(device=dev, dtype=torch.int64), max_len)
        if row_ctl is not None:
            state["ctl"] = row_ctl.to(device=dev, dtype=torch.float32)
        return state

    def chunk_step(self, state: dict, n_steps: int, fast_argmax=None,
                   sampling: bool = False, unk_id: int = 2,
                   temperature: float = 1.0, top_k: int = 0,
                   top_p: float = 1.0) -> dict:
        """Advance every row that is not done by ``n_steps`` decode steps.

        A row becomes done when it emits EOS or reaches its cap; done rows
        freeze (they are pointed at position ``max_len``, where every write
        is skipped). ``fast_argmax`` must be the mode ``chunk_init`` built
        the state with. The KV caches and the history mask are updated in
        place; ``prev``, ``trow``, ``done`` and ``out`` are fresh tensors in
        the returned state, so a driver may still read the previous
        state's.

        ``sampling=True`` draws each step from the extended distribution
        instead of arg-maxing (the state needs ``chunk_init``'s
        ``row_keys``), with ``sample``'s bookkeeping: an EOS at a row's
        step 0 is written as UNK (and ends the row), the row's last step
        is EOS. The controls are the state's per-row ``ctl`` if it has
        them, else (temperature, top_k, top_p). With the same keys a
        request's answer is ``sample``'s, bit for bit."""
        if sampling:
            if "u" not in state:
                raise ValueError("sampled chunks need per-row keys: "
                                 "chunk_init(row_keys=...)")
            controls = state.get("ctl")
            if controls is None:
                validate_controls(temperature, top_k, top_p)
                controls = (temperature, top_k, top_p)
        fast_argmax, use_kernel_comb = self._resolve_fast_argmax(fast_argmax)
        memories, mem_keeps, weights, src_ids = (
            state["memories"], state["mem_keeps"], state["weights"],
            state["src_ids"])
        cross = [self._folded(i, memories[i].dtype) if c is None else c
                 for i, c in enumerate(state["cross"])]
        caches, hist = state["caches"], state["hist"]
        key_projs, feat = state["key_projs"], state["feat"]
        ids_cat, extras = state["ids_cat"], state["extras"]
        row_max = state["row_max"]
        prev, trow, done = state["prev"], state["trow"], state["done"]
        out = state["out"].clone()
        max_len = out.shape[1]
        for _ in range(n_steps):
            t_w = torch.where(done, max_len, trow)
            mix_p, ps, gen_h, gen_logits = self._step_core(
                caches, prev, hist, t_w, cross, key_projs, feat, memories,
                mem_keeps, weights)
            if sampling:
                u = state["u"].gather(1, trow[:, None])[:, 0]
                nxt = self._sample_next(mix_p, ps, gen_logits, src_ids, u,
                                        controls)
                raw_end = nxt == self.eos_id
                nxt = torch.where((trow == 0) & raw_end, unk_id, nxt)
                nxt = torch.where(trow >= row_max - 1, self.eos_id, nxt)
            else:
                nxt = self._greedy_next(mix_p, ps, gen_h, gen_logits,
                                        src_ids, ids_cat, extras,
                                        fast_argmax, use_kernel_comb)
                raw_end = nxt == self.eos_id
            active = ~done
            write_step(out, nxt[:, None], t_w)
            newly = active & (raw_end | (trow >= row_max - 1))
            prev = torch.where(active, nxt, prev)
            trow = torch.where(active & ~newly, trow + 1, trow)
            done = done | newly
        return dict(state, prev=prev, trow=trow, done=done, out=out)

    # ---- greedy decoding (argmax over the extended distribution, no EOS
    #      bookkeeping: ref CaSE/Model.py:119-123) ----

    def decode(self, memories: Sequence[torch.Tensor],
               mem_keeps: Sequence[torch.Tensor],
               weights: Sequence[torch.Tensor],
               src_ids: Sequence[torch.Tensor], max_len: int,
               feature: Optional[torch.Tensor] = None,
               early_exit: bool = False, fast_argmax=None) -> torch.Tensor:
        """Greedy decoding for ``max_len`` steps. Returns [B, max_len]
        int32.

        ``early_exit=True`` stops once every row has emitted EOS at least
        once (the later positions stay PAD); it reads a flag from the device
        every step. The reference keeps arg-maxing past EOS but truncates
        at EOS when it prints, so the emitted answers are the same. While
        ``torch.export`` traces, the early-exit loop is a ``while_loop``
        instead (``_decode_while``), the same steps; the fixed-trip loop is
        traced as it runs. ``fast_argmax``: the argmax mode
        (``_resolve_fast_argmax``)."""
        b = memories[0].shape[0]
        dev = memories[0].device
        fast_argmax, use_kernel_comb = self._resolve_fast_argmax(fast_argmax)
        cross, key_projs, feat = self._decode_precompute(memories, feature)
        caches = self._init_caches(b, max_len, memories)
        ids_cat, extras = self._argmax_precompute(
            src_ids, memories[0].dtype, fast_argmax, use_kernel_comb)
        prev = torch.full((b,), self.bos_id, dtype=torch.int32, device=dev)
        hist = torch.zeros(b, max_len, dtype=torch.bool, device=dev)
        out = torch.zeros(b, max_len, dtype=torch.int32, device=dev)
        ended = torch.zeros(b, dtype=torch.bool, device=dev)

        def step(caches, prev, hist, t):
            mix_p, ps, gen_h, gen_logits = self._step_core(
                caches, prev, hist, t, cross, key_projs, feat, memories,
                mem_keeps, weights)
            return self._greedy_next(mix_p, ps, gen_h, gen_logits, src_ids,
                                     ids_cat, extras, fast_argmax,
                                     use_kernel_comb)

        if early_exit and torch.compiler.is_exporting():
            return self._decode_while(step, caches, prev, hist, out, ended)
        for t in range(max_len):
            if early_exit and t > 0 and bool(ended.all()):
                break
            prev = step(caches, prev, hist, t)
            out[:, t] = prev
            if early_exit:
                ended |= prev == self.eos_id
        return out

    def _decode_while(self, step, caches, prev, hist, out, ended):
        """The early-exit greedy loop as a ``while_loop`` that
        ``torch.export`` traces (the JAX package's ``lax.while_loop``):
        while ``t < max_len`` and some row has not emitted EOS, ``step``
        at t. ``t`` is a 0-dim tensor, given to the step as a [B] tensor
        of per-row positions (the chunked decode's form, the same values),
        and the answer's column t is written by ``where``. The step
        updates the caches and the history in place, and a loop body may
        not mutate what it carries: it updates copies and carries those,
        a copy of every cache a step."""
        from torch._higher_order_ops.while_loop import while_loop
        b, max_len = out.shape
        pos = torch.arange(max_len, device=out.device)
        t0 = torch.zeros((), dtype=torch.long, device=out.device)

        def cond(t, prev, ended, out, hist, caches):
            return (t < max_len) & ~ended.all()

        def body(t, prev, ended, out, hist, caches):
            caches = [c.clone() if isinstance(c, torch.Tensor)
                      else [x.clone() for x in c] for c in caches]
            hist = hist.clone()
            nxt = step(caches, prev, hist, t.repeat(b))
            out = torch.where(pos == t, nxt[:, None], out)
            return (t + 1, nxt, ended | (nxt == self.eos_id), out, hist,
                    caches)

        return while_loop(cond, body, (t0, prev, ended, out, hist,
                                       list(caches)))[3]

    # ---- categorical sampling (beyond the reference, which has only greedy
    #      for these decoders) ----

    def sample(self, memories, mem_keeps, weights, src_ids, max_len: int,
               row_keys: torch.Tensor, feature: Optional[torch.Tensor] = None,
               unk_id: int = 2, temperature: float = 1.0, top_k: int = 0,
               top_p: float = 1.0) -> torch.Tensor:
        """Samples each step from the extended (copy-mixed) distribution,
        with the JAX package's bookkeeping: an EOS at t=0 is rewritten to
        UNK, the final step forces EOS, and positions after a row's EOS
        emit PAD. The temperature/top_k/top_p controls apply to the log of
        the extended distribution (``decode.loops.sampling_controls``;
        the defaults are identity). Row r draws at step t from its key
        ``row_keys[r]`` [B, 2] alone (``decode.loops.sample_uniforms``), as
        ``chunk_step(sampling=True)`` does. Returns [B, max_len] int32."""
        validate_controls(temperature, top_k, top_p)
        b = memories[0].shape[0]
        dev = memories[0].device
        cross, key_projs, feat = self._decode_precompute(memories, feature)
        caches = self._init_caches(b, max_len, memories)
        u = sample_uniforms(row_keys.to(device=dev, dtype=torch.int64),
                            max_len)
        prev = torch.full((b,), self.bos_id, dtype=torch.int32, device=dev)
        hist = torch.zeros(b, max_len, dtype=torch.bool, device=dev)
        out = torch.zeros(b, max_len, dtype=torch.int32, device=dev)
        ended = torch.zeros(b, dtype=torch.bool, device=dev)
        for t in range(max_len):
            mix_p, ps, _, gen_logits = self._step_core(
                caches, prev, hist, t, cross, key_projs, feat, memories,
                mem_keeps, weights)
            nxt = self._sample_next(mix_p, ps, gen_logits, src_ids, u[:, t],
                                    (temperature, top_k, top_p))
            this_end = nxt == self.eos_id
            if t == 0:
                nxt = torch.where(this_end, unk_id, nxt)
            if t == max_len - 1:
                nxt = torch.full_like(nxt, self.eos_id)
            if t > 0:
                nxt = torch.where(ended, 0, nxt)
            ended |= this_end
            out[:, t] = nxt
            prev = nxt
        return out

    # ---- beam search (beyond the reference, which has only greedy for
    #      these decoders; the vectorized beam of decode/loops) ----

    def beam(self, memories, mem_keeps, weights, src_ids, max_len: int,
             width: int, feature: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
        """Beam search of ``width`` beams a row over the extended
        distribution (``decode.loops.run_beam``). The per-row inputs are
        repeated to B*width rows, each row's beams adjacent; every step
        reorders the KV caches (either layout) and the history by the
        surviving beams. Returns [B, max_len] int32, PAD after EOS."""
        b = memories[0].shape[0]
        memories, mem_keeps, weights, src_ids, feat_in = tile_state(
            [memories, mem_keeps, weights, src_ids,
             feature if self.use_feature else None], width)
        cross, key_projs, feat = self._decode_precompute(memories, feat_in)
        bw = b * width
        state0 = {"caches": self._init_caches(bw, max_len, memories),
                  "hist": torch.zeros(bw, max_len, dtype=torch.bool,
                                      device=memories[0].device),
                  "t": 0}

        def step_fn(state, prev):
            mix_p, ps, _, gen_logits = self._step_core(
                state["caches"], prev, state["hist"], state["t"], cross,
                key_projs, feat, memories, mem_keeps, weights)
            dist = self._extend_dist(softmax(gen_logits, dim=-1), mix_p, ps,
                                     src_ids)
            return dist[:, 0], dict(state, t=state["t"] + 1)

        return run_beam(step_fn, state0, b, max_len, width, self.bos_id,
                        self.eos_id)
