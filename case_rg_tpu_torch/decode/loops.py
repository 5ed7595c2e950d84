"""Sampling controls, the sampling draw and beam search (port of
``case_rg_tpu/decode/loops.py``; CaSE's ``MultiMemoryDecoder.sample``,
``beam`` and sampled ``chunk_step`` use them).

* ``sampling_controls`` / ``sampling_controls_rows``: temperature ->
  top-k -> nucleus (top-p) on [B, V] f32 logits, for the whole batch or
  with a control triple per row, masked entries at -1e30.
* The draw: JAX's threefry streams are not reproduced. A row's sampled
  tokens depend only on its two-word key: step t of a row draws one uniform
  from Philox4x32-10 (counter (t, 0, 0, 0), key = the row's key; the
  generator of ``kernels/train_attention``) and picks the token whose
  cumulative probability first exceeds it (``pick_by_uniform``). So a
  request samples the same answer whatever its batch, chunk or refill
  order. ``keys_from_seed`` derives per-row keys from a seed.
* ``run_greedy``, ``run_greedy_copy`` and ``run_sample``: the step
  protocol's loops (``models/predict.py``) over a step function
  ``step_fn(state, prev [B]) -> (scores [B, V], state)``, with the
  reference's EOS bookkeeping: an EOS at step 0 becomes UNK, positions
  after a row's EOS are PAD, the emitted token is fed back.
  ``run_greedy_copy`` takes its argmax over a copy mixture without the
  [B, V] scatter (``kernels/copy_argmax.candidate_argmax_from_logits``,
  the ``combine_copy_mass`` kernel on the card).
* ``run_beam``: the vectorized batch x width beam with the reference's
  retirement, ``-log(p + 1e-10)`` costs, length-normalised final choice and
  stable-sort tie-breaks; ``tile_state`` and ``_reindex_state`` lay a decode
  state out over the beams.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..kernels.train_attention import philox4x32

StepFn = Callable[[object, torch.Tensor], Tuple[torch.Tensor, object]]
_NEG = -1e30
_U32 = 0xFFFFFFFF


def validate_controls(temperature: float, top_k: int, top_p: float) -> None:
    """Range checks for sampling controls."""
    if temperature <= 0.0:
        raise ValueError(f"temperature must be > 0, got {temperature}")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")


def sampling_controls(logits: torch.Tensor, temperature: float = 1.0,
                      top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Standard sampling controls on [B, V] f32 logits (the defaults are
    identity). Order: temperature -> top-k -> nucleus (top-p); masked
    positions set to -1e30. Top-p keeps the tokens whose cumulative mass
    BEFORE them is below top_p (always the most probable one)."""
    validate_controls(temperature, top_k, top_p)
    if temperature != 1.0:
        logits = logits / temperature
    if 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, _NEG, logits)
    if top_p < 1.0:
        sorted_logits, sorted_idx = torch.sort(logits, dim=-1,
                                               descending=True, stable=True)
        probs = torch.softmax(sorted_logits, dim=-1)
        keep_sorted = (torch.cumsum(probs, dim=-1) - probs) < top_p
        keep = torch.zeros_like(keep_sorted).scatter_(-1, sorted_idx,
                                                      keep_sorted)
        logits = torch.where(keep, logits, _NEG)
    return logits


def sampling_controls_rows(logits: torch.Tensor, temperature: torch.Tensor,
                           top_k: torch.Tensor, top_p: torch.Tensor
                           ) -> torch.Tensor:
    """Per-ROW sampling controls on [B, V] f32 logits: ``sampling_controls``
    with [B] control vectors, so every decode row carries its own request's
    controls. A row with (1.0, 0, 1.0) is identity; any other row matches
    ``sampling_controls(logits[r:r+1], *controls[r])``: one descending
    sort serves the top-k threshold and the nucleus mask. The caller
    validates the controls."""
    b, v = logits.shape
    logits = logits / temperature[:, None].to(logits.dtype)
    sorted_logits, sorted_idx = torch.sort(logits, dim=-1, descending=True,
                                           stable=True)
    top_k = top_k.long()
    k_eff = top_k.clamp(1, v)
    kth = sorted_logits.gather(-1, (k_eff - 1)[:, None])
    cut_k = (top_k > 0)[:, None] & (sorted_logits < kth)
    probs = torch.softmax(torch.where(cut_k, _NEG, sorted_logits), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # top_p >= 1 is identity (the batch form skips the branch; the OR keeps
    # the least probable token from float residue in the cumulative sum)
    keep_sorted = ((cum - probs) < top_p[:, None]) | (top_p >= 1.0)[:, None]
    keep_sorted &= ~cut_k
    keep = torch.zeros_like(keep_sorted).scatter_(-1, sorted_idx, keep_sorted)
    return torch.where(keep, logits, _NEG)


def _u32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64) & _U32


def keys_from_seed(seed: int, n: int, stream: int = 0,
                   device="cpu") -> torch.Tensor:
    """n two-word row keys (int64 [n, 2], each word < 2**32) from ``seed``:
    Philox4x32-10 at counter (row, stream, 0, 0) under the seed's two
    words. ``stream`` separates the draws of successive calls."""
    rows = torch.arange(n, dtype=torch.int64, device=device)
    z = torch.zeros_like(rows)
    w = philox4x32(rows, z + (stream & _U32), z, z,
                   _u32(seed).to(device), _u32(seed >> 32).to(device))
    return torch.stack(w[:2], dim=-1)


def sample_uniforms(keys: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B, max_len] f32 uniforms in [0, 1): step t of row r is word 0 of
    Philox4x32-10 at counter (t, 0, 0, 0) under the row's key, its top 24
    bits scaled by 2^-24 (exact in f32)."""
    keys = keys.to(torch.int64)
    t = torch.arange(max_len, dtype=torch.int64, device=keys.device)
    z = torch.zeros((), dtype=torch.int64, device=keys.device)
    w0 = philox4x32(t[None, :], z, z, z, keys[:, :1] & _U32,
                    keys[:, 1:] & _U32)[0]
    return (w0 >> 8).to(torch.float32) * (2.0 ** -24)


def pick_by_uniform(logits: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The categorical draw over softmax(logits) [B, V] by inverse CDF at
    the uniforms u [B]: the first token whose cumulative probability (f32)
    exceeds u times the total. Entries at -1e30 carry no mass, so a row
    with a single unmasked token (top_k = 1) always picks it. Returns [B]
    int32."""
    cdf = torch.cumsum(torch.softmax(logits.float(), dim=-1), dim=-1)
    at = (u.to(cdf.dtype) * cdf[:, -1])[:, None].contiguous()
    idx = torch.searchsorted(cdf, at, right=True)[:, 0]
    return idx.clamp_max(logits.shape[-1] - 1).to(torch.int32)


def _greedy_loop(pick_fn, init_state, batch_size: int, max_len: int,
                 bos: int, eos: int, unk: int, pad: int,
                 early_exit: bool) -> torch.Tensor:
    """The greedy loop: ``pick_fn(state, prev) -> (idx [B], state)``
    chooses each next token; this applies the EOS bookkeeping. With
    ``early_exit`` it stops once every row has ended (later positions stay
    0), reading one flag from the device a step: a host read, so this loop
    is never captured whole. Returns [B, max_len] int32."""
    dev = _device_of(init_state)
    state = init_state
    prev = torch.full((batch_size,), bos, dtype=torch.int32, device=dev)
    ended = torch.zeros(batch_size, dtype=torch.bool, device=dev)
    out = torch.zeros(batch_size, max_len, dtype=torch.int32, device=dev)
    for t in range(max_len):
        if early_exit and t > 0 and bool(ended.all()):
            break
        idx, state = pick_fn(state, prev)
        this_end = idx == eos
        if t == 0:
            idx = torch.where(this_end, unk, idx)
        else:
            idx = torch.where(ended, pad, idx)
        ended = ended | this_end
        out[:, t] = idx
        prev = idx
    return out


def run_greedy(step_fn: StepFn, init_state, batch_size: int, max_len: int,
               bos: int, eos: int, unk: int, pad: int = 0,
               early_exit: bool = False) -> torch.Tensor:
    """Greedy decoding with the reference's EOS bookkeeping. The answers
    are the same with ``early_exit`` (positions past a row's EOS are PAD
    either way)."""
    def pick(state, prev):
        scores, state = step_fn(state, prev)
        return scores.argmax(dim=-1).to(torch.int32), state

    return _greedy_loop(pick, init_state, batch_size, max_len, bos, eos,
                        unk, pad, early_exit)


def run_greedy_copy(fast_fn, src_ids: torch.Tensor, init_state,
                    batch_size: int, max_len: int, bos: int, eos: int,
                    unk: int, pad: int = 0,
                    early_exit: bool = False) -> torch.Tensor:
    """Greedy decoding over a copy-mixture step without the [B, V] scatter.
    ``fast_fn(state, prev) -> (logits [B, V], l_at [B, L], gate, cw [B, L],
    state)``: the vocabulary logits, those logits at the (step-invariant)
    source ids, the gate of the softmax branch and the gate-scaled copy
    mass, the step's distribution being ``gate * softmax(logits) +
    scatter_add(cw, src_ids)``. Same bookkeeping as ``run_greedy``."""
    from ..kernels.copy_argmax import candidate_argmax_from_logits

    ids32 = src_ids.to(torch.int32)

    def pick(state, prev):
        logits, l_at, gate, cw, state = fast_fn(state, prev)
        return candidate_argmax_from_logits(logits, l_at, gate, cw,
                                            ids32), state

    return _greedy_loop(pick, init_state, batch_size, max_len, bos, eos,
                        unk, pad, early_exit)


def run_sample(step_fn: StepFn, init_state, batch_size: int, max_len: int,
               bos: int, eos: int, unk: int, pad: int,
               row_keys: torch.Tensor, temperature: float = 1.0,
               top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Categorical sampling with the reference's bookkeeping: the last step
    is EOS (PAD on a row already ended). Row r draws at step t from its key
    ``row_keys[r]`` [B, 2] alone (``sample_uniforms``). Without controls it
    samples from softmax(softmax(scores)), the reference's double softmax;
    any control switches to ``sampling_controls(log_softmax(scores))``."""
    validate_controls(temperature, top_k, top_p)
    controlled = temperature != 1.0 or top_k > 0 or top_p < 1.0
    dev = _device_of(init_state)
    u = sample_uniforms(row_keys.to(device=dev, dtype=torch.int64), max_len)
    state = init_state
    prev = torch.full((batch_size,), bos, dtype=torch.int32, device=dev)
    ended = torch.zeros(batch_size, dtype=torch.bool, device=dev)
    out = torch.zeros(batch_size, max_len, dtype=torch.int32, device=dev)
    for t in range(max_len):
        scores, state = step_fn(state, prev)
        idx = pick_by_uniform(sample_logits(scores, controlled, temperature,
                                            top_k, top_p), u[:, t])
        this_end = idx == eos
        if t == 0:
            idx = torch.where(this_end, unk, idx)
        if t == max_len - 1:
            idx = torch.full_like(idx, eos)
        if t > 0:
            idx = torch.where(ended, pad, idx)
        ended = ended | this_end
        out[:, t] = idx
        prev = idx
    return out


def sample_logits(scores: torch.Tensor, controlled: bool,
                  temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0, row_ctl=None) -> torch.Tensor:
    """The logits a protocol step's draw is taken over: per-row controls
    ``row_ctl`` [B, 3] or batch controls on the f32 log-softmax, or, with
    neither, the reference's double softmax (a softmax here, the draw's
    own second)."""
    if row_ctl is not None:
        return sampling_controls_rows(
            torch.log_softmax(scores.float(), dim=-1), row_ctl[:, 0],
            row_ctl[:, 1], row_ctl[:, 2])
    if controlled:
        return sampling_controls(torch.log_softmax(scores.float(), dim=-1),
                                 temperature, top_k, top_p)
    return torch.softmax(scores, dim=-1)


def run_beam(step_fn: StepFn, init_state, batch_size: int, max_len: int,
             width: int, bos: int, eos: int, pad: int = 0,
             eps: float = 1e-10) -> torch.Tensor:
    """Reference-exact beam search, vectorized over batch*width.

    * A beam whose newest token is EOS retires into the sample's results at
      the start of the next step; the fringe then refills to ``width`` from
      the surviving parents' expansions.
    * Token cost ``-log(p + 1e-10)`` (in f32). Fringe selection by
      cumulative cost (all live beams share one length); the final winner
      among retirees by ``cum_cost / length`` (the length counts the BOS
      root), the still-live beams retiring at ``max_len + 1``.
    * Tie-breaks: a stable sort over the flattened [parent, token] axis
      picks lower indices first (the reference's order); among retirees the
      earlier step wins (strict <), then the lower fringe position.

    ``init_state`` is laid out over batch*width rows (``tile_state``);
    ``step_fn(state, prev [B*W]) -> (probabilities [B*W, V], state)``.
    Returns the winning sequences [B, max_len] int32, PAD after the EOS
    (the EOS itself is emitted)."""
    b, w = batch_size, width
    state = init_state
    dev = _device_of(state)
    inf = torch.tensor(float("inf"), device=dev)
    b_ar = torch.arange(b, device=dev)
    prev = torch.full((b * w,), bos, dtype=torch.int32, device=dev)
    cum = torch.zeros(b, w, dtype=torch.float32, device=dev)
    alive = torch.ones(b, w, dtype=torch.bool, device=dev)
    toks = torch.full((b, w, max_len), pad, dtype=torch.int32, device=dev)
    best_norm = torch.full((b,), float("inf"), device=dev)
    best_tok = torch.full((b, max_len), pad, dtype=torch.int32, device=dev)

    def harvest(best_norm, best_tok, norm_r, toks):
        cand = norm_r.min(dim=1).values
        idx = norm_r.argmin(dim=1)             # the first minimum
        better = cand < best_norm
        best_norm = torch.where(better, cand, best_norm)
        best_tok = torch.where(better[:, None], toks[b_ar, idx], best_tok)
        return best_norm, best_tok

    for t in range(max_len):
        prev_b = prev.reshape(b, w)
        newly = alive & (prev_b == eos) & (t > 0)
        norm_r = torch.where(newly, cum / (t + 1.0), inf)
        best_norm, best_tok = harvest(best_norm, best_tok, norm_r, toks)
        alive = alive & ~newly
        any_alive = alive.any(dim=1)

        scores, state = step_fn(state, prev)
        v = scores.shape[-1]
        cost = -torch.log(scores.float().clamp_min(0.0) + eps)
        cand = cum[:, :, None] + cost.reshape(b, w, v)
        cand = torch.where(alive[:, :, None], cand, inf)
        if t == 0:       # the reference's first fringe holds ONE root
            cand[:, 1:] = inf
        top_cum, top_idx = torch.sort(cand.reshape(b, w * v), dim=-1,
                                      stable=True)
        top_cum, top_idx = top_cum[:, :w], top_idx[:, :w]
        beam_idx = top_idx // v
        tok = (top_idx % v).to(torch.int32)
        new_toks = toks.gather(1, beam_idx[:, :, None].expand(b, w, max_len))
        new_toks[:, :, t] = tok
        keep = any_alive[:, None]        # an empty fringe freezes its sample
        cum = torch.where(keep, top_cum, cum)
        toks = torch.where(keep[:, :, None], new_toks, toks)
        alive = any_alive[:, None].expand(b, w)
        prev = torch.where(keep, tok, prev_b).reshape(-1)
        state = _reindex_state(state, beam_idx, b, w)

    norm_f = torch.where(alive, cum / (max_len + 1.0), inf)
    _, best_tok = harvest(best_norm, best_tok, norm_f, toks)
    return best_tok


def _device_of(state):
    if isinstance(state, torch.Tensor):
        return state.device
    items = state.values() if isinstance(state, dict) else state
    for s in items:
        if isinstance(s, (torch.Tensor, dict, list, tuple)):
            dev = _device_of(s)
            if dev is not None:
                return dev
    return None


def _tree_map(fn, state):
    if isinstance(state, torch.Tensor):
        return fn(state)
    if isinstance(state, dict):
        return {k: _tree_map(fn, s) for k, s in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_tree_map(fn, s) for s in state)
    return state             # plain values (a step counter) pass through


def _reindex_state(state, beam_idx: torch.Tensor, b: int, w: int):
    """Gather every [B*W, ...] tensor of ``state`` by per-sample beam
    indices [B, W] (KV caches of either layout, the history, ...)."""
    flat = (torch.arange(b, device=beam_idx.device)[:, None] * w
            + beam_idx).reshape(-1)
    return _tree_map(lambda s: s[flat], state)


def tile_state(state, width: int):
    """Repeat every state tensor along the batch: [B, ...] -> [B*W, ...],
    each row's copies adjacent (row b's beams are rows b*W .. b*W+W-1)."""
    return _tree_map(lambda s: s.repeat_interleave(width, dim=0), state)
