"""Greedy, beam and sampled decoding, one-shot and in chunks, over the step
protocol of S2SA, GTTP, GLKS and TMemNet (port of
``case_rg_tpu/models/predict.py``). These models expose

    encode(batch)                   -> enc (everything the step reads, and
                                       "init_state")
    decode_step(enc, state, prev)   -> (scores [B, V], new state)

and GTTP and GLKS also ``prepare_fast_decode`` / ``decode_step_fast`` for
the scatter-free greedy argmax (``decode.loops.run_greedy_copy``, through
the ``combine_copy_mass`` kernel on the card).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..decode.loops import (_device_of, pick_by_uniform, run_beam,
                            run_greedy, run_greedy_copy, run_sample,
                            sample_logits, sample_uniforms, tile_state,
                            validate_controls)
from ..ops.cache import write_step


def _copy_into(dst, src) -> None:
    """Copy every tensor of the state ``src`` into the same place of
    ``dst`` (tensors that are one object already are skipped)."""
    if isinstance(dst, torch.Tensor):
        if dst is not src:
            dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _copy_into(d, s)


def _batch_size(batch) -> int:
    return (batch["response"] if "response" in batch
            else batch["context"]).shape[0]


def fast_copy_on(fast_copy) -> bool:
    """Whether a greedy argmax mode (``--fast_argmax``'s values) takes the
    scatter-free candidate argmax: True, "pallas" and "mxu" do (the JAX
    package routes every truthy mode there); None (auto), False and
    "dense" keep the dense step, as the JAX package's auto does for these
    models."""
    if isinstance(fast_copy, str):
        return fast_copy.lower() in ("pallas", "mxu")
    return bool(fast_copy)


def greedy_predict(model, batch: Dict[str, torch.Tensor], max_len: int,
                   early_exit: bool = False, enc=None,
                   fast_copy=None) -> torch.Tensor:
    """Greedy answers [B, max_len] int32 (``enc``: an encode of this batch
    to reuse). ``fast_copy`` (``fast_copy_on``) routes GTTP and GLKS
    through ``run_greedy_copy``."""
    cfg = model.cfg
    if enc is None:
        enc = model.encode(batch)
    b = _batch_size(batch)
    if fast_copy_on(fast_copy) and hasattr(model, "decode_step_fast"):
        fast = model.prepare_fast_decode(enc)
        return run_greedy_copy(
            lambda s, p: model.decode_step_fast(enc, fast, s, p),
            enc["background"], enc["init_state"], b, max_len, cfg.bos_id,
            cfg.eos_id, cfg.unk_id, cfg.pad_id, early_exit=early_exit)
    return run_greedy(lambda s, p: model.decode_step(enc, s, p),
                      enc["init_state"], b, max_len, cfg.bos_id, cfg.eos_id,
                      cfg.unk_id, cfg.pad_id, early_exit=early_exit)


def beam_predict(model, batch: Dict[str, torch.Tensor], max_len: int,
                 width: int) -> torch.Tensor:
    """Beam search of ``width`` beams a row (``decode.loops.run_beam``).
    The beam's costs read probabilities: GTTP and GLKS emit their mixture
    (``STEP_EMITS_PROBS``); S2SA hands over its raw logits, as the
    reference's generate does (``BEAM_RAW_SCORES``; a negative logit costs
    -log(1e-10)); TMemNet's logits are softmaxed."""
    cfg = model.cfg
    enc = model.encode(batch)
    b = _batch_size(batch)
    state = tile_state(enc.pop("init_state"), width)
    enc = tile_state(enc, width)
    as_probs = getattr(type(model), "STEP_EMITS_PROBS", False) or \
        getattr(type(model), "BEAM_RAW_SCORES", False)

    def step(state, prev):
        scores, state = model.decode_step(enc, state, prev)
        return (scores if as_probs else torch.softmax(scores, dim=-1)), state

    return run_beam(step, state, b, max_len, width, cfg.bos_id, cfg.eos_id,
                    cfg.pad_id)


def sample_predict(model, batch: Dict[str, torch.Tensor], max_len: int,
                   row_keys: torch.Tensor, enc=None,
                   temperature: float = 1.0, top_k: int = 0,
                   top_p: float = 1.0) -> torch.Tensor:
    """Sampled answers [B, max_len] int32, row r drawn from its key
    ``row_keys[r]`` (``decode.loops.run_sample``)."""
    cfg = model.cfg
    if enc is None:
        enc = model.encode(batch)
    return run_sample(lambda s, p: model.decode_step(enc, s, p),
                      enc["init_state"], _batch_size(batch), max_len,
                      cfg.bos_id, cfg.eos_id, cfg.unk_id, cfg.pad_id,
                      row_keys, temperature=temperature, top_k=top_k,
                      top_p=top_p)


def continuous_decode_init(model, batch, *, max_len: int,
                           fast_argmax=None):
    """(chunk-decode state, rank or None) of a batch for continuous
    serving. Every tensor of the state is [B, ...], so rows refill one by
    one (``runtime.continuous.refill_rows``). ``fast_argmax`` is accepted
    for the continuous loops' sake: the chunks take the dense argmax.
    ``batch["response_cap"]`` [B] caps each row's answer; with
    ``batch["sample_key"]`` [B, 2] the state holds each row's uniforms for
    sampled chunks, and ``batch["sample_ctl"]`` [B, 3] its controls."""
    del fast_argmax
    cfg = model.cfg
    enc = model.encode(batch)
    dec = enc.pop("init_state")
    b = _batch_size(batch)
    dev = _device_of(dec)
    if isinstance(dec, dict) and not isinstance(dec.get("t", 0),
                                                torch.Tensor):
        # per-row positions: rows refilled mid-flight sit at their own t
        dec = dict(dec, t=torch.full((b, 1), int(dec["t"]),
                                     dtype=torch.long, device=dev))
    cap = batch.get("response_cap")
    state = {
        "enc": enc, "dec": dec,
        "prev": torch.full((b,), cfg.bos_id, dtype=torch.int32, device=dev),
        "trow": torch.zeros(b, dtype=torch.long, device=dev),
        "done": torch.zeros(b, dtype=torch.bool, device=dev),
        "out": torch.full((b, max_len), cfg.pad_id, dtype=torch.int32,
                          device=dev),
        "row_max": torch.full((b,), max_len, dtype=torch.long, device=dev)
        if cap is None else cap.to(device=dev, dtype=torch.long).clamp(
            1, max_len),
    }
    if batch.get("sample_key") is not None:
        state["u"] = sample_uniforms(
            batch["sample_key"].to(device=dev, dtype=torch.int64), max_len)
    if batch.get("sample_ctl") is not None:
        state["ctl"] = batch["sample_ctl"].to(device=dev,
                                              dtype=torch.float32)
    return state, enc.get("ck_attn")


def continuous_decode_chunk(model, state, *, n_steps: int, fast_argmax=None,
                            sampling: bool = False, temperature: float = 1.0,
                            top_k: int = 0, top_p: float = 1.0):
    """Advance every row that is not done by ``n_steps`` decode steps with
    ``run_greedy``'s bookkeeping (an EOS at a row's step 0 is written as
    UNK but still ends the row; positions past the EOS stay PAD), so a
    request's tokens are the one-shot ``greedy_predict``'s. The decoder
    state is advanced in place (``dec``'s tensors keep their storage, as a
    captured graph needs); ``prev``, ``trow``, ``done`` and ``out`` are
    fresh tensors in the returned state.

    ``sampling=True`` follows ``run_sample`` instead: the row draws at its
    own step from the state's uniforms ``u`` (``continuous_decode_init``
    with "sample_key"), under its per-row controls ``ctl`` when present,
    else (temperature, top_k, top_p), and the row's last step is EOS. With
    the same keys a request's answer is ``sample_predict``'s, bit for
    bit."""
    del fast_argmax
    cfg = model.cfg
    eos, unk = cfg.eos_id, cfg.unk_id
    enc, dec = state["enc"], state["dec"]
    row_max = state["row_max"]
    prev, trow, done = state["prev"], state["trow"], state["done"]
    out = state["out"].clone()
    max_len = out.shape[1]
    if sampling:
        if "u" not in state:
            raise ValueError("sampled chunks need per-row keys: a batch "
                             "with 'sample_key'")
        ctl = state.get("ctl")
        controlled = temperature != 1.0 or top_k > 0 or top_p < 1.0
        if ctl is None:
            validate_controls(temperature, top_k, top_p)
    state_in = dec
    for _ in range(n_steps):
        scores, dec = model.decode_step(enc, dec, prev)
        if sampling:
            u = state["u"].gather(1, trow[:, None])[:, 0]
            idx = pick_by_uniform(sample_logits(scores, controlled,
                                                temperature, top_k, top_p,
                                                row_ctl=ctl), u)
        else:
            idx = scores.argmax(dim=-1).to(torch.int32)
        raw_end = idx == eos
        idx = torch.where((trow == 0) & raw_end, unk, idx)
        if sampling:
            idx = torch.where(trow >= row_max - 1, eos, idx)
        active = ~done
        write_step(out, idx[:, None], torch.where(done, max_len, trow))
        newly = active & (raw_end | (trow >= row_max - 1))
        prev = torch.where(active, idx, prev)
        trow = torch.where(active & ~newly, trow + 1, trow)
        done = done | newly
    _copy_into(state_in, dec)
    return dict(state, prev=prev, trow=trow, done=done, out=out)
