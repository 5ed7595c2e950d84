"""Inference dispatch (port of ``case_rg_tpu/runtime/inference.py`` for
CaSE: greedy, beam and sampled serving, and rank-only serving)."""

from __future__ import annotations

import itertools
from typing import Callable, Dict

import torch

from ..config import ModelConfig
from ..decode.loops import keys_from_seed, validate_controls
from ..device import batch_to_device, resolve_device

RANK_MODELS = ("case",)


def make_predict_fn(model, cfg: ModelConfig, max_len: int, *,
                    beam_width: int = 1, early_exit: bool = False,
                    fast_argmax=None, decoding: str = "greedy",
                    sample_seed: int = 0, temperature: float = 1.0,
                    top_k: int = 0, top_p: float = 1.0,
                    rank_only: bool = False, device="cuda"
                    ) -> Callable[[dict], Dict[str, torch.Tensor]]:
    """A function batch -> {"answer" [B, max_len] int32, "rank" [B, P]}, or
    -> {"rank"} with ``rank_only``. Batches hold "query" [B, 1, Lq] and
    "passage" [B, P, Lp] ids, as numpy arrays or tensors; they are moved to
    ``device``, where ``model`` must live.

    ``decoding="greedy"``: greedy (``early_exit`` and the argmax mode
    ``fast_argmax`` as on ``MultiMemoryDecoder.decode``), or beam search
    with ``beam_width > 1``. ``decoding="sample"``: categorical sampling
    with the temperature/top_k/top_p controls; a batch's per-row keys are
    its "sample_key" [B, 2] if it has one, else drawn from ``sample_seed``
    and the call's index (each call draws afresh, the same sequence on
    every run). Sampling with ``beam_width > 1`` raises. Raises without a
    card unless ``device="cpu"``."""
    dev = resolve_device(device)
    where = next(model.parameters()).device
    if where.type != dev.type:
        raise ValueError(f"model lives on {where}, not on {dev}")
    if cfg.name not in RANK_MODELS:
        raise ValueError(f"model {cfg.name!r} is not ported yet")
    if decoding not in ("greedy", "sample"):
        raise ValueError(f"unknown decoding {decoding!r}")

    if rank_only:
        def fn(batch):
            with torch.inference_mode():
                return {"rank": model.rank(batch_to_device(batch, where))}
        return fn

    if decoding == "sample":
        if beam_width > 1:
            raise ValueError("decoding='sample' excludes beam_width > 1 "
                             "(pick one decode strategy)")
        validate_controls(temperature, top_k, top_p)
        counter = itertools.count()

        def fn(batch):
            batch = batch_to_device(batch, where)
            keys = batch.get("sample_key")
            if keys is None:
                keys = keys_from_seed(sample_seed, batch["query"].shape[0],
                                      stream=next(counter), device=where)
            with torch.inference_mode():
                return model.predict(batch, max_len=max_len,
                                     sample_keys=keys,
                                     temperature=temperature, top_k=top_k,
                                     top_p=top_p)
        return fn

    def fn(batch):
        with torch.inference_mode():
            return model.predict(batch_to_device(batch, where),
                                 max_len=max_len, early_exit=early_exit,
                                 fast_argmax=fast_argmax,
                                 beam_width=beam_width)
    return fn
