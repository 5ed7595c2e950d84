"""Inference dispatch (port of ``case_rg_tpu/runtime/inference.py`` for
CaSE greedy serving and rank-only serving)."""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ..config import ModelConfig
from ..device import batch_to_device, resolve_device

RANK_MODELS = ("case",)


def make_predict_fn(model, cfg: ModelConfig, max_len: int, *,
                    early_exit: bool = False, fast_argmax=None,
                    rank_only: bool = False, device="cuda"
                    ) -> Callable[[dict], Dict[str, torch.Tensor]]:
    """A function batch -> {"answer" [B, max_len] int32, "rank" [B, P]}
    (greedy decoding; ``early_exit`` and the argmax mode ``fast_argmax`` as
    on ``MultiMemoryDecoder.decode``), or -> {"rank"} with ``rank_only``.
    Batches hold "query" [B, 1, Lq] and "passage" [B, P, Lp] ids, as numpy
    arrays or tensors; they are moved to ``device``, where ``model`` must
    live.
    Raises without a card unless ``device="cpu"``."""
    dev = resolve_device(device)
    where = next(model.parameters()).device
    if where.type != dev.type:
        raise ValueError(f"model lives on {where}, not on {dev}")
    if cfg.name not in RANK_MODELS:
        raise ValueError(f"model {cfg.name!r} is not ported yet")

    if rank_only:
        def fn(batch):
            with torch.inference_mode():
                return {"rank": model.rank(batch_to_device(batch, where))}
        return fn

    def fn(batch):
        with torch.inference_mode():
            return model.predict(batch_to_device(batch, where),
                                 max_len=max_len, early_exit=early_exit,
                                 fast_argmax=fast_argmax)
    return fn
