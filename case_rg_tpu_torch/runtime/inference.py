"""Inference dispatch (port of ``case_rg_tpu/runtime/inference.py``):
each model's test-time outputs, greedy, beam or sampled, and rank-only
serving.

* case, masque -> {"answer", "rank"} through their own ``predict``;
* tmemnet -> {"answer", "rank"}: one encode gives the decode memories and
  the knowledge attention (the rank), except under beam search;
* s2sa, gttp, glks -> {"answer"} through ``models/predict.py``.

``make_replicated_predict`` runs the same function over ``Replicas``, one
row block a replica (the JAX package's predict over ``local_mesh`` with
``shard_batch``); a replica over a device group of M devices
(``Replicas(model, groups)``) splits each of its rows' passage pools M ways
(``models/case.PooledCaSE``).
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict

import torch

from ..config import ModelConfig
from ..decode.loops import keys_from_seed, validate_controls
from ..device import batch_to_device, resolve_device
from ..models.predict import beam_predict, greedy_predict, sample_predict

PROTOCOL_MODELS = ("s2sa", "gttp", "glks", "tmemnet")
RANK_MODELS = ("case", "masque", "tmemnet")


def make_predict_fn(model, cfg: ModelConfig, max_len: int, *,
                    beam_width: int = 1, early_exit: bool = False,
                    fast_argmax=None, decoding: str = "greedy",
                    sample_seed: int = 0, temperature: float = 1.0,
                    top_k: int = 0, top_p: float = 1.0,
                    rank_only: bool = False, device="cuda"
                    ) -> Callable[[dict], Dict[str, torch.Tensor]]:
    """A function batch -> {"answer" [B, max_len] int32, "rank" [B, P]} ("rank"
    for the ``RANK_MODELS`` only), or -> {"rank"} with ``rank_only``.
    Batches hold the model's featurized fields ("query" [B, 1, Lq] and
    "passage" [B, P, Lp] ids for case and masque, "context" and
    "background" or "passage" for the others), as numpy arrays or
    tensors; they are moved to ``device``, where ``model`` must live.

    ``decoding="greedy"``: greedy (``early_exit`` and the argmax mode
    ``fast_argmax`` as on ``MultiMemoryDecoder.decode``; for GTTP and GLKS
    ``models.predict.fast_copy_on``), or beam search with ``beam_width >
    1``. ``decoding="sample"``: categorical sampling
    with the temperature/top_k/top_p controls; a batch's per-row keys are
    its "sample_key" [B, 2] if it has one, else drawn from ``sample_seed``
    and the call's index (each call draws afresh, the same sequence on
    every run). Sampling with ``beam_width > 1`` raises. Raises without a
    card unless ``device="cpu"``. Runs under ``torch.inference_mode``;
    ``make_predict_body`` is the same function without the move and the
    mode (``runtime/exported`` traces it)."""
    dev = resolve_device(device)
    where = next(model.parameters()).device
    if where.type != dev.type:
        raise ValueError(f"model lives on {where}, not on {dev}")
    body = make_predict_body(
        model, cfg, max_len, beam_width=beam_width, early_exit=early_exit,
        fast_argmax=fast_argmax, decoding=decoding, sample_seed=sample_seed,
        temperature=temperature, top_k=top_k, top_p=top_p,
        rank_only=rank_only)

    def fn(batch):
        batch = batch_to_device(batch, where)
        with torch.inference_mode():
            return body(batch)
    return fn


def make_replicated_predict(replicas, cfg: ModelConfig, max_len: int, *,
                            decoding: str = "greedy", sample_seed: int = 0,
                            **kw) -> Callable[[dict], "Pending"]:
    """``make_predict_fn`` over ``replicas`` (``runtime/replicas.Replicas``):
    a function batch -> ``Pending`` whose ``get()`` is the outputs as numpy
    arrays. Each replica predicts a contiguous row block of the batch in its
    own thread and starts its block's host copy there; ``get`` puts the
    blocks back in row order. ``kw`` are ``make_predict_fn``'s options.

    Sampled decoding draws the whole batch's row keys once a call
    (``keys_from_seed(sample_seed, B, stream=call index)``, as one device
    does) and gives each replica its rows' keys, so a split batch samples
    what the unsplit batch samples. With one replica the function is
    ``make_predict_fn``'s, its outputs copied to the host. The function's
    ``pool_devices`` is the replicas' group size (``train/trainer.predict``
    checks it)."""
    from .replicas import Pending
    fns = [make_predict_fn(m, cfg, max_len, decoding=decoding,
                           sample_seed=sample_seed, device=d, **kw)
           for m, d in zip(replicas.models, replicas.devices)]
    counter = itertools.count()

    def fn(batch):
        if len(fns) == 1:
            return Pending([fns[0](batch)])
        if decoding == "sample" and batch.get("sample_key") is None:
            batch = dict(batch, sample_key=keys_from_seed(
                sample_seed, _rows(batch), stream=next(counter)))
        return Pending.of_blocks(replicas.map(
            lambda i, blk: Pending([fns[i](blk)]), replicas.split(batch)))
    fn.pool_devices = replicas.pool
    return fn


def make_predict_body(model, cfg: ModelConfig, max_len: int, *,
                      beam_width: int = 1, early_exit: bool = False,
                      fast_argmax=None, decoding: str = "greedy",
                      sample_seed: int = 0, temperature: float = 1.0,
                      top_k: int = 0, top_p: float = 1.0,
                      rank_only: bool = False
                      ) -> Callable[[dict], Dict[str, torch.Tensor]]:
    """``make_predict_fn``'s function on a batch of tensors already on the
    model's device, under the caller's grad mode. Raises ValueError on a
    combination the model does not take."""
    where = next(model.parameters()).device
    name = cfg.name
    if name not in RANK_MODELS + PROTOCOL_MODELS:
        raise ValueError(f"unknown model {name!r}")
    if decoding not in ("greedy", "sample"):
        raise ValueError(f"unknown decoding {decoding!r}")
    protocol = name in PROTOCOL_MODELS

    if rank_only:
        if name not in RANK_MODELS:
            raise ValueError(f"model {name!r} has no rank head (rank_only "
                             f"needs one of {RANK_MODELS})")
        return lambda batch: {"rank": model.rank(batch)}

    if decoding == "sample":
        if beam_width > 1:
            raise ValueError("decoding='sample' excludes beam_width > 1 "
                             "(pick one decode strategy)")
        validate_controls(temperature, top_k, top_p)
        counter = itertools.count()

        def sample(batch):
            keys = batch.get("sample_key")
            if keys is None:
                keys = keys_from_seed(sample_seed, _rows(batch),
                                      stream=next(counter), device=where)
            if not protocol:
                return model.predict(batch, max_len=max_len,
                                     sample_keys=keys,
                                     temperature=temperature,
                                     top_k=top_k, top_p=top_p)
            enc = model.encode(batch)
            out = {"answer": sample_predict(
                model, batch, max_len, keys, enc=enc,
                temperature=temperature, top_k=top_k, top_p=top_p)}
            if name in RANK_MODELS:
                out["rank"] = enc["ck_attn"]
            return out
        return sample

    def greedy(batch):
        if not protocol:
            return model.predict(batch, max_len=max_len,
                                 early_exit=early_exit,
                                 fast_argmax=fast_argmax,
                                 beam_width=beam_width)
        if beam_width > 1:
            out = {"answer": beam_predict(model, batch, max_len,
                                          beam_width)}
            if name in RANK_MODELS:
                out["rank"] = model.rank(batch)
            return out
        enc = model.encode(batch)
        out = {"answer": greedy_predict(model, batch, max_len,
                                        early_exit=early_exit, enc=enc,
                                        fast_copy=fast_argmax)}
        if name in RANK_MODELS:
            # one encode: the decode memories and the rank scores
            out["rank"] = enc["ck_attn"]
        return out
    return greedy


def _rows(batch) -> int:
    for k in ("query", "context"):
        if k in batch:
            return batch[k].shape[0]
    raise KeyError("a batch needs 'query' or 'context'")
