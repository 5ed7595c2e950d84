"""Offline data preparation orchestrator (a copy of
``case_rg_tpu/data/prepare.py``; its worker pool spawns fresh processes).

Rebuild of Prepare_dataset.py:209-311. Pipeline:

  raw TSVs -> tokenize -> sample assembly (pool construction) -> split ->
  dedup dev/test -> per-model fixed-shape featurization -> .npz + meta JSON

Differences from the reference, by design:
* artifacts are compressed ``.npz`` arrays + JSON metadata, not torch pickles;
* the tokenizer is self-contained (data/text.py). If ``cfg.vocab_file`` points
  at a BERT ``vocab.txt`` the ids match the reference's BertTokenizer ids;
  otherwise a deterministic corpus vocabulary is built (specials first);
* the ``marco.vocab`` frequency table (Prepare_dataset.py:29-35) is used when
  present, else in-corpus counts stand in.

This module, and everything it imports, is numpy-only: the ``workers``
processes never import torch.
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np

from ..config import DataConfig, MODEL_NAMES
from .featurize import featurize, sample_metadata
from .loaders import assemble_samples, merge_eval, split_samples
from .text import basic_tokenize
from .vocab import (Vocabulary, freq_table_from_counts, load_freq_table,
                    load_freq_table_json, save_freq_table)

SPLITS = ("train", "dev", "test")


def _corpus_token_stream(base: str, ds: str):
    """Yield basic-token lists from all text columns of the raw files."""
    def rows(path, col):
        if not os.path.exists(path):
            return
        with open(path, encoding="utf-8") as f:
            next(f)
            for line in f:
                parts = line.rstrip("\n").rstrip("\r").split("\t")
                if len(parts) > col:
                    yield parts[col]

    for text in rows(os.path.join(base, f"{ds}.query"), 1):
        yield basic_tokenize(text)
    for text in rows(os.path.join(base, f"{ds}.reformulation.query"), 1):
        yield basic_tokenize(text)
    for text in rows(os.path.join(base, f"{ds}.passage"), 1):
        yield basic_tokenize(text) + ["[SEP]"]
    for text in rows(os.path.join(base, f"{ds}.answer"), 3):
        yield basic_tokenize(text)


def build_vocab_and_freq(data_path: str, dataset: str, cfg: DataConfig,
                         out_dir: str):
    base = os.path.join(data_path, dataset)
    if cfg.vocab_file:
        vocab = Vocabulary.from_bert_vocab_file(cfg.vocab_file)
    else:
        vocab = Vocabulary.build_from_texts(
            _corpus_token_stream(base, dataset), min_freq=cfg.vocab_min_freq)
    vocab.save(os.path.join(out_dir, "vocab.txt"))

    marco = os.path.join(data_path, "marco", "marco.vocab")
    if os.path.exists(marco):
        id2freq = load_freq_table(marco, vocab)
    else:
        counts: collections.Counter = collections.Counter()
        for toks in _corpus_token_stream(base, dataset):
            counts.update(toks)
        id2freq = freq_table_from_counts(counts, vocab)
    save_freq_table(os.path.join(out_dir, "freq.json"), id2freq)
    return vocab, id2freq


# per-worker context for parallel featurization: each spawned worker gets
# the (large) query/passage dicts once, through the pool's initializer,
# instead of once per task
_PREP_CTX: dict = {}


def _init_worker(ctx: dict) -> None:
    _PREP_CTX.update(ctx)


def _feat_job(split: str, model: str):
    ctx = _PREP_CTX
    arrays = featurize(model, ctx["splits"][split], ctx["query"],
                       ctx["passage"], ctx["vocab"], ctx["id2freq"],
                       ctx["cfg"])
    np.savez_compressed(
        os.path.join(ctx["out_dir"], f"{split}.{model}.npz"), **arrays)
    return split, model, {k: v.shape for k, v in arrays.items()}


def prepare_dataset(data_path: str, dataset: str, cfg: Optional[DataConfig] = None,
                    out_dir: Optional[str] = None,
                    models: Optional[List[str]] = None, verbose: bool = True,
                    workers: int = 0) -> str:
    """Run the full offline pipeline; returns the artifact directory.

    ``workers > 1`` featurizes the (split x model) jobs — independent by
    construction — in a pool of spawned processes (a fresh interpreter each:
    nothing of the caller's threads or imports is inherited). Output arrays
    are deterministic and identical to the serial path."""
    cfg = cfg or DataConfig(dataset=dataset, data_path=data_path)
    base = os.path.join(data_path, dataset)
    out_dir = out_dir or os.path.join(base, "prepared")
    os.makedirs(out_dir, exist_ok=True)
    models = list(models or MODEL_NAMES)

    t0 = time.time()
    vocab, id2freq = build_vocab_and_freq(data_path, dataset, cfg, out_dir)
    tokenizer = vocab.tokenizer()

    samples, query, _reformulated, passage = assemble_samples(
        os.path.join(base, f"{dataset}.answer"),
        os.path.join(base, f"{dataset}.passage"),
        os.path.join(base, f"{dataset}.pool"),
        os.path.join(base, f"{dataset}.qrel"),
        os.path.join(base, f"{dataset}.query"),
        os.path.join(base, f"{dataset}.reformulation.query"),
        tokenizer, topk=cfg.pool_topk, pool_candidates=cfg.pool_candidates)

    train, dev, test = split_samples(os.path.join(base, f"{dataset}.split"), samples)
    dev, test = merge_eval(dev), merge_eval(test)
    split_map = {"train": train, "dev": dev, "test": test}
    if verbose:
        print(f"[prepare] vocab={len(vocab)} samples: "
              f"train={len(train)} dev={len(dev)} test={len(test)}")

    for split, ss in split_map.items():
        with open(os.path.join(out_dir, f"{split}.meta.json"), "w") as f:
            json.dump(sample_metadata(ss), f)
    jobs = [(split, model) for split, ss in split_map.items() if ss
            for model in models]

    if workers > 1:
        import multiprocessing as mp
        # the vocabulary without its cached tokenizer, whose native table
        # does not pickle (featurize reads only the id maps)
        ctx = dict(splits=split_map, query=query, passage=passage,
                   vocab=Vocabulary(vocab.vocab2id, vocab.id2vocab),
                   id2freq=id2freq, cfg=cfg, out_dir=out_dir)
        with mp.get_context("spawn").Pool(
                workers, initializer=_init_worker, initargs=(ctx,)) as pool:
            for split, model, shapes in pool.starmap(_feat_job, jobs):
                if verbose:
                    print(f"[prepare] {split}.{model}: {shapes}")
    else:
        for split, model in jobs:
            arrays = featurize(model, split_map[split], query, passage,
                               vocab, id2freq, cfg)
            np.savez_compressed(
                os.path.join(out_dir, f"{split}.{model}.npz"), **arrays)
            if verbose:
                shapes = {k: v.shape for k, v in arrays.items()}
                print(f"[prepare] {split}.{model}: {shapes}")
    if verbose:
        print(f"[prepare] done in {time.time() - t0:.1f}s -> {out_dir}")
    return out_dir


def load_prepared(out_dir: str, split: str, model: str):
    """Returns (arrays dict, metadata list, vocab, id2freq)."""
    arrays = dict(np.load(os.path.join(out_dir, f"{split}.{model}.npz")))
    with open(os.path.join(out_dir, f"{split}.meta.json")) as f:
        meta = json.load(f)
    vocab = Vocabulary.load(os.path.join(out_dir, "vocab.txt"))
    id2freq = load_freq_table_json(os.path.join(out_dir, "freq.json"))
    return arrays, meta, vocab, id2freq
