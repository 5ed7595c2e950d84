"""Pretrained-embedding loading (a copy of
``case_rg_tpu/data/embeddings.py``; numpy only).

Rebuild of the reference's GloVe machinery (common/Utils.py:258-297
``load_embeddings``/``prepare_embeddings`` with a bcolz cache, and
common/Utils.py:441-453 ``load_embedding``): parse a GloVe-format text file
into a [V, D] matrix aligned with the active vocabulary, with a plain ``.npz``
cache instead of bcolz (SURVEY §2.6). Rows for out-of-embedding words follow
the reference: N(0, 0.6) noise for ``load_embeddings`` semantics, or
xavier-uniform background for ``load_embedding`` semantics.

The six entry points never pass ``emb_matrix`` (all Run.py construct models
with learned embeddings), so this is a capability-parity utility; models
consume it by assigning the returned matrix into
``params[...]['embedding']['embedding']`` before training (in the port:
``bridge.load_state`` of the tree, or a copy into the model's
``...embedding.weight``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from .vocab import Vocabulary


def parse_glove_text(path: str) -> Dict[str, np.ndarray]:
    table: Dict[str, np.ndarray] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split()
            if len(parts) < 3:
                continue
            word = parts[0]
            try:
                vec = np.asarray([float(x) for x in parts[1:]], np.float32)
            except ValueError:
                continue
            table[word] = vec
    return table


def load_embedding_matrix(path: str, vocab: Vocabulary, dim: int,
                          cache: Optional[str] = None,
                          seed: int = 0) -> np.ndarray:
    """[len(vocab), dim] matrix; unseen words get N(0, 0.6) rows
    (ref: common/Utils.py:269-276); PAD row zeroed."""
    if cache and os.path.exists(cache):
        data = np.load(cache)
        if data["matrix"].shape == (len(vocab), dim):
            return data["matrix"]
    table = parse_glove_text(path)
    rng = np.random.RandomState(seed)
    out = np.zeros((len(vocab), dim), np.float32)
    found = 0
    for i in range(len(vocab)):
        word = vocab.id2vocab[i]
        vec = table.get(word)
        if vec is not None and len(vec) == dim:
            out[i] = vec
            found += 1
        else:
            out[i] = rng.normal(scale=0.6, size=dim)
    out[vocab.pad_id] = 0.0
    if cache:
        os.makedirs(os.path.dirname(cache) or ".", exist_ok=True)
        np.savez_compressed(cache, matrix=out)
    return out


def assign_embedding(params: dict, path_keys, matrix: np.ndarray) -> dict:
    """Return params with the embedding table at ``path_keys`` replaced."""
    import copy

    params = copy.deepcopy(params)
    cur = params
    for k in path_keys[:-1]:
        cur = cur[k]
    cur[path_keys[-1]] = np.asarray(matrix, np.float32)
    return params
