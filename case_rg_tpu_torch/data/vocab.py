"""Vocabulary handling (a copy of ``case_rg_tpu/data/vocab.py``).

Two sources, mirroring the reference's two vocab paths:

* a BERT-style ``vocab.txt`` (one token per line, line number = id), which is
  what ``bert_tokenizer`` exposes (common/Utils.py:30-37) — the special words
  [PAD]/[unused0]/[UNK]/[unused1]/[SEP]/[CLS]/[MASK] must be present;
* a corpus-built vocabulary laid out like ``load_vocab``'s
  (common/Utils.py:413-438): specials first in the canonical order, then
  corpus tokens.

Frequency tables follow the ``marco.vocab`` format ``token\\tfreq`` and are
remapped onto the active vocabulary's ids (Prepare_dataset.py:29-35), with
the same smoothing for ids 0..3 (common/Utils.py:431-434).
"""

from __future__ import annotations

import collections
import json
import os
from typing import Dict, Iterable, List, Optional, Tuple

from ..constants import (BOS_WORD, CLS_WORD, EOS_WORD, MASK_WORD, PAD_WORD,
                         SEP_WORD, SPECIAL_WORDS, UNK_WORD)
from .text import WordPieceTokenizer, bert_detokenize


class Vocabulary:
    def __init__(self, vocab2id: Dict[str, int], id2vocab: Dict[int, str]):
        self.vocab2id = vocab2id
        self.id2vocab = id2vocab
        for w in SPECIAL_WORDS:
            if w not in vocab2id:
                raise ValueError(f"special word {w!r} missing from vocabulary")
        self.pad_id = vocab2id[PAD_WORD]
        self.bos_id = vocab2id[BOS_WORD]
        self.unk_id = vocab2id[UNK_WORD]
        self.eos_id = vocab2id[EOS_WORD]
        self.sep_id = vocab2id[SEP_WORD]
        self.cls_id = vocab2id[CLS_WORD]
        self.mask_id = vocab2id[MASK_WORD]

    def __len__(self):
        return len(self.vocab2id)

    def get(self, word: str) -> int:
        return self.vocab2id.get(word, self.unk_id)

    def ids(self, words: Iterable[str]) -> List[int]:
        # hot loop (every featurized token passes through here): bind the
        # dict lookup once instead of a method call per token
        get = self.vocab2id.get
        unk = self.unk_id
        return [get(w, unk) for w in words]

    def words(self, ids: Iterable[int]) -> List[str]:
        return [self.id2vocab.get(int(i), UNK_WORD) for i in ids]

    def tokenizer(self) -> WordPieceTokenizer:
        # cached: the tokenizer lazily builds a native wordpiece table
        # (~10 ms for a BERT-size vocab) that serving would otherwise
        # rebuild per request chunk. The native tokenizer reuses an output
        # buffer under a lock: the replicas' threads featurize at once.
        tok = getattr(self, "_tokenizer", None)
        if tok is None:
            tok = WordPieceTokenizer(self.vocab2id, unk_word=UNK_WORD)
            self._tokenizer = tok
        return tok

    @staticmethod
    def detokenizer():
        return bert_detokenize

    # ---- construction ----

    @classmethod
    def from_bert_vocab_file(cls, path: str) -> "Vocabulary":
        """Line number = id. Blank or duplicate lines keep their id slot via
        unique placeholder tokens so ids stay contiguous (and ``save``
        round-trips)."""
        vocab2id: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if not tok or tok in vocab2id:
                    tok = f"[unused_slot_{i}]"
                vocab2id[tok] = i
        id2vocab = {i: w for w, i in vocab2id.items()}
        return cls(vocab2id, id2vocab)

    @classmethod
    def build_from_texts(cls, texts: Iterable[List[str]],
                         min_freq: int = 1,
                         max_size: Optional[int] = None) -> "Vocabulary":
        """Build a word-level vocab: specials in canonical order, then corpus
        tokens by (-freq, token) for determinism."""
        counter: collections.Counter = collections.Counter()
        for toks in texts:
            counter.update(toks)
        vocab2id = {w: i for i, w in enumerate(SPECIAL_WORDS)}
        items = sorted(counter.items(), key=lambda kv: (-kv[1], kv[0]))
        for w, c in items:
            if c < min_freq or w in vocab2id:
                continue
            if max_size is not None and len(vocab2id) >= max_size:
                break
            vocab2id[w] = len(vocab2id)
        id2vocab = {i: w for w, i in vocab2id.items()}
        return cls(vocab2id, id2vocab)

    # ---- persistence ----

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        ordered = [self.id2vocab[i] for i in range(len(self.id2vocab))]
        with open(path, "w", encoding="utf-8") as f:
            f.write("\n".join(ordered) + "\n")

    @classmethod
    def load(cls, path: str) -> "Vocabulary":
        return cls.from_bert_vocab_file(path)


def load_freq_table(path: str, vocab: Vocabulary, threshold: int = 0
                    ) -> Dict[int, float]:
    """``token\\tfreq`` file -> {vocab_id: freq}, with the reference's
    smoothing: ids 0..3 get the mean frequency (common/Utils.py:419-434,
    Prepare_dataset.py:29-35)."""
    id2freq: Dict[int, float] = {}
    total = 0.0
    n = 0
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").rstrip("\r").split("\t")
            if len(parts) != 2:
                continue
            word, freq_s = parts
            try:
                freq = int(freq_s)
            except ValueError:
                continue
            if freq < threshold:
                continue
            if word in vocab.vocab2id:
                id2freq[vocab.vocab2id[word]] = float(freq)
            total += freq
            n += 1
    mean = total / max(n, 1)
    for sid in (vocab.pad_id, vocab.bos_id, vocab.unk_id, vocab.eos_id):
        id2freq[sid] = mean
    return id2freq


def freq_table_from_counts(counts: Dict[str, int], vocab: Vocabulary
                           ) -> Dict[int, float]:
    """Frequency table from in-corpus counts when no marco.vocab file exists."""
    id2freq = {vocab.vocab2id[w]: float(c) for w, c in counts.items()
               if w in vocab.vocab2id}
    mean = (sum(id2freq.values()) / len(id2freq)) if id2freq else 1.0
    for sid in (vocab.pad_id, vocab.bos_id, vocab.unk_id, vocab.eos_id):
        id2freq[sid] = mean
    return id2freq


def save_freq_table(path: str, id2freq: Dict[int, float]):
    with open(path, "w", encoding="utf-8") as f:
        json.dump({str(k): v for k, v in id2freq.items()}, f)


def load_freq_table_json(path: str) -> Dict[int, float]:
    with open(path, encoding="utf-8") as f:
        return {int(k): float(v) for k, v in json.load(f).items()}
