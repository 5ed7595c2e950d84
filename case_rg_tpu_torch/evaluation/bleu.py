"""Sentence BLEU (x100, mean over predictions) (a copy of
``case_rg_tpu/evaluation/bleu.py``).

Self-contained replacement for nltk ``sentence_bleu`` as used at
evaluation/Eval_Bleu.py:7-28: uniform 4-gram weights, multi-reference
clipped counts, closest-reference brevity penalty, no smoothing (a zero
modified precision yields 0, matching nltk's behavior without a smoothing
function).
"""

from __future__ import annotations

import collections
import math
from typing import Dict, List, Sequence


def _ngram_counts(tokens: Sequence[str], n: int) -> collections.Counter:
    return collections.Counter(tuple(tokens[i:i + n])
                               for i in range(len(tokens) - n + 1))


def modified_precision(references: List[Sequence[str]], hyp: Sequence[str],
                       n: int):
    counts = _ngram_counts(hyp, n)
    if not counts:
        return 0, 0
    max_counts: Dict[tuple, int] = {}
    for ref in references:
        rc = _ngram_counts(ref, n)
        for g in counts:
            max_counts[g] = max(max_counts.get(g, 0), rc.get(g, 0))
    clipped = sum(min(c, max_counts.get(g, 0)) for g, c in counts.items())
    return clipped, sum(counts.values())


def closest_ref_length(references: List[Sequence[str]], hyp_len: int) -> int:
    return min((abs(len(r) - hyp_len), len(r)) for r in references)[1]


def sentence_bleu(references: List[Sequence[str]], hyp: Sequence[str],
                  weights=(0.25, 0.25, 0.25, 0.25)) -> float:
    hyp_len = len(hyp)
    if hyp_len == 0:
        return 0.0
    ref_len = closest_ref_length(references, hyp_len)
    bp = 1.0 if hyp_len > ref_len else (
        math.exp(1 - ref_len / hyp_len) if hyp_len > 0 else 0.0)
    log_sum = 0.0
    for i, w in enumerate(weights, start=1):
        num, den = modified_precision(references, hyp, i)
        if num == 0:
            return 0.0
        log_sum += w * math.log(num / den)
    return bp * math.exp(log_sum)


def eval_bleu(hyps: List[Sequence[str]], refs: List[List[Sequence[str]]]
              ) -> Dict[str, float]:
    total = sum(sentence_bleu(r, h) for h, r in zip(hyps, refs))
    return {"BLEU": round(total * 100 / max(len(hyps), 1), 2)}
