"""Answer-vs-pool n-gram overlap ratios (1..4) (a copy of
``case_rg_tpu/evaluation/overlap.py``).

Rebuild of evaluation/Eval_Overlap.py:7-61 — defined by the reference but
not wired into its orchestrator; exposed here as a first-class metric.
"""

from __future__ import annotations

from typing import Dict, List, Sequence


def ngram_set(words: Sequence[str], n: int) -> set:
    return {" ".join(words[i:i + n]) for i in range(len(words) - n + 1)}


def overlap_ratio(answer: set, passage: set) -> float:
    if not answer:
        return 0.0
    return len(answer & passage) / len(answer)


def eval_overlap(answers: List[Sequence[str]], pools: List[Sequence[str]]
                 ) -> Dict[str, float]:
    """answers[i]: predicted answer tokens; pools[i]: concatenated tokens of
    the sample's pooled passages."""
    out = {}
    n_samples = max(len(answers), 1)
    for n in range(1, 5):
        total = 0.0
        for ans, pool in zip(answers, pools):
            a = set(ans) if n == 1 else ngram_set(ans, n)
            p = set(pool) if n == 1 else ngram_set(pool, n)
            total += overlap_ratio(a, p)
        out[f"Overlap-{n}"] = round(total * 100 / n_samples, 2)
    return out
