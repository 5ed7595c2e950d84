"""ROUGE-1/2/L F1 (x100, max over references) (a copy of
``case_rg_tpu/evaluation/rouge.py``).

Self-contained implementation of the metric surface at
evaluation/Eval_Rouge.py:24-68 backed by the vendored Google-seq2seq
definitions (evaluation/Rouge.py): set-based distinct n-gram precision/recall
with F1 = 2pr/(p+r+1e-8), and summary-level LCS with the beta-weighted
F-measure.
"""

from __future__ import annotations

from typing import Dict, List, Sequence


def _ngrams(tokens: Sequence[str], n: int) -> set:
    return {tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1)}


def rouge_n(hyp: Sequence[str], ref: Sequence[str], n: int) -> float:
    h, r = _ngrams(hyp, n), _ngrams(ref, n)
    overlap = len(h & r)
    p = overlap / len(h) if h else 0.0
    rec = overlap / len(r) if r else 0.0
    return 2.0 * p * rec / (p + rec + 1e-8)


def _lcs_len(x: Sequence[str], y: Sequence[str]) -> int:
    m, n = len(x), len(y)
    prev = [0] * (n + 1)
    for i in range(1, m + 1):
        cur = [0] * (n + 1)
        for j in range(1, n + 1):
            if x[i - 1] == y[j - 1]:
                cur[j] = prev[j - 1] + 1
            else:
                cur[j] = max(prev[j], cur[j - 1])
        prev = cur
    return prev[n]


def rouge_l(hyp: Sequence[str], ref: Sequence[str]) -> float:
    """Beta-weighted LCS F (ref math: evaluation/Rouge.py:186-206)."""
    if not hyp or not ref:
        return 0.0
    llcs = _lcs_len(hyp, ref)
    r_lcs = llcs / len(ref)
    p_lcs = llcs / len(hyp)
    beta = p_lcs / (r_lcs + 1e-12)
    num = (1 + beta ** 2) * r_lcs * p_lcs
    denom = r_lcs + (beta ** 2) * p_lcs
    return num / (denom + 1e-12)


def rouge_scores(hyp: str, ref: str) -> Dict[str, float]:
    h, r = hyp.split(), ref.split()
    return {"rouge_1": rouge_n(h, r, 1), "rouge_2": rouge_n(h, r, 2),
            "rouge_l": rouge_l(h, r)}


def eval_rouge(hyps: List[str], refs: List[List[str]]) -> Dict[str, float]:
    """Mean of per-sample max-over-references, x100
    (ref: Eval_Rouge.py:13-22,53-68)."""
    assert len(hyps) == len(refs)
    tot1 = tot2 = totl = 0.0
    for hyp, rset in zip(hyps, refs):
        best = [0.0, 0.0, 0.0]
        for ref in rset:
            s = rouge_scores(hyp, ref)
            best[0] = max(best[0], s["rouge_1"] * 100)
            best[1] = max(best[1], s["rouge_2"] * 100)
            best[2] = max(best[2], s["rouge_l"] * 100)
        tot1 += best[0]
        tot2 += best[1]
        totl += best[2]
    n = max(len(hyps), 1)
    return {"ROUGE_1_F1": round(tot1 / n, 2), "ROUGE_2_F1": round(tot2 / n, 2),
            "ROUGE_L_F1": round(totl / n, 2)}
