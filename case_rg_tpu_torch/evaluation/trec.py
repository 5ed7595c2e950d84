"""TREC ranking metrics: MAP / NDCG / recall@k (a copy of
``case_rg_tpu/evaluation/trec.py``).

Self-contained replacement for the pytrec_eval dependency
(evaluation/Eval_Trec.py:4-36 computes {'recall','map','ndcg'} macro-averaged
over queries). Definitions follow trec_eval:

* documents are ranked by (score desc, docid desc) — trec_eval's tie-break;
* map: average precision over all relevant docs (missing docs count 0);
* ndcg: LINEAR-gain DCG (gain = rel, trec_eval m_ndcg.c — not the
  exponential 2^rel-1 variant) with Jarvelin discount 1/log2(max(rank, 2))
  over the full ranking, normalized by the ideal DCG;
* recall_k for the standard cutoff set {5, 10, 15, 20, 30, 100, 200, 500,
  1000}.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, Iterable

RECALL_CUTOFFS = (5, 10, 15, 20, 30, 100, 200, 500, 1000)


def parse_run(lines: Iterable[str]) -> Dict[str, Dict[str, float]]:
    """6-column TREC run lines -> {qid: {docid: score}}
    (ref: evaluation/Eval_Trec.py:9-18)."""
    run: Dict[str, Dict[str, float]] = collections.defaultdict(dict)
    for line in lines:
        parts = line.strip().split()
        if len(parts) != 6:
            continue
        qid, _, docid, _, score, _ = parts
        run[qid][docid] = float(score)
    return dict(run)


def parse_qrel(lines: Iterable[str]) -> Dict[str, Dict[str, int]]:
    """4-column qrel lines -> {qid: {docid: rel}} (header lines skipped)."""
    qrel: Dict[str, Dict[str, int]] = collections.defaultdict(dict)
    for line in lines:
        parts = line.strip().split()
        if len(parts) != 4 or parts[0].startswith("#"):
            continue
        qid, _, docid, rel = parts
        try:
            qrel[qid][docid] = int(rel)
        except ValueError:
            continue
    return dict(qrel)


def _ranked_docs(doc_scores: Dict[str, float]):
    """Sort by (score desc, docid desc) — trec_eval's tie-break."""
    return [d for d, _ in sorted(doc_scores.items(),
                                 key=lambda kv: (kv[1], kv[0]), reverse=True)]


def average_precision(ranked, rels: Dict[str, int]) -> float:
    num_rel = sum(1 for r in rels.values() if r > 0)
    if num_rel == 0:
        return 0.0
    hits, ap = 0, 0.0
    for i, d in enumerate(ranked):
        if rels.get(d, 0) > 0:
            hits += 1
            ap += hits / (i + 1)
    return ap / num_rel


def ndcg(ranked, rels: Dict[str, int]) -> float:
    """trec_eval semantics (m_ndcg.c): linear gain = rel, Jarvelin discount
    1/log2(max(rank, 2)) — ranks 1 and 2 undiscounted."""
    def disc(rank1):  # 1-indexed rank
        return math.log2(max(rank1, 2))

    dcg = sum(rels.get(d, 0) / disc(i + 1) for i, d in enumerate(ranked))
    ideal = sorted((r for r in rels.values() if r > 0), reverse=True)
    idcg = sum(r / disc(i + 1) for i, r in enumerate(ideal))
    return dcg / idcg if idcg > 0 else 0.0


def recall_at(ranked, rels: Dict[str, int], k: int) -> float:
    num_rel = sum(1 for r in rels.values() if r > 0)
    if num_rel == 0:
        return 0.0
    got = sum(1 for d in ranked[:k] if rels.get(d, 0) > 0)
    return got / num_rel


def eval_trec(run: Dict[str, Dict[str, float]],
              qrel: Dict[str, Dict[str, int]]) -> Dict[str, float]:
    """Macro-average over queries present in BOTH run and qrel (pytrec_eval
    evaluates run queries that have judgments)."""
    totals: Dict[str, float] = collections.defaultdict(float)
    n = 0
    for qid, doc_scores in run.items():
        rels = qrel.get(qid)
        if not rels:
            continue
        ranked = _ranked_docs(doc_scores)
        n += 1
        totals["map"] += average_precision(ranked, rels)
        totals["ndcg"] += ndcg(ranked, rels)
        for k in RECALL_CUTOFFS:
            totals[f"recall_{k}"] += recall_at(ranked, rels, k)
    if n == 0:
        return {}
    return {k: v / n for k, v in totals.items()}


def eval_trec_file(run_file: str, qrel_file: str) -> Dict[str, float]:
    with open(run_file, encoding="utf-8") as f:
        run = parse_run(f)
    with open(qrel_file, encoding="utf-8") as f:
        qrel = parse_qrel(f)
    return eval_trec(run, qrel)
