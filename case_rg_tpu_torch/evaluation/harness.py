"""Evaluation orchestrator (a copy of
``case_rg_tpu/evaluation/harness.py``).

Rebuild of Run_Evaluation.py:28-90: merge per-rank result shards, score run
files against qrels (MAP/NDCG/recall) and answer files against gold answers
(ROUGE/BLEU/METEOR, plus the overlap metric the reference defines but never
wires in). Tokenization uses the framework's own tokenizer (data/text.py).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

from ..data.text import basic_tokenize, bert_detokenize
from ..runtime.io import merge_shards
from .bleu import eval_bleu
from .meteor import eval_meteor
from .overlap import eval_overlap
from .rouge import eval_rouge
from .trec import eval_trec_file

KEY_SEP = "##<>##"


def _load_answers(path: str, tokenizer: Callable) -> Dict[str, List[str]]:
    """prediction file: key = query_id##<>##passage_ids
    (ref: Eval_Rouge.py:25-31)."""
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").rstrip("\r").split("\t")
            if len(parts) == 4:
                out[parts[1] + KEY_SEP + parts[2]] = tokenizer(parts[3])
    return out


def _load_refs(path: str, tokenizer: Callable) -> Dict[str, List[List[str]]]:
    refs: Dict[str, List[List[str]]] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").rstrip("\r").split("\t")
            if len(parts) == 4:
                refs.setdefault(parts[1], []).append(tokenizer(parts[3]))
    return refs


def eval_answer_file(run_file: str, ref_file: str,
                     tokenizer: Callable = basic_tokenize) -> Dict[str, float]:
    run = _load_answers(run_file, tokenizer)
    refs = _load_refs(ref_file, tokenizer)
    hyps_tok, refs_tok = [], []
    for key, hyp in run.items():
        qid = key.split(KEY_SEP)[0]
        if qid not in refs:
            continue
        hyps_tok.append(hyp)
        refs_tok.append(refs[qid])
    detok_hyps = [bert_detokenize(h).split() for h in hyps_tok]
    detok_refs = [[bert_detokenize(r).split() for r in rs] for rs in refs_tok]
    metrics: Dict[str, float] = {}
    metrics.update(eval_rouge([" ".join(h) for h in detok_hyps],
                              [[" ".join(r) for r in rs] for rs in detok_refs]))
    metrics.update(eval_bleu(hyps_tok, refs_tok))
    metrics.update(eval_meteor(detok_hyps, detok_refs))
    return metrics


def eval_all(result_dir: str, qrel_file: Optional[str],
             gt_answer_file: Optional[str],
             tokenizer: Callable = basic_tokenize,
             verbose: bool = True) -> Dict[str, Dict[str, float]]:
    """Merge shards then evaluate every result prefix
    (ref: Run_Evaluation.py:28-90)."""
    merged = merge_shards(result_dir)
    if verbose:
        # data-drop-in observability: METEOR's synonym stage uses real
        # WordNet when its corpus is loadable, else the curated embedded
        # table (evaluation/meteor.py). Numbers from the two variants are
        # NOT comparable — log which produced this report.
        from .meteor import METEOR_VARIANT
        print(f"[eval] meteor synonym stage: {METEOR_VARIANT}"
              + ("" if METEOR_VARIANT == "wordnet" else
                 " (curated table; NOT WordNet-comparable — install the "
                 "nltk wordnet corpus for reference-exact METEOR)"),
              flush=True)
    report: Dict[str, Dict[str, float]] = {}
    for prefix, kinds in sorted(merged.items()):
        metrics: Dict[str, float] = {}
        if "run" in kinds and qrel_file and os.path.exists(qrel_file):
            metrics.update(eval_trec_file(kinds["run"], qrel_file))
        if "answer" in kinds and gt_answer_file and os.path.exists(gt_answer_file):
            metrics.update(eval_answer_file(kinds["answer"], gt_answer_file,
                                            tokenizer))
        report[prefix] = metrics
        if verbose:
            print(f"[eval] {prefix}: {metrics}", flush=True)
    return report
