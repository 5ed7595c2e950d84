"""Raw TSV loaders and sample assembly (a copy of
``case_rg_tpu/data/loaders.py``).

Rebuild of the offline stage of Prepare_dataset.py:51-207. File
formats (documented at the reference's README.md:16-58):

* ``.answer``  — context-ids;query-id;passage-ids;answer-text (TSV)
* ``.passage`` — passage-id\\tpassage-text
* ``.pool``    — TREC run lines: qid Q0 pid rank score model
* ``.qrel``    — qid 0 pid relevance
* ``.query``   — query-id\\tquery-text
* ``.split``   — query-id\\ttrain|dev|test

Sample assembly reproduces the reference's pool construction: shuffle the
(shared!) candidate list, force gold passages in, then fill to ``topk`` with
non-gold, non-qrel candidates, and shuffle the final pool
(Prepare_dataset.py:160-195). The qrel exclusion uses exact-id membership
(the reference tests ``p not in q_qrel`` against a *string*, i.e. substring
matching — an accidental behavior we do not reproduce).
"""

from __future__ import annotations

import os
import random
from typing import Callable, Dict, List, Optional, Set, Tuple

from .text import split_sentences

Tokenizer = Callable[[str], List[str]]


def load_answer(path: str, tokenizer: Tokenizer) -> List[list]:
    """Rows [context_ids, query_id, passage_ids, answer_tokens]
    (ref: Prepare_dataset.py:51-65)."""
    rows = []
    with open(path, encoding="utf-8") as f:
        next(f)
        for line in f:
            parts = line.strip("\n").strip("\r").split("\t")
            if len(parts) < 4:
                continue
            ctx = parts[0].split(";") if parts[0] else []
            rows.append([ctx, parts[1], parts[2].split(";"), tokenizer(parts[3])])
    return rows


def load_pool(path: str, topk: int = 100) -> Dict[str, List[str]]:
    """Top-k candidate passages per query (ref: Prepare_dataset.py:81-94)."""
    pool: Dict[str, List[str]] = {}
    with open(path, encoding="utf-8") as f:
        next(f)
        for line in f:
            parts = line.strip("\n").strip("\r").split(" ")
            if len(parts) != 6:
                continue
            qid, pid = parts[0], parts[2]
            lst = pool.setdefault(qid, [])
            if len(lst) < topk:
                lst.append(pid)
    return pool


def load_qrel(path: str) -> Dict[str, str]:
    """Positive-relevance passage per query (ref: Prepare_dataset.py:96-105)."""
    qrel: Dict[str, str] = {}
    with open(path, encoding="utf-8") as f:
        next(f)
        for line in f:
            parts = line.strip("\n").strip("\r").split(" ")
            if len(parts) == 4 and int(parts[3]) > 0:
                qrel[parts[0]] = parts[2]
    return qrel


def _batch_tokenize(tokenizer: Tokenizer, texts: List[str],
                    chunk: int = 8192) -> List[List[str]]:
    """Tokenize many texts, using the tokenizer's batched native call when
    it has one (one ctypes crossing per ``chunk`` texts — corpus-scale
    prep and serving featurization are dominated by per-call overhead
    otherwise, docs/PERF.md). Byte-identical to mapping the tokenizer."""
    bat = getattr(tokenizer, "batch", None)
    if bat is None:
        return [tokenizer(t) for t in texts]
    out: List[List[str]] = []
    for i in range(0, len(texts), chunk):
        out.extend(bat(texts[i:i + chunk]))
    return out


def load_query(path: str, tokenizer: Tokenizer) -> Dict[str, List[str]]:
    qids: List[str] = []
    texts: List[str] = []
    with open(path, encoding="utf-8") as f:
        next(f)
        for line in f:
            parts = line.strip("\n").strip("\r").split("\t")
            if len(parts) == 2:
                qids.append(parts[0])
                texts.append(parts[1])
    return dict(zip(qids, _batch_tokenize(tokenizer, texts)))


def load_passage(path: str, pool: Optional[Dict[str, List[str]]],
                 tokenizer: Tokenizer) -> Dict[str, List[str]]:
    """Sentence-split + tokenize passages, ' [SEP] '-joined, restricted to
    pooled ids (ref: Prepare_dataset.py:67-79)."""
    poolset: Set[str] = set()
    if pool is not None:
        for pids in pool.values():
            poolset.update(pids)
    rows: List[Tuple[str, int, int]] = []   # (pid, first sent idx, n sents)
    texts: List[str] = []
    with open(path, encoding="utf-8") as f:
        next(f)
        for line in f:
            parts = line.strip("\n").strip("\r").split("\t")
            if len(parts) == 2 and (pool is None or parts[0] in poolset):
                sents = split_sentences(parts[1])
                rows.append((parts[0], len(texts), len(sents)))
                texts.extend(sents)
    toked = _batch_tokenize(tokenizer, texts)
    passages: Dict[str, List[str]] = {}
    for pid, first, n in rows:
        joined = " [SEP] ".join(
            " ".join(t) for t in toked[first:first + n])
        passages[pid] = joined.split(" ") if joined else []
    return passages


def load_split(path: str) -> Tuple[Set[str], Set[str], Set[str]]:
    train, dev, test = set(), set(), set()
    buckets = {"train": train, "dev": dev, "test": test}
    with open(path, encoding="utf-8") as f:
        next(f)
        for line in f:
            parts = line.strip("\n").strip("\r").split("\t")
            if len(parts) == 2 and parts[1] in buckets:
                buckets[parts[1]].add(parts[0])
    return train, dev, test


def assemble_samples(answer_file: str, passage_file: str, pool_file: Optional[str],
                     qrel_file: str, query_file: str,
                     query_reformulation_file: Optional[str],
                     tokenizer: Tokenizer, topk: int = 10,
                     pool_candidates: int = 100, randoms: int = 1, seed: int = 1):
    """Pool construction + passage loading (ref: Prepare_dataset.py:148-199).

    Returns (samples, query, reformulated_query, passage)."""
    rng = random.Random(seed)
    answers = load_answer(answer_file, tokenizer)
    pool = load_pool(pool_file, pool_candidates) if pool_file else None
    query = load_query(query_file, tokenizer)
    qrel = load_qrel(qrel_file) if qrel_file and os.path.exists(qrel_file) else {}
    reformulated = None
    if query_reformulation_file and os.path.exists(query_reformulation_file):
        reformulated = load_query(query_reformulation_file, tokenizer)

    samples = []
    dropped = 0
    for row in answers:
        for _ in range(randoms):
            c_id, q_id, p_id, ans = row[:4]
            # partial corpora (like the in-repo reference sample) reference
            # queries that are absent from .query: drop such samples instead
            # of crashing at featurization time
            if q_id not in query or any(c not in query for c in c_id):
                dropped += 1
                continue
            q_pool = None
            if pool is not None:
                q_pool = pool.get(q_id, [])
                rng.shuffle(q_pool)  # in place on the shared list, as in the ref
            sample = {
                "context_id": c_id,
                "query_id": q_id,
                "passage_id": list(p_id),
                "answer": ans,
                "passage_pool_id": list(p_id),
            }
            gold_qrel = {qrel[q_id]} if q_id in qrel else set()
            if q_pool is not None:
                for p in p_id:
                    if p not in q_pool:
                        q_pool.append(p)
                for p in q_pool:
                    if len(sample["passage_pool_id"]) == topk:
                        break
                    if p not in sample["passage_pool_id"] and p not in gold_qrel:
                        sample["passage_pool_id"].append(p)
            rng.shuffle(sample["passage_pool_id"])
            samples.append(sample)

    passage = load_passage(passage_file, pool, tokenizer)
    if dropped:
        print(f"[loaders] dropped {dropped} samples with missing queries")
    return samples, query, reformulated, passage


def split_samples(split_file: str, samples: List[dict]):
    """(ref: Prepare_dataset.py:134-146)"""
    train, dev, test = load_split(split_file)
    out = ([], [], [])
    for s in samples:
        if s["query_id"] in train:
            out[0].append(s)
        elif s["query_id"] in dev:
            out[1].append(s)
        elif s["query_id"] in test:
            out[2].append(s)
    return out


def merge_eval(samples: List[dict]) -> List[dict]:
    """Dedup dev/test by (context, query, pool) key
    (ref: Prepare_dataset.py:201-207)."""
    seen = {}
    for s in samples:
        key = "-".join(s["context_id"]) + "_" + s["query_id"] + "_" + "-".join(s["passage_pool_id"])
        if key not in seen:
            seen[key] = dict(s)
    return list(seen.values())
