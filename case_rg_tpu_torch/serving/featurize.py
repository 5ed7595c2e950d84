"""Request featurization for online serving (a copy of
``case_rg_tpu/serving/featurize.py``).

Requests are tokenized and featurized on the host with the SAME code path
as the offline pipeline (data/featurize.py, mirroring the reference's
Prepare_dataset.py:51-132 loaders), so serving and evaluation are
guaranteed to agree. All texts of a chunk are tokenized in ONE native
batch call — the per-sentence ctypes crossing dominated the host
featurizer at device-rate serving (the JAX package's docs/PERF.md).
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List

import numpy as np

from ..config import DataConfig
from ..data.featurize import featurize
from ..data.text import split_sentences
from ..data.vocab import Vocabulary


def featurize_requests(requests: List[dict], model: str, vocab: Vocabulary,
                       dcfg: DataConfig) -> Dict[str, np.ndarray]:
    """Requests -> the same fixed-shape arrays the offline pipeline emits
    (tokenization mirrors data/loaders.load_query/load_passage)."""
    tok = vocab.tokenizer()
    texts: List[str] = []
    meta = []   # per request: (query_i, [hist_i], [[sent_i per passage]])
    for i, req in enumerate(requests):
        qi = len(texts)
        texts.append(req.get("query", ""))
        his = []
        for h in req.get("history", []):
            his.append(len(texts))
            texts.append(h)
        n_pass = len(req.get("passages", []))
        if n_pass > dcfg.num_passage:
            print(f"[serve] warning: request {req.get('id', i)!r} has "
                  f"{n_pass} passages; only the first {dcfg.num_passage} "
                  "are scored (raise --num_passage to cover the pool)",
                  file=sys.stderr)
        ps = []
        # passages beyond the pool size are discarded by featurize() —
        # don't pay to sentence-split/tokenize them (the warning above
        # already fired)
        for ptext in req.get("passages", [])[: dcfg.num_passage]:
            sidx = []
            for sent in split_sentences(ptext):
                sidx.append(len(texts))
                texts.append(sent)
            ps.append(sidx)
        meta.append((qi, his, ps))
    toked = tok.batch(texts)

    query: Dict[str, List[str]] = {}
    passage: Dict[str, List[str]] = {}
    samples = []
    for i, (qi, his, ps) in enumerate(meta):
        qid = f"q{i}"
        query[qid] = toked[qi]
        ctx_ids = []
        for j, hi in enumerate(his):
            cid = f"q{i}_h{j}"
            query[cid] = toked[hi]
            ctx_ids.append(cid)
        pool = []
        for j, sidx in enumerate(ps):
            pid = f"p{i}_{j}"
            joined = " [SEP] ".join(" ".join(toked[s]) for s in sidx)
            passage[pid] = joined.split(" ") if joined else []
            pool.append(pid)
        samples.append({"query_id": qid, "context_id": ctx_ids,
                        "passage_pool_id": pool, "passage_id": [],
                        "answer": []})
    arrays = featurize(model, samples, query, passage, vocab, None, dcfg)
    return arrays


def chunk_to_batch(chunk: List[dict], model: str, vocab: Vocabulary,
                   dcfg: DataConfig, bs: int) -> Dict[str, np.ndarray]:
    """Featurize one request chunk into a fixed-size padded batch
    (pad rows repeat the last request; sample_weight flags them).

    A request's optional ``max_tokens`` becomes the per-row response cap
    (``response_cap``): the continuous decode ends the row there; the
    batch paths truncate host-side (greedy/sampled prefixes are
    unaffected by later steps, so both give the same answer)."""
    arrays = featurize_requests(chunk, model, vocab, dcfg)
    real = len(chunk)
    batch: Dict[str, np.ndarray] = {}
    for k, v in arrays.items():
        if k == "passage_labels":
            continue
        batch[k] = np.concatenate([v, np.repeat(v[-1:], bs - real, axis=0)]) \
            if real < bs else v
    if "passage_labels" in arrays:   # no golds at serving time
        batch["passage_label"] = np.zeros(bs, np.int32)
    w = np.zeros(bs, np.float32)
    w[:real] = 1.0
    batch["sample_weight"] = w
    cap = np.full(bs, dcfg.answer_len, np.int32)
    for i, r in enumerate(chunk):
        if "max_tokens" in r:
            cap[i] = max(1, min(int(r["max_tokens"]), dcfg.answer_len))
    batch["response_cap"] = cap
    return batch


def read_requests(src):
    for line in src:
        if line.strip():
            yield json.loads(line)


def read_chunks(src, size: int):
    chunk: List[dict] = []
    for req in read_requests(src):
        chunk.append(req)
        if len(chunk) == size:
            yield chunk
            chunk = []
    if chunk:
        yield chunk


def bucket_for(n_passages: int, buckets: List[int]) -> int:
    """Smallest bucket that fits the pool (over-long pools get the largest
    bucket and are truncated with the featurizer's warning)."""
    for b in buckets:
        if n_passages <= b:
            return b
    return buckets[-1]


def parse_buckets(spec: str, cap: int,
                  flag: str = "--pool_buckets") -> List[int]:
    """Parse a bucket-size list; ``cap`` (num_passage resp. batch_size)
    always joins as the largest bucket so inputs bigger than every listed
    bucket still run at the full configured size (not silently truncated)."""
    buckets = {int(x) for x in spec.split(",") if x}
    if any(b <= 0 for b in buckets):
        raise SystemExit(f"{flag} entries must be positive")
    buckets.add(cap)
    return sorted(buckets)
