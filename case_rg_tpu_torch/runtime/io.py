"""Result materialization: .answer / .run files and shard merging (a copy
of ``case_rg_tpu/runtime/io.py``).

TPU-native rebuild of Utils.py:5-49 (``save_result``) and the shard-merge
half of Run_Evaluation.py:28-71. Ids and passage-id strings never touch the
device — predictions arrive as (host_batch, output-arrays) pairs and are
joined with the prepared-sample metadata here.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Sequence

import numpy as np

from ..constants import BOS_WORD, EOS_WORD, PAD_WORD, UNK_WORD
from ..data.vocab import Vocabulary


def ids_to_words(ids: Sequence[int], vocab: Vocabulary) -> List[str]:
    """Token ids -> words, skipping BOS/PAD, stopping at EOS — WITHOUT the
    empty->[UNK] filler (token streaming wants honest partial prefixes)."""
    words = []
    for i in ids:
        w = vocab.id2vocab.get(int(i), UNK_WORD)
        if w in (BOS_WORD, PAD_WORD):
            continue
        if w == EOS_WORD:
            break
        words.append(w)
    return words


def ids_to_sentence(ids: Sequence[int], vocab: Vocabulary) -> List[str]:
    """Token ids -> words, skipping BOS/PAD, stopping at EOS; empty -> [UNK]
    (ref: common/Utils.py:200-217)."""
    return ids_to_words(ids, vocab) or [UNK_WORD]


def remove_duplicate_once(sents: List[List[str]], n: int = 3) -> bool:
    """(ref: common/Utils.py:180-193)"""
    changed = False
    for b, sent in enumerate(sents):
        if len(sent) <= n:
            continue
        for i in range(len(sent) - n):
            index = len(sent) - i - n
            if all(tok in sent[:index] for tok in sent[index:]):
                sents[b] = sent[:index]
                changed = True
                break
    return changed


def remove_duplicate(sents: List[List[str]], n: int = 3):
    """Iteratively trim trailing n-grams wholly contained in the prefix
    (ref: common/Utils.py:195-198)."""
    while remove_duplicate_once(sents, n):
        pass


def save_results(predictions: Iterable[tuple], meta: List[dict],
                 vocab: Vocabulary, output_path: str, local_rank: int,
                 epoch: int, eval_type: str):
    """predictions: iterable of (host_batch, outputs) where outputs may hold
    'answer' [B, T] ids and/or 'rank' [B, P] scores (ref: Utils.py:5-49)."""
    detok = vocab.detokenizer()
    answers: List[str] = []
    run_lines: List[str] = []
    for batch, out in predictions:
        weights = batch.get("sample_weight")
        indices = batch.get("_indices")
        bsz = len(batch["id"])
        sents = None
        if "answer" in out:
            sents = [ids_to_sentence(row, vocab) for row in np.asarray(out["answer"])]
            remove_duplicate(sents)
        for i in range(bsz):
            if weights is not None and weights[i] == 0:
                continue  # padded duplicate row
            m = meta[int(indices[i] if indices is not None else batch["id"][i])]
            if sents is not None:
                answers.append("\t".join([
                    ";".join(m["context_id"]), m["query_id"],
                    ";".join(m["passage_id"]), detok(sents[i])]))
            if "rank" in out:
                scores = np.asarray(out["rank"][i])
                pool = m["passage_pool_id"]
                order = np.argsort(-scores[: len(pool)], kind="stable")
                for r, j in enumerate(order):
                    run_lines.append(" ".join([
                        m["query_id"], "Q0", pool[int(j)], str(r + 1),
                        str(float(scores[int(j)])), "system"]))

    result_dir = os.path.join(output_path, "result")
    os.makedirs(result_dir, exist_ok=True)
    if answers:
        p = os.path.join(result_dir, f"{eval_type}_{epoch}.{local_rank}.answer")
        with open(p, "w", encoding="utf-8") as f:
            f.write("\n".join(answers) + "\n")
    if run_lines:
        p = os.path.join(result_dir, f"{eval_type}_{epoch}.{local_rank}.run")
        with open(p, "w", encoding="utf-8") as f:
            f.write("\n".join(run_lines) + "\n")


def merge_shards(result_dir: str) -> Dict[str, Dict[str, str]]:
    """Concatenate per-rank shards into .all.answer / .all.run per prefix
    (ref: Run_Evaluation.py:28-71). Returns {prefix: {kind: merged_path}}."""
    groups: Dict[str, Dict[str, List[str]]] = {}
    for fname in sorted(os.listdir(result_dir)):
        if fname.endswith(".all.answer") or fname.endswith(".all.run"):
            continue
        kind = "answer" if fname.endswith(".answer") else (
            "run" if fname.endswith(".run") else None)
        if kind is None:
            continue
        prefix = fname.split(".")[0]
        groups.setdefault(prefix, {}).setdefault(kind, []).append(fname)

    merged: Dict[str, Dict[str, str]] = {}
    for prefix, kinds in groups.items():
        merged[prefix] = {}
        for kind, files in kinds.items():
            out_path = os.path.join(result_dir, f"{prefix}.all.{kind}")
            with open(out_path, "w", encoding="utf-8") as out:
                for fname in sorted(files):
                    with open(os.path.join(result_dir, fname), encoding="utf-8") as f:
                        out.write(f.read())
            merged[prefix][kind] = out_path
    return merged
