"""Supervision-label construction (vectorized numpy; a copy of
``case_rg_tpu/data/labels.py``).

* CaSE supporting-token labels + confidence weights — 1/3/5-gram overlap
  against the answer, scaled by inverse log-frequency, ^0.2
  (ref: CaSE/CaSEDataset.py:6-28). Bit-compatible with the reference's
  per-token Python loops but vectorized over [num_passage, passage_len].
* GLKS sliding-window selection soft labels
  (ref: GLKS/GLKSDataset.py:6-20).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def _window_overlap_counts(tokens: np.ndarray, answer_set: set, size: int) -> np.ndarray:
    """For each position: |distinct window members that appear in answer_set|,
    window of ``size`` centered with (size-1)/2 zero padding (stride 1)."""
    pad = (size - 1) // 2
    padded = np.concatenate([np.zeros(pad, tokens.dtype), tokens, np.zeros(pad, tokens.dtype)])
    n = tokens.shape[0]
    out = np.empty(n, np.float32)
    windows = np.lib.stride_tricks.sliding_window_view(padded, size)
    for i in range(n):
        out[i] = len(set(windows[i].tolist()) & answer_set)
    return out


def _dense_freq(id2freq: Dict[int, float], vocab_size: int) -> np.ndarray:
    out = np.zeros(vocab_size, np.float32)
    for k, v in id2freq.items():
        if 0 <= int(k) < vocab_size:
            out[int(k)] = v
    return out


def case_token_labels(passages: np.ndarray, answer: Sequence[int],
                      id2freq: Dict[int, float],
                      use_native: bool = True
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """passages: [P, L] int ids (padded); answer: unpadded answer ids
    (including EOS). Returns (labels [P, L], confidences [P, L]).

    Dispatches to the C kernel (native/fastprep.cpp) when available; the
    Python path below is the readable specification and fallback."""
    if use_native:
        from .. import native as _native

        vocab_size = int(max(int(np.max(passages, initial=0)),
                             max([int(a) for a in answer], default=0),
                             max((int(k) for k in id2freq), default=0))) + 1
        res = _native.case_token_labels(
            np.asarray(passages, np.int32),
            np.asarray(list(answer), np.int32),
            _dense_freq(id2freq, vocab_size))
        if res is not None:
            return res
    answer_set = set(int(a) for a in answer)
    p, l = passages.shape
    labels = np.zeros((p, l), np.float32)
    confs = np.zeros((p, l), np.float32)
    freq_lookup = np.vectorize(lambda t: id2freq.get(int(t), 0.0), otypes=[np.float32])
    for pi in range(p):
        toks = passages[pi]
        freq = freq_lookup(toks)
        gram1 = np.isin(toks, list(answer_set)).astype(np.float32)
        gram3 = _window_overlap_counts(toks, answer_set, 3)
        gram5 = _window_overlap_counts(toks, answer_set, 5)
        logf = np.log(freq + 2.0)
        inv = logf.sum() / logf  # scalar-sum / per-token (CaSEDataset.py:21-22)
        conf = np.power(np.maximum(inv * gram1 * gram3 * gram5, 0.0), 0.2)
        conf = np.where(gram1 > 0, conf, 1.0)
        labels[pi] = gram1
        confs[pi] = conf
    return labels, confs


def glks_selection_label(background: np.ndarray, answer: Sequence[int],
                         min_window_size: int = 5, n_windows: int = 4,
                         use_native: bool = True) -> np.ndarray:
    """Soft distribution over sliding windows of sizes
    {min_ws, 2*min_ws, ..., n*min_ws} with stride min_ws: softmax of distinct
    overlap counts with the answer (ref: GLKS/GLKSDataset.py:6-20)."""
    if use_native:
        from .. import native as _native

        vocab_size = int(max(int(np.max(background, initial=0)),
                             max([int(a) for a in answer], default=0))) + 1
        counts = _native.glks_window_overlap(
            np.asarray(background, np.int32),
            np.asarray(list(answer), np.int32),
            min_window_size, n_windows, vocab_size)
        if counts is not None:
            e = np.exp(counts - counts.max())
            return e / e.sum()
    answer_set = set(int(a) for a in answer)
    counts = []
    window_size = min_window_size
    for _ in range(n_windows):
        n_w = (len(background) - window_size) // min_window_size + 1
        for w in range(max(n_w, 0)):
            seg = background[w * min_window_size: w * min_window_size + window_size]
            counts.append(len(set(seg.tolist()) & answer_set))
        window_size += min_window_size
    arr = np.asarray(counts, np.float32)
    e = np.exp(arr - arr.max())
    return e / e.sum()
