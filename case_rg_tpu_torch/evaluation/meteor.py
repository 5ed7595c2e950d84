"""METEOR (x100, mean; max over references) (a copy of
``case_rg_tpu/evaluation/meteor.py``).

Replacement for nltk ``meteor_score`` (reference: evaluation/Eval_Meteor.py:7-28)
with nltk's parameters (alpha=0.9, beta=3, gamma=0.5) and its exact 3-stage
alignment — exact, Porter-stem, WordNet-synonym — mirroring the installed
nltk semantics precisely:

* words are lowercased first (nltk ``preprocess=str.lower``);
* every stage scans the hypothesis in REVERSE order and matches each word to
  the LATEST still-unused reference position (nltk ``_match_enums``; the
  pairing, not just the match count, feeds the chunk/fragmentation penalty);
* the synonym stage matches a reference word appearing among the single-word
  lemma names of any synset of the hypothesis word, or the word itself.

Synonym sources, in order (``METEOR_VARIANT`` records which is active and
``eval_meteor`` tags its output):

* ``"wordnet"`` — the real nltk WordNet corpus, when its data is loadable;
* ``"embedded"`` — a compact built-in synonym table (WordNet's data is
  not bundled with nltk and nothing is downloaded); strictly narrower matching than WordNet, so scores
  sit between exact+stem and full-WordNet METEOR;
* ``"exact+stem"`` — synonym stage disabled (pass ``synonyms=None``).

Alignment+math parity against the installed nltk — including the synonym
stage, exercised via an injected fake wordnet — is enforced by
``tests/test_evaluation.py``.

Known reference-environment delta: the reference pins nltk==3.4.5
(requirements.txt:1), whose meteor_score took raw strings (whitespace split,
no lowercasing). That version is not installable here; parity is against the
installed nltk's algorithm, and the harness feeds pre-split tokens
(harness.py:58-64) exactly as the modern API requires.
"""

from __future__ import annotations

from typing import (Callable, Dict, List, Optional, Sequence, Set, Tuple)

try:  # Porter stemmer is pure code (no corpus download needed)
    from nltk.stem.porter import PorterStemmer
    _STEMMER = PorterStemmer()

    def _stem(w: str) -> str:
        return _STEMMER.stem(w)
except Exception:  # pragma: no cover
    def _stem(w: str) -> str:
        return w

SynonymFn = Callable[[str], Set[str]]


def _load_wordnet() -> Optional[SynonymFn]:
    """Real nltk WordNet synonym lookup, or None when the corpus data is
    absent (it is not bundled with nltk, and nothing is downloaded)."""
    try:
        from itertools import chain

        from nltk.corpus import wordnet
        wordnet.synsets("test")  # force the lazy corpus load now
    except Exception:
        return None

    def synonyms(word: str) -> Set[str]:
        return set(
            chain.from_iterable(
                (lem.name() for lem in syn.lemmas() if "_" not in lem.name())
                for syn in wordnet.synsets(word))
        ) | {word}

    return synonyms


# Fallback synonym groups (symmetric), curated in evaluation/synonyms.py —
# ~550 groups biased toward conversational QA/answer vocabulary. Deliberately
# high-precision: embedded-table METEOR must only *loosen* matching toward
# WordNet, never invent matches a human would dispute.
from .synonyms import build_groups

_SYN_GROUPS: List[Set[str]] = build_groups()

_SYN_INDEX: Dict[str, Set[str]] = {}
for _g in _SYN_GROUPS:
    # The synonym stage runs on Porter stems (nltk stage-chaining quirk, see
    # _align), so index the table under both surface and stemmed keys and
    # include stemmed members in each value set.
    _all = set(_g) | {_stem(_w) for _w in _g}
    for _w in _all:
        _SYN_INDEX.setdefault(_w, set()).update(_all)


def _embedded_synonyms(word: str) -> Set[str]:
    return _SYN_INDEX.get(word, set()) | {word}


_wn = _load_wordnet()
if _wn is not None:  # pragma: no cover - WordNet data installed
    DEFAULT_SYNONYMS: Optional[SynonymFn] = _wn
    METEOR_VARIANT = "wordnet"
else:
    DEFAULT_SYNONYMS = _embedded_synonyms
    METEOR_VARIANT = "embedded"


def _match_stage(hyp_enum: List[Tuple[int, str]],
                 ref_enum: List[Tuple[int, str]],
                 key: Callable[[str], str]):
    """nltk ``_match_enums`` semantics: scan the hypothesis in REVERSE and
    match each word to the LATEST still-unused reference position with an
    equal key. Returns (matches, unmatched_hyp, unmatched_ref)."""
    hk = [key(w) for _, w in hyp_enum]
    rk = [key(w) for _, w in ref_enum]
    matches = []
    matched_h: Set[int] = set()
    used_r: Set[int] = set()
    for i in range(len(hyp_enum) - 1, -1, -1):
        for j in range(len(ref_enum) - 1, -1, -1):
            if j not in used_r and hk[i] == rk[j]:
                matches.append((hyp_enum[i][0], ref_enum[j][0]))
                matched_h.add(i)
                used_r.add(j)
                break
    rest_h = [p for i, p in enumerate(hyp_enum) if i not in matched_h]
    rest_r = [p for j, p in enumerate(ref_enum) if j not in used_r]
    return matches, rest_h, rest_r


def _syn_match_stage(hyp_enum: List[Tuple[int, str]],
                     ref_enum: List[Tuple[int, str]],
                     synonyms: SynonymFn):
    """nltk ``_enum_wordnetsyn_match`` semantics: reverse hypothesis scan;
    match the latest still-unused reference word contained in the hypothesis
    word's synonym set."""
    matches = []
    matched_h: Set[int] = set()
    used_r: Set[int] = set()
    for i in range(len(hyp_enum) - 1, -1, -1):
        syns = synonyms(hyp_enum[i][1])
        for j in range(len(ref_enum) - 1, -1, -1):
            if j not in used_r and ref_enum[j][1] in syns:
                matches.append((hyp_enum[i][0], ref_enum[j][0]))
                matched_h.add(i)
                used_r.add(j)
                break
    rest_h = [p for i, p in enumerate(hyp_enum) if i not in matched_h]
    rest_r = [p for j, p in enumerate(ref_enum) if j not in used_r]
    return matches, rest_h, rest_r


def _align(hyp: Sequence[str], ref: Sequence[str],
           synonyms: Optional[SynonymFn]):
    h_enum = list(enumerate(hyp))
    r_enum = list(enumerate(ref))
    exact, h_enum, r_enum = _match_stage(h_enum, r_enum, lambda w: w)
    # nltk quirk reproduced for parity: _enum_stem_match matches on STEMMED
    # enum lists and hands their (stemmed) leftovers straight to the synonym
    # stage — so WordNet lookups there run on stems, not surface words.
    h_enum = [(i, _stem(w)) for i, w in h_enum]
    r_enum = [(j, _stem(w)) for j, w in r_enum]
    stem, h_enum, r_enum = _match_stage(h_enum, r_enum, lambda w: w)
    syn: List[Tuple[int, int]] = []
    if synonyms is not None:
        syn, h_enum, r_enum = _syn_match_stage(h_enum, r_enum, synonyms)
    return sorted(exact + stem + syn)


def _count_chunks(matches: List[Tuple[int, int]]) -> int:
    if not matches:
        return 0
    chunks = 1
    for (h1, r1), (h2, r2) in zip(matches, matches[1:]):
        if h2 != h1 + 1 or r2 != r1 + 1:
            chunks += 1
    return chunks


def single_meteor_score(ref: Sequence[str], hyp: Sequence[str],
                        alpha: float = 0.9, beta: float = 3.0,
                        gamma: float = 0.5,
                        preprocess: Callable[[str], str] = str.lower,
                        synonyms: Optional[SynonymFn] = None,
                        use_default_synonyms: bool = True) -> float:
    if synonyms is None and use_default_synonyms:
        synonyms = DEFAULT_SYNONYMS
    hyp_l = [preprocess(w) for w in hyp]
    ref_l = [preprocess(w) for w in ref]
    matches = _align(hyp_l, ref_l, synonyms)
    m = len(matches)
    if m == 0 or not hyp_l or not ref_l:  # nltk returns 0.0 on ZeroDivision
        return 0.0
    precision = m / len(hyp_l)
    recall = m / len(ref_l)
    fmean = precision * recall / (alpha * precision + (1 - alpha) * recall)
    frag = _count_chunks(matches) / m
    penalty = gamma * frag ** beta
    return (1 - penalty) * fmean


def meteor_score(references: List[Sequence[str]], hyp: Sequence[str],
                 **kw) -> float:
    return max(single_meteor_score(r, hyp, **kw) for r in references)


def eval_meteor(hyps: List[Sequence[str]], refs: List[List[Sequence[str]]]
                ) -> Dict[str, float]:
    total = sum(meteor_score(r, h) for h, r in zip(hyps, refs))
    return {"METEOR": round(total * 100 / max(len(hyps), 1), 2),
            "METEOR_variant": METEOR_VARIANT}
