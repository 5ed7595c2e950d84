"""Self-contained text processing: basic + WordPiece tokenization,
detokenization, sentence splitting (a copy of ``case_rg_tpu/data/text.py``;
the tests named below are the JAX package's, and
``tests/test_torch_textdata.py`` holds this copy equal to it).

The reference shells out to HuggingFace's BertTokenizer and nltk
(common/Utils.py:30-52, Prepare_dataset.py:78). This environment has no
downloaded tokenizer assets, so the framework ships its own implementations:

* ``basic_tokenize`` — the exact BertTokenizer BasicTokenizer algorithm
  (transformers tokenization_bert.py): invalid-char/control removal, CJK
  char isolation, NFC normalization, whitespace split, per-token
  lower + accent strip (NFD, drop Mn), punctuation split. Parity with the
  installed transformers across a Unicode gauntlet is enforced by
  tests/test_data_pipeline.py. Known reference-environment delta: the
  reference pins transformers==2.1.1 (requirements.txt:2), which lacks the
  NFC normalization step (added to HF later) — visible only on
  non-NFC-normalized input whose composed form changes a char class;
* ``WordPieceTokenizer`` — greedy longest-match-first subword tokenization
  against a supplied vocabulary ('##' continuation convention), with
  HF-style ``never_split`` special-token handling. With a word-level
  (corpus-built) vocabulary it degrades gracefully to word-level lookup
  with UNK fallback;
* ``bert_detokenize`` — ' '.join + '##' merge (common/Utils.py:39-42);
* ``split_sentences`` — sentence splitter used when chunking passages
  (Prepare_dataset.py:78). Uses nltk punkt directly when its data is
  installed (exact reference parity); otherwise a curated rule-based
  splitter stands in — punkt is a trained pickle unavailable offline, so
  boundary parity on data-less hosts is approximate by construction
  (gold-case corpus in tests/test_data_pipeline.py; divergence runner in
  tools/exp_sentence_split.py).
"""

from __future__ import annotations

import re
import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

BERT_SPECIAL_TOKENS = ("[UNK]", "[SEP]", "[PAD]", "[CLS]", "[MASK]")


def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_whitespace(ch: str) -> bool:
    # HF _is_whitespace: \t \n \r + category Zs (NOT Python str.isspace,
    # which also accepts Zl/Zp/\x0b/\x0c/\x1c-\x1f)
    if ch in " \t\n\r":
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in "\t\n\r":
        return False
    return unicodedata.category(ch).startswith("C")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


def _clean_text(text: str) -> str:
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        out.append(" " if _is_whitespace(ch) else ch)
    return "".join(out)


def _strip_accents(token: str) -> str:
    token = unicodedata.normalize("NFD", token)
    return "".join(ch for ch in token
                   if unicodedata.category(ch) != "Mn")


def _split_on_punc(token: str) -> List[str]:
    out: List[List[str]] = []
    new_word = True
    for ch in token:
        if _is_punct(ch):
            out.append([ch])
            new_word = True
        else:
            if new_word:
                out.append([])
            new_word = False
            out[-1].append(ch)
    return ["".join(p) for p in out]


def basic_tokenize(text: str, lower: bool = True,
                   never_split: Sequence[str] = ()) -> List[str]:
    """The BertTokenizer BasicTokenizer algorithm, step for step:
    clean (drop NUL/U+FFFD/controls, map whitespace to ' '), isolate CJK
    chars, NFC-normalize, whitespace-split, then per token lower + strip
    accents (unless the token is in ``never_split``) and split punctuation.
    """
    text = _clean_text(text)
    if any(_is_cjk(ord(ch)) for ch in text):
        text = "".join(f" {ch} " if _is_cjk(ord(ch)) else ch for ch in text)
    text = unicodedata.normalize("NFC", text)
    ns = set(never_split)
    tokens: List[str] = []
    for token in text.split():
        if token in ns:
            tokens.append(token)
            continue
        if lower:
            token = _strip_accents(token.lower())
        tokens.extend(_split_on_punc(token))
    return tokens


class WordPieceTokenizer:
    """Greedy longest-match-first WordPiece over a vocab dict.

    ``never_split`` reproduces HF's special-token handling: the text is
    first split on exact special-token substrings (HF's trie split), the
    specials pass through whole, and the remaining segments go through
    basic + wordpiece tokenization."""

    def __init__(self, vocab2id: Dict[str, int], unk_word: str = "[UNK]",
                 max_chars_per_word: int = 100, lower: bool = True,
                 never_split: Sequence[str] = BERT_SPECIAL_TOKENS):
        self.vocab2id = vocab2id
        self.unk_word = unk_word
        self.max_chars = max_chars_per_word
        self.lower = lower
        self.never_split = tuple(sorted(never_split, key=len, reverse=True))
        self._native = None       # C++ fast path (native/fastprep.cpp),
        self._native_tried = False  # ASCII texts only; lazy-built
        self._words: List[str] = []

    def _native_tokenizer(self):
        if not self._native_tried:
            self._native_tried = True
            try:
                from ..native import make_wordpiece
                words = [w for w, _ in sorted(self.vocab2id.items(),
                                              key=lambda kv: kv[1])]
                try:
                    unk_idx = words.index(self.unk_word)
                except ValueError:
                    unk_idx = len(words)
                    words = words + [self.unk_word]
                native = make_wordpiece(words, unk_idx)
                if native is not None:
                    self._native = native
                    self._words = words
            except Exception:
                self._native = None
        return self._native

    def wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars:
            return [self.unk_word]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab2id:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [self.unk_word]
            pieces.append(piece)
            start = end
        return pieces

    def _has_special(self, text: str) -> bool:
        return any(s in text for s in self.never_split)

    def _tokenize_segments(self, text: str) -> List[str]:
        """HF split_on_tokens: cut the text at exact special-token
        substrings; specials pass through whole, segments get basic +
        wordpiece."""
        segments: List[Tuple[str, bool]] = [(text, False)]
        for sp in self.never_split:
            nxt: List[Tuple[str, bool]] = []
            for seg, is_sp in segments:
                if is_sp or sp not in seg:
                    nxt.append((seg, is_sp))
                    continue
                parts = seg.split(sp)
                for i, part in enumerate(parts):
                    if part:
                        nxt.append((part, False))
                    if i < len(parts) - 1:
                        nxt.append((sp, True))
            segments = nxt
        out: List[str] = []
        for seg, is_sp in segments:
            if is_sp:
                out.append(seg)
            else:
                for tok in basic_tokenize(seg, lower=self.lower):
                    out.extend(self.wordpiece(tok))
        return out

    def __call__(self, text: str) -> List[str]:
        # C++ fast path for ASCII text (byte-identical — tests/test_native.py);
        # non-ASCII falls through to the Python path, where Unicode
        # normalization (CJK isolation, NFC, NFD accent strip, category-P
        # punctuation) applies. Texts containing special tokens take the
        # Python never_split path (substring check is a conservative
        # superset of HF's exact split — routing only).
        if self._has_special(text):
            return self._tokenize_segments(text)
        if text.isascii():
            native = self._native_tokenizer()
            if native is not None:
                ids = native.tokenize_ids(text, self.lower, self.max_chars)
                words = self._words
                return [words[i] for i in ids.tolist()]
        out: List[str] = []
        for tok in basic_tokenize(text, lower=self.lower):
            out.extend(self.wordpiece(tok))
        return out

    def batch(self, texts: List[str]) -> List[List[str]]:
        """Tokenize many texts with one native call — byte-identical to
        ``[self(t) for t in texts]`` (tests/test_native.py). Any non-ASCII
        text (or no native library) falls back to the per-text path."""
        if texts and all(t.isascii() and not self._has_special(t)
                         for t in texts):
            native = self._native_tokenizer()
            if native is not None:
                ids, lens = native.tokenize_ids_batch(texts, self.lower,
                                                      self.max_chars)
                words = self._words
                toks = [words[i] for i in ids.tolist()]
                out, pos = [], 0
                for ln in lens.tolist():
                    out.append(toks[pos:pos + ln])
                    pos += ln
                return out
        return [self(t) for t in texts]


def bert_detokenize(tokens: Iterable[str]) -> str:
    """' '.join then merge '##' continuations (ref: common/Utils.py:39-42)."""
    return " ".join(tokens).replace(" ##", "").strip()


# Sentence boundary candidates. '!' and '?' are unambiguous terminators
# (punkt treats them as sentence-final regardless of the next token's
# case); '.' is a candidate only before a capitalized/numeric next token
# (approximating punkt's orthographic heuristic — a lowercase follower
# almost always means an abbreviation or mid-sentence period).
_SENT_BOUNDARY = re.compile(
    r"(?<=[!?])([\"')\]]*)\s+"
    r"|(?<=\.)([\"')\]]*)\s+(?=[\"'(\[]?[A-Z0-9])")
# Period-final tokens that are (almost) never sentence-final: honorifics,
# ranks, months, and reference/measure shorthands. Mirrors the known-
# abbreviation behavior of nltk punkt's pretrained English parameters
# (this environment cannot ship the punkt pickle — zero egress — so the
# list is curated; tools/exp_sentence_split.py measures the divergence).
_ABBREV = {
    "mr.", "mrs.", "ms.", "dr.", "prof.", "sr.", "jr.", "st.", "vs.",
    "mt.", "ft.", "gen.", "col.", "sgt.", "capt.", "lt.", "cmdr.", "rev.",
    "hon.", "gov.", "sen.", "rep.", "pres.", "supt.", "det.", "messrs.",
    "mme.", "approx.", "dept.", "est.", "cf.", "ca.", "resp.",
    "jan.", "feb.", "mar.", "apr.", "jun.", "jul.", "aug.", "sep.",
    "sept.", "oct.", "nov.", "dec.",
}
# Reference shorthands that are abbreviations only when a number follows
# ("Fig. 3", "no. 5", "pp. 10-12"); sentence-final otherwise ("He said
# no. Then he left.").
_NUM_ABBREV = {"no.", "vol.", "fig.", "figs.", "pp.", "p.", "pg.", "sec.",
               "ch.", "art.", "op.", "nos."}
# Dotted acronyms / initialisms ("u.s.", "e.g.", "a.m.", "u.s.a.", "j.r.")
# — every letter followed by a dot.
_ACRONYM = re.compile(r"^(?:[a-z0-9]\.){2,}$")


def split_sentences(text: str) -> List[str]:
    """Sentence splitter for raw passage text (replaces the reference's
    nltk ``sent_tokenize``, Prepare_dataset.py:78).

    When nltk's pretrained punkt data is installed, that tokenizer is used
    directly (exact reference parity). On data-less hosts (this image has
    nltk but no corpora) a rule-based splitter stands in: terminator
    regex + abbreviation re-merge, curated against punkt's documented
    behavior (tests/test_data_pipeline.py gold corpus;
    tools/exp_sentence_split.py reports divergence when punkt data IS
    available)."""
    text = text.strip()
    if not text:
        return []
    punkt = _punkt_tokenizer()
    if punkt is not None:
        return [s.strip() for s in punkt(text) if s.strip()]
    # manual split via finditer: trailing close-quotes/brackets belong to
    # the PRECEDING sentence ('He said, "Go!"' keeps its quote — punkt
    # behavior), which re.split would swallow as separator text
    raw: List[str] = []
    last = 0
    for m in _SENT_BOUNDARY.finditer(text):
        quotes = m.group(1) if m.group(1) is not None else m.group(2)
        raw.append(text[last:m.start()] + quotes)
        last = m.end()
    raw.append(text[last:])
    # re-merge splits caused by abbreviations
    sents: List[str] = []
    for part in raw:
        part = part.strip()
        if not part:
            continue
        if sents and sents[-1][-1:] == ".":
            words = sents[-1].rsplit(None, 1)
            last_word = words[-1].lower() if words else ""
            merge = (
                last_word in _ABBREV
                or _ACRONYM.match(last_word) is not None
                # single initials: "J. K. Rowling", "George W. Bush"
                or (len(last_word) == 2 and last_word[0].isalpha())
                # "Fig. 3", "no. 5": numeric follower (skip open quotes
                # and brackets)
                or (last_word in _NUM_ABBREV
                    and part.lstrip("\"'([")[0:1].isdigit())
            )
            if merge:
                sents[-1] = sents[-1] + " " + part
                continue
        sents.append(part)
    return sents


_PUNKT_CACHE: List[Optional[object]] = []


def sentence_splitter_variant() -> str:
    """Which sentence splitter ``split_sentences`` will use — "punkt"
    (nltk data installed: exact reference parity with
    Prepare_dataset.py:78) or "rule" (the curated fallback). Drop the
    punkt pickle into any nltk data path (e.g. ~/nltk_data/tokenizers/
    punkt) to switch; cli/prepare logs this so corpus-parity runs are
    attributable."""
    return "punkt" if _punkt_tokenizer() is not None else "rule"


def _punkt_tokenizer():
    """nltk punkt ``sent_tokenize`` when its data is installed, else None
    (cached; the lookup costs a filesystem scan)."""
    if not _PUNKT_CACHE:
        tok = None
        try:
            import nltk
            nltk.data.find("tokenizers/punkt")
            from nltk.tokenize import sent_tokenize
            tok = sent_tokenize
        except Exception:
            tok = None
        _PUNKT_CACHE.append(tok)
    return _PUNKT_CACHE[0]
