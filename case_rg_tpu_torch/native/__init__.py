"""Native (C++) acceleration for the host data pipeline (port of
``case_rg_tpu/native``; the same ``fastprep.cpp``).

Compiled lazily with the system C++ compiler and bound via ctypes; every
entry point has a pure-Python fallback (``data/labels.py``,
``data/text.WordPieceTokenizer``), so the package works without a
toolchain. The library is built into ``build/native/fastprep-<hash>/`` at
the repository root (``.gitignore`` lists ``build/``), keyed on the source
and the flags, never next to the source. ``available()`` reports whether
the native library loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "fastprep.cpp"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def lib_path() -> Path:
    """Where the library for this source and these flags is built."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return BUILD_ROOT / f"fastprep-{h.hexdigest()[:16]}" / "_fastprep.so"


def _build(out: Path) -> bool:
    """Compile into a temporary file beside ``out``, then rename it into
    place, so processes building at once never load a half-written file."""
    out.parent.mkdir(parents=True, exist_ok=True)
    for cc in ("c++", "g++", "clang++"):
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        try:
            subprocess.run([cc, *_FLAGS, str(_SRC), "-o", tmp], check=True,
                           capture_output=True, timeout=120)
            os.replace(tmp, out)
            return True
        except (OSError, subprocess.SubprocessError):
            continue
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = lib_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.case_token_labels.argtypes = [
            i32p, ctypes.c_int, ctypes.c_int, i32p, ctypes.c_int,
            f32p, ctypes.c_int, f32p, f32p]
        lib.case_token_labels.restype = None
        lib.glks_window_overlap.argtypes = [
            i32p, ctypes.c_int, i32p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, f32p]
        lib.glks_window_overlap.restype = ctypes.c_int
        lib.wp_create.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                  ctypes.c_int32]
        lib.wp_create.restype = ctypes.c_void_p
        lib.wp_destroy.argtypes = [ctypes.c_void_p]
        lib.wp_destroy.restype = None
        lib.wp_tokenize.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, i32p, ctypes.c_int]
        lib.wp_tokenize.restype = ctypes.c_int
        lib.wp_tokenize_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, i32p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, i32p, ctypes.c_int, i32p]
        lib.wp_tokenize_batch.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def case_token_labels(passages: np.ndarray, answer: np.ndarray,
                      freq_dense: np.ndarray):
    """passages [P, L] int32, answer [T] int32, freq_dense [V] float32 ->
    (labels [P, L], conf [P, L]) or None if the native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    passages = np.ascontiguousarray(passages, np.int32)
    answer = np.ascontiguousarray(answer, np.int32)
    freq_dense = np.ascontiguousarray(freq_dense, np.float32)
    p, l = passages.shape
    labels = np.zeros((p, l), np.float32)
    conf = np.zeros((p, l), np.float32)
    lib.case_token_labels(passages, p, l, answer, len(answer),
                          freq_dense, len(freq_dense), labels, conf)
    return labels, conf


class NativeWordPiece:
    """C++ WordPiece over an id-ordered vocabulary; ASCII texts only (the
    caller falls back to the Python tokenizer for non-ASCII input, where
    Unicode normalization applies). Returns token ids."""

    def __init__(self, words, unk_id: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        blob = "\n".join(words).encode("utf-8")
        self._lib = lib
        self._h = lib.wp_create(blob, len(blob), unk_id)
        self._buf = np.zeros(4096, np.int32)

    def _fit_buf(self, n_bytes: int) -> None:
        # every emitted wordpiece id consumes >= 1 source character, so
        # the id count is bounded by the input byte length — size the
        # buffer once instead of tokenize-retry-doubling
        if len(self._buf) < n_bytes:
            self._buf = np.zeros(n_bytes, np.int32)

    def tokenize_ids(self, text: str, lower: bool = True,
                     max_chars: int = 100) -> np.ndarray:
        data = text.encode("ascii")   # caller guarantees ASCII
        self._fit_buf(len(data))
        while True:
            n = self._lib.wp_tokenize(self._h, data, len(data),
                                      1 if lower else 0, max_chars,
                                      self._buf, len(self._buf))
            if n >= 0:
                return self._buf[:n].copy()
            self._buf = np.zeros(len(self._buf) * 2, np.int32)

    def tokenize_ids_batch(self, texts, lower: bool = True,
                           max_chars: int = 100):
        """Tokenize many ASCII texts with ONE native call (the per-call
        ctypes crossing dominates once the tokenizer itself is C++).
        Returns (flat ids [sum lens] int32, per-text lens [n] int32)."""
        blob = "".join(texts).encode("ascii")   # caller guarantees ASCII
        offs = np.zeros(len(texts) + 1, np.int32)
        if texts:
            offs[1:] = np.cumsum([len(t) for t in texts])
        lens = np.zeros(max(len(texts), 1), np.int32)
        self._fit_buf(len(blob))
        while True:
            n = self._lib.wp_tokenize_batch(
                self._h, blob, offs, len(texts), 1 if lower else 0,
                max_chars, self._buf, len(self._buf), lens)
            if n >= 0:
                return self._buf[:n].copy(), lens[: len(texts)].copy()
            self._buf = np.zeros(len(self._buf) * 2, np.int32)

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.wp_destroy(self._h)
        except Exception:
            pass


def make_wordpiece(words, unk_id: int):
    """NativeWordPiece or None if the toolchain/library is unavailable."""
    if _load() is None:
        return None
    return NativeWordPiece(words, unk_id)


def glks_window_overlap(background: np.ndarray, answer: np.ndarray,
                        min_window_size: int, n_windows: int,
                        vocab_size: int):
    lib = _load()
    if lib is None:
        return None
    background = np.ascontiguousarray(background, np.int32)
    answer = np.ascontiguousarray(answer, np.int32)
    total = 0
    ws = min_window_size
    for _ in range(n_windows):
        total += max((len(background) - ws) // min_window_size + 1, 0)
        ws += min_window_size
    out = np.zeros(total, np.float32)
    n = lib.glks_window_overlap(background, len(background), answer,
                                len(answer), min_window_size, n_windows,
                                vocab_size, out)
    return out[:n]
