"""Shared CLI flag helpers (a copy of ``case_rg_tpu/cli/flags.py``)."""

from __future__ import annotations

import argparse

_ARGMAX_HELP = (
    "decode argmax epilogue for CaSE: auto (dense, see "
    "MultiMemoryDecoder._resolve_fast_argmax), dense (the [B, V] copy "
    "scatter + argmax), mxu (candidate argmax - duplicate-id copy mass "
    "combined by one batched product against a first-occurrence matrix), "
    "pallas (the candidate argmax through the combine_copy_mass CUDA "
    "kernel; its plain version on the CPU). Bare --fast_argmax is an alias "
    "for pallas, --no-fast_argmax for dense.")


def _argmax_mode(value: str):
    v = value.lower()
    if v in ("auto", "none"):
        return None
    if v in ("dense", "false", "off"):
        return False
    if v in ("true", "on"):
        return True
    if v in ("mxu", "pallas"):
        return v
    raise argparse.ArgumentTypeError(
        f"{value!r} not one of auto/dense/mxu/pallas")


def add_fast_argmax_flag(p: argparse.ArgumentParser) -> None:
    """--fast_argmax [auto|dense|mxu|pallas] plus legacy --no-fast_argmax."""
    p.add_argument("--fast_argmax", nargs="?", const=True, default=None,
                   type=_argmax_mode, metavar="MODE", help=_ARGMAX_HELP)
    p.add_argument("--no-fast_argmax", dest="fast_argmax",
                   action="store_const", const=False,
                   help=argparse.SUPPRESS)
