"""Duplicate-id copy-mass combine and the candidate argmax (port of
``case_rg_tpu/kernels/copy_argmax.py``).

Greedy decoding over a copy-extended distribution needs only the ARGMAX of
``gate * softmax(logits) + scatter(copy_mass, src_ids)``. The scatter adds
mass only at the L_s source ids, so the argmax is either the generator's
argmax or the best source id once the copy mass of duplicate ids is
combined: ``comb[b, j] = sum_l cw[b, l] * [ids[b, l] == ids[b, j]]``.

``combine_copy_mass`` is the wrapper: on a CUDA tensor it launches the
hand-written kernel in ``csrc/copy_argmax.cu`` with the body
``combine_copy_mass_plan`` picks and counts the launch in ``LAUNCHES``; on
a CPU tensor it runs ``combine_copy_mass_plain``, the same function in
PyTorch. The multi-memory decoder's ``pallas`` argmax mode
reaches it once per decode step through ``candidate_argmax_from_logits``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build

LAUNCHES = 0        # kernel launches since the last reset (plain runs excluded)
_SMEM_LIMIT = 232448   # bytes of shared memory one block may use on sm_90
# The longest source the kernel takes: its brute body stages a row's ids
# and weights, 8 bytes a position, in shared memory. (The JAX package's
# ceiling, 1280, was the TPU kernel's scoped-VMEM limit; CaSE's source is
# 1060.)
MAX_FAST_LS = _SMEM_LIMIT // 8
_MAX_SORT = 4096    # the longest row the sort body holds (512 threads x 8)
_MIN_SORT = 256     # its smallest sorting width (one warp x 8)
# Rows up to this long go to the brute body: its Ls^2 compares take less
# time than the sort's chain of steps there (B=64 on an H100: chip_smoke.py
# prints both bodies' times by length as "combine_copy_mass by_ls").
_MAX_BRUTE_SHORT = 384
_BODIES = {"sort": 0, "brute": 1}     # the C launcher's body codes


@functools.lru_cache(maxsize=None)
def combine_copy_mass_plan(b: int, ls: int, body=None) -> dict:
    """The kernel's launch for B rows of Ls positions, as its C launcher
    lays it out (``csrc/copy_argmax.cu``): "sort", one block a row of
    ``threads`` = n / 8 threads, n = Ls rounded up to a power of two (at
    least 256), that sorts the row's (id, position) keys and sums the
    groups, where 384 < Ls <= 4096; else "brute", a block of 128 threads a
    (row, tile of 128 positions) comparing every pair. ``smem``: bytes of
    shared memory a block. ``body`` forces one (for comparisons on the
    card). Raises on a shape the kernel does not take."""
    if not 1 <= ls <= MAX_FAST_LS or not 1 <= b <= 65535:
        raise ValueError(f"combine_copy_mass: the kernel takes at most "
                         f"{MAX_FAST_LS} positions and 65535 rows, got "
                         f"B={b}, Ls={ls}")
    if body is None:
        body = "sort" if _MAX_BRUTE_SHORT < ls <= _MAX_SORT else "brute"
    if body == "sort":
        if ls > _MAX_SORT:
            raise ValueError(f"combine_copy_mass: the sort body holds at "
                             f"most {_MAX_SORT} positions, got Ls={ls}")
        n = max(_MIN_SORT, 1 << (ls - 1).bit_length())
        return {"body": "sort", "n": n, "threads": n // 8, "blocks": b,
                "smem": 4 * n + 2 * (n + n // 8) * 8 + 32 * 12 + 3 * 32 * 4}
    if body != "brute":
        raise ValueError(f"combine_copy_mass: no body {body!r}")
    return {"body": "brute", "n": ls, "threads": 128,
            "blocks": b * -(-ls // 128), "smem": 8 * (-(-ls // 4) * 4)}


def combine_copy_mass_plain(cw: torch.Tensor,
                            src_ids: torch.Tensor) -> torch.Tensor:
    """The kernel's function in PyTorch (``combine_copy_mass_xla`` in the
    JAX package): a dense [B, Ls, Ls] compare, summed in f32."""
    eq = src_ids[:, :, None] == src_ids[:, None, :]
    return torch.where(eq, cw.float()[:, :, None],
                       torch.zeros((), device=cw.device)).sum(dim=1)


def combine_copy_mass(cw: torch.Tensor, src_ids: torch.Tensor) -> torch.Tensor:
    """comb[b, j] = sum_l cw[b, l] * [src_ids[b, l] == src_ids[b, j]].

    cw: [B, Ls] copy mass per source position, f32 or bf16 (summed in f32);
    src_ids: [B, Ls] int32 vocab ids >= 0 (int64 ids are cast). Returns
    [B, Ls] f32: every member of a duplicate-id group carries the whole
    group's mass, so a later argmax picks the group's first position."""
    if cw.device.type == "cpu":
        return combine_copy_mass_plain(cw, src_ids)
    if cw.ndim != 2 or tuple(src_ids.shape) != tuple(cw.shape):
        raise ValueError(f"combine_copy_mass: cw and src_ids must both be "
                         f"[B, Ls], got {tuple(cw.shape)} and "
                         f"{tuple(src_ids.shape)}")
    if cw.device.type != "cuda" or src_ids.device != cw.device:
        raise ValueError(f"combine_copy_mass: cw and src_ids must be on one "
                         f"CUDA device, got {cw.device} and {src_ids.device}")
    if cw.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"combine_copy_mass: cw must be f32 or bf16, got "
                         f"{cw.dtype}")
    if src_ids.dtype == torch.int64:
        src_ids = src_ids.to(torch.int32)
    if src_ids.dtype != torch.int32:
        raise ValueError(f"combine_copy_mass: src_ids must be int32 or "
                         f"int64, got {src_ids.dtype}")
    if not cw.is_contiguous() or not src_ids.is_contiguous():
        raise ValueError("combine_copy_mass: cw and src_ids must be "
                         "contiguous")
    b, ls = cw.shape
    out = torch.empty(b, ls, dtype=torch.float32, device=cw.device)
    if out.numel() == 0:
        return out
    plan = combine_copy_mass_launch(b, ls)
    lib = _lib()
    code = _BODIES[plan["body"]]
    if lib.combine_copy_mass_smem_bytes(code, ls) != plan["smem"]:
        raise RuntimeError("combine_copy_mass: the C launcher and "
                           "combine_copy_mass_plan count shared memory "
                           "differently")
    rc = lib.combine_copy_mass(
        code, cw.data_ptr(), int(cw.dtype == torch.bfloat16),
        src_ids.data_ptr(), out.data_ptr(), b, ls,
        torch.cuda.current_stream(cw.device).cuda_stream)
    _build.check(rc, "combine_copy_mass")
    global LAUNCHES
    LAUNCHES += 1
    return out


def candidate_argmax_from_logits(logits: torch.Tensor, l_at: torch.Tensor,
                                 gate: torch.Tensor, cw: torch.Tensor,
                                 src_ids: torch.Tensor) -> torch.Tensor:
    """``argmax_v(gate * softmax(logits)[v] + scatter_add(cw, src_ids)[v])``
    with neither the [B, V] scatter nor a [B, V] gather.

    The caller supplies ``l_at`` [B, Ls], the pre-softmax logits at the
    source ids (a small product against generator weight rows gathered once
    per batch, ``gather_weight_columns``); the softmax values there are
    rebuilt in f32 from the row max and partition sum:
    ``base[id] = gate * exp(l_at - lmax) / Z``.

    logits: [B, V]; gate: [B] or [B, 1]; cw: [B, Ls] gate-scaled copy mass;
    src_ids: [B, Ls]. Returns idx [B] int32. Exact up to f32 rounding and
    tie-breaks (the dense path softmaxes in the compute dtype; this rebuilds
    in f32, so the two may part at near-ties)."""
    lf = logits.float()
    lmax = lf.max(dim=-1, keepdim=True).values                  # [B, 1]
    g_idx = lf.argmax(dim=-1)                                   # [B]
    z = torch.exp(lf - lmax).sum(dim=-1)                        # [B]
    gate = gate.reshape(gate.shape[0]).float()
    g_val = gate / z                                            # exp(0) = 1
    b_at = gate[:, None] * torch.exp(l_at.float() - lmax) / z[:, None]
    comb = combine_copy_mass(cw, src_ids)                       # [B, Ls] f32
    cand = b_at + comb
    c_pos = cand.argmax(dim=-1, keepdim=True)
    c_val = cand.gather(-1, c_pos)[:, 0]
    c_idx = src_ids.gather(-1, c_pos)[:, 0]
    return torch.where(c_val > g_val, c_idx.to(g_idx.dtype), g_idx).to(
        torch.int32)


def gather_weight_columns(weight: torch.Tensor, src_ids: torch.Tensor,
                          bias: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The generator's weight rows at the copy source ids, gathered once per
    batch: weight [V, d] (a Linear's weight, which is already the JAX
    kernel transposed), src_ids [B, Ls] -> (w_at [B, Ls, d], b_at [B, Ls]
    or None). The per-step ``l_at`` is then ``einsum('bld,bd->bl', w_at,
    h) (+ b_at)``."""
    w_at = weight[src_ids]
    b_at = None if bias is None else bias[src_ids]
    return w_at, b_at


def candidate_argmax(base: torch.Tensor, cw: torch.Tensor,
                     src_ids: torch.Tensor) -> torch.Tensor:
    """``argmax_v(base[v] + scatter_add(cw, src_ids)[v])`` without the
    [B, V] scatter. base: [B, V] non-negative mixture mass already scaled
    by its gate; cw: [B, Ls] gate-scaled copy mass; src_ids: [B, Ls].
    Returns idx [B] int32. This form gathers ``base`` at the source ids
    every call; the decode paths use ``candidate_argmax_from_logits``."""
    b_idx = base.argmax(dim=-1, keepdim=True)
    b_val = base.gather(-1, b_idx)[:, 0].float()
    comb = combine_copy_mass(cw, src_ids)                       # [B, Ls] f32
    cand = base.gather(-1, src_ids.long()).float() + comb
    c_pos = cand.argmax(dim=-1, keepdim=True)
    c_val = cand.gather(-1, c_pos)[:, 0]
    c_idx = src_ids.gather(-1, c_pos)[:, 0]
    return torch.where(c_val > b_val, c_idx.to(b_idx.dtype), b_idx[:, 0]).to(
        torch.int32)


def combine_copy_mass_launch(b: int, ls: int) -> dict:
    """The plan the wrapper launches (chip_smoke.py and the ``cuda`` tests
    replace it to time or hold the other body)."""
    return combine_copy_mass_plan(b, ls)


def _lib():
    lib = _build.load("copy_argmax")
    if not getattr(lib, "_argtypes_set", False):
        lib.combine_copy_mass_smem_bytes.argtypes = [ctypes.c_int] * 2
        lib.combine_copy_mass_smem_bytes.restype = ctypes.c_int
        lib.combine_copy_mass.argtypes = (
            [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.combine_copy_mass.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib
