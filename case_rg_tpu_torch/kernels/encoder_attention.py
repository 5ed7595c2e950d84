"""Fused multi-head attention on merged-head [R, L, E] projections (port of
``case_rg_tpu/kernels/encoder_attention.py``).

``fused_mha`` is the wrapper: on a CUDA tensor it launches the hand-written
kernel in ``csrc/encoder_attention.cu`` (bf16 only) as ``fused_mha_plan``
lays it out, and counts the launch in ``LAUNCHES``; on a CPU tensor it runs
``fused_mha_plain``, the same function in PyTorch. The encoder and tower
self-attention sites reach it through
``ops/attention.MultiHeadAttention.attend_with_kv``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..ops.masking import neg_inf
from . import _build

LAUNCHES = 0        # kernel launches since the last reset (plain runs excluded)
_SMEM_LIMIT = 232448   # bytes of shared memory one block may use on sm_90
_MAX_KEYS = 128
_MAX_WARPS = 8
_WIDTHS = (32, 160)    # head widths with a compiled instance of their own


@functools.lru_cache(maxsize=None)
def fused_mha_plan(lq: int, lk: int, d: int) -> dict:
    """The kernel's launch at (Lq, Lk, head width d), as its C launcher
    lays it out (``csrc/encoder_attention.cu``): grid (R, H); one warp per
    16 queries, at most 8 (more query tiles loop); ``kt`` keys a block
    holds (64, 112 or 128: the scores of 16 queries sit whole in a warp's
    registers); the instance ``<d, kt / 16>`` (``<0, ..>`` reads a width
    other than 32 or 160 at run time); ``smem`` bytes of shared memory
    (q, K and V tiles, rows padded by 8 bf16, and the key mask). Raises
    on a shape the kernel does not take."""
    if d < 16 or d % 16 or not 1 <= lk <= _MAX_KEYS or lq < 1:
        raise ValueError(f"fused_mha: the kernel takes head widths divisible "
                         f"by 16 and 1 to {_MAX_KEYS} keys; got d={d}, "
                         f"Lk={lk}, Lq={lq}")
    kt = next(n for n in (64, 112, _MAX_KEYS) if lk <= n)
    mpad = -(-lq // 16) * 16
    smem = 2 * (mpad + 2 * kt) * (d + 8) + kt
    if smem > _SMEM_LIMIT:
        raise ValueError(f"fused_mha: Lq={lq}, Lk={lk}, d={d} needs {smem} "
                         "bytes of shared memory, more than a block has")
    return {"warps": min(mpad // 16, _MAX_WARPS), "kt": kt,
            "instance": f"<{d if d in _WIDTHS else 0},{kt // 16}>",
            "smem": smem}


def _scale(d: int, dtype) -> torch.Tensor:
    """1/sqrt(d) in f32, rounded to ``dtype`` as the JAX kernel does."""
    return torch.tensor(np.float32(1.0) / np.sqrt(np.float32(d))).to(dtype)


def fused_mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    keep, num_heads: int) -> torch.Tensor:
    """The kernel's function in PyTorch (``fused_mha_xla`` in the JAX
    package): split heads, f32 scores, masked softmax in f32, probs cast to
    v's dtype, PV, merge heads. A row with no valid key gives zeros."""
    r, lq, e = q.shape
    h = num_heads
    d = e // h
    scale = _scale(d, q.dtype).to(q.device)
    qh = (q * scale).reshape(r, lq, h, d).transpose(1, 2)
    kh = k.reshape(r, -1, h, d).transpose(1, 2)
    vh = v.reshape(r, -1, h, d).transpose(1, 2)
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    if keep is not None:
        scores = torch.where(keep[:, None, None, :], scores,
                             torch.full((), neg_inf(scores.dtype),
                                        device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    if keep is not None:
        probs = probs * keep.any(dim=-1).to(probs.dtype)[:, None, None, None]
    ctx = torch.matmul(probs.to(v.dtype), vh)
    return ctx.transpose(1, 2).reshape(r, lq, e)


def fused_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              keep, num_heads: int) -> torch.Tensor:
    """q: [R, Lq, E]; k/v: [R, Lk, E] (already in-projected); keep: [R, Lk]
    bool (True = attend) or None. Returns the pre-out-projection context
    [R, Lq, E] in q's dtype."""
    return torch.ops.case_rg_torch.fused_mha.default(q, k, v, keep,
                                                     num_heads)


@_build.on_input_card
def fused_mha_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   keep, num_heads: int) -> torch.Tensor:
    """The op's CUDA implementation: checks, then one launch."""
    r, lq, e = q.shape
    lk = k.shape[1]
    for name, x, shape in (("q", q, (r, lq, e)), ("k", k, (r, lk, e)),
                           ("v", v, (r, lk, e))):
        if x.device.type != "cuda" or x.dtype != torch.bfloat16:
            raise ValueError(f"fused_mha: {name} must be a bf16 CUDA tensor, "
                             f"got {x.dtype} on {x.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"fused_mha: {name} must be contiguous "
                             f"{shape}, got {tuple(x.shape)}")
    if keep is not None:
        if keep.dtype != torch.bool or tuple(keep.shape) != (r, lk) \
                or keep.device != q.device:
            raise ValueError("fused_mha: keep must be a bool [R, Lk] tensor "
                             "on q's device")
        keep = keep.contiguous()
    if e % num_heads:
        raise ValueError(f"fused_mha: E={e} does not split into {num_heads} "
                         "heads")
    d = e // num_heads
    plan = fused_mha_plan(lq, lk, d)
    lib = _lib()
    if lib.fused_mha_smem_bytes(lq, lk, d) != plan["smem"]:
        raise RuntimeError("fused_mha: the C launcher and fused_mha_plan "
                           "count shared memory differently")
    out = torch.empty_like(q)
    rc = lib.fused_mha_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        keep.data_ptr() if keep is not None else None, out.data_ptr(),
        r, lq, lk, e, num_heads, float(_scale(d, torch.bfloat16)),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "fused_mha")
    global LAUNCHES
    with _build.COUNT_LOCK:
        LAUNCHES += 1
    _build.tally("fused_mha")
    return out


def _lib():
    lib = _build.load("encoder_attention")
    if not getattr(lib, "_argtypes_set", False):
        lib.fused_mha_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.fused_mha_smem_bytes.restype = ctypes.c_int
        lib.fused_mha_bf16.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
            + [ctypes.c_float, ctypes.c_void_p])
        lib.fused_mha_bf16.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib
