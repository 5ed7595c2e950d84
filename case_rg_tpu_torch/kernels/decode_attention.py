"""Single-query multi-head attention for the decode step (port of
``case_rg_tpu/kernels/decode_attention.py``).

``single_query_mha`` is the wrapper: on a CUDA tensor it launches the
hand-written kernel in ``csrc/decode_attention.cu`` (bf16 only) in the
layout ``single_query_mha_plan`` picks and counts the launch in
``LAUNCHES``; on a CPU tensor it runs
``single_query_mha_plain``, the same function in PyTorch. K and V may be
strided views (the two halves of a packed [B, T, 2E] K|V cache): the kernel
reads them in place. The decode step of every unfused decoder stack
reaches it through ``ops/attention.MultiHeadAttention.attend_with_kv_merged``
(its self-attention over the cache and its cross-attention over the
memory).
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
_WIDTHS = (8, 16, 32, 64, 128, 256)   # head widths the kernel takes
_WARP_KEYS = 8      # keys a lane holds in the warp layout
_LAYOUTS = {"warp": 0, "block": 1}    # the C launcher's layout codes


@functools.lru_cache(maxsize=None)
def single_query_mha_plan(b: int, l: int, d: int, layout=None) -> dict:
    """The kernel's launch for B rows of L keys at head width d, as its C
    launcher lays it out (``csrc/decode_attention.cu``): "warp", one warp a
    (row, head), four a block of 128 threads, no shared memory, where a
    warp's lanes hold every key (``_WARP_KEYS`` keys a lane, 256 / d keys a
    pass: L <= 64 at d = 32); else "block", a block of 128 threads a (row,
    head) with the row's f32 scores in ``smem`` bytes of shared memory.
    ``layout`` forces one (for comparisons on the card). Raises on a shape
    the kernel does not take."""
    if d not in _WIDTHS or l < 1 or not 1 <= b <= 2 ** 31 - 1:
        raise ValueError(f"single_query_mha: the kernel takes head widths "
                         f"{_WIDTHS}, L >= 1 and 1 <= B < 2^31; got d={d}, "
                         f"L={l}, B={b}")
    warp_keys = _WARP_KEYS * 256 // d
    if layout is None:
        layout = "warp" if l <= warp_keys else "block"
    if layout == "warp":
        if l > warp_keys:
            raise ValueError(f"single_query_mha: the warp layout holds at "
                             f"most {warp_keys} keys at d={d}, got L={l}")
        return {"layout": "warp", "threads": 128, "smem": 0}
    if layout != "block":
        raise ValueError(f"single_query_mha: no layout {layout!r}")
    smem = 4 * (5 * d + l + 4)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"single_query_mha: L={l} needs {smem} bytes of "
                         "shared memory, more than a block has")
    return {"layout": "block", "threads": 128, "smem": smem}


def _scale(d: int, dtype) -> float:
    """1/sqrt(d) rounded to ``dtype``, as the decode path has it. A Python
    float: a 0-dim tensor moved to the card would be a blocking copy, a
    synchronisation of the stream in every decode step."""
    return float(torch.tensor(1.0 / np.sqrt(d)).to(dtype))


def single_query_mha_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, keep, num_heads: int
                           ) -> torch.Tensor:
    """The kernel's function in PyTorch (``single_query_mha_xla`` in the
    JAX package, with the rounding points of the decode path it replaces):
    q * scale in q's dtype, f32 scores, masked softmax in f32, a row with no
    valid key gives zeros, probs cast to v's dtype, PV. Takes any number of
    queries: it is also the dense path of ``attend_with_kv_merged``."""
    b, lq, e = q.shape
    h = num_heads
    d = e // h
    qh = q.reshape(b, lq, h, d)
    kh = k.reshape(b, -1, h, d)
    vh = v.reshape(b, -1, h, d)
    scores = torch.einsum("bqhd,bkhd->bhqk",
                          (qh * _scale(d, q.dtype)).float(), kh.float())
    if keep is not None:
        scores = torch.where(keep[:, None, None, :], scores,
                             torch.full((), neg_inf(scores.dtype),
                                        device=scores.device))
    probs = torch.softmax(scores, dim=-1)
    if keep is not None:
        probs = probs * keep.any(-1).to(probs.dtype)[:, None, None, None]
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs.to(vh.dtype), vh)
    return ctx.reshape(b, lq, e)


def check_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 keep) -> None:
    """Raise ValueError unless the kernel can read these tensors where they
    lie (shapes, strides, alignment; device and dtype aside): q [B, 1, E]
    and k/v [B, L, E] with unit stride along E, batch and row strides
    divisible by 8 and 16-byte aligned starts (its 16-byte loads of a
    head's lanes), keep a bool [B, L] or None. The decode path's views (the
    query third of a packed QKV projection, the halves of a packed K|V
    cache) pass as they are."""
    b, lq, e = q.shape
    l = k.shape[1]
    if lq != 1:
        raise ValueError(f"single_query_mha: one query a row, got Lq={lq}")
    for name, x, shape in (("q", q, (b, 1, e)), ("k", k, (b, l, e)),
                           ("v", v, (b, l, e))):
        if tuple(x.shape) != shape:
            raise ValueError(f"single_query_mha: {name} must be {shape}, got "
                             f"{tuple(x.shape)}")
        if x.stride(2) != 1 or x.stride(1) % 8 or x.stride(0) % 8 \
                or x.data_ptr() % 16:
            raise ValueError(f"single_query_mha: {name} needs unit stride "
                             f"along E, batch and row strides divisible by "
                             f"8 and a 16-byte aligned start; got strides "
                             f"{x.stride()}")
    if keep is not None and (keep.dtype != torch.bool
                             or tuple(keep.shape) != (b, l)):
        raise ValueError("single_query_mha: keep must be a bool [B, L] "
                         "tensor")


def single_query_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     keep, num_heads: int) -> torch.Tensor:
    """q: [B, 1, E] (already in-projected); k/v: [B, L, E] (projected,
    merged layout; strided views as ``check_layout`` takes them); keep:
    [B, L] bool (True = attend) or None. Returns the pre-out-projection
    context [B, 1, E] in q's dtype."""
    if q.device.type == "cpu":
        return single_query_mha_plain(q, k, v, keep, num_heads)
    for name, x in (("q", q), ("k", k), ("v", v), ("keep", keep)):
        if x is not None and x.device != q.device:
            raise ValueError(f"single_query_mha: {name} is on {x.device}, "
                             f"not on {q.device}")
        if x is not None and name != "keep" and x.dtype != torch.bfloat16:
            raise ValueError(f"single_query_mha: {name} must be bf16, got "
                             f"{x.dtype}")
    check_layout(q, k, v, keep)
    b, _, e = q.shape
    l = k.shape[1]
    if keep is not None:
        keep = keep.contiguous()
    if e % num_heads or not 1 <= num_heads <= 65535:
        raise ValueError(f"single_query_mha: E={e} does not split into "
                         f"H={num_heads} heads")
    d = e // num_heads
    plan = single_query_mha_launch(b, l, d)
    lib = _lib()
    code = _LAYOUTS[plan["layout"]]
    if lib.single_query_mha_smem_bytes(code, l, d) != plan["smem"]:
        raise RuntimeError("single_query_mha: the C launcher and "
                           "single_query_mha_plan count shared memory "
                           "differently")
    out = torch.empty(b, 1, e, dtype=q.dtype, device=q.device)
    rc = lib.single_query_mha_bf16(
        code, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        keep.data_ptr() if keep is not None else None, out.data_ptr(),
        b, l, e, num_heads, q.stride(0), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), _scale(d, torch.bfloat16),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "single_query_mha")
    global LAUNCHES
    LAUNCHES += 1
    return out


def single_query_mha_launch(b: int, l: int, d: int) -> dict:
    """The plan the wrapper launches (chip_smoke.py and the ``cuda`` tests
    replace it to time or hold the other layout)."""
    return single_query_mha_plan(b, l, d)


def _lib():
    lib = _build.load("decode_attention")
    if not getattr(lib, "_argtypes_set", False):
        lib.single_query_mha_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.single_query_mha_smem_bytes.restype = ctypes.c_int
        lib.single_query_mha_bf16.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
            + [ctypes.c_longlong] * 5 + [ctypes.c_float, ctypes.c_void_p])
        lib.single_query_mha_bf16.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib
