"""Additive (Bahdanau) attention scores without the [B, T, L, H] tensor
(port of ``case_rg_tpu/kernels/additive_attention.py``).

``additive_scores(wq, uh, v)`` computes ``s[b, t, l] = sum_h tanh(wq[b, t,
h] + uh[b, l, h]) * v[h]``, the scorer of every ``ops/bilinear.
BilinearAttention`` (CaSE's copy attention over both memories, in every
decode step and in teacher forcing). It is a ``torch.autograd.Function``:
on CUDA tensors its forward and its backward launch the hand-written
kernels of ``csrc/additive_attention.cu`` (bf16 only; the backward is
three launches and no atomics) and count one forward in ``LAUNCHES`` and
one backward in ``LAUNCHES_BWD``; on CPU tensors they run the plain
versions, ``additive_scores_plain`` (the JAX package's ``_scores_xla``)
and ``additive_scores_plain_bwd`` (the math of its custom VJP ``_bwd``).
Both keep the kernels' rounding points: wq + uh rounded to the input
dtype, tanh rounded to the input dtype, each sum in f32 rounded once.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

LAUNCHES = 0        # forward launches since the last reset (plain runs excluded)
LAUNCHES_BWD = 0    # backward launches (three kernels each)
_SMEM_LIMIT = 232448   # bytes of shared memory one block may use on sm_90


def _tanh_sum(wq, uh):
    """th [B, T, L, H] = tanh(wq + uh), each rounded to the input dtype."""
    return torch.tanh(wq[:, :, None, :] + uh[:, None, :, :])


def additive_scores_plain(wq: torch.Tensor, uh: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """The forward in PyTorch (``_scores_xla``): builds the [B, T, L, H]
    tensor; the H-sum is a product, accumulated in f32 on the card."""
    return torch.einsum("btlh,h->btl", _tanh_sum(wq, uh), v)


def additive_scores_plain_bwd(wq, uh, v, g):
    """(dwq, duh, dv) of ``additive_scores_plain`` (the math of the JAX
    package's ``_bwd``): th recomputed, then in f32
    ``c = g * (1 - th^2)``, ``dwq = v * sum_l c``, ``duh = v * sum_t c``,
    ``dv = sum th * g``; each rounded once to its input's dtype."""
    th = _tanh_sum(wq, uh).float()
    gf = g.float()[..., None]
    c = gf * (1.0 - th * th)
    vf = v.float()
    dwq = c.sum(2) * vf
    duh = c.sum(1) * vf
    dv = (th * gf).sum((0, 1, 2))
    return dwq.to(wq.dtype), duh.to(uh.dtype), dv.to(v.dtype)


class _AdditiveScores(torch.autograd.Function):

    @staticmethod
    def forward(ctx, wq, uh, v):
        ctx.save_for_backward(wq, uh, v)
        if wq.device.type == "cpu":
            return additive_scores_plain(wq, uh, v)
        return _launch_fwd(wq, uh, v)

    @staticmethod
    def backward(ctx, g):
        wq, uh, v = ctx.saved_tensors
        if wq.device.type == "cpu":
            return additive_scores_plain_bwd(wq, uh, v, g)
        return _launch_bwd(wq, uh, v, g.to(wq.dtype).contiguous())


def additive_scores(wq: torch.Tensor, uh: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """wq: [B, T, H]; uh: [B, L, H]; v: [H]. Returns the scores [B, T, L] in
    wq's dtype, differentiable in all three."""
    return _AdditiveScores.apply(wq, uh, v)


def _check(wq, uh, v, g=None):
    b, t, h = wq.shape
    l = uh.shape[1]
    named = [("wq", wq, (b, t, h)), ("uh", uh, (b, l, h)), ("v", v, (h,))]
    if g is not None:
        named.append(("g", g, (b, t, l)))
    for name, x, shape in named:
        if x.device != wq.device or x.dtype != torch.bfloat16:
            raise ValueError(f"additive_scores: {name} must be a bf16 CUDA "
                             f"tensor on {wq.device}, got {x.dtype} on "
                             f"{x.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"additive_scores: {name} must be contiguous "
                             f"{shape}, got {tuple(x.shape)}")
    lib = _lib()
    if not lib.additive_supports(h) or b > 65535:
        raise ValueError(f"additive_scores: the kernels take a hidden width "
                         f"divisible by 8, at most 256, and at most 65535 "
                         f"rows; got H={h}, B={b}")
    if lib.additive_fwd_smem_bytes(h) > _SMEM_LIMIT:
        raise ValueError(f"additive_scores: H={h} needs more shared memory "
                         "than a block has")
    return lib, b, t, l, h


def _launch_fwd(wq, uh, v):
    lib, b, t, l, h = _check(wq, uh, v)
    out = torch.empty(b, t, l, dtype=wq.dtype, device=wq.device)
    if out.numel() == 0:
        return out
    rc = lib.additive_scores_fwd_bf16(
        wq.data_ptr(), uh.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, l,
        h, torch.cuda.current_stream(wq.device).cuda_stream)
    _build.check(rc, "additive_scores forward")
    global LAUNCHES
    LAUNCHES += 1
    return out


def _launch_bwd(wq, uh, v, g):
    lib, b, t, l, h = _check(wq, uh, v, g)
    dwq, duh = torch.empty_like(wq), torch.empty_like(uh)
    dv = torch.empty_like(v)
    part = torch.empty(lib.additive_dv_rows(b, t), h, dtype=torch.float32,
                       device=wq.device)
    rc = lib.additive_scores_bwd_bf16(
        wq.data_ptr(), uh.data_ptr(), v.data_ptr(), g.data_ptr(),
        dwq.data_ptr(), duh.data_ptr(), dv.data_ptr(), part.data_ptr(), b, t,
        l, h, torch.cuda.current_stream(wq.device).cuda_stream)
    _build.check(rc, "additive_scores backward")
    global LAUNCHES_BWD
    LAUNCHES_BWD += 1
    return dwq, duh, dv


def _lib():
    lib = _build.load("additive_attention")
    if not getattr(lib, "_argtypes_set", False):
        lib.additive_supports.argtypes = [ctypes.c_int]
        lib.additive_supports.restype = ctypes.c_int
        lib.additive_fwd_smem_bytes.argtypes = [ctypes.c_int]
        lib.additive_fwd_smem_bytes.restype = ctypes.c_int
        lib.additive_dv_rows.argtypes = [ctypes.c_int] * 2
        lib.additive_dv_rows.restype = ctypes.c_int
        lib.additive_scores_fwd_bf16.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.additive_scores_fwd_bf16.restype = ctypes.c_int
        lib.additive_scores_bwd_bf16.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.additive_scores_bwd_bf16.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib
