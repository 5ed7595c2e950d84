"""Fused training attention with probs dropout, forward and backward (port
of ``case_rg_tpu/kernels/train_attention.py``).

Two wrappers, each a ``torch.autograd.Function``:

* ``fused_train_mha``: the dropout mask is the caller's [R, H, Lq, Lk] bool
  draw (``ops/dropout.keep_mask``, the dense path's draw);
* ``fused_train_mha_rng``: the mask is drawn inside the kernel by
  Philox4x32-10 from a per-site seed and drawn again, bit for bit, in the
  backward; no mask tensor exists. Element (row r, head h, query i, key j)
  is kept when word ``j % 4`` of Philox(counter = (j // 4, i, h, r), key =
  seed) is below ``round((1 - rate) * 2**32)``, so the mask is a function
  of those indices alone, whatever the tiling. ``philox_keep_mask`` draws
  the same mask in PyTorch integer arithmetic. The stream differs from the
  TPU kernel's by design.

On a CUDA tensor a wrapper launches the hand-written kernels of
``csrc/train_attention.cu`` (bf16 only) as ``train_mha_plan`` lays them
out: at most 128 keys, one forward launch and one backward launch per
(row, head), the scores held whole; more keys (or a backward that does not
fit shared memory), a forward of two sweeps over key tiles and a backward
of two launches (a pass over query rows for dq and the row term, then a
pass over key tiles for dk and dv). It counts one forward or backward in
``LAUNCHES_FWD`` / ``LAUNCHES_BWD``, by variant ("mask", "rng"). On a CPU
tensor it runs the plain versions: ``fused_train_mha_plain`` (the JAX
package's ``fused_train_mha_xla``) and ``fused_train_mha_plain_bwd`` (the
recompute of its ``_bwd_kernel``). Anything else raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..ops.masking import neg_inf
from . import _build
from .encoder_attention import _scale

LAUNCHES_FWD = {"mask": 0, "rng": 0}   # since the last reset; plain runs excluded
LAUNCHES_BWD = {"mask": 0, "rng": 0}
_SMEM_LIMIT = 232448   # bytes of shared memory one block may use on sm_90

# ---- Philox4x32-10 in PyTorch integer arithmetic (int64 holding u32) ----

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor):
    """(lo, hi) 32-bit words of the 64-bit product a * b, without
    overflowing int64: b is split into 16-bit halves."""
    p1 = a * (b & 0xFFFF)                     # < 2**48
    p2 = a * (b >> 16)                        # < 2**48
    mid = p1 + ((p2 & 0xFFFF) << 16)          # < 2**49
    return mid & _U32, (p2 >> 16) + (mid >> 32)


def philox4x32(c0, c1, c2, c3, k0, k1, rounds: int = 10):
    """Philox4x32 (Salmon et al., SC 2011) on int64 tensors holding u32
    words; returns the four output words."""
    for i in range(rounds):
        if i:
            k0 = (k0 + _W0) & _U32
            k1 = (k1 + _W1) & _U32
        lo0, hi0 = _mulhilo(_M0, c0)
        lo1, hi1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_threshold(rate: float) -> int:
    """Keep an element when its u32 is below this (the JAX kernel's
    ``round((1 - rate) * 2**32)``)."""
    return int(round((1.0 - rate) * float(2 ** 32)))


def philox_keep_mask(seed, rows: int, num_heads: int, lq: int, lk: int,
                     rate: float) -> torch.Tensor:
    """The in-kernel dropout mask, bool [rows, H, Lq, Lk], on the seed's
    device. ``seed``: int64 [2] tensor of two u32 key words."""
    seed = torch.as_tensor(seed, dtype=torch.int64)
    dev = seed.device
    k0, k1 = seed[0] & _U32, seed[1] & _U32
    ng = (lk + 3) // 4
    shape = (rows, num_heads, lq, ng)
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=dev)
    ctr = (ar(ng).view(1, 1, 1, ng).expand(shape),
           ar(lq).view(1, 1, lq, 1).expand(shape),
           ar(num_heads).view(1, num_heads, 1, 1).expand(shape),
           ar(rows).view(rows, 1, 1, 1).expand(shape))
    words = torch.stack(philox4x32(*ctr, k0, k1), dim=-1)   # [.., ng, 4]
    u = words.reshape(rows, num_heads, lq, 4 * ng)[..., :lk]
    return u < keep_threshold(rate)


def draw_seed(gen: torch.Generator, device) -> torch.Tensor:
    """One site's Philox key, two u32 words in an int64 [2] tensor on
    ``device``, drawn from ``gen`` (the role of ``make_rng("dropout")``).
    It stays on the device: the kernel reads it there."""
    return torch.randint(0, 2 ** 32, (2,), generator=gen, device=device,
                         dtype=torch.int64)


# ---- plain versions ----

def _split(x, r, h, d):
    return x.reshape(r, -1, h, d).transpose(1, 2)


def _probs(qs, k, keep, r, h, d):
    """f32 softmax of the masked scores, [R, H, Lq, Lk]."""
    s = torch.matmul(_split(qs, r, h, d).float(),
                     _split(k, r, h, d).float().transpose(-1, -2))
    if keep is not None:
        s = torch.where(keep[:, None, None, :], s,
                        torch.full((), neg_inf(s.dtype), device=s.device))
    return torch.softmax(s, dim=-1)


def fused_train_mha_plain(q, k, v, keep, mask, num_heads: int,
                          rate: float) -> torch.Tensor:
    """The kernels' forward in PyTorch (``fused_train_mha_xla``): split
    heads, f32 scores and masked softmax, all-padding rows zeroed, probs
    dropout ``where(mask, p / (1 - rate), 0)``, probs cast to v's dtype,
    PV, merge heads."""
    r, lq, e = q.shape
    h = num_heads
    d = e // h
    probs = _probs(q * _scale(d, q.dtype).to(q.device), k, keep, r, h, d)
    if keep is not None:
        probs = probs * keep.any(dim=-1).to(probs.dtype)[:, None, None, None]
    probs = torch.where(mask, probs / (1.0 - rate),
                        torch.zeros((), device=probs.device))
    ctx = torch.matmul(probs.to(v.dtype), _split(v, r, h, d))
    return ctx.transpose(1, 2).reshape(r, lq, e)


def fused_train_mha_plain_bwd(q, k, v, keep, mask, do, num_heads: int,
                              rate: float):
    """(dq, dk, dv) of ``fused_train_mha_plain`` by recompute, with the JAX
    backward kernel's rounding points: dropped probs rounded to do's dtype
    before dv, ``ds = p * (dp - rowsum(dp * p))`` rounded to q's dtype
    before dq and dk, the scale's chain rule on dq only (in f32), and the
    rows whose keys are all padding zeroed."""
    r, lq, e = q.shape
    h = num_heads
    d = e // h
    ik = float(np.float32(1.0) / np.float32(1.0 - rate))
    qs = q * _scale(d, q.dtype).to(q.device)
    p = _probs(qs, k, keep, r, h, d)
    zero = torch.zeros((), device=p.device)
    doh = _split(do.to(q.dtype), r, h, d).float()
    pt = torch.where(mask, p * ik, zero)
    dv = torch.matmul(pt.to(do.dtype).float().transpose(-1, -2), doh)
    dpt = torch.matmul(doh, _split(v, r, h, d).float().transpose(-1, -2))
    dp = torch.where(mask, dpt * ik, zero)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds = ds.to(q.dtype).float()
    dq = torch.matmul(ds, _split(k, r, h, d).float())
    dk = torch.matmul(ds.transpose(-1, -2), _split(qs, r, h, d).float())
    av = (keep.any(dim=-1).float()[:, None, None, None] if keep is not None
          else torch.ones((), device=q.device))
    scale = float(np.float32(1.0) / np.sqrt(np.float32(d)))
    merge = lambda x: (x * av).transpose(1, 2).reshape(r, -1, e).to(q.dtype)
    return merge(dq * scale), merge(dk), merge(dv)


# ---- the autograd Function ----

def _mask_of(src, rng: bool, q, k, num_heads, rate):
    if not rng:
        return src
    return philox_keep_mask(src, q.shape[0], num_heads, q.shape[1],
                            k.shape[1], rate)


class _FusedTrainMHA(torch.autograd.Function):
    """src: the bool mask [R, H, Lq, Lk] (rng=False) or the int64 [2] seed
    (rng=True). The forward's per-row softmax statistics are kept for the
    backward on the card; the plain path keeps nothing but the inputs."""

    @staticmethod
    def forward(ctx, q, k, v, keep, src, num_heads, rate, rng):
        if q.device.type == "cpu":
            out = fused_train_mha_plain(
                q, k, v, keep, _mask_of(src, rng, q, k, num_heads, rate),
                num_heads, rate)
            stats = None
        else:
            out, stats = _launch_fwd(q, k, v, keep, src, num_heads, rate, rng)
        ctx.save_for_backward(q, k, v, keep, src, stats)
        ctx.num_heads, ctx.rate, ctx.rng = num_heads, rate, rng
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, keep, src, stats = ctx.saved_tensors
        h, rate, rng = ctx.num_heads, ctx.rate, ctx.rng
        do = do.to(q.dtype).contiguous()
        if q.device.type == "cpu":
            grads = fused_train_mha_plain_bwd(
                q, k, v, keep, _mask_of(src, rng, q, k, h, rate), do, h, rate)
        else:
            grads = _launch_bwd(q, k, v, keep, src, do, stats, h, rate, rng)
        return (*grads, None, None, None, None, None)


def fused_train_mha(q, k, v, keep, mask, num_heads: int,
                    rate: float) -> torch.Tensor:
    """q: [R, Lq, E]; k/v: [R, Lk, E] (in-projected); keep: [R, Lk] bool
    (True = attend) or None; mask: [R, H, Lq, Lk] bool dropout keep-mask.
    Returns the pre-out-projection context [R, Lq, E], differentiable in
    q, k and v."""
    return _FusedTrainMHA.apply(q, k, v, keep, mask, num_heads, rate, False)


def fused_train_mha_rng(q, k, v, keep, seed, num_heads: int,
                        rate: float) -> torch.Tensor:
    """As ``fused_train_mha`` with the mask drawn from ``seed`` (int64 [2],
    see ``draw_seed``) inside the kernel: ``philox_keep_mask(seed, ...)``."""
    return _FusedTrainMHA.apply(q, k, v, keep, seed, num_heads, rate, True)


# ---- the launch plan ----

_KINDS = ("fwd_short", "fwd_long", "bwd_short", "bwd_rows", "bwd_keys")
_SHORT_KEYS = 128     # keys a short-path block holds
_TILE = 64            # keys per tile of the long path
_MAX_WARPS = 8
_NBUF = 2             # key tiles in flight on the long path (1 or 2)


class Launch(NamedTuple):
    """One kernel launch: grid (R, H, z), ``warps`` warps a block (query
    warps times ``wk`` key warps), ``kt`` keys a block holds (short kinds
    and bwd_keys), ``nbuf`` key-tile buffers (long kinds), ``smem`` bytes of
    shared memory a block (the C launcher counts them itself, smem_need)."""
    kind: str
    warps: int
    wk: int
    kt: int
    z: int
    nbuf: int
    smem: int


def _smem(kind, lq, lk, d, kt, wk, nbuf, rng) -> int:
    """Shared-memory bytes of one block (csrc/train_attention.cu,
    smem_need: the same layouts)."""
    mpad, ld = -(-lq // 16) * 16, d + 8
    nall = -(-lk // _TILE) * _TILE
    mask_tile = 0 if rng else mpad * (kt + 16)
    mask_tiles = 0 if rng else nbuf * mpad * (_TILE + 16)
    kv = nbuf * 2 * _TILE * ld * 2
    tiles = max(kv, (wk - 1) * (mpad // 16) * 16 * d * 4)
    if kind == "fwd_short":     # at d = 160 the mask goes where K was
        return 2 * (mpad + 2 * kt) * ld + kt + (0 if d == 160 else mask_tile)
    if kind == "fwd_long":
        return 2 * mpad * ld + nall + 8 * wk * mpad + mask_tiles + tiles
    if kind in ("bwd_short", "bwd_keys"):
        return (2 * (2 * mpad + 2 * kt) * ld + 4 * mpad * (kt + 8) + kt
                + mask_tile)
    return 4 * mpad * ld + nall + mpad * nall // 8 + mask_tiles + kv


def _long(kind, lq, lk, d, rng) -> Launch:
    """A long-path sweep kernel, _NBUF key tiles in flight (one where shared
    memory is short: bwd_rows at d = 160 with thousands of keys); the
    forward with key warps beside the query warps at Lq <= 64."""
    wq = -(-lq // 16)
    wk = min(4, _MAX_WARPS // wq) if kind == "fwd_long" and lq <= 64 else 1
    for nbuf in range(_NBUF, 0, -1):
        smem = _smem(kind, lq, lk, d, _TILE, wk, nbuf, rng)
        if smem <= _SMEM_LIMIT:
            return Launch(kind, wq * wk, wk, _TILE, 1, nbuf, smem)
    raise ValueError(f"fused_train_mha: no launch of {kind} fits Lq={lq}, "
                     f"Lk={lk}, d={d}")


@functools.lru_cache(maxsize=None)
def train_mha_plan(lq: int, lk: int, d: int, rng: bool = True) -> dict:
    """The launches of the training attention at (Lq, Lk, head width d), for
    the in-kernel RNG (``rng``) or the caller's mask: ``{"fwd": [Launch],
    "bwd": [Launch, ...], "path": {"fwd": "short" | "long", "bwd": ...}}``.
    At most 128 keys the short path holds a (row, head)'s keys whole: one
    forward and one backward launch. More keys, or a short backward that
    does not fit a block's shared memory (d = 160 at 128 x 128), take the
    long path: tiles of 64 keys, and a backward of two launches. Cached:
    callers read the plan and do not change it."""
    wq = -(-lq // 16)
    plan = {"fwd": None, "bwd": None, "path": {}}
    if lk <= _SHORT_KEYS:
        kt = next(n for n in (64, 112, _SHORT_KEYS) if lk <= n)
        plan["fwd"] = [Launch("fwd_short", wq, 1, kt, 1, 1,
                              _smem("fwd_short", lq, lk, d, kt, 1, 1, rng))]
        smem = _smem("bwd_short", lq, lk, d, kt, 1, 1, rng)
        if smem <= _SMEM_LIMIT:
            plan["bwd"] = [Launch("bwd_short", wq, 1, kt, 1, 1, smem)]
    if plan["fwd"] is None:
        plan["fwd"] = [_long("fwd_long", lq, lk, d, rng)]
    if plan["bwd"] is None:
        plan["bwd"] = [_long("bwd_rows", lq, lk, d, rng),
                       Launch("bwd_keys", wq, 1, _TILE, -(-lk // _TILE), 1,
                              _smem("bwd_keys", lq, lk, d, _TILE, 1, 1, rng))]
    for way in ("fwd", "bwd"):
        plan["path"][way] = ("short" if plan[way][0].kind.endswith("short")
                             else "long")
    return plan


# ---- the CUDA launches ----

def _check(q, k, v, keep, src, num_heads, rng):
    r, lq, e = q.shape
    lk = k.shape[1]
    for name, x, shape in (("q", q, (r, lq, e)), ("k", k, (r, lk, e)),
                           ("v", v, (r, lk, e))):
        if x.device.type != "cuda" or x.dtype != torch.bfloat16:
            raise ValueError(f"fused_train_mha: {name} must be a bf16 CUDA "
                             f"tensor, got {x.dtype} on {x.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"fused_train_mha: {name} must be contiguous "
                             f"{shape}, got {tuple(x.shape)}")
    if keep is not None and (keep.dtype != torch.bool or keep.device != q.device
                             or tuple(keep.shape) != (r, lk)
                             or not keep.is_contiguous()):
        raise ValueError("fused_train_mha: keep must be a contiguous bool "
                         "[R, Lk] tensor on q's device")
    want = ((2,), torch.int64) if rng else ((r, num_heads, lq, lk), torch.bool)
    if (tuple(src.shape), src.dtype) != want or src.device != q.device \
            or not src.is_contiguous():
        raise ValueError(f"fused_train_mha: the {'seed' if rng else 'mask'} "
                         f"must be a contiguous {want[1]} {want[0]} tensor on "
                         "q's device")
    lib = _lib()
    d = e // num_heads
    if e % num_heads or not lib.train_mha_supports(lq, lk, d):
        raise ValueError(f"fused_train_mha: the kernel takes head widths 32 "
                         f"or 160, at most 128 queries and 4096 keys; got "
                         f"E={e}, H={num_heads}, Lq={lq}, Lk={lk}")
    return lib, r, lq, lk, e, d


def _consts(d: int, rate: float):
    return (float(_scale(d, torch.bfloat16)),
            float(np.float32(1.0) / np.sqrt(np.float32(d))),
            float(np.float32(1.0) / np.float32(1.0 - rate)),
            keep_threshold(rate))


def _ptr(x):
    return x.data_ptr() if x is not None else None


def _launch(lib, plan, what, q, k, v, keep, src, do, stats, rowterm, out,
            dk, dv, num_heads, rate, rng):
    r, lq, e = q.shape
    lk = k.shape[1]
    qscale, dqscale, inv_keep, thresh = _consts(e // num_heads, rate)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    for ln in plan:
        rc = lib.train_mha_launch(
            _KINDS.index(ln.kind), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _ptr(keep), None if rng else src.data_ptr(),
            src.data_ptr() if rng else None, _ptr(do), _ptr(stats),
            _ptr(rowterm), out.data_ptr(), _ptr(dk), _ptr(dv), r, lq, lk, e,
            num_heads, qscale, dqscale, inv_keep, thresh, int(rng), ln.warps,
            ln.wk, ln.kt, ln.z, ln.nbuf, stream)
        _build.check(rc, f"fused_train_mha {what} ({ln.kind})")


@_build.on_input_card
def _launch_fwd(q, k, v, keep, src, num_heads, rate, rng):
    lib, r, lq, lk, e, d = _check(q, k, v, keep, src, num_heads, rng)
    out = torch.empty_like(q)
    stats = torch.empty(r, num_heads, lq, 2, dtype=torch.float32,
                        device=q.device)
    _launch(lib, train_mha_plan(lq, lk, d, rng)["fwd"], "forward", q, k, v,
            keep, src, None, stats, None, out, None, None, num_heads, rate,
            rng)
    with _build.COUNT_LOCK:
        LAUNCHES_FWD["rng" if rng else "mask"] += 1
    return out, stats


@_build.on_input_card
def _launch_bwd(q, k, v, keep, src, do, stats, num_heads, rate, rng):
    lib, r, lq, lk, e, d = _check(q, k, v, keep, src, num_heads, rng)
    plan = train_mha_plan(lq, lk, d, rng)["bwd"]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rowterm = (torch.empty(r, num_heads, lq, dtype=torch.float32,
                           device=q.device) if len(plan) > 1 else None)
    _launch(lib, plan, "backward", q, k, v, keep, src, do, stats, rowterm,
            dq, dk, dv, num_heads, rate, rng)
    with _build.COUNT_LOCK:
        LAUNCHES_BWD["rng" if rng else "mask"] += 1
    return dq, dk, dv


def _lib():
    lib = _build.load("train_attention")
    if not getattr(lib, "_argtypes_set", False):
        lib.train_mha_supports.argtypes = [ctypes.c_int] * 3
        lib.train_mha_supports.restype = ctypes.c_int
        lib.train_mha_smem_need.argtypes = [ctypes.c_int] * 8
        lib.train_mha_smem_need.restype = ctypes.c_int
        lib.train_mha_launch.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
            + [ctypes.c_float] * 3 + [ctypes.c_uint64] + [ctypes.c_int] * 6
            + [ctypes.c_void_p])
        lib.train_mha_launch.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib
