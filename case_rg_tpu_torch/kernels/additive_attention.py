"""Additive (Bahdanau) attention scores without the [B, T, L, H] tensor
(port of ``case_rg_tpu/kernels/additive_attention.py``).

``additive_scores(wq, uh, v)`` computes ``s[b, t, l] = sum_h tanh(wq[b, t,
h] + uh[b, l, h]) * v[h]``, the scorer of every ``ops/bilinear.
BilinearAttention`` (CaSE's copy attention over both memories, in every
decode step and in teacher forcing). It is a ``torch.autograd.Function``:
on CUDA tensors its forward and its backward launch the hand-written
kernels of ``csrc/additive_attention.cu`` (bf16 only) in the layouts
``additive_scores_plan`` picks, and count one forward in ``LAUNCHES`` and
one backward in ``LAUNCHES_BWD``; on CPU tensors they run the plain
versions, ``additive_scores_plain`` (the JAX package's ``_scores_xla``)
and ``additive_scores_plain_bwd`` (the math of its custom VJP ``_bwd``).
Both keep the kernels' rounding points: wq + uh rounded to the input
dtype, tanh rounded to the input dtype, each sum in f32 rounded once.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

LAUNCHES = 0        # forward calls since the last reset (plain runs excluded)
LAUNCHES_BWD = 0    # backward calls (two launches, three in "partials")
_SMS = 132          # SMs of an H100 SXM: the plans size their grids for it
_NK = 64            # backward: keys a block (kNK of the C source)
_MAX_CLUSTER = 16   # blocks a cluster (non-portable above 8)
# "partials": clusters of 8 key tiles, taken past 8 key tiles a row (at the
# 1000-key memory's 16 it beats one cluster of 16 on an H100: PERF.md)
_PARTIALS_CLUSTER = 8
# backward blocks in flight at once on an H100: two an SM, of which clusters
# of 16 leave 224 (14 clusters, cudaOccupancyMaxActiveClusters)
_BWD_SLOTS = 224
_ROUND_QUERIES = 4  # a block's fixed cost (staging, barriers), in queries
# shared memory a backward block may take for two to fit an SM (228 KB an
# SM, 1 KB reserved a block)
_SMEM_TWO = 228 * 1024 // 2 - 1024
_CHUNK = 48         # backward: queries a chunk, at most (two blocks an SM)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def additive_scores_plan(b: int, t: int, l: int, h: int, bwd=None) -> dict:
    """The kernels' launches for wq [b, t, h] and uh [b, l, h], as the C
    launchers of ``csrc/additive_attention.cu`` lay them out.

    Forward, one layout for every t: a warp takes ``keys_a_warp`` keys of a
    query row, a lane 8 h of each (one 16-byte load), 4 warps a block, a
    block row a query row; 8 keys a warp where that still gives 16 warps an
    SM, else 4.

    Backward: a block takes 64 keys (``_NK``) of a row, a thread an h.
    "cluster" (a row's key tiles fit one cluster, at most 16; planned up
    to 8): a cluster of (key tiles, query shares) blocks, the query shares
    chosen to fill the blocks in flight (``_BWD_SLOTS``) at the least cost
    of rounds times (a block's queries + ``_ROUND_QUERIES``); "partials"
    (planned past 8 key tiles): clusters of 8 key tiles, each cluster's dwq
    sums in f32 and a second launch to add them. ``chunk`` queries of g a
    round in ``smem`` bytes of shared memory. Each cluster's dv partial is
    added in cluster order by a launch of its own. ``bwd`` forces a layout
    (for comparisons on the card). Raises ValueError on a shape no layout
    takes."""
    if not (8 <= h <= 256 and h % 8 == 0) or t < 1 or l < 1 \
            or not 1 <= b <= 65535:
        raise ValueError(f"additive_scores: the kernels take a hidden width "
                         f"divisible by 8 in [8, 256], T >= 1, L >= 1 and "
                         f"1 <= B <= 65535; got B={b}, T={t}, L={l}, H={h}")
    return {"fwd": _fwd_plan(b, t, l), "bwd": _bwd_plan(b, t, l, h, bwd)}


def _fwd_plan(b, t, l):
    keys = 8 if b * t * _cdiv(l, 8) >= 16 * _SMS else 4   # 16 warps an SM
    grid = (b * t, _cdiv(l, 4 * keys))
    if grid[0] >= 2 ** 31 or grid[1] > 65535:
        raise ValueError(f"additive_scores: a forward grid of {grid} blocks "
                         f"is beyond CUDA's limits")
    return {"keys_a_warp": keys, "grid": grid}


def _bwd_layout(layout, tiles, split, t, h):
    """(per, chunk, red_rows, smem) of a backward block: ``per`` queries in
    chunks of ``chunk``; red_rows rows of H floats for dq's partials (where
    dq is added across blocks) and the 64 keys' duh (where queries split)."""
    per = _cdiv(t, split)
    chunk = min(_CHUNK, per)
    red_rows = (chunk if tiles > 1 or layout == "partials" else 0) \
        + (_NK if split > 1 else 0)
    return per, chunk, red_rows, 4 * (red_rows * h + chunk * _NK
                                      + (_NK // 2 + 1) * h)


def _bwd_plan(b, t, l, h, layout):
    tiles = _cdiv(l, _NK)
    if layout is None:
        layout = "cluster" if tiles <= _PARTIALS_CLUSTER else "partials"
    if layout == "cluster":
        if tiles > _MAX_CLUSTER:
            raise ValueError(f"additive_scores: L={l} needs {tiles} key tiles, "
                             f"more than a cluster of {_MAX_CLUSTER} holds")
        # query shares that keep two blocks an SM (the launch bound), at the
        # least cost of rounds x (a block's queries + a block's fixed cost)
        fits = [s for s in range(1, min(t, _MAX_CLUSTER // tiles) + 1)
                if _bwd_layout(layout, tiles, s, t, h)[3] <= _SMEM_TWO]
        split = min(fits, key=lambda s: _cdiv(b * tiles * s, _BWD_SLOTS)
                    * (_cdiv(t, s) + _ROUND_QUERIES))
        split = _cdiv(t, _cdiv(t, split))
        cx = gx = tiles
    elif layout == "partials":
        cx = min(tiles, _PARTIALS_CLUSTER)
        gx = _cdiv(tiles, cx) * cx
        split = 1
    else:
        raise ValueError(f"additive_scores: no backward layout {layout!r}")
    per, chunk, red_rows, smem = _bwd_layout(layout, cx, split, t, h)
    return {"layout": layout, "cluster": (cx, split), "grid": (gx, split, b),
            "queries_a_block": per, "chunk": chunk, "red_rows": red_rows,
            "smem": smem, "clusters": gx // cx * b}


def additive_scores_launch(b: int, t: int, l: int, h: int) -> dict:
    """The plan the wrapper launches (chip_smoke.py and the ``cuda`` tests
    replace it to time or hold the other backward layout)."""
    return additive_scores_plan(b, t, l, h)


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


def _aligned(x):
    """x, or a copy where its start is not 16-byte aligned (the kernels read
    16 bytes a lane)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


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
    return b, t, l, h


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch_fwd(wq, uh, v):
    b, t, l, h = _check(wq, uh, v)
    out = torch.empty(b, t, l, dtype=wq.dtype, device=wq.device)
    if out.numel() == 0:
        return out
    plan = additive_scores_launch(b, t, l, h)["fwd"]
    wq, uh, v = map(_aligned, (wq, uh, v))
    rc = _lib().additive_scores_fwd_bf16(
        wq.data_ptr(), uh.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, t, l, h, plan["keys_a_warp"], _stream(wq))
    _build.check(rc, "additive_scores forward")
    global LAUNCHES
    LAUNCHES += 1
    return out


def _launch_bwd(wq, uh, v, g):
    b, t, l, h = _check(wq, uh, v, g)
    plan = additive_scores_launch(b, t, l, h)["bwd"]
    lib = _lib()
    if lib.additive_bwd_smem_bytes(h, plan["chunk"],
                                   plan["red_rows"]) != plan["smem"]:
        raise RuntimeError("additive_scores: the C launcher and "
                           "additive_scores_plan count shared memory "
                           "differently")
    wq, uh, v, g = map(_aligned, (wq, uh, v, g))
    dwq, duh = torch.empty_like(wq), torch.empty_like(uh)
    dv = torch.empty_like(v)
    gx, split, _ = plan["grid"]
    cx = plan["cluster"][0]
    f32 = dict(dtype=torch.float32, device=wq.device)
    dq_part = (torch.empty(b, gx // cx, t, h, **f32)
               if plan["layout"] == "partials" else None)
    dv_part = torch.empty(plan["clusters"], h, **f32)
    rc = lib.additive_scores_bwd_bf16(
        wq.data_ptr(), uh.data_ptr(), v.data_ptr(), g.data_ptr(),
        dwq.data_ptr(), duh.data_ptr(), dv.data_ptr(),
        None if dq_part is None else dq_part.data_ptr(), dv_part.data_ptr(),
        b, t, l, h, gx, cx, split, plan["queries_a_block"], plan["chunk"],
        _stream(wq))
    _build.check(rc, "additive_scores backward")
    global LAUNCHES_BWD
    LAUNCHES_BWD += 1
    return dwq, duh, dv


def _lib():
    lib = _build.load("additive_attention")
    if not getattr(lib, "_argtypes_set", False):
        lib.additive_bwd_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.additive_bwd_smem_bytes.restype = ctypes.c_int
        lib.additive_scores_fwd_bf16.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.additive_scores_fwd_bf16.restype = ctypes.c_int
        lib.additive_scores_bwd_bf16.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        lib.additive_scores_bwd_bf16.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib
