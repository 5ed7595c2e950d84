"""One fused decode step through a whole decoder stack (port of
``case_rg_tpu/kernels/decoder_stack.py``).

``fold_stack_weights`` folds a decoder stack's cross-attention projections
into the operands the step reads against the RAW memory (scores = x A_h m^T
+ m u_h; the softmax-invariant terms x W_q,h . b_k,h and b_q,h . b_k,h are
dropped; context through W_v,h W_o,h plus b_v W_o + b_o), so no per-layer
cross K/V cache is ever built.

``stack_step`` is the wrapper: on a CUDA tensor it launches the
hand-written kernel in ``csrc/decoder_stack.cu`` (bf16 only; one launch
runs every layer, a row on a cluster of two blocks or on one, as
``stack_step_plan`` lays it out) and counts the launch in ``LAUNCHES``; on
a CPU tensor it runs ``stack_step_plain``, the same function in PyTorch
with the bf16 roundings at the same points. Both update the KV cache IN
PLACE (only slot t of each layer is written) and return it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from ..ops.cache import write_step
from ..ops.masking import neg_inf
from . import _build

LAUNCHES = 0        # kernel launches since the last reset (plain runs excluded)
_LN_EPS = 1e-5
_SMEM_LIMIT = 232448   # bytes of shared memory one block may use on sm_90
_E = 256               # the stream width the kernel takes

# operand order of the kernel's weight-pointer array (csrc/decoder_stack.cu)
WEIGHT_KEYS = ("ln1g", "ln1b", "wqkv", "bqkv", "wos", "bos",
               "ln2g", "ln2b", "aq", "u", "wvo", "bout",
               "ln3g", "ln3b", "w1", "b1", "w2", "b2")


@torch.no_grad()
def fold_stack_weights(decoder, num_layers: int, num_heads: int,
                       dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The kernel's stacked [n_layers, ...] operands from an
    ``ops.transformer.Decoder``. Folds run in f32 and are cast to ``dtype``
    once. Matrices are in [in, out] layout."""
    h = num_heads
    out: Dict[str, list] = {k: [] for k in WEIGHT_KEYS}
    for i in range(num_layers):
        p = decoder.layers[i]
        for norm, g, b in ((p.norm1, "ln1g", "ln1b"), (p.norm2, "ln2g", "ln2b"),
                           (p.norm3, "ln3g", "ln3b")):
            out[g].append(norm.weight.float())
            out[b].append(norm.bias.float())
        sa = p.self_attn
        out["wqkv"].append(sa.in_proj_weight.float().t())
        out["bqkv"].append(sa.in_proj_bias.float())
        out["wos"].append(sa.out.weight.float().t())
        out["bos"].append(sa.out.bias.float())

        ca = p.cross_attn
        e = ca.embed_dim
        d = e // h
        scale = float(np.float32(1.0) / np.sqrt(np.float32(d)))
        w = ca.in_proj_weight.float()
        bias = ca.in_proj_bias.float()
        wq_h = w[:e].t().reshape(e, h, d)
        wk_h = w[e:2 * e].t().reshape(e, h, d)
        wv_h = w[2 * e:].t().reshape(e, h, d)
        bq_h = bias[:e].reshape(h, d)
        bv = bias[2 * e:]
        wo = ca.out.weight.float().t()
        bo = ca.out.bias.float()
        # b_k only feeds softmax-invariant score terms, so it drops out.
        # aq[:, hh*e:(hh+1)*e] = s * W_q,h @ W_k,h^T  -> [e, h*e]
        out["aq"].append((scale * torch.einsum("ehd,fhd->ehf", wq_h, wk_h)
                          ).reshape(e, h * e))
        # u[hh*e:(hh+1)*e] = s * W_k,h @ b_q,h        -> [h*e]
        out["u"].append((scale * torch.einsum("ehd,hd->he", wk_h, bq_h)
                         ).reshape(h * e))
        # wvo[hh*e:(hh+1)*e, :] = W_v,h @ W_o,h       -> [h*e, e]
        out["wvo"].append(torch.einsum("ehd,hdf->hef", wv_h,
                                       wo.reshape(h, d, e)).reshape(h * e, e))
        out["bout"].append(bv @ wo + bo)

        out["w1"].append(p.ffn.linear1.weight.float().t())
        out["b1"].append(p.ffn.linear1.bias.float())
        out["w2"].append(p.ffn.linear2.weight.float().t())
        out["b2"].append(p.ffn.linear2.bias.float())
    return {k: torch.stack(v).to(dtype).contiguous() for k, v in out.items()}


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def _span(cluster: int, l: int) -> int:
    """Positions of a row's memory each block of the cluster owns."""
    return l if cluster == 1 else _up(_up(l, cluster) // cluster, 16)


def stack_step_smem(cluster: int, tmax: int, l: int, h: int, f: int) -> int:
    """Shared-memory bytes of one block (``csrc/decoder_stack.cu``,
    ``smem_bytes``): the stream and its intermediates, the scores of the
    block's positions [H, max(span, T)], the matrix-vector partial sums,
    the context partials, the cluster's max and sum exchange, the history
    mask and, with two blocks a row, both blocks' context partials [2, H,
    E]."""
    e = _E
    lt = max(_span(cluster, l), tmax)
    return 4 * (5 * e + 8 * e // 2 + max(8 * e, f) + h * lt + 8 * 512
                + 8 * 8 * e + 64 + tmax + (cluster * h * e if cluster > 1
                                           else 0))


def stack_step_plan(b: int, l: int, tmax: int, h: int, f: int,
                    max_clusters: int) -> dict:
    """The launch for a step of B rows over L memory positions (history T,
    H heads, FFN width F) on a card that holds ``max_clusters`` two-block
    clusters at once (cudaOccupancyMaxActiveClusters):
    ``{"cluster", "span", "smem", "blocks"}``.

    A row runs on a cluster of two blocks (each owning ``span`` positions
    and half of every product's columns) where one wave of clusters holds
    the batch, and on one block otherwise: two blocks a row in two or more
    waves would read every weight and position once per wave, where one
    block a row reads them in one wave or two. Where one block's shared
    memory cannot hold a row's scores, two blocks a row take it. Raises
    where neither fits."""
    fits = {c: stack_step_smem(c, tmax, l, h, f) <= _SMEM_LIMIT
            for c in (1, 2)}
    if fits[2] and (b <= max_clusters or not fits[1]):
        cluster = 2
    elif fits[1]:
        cluster = 1
    else:
        raise ValueError(f"stack_step: no launch fits L={l}, T={tmax}, H={h}, "
                         f"F={f} in a block's shared memory")
    return {"cluster": cluster, "span": _span(cluster, l),
            "smem": stack_step_smem(cluster, tmax, l, h, f),
            "blocks": cluster * b}


def _scale(d: int, dtype) -> torch.Tensor:
    """1/sqrt(d) in f32, rounded to ``dtype`` as the JAX kernel does."""
    return torch.tensor(np.float32(1.0) / np.sqrt(np.float32(d))).to(dtype)


def _rows_t(t, b: int, device) -> torch.Tensor:
    if isinstance(t, torch.Tensor) and t.ndim == 1:
        return t.to(device=device, dtype=torch.int32).contiguous()
    return torch.full((b,), int(t), dtype=torch.int32, device=device)


def _layernorm(x, g, b):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + _LN_EPS)
    return (y * g.float() + b.float()).to(x.dtype)


def stack_step_plain(x, t, caches, m, mem_keep, hist_keep,
                     folded: Dict[str, torch.Tensor], num_heads: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in PyTorch: the same layer walk, the same
    bf16 roundings, products accumulated in f32."""
    b, e = x.shape
    nl, tmax = caches.shape[1], caches.shape[2]
    h = num_heads
    d = e // h
    dt = x.dtype
    w = folded
    big_neg = torch.full((), neg_inf(torch.float32), device=x.device)
    scale = _scale(d, dt).to(x.device)
    tt = _rows_t(t, b, x.device)
    mm = lambda a, wt: a.float() @ wt.float()
    mem_any = mem_keep.any(-1).float()[:, None, None]        # [B, 1, 1]
    hist_any = hist_keep.any(-1).float()[:, None]            # [B, 1]
    mf = m.float()
    for l in range(nl):
        # ---- self-attention over the KV cache ----
        xn = _layernorm(x, w["ln1g"][l], w["ln1b"][l])
        qkv = (mm(xn, w["wqkv"][l]) + w["bqkv"][l].float()).to(dt)
        write_step(caches[:, l], qkv[:, None, e:], tt)
        k = caches[:, l, :, :e].reshape(b, tmax, h, d).float()
        v = caches[:, l, :, e:].reshape(b, tmax, h, d).float()
        qs = (qkv[:, :e] * scale).reshape(b, h, d).float()
        s = torch.einsum("bhd,bthd->bht", qs, k)
        s = torch.where(hist_keep[:, None, :], s, big_neg)
        p = torch.softmax(s, dim=-1).to(dt).float()
        a = torch.einsum("bht,bthd->bhd", p, v).reshape(b, e) * hist_any
        a = mm(a.to(dt), w["wos"][l]) + w["bos"][l].float()
        x = xn + a.to(dt)
        # ---- folded cross-attention against the raw memory ----
        xn = _layernorm(x, w["ln2g"][l], w["ln2b"][l])
        qf = (mm(xn, w["aq"][l]) + w["u"][l].float()).reshape(b, h, e)
        s = torch.einsum("bhe,ble->bhl", qf.to(dt).float(), mf)
        s = torch.where(mem_keep[:, None, :], s, big_neg)
        p = torch.softmax(s, dim=-1) * mem_any
        cf = torch.einsum("bhl,ble->bhe", p.to(dt).float(), mf)
        ctx = mm(cf.to(dt).reshape(b, h * e), w["wvo"][l]) \
            + w["bout"][l].float()
        x = xn + ctx.to(dt)
        # ---- FFN (residual around the normed stream) ----
        xn = _layernorm(x, w["ln3g"][l], w["ln3b"][l])
        f = mm(xn, w["w1"][l]) + w["b1"][l].float()
        f = 0.5 * f * (1.0 + torch.erf(f * np.float32(1.0 / np.sqrt(2.0))))
        f = mm(f.to(dt), w["w2"][l]) + w["b2"][l].float()
        x = xn + f.to(dt)
    return x, caches


def stack_step(x: torch.Tensor, t, caches: torch.Tensor, m: torch.Tensor,
               mem_keep: torch.Tensor, hist_keep: torch.Tensor,
               folded: Dict[str, torch.Tensor], num_heads: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step through a whole stack.

    x: [B, E] current hidden; t: int or [B] step indices (rows whose t is
    out of [0, T) skip their cache write); caches: [B, n_layers, T, 2E]
    packed K|V, updated in place; m: [B, L, E] raw encoder memory;
    mem_keep/hist_keep: [B, L]/[B, T] bool; folded: output of
    ``fold_stack_weights``. On the card the launch is
    ``stack_step_launch``'s. Returns (x_out [B, E], caches)."""
    if x.device.type == "cpu":
        return stack_step_plain(x, t, caches, m, mem_keep, hist_keep, folded,
                                num_heads)
    b, e = x.shape
    _, nl, tmax, e2 = caches.shape
    l = m.shape[1]
    h = num_heads
    f = folded["w1"].shape[2]
    if e % h or e2 != 2 * e:
        raise ValueError(f"stack_step: E={e} and caches' last dim {e2} do "
                         f"not fit {h} heads")
    shapes = {"x": (x, (b, e)), "caches": (caches, (b, nl, tmax, 2 * e)),
              "m": (m, (b, l, e))}
    expect = {"ln1g": (nl, e), "ln1b": (nl, e), "wqkv": (nl, e, 3 * e),
              "bqkv": (nl, 3 * e), "wos": (nl, e, e), "bos": (nl, e),
              "ln2g": (nl, e), "ln2b": (nl, e), "aq": (nl, e, h * e),
              "u": (nl, h * e), "wvo": (nl, h * e, e), "bout": (nl, e),
              "ln3g": (nl, e), "ln3b": (nl, e), "w1": (nl, e, f),
              "b1": (nl, f), "w2": (nl, f, e), "b2": (nl, e)}
    shapes.update({k: (folded[k], s) for k, s in expect.items()})
    for name, (ten, shape) in shapes.items():
        if ten.device != x.device or ten.dtype != torch.bfloat16:
            raise ValueError(f"stack_step: {name} must be a bf16 tensor on "
                             f"{x.device}, got {ten.dtype} on {ten.device}")
        if tuple(ten.shape) != shape or not ten.is_contiguous():
            raise ValueError(f"stack_step: {name} must be contiguous "
                             f"{shape}, got {tuple(ten.shape)}")
    for name, ten, shape in (("mem_keep", mem_keep, (b, l)),
                             ("hist_keep", hist_keep, (b, tmax))):
        if ten.dtype != torch.bool or tuple(ten.shape) != shape \
                or ten.device != x.device:
            raise ValueError(f"stack_step: {name} must be a bool {shape} "
                             f"tensor on {x.device}")
    lib = _lib()
    if not lib.stack_step_supports(e, h, f):
        raise ValueError(f"stack_step: the kernel takes E=256, at most 8 heads "
                         f"of a width divisible by 8 and an FFN width "
                         f"divisible by 256; got E={e}, H={h}, F={f}")
    plan = stack_step_launch(b, l, tmax, h, f)
    if lib.stack_step_smem_bytes(plan["cluster"], tmax, l, h, f) != plan["smem"]:
        raise RuntimeError("stack_step: the C launcher and stack_step_plan "
                           "count shared memory differently")
    tt = _rows_t(t, b, x.device)
    mem_keep = mem_keep.contiguous()
    hist_keep = hist_keep.contiguous()
    ptrs = (ctypes.c_void_p * len(WEIGHT_KEYS))(
        *[folded[k].data_ptr() for k in WEIGHT_KEYS])
    xout = torch.empty_like(x)
    rc = lib.stack_step_bf16(
        x.data_ptr(), tt.data_ptr(), caches.data_ptr(), m.data_ptr(),
        mem_keep.data_ptr(), hist_keep.data_ptr(), ptrs, xout.data_ptr(),
        b, nl, tmax, e, l, h, f, float(_scale(e // h, torch.bfloat16)),
        plan["cluster"], torch.cuda.current_stream(x.device).cuda_stream, None)
    _build.check(rc, "stack_step")
    global LAUNCHES
    LAUNCHES += 1
    return xout, caches


@functools.lru_cache(maxsize=None)
def max_active_clusters(l: int, tmax: int, h: int, f: int) -> int:
    """cudaOccupancyMaxActiveClusters of the two-block launch at these
    shapes on the current card: how many rows it runs at once."""
    smem = stack_step_smem(2, tmax, l, h, f)
    if smem > _SMEM_LIMIT:
        return 0
    n = ctypes.c_int(0)
    rc = _lib().stack_step_bf16(*[None] * 8, 1, 1, tmax, _E, l, h, f, 1.0, 2,
                                None, ctypes.byref(n))
    _build.check(rc, "stack_step occupancy")
    return n.value


def stack_step_launch(b: int, l: int, tmax: int, h: int, f: int) -> dict:
    """``stack_step_plan`` on the current card."""
    return stack_step_plan(b, l, tmax, h, f, max_active_clusters(l, tmax, h, f))


def _lib():
    lib = _build.load("decoder_stack")
    if not getattr(lib, "_argtypes_set", False):
        lib.stack_step_smem_bytes.argtypes = [ctypes.c_int] * 5
        lib.stack_step_smem_bytes.restype = ctypes.c_int
        lib.stack_step_supports.argtypes = [ctypes.c_int] * 3
        lib.stack_step_supports.restype = ctypes.c_int
        lib.stack_step_bf16.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.POINTER(ctypes.c_void_p),
                                     ctypes.c_void_p]
            + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                    ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_int)])
        lib.stack_step_bf16.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib
