#!/usr/bin/env python3
"""Chip smoke run of case_rg_tpu_torch, the PyTorch/CUDA port, on one NVIDIA
card.

    python3 chip_smoke.py        # from the repository root; needs one card

In order it
  1. prints the card's name and power limit, builds the CUDA kernels from
     case_rg_tpu_torch/csrc (nvcc, sm_90a) and prints the build time and
     each kernel's registers and shared memory (ptxas -v);
  2. holds each kernel against its plain PyTorch version on the card, in
     bf16, at the shapes CaSE serving gives it (tolerances below);
  3. times each kernel, its plain version and, where one PyTorch call
     computes the same function, that call (CUDA events, after warm-up);
  4. builds CaSE at the serving widths (V=30522, E=256, H=8, 3 encoder and
     2x4 decoder layers, bf16 weights drawn from a seed, with noisy biases
     and LayerNorm gains) and serves B=64 batches (query 60, pool 10x100,
     40-step greedy decode) and one rank-only batch through
     make_predict_fn, with the launch counters set to 0 just before and
     read just after. It serves the same batches twice more: with each
     kernel's wrapper swapped for its plain version (the same function with
     the same rounding points; answers gated at a stated agreement), and
     with the kernels routed off (dense attention, per-layer decode chain;
     rank gated, answers reported). Last, it profiles two batches with
     torch.profiler: device busy and idle share, and the kernels that take
     the most device time;
  5. prints one JSON line {"kernels": [...]} and, last, the device line
     {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no result.
It also fails when torch sees no card, and when it stands alone without the
case_rg_tpu_torch package beside it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12

# serving shapes (bench.py): B=64, query 60, pool 10 x 100, answer 40
B, LQ, P, LP, T_ANS = 64, 60, 10, 100, 40
V, E, H, ENC_LAYERS, DEC_LAYERS = 30522, 256, 8, 3, 4
# fused_mha sites per predict: (rows, L, E) -> count
MHA_SITES = {(B, LQ, E): 6,            # encoder query x3, ps q blocks 1-2, sti q block 1
             (B * P, LP, E): 9,        # encoder pool x3, ps p blocks 1-4, sti p blocks 1-2
             (B, LQ, 5 * E): 2,        # ps/sti q block 0 (5D wide, d=160)
             (B * P, LP, 5 * E): 2}    # ps/sti p block 0
RANK_ONLY_MHA = 14                     # encoder x6, ps tower 3 + 5

# Stated tolerances, in bf16 ulps (2^-7 relative), element by element, at
# the larger of the element's magnitude and its row's RMS (see bf16_ulps):
# a kernel and its plain version round the same values but sum in another
# order, so a rounding may land one ulp apart; the decoder stack carries
# such differences through 4 layers and several self-fed steps. Each limit
# is the worst reading on an H100 (3, 9 and 13 ulps) with a margin.
MHA_ULPS = 4
STACK_ULPS = 16
# rank scores: kernels vs their plain versions, and kernels on vs routed
# off, through 11 attention sites of the encoder and the selection tower
RANK_ULPS = 24
# Answers. With random weights greedy decoding meets near-ties that a
# one-ulp difference in a few attention outputs tips, and a tipped token
# changes the rest of its row. So the kernels are held to their plain
# versions on at least these shares of answer tokens and of first tokens,
# and on no less (by AGREEMENT_SLACK) than a witness that differs from the
# plain versions only in rounding: attention with every sum exact (f64)
# before its rounding (mha_exact_sums).
MIN_TOKEN_AGREEMENT = 0.7
MIN_FIRST_TOKEN_AGREEMENT = 0.75
AGREEMENT_SLACK = 0.05
PROFILE_BATCHES = 2


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def bf16_ulps(out: torch.Tensor, ref: torch.Tensor):
    """(max |out - ref| in bf16 ulps, max |out - ref|). An element's ulp is
    taken at the larger of its magnitude and its row's RMS (rows along the
    last dim), so an element near 0 is held to its row's scale."""
    o, r = out.float(), ref.float()
    rms = r.square().mean(-1, keepdim=True).sqrt()
    mag = torch.maximum(r.abs(), rms).clamp_min(2.0 ** -100)
    diff = (o - r).abs()
    ulps = diff / torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ulps.max().item(), diff.max().item()


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# ---- phase 2/3: fused_mha ----

def mha_inputs(r, l, e, gen, dev):
    q, k, v = (torch.randn(r, l, e, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    lengths = torch.randint(l // 3, l + 1, (r,), generator=gen, device=dev)
    keep = torch.arange(l, device=dev)[None, :] < lengths[:, None]
    keep[:2] = False                       # rows whose keys are all padding
    return q, k, v, keep


def check_and_time_mha(dev, gen):
    from case_rg_tpu_torch.kernels import encoder_attention as ea
    rows, total = [], {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                       "bytes": 0, "flops": 0, "max_abs_err": 0.0,
                       "max_ulps": 0.0}
    for (r, l, e), count in MHA_SITES.items():
        q, k, v, keep = mha_inputs(r, l, e, gen, dev)
        out = ea.fused_mha(q, k, v, keep, H)
        ref = ea.fused_mha_plain(q, k, v, keep, H)
        torch.cuda.synchronize()
        ulps, err = bf16_ulps(out, ref)
        check(ulps <= MHA_ULPS,
              f"fused_mha R={r} L={l} E={e}: kernel vs plain {ulps} bf16 "
              f"ulps > {MHA_ULPS}")
        check(bool((out[:2] == 0).all()), "fused_mha: all-padding rows not 0")
        d = e // H
        qh, kh, vh = (x.view(r, l, H, d).transpose(1, 2) for x in (q, k, v))
        lib_keep = keep.clone()
        lib_keep[:, 0] = True              # SDPA gives NaN on empty rows
        lib_mask = lib_keep[:, None, None, :]
        ms = time_ms(lambda: ea.fused_mha(q, k, v, keep, H))
        plain = time_ms(lambda: ea.fused_mha_plain(q, k, v, keep, H))
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=lib_mask))
        n_bytes = nbytes(q, k, v, keep, out)
        n_flops = 4 * l * d * H * int(keep.sum().item())   # QK^T and PV, valid keys
        rows.append({"rows": r, "L": l, "E": e, "d": d, "sites": count,
                     "max_abs_err": err, "max_ulps": ulps,
                     "ms": ms, "plain_ms": plain,
                     "library_ms": lib,
                     "bound_ms": bound_ms(n_bytes, n_flops)[0]})
        total["ms"] += count * ms
        total["plain_ms"] += count * plain
        total["library_ms"] += count * lib
        total["bytes"] += count * n_bytes
        total["flops"] += count * n_flops
        total["max_abs_err"] = max(total["max_abs_err"], err)
        total["max_ulps"] = max(total["max_ulps"], ulps)
    total["bound_ms"], total["bound_by"] = bound_ms(total["bytes"],
                                                    total["flops"])
    return total, rows


# ---- phase 2/3: stack_step ----

def stack_setup(dev, seed):
    from case_rg_tpu_torch.kernels import decoder_stack as ds
    from case_rg_tpu_torch.models import init_weights, perturb_affine
    from case_rg_tpu_torch.ops.transformer import Decoder
    dec = Decoder(DEC_LAYERS, E, H, d_ff=E, device=dev)
    init_weights(dec, torch.Generator(device=dev).manual_seed(seed))
    # nonzero biases and gains, so that every folded operand (u, bout, ...)
    # carries signal into the comparison
    perturb_affine(dec, torch.Generator(device=dev).manual_seed(seed + 2))
    fold = ds.fold_stack_weights(dec, DEC_LAYERS, H, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    lm = P * LP
    m = torch.randn(B, lm, E, generator=gen, device=dev).to(torch.bfloat16)
    x = torch.randn(B, E, generator=gen, device=dev).to(torch.bfloat16)
    lengths = torch.randint(lm // 2, lm + 1, (B,), generator=gen, device=dev)
    mem_keep = torch.arange(lm, device=dev)[None, :] < lengths[:, None]
    return fold, m, x, mem_keep, gen


def check_and_time_stack(dev):
    from case_rg_tpu_torch.kernels import decoder_stack as ds
    fold, m, x, mem_keep, gen = stack_setup(dev, seed=3)
    zeros = lambda: torch.zeros(B, DEC_LAYERS, T_ANS, 2 * E,
                                dtype=torch.bfloat16, device=dev)
    # scalar t, six self-fed steps: outputs each step, caches at the end
    ck, cp = zeros(), zeros()
    hist = torch.zeros(B, T_ANS, dtype=torch.bool, device=dev)
    xk = xp = x
    readings = {}

    def hold(what, out, ref):
        ulps, err = bf16_ulps(out, ref)
        check(ulps <= STACK_ULPS, f"stack_step {what}: kernel vs plain {ulps} "
              f"bf16 ulps > {STACK_ULPS}")
        readings[what] = (ulps, err)

    for t in range(6):
        hist[:, t] = True
        xk, ck = ds.stack_step(xk, t, ck, m, mem_keep, hist, fold, H)
        xp, cp = ds.stack_step_plain(xp, t, cp, m, mem_keep, hist, fold, H)
        torch.cuda.synchronize()
        hold(f"output t={t}", xk, xp)
    hold("caches", ck, cp)
    # per-row t: rows pointed at T skip their write
    t_rows = torch.randint(0, T_ANS, (B,), generator=gen, device=dev)
    t_rows[::4] = T_ANS
    hist = torch.rand(B, T_ANS, generator=gen, device=dev) > 0.3
    c0 = torch.randn(B, DEC_LAYERS, T_ANS, 2 * E, generator=gen,
                     device=dev).to(torch.bfloat16)
    ck, cp = c0.clone(), c0.clone()
    yk, ck = ds.stack_step(x, t_rows, ck, m, mem_keep, hist, fold, H)
    yp, cp = ds.stack_step_plain(x, t_rows, cp, m, mem_keep, hist, fold, H)
    torch.cuda.synchronize()
    hold("per-row t output", yk, yp)
    hold("per-row t caches", ck, cp)
    check(bool((ck[::4] == c0[::4]).all()),
          "stack_step: a row with t=T wrote its cache")

    # one predict's worth: 40 steps, t = 0..39, history growing
    hists = [torch.arange(T_ANS, device=dev)[None, :].expand(B, T_ANS) <= t
             for t in range(T_ANS)]
    cache = zeros()

    def run(step_fn):
        def go():
            for t in range(T_ANS):
                step_fn(x, t, cache, m, mem_keep, hists[t], fold, H)
        return go

    ms = time_ms(run(ds.stack_step), iters=5)
    plain = time_ms(run(ds.stack_step_plain), iters=2, warmup=1)
    weights = nbytes(*fold.values())
    n_valid = int(mem_keep.sum().item())
    n_bytes = n_flops = 0
    f = fold["w1"].shape[2]
    per_row_mm = 2 * (E * 3 * E + E * E + E * H * E + H * E * E + E * f
                      + f * E)
    for t in range(T_ANS):
        n_bytes += (nbytes(x, m, mem_keep, hists[t], x) + weights
                    + B * DEC_LAYERS * t * 2 * E * 2       # history read
                    + B * DEC_LAYERS * 2 * E * 2)          # slot t written
        n_flops += DEC_LAYERS * (B * per_row_mm
                                 + B * 4 * E * (t + 1)       # self-attn
                                 + 4 * H * E * n_valid)      # cross-attn
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    return {"ms": ms, "plain_ms": plain, "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": max(err for _, err in readings.values()),
            "max_ulps": max(ulps for ulps, _ in readings.values()),
            "ulps_by_check": {k: u for k, (u, _) in readings.items()}}


# ---- phase 4: CaSE serving ----

def make_batch(rng):
    q = rng.randint(4, V, size=(B, 1, LQ)).astype(np.int32)
    p = rng.randint(4, V, size=(B, P, LP)).astype(np.int32)
    for i, n in enumerate(rng.randint(LQ // 3, LQ + 1, size=B)):
        q[i, :, n:] = 0
    for i, n in enumerate(rng.randint(LP // 2, LP + 1, size=(B, P)).ravel()):
        p[i // P, i % P, n:] = 0
    return {"query": q, "passage": p}


def mha_exact_sums(q, k, v, keep, num_heads):
    """fused_mha's function with its rounding points (q * scale, the
    probabilities and the output, each to bf16) and every sum in f64: a
    rounding of the same function that is no worse than the plain
    version's, used as a witness of how far rounding alone moves the
    answers."""
    from case_rg_tpu_torch.kernels import encoder_attention as ea
    r, lq, e = q.shape
    d = e // num_heads
    split = lambda x: x.reshape(r, -1, num_heads, d).transpose(1, 2).double()
    s = split(q * ea._scale(d, q.dtype).to(q.device)) \
        @ split(k).transpose(-1, -2)
    s = torch.where(keep[:, None, None, :], s,
                    torch.full((), -1e20, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, -1) * keep.any(-1).double()[:, None, None, None]
    ctx = p.to(q.dtype).double() @ split(v)
    return ctx.to(q.dtype).transpose(1, 2).reshape(r, lq, e)


def serve(predict, batches):
    """Each batch through ``predict``: outputs on the host, host ms each."""
    outs, times = [], []
    for bt in batches:
        t0 = time.perf_counter()
        out = predict(bt)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append({k: v.cpu() for k, v in out.items()})
    return outs, times


def agreement(outs, refs):
    """Rank scores' max bf16 ulps and max |diff|, and the shares of answer
    tokens and of first tokens that agree."""
    ulps = diff = 0.0
    same = first = 0
    for o, r in zip(outs, refs):
        u, d = bf16_ulps(o["rank"], r["rank"])
        ulps, diff = max(ulps, u), max(diff, d)
        same += int((o["answer"] == r["answer"]).sum())
        first += int((o["answer"][:, 0] == r["answer"][:, 0]).sum())
    return {"rank_max_ulps": ulps, "rank_max_abs_diff": diff,
            "token_agreement": same / (len(outs) * B * T_ANS),
            "first_token_agreement": first / (len(outs) * B)}


def profile_serving(predict, batches):
    """Device time of ``batches`` under torch.profiler: wall ms per batch,
    device busy ms and idle share, and the kernels that take the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_us(evt):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(evt, name):
                return float(getattr(evt, name))
        return 0.0

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for bt in batches:
            predict(bt)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    # device-side events only: a CPU op's entry repeats its kernels' time
    kernels = sorted(((device_us(e) / 1e3 / len(batches), e.count // len(batches),
                       e.key[:100]) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and device_us(e) > 0),
                     reverse=True)
    busy_ms = sum(k[0] for k in kernels)
    check(busy_ms > 0, "profile: no device time recorded")
    return {"wall_ms_per_batch": wall_ms, "device_busy_ms_per_batch": busy_ms,
            "device_idle_share": 1 - busy_ms / wall_ms,
            "top_kernels": [{"name": n, "ms_per_batch": ms,
                             "launches_per_batch": c}
                            for ms, c, n in kernels[:12]]}


def serve_case(dev):
    from case_rg_tpu_torch.config import ModelConfig
    from case_rg_tpu_torch.kernels import decoder_stack as ds
    from case_rg_tpu_torch.kernels import encoder_attention as ea
    from case_rg_tpu_torch.models import create_model, multimem, perturb_affine
    from case_rg_tpu_torch.ops import attention
    from case_rg_tpu_torch.runtime.inference import make_predict_fn

    cfg = ModelConfig(name="case", vocab_size=V, embedding_size=E,
                      hidden_size=E, num_heads=H, enc_layers=ENC_LAYERS,
                      dec_layers=DEC_LAYERS, max_dec_len=T_ANS,
                      max_target_length=T_ANS, param_dtype="bfloat16")
    model = create_model("case", cfg, device=dev, seed=0)
    perturb_affine(model, torch.Generator(device=dev).manual_seed(1))
    n_params = sum(p.numel() for p in model.parameters())
    predict = make_predict_fn(model, cfg, T_ANS, device=dev)
    rank_only = make_predict_fn(model, cfg, T_ANS, rank_only=True, device=dev)
    rng = np.random.RandomState(0)
    batches = [make_batch(rng) for _ in range(3)]
    predict(make_batch(rng))                    # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()

    ea.LAUNCHES = ds.LAUNCHES = 0
    outs, times = serve(predict, batches)
    launches = {"fused_mha": ea.LAUNCHES, "stack_step": ds.LAUNCHES}
    n = len(batches)
    check(launches["fused_mha"] == 19 * n,
          f"fused_mha launched {launches['fused_mha']} times, expected {19 * n}")
    check(launches["stack_step"] == T_ANS * n,
          f"stack_step launched {launches['stack_step']} times, expected "
          f"{T_ANS * n}")
    for out in outs:
        a, r = out["answer"], out["rank"]
        check(tuple(a.shape) == (B, T_ANS) and a.dtype == torch.int32,
              f"answer {tuple(a.shape)} {a.dtype}")
        check(bool(((a >= 0) & (a < V)).all()), "answer ids out of the vocab")
        check(tuple(r.shape) == (B, P) and bool(torch.isfinite(r).all()),
              f"rank {tuple(r.shape)} not finite")

    ea.LAUNCHES = 0
    t0 = time.perf_counter()
    ro = rank_only(batches[0])["rank"]
    torch.cuda.synchronize()
    rank_only_ms = (time.perf_counter() - t0) * 1e3
    ro = ro.cpu()
    check(ea.LAUNCHES == RANK_ONLY_MHA and tuple(ro.shape) == (B, P)
          and bool(torch.isfinite(ro).all()),
          f"rank_only: {ea.LAUNCHES} fused_mha launches, shape "
          f"{tuple(ro.shape)}")
    ulps, _ = bf16_ulps(ro, outs[0]["rank"])
    check(ulps <= 1, f"rank_only vs predict rank: {ulps} bf16 ulps > 1")

    def serve_swapped(mha, stack):
        """The batches with the two wrappers replaced by ``mha``/``stack``."""
        try:
            attention.fused_mha, multimem.stack_step = mha, stack
            return serve(predict, batches)
        finally:
            attention.fused_mha, multimem.stack_step = ea.fused_mha, \
                ds.stack_step

    # the same batches with each wrapper swapped for its plain version: the
    # same function, rounded at the same points, so only the order of the
    # sums differs
    ea.LAUNCHES = ds.LAUNCHES = 0
    plain_outs, plain_times = serve_swapped(ea.fused_mha_plain,
                                            ds.stack_step_plain)
    check(ea.LAUNCHES == 0 and ds.LAUNCHES == 0,
          "kernels launched with their plain versions swapped in")
    vs_plain = agreement(outs, plain_outs)
    # the stack kernel alone, and the rounding witness
    stack_only = agreement(
        serve_swapped(ea.fused_mha_plain, ds.stack_step)[0], plain_outs)
    exact_vs_plain = agreement(
        serve_swapped(mha_exact_sums, ds.stack_step_plain)[0], plain_outs)
    check(vs_plain["rank_max_ulps"] <= RANK_ULPS,
          f"rank, kernels vs plain versions: {vs_plain['rank_max_ulps']} bf16 "
          f"ulps > {RANK_ULPS}")
    for what, got in (("kernels", vs_plain), ("stack kernel alone", stack_only)):
        check(got["token_agreement"] >= MIN_TOKEN_AGREEMENT
              and got["first_token_agreement"] >= MIN_FIRST_TOKEN_AGREEMENT,
              f"answers, {what} vs plain versions: {got}")
    for key in ("token_agreement", "first_token_agreement"):
        check(vs_plain[key] >= exact_vs_plain[key] - AGREEMENT_SLACK,
              f"{key}: kernels vs plain versions {vs_plain[key]}, exact sums "
              f"vs plain versions {exact_vs_plain[key]}")

    # the same batches with the kernels routed off: dense attention and the
    # per-layer decode chain (another rounding of the same function)
    try:
        attention.set_fused_attention(False)
        multimem.set_fused_stack(False)
        ea.LAUNCHES = ds.LAUNCHES = 0
        off_outs, off_times = serve(predict, batches)
        check(ea.LAUNCHES == 0 and ds.LAUNCHES == 0,
              "kernels launched with the routing off")
    finally:
        attention.set_fused_attention(None)
        multimem.set_fused_stack(None)
    vs_off = agreement(outs, off_outs)
    check(vs_off["rank_max_ulps"] <= RANK_ULPS,
          f"rank, kernels vs routed off: {vs_off['rank_max_ulps']} bf16 ulps "
          f"> {RANK_ULPS}")

    profiled = profile_serving(predict, batches[:PROFILE_BATCHES])
    return {
        "params": n_params, "launches": launches,
        "ms_per_batch": times, "plain_ms_per_batch": plain_times,
        "routed_off_ms_per_batch": off_times, "rank_only_ms": rank_only_ms,
        "vs_plain": vs_plain, "stack_kernel_alone_vs_plain": stack_only,
        "exact_sums_vs_plain": exact_vs_plain, "vs_routed_off": vs_off,
        "profile": profiled,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from case_rg_tpu_torch.kernels import _build

    # the plain versions' products accumulate in full f32, as the kernels do
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    card = smi()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas info" in line and ("Compiling" in line or "Used" in line):
                print(f"  {name}: {line.split(':', 1)[1].strip()}")

    gen = torch.Generator(device=dev).manual_seed(0)
    mha, mha_rows = check_and_time_mha(dev, gen)
    print("fused_mha sites: " + json.dumps(mha_rows), flush=True)
    stack = check_and_time_stack(dev)
    print("stack_step: " + json.dumps(stack), flush=True)
    serve = serve_case(dev)
    print("case serving: " + json.dumps(serve), flush=True)

    kernels = [
        {"name": "fused_mha", "route": "cuda",
         "source": "case_rg_tpu_torch/csrc/encoder_attention.cu",
         "replaces": "case_rg_tpu/kernels/encoder_attention.py:146",
         "launches": serve["launches"]["fused_mha"],
         "max_abs_err": mha["max_abs_err"], "ms": mha["ms"],
         "plain_ms": mha["plain_ms"], "bound_ms": mha["bound_ms"],
         "bound_by": mha["bound_by"], "library_ms": mha["library_ms"]},
        {"name": "stack_step", "route": "cuda",
         "source": "case_rg_tpu_torch/csrc/decoder_stack.cu",
         "replaces": "case_rg_tpu/kernels/decoder_stack.py:428",
         "launches": serve["launches"]["stack_step"],
         "max_abs_err": stack["max_abs_err"], "ms": stack["ms"],
         "plain_ms": stack["plain_ms"], "bound_ms": stack["bound_ms"],
         "bound_by": stack["bound_by"], "library_ms": stack["library_ms"]},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
