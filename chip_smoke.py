#!/usr/bin/env python3
"""Chip smoke run of case_rg_tpu_torch, the PyTorch/CUDA port, on one NVIDIA
card.

    python3 chip_smoke.py        # from the repository root; needs one card

In order it
  1. prints the card's name and power limit, builds the CUDA kernels from
     case_rg_tpu_torch/csrc (nvcc, sm_90a, one process per source, all at
     once) and prints the build time and each kernel's registers and shared
     memory (ptxas -v), then each serving kernel instance's registers and
     spills (fused_mha, stack_step, single_query_mha, combine_copy_mass,
     additive_scores: "serving kernel instances"; a spill fails the run);
  2. holds each kernel against its plain PyTorch version on the card, in
     bf16, at the shapes CaSE serving gives it (tolerances below):
     fused_mha (the four sites, two launches equal bit for bit),
     stack_step (at B=64, a cluster of two blocks a row, and at the beam's
     256 rows, one block a row; self-fed steps, per-row t, a repeat equal
     bit for bit), single_query_mha (the query memory, the packed
     self-attention history and beam rows in the warp layout, a 1000-key
     check in the block layout, each plan's layout asserted, the other
     layout held too where it takes the shape, two launches equal bit for
     bit) and
     additive_scores (a decode step over each memory at B=64 and at the
     beam's 256 rows, teacher forcing over each memory; the forward in its
     one layout; the backward at teacher forcing in its planned layout,
     asserted, and in the other where it takes the shape, two runs equal
     bit for bit);
  3. times each kernel, its plain version and, where one PyTorch call
     computes the same function, that call (CUDA events, after warm-up),
     beside the least time the card could take (bytes over 3.35 TB/s, or
     operations over their peak; additive_scores' tanh over the
     special-function unit's rate at the card's maximum clock); fused_mha
     and SDPA by device time behind a spin kernel (device_ms), per site;
     stack_step by device time per predict (B=64) and per beam batch (B x
     4 rows), in the plan's layout and with the other forced, and 40 steps
     at other batches in both, with the plans and the card's max active
     clusters; single_query_mha by device time at each shape in both
     layouts, with clock64 marks of the warp layout's phases (an extra
     build of decode_attention.cu whose `// phase` lines become marks) and
     the floor under any launch (a one-thread kernel); additive_scores by
     device time (the backward in each layout), per B=64 predict, per beam
     batch and per train step (forward and backward), with clock64 marks of
     its forward and its backward;
  4. builds CaSE at the serving widths (V=30522, E=256, H=8, 3 encoder and
     2x4 decoder layers, bf16 weights drawn from a seed, with noisy biases
     and LayerNorm gains) and serves B=64 batches (query 60, pool 10x100,
     40-step greedy decode) and one rank-only batch through
     make_predict_fn, with the launch counters set to 0 just before and
     read just after. It serves the same batches twice more: with each
     kernel's wrapper swapped for its plain version (the same function with
     the same rounding points; answers gated at a stated agreement), and
     with the kernels routed off (dense attention, per-layer decode chain,
     dense single-query attention and copy scores; rank gated, answers
     reported). Last, it profiles two batches with torch.profiler: device
     busy and idle share, and the kernels that take the most device time;
     then runs every greedy _step_core step of a predict and one
     decode_chunk (pallas and dense modes) under no_host_sync (an operation
     that makes the host wait on the card raises; "sync check");
  5. holds combine_copy_mass, the copy-argmax combine, against its plain
     version at the decode's shape (B=64, source 60 + 10x100 = 1060, bf16
     copy mass, ids drawn Zipf-like so they repeat as text does, padding as
     served), an odd shape and one of 3000 positions, in its planned body
     (asserted) and in the other; two launches equal bit for bit and every
     group's members equal bit for bit; and times both bodies per launch
     (device time) beside its plain version and the dense scatter_add_ +
     gather pair, the sort body's phases (clock64 marks, as for
     single_query_mha), and both bodies over a range of row lengths at
     B=64;
  6. serves two B=64 batches in each argmax mode (dense, mxu, pallas), and
     in pallas mode with the combine's wrapper swapped for its plain
     version (answers gated at stated agreements);
  7. serves 512 requests (answer caps drawn over 8..40) through continuous
     batching at full width (batch 64, refill 16, chunks of 8 steps, pallas
     mode), every launch counter set to 0 just before the base run and read
     just after; then with lookahead, with the async harvest and with
     refills coalesced to 8 rows (answers equal to the base run's, token for
     token), through the multi-lane driver over pools of 5 and 10 passages,
     and through the one-shot predict (answers gated at stated agreements);
     dense mode once more for its time, and a profile;
  8. serves two B=64 batches with beam search (width 4), with sampling at
     top_k=1 and with sampling at temperature 0.9, top_k 50, top_p 0.95,
     and through the decoder's beam at width 1 (equal to greedy cut at its
     first EOS; sampling at top_k=1 gated against greedy; sampling repeated
     with the same keys equal bit for bit), each with the new kernels'
     launches counted;
  9. serves the 512 requests through continuous batching with sampling
     (a key per request): launches counted around the base run, a repeat
     equal bit for bit, the one-shot sampled predict with the same keys
     gated at the stated agreements;
 10. serves the 512 requests through the device loop (batch 64, 4 steps a
     chunk, 8 chunks a mega, a ring of 256 encoded requests, refill 16,
     lookahead; pallas mode), each mega a replay of a CUDA graph captured
     in a warm-up run: launches reckoned as each capture's recorded
     launches times its replays plus the counters' rise, held to the
     chunks run; answers equal to the chunk loop's base run token for
     token (also without lookahead and with the round's host side under
     no_host_sync), sampled answers equal to the sampled chunk loop's, the
     multi-lane device loop's full-bucket answers equal too; requests/s of
     both loops in turns with a profile of each, one mega's device time
     beside the host time of an encode issued behind a spin kernel,
     capture seconds and pool bytes, and requests/s at (4, 8), (8, 4) and
     (4, 16) steps and chunks ("device-loop serving");
 11. serves CaSE from text through cli/serve's ``main``, in process
     ("text serving"): a vocab.txt of exactly V=30522 wordpieces (specials,
     punctuation, "##" pieces, synthetic words, from seed 0), a checkpoint
     in the port's format (``train/checkpoint.save_checkpoint``) of f32 CaSE
     from seed 0 with noisy biases and gains, and 256 text requests from
     seed 3 (a history of 0-2 turns; 5 passages for a third of them, 10 for
     the rest, sentences joined by ". "; ``max_tokens`` over 8-40). Four
     modes, each run twice (the second under torch.profiler, its answers
     equal to the first's), all with --bf16, B=64 and --warmup: (a)
     batched greedy, equal to ``make_predict_fn`` on ``chunk_to_batch`` of
     the same requests; (b) --continuous --fast_argmax pallas
     --pool_buckets 5,10, equal to ``run_continuous_multi`` driven directly
     on the same batches; (c) the same through --device_loop 8
     --chunk_steps 4 --lookahead, equal to (b); (d) (c) behind --listen,
     eight client threads POSTing the requests four to a POST, every
     response equal to (c)'s, /healthz and /varz answering. Token for token
     as detokenized, ranking for ranking. Per mode it prints requests/s
     over the serving window (after the load and warm-up), the host ms per
     request in ``featurize_requests`` split into the tokenizer's batch
     call and ``data.featurize``, ``chunk_to_batch`` ms at 16 and 64 rows,
     whether the native tokenizer loaded, the window's launches (each
     kernel's counter set to 0 at its start; graph replays x recorded
     launches added) and the device's idle share;
 12. trains CaSE at the same widths (dropout 0.1, B=64 batches with a
     response, passage and token labels; f32 masters, bf16 compute) through
     the train step of case_rg_tpu_torch.train.trainer. First it holds the
     four training-attention kernels (forward and backward of
     fused_train_mha and fused_train_mha_rng) against their plain versions
     at the six shapes one train step gives them, times them (device time,
     device_ms) beside scaled_dot_product_attention with dropout, recovers
     the in-kernel dropout mask with a probe on the short path (d = 32 and
     d = 160) and on the long path, and checks that ptxas reports no spill
     in any training-attention instance (each instance's registers and each
     site's launch plan, train_mha_plan, are printed after the build).
     Then, for each variant, it compares the
     first step's loss and gradient with the kernels (training attention
     and additive_scores) swapped for their plain versions (same dropout
     bits), runs 10 steps on one repeated batch with the kernels (launch
     counters set to 0 just before, read just after; the loss must fall),
     the same 10 steps with the plain versions, profiles two steps with
     torch.profiler, and runs one step under no_host_sync;
 13. prints one JSON line {"kernels": [...]} and, last, the device line
     {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no result.
It also fails when torch sees no card, and when it stands alone without the
case_rg_tpu_torch package beside it.
"""

from __future__ import annotations

import contextlib
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
PEAK_F32_FLOPS = 67e12          # f32 outside the tensor cores

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

# training: dropout rate, and the sites of the training-attention kernels
# in one CaSE train step at B=64: (rows, Lq, Lk, E) -> count
RATE = 0.1
TRAIN_SITES = {(B, LQ, LQ, E): 6,              # encoder query x3, ps q 1-2, sti q 1
               (B * P, LP, LP, E): 9,          # encoder pool x3, ps p 1-4, sti p 1-2
               (B, LQ, LQ, 5 * E): 2,          # ps/sti q block 0 (d=160)
               (B * P, LP, LP, 5 * E): 2,      # ps/sti p block 0
               (B, T_ANS, LQ, E): 4,           # decoder stack 0 cross-attention
               (B, T_ANS, P * LP, E): 4}       # decoder stack 1 cross-attention
TRAIN_SITES_PER_STEP = 27
# Training-attention kernels against their plain versions, in bf16 ulps
# per element as above (the same function with the same rounding points,
# sums in another order). The worst readings on an H100 were 3 ulps forward
# and 4 on the gradients, over the six sites and both variants; each limit
# keeps a margin over them.
TRAIN_FWD_ULPS = 4
TRAIN_GRAD_ULPS = 8
# the keep share of the recovered in-kernel mask at the (640, 100, 100)
# site, against 1 - RATE
KEEP_SHARE_TOL = 0.005
# Train steps: kernels vs their plain versions on the first step, from the
# same weights with the same dropout bits, so only rounding differs. Read on
# an H100: loss 1.5e-5 relative apart, gradient cosine 0.9999962 (both
# variants); the limits keep a margin of about 60x and 25x on 1 - cosine.
FIRST_LOSS_RTOL = 1e-3
FIRST_GRAD_COSINE = 0.9999
TRAIN_STEPS, TRAIN_WARMUP = 10, 2

# single_query_mha shapes: (rows, L, packed): the passage memory (a check
# at 1000 keys), the query memory, the packed self-attention history
# [B, T, 2E] and the query memory at beam rows (B x 4)
BEAM_WIDTH = 4
SQ_SHAPES = ((B, P * LP, False), (B, LQ, False), (B, T_ANS, True),
             (B * BEAM_WIDTH, LQ, False))
# the layout single_query_mha_plan must pick at each L of SQ_SHAPES: a warp a
# (row, head) at the decode's lengths, a block a (row, head) at 1000 keys
SQ_LAYOUTS = {P * LP: "block", LQ: "warp", T_ANS: "warp"}
# additive_scores (rows, T, L): a decode step over each memory at the
# served batch and at the beam's rows (B x 4), teacher forcing over each
# memory; the backward layouts each teacher-forcing shape is held and
# timed in (every one that takes it), and the one the plan must pick
ADD_DECODE = ((B, 1, P * LP), (B, 1, LQ), (B * BEAM_WIDTH, 1, P * LP),
              (B * BEAM_WIDTH, 1, LQ))
ADD_TRAIN = ((B, T_ANS, P * LP), (B, T_ANS, LQ))
ADD_BWD_LAYOUTS = ("cluster", "partials")
ADD_BWD_PLANNED = {P * LP: "partials", LQ: "cluster"}
# Kernels against their plain versions, in bf16 ulps per element as above
# (the same function with the same rounding points, sums in another order;
# additive_scores' tanh is the special-function unit's, which may land one
# bf16 ulp from the plain version's tanhf on some of the 256 terms). The
# worst readings on an H100 were 1 ulp for each; each limit keeps a margin.
SQ_ULPS = 2
ADD_FWD_ULPS = 2
ADD_BWD_ULPS = 4
# sampled decoding's controls (phases 9-10)
SAMPLE_CONTROLS = dict(temperature=0.9, top_k=50, top_p=0.95)


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


def bound_ms(n_bytes: float, n_flops: float, peak_flops=PEAK_BF16_FLOPS):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_sm_mhz() -> float:
    """The card's maximum SM clock (nvidia-smi)."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])


def sfu_per_s() -> float:
    """tanh results a second: 16 per clock on each of 132 SMs at the card's
    maximum SM clock, the best per-element tanh rate tools/
    probe_tanh_rates.py reads on an H100 (tanh.approx.f32 gives 16 a clock
    an SM, tanh.approx.bf16x2 8 instructions of two)."""
    return 16 * 132 * max_sm_mhz() * 1e6


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class other_plan:
    """Within ``with``, ``module.<name>`` (a wrapper's launch plan) is
    ``plan``: the wrapper launches the layout or body it gives. ``fits``
    says whether ``plan`` takes a shape at all."""

    def __init__(self, module, name, plan):
        self.module, self.name, self.plan = module, name, plan

    def fits(self, *shape) -> bool:
        try:
            self.plan(*shape)
            return True
        except ValueError:
            return False

    def __enter__(self):
        self.saved = getattr(self.module, self.name)
        setattr(self.module, self.name, self.plan)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)


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
        again = ea.fused_mha(q, k, v, keep, H)
        torch.cuda.synchronize()
        check(torch.equal(out, again), f"fused_mha R={r} L={l} E={e}: two "
              "launches differ")
        ms = device_ms(lambda: ea.fused_mha(q, k, v, keep, H))
        plain = time_ms(lambda: ea.fused_mha_plain(q, k, v, keep, H))
        lib = device_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=lib_mask))
        n_bytes = nbytes(q, k, v, keep, out)
        n_flops = 4 * l * d * H * int(keep.sum().item())   # QK^T and PV, valid keys
        rows.append({"rows": r, "L": l, "E": e, "d": d, "sites": count,
                     "plan": ea.fused_mha_plan(l, l, d),
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


# stack_step at the served batches: B=64 rows (a predict, and continuous
# serving's 64 slots), where the plan runs a row on a cluster of two
# blocks, and B x BEAM_WIDTH rows under beam search, where it runs a row on
# one block; each is held against the plain version in the plan's layout
STACK_SHAPES = (("predict", B, 2), ("beam batch", B * BEAM_WIDTH, 1))
STACK_BATCHES = (8, 32, 100, 128)       # timed in both layouts as well


def start_stack_phase_build(_build):
    """Start nvcc on a copy of csrc/decoder_stack.cu whose every `// phase
    <name>` line (the ends of the layer loop's phases) becomes a clock64
    mark by thread 0 of block 0 into a device array, which the added
    read_stack_phases copies out. Returns (the nvcc process, the library's
    path, the phase names); the caller waits for the process."""
    import re
    phase = re.compile(r"\s*// phase (.+)")
    src = os.path.join(_build.CSRC, "decoder_stack.cu")
    lines = open(src).read().splitlines()
    names = [m.group(1) for m in map(phase.fullmatch, lines) if m]
    n = len(names)
    out, k = [], 0
    for ln in lines:
        if phase.fullmatch(ln):
            out.append(f"if (threadIdx.x == 0 && blockIdx.x == 0) "
                       f"g_phase[layer * {n} + {k}] = clock64();")
            k += 1
        else:
            out.append(ln)
            if ln == "namespace cg = cooperative_groups;":
                out.append(f"__device__ long long g_phase[16 * {n}];")
    out += ['extern "C" int read_stack_phases(long long* dst, int count) {',
            "  return static_cast<int>(cudaMemcpyFromSymbol(",
            "      dst, g_phase, sizeof(long long) * count));", "}"]
    d = os.path.join(_build.BUILD_ROOT, "stack_phases")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "decoder_stack_phases.cu"), "w") as f:
        f.write("\n".join(out) + "\n")
    lib = os.path.join(d, "libstack_phases.so")
    proc = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
         lib, os.path.join(d, "decoder_stack_phases.cu")],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    return proc, lib, names


def start_phase_build(_build, name):
    """Start nvcc on a copy of csrc/<name>.cu whose every `// phase <mark>`
    line becomes a clock64 mark by thread 0 of block (0, 0, 0) (clock64 is
    an SM's own counter) into a device array,
    which the added read_phases copies out. Returns (the nvcc process, the
    library's path, the mark names in the source's order); the caller waits
    for the process."""
    import re
    phase = re.compile(r"\s*// phase (.+)")
    src = os.path.join(_build.CSRC, f"{name}.cu")
    out, names = [], []
    for ln in open(src).read().splitlines():
        m = phase.fullmatch(ln)
        if m:
            out.append(f"if (threadIdx.x == 0 && blockIdx.x == 0 && "
                       f"blockIdx.y == 0 && blockIdx.z == 0) "
                       f"g_phase[{len(names)}] = clock64();")
            names.append(m.group(1))
        else:
            out.append(ln)
            if ln == "namespace {" and out.count(ln) == 1:
                out.append("__device__ long long g_phase[32];")
    out += ['extern "C" int read_phases(long long* dst, int count) {',
            "  return static_cast<int>(cudaMemcpyFromSymbol(",
            "      dst, g_phase, sizeof(long long) * count));", "}"]
    d = os.path.join(_build.BUILD_ROOT, f"{name}_phases")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"{name}_phases.cu"), "w") as f:
        f.write("\n".join(out) + "\n")
    lib = os.path.join(d, f"lib{name}_phases.so")
    proc = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
         lib, os.path.join(d, f"{name}_phases.cu")],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    return proc, lib, names


def kernel_phases(build, module, functions, run, prefix=""):
    """One launch's clock64 marks through the instrumented build of
    start_phase_build: ``run()`` calls the wrapper of ``module``, whose
    ``_lib`` is swapped for the build (``functions``: its C functions).
    The marks whose names start with ``prefix`` (one kernel's, where a
    source has several), in the order they were taken, as µs between each
    and the one before at the card's maximum SM clock, and the launch's µs
    from the first mark to the last (thread 0 of block 0)."""
    import ctypes
    from case_rg_tpu_torch.kernels import _build
    proc, path, names = build
    check(proc.returncode == 0, f"{module.__name__} phases: nvcc failed")
    lib = ctypes.CDLL(path)
    kernel_lib = module._lib()
    for fn in functions:
        getattr(lib, fn).argtypes = getattr(kernel_lib, fn).argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.read_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    plain_lib = module._lib
    module._lib = lambda: lib
    try:
        for _ in range(3):
            run()
        torch.cuda.synchronize()
    finally:
        module._lib = plain_lib
    marks = (ctypes.c_longlong * len(names))()
    _build.check(lib.read_phases(marks, len(names)), "read_phases")
    order = sorted((m, nm) for m, nm in zip(list(marks), names)
                   if nm.startswith(prefix))
    mhz = max_sm_mhz()
    return {"us": {nm: (c - p) / mhz for (p, _), (c, nm) in
                   zip(order[:-1], order[1:])},
            "total_us": (order[-1][0] - order[0][0]) / mhz}


def stack_phases(dev, build, shapes):
    """Clock64 marks of one step (t = 20) at each (name, rows) of
    ``shapes``, in the plan's layout, through the instrumented build of
    start_stack_phase_build: per phase the cycles of block 0 averaged over
    the layers and their microseconds at the card's maximum SM clock, and
    the step's cycles."""
    import ctypes
    from case_rg_tpu_torch.kernels import _build
    from case_rg_tpu_torch.kernels import decoder_stack as ds
    proc, path, names = build
    check(proc.returncode == 0, "stack_step phases: nvcc failed")
    lib = ctypes.CDLL(path)
    kernel_lib = ds._lib()
    for fn in ("stack_step_smem_bytes", "stack_step_supports",
               "stack_step_bf16"):
        getattr(lib, fn).argtypes = getattr(kernel_lib, fn).argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.read_stack_phases.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fold, m, x, mem_keep, _ = stack_setup(dev, seed=3)
    mhz = max_sm_mhz()
    n = len(names)
    rows_of = lambda a, b: a.repeat_interleave(-(-b // B), 0)[:b]
    out = {}
    plain_lib = ds._lib
    ds._lib = lambda: lib
    try:
        for what, b in shapes:
            xb, mb, kb = rows_of(x, b), rows_of(m, b), rows_of(mem_keep, b)
            hist = torch.arange(T_ANS, device=dev)[None, :].expand(b, T_ANS) <= 20
            cache = torch.zeros(b, DEC_LAYERS, T_ANS, 2 * E,
                                dtype=torch.bfloat16, device=dev)
            for _ in range(2):
                ds.stack_step(xb, 20, cache, mb, kb, hist, fold, H)
            torch.cuda.synchronize()
            marks = (ctypes.c_longlong * (DEC_LAYERS * n))()
            _build.check(lib.read_stack_phases(marks, DEC_LAYERS * n),
                         "read_stack_phases")
            v = torch.tensor(list(marks), dtype=torch.float64).view(DEC_LAYERS, n)
            cyc = (v[:, 1:] - v[:, :-1]).mean(0)
            out[what] = {"rows": b, "mhz": mhz,
                         "step_cycles": float(v[-1, -1] - v[0, 0]),
                         "us_per_layer": {nm: c / mhz for nm, c in
                                          zip(names[1:], cyc.tolist())}}
    finally:
        ds._lib = plain_lib
    return out


def check_and_time_stack(dev):
    """stack_step against its plain version (six self-fed steps from a zero
    cache, per-row t with done rows, two launches equal bit for bit) at
    STACK_SHAPES, each in the plan's layout (asserted). Device times of one
    predict (40 steps) at B=64 and of one beam batch, in the plan's layout
    and, for comparison, with the other layout forced, and of 40 steps at
    STACK_BATCHES in both; the plans and the card's max active
    clusters."""
    from case_rg_tpu_torch.kernels import decoder_stack as ds
    fold, m, x, mem_keep, gen = stack_setup(dev, seed=3)
    lm = P * LP
    f = fold["w1"].shape[2]
    mac = ds.max_active_clusters(lm, T_ANS, H, f)
    zeros = lambda b: torch.zeros(b, DEC_LAYERS, T_ANS, 2 * E,
                                  dtype=torch.bfloat16, device=dev)
    rows_of = lambda a, b: a.repeat_interleave(-(-b // B), 0)[:b]
    readings = {}

    def hold(what, out, ref):
        ulps, err = bf16_ulps(out, ref)
        check(ulps <= STACK_ULPS, f"stack_step {what}: kernel vs plain {ulps} "
              f"bf16 ulps > {STACK_ULPS}")
        readings[what] = (ulps, err)

    for what, b, cluster in STACK_SHAPES:
        plan = ds.stack_step_plan(b, lm, T_ANS, H, f, mac)
        check(plan["cluster"] == cluster,
              f"stack_step {what}: the plan runs a row on {plan['cluster']} "
              f"blocks, not {cluster}")
        tag = f"{what} B={b}"
        mb, xb, kb = rows_of(m, b), rows_of(x, b), rows_of(mem_keep, b)
        # scalar t, six self-fed steps: outputs each step, caches at the end
        ck, cp = zeros(b), zeros(b)
        hist = torch.zeros(b, T_ANS, dtype=torch.bool, device=dev)
        xk = xp = xb
        for t in range(6):
            hist[:, t] = True
            xk, ck = ds.stack_step(xk, t, ck, mb, kb, hist, fold, H)
            xp, cp = ds.stack_step_plain(xp, t, cp, mb, kb, hist, fold, H)
            torch.cuda.synchronize()
            hold(f"{tag} output t={t}", xk, xp)
        hold(f"{tag} caches", ck, cp)
        # per-row t: rows pointed at T skip their write; a repeat is equal
        t_rows = torch.randint(0, T_ANS, (b,), generator=gen, device=dev)
        t_rows[::4] = T_ANS
        hist = torch.rand(b, T_ANS, generator=gen, device=dev) > 0.3
        c0 = torch.randn(b, DEC_LAYERS, T_ANS, 2 * E, generator=gen,
                         device=dev).to(torch.bfloat16)
        ck, ck2, cp = c0.clone(), c0.clone(), c0.clone()
        yk, ck = ds.stack_step(xb, t_rows, ck, mb, kb, hist, fold, H)
        y2, ck2 = ds.stack_step(xb, t_rows, ck2, mb, kb, hist, fold, H)
        yp, cp = ds.stack_step_plain(xb, t_rows, cp, mb, kb, hist, fold, H)
        torch.cuda.synchronize()
        hold(f"{tag} per-row t output", yk, yp)
        hold(f"{tag} per-row t caches", ck, cp)
        check(bool((ck[::4] == c0[::4]).all()),
              f"stack_step {tag}: a row with t=T wrote its cache")
        check(torch.equal(yk, y2) and torch.equal(ck, ck2),
              f"stack_step {tag}: two launches differ")

    def steps(b):
        """One predict's worth at b rows: 40 steps, t = 0..39, the history
        growing."""
        mb, kb, xb = rows_of(m, b), rows_of(mem_keep, b), rows_of(x, b)
        hists = [torch.arange(T_ANS, device=dev)[None, :].expand(b, T_ANS) <= t
                 for t in range(T_ANS)]
        cache = zeros(b)

        def go(step_fn=ds.stack_step):
            for t in range(T_ANS):
                step_fn(xb, t, cache, mb, kb, hists[t], fold, H)
        return go, mb, kb, xb, hists

    weights = nbytes(*fold.values())
    per_row_mm = 2 * (E * 3 * E + E * E + E * H * E + H * E * E + E * f
                      + f * E)

    def bound(b, mb, kb, xb, hists):
        n_valid = int(kb.sum().item())
        n_bytes = n_flops = 0
        for t in range(T_ANS):
            n_bytes += (nbytes(xb, mb, kb, hists[t], xb) + weights
                        + b * DEC_LAYERS * t * 2 * E * 2     # history read
                        + b * DEC_LAYERS * 2 * E * 2)        # slot t written
            n_flops += DEC_LAYERS * (b * per_row_mm + b * 4 * E * (t + 1)
                                     + 4 * H * E * n_valid)
        return bound_ms(n_bytes, n_flops)

    shapes = {}
    launch = ds.stack_step_launch
    for what, b, cluster in STACK_SHAPES:
        go, mb, kb, xb, hists = steps(b)
        row = {"rows": b, "plan": ds.stack_step_plan(b, lm, T_ANS, H, f, mac),
               "max_active_clusters": mac, "ms": device_ms(go, iters=3)}
        # the other layout, forced for this comparison only
        other = 3 - cluster
        ds.stack_step_launch = lambda b_, l_, t_, h_, f_: ds.stack_step_plan(
            b_, l_, t_, h_, f_, b_ if other == 2 else 0)
        try:
            row[f"ms_cluster_{other}"] = device_ms(go, iters=3)
        finally:
            ds.stack_step_launch = launch
        row["bound_ms"], row["bound_by"] = bound(b, mb, kb, xb, hists)
        shapes[what] = row
    # 40 steps by batch in both layouts (timing only): where the step's
    # time stops being flat in B, and where two blocks a row stop winning
    by_batch = {}
    for b in STACK_BATCHES:
        go, *_ = steps(b)
        by_batch[b] = {}
        for cluster in (1, 2):
            ds.stack_step_launch = lambda b_, l_, t_, h_, f_: \
                ds.stack_step_plan(b_, l_, t_, h_, f_, b_ if cluster == 2 else 0)
            try:
                by_batch[b][f"ms_cluster_{cluster}"] = device_ms(go, iters=3)
            finally:
                ds.stack_step_launch = launch
    go, *_ = steps(B)
    plain = time_ms(lambda: go(ds.stack_step_plain), iters=2, warmup=1)
    pr = shapes["predict"]
    return {"ms": pr["ms"], "plain_ms": plain, "library_ms": None,
            "bound_ms": pr["bound_ms"], "bound_by": pr["bound_by"],
            "max_abs_err": max(err for _, err in readings.values()),
            "max_ulps": max(ulps for ulps, _ in readings.values()),
            "ulps_by_check": {k: u for k, (u, _) in readings.items()},
            "shapes": shapes, "by_batch": by_batch}


# ---- phase 2/3: single_query_mha and additive_scores ----

def check_and_time_single_query(dev, gen, phase_build):
    """single_query_mha against its plain version at SQ_SHAPES (bf16; row 0
    with no valid key; keys valid up to a length drawn per row, as over a
    decode; the history's q, K and V strided views of packed projections),
    in the layout its plan picks (asserted: SQ_LAYOUTS) and, where the shape
    fits it, the other one; two launches equal bit for bit; the warp
    layout's clock64 marks (``kernel_phases``) and the floor under any
    launch; with device times of the kernel, the other layout, its plain
    version and scaled_dot_product_attention (a yardstick of time only: it
    gives NaN on a row with no valid key, so its row 0 keeps key 0), and the
    byte bound of each shape. The total is per B=64 predict: 40 steps of 4
    layers, each a history and a query-memory attention."""
    from case_rg_tpu_torch.kernels import decode_attention as da
    rows = []
    for r, l, packed in SQ_SHAPES:
        q = torch.randn(r, 1, E, generator=gen, device=dev).to(torch.bfloat16)
        if packed:       # as the self-attention reads them, in place
            q = torch.cat([q, q, q], -1)[..., :E]
            cache = torch.randn(r, l, 2 * E, generator=gen,
                                device=dev).to(torch.bfloat16)
            k, v = cache[..., :E], cache[..., E:]
        else:
            k, v = (torch.randn(r, l, E, generator=gen, device=dev)
                    .to(torch.bfloat16) for _ in range(2))
        lengths = torch.randint(1, l + 1, (r,), generator=gen, device=dev)
        keep = torch.arange(l, device=dev)[None, :] < lengths[:, None]
        keep[0] = False
        d = E // H
        plan = da.single_query_mha_plan(r, l, d)["layout"]
        check(plan == SQ_LAYOUTS[l], f"single_query_mha {(r, l, packed)}: "
              f"planned {plan}, not {SQ_LAYOUTS[l]}")
        out = da.single_query_mha(q, k, v, keep, H)
        again = da.single_query_mha(q, k, v, keep, H)
        ref = da.single_query_mha_plain(q, k, v, keep, H)
        other = "block" if plan == "warp" else "warp"
        forced = other_plan(da, "single_query_mha_launch",
                            lambda b, l_, d_: da.single_query_mha_plan(
                                b, l_, d_, layout=other))
        with forced:
            out_other = (da.single_query_mha(q, k, v, keep, H)
                         if forced.fits(r, l, d) else None)
        torch.cuda.synchronize()
        check(torch.equal(out, again), f"single_query_mha {(r, l, packed)}: "
              "two launches differ")
        ulps, err = bf16_ulps(out, ref)
        check(ulps <= SQ_ULPS, f"single_query_mha {(r, l, packed)}: kernel "
              f"vs plain {ulps} bf16 ulps > {SQ_ULPS}")
        check(bool((out[0] == 0).all()),
              "single_query_mha: a row with no valid key is not 0")
        if out_other is not None:
            o_ulps = bf16_ulps(out_other, ref)[0]
            check(o_ulps <= SQ_ULPS, f"single_query_mha {(r, l, packed)}: "
                  f"{other} layout vs plain {o_ulps} bf16 ulps > {SQ_ULPS}")
        split = lambda x: x.view(r, -1, H, d).transpose(1, 2)
        lib_keep = keep.clone()
        lib_keep[:, 0] = True
        ms = device_ms(lambda: da.single_query_mha(q, k, v, keep, H))
        with forced:
            other_ms = (None if out_other is None else device_ms(
                lambda: da.single_query_mha(q, k, v, keep, H)))
        plain = device_ms(lambda: da.single_query_mha_plain(q, k, v, keep, H),
                          iters=20)
        lib = device_ms(lambda: F.scaled_dot_product_attention(
            split(q), split(k), split(v),
            attn_mask=lib_keep[:, None, None, :]))
        valid = int(keep.sum().item())
        # q, keep and out, and K and V rows of the valid keys
        n_bytes = nbytes(q, keep, out) + valid * 2 * E * 2
        b_ms, b_by = bound_ms(n_bytes, 4 * valid * E)
        rows.append({"rows": r, "L": l, "packed": packed, "layout": plan,
                     "max_ulps": ulps, "max_abs_err": err, "ms": ms,
                     f"{other}_ms": other_ms, "plain_ms": plain,
                     "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by})
        if plan == "warp":     # marks of (row 0, head 0): give it keys
            keep_p = keep.clone()
            keep_p[0] = keep[1]
            rows[-1]["phases"] = kernel_phases(
                phase_build, da, ("single_query_mha_smem_bytes",
                                  "single_query_mha_bf16"),
                lambda: da.single_query_mha(q, k, v, keep_p, H))
    per_site = DEC_LAYERS * T_ANS          # launches of each site a predict
    sites = [x for x in rows if (x["rows"], x["L"]) in ((B, LQ), (B, T_ANS))]
    total = {k: per_site * sum(x[k] for x in sites)
             for k in ("ms", "block_ms", "plain_ms", "library_ms",
                       "bound_ms")}
    # the floor under any launch: a one-thread kernel that spins a cycle
    total.update(launch_floor_ms=device_ms(lambda: torch.cuda._sleep(1)))
    total.update(bound_by="bytes", launches_per_predict=2 * per_site,
                 max_abs_err=max(x["max_abs_err"] for x in rows),
                 max_ulps=max(x["max_ulps"] for x in rows))
    return total, rows


def additive_inputs(r, t, l, gen, dev):
    """wq [r, t, E], uh [r, l, E], v [E] and an upstream gradient, bf16,
    at the scale the copy attention gives them (projections of normed
    streams: entries of order 1)."""
    wq = torch.randn(r, t, E, generator=gen, device=dev).to(torch.bfloat16)
    uh = torch.randn(r, l, E, generator=gen, device=dev).to(torch.bfloat16)
    v = (torch.randn(E, generator=gen, device=dev) / 16).to(torch.bfloat16)
    g = torch.randn(r, t, l, generator=gen, device=dev).to(torch.bfloat16)
    return wq, uh, v, g


def cold_ms(fn, x, l2_bytes=50e6):
    """device_ms of fn(copy) over copies of x that together exceed twice the
    L2 cache, in turn: each launch reads its x from device memory, as a
    caller finds it whose other work between two launches fills the cache
    (a decode step's stack_step streams the memories)."""
    import itertools
    n = max(2, -(-int(2 * l2_bytes) // nbytes(x)))
    copies = itertools.cycle([x.clone() for _ in range(n)])
    return device_ms(lambda: fn(next(copies)))


def additive_forced(aa, bwd):
    """other_plan that makes the wrapper launch the backward layout ``bwd``
    of additive_scores_plan."""
    return other_plan(aa, "additive_scores_launch",
                      lambda b, t, l, h: aa.additive_scores_plan(
                          b, t, l, h, bwd=bwd))


def check_and_time_additive(dev, gen, phase_build):
    """additive_scores against its plain versions in bf16 ulps: the forward
    at the decode shapes (the served batch and the beam's B x 4 rows, both
    memories) and at teacher forcing (T = 40), the backward at teacher
    forcing in its planned layout (asserted: ADD_BWD_PLANNED) and in the
    other where it takes the shape, forced through other_plan (each twice:
    the same bits each time). Device times (device_ms) of the planned
    launch, of each backward layout and of the plain versions, beside the
    bound: the larger of the bytes (inputs once, outputs once) over 3.35
    TB/s and the B*T*L*H tanh the function needs over the best tanh rate
    (sfu_per_s; the backward needs the same tanh once). At T = 1 also
    cold_ms: uh read from device memory on every launch (the byte bound is
    for that; on repeated launches a 32.8 MB uh stays in the 50 MB L2). No
    single PyTorch call computes it, so there is no library time. clock64
    marks of the forward at (B, 1, 1000) and of the backward at (B, 40,
    1000). Totals: the forward per B=64 predict and per beam batch (40
    steps over both memories), the forward and the backward per train step
    (both memories)."""
    from case_rg_tpu_torch.kernels import additive_attention as aa
    sfu = sfu_per_s()
    fns = ("additive_bwd_smem_bytes", "additive_scores_fwd_bf16",
           "additive_scores_bwd_bf16")
    rows = []
    for r, t, l in ADD_DECODE + ADD_TRAIN:
        wq, uh, v, g = additive_inputs(r, t, l, gen, dev)
        plan = aa.additive_scores_plan(r, t, l, E)
        ref = aa.additive_scores_plain(wq, uh, v)
        out = aa.additive_scores(wq, uh, v)
        torch.cuda.synchronize()
        ulps, err = bf16_ulps(out, ref)
        check(ulps <= ADD_FWD_ULPS, f"additive_scores {(r, t, l)}: kernel "
              f"vs plain {ulps} bf16 ulps > {ADD_FWD_ULPS}")
        n_tanh = r * t * l * E
        row = {"rows": r, "T": t, "L": l,
               "keys_a_warp": plan["fwd"]["keys_a_warp"],
               "max_ulps": ulps, "max_abs_err": err,
               "ms": device_ms(lambda: aa.additive_scores(wq, uh, v)),
               "plain_ms": device_ms(
                   lambda: aa.additive_scores_plain(wq, uh, v), iters=5),
               "library_ms": None}
        row["bound_ms"], row["bound_by"] = bound_ms(
            nbytes(wq, uh, v, out), n_tanh, sfu)
        if t == 1:   # uh from device memory, as a decode step finds it
            row["cold_ms"] = cold_ms(
                lambda u: aa.additive_scores(wq, u, v), uh)
        if (r, t, l) == (B, 1, P * LP):
            row["phases"] = kernel_phases(
                phase_build, aa, fns, lambda: aa.additive_scores(wq, uh, v),
                prefix="fwd")
        if t > 1:
            row["bwd"] = additive_backward(aa, wq, uh, v, g, n_tanh, sfu)
            if l == P * LP:
                row["bwd"]["phases"] = kernel_phases(
                    phase_build, aa, fns,
                    lambda: aa._launch_bwd(wq, uh, v, g), prefix="bwd")
        rows.append(row)
    keys = ("ms", "plain_ms", "bound_ms", "cold_ms")
    total = lambda part: {k: sum(x[k] for x in part) for k in keys
                          if all(k in x for x in part)}
    served = [x for x in rows if x["T"] == 1 and x["rows"] == B]
    beam = [x for x in rows if x["T"] == 1 and x["rows"] == B * BEAM_WIDTH]
    train = [x for x in rows if x["T"] > 1]
    fwd = {k: T_ANS * x for k, x in total(served).items()}
    fwd["per_beam_batch"] = {k: T_ANS * x for k, x in total(beam).items()}
    fwd["per_train_step"] = total(train)
    bwd_keys = ("ms", "plain_ms", "bound_ms", "cluster_ms", "partials_ms")
    bwd = {k: sum(x["bwd"][k] or 0.0 for x in train) for k in bwd_keys}
    for tot, part in ((fwd, served), (bwd, [x["bwd"] for x in train])):
        tot.update(library_ms=None, max_ulps=max(x["max_ulps"] for x in part),
                   max_abs_err=max(x["max_abs_err"] for x in part),
                   bound_by=max(part, key=lambda x: x["bound_ms"])["bound_by"])
    fwd["max_abs_err"] = max(x["max_abs_err"] for x in rows)
    fwd["max_ulps"] = max(x["max_ulps"] for x in rows)
    return fwd, bwd, rows, sfu


def additive_backward(aa, wq, uh, v, g, n_tanh, sfu):
    """The backward at one teacher-forcing shape: planned (asserted) and
    each layout that takes the shape, against the plain version (see
    check_and_time_additive)."""
    want = aa.additive_scores_plain_bwd(wq, uh, v, g)
    xs = [x.clone().requires_grad_() for x in (wq, uh, v)]
    y = aa.additive_scores(*xs)
    grads = [torch.autograd.grad(y, xs, g, retain_graph=True)
             for _ in range(2)]
    torch.cuda.synchronize()
    shape = tuple(g.shape)
    check(all(torch.equal(a, b) for a, b in zip(*grads)),
          f"additive_scores backward {shape}: two runs differ")
    plan = aa.additive_scores_plan(*wq.shape[:2], uh.shape[1], E)["bwd"]
    check(plan["layout"] == ADD_BWD_PLANNED[uh.shape[1]],
          f"additive_scores backward {shape}: planned {plan['layout']}, not "
          f"{ADD_BWD_PLANNED[uh.shape[1]]}")
    read = [bf16_ulps(a, b) for a, b in zip(grads[0], want)]
    out = {"layout": plan["layout"], "cluster": plan["cluster"],
           "max_ulps": max(u for u, _ in read),
           "max_abs_err": max(x for _, x in read),
           "ms": device_ms(lambda: aa._launch_bwd(wq, uh, v, g)),
           "plain_ms": device_ms(
               lambda: aa.additive_scores_plain_bwd(wq, uh, v, g), iters=3),
           "library_ms": None}
    for lay in ADD_BWD_LAYOUTS:
        forced = additive_forced(aa, lay)
        if not forced.fits(*wq.shape[:2], uh.shape[1], E):
            out[f"{lay}_ms"] = None
            continue
        with forced:
            got = [aa._launch_bwd(wq, uh, v, g) for _ in range(2)]
            torch.cuda.synchronize()
            out[f"{lay}_ms"] = device_ms(lambda: aa._launch_bwd(wq, uh, v, g))
        check(all(torch.equal(a, b) for a, b in zip(*got)),
              f"additive_scores backward {shape} {lay}: two runs differ")
        if lay == plan["layout"]:
            check(all(torch.equal(a, b) for a, b in zip(got[0], grads[0])),
                  f"additive_scores backward {shape}: {lay} forced differs "
                  f"from planned")
        out["max_ulps"] = max(out["max_ulps"], max(
            bf16_ulps(a, b)[0] for a, b in zip(got[0], want)))
    check(out["max_ulps"] <= ADD_BWD_ULPS, f"additive_scores backward "
          f"{shape}: {out['max_ulps']} bf16 ulps > {ADD_BWD_ULPS}")
    out["bound_ms"], out["bound_by"] = bound_ms(
        nbytes(wq, uh, v, g, wq, uh, v), n_tanh, sfu)
    return out


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


def device_ms(fn, iters: int = 50) -> float:
    """Device time per call of ``fn``, without the host's gaps: the calls
    are queued behind a spin kernel, so the host has issued them all before
    the first runs, and two events time them on the device alone. A call
    that the device finishes before the host can issue the next one (a
    short kernel) is timed as the device runs it."""
    fn()
    torch.cuda.synchronize()
    spin = 5e7                            # cycles: ~25 ms at 1.98 GHz
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued = not start.query()        # the spin still ran: no gaps
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / iters
        spin *= 4
    raise CheckFailed("device_ms: the host could not queue the calls ahead "
                      "of the device")


def profile_device(run, batches):
    """Device time of ``run`` over ``batches`` under torch.profiler: wall ms
    per batch, device busy ms and idle share, and the kernels that take the
    most."""
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
            run(bt)
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


def serving_model(dev):
    """CaSE at the serving widths, bf16 weights from seed 0 with noisy
    biases and LayerNorm gains: (cfg, model)."""
    from case_rg_tpu_torch.config import ModelConfig
    from case_rg_tpu_torch.models import create_model, perturb_affine
    cfg = ModelConfig(name="case", vocab_size=V, embedding_size=E,
                      hidden_size=E, num_heads=H, enc_layers=ENC_LAYERS,
                      dec_layers=DEC_LAYERS, max_dec_len=T_ANS,
                      max_target_length=T_ANS, param_dtype="bfloat16")
    model = create_model("case", cfg, device=dev, seed=0)
    perturb_affine(model, torch.Generator(device=dev).manual_seed(1))
    return cfg, model


def serve_case(dev, cfg, model):
    from case_rg_tpu_torch.kernels import additive_attention as aa
    from case_rg_tpu_torch.kernels import decode_attention as da
    from case_rg_tpu_torch.kernels import decoder_stack as ds
    from case_rg_tpu_torch.kernels import encoder_attention as ea
    from case_rg_tpu_torch.models import multimem
    from case_rg_tpu_torch.ops import attention, bilinear
    from case_rg_tpu_torch.runtime.inference import make_predict_fn

    n_params = sum(p.numel() for p in model.parameters())
    predict = make_predict_fn(model, cfg, T_ANS, device=dev)
    rank_only = make_predict_fn(model, cfg, T_ANS, rank_only=True, device=dev)
    rng = np.random.RandomState(0)
    batches = [make_batch(rng) for _ in range(3)]
    predict(make_batch(rng))                    # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()

    def reset():
        ea.LAUNCHES = ds.LAUNCHES = da.LAUNCHES = aa.LAUNCHES = 0

    def counts():
        return {"fused_mha": ea.LAUNCHES, "stack_step": ds.LAUNCHES,
                "single_query_mha": da.LAUNCHES, "additive_scores": aa.LAUNCHES}

    reset()
    outs, times = serve(predict, batches)
    launches = counts()
    n = len(batches)
    # per batch: 19 attention sites; 40 steps, each through the fused
    # passage stack, 4 layers x 2 attentions of the query-memory stack and
    # the copy attention over both memories
    want = {"fused_mha": 19 * n, "stack_step": T_ANS * n,
            "single_query_mha": 2 * DEC_LAYERS * T_ANS * n,
            "additive_scores": 2 * T_ANS * n}
    check(launches == want, f"serving launches {launches}, expected {want}")
    for out in outs:
        a, r = out["answer"], out["rank"]
        check(tuple(a.shape) == (B, T_ANS) and a.dtype == torch.int32,
              f"answer {tuple(a.shape)} {a.dtype}")
        check(bool(((a >= 0) & (a < V)).all()), "answer ids out of the vocab")
        check(tuple(r.shape) == (B, P) and bool(torch.isfinite(r).all()),
              f"rank {tuple(r.shape)} not finite")

    reset()
    t0 = time.perf_counter()
    ro = rank_only(batches[0])["rank"]
    torch.cuda.synchronize()
    rank_only_ms = (time.perf_counter() - t0) * 1e3
    ro = ro.cpu()
    check(counts() == dict(want, fused_mha=RANK_ONLY_MHA, stack_step=0,
                           single_query_mha=0, additive_scores=0)
          and tuple(ro.shape) == (B, P) and bool(torch.isfinite(ro).all()),
          f"rank_only: launches {counts()}, shape {tuple(ro.shape)}")
    ulps, _ = bf16_ulps(ro, outs[0]["rank"])
    check(ulps <= 1, f"rank_only vs predict rank: {ulps} bf16 ulps > 1")

    kernels = (ea.fused_mha, ds.stack_step, da.single_query_mha,
               aa.additive_scores)
    plains = (ea.fused_mha_plain, ds.stack_step_plain,
              da.single_query_mha_plain, aa.additive_scores_plain)

    def route(fns):
        (attention.fused_mha, multimem.stack_step, attention.single_query_mha,
         bilinear.additive_scores) = fns

    def serve_swapped(*fns):
        """The batches with the four wrappers replaced by ``fns``."""
        try:
            route(fns)
            return serve(predict, batches)
        finally:
            route(kernels)

    # the same batches with each wrapper swapped for its plain version: the
    # same function, rounded at the same points, so only the order of the
    # sums differs
    reset()
    plain_outs, plain_times = serve_swapped(*plains)
    check(not any(counts().values()),
          "kernels launched with their plain versions swapped in")
    vs_plain = agreement(outs, plain_outs)
    # the stack kernel alone, and the rounding witness
    stack_only = agreement(serve_swapped(
        plains[0], ds.stack_step, *plains[2:])[0], plain_outs)
    exact_vs_plain = agreement(
        serve_swapped(mha_exact_sums, *plains[1:])[0], plain_outs)
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

    # the same batches with the kernels routed off: dense attention, the
    # per-layer decode chain, the dense single-query attention and copy
    # scores (another rounding of the same function)
    switches = (attention.set_fused_attention, multimem.set_fused_stack,
                attention.set_single_query_attention,
                bilinear.set_additive_kernel)
    try:
        for switch in switches:
            switch(False)
        reset()
        off_outs, off_times = serve(predict, batches)
        check(not any(counts().values()), "kernels launched with the routing "
              "off")
    finally:
        for switch in switches:
            switch(None)
    vs_off = agreement(outs, off_outs)
    check(vs_off["rank_max_ulps"] <= RANK_ULPS,
          f"rank, kernels vs routed off: {vs_off['rank_max_ulps']} bf16 ulps "
          f"> {RANK_ULPS}")

    profiled = profile_device(predict, batches[:PROFILE_BATCHES])
    return {
        "params": n_params, "launches": launches,
        "ms_per_batch": times, "plain_ms_per_batch": plain_times,
        "routed_off_ms_per_batch": off_times, "rank_only_ms": rank_only_ms,
        "vs_plain": vs_plain, "stack_kernel_alone_vs_plain": stack_only,
        "exact_sums_vs_plain": exact_vs_plain, "vs_routed_off": vs_off,
        "profile": profiled,
    }


def sync_check_serving(dev, cfg, model):
    """The decode step loops under no_host_sync (any operation that makes
    the host wait on the card raises): every greedy _step_core of one B=64
    predict, and one decode_chunk of CHUNK_STEPS steps in the pallas and
    dense argmax modes; the stack kernel's launches inside them."""
    from case_rg_tpu_torch.device import no_host_sync
    from case_rg_tpu_torch.kernels import decoder_stack as ds
    from case_rg_tpu_torch.runtime.continuous import make_continuous_fns
    from case_rg_tpu_torch.runtime.inference import make_predict_fn
    batch = make_batch(np.random.RandomState(5))
    predict = make_predict_fn(model, cfg, T_ANS, device=dev)
    predict(batch)                                   # warm-up
    dec = model.decoder
    core = dec._step_core

    def checked(*args, **kw):
        with no_host_sync():
            return core(*args, **kw)

    ds.LAUNCHES = 0
    dec._step_core = checked
    try:
        out = predict(batch)
    finally:
        del dec._step_core
    torch.cuda.synchronize()
    check(tuple(out["answer"].shape) == (B, T_ANS) and ds.LAUNCHES == T_ANS,
          f"sync check: answer {tuple(out['answer'].shape)}, stack launches "
          f"{ds.LAUNCHES}")
    res = {"greedy _step_core steps": T_ANS}
    for mode in ("pallas", "dense"):
        init_fn, chunk_fn, _ = make_continuous_fns(model, T_ANS, CHUNK_STEPS,
                                                   fast_argmax=mode,
                                                   device=dev)
        state, _ = init_fn(batch)
        state = chunk_fn(state)                      # warm-up
        ds.LAUNCHES = 0
        with no_host_sync():
            state = chunk_fn(state)
        torch.cuda.synchronize()
        check(ds.LAUNCHES == CHUNK_STEPS, f"sync check {mode}: stack "
              f"launches {ds.LAUNCHES}")
        res[f"decode_chunk ({mode})"] = CHUNK_STEPS
    return res


# ---- phases 5-7: the candidate argmax and continuous serving ----

LS = LQ + P * LP                 # copy source of a row: query + pool = 1060
# combine_copy_mass: the decode's shape, an odd one, and one longer than the
# JAX package's MAX_FAST_LS (1280)
COMBINE_SHAPES = ((B, LS), (5, 77), (8, 3000))
# the body combine_copy_mass_plan must pick at each Ls of COMBINE_SHAPES:
# the brute body's compares at short rows, the sort at the decode's 1060
COMBINE_BODIES = {LS: "sort", 77: "brute", 3000: "sort"}
# lengths at which both bodies are timed at B=64 (a pool of 5 passages:
# 560 positions)
COMBINE_SWEEP = (77, 256, 384, 560, LS, 2048)
# Per element, as a share of the row's total copy mass: the kernel and its
# plain version add the same f32 values in another order.
COMBINE_TOL = 1e-5
# Ids as text repeats them: each request draws ranks from a Zipf law
# (exponent 1) over this many ranks, mapped to its own random vocabulary
# ids, so its most frequent ids recur tens of times in 1060 positions.
ZIPF_RANKS = 1000
ARGMAX_MODES = ("dense", "mxu", "pallas")
# pallas mode with the kernel vs with its plain version: the same function,
# only the order of the combine's f32 sums differs
MIN_COMBINE_TOKEN_AGREEMENT = 0.99
# continuous serving: requests, refill width, steps per chunk, the refill
# coalescing variant, caps drawn over [CAP_LO, T_ANS], and the two pool
# buckets (passages) of the multi-lane run
N_REQUESTS, REFILL, CHUNK_STEPS, REFILL_MIN, CAP_LO = 512, 16, 8, 8, 8
BUCKETS = (5, P)
MHA_PER_ENCODE = sum(MHA_SITES.values())    # fused_mha launches per encode


def zipf_ids(rng, n: int) -> np.ndarray:
    """``n`` token ids of one request, drawn as ZIPF_RANKS says."""
    p = 1.0 / np.arange(1, ZIPF_RANKS + 1)
    vocab = rng.choice(np.arange(4, V), ZIPF_RANKS, replace=False)
    return vocab[rng.choice(ZIPF_RANKS, n, p=p / p.sum())].astype(np.int32)


def make_requests(rng, n: int):
    """``n`` requests (query 60, pool 10 x 100 with padded tails; a third
    of them with only 5 passages) and their answer caps."""
    q = np.zeros((n, 1, LQ), np.int32)
    pool = np.zeros((n, P, LP), np.int32)
    for i in range(n):
        ids = zipf_ids(rng, LQ + P * LP)
        nq = rng.randint(LQ // 3, LQ + 1)
        q[i, 0, :nq] = ids[:nq]
        n_pass = BUCKETS[0] if i % 3 == 0 else P
        for k in range(n_pass):
            n_tok = rng.randint(LP // 2, LP + 1)
            pool[i, k, :n_tok] = ids[LQ + k * LP:LQ + k * LP + n_tok]
    caps = rng.randint(CAP_LO, T_ANS + 1, n).astype(np.int32)
    return {"query": q, "passage": pool}, caps


def take(arrays, idx):
    return {k: v[idx] for k, v in arrays.items()}


def check_and_time_combine(dev, reqs, phase_build):
    """combine_copy_mass against its plain version at COMBINE_SHAPES (bf16
    copy mass, as the decode gives it), in the body its plan picks
    (asserted: COMBINE_BODIES) and in the other: per element within
    COMBINE_TOL of the row's mass, and the argmax of ``b_at + comb`` picks
    the same id on every row; two launches equal bit for bit, and every
    member of a group equal to its first member bit for bit. Times per
    launch: the kernel, the other body, its plain version, and the dense
    scatter_add_ + gather pair as yardstick, and the sort body's clock64
    marks (``kernel_phases``). Then both bodies' times at
    B=64 over COMBINE_SWEEP lengths ("by_ls", where the plan's switch
    between them is read)."""
    from case_rg_tpu_torch.kernels import copy_argmax as ca
    rng = np.random.RandomState(5)
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for b, ls in COMBINE_SHAPES:
        if (b, ls) == (B, LS):        # the served layout, padding and all
            ids = np.concatenate([reqs["query"][:B, 0],
                                  reqs["passage"][:B].reshape(B, -1)], 1)
        else:
            ids = np.zeros((b, ls), np.int32)
            for r in range(b):
                n = rng.randint(ls // 2, ls + 1)
                ids[r, :n] = zipf_ids(rng, n)
        cw = rng.rand(b, ls) * (ids != 0)
        cw = cw / cw.sum(-1, keepdims=True) * rng.uniform(0.2, 1.0, (b, 1))
        ids_t = torch.from_numpy(ids).to(dev)
        cw_t = torch.from_numpy(cw.astype(np.float32)).to(dev).to(
            torch.bfloat16)
        body = ca.combine_copy_mass_plan(b, ls)["body"]
        check(body == COMBINE_BODIES[ls], f"combine_copy_mass {(b, ls)}: "
              f"planned {body}, not {COMBINE_BODIES[ls]}")
        out = ca.combine_copy_mass(cw_t, ids_t)
        again = ca.combine_copy_mass(cw_t, ids_t)
        ref = ca.combine_copy_mass_plain(cw_t, ids_t)
        other_body = "brute" if body == "sort" else "sort"
        other = other_plan(ca, "combine_copy_mass_launch",
                           lambda b_, l_: ca.combine_copy_mass_plan(
                               b_, l_, body=other_body))
        with other:
            out_other = ca.combine_copy_mass(cw_t, ids_t)
        torch.cuda.synchronize()
        check(torch.equal(out, again), f"combine_copy_mass {(b, ls)}: two "
              "launches differ")
        # every member of a group carries its first member's value, bit for
        # bit (first: the smallest position of each id, per row)
        pos = torch.arange(ls, device=dev).expand(b, ls)
        first = torch.full((b, int(ids_t.max()) + 1), ls, device=dev,
                           dtype=torch.long).scatter_reduce(
            1, ids_t.long(), pos, "amin")
        check(torch.equal(out, out.gather(1, first.gather(1, ids_t.long()))),
              f"combine_copy_mass {(b, ls)}: a group's members differ")
        mass = cw_t.float().sum(-1, keepdim=True)
        rel = ((out - ref).abs() / mass).max().item()
        check(rel <= COMBINE_TOL, f"combine_copy_mass {(b, ls)}: kernel vs "
              f"plain {rel} of the row's mass > {COMBINE_TOL}")
        rel_other = ((out_other - ref).abs() / mass).max().item()
        check(rel_other <= COMBINE_TOL, f"combine_copy_mass {(b, ls)}: "
              f"{other_body} body vs plain {rel_other} of the row's mass > "
              f"{COMBINE_TOL}")
        # generator mass at each id (the same for every member of a group)
        b_at = (0.05 * torch.rand(b, V, generator=gen, device=dev)).gather(
            1, ids_t.long())
        pick = lambda c: ids_t.gather(1, (b_at + c).argmax(-1, keepdim=True))
        check(torch.equal(pick(out), pick(ref)),
              f"combine_copy_mass {(b, ls)}: the candidate argmax differs")
        groups = [np.unique(r[r != 0], return_counts=True)[1] for r in ids]
        ids_l, cw_f = ids_t.long(), cw_t.float()
        kernel = lambda: ca.combine_copy_mass(cw_t, ids_t)
        # device time: a launch takes less than the host needs to issue the
        # next one, so back-to-back launches timed by events read the host
        ms = device_ms(kernel)
        with other:
            other_ms = device_ms(kernel)
        issue_ms = time_ms(kernel, iters=200)
        plain = device_ms(lambda: ca.combine_copy_mass_plain(cw_t, ids_t),
                          iters=20)
        lib = device_ms(lambda: torch.zeros(b, V, device=dev).scatter_add_(
            1, ids_l, cw_f).gather(1, ids_l))
        # operations the function needs, not the kernel's brute-force
        # compare per (l, j) pair: per row a sort of (id, position) pairs
        # (ls * ceil(log2 ls) compares), a segmented sum and the write-back
        # (one operation each per position), all SIMT
        n_ops = b * ls * (int(np.ceil(np.log2(ls))) + 2)
        b_ms, b_by = bound_ms(nbytes(cw_t, ids_t, out), n_ops, PEAK_F32_FLOPS)
        rows.append({"B": b, "Ls": ls, "body": body, "max_rel_err": rel,
                     f"{other_body}_rel_err": rel_other,
                     f"{other_body}_ms": other_ms,
                     "max_abs_err": (out - ref).abs().max().item(),
                     "largest_group": int(max(g.max() for g in groups)),
                     "mean_group": float(np.mean([g.mean() for g in groups])),
                     "ms": ms, "issue_ms": issue_ms, "plain_ms": plain,
                     "library_ms": lib, "bound_ms": b_ms, "bound_by": b_by})
        if body == "sort":
            rows[-1]["phases"] = kernel_phases(
                phase_build, ca, ("combine_copy_mass_smem_bytes",
                                  "combine_copy_mass"), kernel)
    by_ls = []
    for ls in COMBINE_SWEEP:
        ids = np.zeros((B, ls), np.int32)
        for r in range(B):
            n = rng.randint(ls // 2, ls + 1)
            ids[r, :n] = zipf_ids(rng, n)
        cw = rng.rand(B, ls) * (ids != 0)
        cw_t = torch.from_numpy((cw / cw.sum(-1, keepdims=True)).astype(
            np.float32)).to(dev).to(torch.bfloat16)
        ids_t = torch.from_numpy(ids).to(dev)
        row = {"Ls": ls, "plan": ca.combine_copy_mass_plan(B, ls)["body"]}
        for body in ("sort", "brute"):
            forced = other_plan(ca, "combine_copy_mass_launch",
                                lambda b_, l_: ca.combine_copy_mass_plan(
                                    b_, l_, body=body))
            if forced.fits(B, ls):
                with forced:
                    row[f"{body}_ms"] = device_ms(
                        lambda: ca.combine_copy_mass(cw_t, ids_t))
        by_ls.append(row)
    return rows, by_ls


def serve_argmax_modes(dev, cfg, model, reqs):
    """Two B=64 batches through make_predict_fn in each argmax mode, the
    combine's launches counted; pallas mode again with the kernel's wrapper
    swapped for its plain version. Candidate modes are held to dense as the
    kernels are to their plain versions (answers of a random-weight model
    tip at near-ties), the kernel to its plain version at
    MIN_COMBINE_TOKEN_AGREEMENT."""
    from case_rg_tpu_torch.kernels import copy_argmax as ca
    from case_rg_tpu_torch.runtime.inference import make_predict_fn
    batches = [take(reqs, slice(i * B, (i + 1) * B)) for i in range(2)]
    predict = {mode: make_predict_fn(model, cfg, T_ANS, fast_argmax=mode,
                                     device=dev) for mode in ARGMAX_MODES}
    outs, res = {}, {m: {"ms_per_batch": []} for m in ARGMAX_MODES}
    for mode in ARGMAX_MODES:
        predict[mode](batches[0])          # warm-up
    torch.cuda.synchronize()
    # in turns (dense, mxu, pallas, pallas, mxu, dense): the host's clock
    # drifts with the shared host
    for mode in ARGMAX_MODES + ARGMAX_MODES[::-1]:
        ca.LAUNCHES = 0
        got, times = serve(predict[mode], batches)
        want = T_ANS * len(batches) if mode == "pallas" else 0
        check(ca.LAUNCHES == want, f"{mode}: combine_copy_mass launched "
              f"{ca.LAUNCHES} times, expected {want}")
        if mode in outs:
            check(all(torch.equal(a["answer"], b["answer"])
                      for a, b in zip(got, outs[mode])),
                  f"{mode}: two runs of the same batches differ")
        outs[mode] = got
        res[mode]["ms_per_batch"] += times
        res[mode]["combine_launches_per_batch"] = want // len(batches)
    for mode in ARGMAX_MODES:
        res[mode]["profile"] = profile_device(predict[mode], batches[:1])
    kernel = ca.combine_copy_mass
    try:
        ca.combine_copy_mass = ca.combine_copy_mass_plain
        ca.LAUNCHES = 0
        plain_outs, plain_times = serve(make_predict_fn(
            model, cfg, T_ANS, fast_argmax="pallas", device=dev), batches)
        check(ca.LAUNCHES == 0, "combine_copy_mass launched while swapped")
    finally:
        ca.combine_copy_mass = kernel
    vs_plain = agreement(outs["pallas"], plain_outs)
    check(vs_plain["token_agreement"] >= MIN_COMBINE_TOKEN_AGREEMENT,
          f"pallas mode, kernel vs plain combine: {vs_plain}")
    res["pallas_plain_combine"] = {"ms_per_batch": plain_times,
                                   "vs_kernel": vs_plain}
    for mode in ("mxu", "pallas"):
        got = agreement(outs[mode], outs["dense"])
        check(got["token_agreement"] >= MIN_TOKEN_AGREEMENT
              and got["first_token_agreement"] >= MIN_FIRST_TOKEN_AGREEMENT,
              f"answers, {mode} vs dense: {got}")
        res[mode]["vs_dense"] = got
    return res


def serve_continuous(dev, cfg, model, reqs, caps):
    """Continuous serving at full width: N_REQUESTS requests through
    run_continuous (batch 64, refill 16, chunks of 8 steps, pallas mode),
    every launch counter set to 0 just before the base run and read just
    after; then lookahead, async harvest and refill coalescing (answers
    equal to the base run's, token for token), the multi-lane driver over
    two pool buckets, the one-shot predict of the same requests (answers
    cut at each cap held to agreement, rank within RANK_ULPS), dense mode
    for its time, and a profile."""
    from case_rg_tpu_torch.kernels import additive_attention as aa
    from case_rg_tpu_torch.kernels import copy_argmax as ca
    from case_rg_tpu_torch.kernels import decode_attention as da
    from case_rg_tpu_torch.kernels import decoder_stack as ds
    from case_rg_tpu_torch.kernels import encoder_attention as ea
    from case_rg_tpu_torch.runtime.continuous import (
        Lane, make_continuous_fns, run_continuous, run_continuous_multi)
    from case_rg_tpu_torch.runtime.inference import make_predict_fn
    n = len(caps)

    fns = {mode: make_continuous_fns(model, T_ANS, CHUNK_STEPS,
                                     fast_argmax=mode, device=dev)
           for mode in ("pallas", "dense")}
    def single(k=n, mode="pallas", **opts):
        return timed(lambda emit: run_continuous(
            items(k), batch_maker(reqs, caps), *fns[mode], batch_size=B,
            refill=REFILL, emit=emit, **opts), k)

    single()                                  # warm-up
    ea.LAUNCHES = ds.LAUNCHES = ca.LAUNCHES = da.LAUNCHES = aa.LAUNCHES = 0
    base, stats = single()
    launches = {"fused_mha": ea.LAUNCHES, "stack_step": ds.LAUNCHES,
                "combine_copy_mass": ca.LAUNCHES,
                "single_query_mha": da.LAUNCHES, "additive_scores": aa.LAUNCHES}
    steps = CHUNK_STEPS * stats["chunks"]
    want = {"fused_mha": MHA_PER_ENCODE * (1 + stats["refills"]),
            "stack_step": steps, "combine_copy_mass": steps,
            "single_query_mha": 2 * DEC_LAYERS * steps,
            "additive_scores": 2 * steps}
    check(launches == want, f"continuous launches {launches}, expected {want}")
    res = {"base": dict(stats, launches=launches)}
    _, res["dense"] = single(mode="dense")

    def same_as_base(got, what):
        bad = [i for i in got if not np.array_equal(got[i][0], base[i][0])]
        check(not bad, f"continuous {what}: {len(bad)} answers differ from "
              f"the base run's (first: request {bad[:1]})")

    for name, opts in (("lookahead", {"lookahead": True}),
                       ("async_harvest", {"async_harvest": True}),
                       ("refill_min", {"refill_min": REFILL_MIN})):
        got, res[name] = single(**opts)
        same_as_base(got, name)

    # multi-lane: one lane per pool bucket; a request goes to the smallest
    # bucket that holds its non-empty passages
    used = (reqs["passage"] != 0).any(-1).sum(-1)
    lanes = {p: Lane(p, batch_maker(dict(reqs, passage=reqs["passage"][:, :p]),
                                 caps),
                     *fns["pallas"], batch_size=B, refill=REFILL)
             for p in BUCKETS}
    route = lambda r: lanes[min(p for p in BUCKETS if used[r["i"]] <= p)]
    got, res["multi_lane"] = timed(lambda emit: run_continuous_multi(
        items(n), list(lanes.values()), route, emit=emit), n)
    full = [i for i in range(n) if used[i] > BUCKETS[0]]
    same_as_base({i: got[i] for i in full}, "multi-lane, full bucket")
    res["multi_lane"]["small_bucket_vs_base"] = answer_agreement(
        {i: got[i] for i in range(n) if used[i] <= BUCKETS[0]}, base, caps,
        cfg.eos_id)

    # the same requests through the one-shot predict (pallas mode)
    predict = make_predict_fn(model, cfg, T_ANS, fast_argmax="pallas",
                              device=dev)
    one = {}
    for s in range(0, n, B):
        out = predict(take(reqs, slice(s, s + B)))
        for i, (a, r) in enumerate(zip(out["answer"].cpu().numpy(),
                                       out["rank"].float().cpu())):
            one[s + i] = (a, r)
    vs_one = answer_agreement(base, one, caps, cfg.eos_id)
    vs_one["rank_max_ulps"] = max(bf16_ulps(torch.from_numpy(base[i][1]),
                                            one[i][1])[0] for i in range(n))
    check(vs_one["token_agreement"] >= MIN_TOKEN_AGREEMENT
          and vs_one["first_token_agreement"] >= MIN_FIRST_TOKEN_AGREEMENT
          and vs_one["rank_max_ulps"] <= RANK_ULPS,
          f"continuous vs one-shot predict: {vs_one}")
    res["vs_one_shot"] = vs_one
    # pallas and dense once more, in the reverse order (pallas, dense, ...,
    # dense, pallas): the host's clock drifts with the shared host
    _, res["dense_again"] = single(mode="dense")
    got, res["base_again"] = single()
    same_as_base(got, "base again")
    res["profile"] = profile_device(lambda k: single(k=k), [2 * B])
    return res, base


def items(k: int):
    return iter([{"i": i} for i in range(k)])


def batch_maker(arrays, caps, keys=None):
    """``make_batch(items, bs)`` of the continuous drivers over request
    ``arrays`` with answer ``caps`` (and sampling ``keys``): padding rows
    repeat the last request."""
    def make_batch(its, bs):
        idx = [r["i"] for r in its]
        idx += [idx[-1]] * (bs - len(idx))
        batch = dict(take(arrays, idx), response_cap=caps[idx])
        if keys is not None:
            batch["sample_key"] = keys[idx]
        return batch
    return make_batch


def sample_keys(n: int) -> np.ndarray:
    """A sampling key per request, from seed 11."""
    return np.random.RandomState(11).randint(0, 2 ** 32, (n, 2),
                                             dtype=np.int64)


def timed(drive, k: int):
    """``drive(emit)`` (a continuous run over requests 0..k-1) on the host
    clock: ({request: (answer, rank)}, the run's counters with
    requests/s, wall seconds and ms per chunk)."""
    got = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = drive(lambda r, ids, rk: got.__setitem__(
        r["i"], (ids.copy(), rk.copy())))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(stats["served"] == k and sorted(got) == list(range(k)),
          f"continuous: served {stats['served']} of {k}")
    stats.update(requests_per_s=k / wall, wall_s=wall,
                 ms_per_chunk=wall * 1e3 / stats["chunks"])
    return got, stats


def answer_agreement(got, ref, caps, eos):
    """Shares of answer tokens (each request's first ``cap`` positions, the
    reference cut at the cap and its first EOS) and of first tokens that
    agree between two {request: (answer, rank)} maps."""
    same = total = first = 0
    for i in got:
        a, r = got[i][0], ref[i][0].copy()
        cap = int(caps[i])
        hits = np.flatnonzero(r[:cap] == eos)
        r[(hits[0] + 1 if len(hits) else cap):] = 0
        same += int((a[:cap] == r[:cap]).sum())
        total += cap
        first += int(a[0] == r[0])
    return {"token_agreement": same / max(total, 1),
            "first_token_agreement": first / max(len(got), 1),
            "requests": len(got)}


# ---- phases 9-10: beam search and sampling ----

def decode_counts():
    from case_rg_tpu_torch.kernels import additive_attention as aa
    from case_rg_tpu_torch.kernels import decode_attention as da
    return {"single_query_mha": da.LAUNCHES, "additive_scores": aa.LAUNCHES}


def reset_decode_counts():
    from case_rg_tpu_torch.kernels import additive_attention as aa
    from case_rg_tpu_torch.kernels import decode_attention as da
    da.LAUNCHES = aa.LAUNCHES = 0


def cut_at_eos(answer: torch.Tensor, eos: int) -> torch.Tensor:
    """PAD after each row's first EOS (a beam's answer ends there)."""
    after = (answer == eos).int().cumsum(-1) - (answer == eos).int() > 0
    return torch.where(after, torch.zeros_like(answer), answer)


def serve_decoding(dev, cfg, model, reqs):
    """Two B=64 batches through make_predict_fn with beam search of width
    BEAM_WIDTH, with sampling at top_k=1 and with sampling under
    SAMPLE_CONTROLS (per-row keys from a seed), and through the decoder's
    beam at width 1; greedy for reference. Host ms per batch and the new
    kernels' launches per batch (40 steps x (8 + 2), on B or B x width
    rows). Gates: beam width 1 is greedy cut at its first EOS, token for
    token; sampling at top_k=1 agrees with greedy as the kernels agree with
    their plain versions (MIN_TOKEN_AGREEMENT, MIN_FIRST_TOKEN_AGREEMENT;
    the sampler's bookkeeping ends every row with EOS); real sampling
    repeats bit for bit with the same keys."""
    from case_rg_tpu_torch.device import batch_to_device
    from case_rg_tpu_torch.runtime.inference import make_predict_fn
    rng = np.random.RandomState(7)
    batches = [dict(take(reqs, slice(i * B, (i + 1) * B)),
                    sample_key=rng.randint(0, 2 ** 32, (B, 2), dtype=np.int64))
               for i in range(2)]

    def beam1(bt):
        with torch.inference_mode():
            bt = batch_to_device(bt, dev)
            st = model.stages(bt)
            mem, keeps, weights, src, feat = model._decoder_inputs(bt, st)
            return {"answer": model.decoder.beam(mem, keeps, weights, src,
                                                 T_ANS, 1, feature=feat),
                    "rank": st["passage_score"]}

    fns = {"greedy": make_predict_fn(model, cfg, T_ANS, device=dev),
           "beam": make_predict_fn(model, cfg, T_ANS, beam_width=BEAM_WIDTH,
                                   device=dev),
           "beam1": beam1,
           "sample_top_k_1": make_predict_fn(model, cfg, T_ANS,
                                             decoding="sample", top_k=1,
                                             device=dev),
           "sample": make_predict_fn(model, cfg, T_ANS, decoding="sample",
                                     device=dev, **SAMPLE_CONTROLS)}
    res, outs = {}, {}
    per_batch = {"single_query_mha": 2 * DEC_LAYERS * T_ANS,
                 "additive_scores": 2 * T_ANS}
    for name, fn in fns.items():
        fn(batches[0])                               # warm-up
        reset_decode_counts()
        outs[name], times = serve(fn, batches)
        launches = decode_counts()
        want = {k: len(batches) * c for k, c in per_batch.items()}
        check(launches == want, f"{name}: launches {launches}, expected "
              f"{want}")
        for out in outs[name]:
            a = out["answer"]
            check(tuple(a.shape) == (B, T_ANS) and bool(((a >= 0) & (a < V))
                                                        .all()),
                  f"{name}: answer {tuple(a.shape)} out of the vocab")
        res[name] = {"ms_per_batch": times,
                     "launches_per_batch": {k: c // len(batches)
                                            for k, c in launches.items()}}
    for g, b1 in zip(outs["greedy"], outs["beam1"]):
        check(torch.equal(cut_at_eos(g["answer"], cfg.eos_id), b1["answer"]),
              "beam width 1 differs from greedy cut at its first EOS")
    res["beam1"]["vs_greedy"] = "identical"
    got = agreement(outs["sample_top_k_1"], outs["greedy"])
    check(got["token_agreement"] >= MIN_TOKEN_AGREEMENT
          and got["first_token_agreement"] >= MIN_FIRST_TOKEN_AGREEMENT,
          f"sampling at top_k=1 vs greedy: {got}")
    res["sample_top_k_1"]["vs_greedy"] = got
    again, _ = serve(fns["sample"], batches)
    check(all(torch.equal(a["answer"], b["answer"])
              for a, b in zip(again, outs["sample"])),
          "sampling: a repeat with the same keys differs")
    res["sample"]["vs_greedy"] = agreement(outs["sample"], outs["greedy"])
    res["beam"]["vs_greedy"] = agreement(outs["beam"], outs["greedy"])
    for name in ("beam", "sample"):
        res[name]["profile"] = profile_device(fns[name], batches[:1])
    return res


def serve_continuous_sampled(dev, cfg, model, reqs, caps):
    """N_REQUESTS requests through run_continuous with decoding="sample"
    under SAMPLE_CONTROLS (batch 64, refill 16, chunks of 8; a key per
    request from a seed), launch counters set to 0 just before the base run
    and read just after; a repeat gives the same answers bit for bit; the
    one-shot sampled predict with the same keys agrees at the greedy gates
    (MIN_TOKEN_AGREEMENT, MIN_FIRST_TOKEN_AGREEMENT: a row's last step
    is EOS in both, at its cap here, at 40 there)."""
    from case_rg_tpu_torch.kernels import decoder_stack as ds
    from case_rg_tpu_torch.runtime.continuous import (make_continuous_fns,
                                                      run_continuous)
    from case_rg_tpu_torch.runtime.inference import make_predict_fn
    n = len(caps)
    keys = sample_keys(n)
    make_batch = batch_maker(reqs, caps, keys)

    fns = make_continuous_fns(model, T_ANS, CHUNK_STEPS, decoding="sample",
                              device=dev, **SAMPLE_CONTROLS)
    run = lambda: timed(lambda emit: run_continuous(
        items(n), make_batch, *fns, batch_size=B, refill=REFILL, emit=emit),
        n)
    reset_decode_counts()
    ds.LAUNCHES = 0
    base, stats = run()
    launches = dict(decode_counts(), stack_step=ds.LAUNCHES)
    steps = CHUNK_STEPS * stats["chunks"]
    want = {"single_query_mha": 2 * DEC_LAYERS * steps,
            "additive_scores": 2 * steps, "stack_step": steps}
    check(launches == want, f"sampled continuous launches {launches}, "
          f"expected {want}")
    res = {"base": dict(stats, launches=launches)}
    again, res["again"] = run()
    bad = [i for i in range(n) if not np.array_equal(again[i][0], base[i][0])]
    check(not bad, f"sampled continuous: {len(bad)} answers differ on a "
          f"repeat with the same keys (first: request {bad[:1]})")
    predict = make_predict_fn(model, cfg, T_ANS, decoding="sample",
                              device=dev, **SAMPLE_CONTROLS)
    one = {}
    for s0 in range(0, n, B):
        out = predict(dict(take(reqs, slice(s0, s0 + B)),
                           sample_key=keys[s0:s0 + B]))
        for i, (a, r) in enumerate(zip(out["answer"].cpu().numpy(),
                                       out["rank"].float().cpu())):
            one[s0 + i] = (a, r)
    vs_one = answer_agreement(base, one, caps, cfg.eos_id)
    check(vs_one["token_agreement"] >= MIN_TOKEN_AGREEMENT
          and vs_one["first_token_agreement"] >= MIN_FIRST_TOKEN_AGREEMENT,
          f"sampled continuous vs one-shot sample: {vs_one}")
    res["vs_one_shot"] = vs_one
    return res, base


# ---- the device loop ----

# the device loop at full width: steps a chunk, chunks a mega, ring rows;
# refill width REFILL and batch B as in the chunk loop; the (steps, K)
# pairs whose requests/s decide the knee again on the card
DL_STEPS, DL_K, DL_RING = 4, 8, 256
DL_KNEE = ((4, 8), (8, 4), (4, 16))
SPIN_CYCLES = int(1e8)                 # ~50 ms at 1.98 GHz


def serve_device_loop(dev, cfg, model, reqs, caps, chunk_base, sampled_base):
    """The 512 requests through run_continuous_device (greedy pallas, B=64,
    DL_STEPS steps a chunk, DL_K chunks a mega, a ring of DL_RING rows,
    refill 16, lookahead), each mega a replay of its lane's CUDA graph.
    A warm-up run captures the graph; then, every launch counter set to 0
    just before the base run and read just after, the base run's launches
    are reckoned as the counters' rise (the eager encodes) plus each
    capture's recorded launches times its replays in the run, and held to
    the chunks the megas ran. Gates: every answer equals the chunk loop's
    base run (`chunk_base`), without lookahead too, and in a run whose
    host-side programs (encode, wrap, ring push, the replay, the harvest
    copy) run under no_host_sync; the sampled device loop equals the
    sampled chunk loop (`sampled_base`); the multi-lane device loop over
    BUCKETS equals the single lane on the full bucket. Also: requests/s of
    both loops in turns (chunk, device, device, chunk), a profile of each
    over half the requests, host ms of an encode issued behind a ~50 ms
    spin kernel against one mega's device time, capture seconds and pool
    bytes, and requests/s at each DL_KNEE pair."""
    from case_rg_tpu_torch.device import no_host_sync
    from case_rg_tpu_torch.runtime import graphs
    from case_rg_tpu_torch.runtime.continuous import (
        DeviceLane, base as cbase, make_continuous_fns, make_device_loop_fns,
        run_continuous, run_continuous_device, run_continuous_device_multi)
    from case_rg_tpu_torch.kernels import (additive_attention,
                                           copy_argmax, decode_attention,
                                           decoder_stack, encoder_attention)
    counters = (encoder_attention, decoder_stack, copy_argmax,
                decode_attention, additive_attention)
    n = len(caps)
    make_batch = batch_maker(reqs, caps)

    made = []

    def loop_fns(steps=DL_STEPS, k=DL_K, **kw):
        kw.setdefault("fast_argmax", "pallas")
        made.append(make_device_loop_fns(model, T_ANS, steps, k, DL_RING,
                                         device=dev, **kw))
        return made[-1]

    def device(fns, k=n, mb=make_batch, lookahead=True):
        return timed(lambda emit: run_continuous_device(
            items(k), mb, fns, batch_size=B, refill=REFILL, emit=emit,
            max_len=T_ANS, lookahead=lookahead), k)

    chunk_fns = make_continuous_fns(model, T_ANS, CHUNK_STEPS,
                                    fast_argmax="pallas", device=dev)

    def chunk(k=n):
        return timed(lambda emit: run_continuous(
            items(k), make_batch, *chunk_fns, batch_size=B, refill=REFILL,
            emit=emit), k)

    def same_as(got, want, what):
        bad = [i for i in got if not np.array_equal(got[i][0], want[i][0])]
        check(not bad, f"device loop {what}: {len(bad)} answers differ from "
              f"the chunk loop's (first: request {bad[:1]})")

    def with_occupancy(stats, steps=DL_STEPS, k=DL_K):
        rows = B * steps
        return dict(stats, occupancy=stats["steps_served"]
                    / (rows * stats["chunks"]),
                    occupancy_of_megas=stats["steps_served"]
                    / (rows * k * stats["megas"]))

    fns = loop_fns()
    _, warm = device(fns)                          # warm-up: captures
    check(len(fns.captures) == 1, f"device loop: {len(fns.captures)} "
          "captures in the warm-up run")
    cap = fns.captures[0]
    replays0 = cap["replays"]
    for mod in counters:
        mod.LAUNCHES = 0
    got, stats = device(fns)
    rise = graphs.launch_counts()
    replays = cap["replays"] - replays0
    check(len(fns.captures) == 1 and replays == stats["megas"],
          f"device loop: {len(fns.captures)} captures, {replays} replays for "
          f"{stats['megas']} megas")
    launches = {k: rise[k] + cap["launches"][k] * replays for k in rise}
    steps_run = DL_STEPS * DL_K * stats["megas"]
    want = {"fused_mha": MHA_PER_ENCODE * (1 + stats["refills"]),
            "stack_step": steps_run, "combine_copy_mass": steps_run,
            "single_query_mha": 2 * DEC_LAYERS * steps_run,
            "additive_scores": 2 * steps_run}
    check(launches == want and DL_STEPS * stats["chunks"] <= steps_run,
          f"device loop launches {launches}, expected {want} (chunks "
          f"{stats['chunks']})")
    same_as(got, chunk_base, "base")
    res = {"config": {"batch": B, "steps_a_chunk": DL_STEPS,
                      "chunks_a_mega": DL_K, "ring": DL_RING,
                      "refill": REFILL, "lookahead": True},
           "warm_up": warm, "base": dict(with_occupancy(stats),
                                         launches=launches),
           "capture": dict(cap, replays_in_base=replays)}
    got, res["no_lookahead"] = device(fns, lookahead=False)
    same_as(got, chunk_base, "without lookahead")

    # the round's host side waits for nothing (the graph exists already)
    def checked(fn):
        def run(*args, **kw):
            with no_host_sync():
                return fn(*args, **kw)
        return run

    names = ("init_fn", "wrap_fn", "stage_fn", "push_fn", "mega_fn")
    real_copy = cbase.HostCopy.__init__
    for name in names:
        setattr(fns, name, checked(getattr(fns, name)))
    cbase.HostCopy.__init__ = checked(real_copy)
    try:
        got, res["no_host_sync"] = device(fns)
    finally:
        cbase.HostCopy.__init__ = real_copy
        for name in names:
            delattr(fns, name)
    same_as(got, chunk_base, "under no_host_sync")

    # an encode issued while the card is busy returns before the card ends
    bucket = make_batch([{"i": i} for i in range(REFILL)], REFILL)
    fns.init_fn(bucket)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    fns.init_fn(bucket)
    issue_ms = (time.perf_counter() - t0) * 1e3
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    res["encode_behind_spin"] = {
        "host_ms": issue_ms,
        "then_waited_ms": (time.perf_counter() - t1) * 1e3}

    # one mega's device time (a mega runs all its chunks whatever the rows
    # hold, so a replay on a fresh lane state times any mega)
    state, _ = fns.init_fn(make_batch([{"i": i} for i in range(B)], B))
    wrap = fns.wrap_fn(state, np.arange(B), np.ones(B, bool))
    stage = fns.stage_fn(state, np.full(B, -1))
    res["mega_device_ms"] = device_ms(lambda: fns.mega_fn(wrap, stage, 0),
                                      iters=5)
    del state, wrap, stage

    # requests/s in turns: chunk, device, device, chunk
    res["turns"] = []
    for name in ("chunk", "device", "device", "chunk"):
        if name == "chunk":
            got, st = chunk()
            same_as(got, chunk_base, "chunk loop again")
        else:
            got, st = device(fns)
            same_as(got, chunk_base, "again")
        res["turns"].append({"loop": name, "requests_per_s":
                             st["requests_per_s"], "wall_s": st["wall_s"]})
    for name in ("chunk", "device"):
        qps = [t["requests_per_s"] for t in res["turns"] if t["loop"] == name]
        res[f"{name}_requests_per_s"] = float(np.mean(qps))
    res["speedup"] = res["device_requests_per_s"] / res["chunk_requests_per_s"]
    res["profile"] = profile_device(lambda k: device(fns, k=k), [n // 2])
    res["chunk_profile"] = profile_device(lambda k: chunk(k=k), [n // 2])

    # sampled: the sampled chunk loop's answers with the same keys
    sfns = loop_fns(decoding="sample", **SAMPLE_CONTROLS)
    smb = batch_maker(reqs, caps, sample_keys(n))
    device(sfns, mb=smb)
    got, res["sampled"] = device(sfns, mb=smb)
    same_as(got, sampled_base, "sampled")
    res["sampled"]["capture"] = sfns.captures[0]

    # multi-lane over the pool buckets, one DeviceLoopFns for both lanes
    used = (reqs["passage"] != 0).any(-1).sum(-1)
    bucket_batch = {p: batch_maker(dict(reqs, passage=reqs["passage"][:, :p]),
                                   caps) for p in BUCKETS}

    def multi():
        lanes = {p: DeviceLane(p, bucket_batch[p], fns, batch_size=B,
                               refill=REFILL) for p in BUCKETS}
        route = lambda r: lanes[min(p for p in BUCKETS if used[r["i"]] <= p)]
        return timed(lambda emit: run_continuous_device_multi(
            items(n), list(lanes.values()), route, emit=emit, max_len=T_ANS,
            lookahead=True), n)

    multi()                                       # warm-up: the small lane
    got, res["multi_lane"] = multi()
    full = [i for i in range(n) if used[i] > BUCKETS[0]]
    same_as({i: got[i] for i in full}, chunk_base, "multi-lane, full bucket")
    res["multi_lane"]["small_bucket_vs_chunk_base"] = answer_agreement(
        {i: got[i] for i in range(n) if used[i] <= BUCKETS[0]}, chunk_base,
        caps, cfg.eos_id)
    res["multi_lane"]["captures"] = len(fns.captures)

    # the knee: requests/s over (steps a chunk, chunks a mega)
    res["knee"] = []
    for steps, k in DL_KNEE:
        kfns = fns if (steps, k) == (DL_STEPS, DL_K) else loop_fns(steps, k)
        device(kfns)
        got, st = device(kfns)
        same_as(got, chunk_base, f"steps {steps}, K {k}")
        res["knee"].append(dict(with_occupancy(st, steps, k), steps=steps,
                                chunks_a_mega=k,
                                capture_s=kfns.captures[0]["capture_s"]))
    res["pool_bytes"] = [c["pool_bytes"] for f in made for c in f.captures]
    return res


# ---- phase 11: CaSE served from text through cli/serve ----

N_TEXT = 256                   # text requests, from seed 3
TEXT_DIR = os.path.join(ROOT, "build", "text_serving")   # .gitignore: build/
TEXT_CLIENTS, TEXT_LINES = 8, 4    # HTTP: client threads, requests a POST
SPECIAL_WORDS = ("[PAD]", "[unused0]", "[UNK]", "[unused1]", "[SEP]",
                 "[CLS]", "[MASK]")
TEXT_PUNCT = tuple(".,?!;:'()-")
TEXT_PIECES = 4000             # "##" continuation pieces in the vocabulary


def text_vocab(path: str):
    """A vocab.txt of exactly V wordpieces (the specials, punctuation,
    TEXT_PIECES "##" pieces and synthetic words, from seed 0); returns the
    words and the pieces."""
    rng = np.random.RandomState(0)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    pieces, words = set(), set()
    while len(pieces) < TEXT_PIECES:
        pieces.add("##" + "".join(rng.choice(letters, rng.randint(1, 5))))
    n_words = V - len(SPECIAL_WORDS) - len(TEXT_PUNCT) - TEXT_PIECES
    while len(words) < n_words:
        words.add("".join(rng.choice(letters, rng.randint(2, 10))))
    words, pieces = sorted(words), sorted(pieces)
    lines = list(SPECIAL_WORDS) + list(TEXT_PUNCT) + pieces + words
    check(len(lines) == V and len(set(lines)) == V, "text vocab: not V words")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return words, pieces


def text_requests(words, pieces, n: int):
    """``n`` requests from seed 3: a history of 0-2 turns, a query, and 5
    (a third of them) or 10 passages of 3-6 sentences joined by ". ",
    their words drawn from the vocabulary (one in eight glued to a "##"
    piece, which the tokenizer splits again); ``max_tokens`` over 8-40."""
    rng = np.random.RandomState(3)
    words = np.array(words)
    tails = [p[2:] for p in pieces]

    def sent(lo, hi):
        ws = list(rng.choice(words, rng.randint(lo, hi + 1)))
        for i in np.flatnonzero(rng.rand(len(ws)) < 0.125):
            ws[i] += tails[rng.randint(len(tails))]
        return " ".join(ws)

    reqs = []
    for i in range(n):
        n_pass = 5 if i % 3 == 0 else P
        reqs.append({
            "id": f"t{i}",
            "history": [sent(4, 12) + " ?" for _ in range(rng.randint(3))],
            "query": sent(4, 14) + " ?",
            "passages": [". ".join(sent(6, 22) for _ in range(
                rng.randint(3, 7))) + "." for _ in range(n_pass)],
            "max_tokens": int(rng.randint(8, T_ANS + 1))})
    return reqs


def text_responses(chunk, answer, rank, vocab, num_passage):
    """What cli/serve answers for a chunk from its predict outputs (host
    arrays): answers cut at each request's cap and detokenized, passages
    ranked by score."""
    from case_rg_tpu_torch.runtime.io import ids_to_sentence, remove_duplicate
    sents = [ids_to_sentence(row[:max(min(r["max_tokens"], len(row)), 1)],
                             vocab) for row, r in zip(answer, chunk)]
    remove_duplicate(sents)
    out = []
    for r, s, sc in zip(chunk, sents, rank):
        n_real = min(len(r["passages"]), num_passage)
        order = np.argsort(-np.asarray(sc, np.float32)[:max(n_real, 1)],
                           kind="stable")
        out.append({"id": r["id"], "answer": vocab.detokenizer()(s),
                    "ranking": [int(j) for j in order[:n_real]]})
    return out


class DeviceTrace:
    """torch.profiler's device activity (CUPTI) over a block, kept as the
    profiler's raw result: torch.profiler's own exit may build a Python
    record of every event, which took over a minute for the kernels of a
    whole HTTP run on an H100."""

    def __enter__(self):
        from torch.autograd import (ProfilerActivity, _enable_profiler,
                                    _prepare_profiler)
        from torch.autograd.profiler import profile
        config = profile(use_kineto=True).config()
        _prepare_profiler(config, {ProfilerActivity.CUDA})
        _enable_profiler(config, {ProfilerActivity.CUDA})
        return self

    def __exit__(self, *exc):
        from torch.autograd import _disable_profiler
        torch.cuda.synchronize()
        self.events = _disable_profiler().events()
        return False


class TextRun:
    """One in-process run of cli/serve's ``main``: the serving window's
    host seconds (around the offline serving loop, after the checkpoint
    load and the warm-up), launches in the window (counters set to 0 at
    its start; the device loop's graph replays x the launches each capture
    recorded added), host time in ``featurize_requests`` split into the
    tokenizer's batch call and ``data.featurize``, and, with ``profiled``,
    the profiler's device activity over the window."""

    def __init__(self, profiled: bool = False):
        self.fns = []
        self.active = False       # host timers count inside the window only
        self.call_s = None        # the whole main() call
        self.reset(profiled)

    def reset(self, profiled: bool) -> None:
        """Ready for a new window (the spies' captures are kept)."""
        self.profiled = profiled
        self.wall_s = self.launches = self.prof = self.trace_s = None
        self.host = {"featurize_requests": 0.0, "tokenize": 0.0,
                     "featurize": 0.0, "requests": 0}

    def window(self, fn):
        """``fn`` (a serving loop) timed, counted and maybe profiled."""
        from case_rg_tpu_torch.runtime import graphs

        def run(*a, **kw):
            prof = DeviceTrace() if self.profiled else None
            torch.cuda.synchronize()
            for mod in graph_counters():
                mod.LAUNCHES = 0
            replays0 = [c["replays"] for f in self.fns for c in f.captures]
            n_caps = [len(f.captures) for f in self.fns]
            if prof is not None:
                prof.__enter__()
            self.active = True
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                self.wall_s = time.perf_counter() - t0
                self.active = False
                if prof is not None:
                    t1 = time.perf_counter()
                    prof.__exit__(None, None, None)
                    self.prof = prof
                    self.trace_s = time.perf_counter() - t1
                rise = graphs.launch_counts()
                caps = [c for f in self.fns for c in f.captures]
                check([len(f.captures) for f in self.fns] == n_caps,
                      "text serving: a graph was captured inside the window")
                for c, r0 in zip(caps, replays0):
                    for k in rise:
                        rise[k] += c["launches"][k] * (c["replays"] - r0)
                self.launches = rise
        return run

    def timer(self, key, count=False):
        def wrap(fn):
            def timed(*a, **kw):
                if not self.active:
                    return fn(*a, **kw)
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    self.host[key] += time.perf_counter() - t0
                    if count:
                        self.host["requests"] += len(a[0])
            return timed
        return wrap

    def spy_fns(self, make):
        def made(*a, **kw):
            fns = make(*a, **kw)
            self.fns.append(fns)
            return fns
        return made

    def patch(self, stack, offline: bool = True) -> None:
        """Enter the timers and spies on ``stack`` (``mock.patch.object``
        of each wrapped callable); ``offline``: the offline loops' windows too."""
        from unittest import mock
        from case_rg_tpu_torch.cli import serve as cli
        from case_rg_tpu_torch.data import text
        from case_rg_tpu_torch.runtime.continuous import device_loop
        from case_rg_tpu_torch.serving import featurize as sf
        wraps = [(sf, "featurize_requests",
                  self.timer("featurize_requests", count=True)),
                 (sf, "featurize", self.timer("featurize")),
                 (text.WordPieceTokenizer, "batch", self.timer("tokenize")),
                 (device_loop, "make_device_loop_fns", self.spy_fns)]
        if offline:
            wraps += [(cli, "run_offline_batched", self.window),
                      (cli, "run_offline_continuous", self.window)]
        for owner, name, wrap in wraps:
            stack.enter_context(mock.patch.object(
                owner, name, wrap(getattr(owner, name))))

    def report(self, n: int) -> dict:
        h = self.host
        per = 1e3 / max(h["requests"], 1)
        out = {"requests_per_s": n / self.wall_s, "wall_s": self.wall_s,
               "featurize_ms_per_request": {
                   "total": h["featurize_requests"] * per,
                   "tokenize": h["tokenize"] * per,
                   "featurize": h["featurize"] * per,
                   "other": (h["featurize_requests"] - h["tokenize"]
                             - h["featurize"]) * per},
               "featurized_requests": h["requests"],
               "launches": self.launches}
        if self.fns:
            out["captures"] = [dict(c) for f in self.fns for c in f.captures]
        if self.prof is not None:
            t0 = time.perf_counter()
            out["profile"] = profile_window(self.prof.events, self.wall_s)
            out["profile"]["trace_s"] = self.trace_s + time.perf_counter() - t0
        out["call_s"] = self.call_s
        return out


def graph_counters():
    from case_rg_tpu_torch.kernels import (additive_attention, copy_argmax,
                                           decode_attention, decoder_stack,
                                           encoder_attention)
    return (encoder_attention, decoder_stack, copy_argmax, decode_attention,
            additive_attention)


def profile_window(events, wall_s: float) -> dict:
    """Device busy ms and idle share of a profiled window, and its top
    kernels, summed from the profiler's raw device events."""
    from torch.autograd import DeviceType
    by_name = {}
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            ms, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    busy = sum(ms for ms, _ in by_name.values())
    check(busy > 0, "text serving profile: no device time recorded")
    top = sorted(((ms, n, k[:80]) for k, (ms, n) in by_name.items()),
                 reverse=True)[:6]
    return {"wall_ms": wall_s * 1e3, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / (wall_s * 1e3),
            "top_kernels": [{"name": k, "ms": ms, "launches": n}
                            for ms, n, k in top]}


def serve_text_mode(common, extra, out_path, profiled=False):
    """cli/serve ``main`` on the requests file: (responses, TextRun)."""
    from case_rg_tpu_torch.cli.serve import main as serve_main
    run = TextRun(profiled)
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        run.patch(stack)
        serve_main(common + extra + ["--output", out_path])
    run.call_s = time.perf_counter() - t0
    with open(out_path) as f:
        return [json.loads(x) for x in f], run


def serve_text_http(common, extra, reqs, n: int):
    """cli/serve ``main`` with ``--listen`` in a thread; TEXT_CLIENTS client
    threads POST the requests TEXT_LINES to a POST, twice (the second time
    under the profiler), each window on the clients' clock. Returns the
    {id: response} maps of both rounds, the mode's report and /varz after
    the first round."""
    import threading
    import urllib.request
    from case_rg_tpu_torch.cli.serve import main as serve_main
    run = TextRun()
    stack = contextlib.ExitStack()
    run.patch(stack, offline=False)
    holder, ready = {}, threading.Event()

    def on_ready(server):
        holder["server"] = server
        ready.set()

    t0 = time.perf_counter()
    server = threading.Thread(target=serve_main, args=(
        common + extra + ["--listen", "127.0.0.1:0"],),
        kwargs={"_server_ready": on_ready}, daemon=True)
    server.start()
    rounds, reports, errors = [], [], []
    try:
        check(ready.wait(timeout=300), "text serving: server did not come up")
        host, port = holder["server"].server_address[:2]
        base = f"http://{host}:{port}"

        def get(path):
            with urllib.request.urlopen(base + path, timeout=60) as r:
                return r.read().decode()

        check(get("/healthz") == "ok\n", "text serving: /healthz")
        posts = [reqs[i:i + TEXT_LINES]
                 for i in range(0, len(reqs), TEXT_LINES)]

        def client(c, got):
            try:
                for lines in posts[c::TEXT_CLIENTS]:
                    data = "".join(json.dumps(x) + "\n"
                                   for x in lines).encode()
                    rq = urllib.request.Request(base + "/", data=data,
                                                method="POST")
                    with urllib.request.urlopen(rq, timeout=300) as r:
                        for x in r.read().decode().splitlines():
                            resp = json.loads(x)
                            got[resp["id"]] = resp
            except Exception as e:        # reported by the main thread
                errors.append(repr(e))

        def clients(got):
            threads = [threading.Thread(target=client, args=(c, got))
                       for c in range(TEXT_CLIENTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()

        for profiled in (False, True):
            run.reset(profiled)
            rounds.append({})
            run.window(clients)(rounds[-1])
            reports.append(run.report(n))
            if not profiled:
                varz = json.loads(get("/varz"))
    finally:
        if "server" in holder:
            holder["server"].shutdown()
        server.join(timeout=60)
        stack.close()
    check(not server.is_alive(), "text serving: the server did not stop")
    check(not errors, f"text serving: client errors {errors[:3]}")
    report = dict(reports[0], profiled=reports[1],
                  call_s=time.perf_counter() - t0)
    return rounds, report, varz


def same_responses(got, want, what):
    """Token for token (as detokenized) and ranking for ranking."""
    bad = [w["id"] for w, g in zip(want, got) if g != w]
    check(len(got) == len(want) and not bad,
          f"text serving {what}: {len(bad)} of {len(want)} responses differ "
          f"(first: {bad[:3]}), {len(got)} responses")


def serve_text(dev):
    """CaSE served from text (phase 11): a vocabulary of V wordpieces, a
    checkpoint in the port's format, 256 text requests, and cli/serve's
    ``main`` in four modes, each gated as PERF.md section 2 says."""
    import dataclasses
    import shutil
    from case_rg_tpu_torch import native
    from case_rg_tpu_torch.config import DataConfig, ModelConfig
    from case_rg_tpu_torch.data.vocab import Vocabulary
    from case_rg_tpu_torch.models import (build_model_cfg, create_model,
                                          perturb_affine)
    from case_rg_tpu_torch.runtime.continuous import (Lane,
                                                      make_continuous_fns,
                                                      run_continuous_multi)
    from case_rg_tpu_torch.runtime.inference import make_predict_fn
    from case_rg_tpu_torch.serving.featurize import bucket_for, chunk_to_batch
    from case_rg_tpu_torch.train.checkpoint import save_checkpoint

    t_phase = time.perf_counter()
    shutil.rmtree(TEXT_DIR, ignore_errors=True)
    prep, out = os.path.join(TEXT_DIR, "prepared"), os.path.join(TEXT_DIR,
                                                                 "out")
    os.makedirs(prep)
    words, pieces = text_vocab(os.path.join(prep, "vocab.txt"))
    vocab = Vocabulary.load(os.path.join(prep, "vocab.txt"))
    reqs = text_requests(words, pieces, N_TEXT)
    n = len(reqs)
    req_path = os.path.join(TEXT_DIR, "requests.jsonl")
    with open(req_path, "w") as f:
        for r in reqs:
            f.write(json.dumps(r) + "\n")
    cfg = build_model_cfg(ModelConfig(embedding_size=E, hidden_size=E,
                                      num_heads=H, max_target_length=T_ANS,
                                      max_dec_len=T_ANS), "case", vocab)
    model = create_model("case", cfg, device=dev, seed=0)
    perturb_affine(model, torch.Generator(device=dev).manual_seed(1))
    params = dict(model.named_parameters())
    save_checkpoint(out, 0, {"params": params, "ema": params, "step": 0})
    del params
    model = model.to(torch.bfloat16)         # as --bf16 casts at load
    cfg = cfg.replace(param_dtype="bfloat16")
    dcfg = DataConfig(query_len=LQ, passage_len=LP, num_passage=P,
                      answer_len=T_ANS)
    res = {"requests": n, "native_tokenizer": native.available(),
           "setup_s": time.perf_counter() - t_phase}

    # host ms of chunk_to_batch at 16 and 64 rows (median of 3)
    res["chunk_to_batch_ms"] = {}
    for rows in (16, 64):
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            chunk_to_batch(reqs[:rows], "case", vocab, dcfg, rows)
            ts.append((time.perf_counter() - t0) * 1e3)
        res["chunk_to_batch_ms"][rows] = sorted(ts)[1]

    common = ["--model", "case", "--prepared_dir", prep, "--output_path",
              out, "--input", req_path, "--bf16", "--batch_size", str(B),
              "--warmup"]
    modes = {
        "a_batched": [],
        "b_continuous": ["--continuous", "--fast_argmax", "pallas",
                         "--pool_buckets", "5,10"],
        "c_device_loop": ["--continuous", "--device_loop", "8",
                          "--chunk_steps", "4", "--fast_argmax", "pallas",
                          "--pool_buckets", "5,10", "--lookahead"]}
    got, runs = {}, {}
    for name, extra in modes.items():
        path = os.path.join(TEXT_DIR, f"{name}.jsonl")
        got[name], run = serve_text_mode(common, extra, path)
        again, prof = serve_text_mode(common, extra, path, profiled=True)
        same_responses(again, got[name], f"{name}: a second run")
        runs[name] = dict(run.report(n), profiled=prof.report(n),
                          chunk_to_batch_ms=res["chunk_to_batch_ms"],
                          native_tokenizer=res["native_tokenizer"])
        print(f"text serving {name}: " + json.dumps(runs[name]), flush=True)

    # (a) = make_predict_fn on chunk_to_batch of the same requests
    t_ref = time.perf_counter()
    predict = make_predict_fn(model, cfg, T_ANS, early_exit=True, device=dev)
    want = []
    for i in range(0, n, B):
        chunk = reqs[i:i + B]
        o = predict(chunk_to_batch(chunk, "case", vocab, dcfg, B))
        want += text_responses(chunk, o["answer"].cpu().numpy(),
                               o["rank"].float().cpu().numpy(), vocab, P)
    same_responses(got["a_batched"], want, "(a) batched vs make_predict_fn")

    # (b) = run_continuous_multi driven directly on the same batches
    init_fn, chunk_fn, refill_fn = make_continuous_fns(
        model, T_ANS, 8, fast_argmax="pallas", device=dev)
    buckets = [5, P]
    lanes = {k: Lane(k, (lambda dk: lambda c, w: chunk_to_batch(
        c, "case", vocab, dk, w))(dataclasses.replace(dcfg, num_passage=k)),
        init_fn, chunk_fn, refill_fn, B, B // 4) for k in buckets}
    direct = {}
    run_continuous_multi(
        iter(reqs), list(lanes.values()),
        lambda r: lanes[bucket_for(len(r["passages"]), buckets)],
        lambda r, ids, rk: direct.__setitem__(r["id"], text_responses(
            [r], ids[None], rk[None], vocab,
            bucket_for(len(r["passages"]), buckets))[0]))
    same_responses(got["b_continuous"], [direct[r["id"]] for r in reqs],
                   "(b) continuous vs run_continuous_multi")
    # (c) = (b), token for token
    same_responses(got["c_device_loop"], got["b_continuous"],
                   "(c) device loop vs (b)")
    res["references_s"] = time.perf_counter() - t_ref

    # (d) HTTP, 8 clients, lines of 4: every response = (c)'s
    rounds, report, varz = serve_text_http(common, modes["c_device_loop"],
                                           reqs, n)
    for i, http in enumerate(rounds):
        same_responses([http.get(r["id"]) for r in reqs],
                       got["c_device_loop"], f"(d) HTTP round {i} vs (c)")
    check(varz["requests_served"] == n and varz["errors"] == 0,
          f"text serving (d): /varz {varz}")
    runs["d_http"] = dict(report, chunk_to_batch_ms=res["chunk_to_batch_ms"],
                          native_tokenizer=res["native_tokenizer"],
                          varz={k: varz[k] for k in (
                              "requests_served", "batches", "errors",
                              "request_latency_s") if k in varz})
    print("text serving d_http: " + json.dumps(runs["d_http"]), flush=True)

    # every serving kernel of a mode launched in its window, in the counts
    # its decode steps give: a step launches combine_copy_mass once in the
    # pallas modes, additive_scores twice and single_query_mha 8 times (the
    # query-memory stack); on the 1000-position pool stack_step once, on
    # the 5-passage lane's 500 positions (under the fused stack's 512)
    # single_query_mha 8 times more instead; fused_mha 19 times an encode
    for name, r in runs.items():
        n = r["launches"]
        steps = n["stack_step"] if name == "a_batched" else \
            n["combine_copy_mass"]
        chain = steps - n["stack_step"]
        check(steps > 0 and n["stack_step"] > 0 and chain >= 0
              and (chain > 0) == (name != "a_batched")
              and n["single_query_mha"] == 2 * DEC_LAYERS * (steps + chain)
              and n["additive_scores"] == 2 * steps
              and n["fused_mha"] > 0 and n["fused_mha"] % MHA_PER_ENCODE == 0,
              f"text serving {name}: launches {n}")
    shutil.rmtree(TEXT_DIR, ignore_errors=True)
    res["modes"] = runs
    res["phase_s"] = time.perf_counter() - t_phase
    return res


# ---- phase 8: training ----

VARIANTS = {"mask": False, "rng": True}     # kernel variant -> in-kernel RNG


def train_mha_inputs(r, lq, lk, e, gen, dev):
    q = torch.randn(r, lq, e, generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(r, lk, e, generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    lengths = torch.randint(lk // 3, lk + 1, (r,), generator=gen, device=dev)
    keep = torch.arange(lk, device=dev)[None, :] < lengths[:, None]
    keep[:2] = False                       # rows whose keys are all padding
    do = torch.randn(r, lq, e, generator=gen, device=dev).to(torch.bfloat16)
    return q, k, v, keep, do


def check_and_time_train_mha(dev, gen):
    """Each training-attention kernel (forward and backward, both variants)
    against its plain version at each site of a train step; times and
    bounds summed over one step's sites."""
    from case_rg_tpu_torch.kernels import train_attention as ta
    from case_rg_tpu_torch.ops.dropout import keep_mask
    names = [f"{v}_{w}" for v in VARIANTS for w in ("fwd", "bwd")]
    total = {n: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0,
                 "flops": 0, "max_abs_err": 0.0, "max_ulps": 0.0}
             for n in names}
    rows = []
    for (r, lq, lk, e), count in TRAIN_SITES.items():
        d = e // H
        q, k, v, keep, do = train_mha_inputs(r, lq, lk, e, gen, dev)
        valid = int(keep.sum().item())
        lib_keep = keep.clone()
        lib_keep[:, 0] = True              # SDPA gives NaN on empty rows
        qh, kh, vh, doh = (x.view(x.shape[0], -1, H, d).transpose(1, 2)
                           for x in (q, k, v, do))
        lib_fwd = device_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=lib_keep[:, None, None, :], dropout_p=RATE))
        xs = [x.detach().clone().requires_grad_() for x in (qh, kh, vh)]
        lib_out = F.scaled_dot_product_attention(
            *xs, attn_mask=lib_keep[:, None, None, :], dropout_p=RATE)
        lib_bwd = device_ms(lambda: torch.autograd.grad(lib_out, xs, doh,
                                                        retain_graph=True))
        for variant, rng in VARIANTS.items():
            if rng:
                src = torch.tensor([0x243F6A88, r + lk], dtype=torch.int64,
                                   device=dev)
                mask = ta.philox_keep_mask(src, r, H, lq, lk, RATE)
                fn = ta.fused_train_mha_rng
            else:
                src = mask = keep_mask((r, H, lq, lk), RATE, gen, dev)
                fn = ta.fused_train_mha
            outs = []
            for _ in range(2):             # twice: the same bits each time
                xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
                out = fn(*xs, keep, src, H, RATE)
                outs.append([out.detach(),
                             *torch.autograd.grad(out, xs, do)])
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(*outs)),
                  f"train_mha {variant} {(r, lq, lk, e)}: two launches differ")
            ref = ta.fused_train_mha_plain(q, k, v, keep, mask, H, RATE)
            ref_g = ta.fused_train_mha_plain_bwd(q, k, v, keep, mask, do, H,
                                                 RATE)
            f_ulps, f_err = bf16_ulps(outs[0][0], ref)
            g_read = [bf16_ulps(g, rg) for g, rg in zip(outs[0][1:], ref_g)]
            g_ulps = max(u for u, _ in g_read)
            g_err = max(x for _, x in g_read)
            site = (r, lq, lk, e)
            check(f_ulps <= TRAIN_FWD_ULPS,
                  f"train_mha {variant} {site}: forward {f_ulps} bf16 ulps > "
                  f"{TRAIN_FWD_ULPS}")
            check(g_ulps <= TRAIN_GRAD_ULPS,
                  f"train_mha {variant} {site}: gradients {g_ulps} bf16 ulps "
                  f"> {TRAIN_GRAD_ULPS}")
            check(all(bool((x[:2] == 0).all()) for x in outs[0]),
                  f"train_mha {variant} {site}: all-padding rows not 0")
            _, stats = ta._launch_fwd(q, k, v, keep, src, H, RATE, rng)
            ms_f = device_ms(lambda: ta._launch_fwd(q, k, v, keep, src, H,
                                                    RATE, rng))
            ms_b = device_ms(lambda: ta._launch_bwd(q, k, v, keep, src, do,
                                                    stats, H, RATE, rng))
            plain_mask = ((lambda: ta.philox_keep_mask(src, r, H, lq, lk,
                                                       RATE)) if rng
                          else (lambda: src))
            plain_f = time_ms(lambda: ta.fused_train_mha_plain(
                q, k, v, keep, plain_mask(), H, RATE), iters=5)
            plain_b = time_ms(lambda: ta.fused_train_mha_plain_bwd(
                q, k, v, keep, plain_mask(), do, H, RATE), iters=5)
            src_bytes = nbytes(src)
            io = nbytes(q, k, v, keep) + src_bytes
            readings = {
                "fwd": (ms_f, plain_f, lib_fwd, io + nbytes(q),
                        4 * lq * d * H * valid, f_err, f_ulps),
                "bwd": (ms_b, plain_b, lib_bwd, io + nbytes(do, q, k, v),
                        10 * lq * d * H * valid, g_err, g_ulps)}
            for way, (ms, pl, lib, nb, nf, err, ulps) in readings.items():
                t = total[f"{variant}_{way}"]
                t["ms"] += count * ms
                t["plain_ms"] += count * pl
                t["library_ms"] += count * lib
                t["bytes"] += count * nb
                t["flops"] += count * nf
                t["max_abs_err"] = max(t["max_abs_err"], err)
                t["max_ulps"] = max(t["max_ulps"], ulps)
                rows.append({"kernel": f"{variant}_{way}", "rows": r, "Lq": lq,
                             "Lk": lk, "E": e, "sites": count, "ms": ms,
                             "plain_ms": pl, "library_ms": lib,
                             "bound_ms": bound_ms(nb, nf)[0],
                             "max_ulps": ulps, "max_abs_err": err})
    for t in total.values():
        t["bound_ms"], t["bound_by"] = bound_ms(t["bytes"], t["flops"])
    return total, rows


# the probe's sites: the short path (d = 32 and d = 160) and the long path
PROBE_SITES = ((B * P, LP, LP, E), (B, LQ, LQ, 5 * E), (B, T_ANS, P * LP, E))


def probe_rng_mask(dev, r, lq, lk, e):
    """The in-kernel mask at a site, recovered as the JAX package's test
    does: q = k = 0 makes the probabilities uniform, and v's lanes of each
    head are basis vectors over a chunk of d keys, so the output lanes are
    the dropped probabilities of those keys. It must equal philox_keep_mask
    bit for bit, and keep 1 - RATE of the elements."""
    from case_rg_tpu_torch.kernels import train_attention as ta
    d = e // H
    seed = torch.tensor([0x9E3779B9, 7], dtype=torch.int64, device=dev)
    z = torch.zeros(r, lq, e, dtype=torch.bfloat16, device=dev)
    zk = torch.zeros(r, lk, e, dtype=torch.bfloat16, device=dev)
    got = torch.empty(r, H, lq, lk, dtype=torch.bool, device=dev)
    for c0 in range(0, lk, d):
        n = min(d, lk - c0)
        v = torch.zeros(r, lk, e, dtype=torch.bfloat16, device=dev)
        for h in range(H):
            v[:, c0:c0 + n, h * d:h * d + n] = torch.eye(n, device=dev)
        out = ta.fused_train_mha_rng(z, zk, v, None, seed, H, RATE)
        for h in range(H):
            got[:, h, :, c0:c0 + n] = out[:, :, h * d:h * d + n] != 0
    want = ta.philox_keep_mask(seed, r, H, lq, lk, RATE)
    site = (r, lq, lk, e)
    check(torch.equal(got, want), f"probe {site}: the kernel's mask is not "
          f"philox_keep_mask ({int((got != want).sum())} elements differ)")
    share = got.float().mean().item()
    check(abs(share - (1 - RATE)) <= KEEP_SHARE_TOL,
          f"probe {site}: keep share {share}, expected {1 - RATE}")
    return {"site": site, "path": ta.train_mha_plan(lq, lk, d)["path"]["fwd"],
            "keep_share": share, "elements": got.numel()}


def _kernel_name(mangled: str) -> str:
    """A kernel's mangled name as name<template args>, nested names joined
    by '::' (the anonymous namespace left out)."""
    import re
    s = mangled[3:] if mangled.startswith("_ZN") else mangled
    parts, i = [], 0
    while i < len(s) and s[i].isdigit():
        j = i
        while s[j].isdigit():
            j += 1
        n = int(s[i:j])
        parts.append(s[j:j + n])
        i = j + n
    args = re.findall(r"L[ib](\d+)E", s[i:]) if s[i:i + 1] == "I" else []
    name = "::".join(p for p in parts if not p.startswith("_GLOBAL__N"))
    return f"{name}<{','.join(args)}>" if args else name


def kernel_instances(log: str):
    """Registers and spills of each kernel instance in a ptxas -v log:
    [{"kernel": "fwd_short<32,4,1>", "registers": n, "spill_stores": b,
    "spill_loads": b}, ...]."""
    import re
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"kernel": _kernel_name(m.group(1))}
            out.append(cur)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    return out


def check_no_spills(instances, what):
    check(len(instances) > 0 and all(
        x.get("spill_stores", 1) == 0 and x.get("spill_loads", 1) == 0
        for x in instances), f"{what}: ptxas reports spills (or no report)")


def train_mha_plans():
    """Each site's launches from train_mha_plan, per variant."""
    from case_rg_tpu_torch.kernels import train_attention as ta
    rows = []
    for (r, lq, lk, e) in TRAIN_SITES:
        for variant, rng in VARIANTS.items():
            plan = ta.train_mha_plan(lq, lk, e // H, rng)
            rows.append({"site": (r, lq, lk, e), "variant": variant,
                         "path": plan["path"],
                         "launches": [ln._asdict() for ln in
                                      plan["fwd"] + plan["bwd"]]})
    return rows


class _PlainTrainMHA(torch.autograd.Function):
    """The training attention with the kernels' plain versions as forward
    and backward (same rounding points), for the swapped-in runs."""

    @staticmethod
    def forward(ctx, q, k, v, keep, mask, num_heads, rate):
        from case_rg_tpu_torch.kernels import train_attention as ta
        ctx.save_for_backward(q, k, v, keep, mask)
        ctx.num_heads, ctx.rate = num_heads, rate
        return ta.fused_train_mha_plain(q, k, v, keep, mask, num_heads, rate)

    @staticmethod
    def backward(ctx, do):
        from case_rg_tpu_torch.kernels import train_attention as ta
        q, k, v, keep, mask = ctx.saved_tensors
        grads = ta.fused_train_mha_plain_bwd(q, k, v, keep, mask, do,
                                             ctx.num_heads, ctx.rate)
        return (*grads, None, None, None, None)


def plain_mha(q, k, v, keep, mask, num_heads, rate):
    return _PlainTrainMHA.apply(q, k, v, keep, mask, num_heads, rate)


def plain_mha_rng(q, k, v, keep, seed, num_heads, rate):
    from case_rg_tpu_torch.kernels import train_attention as ta
    mask = ta.philox_keep_mask(seed, q.shape[0], num_heads, q.shape[1],
                               k.shape[1], rate)
    return _PlainTrainMHA.apply(q, k, v, keep, mask, num_heads, rate)


class _PlainAdditive(torch.autograd.Function):
    """additive_scores with its plain versions as forward and backward
    (same rounding points), for the swapped-in runs."""

    @staticmethod
    def forward(ctx, wq, uh, v):
        from case_rg_tpu_torch.kernels import additive_attention as aa
        ctx.save_for_backward(wq, uh, v)
        return aa.additive_scores_plain(wq, uh, v)

    @staticmethod
    def backward(ctx, g):
        from case_rg_tpu_torch.kernels import additive_attention as aa
        return aa.additive_scores_plain_bwd(*ctx.saved_tensors, g)


def make_train_batch(rng):
    """A served batch plus what training reads: a response of variable
    length and the passage and token labels."""
    bt = make_batch(rng)
    resp = rng.randint(4, V, size=(B, T_ANS)).astype(np.int32)
    for i, n in enumerate(rng.randint(T_ANS // 4, T_ANS + 1, size=B)):
        resp[i, n:] = 0
    bt["response"] = resp
    bt["passage_label"] = rng.randint(0, P, size=B).astype(np.int32)
    bt["token_label"] = ((rng.rand(B, P, LP) < 0.1)
                         & (bt["passage"] != 0)).astype(np.float32)
    bt["token_weight"] = (1 + rng.rand(B, P, LP)).astype(np.float32)
    return bt


def train_case(dev):
    from case_rg_tpu_torch.config import ModelConfig, TrainConfig
    from case_rg_tpu_torch.kernels import additive_attention as aa
    from case_rg_tpu_torch.kernels import train_attention as ta
    from case_rg_tpu_torch.models import create_model, perturb_affine
    from case_rg_tpu_torch.ops import attention, bilinear
    from case_rg_tpu_torch.train.trainer import Trainer

    cfg = ModelConfig(name="case", vocab_size=V, embedding_size=E,
                      hidden_size=E, num_heads=H, enc_layers=ENC_LAYERS,
                      dec_layers=DEC_LAYERS, max_dec_len=T_ANS,
                      max_target_length=T_ANS, dropout=RATE,
                      param_dtype="float32")
    tc = TrainConfig(batch_size=B, learning_rate=2.5e-4, warmup_steps=1,
                     compute_dtype="bfloat16")
    model = create_model("case", cfg, device=dev, seed=0)
    perturb_affine(model, torch.Generator(device=dev).manual_seed(1))
    init = {k: v.detach().clone() for k, v in model.named_parameters()}
    trainer = Trainer(model, tc, total_steps=1000, device=dev)
    rng = np.random.RandomState(1)
    batch = make_train_batch(rng)

    def fresh():
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(init[k])
        return trainer.init_state(), torch.Generator(device=dev).manual_seed(7)

    def routed(variant, plain):
        """Route the training sites to ``variant``'s kernels, or to their
        plain versions (same dropout draws from the generator); the copy
        attention's scores to additive_scores' kernels or to their plain
        versions."""
        attention.set_fused_train_attn_rng(VARIANTS[variant])
        attention.fused_train_mha = plain_mha if plain else ta.fused_train_mha
        attention.fused_train_mha_rng = (plain_mha_rng if plain
                                         else ta.fused_train_mha_rng)
        bilinear.additive_scores = (_PlainAdditive.apply if plain
                                    else aa.additive_scores)

    out = {}
    try:
        for variant in VARIANTS:
            first = {}
            for route in ("kernels", "plain"):
                routed(variant, route == "plain")
                st, gen = fresh()
                losses, grads = trainer.loss_and_grads(st, batch, gen)
                flat = torch.cat([g.float().flatten() for g in grads.values()])
                first[route] = (losses["total"].item(), flat)
            (lk_, gk), (lp, gp) = first["kernels"], first["plain"]
            cosine = F.cosine_similarity(gk, gp, dim=0).item()
            check(abs(lk_ - lp) <= FIRST_LOSS_RTOL * abs(lp),
                  f"train {variant}: first loss {lk_} vs plain {lp}")
            check(cosine >= FIRST_GRAD_COSINE,
                  f"train {variant}: first gradient cosine {cosine}")
            res = {"first_loss": lk_, "first_loss_plain": lp,
                   "first_loss_rel_diff": abs(lk_ - lp) / abs(lp),
                   "first_grad_cosine": cosine}
            for route in ("kernels", "plain"):
                routed(variant, route == "plain")
                st, gen = fresh()
                torch.cuda.synchronize()
                ta.LAUNCHES_FWD[variant] = ta.LAUNCHES_BWD[variant] = 0
                aa.LAUNCHES = aa.LAUNCHES_BWD = 0
                losses, norms, times = [], [], []
                for step in range(TRAIN_STEPS):
                    t0 = time.perf_counter()
                    o = trainer.train_step(st, batch, gen)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                    losses.append(o["total"].item())
                    norms.append(o["grad_norm"].item())
                launches = (ta.LAUNCHES_FWD[variant], ta.LAUNCHES_BWD[variant])
                add_launches = (aa.LAUNCHES, aa.LAUNCHES_BWD)
                check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
                      f"train {variant} {route}: losses {losses}, gradient "
                      f"norms {norms}")
                check(losses[-1] < losses[0],
                      f"train {variant} {route}: loss did not fall: {losses}")
                want = (0, 0) if route == "plain" else \
                    (TRAIN_SITES_PER_STEP * TRAIN_STEPS,) * 2
                check(launches == want, f"train {variant} {route}: launches "
                      f"{launches}, expected {want}")
                # the copy attention over both memories, forward and
                # backward, every step
                want = (0, 0) if route == "plain" else (2 * TRAIN_STEPS,) * 2
                check(add_launches == want, f"train {variant} {route}: "
                      f"additive_scores launches {add_launches}, expected "
                      f"{want}")
                res[route] = {"losses": losses, "grad_norms": norms,
                              "ms_per_step": times[TRAIN_WARMUP:],
                              "launches": launches,
                              "additive_launches": add_launches}
            out[variant] = res
        routed("rng", False)
        st, gen = fresh()
        out["profile_rng"] = profile_device(
            lambda bt: trainer.train_step(st, bt, gen), [batch] * 2)
        # a train step (in-kernel dropout) on a batch already on the card,
        # under no_host_sync: any operation that makes the host wait raises
        from case_rg_tpu_torch.device import batch_to_device, no_host_sync
        on_card = batch_to_device(batch, dev)
        with no_host_sync():
            o = trainer.train_step(st, on_card, gen)
        check(bool(torch.isfinite(o["total"])), "sync check: train step loss")
        out["sync_check"] = "train step under no_host_sync"
    finally:
        routed("rng", False)
    return out


def train_attention_phase(dev, gen, instances):
    """The training-attention kernels against their plain versions and
    timed at every site, the mask probes, and no spill in any kernel
    instance (``instances``: kernel_instances of the build log)."""
    tmha, tmha_rows = check_and_time_train_mha(dev, gen)
    print("train attention sites: " + json.dumps(tmha_rows), flush=True)
    print("train attention: " + json.dumps(tmha), flush=True)
    for site in PROBE_SITES:
        print("train attention probe: " + json.dumps(probe_rng_mask(dev,
                                                                    *site)),
              flush=True)
    check_no_spills(instances, "train attention")
    return tmha


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
    phase_build = start_stack_phase_build(_build)
    phase_builds = {n: start_phase_build(_build, n)
                    for n in ("decode_attention", "copy_argmax",
                              "additive_attention")}
    try:
        logs = _build.build_all()
    finally:            # nvcc of the phase builds ends here, whatever happens
        for proc, _, _ in (phase_build, *phase_builds.values()):
            proc.communicate()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "ptxas info" in line and ("Compiling" in line or "Used" in line):
                print(f"  {name}: {line.split(':', 1)[1].strip()}")

    gen = torch.Generator(device=dev).manual_seed(0)
    instances = kernel_instances(logs["train_attention"])
    print("train attention instances: " + json.dumps(instances), flush=True)
    serving = {n: kernel_instances(logs[n])
               for n in ("encoder_attention", "decoder_stack",
                         "decode_attention", "copy_argmax",
                         "additive_attention")}
    print("serving kernel instances: " + json.dumps(serving), flush=True)
    for n, inst in serving.items():
        check_no_spills(inst, n)
    print("train attention plans: " + json.dumps(train_mha_plans()),
          flush=True)
    mha, mha_rows = check_and_time_mha(dev, gen)
    print("fused_mha sites: " + json.dumps(mha_rows), flush=True)
    stack = check_and_time_stack(dev)
    print("stack_step: " + json.dumps(stack), flush=True)
    print("stack_step phases: " + json.dumps(stack_phases(
        dev, phase_build, [(what, b) for what, b, _ in STACK_SHAPES])),
        flush=True)
    sq, sq_rows = check_and_time_single_query(
        dev, gen, phase_builds["decode_attention"])
    print("single_query_mha: " + json.dumps(sq_rows), flush=True)
    print("single_query_mha per predict: " + json.dumps(sq), flush=True)
    add_fwd, add_bwd, add_rows, sfu = check_and_time_additive(
        dev, gen, phase_builds["additive_attention"])
    print(f"additive_scores (tanh bound at {sfu:.4g}/s): "
          + json.dumps(add_rows), flush=True)
    print("additive_scores totals: " + json.dumps(
        {"fwd_per_predict": add_fwd, "bwd_per_train_step": add_bwd}),
        flush=True)
    cfg, model = serving_model(dev)
    serve = serve_case(dev, cfg, model)
    print("case serving: " + json.dumps(serve), flush=True)
    print("sync check: " + json.dumps(sync_check_serving(dev, cfg, model)),
          flush=True)
    reqs, caps = make_requests(np.random.RandomState(3), N_REQUESTS)
    combine, combine_by_ls = check_and_time_combine(
        dev, reqs, phase_builds["copy_argmax"])
    print("combine_copy_mass: " + json.dumps(combine), flush=True)
    print("combine_copy_mass by_ls: " + json.dumps(combine_by_ls), flush=True)
    modes = serve_argmax_modes(dev, cfg, model, reqs)
    print("argmax modes: " + json.dumps(modes), flush=True)
    cont, cont_base = serve_continuous(dev, cfg, model, reqs, caps)
    print("continuous serving: " + json.dumps(cont), flush=True)
    decoding = serve_decoding(dev, cfg, model, reqs)
    print("beam and sampling: " + json.dumps(decoding), flush=True)
    sampled, sampled_base = serve_continuous_sampled(dev, cfg, model, reqs,
                                                     caps)
    print("sampled continuous serving: " + json.dumps(sampled), flush=True)
    dloop = serve_device_loop(dev, cfg, model, reqs, caps, cont_base,
                              sampled_base)
    print("device-loop serving: " + json.dumps(dloop), flush=True)
    text = serve_text(dev)
    print("text serving: " + json.dumps({k: v for k, v in text.items()
                                          if k != "modes"}), flush=True)
    tmha = train_attention_phase(dev, gen, instances)
    train = train_case(dev)
    print("case training: " + json.dumps(train), flush=True)

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
    replaces = {"mask_fwd": ("fused_train_mha", 188),
                "mask_bwd": ("fused_train_mha_bwd", 222),
                "rng_fwd": ("fused_train_mha_rng", 470),
                "rng_bwd": ("fused_train_mha_rng_bwd", 498)}
    for key, (name, line) in replaces.items():
        variant, way = key.split("_")
        t = tmha[key]
        launches = train[variant]["kernels"]["launches"][way == "bwd"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "case_rg_tpu_torch/csrc/train_attention.cu",
            "replaces": f"case_rg_tpu/kernels/train_attention.py:{line}",
            "launches": launches, "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    c = combine[0]                      # the decode's shape
    kernels.append({
        "name": "combine_copy_mass", "route": "cuda",
        "source": "case_rg_tpu_torch/csrc/copy_argmax.cu",
        "replaces": "case_rg_tpu/kernels/copy_argmax.py:153",
        "launches": cont["base"]["launches"]["combine_copy_mass"],
        "max_abs_err": max(r["max_abs_err"] for r in combine),
        "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
        "bound_by": c["bound_by"], "library_ms": c["library_ms"]})
    kernels.append({
        "name": "single_query_mha", "route": "cuda",
        "source": "case_rg_tpu_torch/csrc/decode_attention.cu",
        "replaces": "case_rg_tpu/kernels/decode_attention.py:94",
        "launches": serve["launches"]["single_query_mha"],
        **{k: sq[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms")}})
    for name, t, launches, line in (
            ("additive_scores", add_fwd,
             serve["launches"]["additive_scores"], 83),
            ("additive_scores_bwd", add_bwd,
             train["rng"]["kernels"]["additive_launches"][1], 95)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "case_rg_tpu_torch/csrc/additive_attention.cu",
            "replaces": f"case_rg_tpu/kernels/additive_attention.py:{line}",
            "launches": launches,
            **{k: t[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")}})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
