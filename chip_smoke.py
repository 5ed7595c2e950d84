#!/usr/bin/env python3
"""Chip smoke run of case_rg_tpu_torch, the PyTorch/CUDA port, on one NVIDIA
card.

    python3 chip_smoke.py        # from the repository root; needs one card
    python3 chip_smoke.py --only-replicas   # phase 17 alone (several cards)
    python3 chip_smoke.py --only-pool       # phase 18 alone (several cards)

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
     modes, all with --bf16, B=64 and --warmup (the device loop run twice,
     the second under torch.profiler, its answers equal to the first's):
     (a)
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
     bits), runs 6 steps on one repeated batch with the kernels (launch
     counters set to 0 just before, read just after; the loss must fall),
     the same 6 steps with the plain versions, profiles two steps with
     torch.profiler, and runs one step under no_host_sync;
 13. takes CaSE from raw files through the port's entry points ("raw
     files"): writes raw CAsT-format TSVs from seed 5 (512 / 128 / 128
     train / dev / test queries in topics of 8 turns, 3000 passages of
     60-150 words from phase 11's 30522-wordpiece vocabulary, pools of 100
     candidates), runs ``cli/prepare`` on them in a process of its own
     (``--vocab_file``, ``--workers 3``), then ``cli/run --multihost
     --mode train --bf16_train --checkpoint_every_steps 3`` (B=64,
     dropout 0.1) under torchrun, a world of one over NCCL, whose rank it
     sends SIGTERM once epoch 1's first mid-epoch checkpoint is on disk
     (exit 0, ``1.preempt.pt`` written, ``0.mid.pt`` and ``1.mid.pt`` too,
     ``latest.json`` still at epoch 0); epoch 0 of it must equal the same
     cli/run without ``--multihost`` in process (stopped at epoch 1's
     first boundary) bit for bit: the checkpoint, the epoch's last losses,
     the dev loss (phase 13b); in process it
     resumes the run (the
     restored parameters, EMA, Adam moments and counts equal epoch 0's
     checkpoint bit for bit) for epochs 1-3 with every step under
     no_host_sync, one more epoch with ``--no-kernel_rng_dropout`` and one
     under ``--profile_dir``; each run's training-attention and
     additive_scores launches are counted (27 + 27 and 2 + 2 a step, of
     the variant the flags select); every loss finite, the last epoch's
     mean loss below the first's, ``best.json`` at the lowest dev total.
     ``--mode avg`` must write the mean of the last three epochs;
     ``--mode test --bf16_eval`` on epoch 0 and ``--avg_only`` must
     write what ``make_predict_fn`` on the prepared batches gives (and
     ``--multihost`` in process, a world of one over NCCL, epoch 0's files
     byte for byte), the
     average through ``--continuous --fast_argmax pallas`` what
     ``run_continuous`` driven directly gives, and through ``--device_loop
     8 --chunk_steps 4 --lookahead`` what the chunk loop gave;
     ``cli/evaluate`` must report finite MAP, NDCG, recall, ROUGE, BLEU and
     METEOR for every result. It prints the prepare seconds and shapes, ms
     per train step inside ``fit`` beside phase 12's bare step, the idle
     share and top kernels of the profiled epoch, dev-evaluation ms,
     checkpoint write and load seconds and bytes, the batch's
     host-to-device copy from pageable and from pinned memory, test
     samples/s and the phase's seconds;
13b. data-parallel training and testing ("data-parallel training and
     testing", on phase 13's raw files, which are removed after it): two
     ranks of ``cli/run --multihost`` under torchrun (NCCL with two cards;
     on one card gloo, if a gloo world of one takes CUDA tensors here, else
     the phase says why and runs phase 13's world of one alone). Training,
     one epoch at B=64 a rank (global batch 128), bf16, profiled: the
     epoch's last losses within FIRST_LOSS_RTOL (and whether bit for bit)
     of one process stepping as the group does
     (``dp_emulate``: each rank's batch through its own generator, the
     denominators summed, the gradients summed, no collective), the
     replicas bit-identical (the trainer's checksum at the checkpoint),
     the dev loss within 1e-5 of one process's at B=128 on the same
     checkpoint; testing with ``--bf16_eval``: the ranks' shards merged
     hold one process's lines. Prints, for one rank, ms a step with and
     without the collectives, the collectives' ms, device busy ms and idle
     share, the training kernels' launches, and the reduced bytes a step;
 14. serves and trains the other five models ("other models"): Masque,
     S2SA, GTTP, GLKS and TMemNet, each at the serving widths (V=30522,
     E = H = 256, 8 heads; Masque 3 encoder and 2x4 decoder layers,
     TMemNet 8 + 8, the GRU models their JAX defaults; bf16 weights from
     seed 0 with noisy biases and gains) on CAsT shapes (query or context
     60, a pool of 10x100 or its 1000 positions as background, 40-step
     decode, B=64; phase 7's requests in each model's fields). Per model:
     (a) a greedy batch through make_predict_fn, every launch counter
     set to 0 just before and read just after and held to the model's
     launches (OTHER_LAUNCHES), then the same batches with each kernel's
     wrapper swapped for its plain version (answers gated as in phase 4,
     beside the exact-f64-sum witness of the encoder attention and of the
     copy attentions; rank scores within RANK_ULPS), ms per encode, the
     additive sites sent dense (ops/bilinear.DENSE_SITES) and a profiled
     batch; (b) a rank-only batch (masque, tmemnet); (c) beam width 4 and
     sampling at top_k=1 (gated against greedy); (f) masque, gttp and glks
     in the pallas argmax mode (combine_copy_mass launches a step; gated
     against its plain version and against dense); (d) 80 requests through
     the chunk loop (batch 64, refill 16, chunks of 8; equal to the
     one-shot greedy answers token for token) and the device loop (4 steps a chunk, 8 chunks a mega,
     a ring of 256, lookahead; equal to the chunk loop token for token,
     launches reckoned from the capture); (e) bf16 training over f32
     masters: the first step's loss and gradient against the plain
     versions, 3 steps on one batch, GLKS 6, the last under no_host_sync
     (the loss without dropout must fall; the training attention's and
     additive_scores' launches counted). A line per model, then the
     phase's summary;
 15. exports and routes ("export and multi-model serving"): (a)
     cli/export_model of CaSE at the serving widths (--bf16, B=64,
     --check) from a checkpoint in the port's format (phase 11's text
     setup), greedy and --rank_only: export, save and load seconds, the
     archive's MB and the custom ops in its graph; --fast_argmax pallas
     traced in process (export_predict, not saved); on two B=64 batches of
     text requests each program against the live fixed-trip predict:
     outputs equal bit for bit, each kernel's launches a batch equal and
     as EXPORT_VARIANTS says, ms a batch by the host clock and device busy
     ms of each; (b) cli/serve
     --from_export on the 256 text requests equal to cli/serve
     --no-early_exit from the checkpoint, requests/s of both; (c)
     cli/serve_multi with a CaSE and a Masque backend (ROUTER_FLAGS: bf16,
     device loop, pallas, pool buckets, lookahead, passed through after
     --), 8 clients POSTing the 256 requests, half routed to each: every
     response equal to that backend's alone through cli/serve, a streamed
     request, /healthz and /varz; requests/s through the router and of
     each backend alone;
 16. training options and early-exit export: (a) CaSE at the serving
     widths (B=64, dropout 0.1, bf16 over f32 masters, the in-kernel-RNG
     training attention) takes a step from the same parameters and
     generator seed under each of TRAIN_OPTIONS (the default,
     --seeded_dropout, --remat dots, dots_batch, nothing): the loss equal
     to the default's bit for bit, gradient cosine >= FIRST_GRAD_COSINE
     and the largest difference, the training kernels' launches (remat
     runs each forward twice), ms a step by the host clock, device busy
     ms, and peak allocated memory over the timed steps; then the
     default's step with bf16 attention scores (the DENSE_ATTEND dense
     attend calls of the step take bf16 scores; loss finite and within
     BF16_SCORES_LOSS_RTOL of the default's f32-score loss; gradients
     different from the default's at cosine >= BF16_SCORES_GRAD_COSINE;
     ms, peak memory) and a --remat dots step under no_host_sync; (b), run
     inside
     phase 15 on its CaSE and its two B=64 batches of text requests: the
     early-exit decode (a while_loop) exported in process with
     --fast_argmax pallas against the live early-exit predict (outputs
     equal bit for bit, launches a batch equal, per step run), export s,
     graph nodes, the steps run, ms a batch and device busy ms beside the
     fixed-trip pallas program of 15 (a); then, with the EOS logit pushed
     (EOS_PUSHES) until every row of a batch ends before T_ANS, both
     programs again on that batch against their live predicts (the
     early-exit one's steps run below T_ANS, gated), and the loop body's
     copies of the carried caches (bytes and µs a step);
 17. serves and tests over several replicas ("serving over cards", after
     phase 13b, on phases 4-11's model, requests and one-card runs and
     phases 11 and 13's files, which are removed after it;
     runtime/replicas.py): two replicas on cuda:0 (two threads, a stream
     each), and with more cards also one a card (cuda:0,cuda:1; four with
     four). (a) make_replicated_predict greedy dense and pallas, sampled,
     beam 4 and rank-only on a B=64 batch: each replica's rows equal one
     replica's predict on its row block bit for bit (a sampled call's keys
     drawn once for the batch), each kernel's launches the blocks' sum, the
     merged batch against one card at the serving gates (the token gates
     for every mode with answers); requests/s and device busy/idle share
     of one replica against the replicas, in turns; the host threads' CPU
     ms against the wall ms, of one replica and of the replicas; the card
     guard's host µs a launch;
     (b) the first 256 of phase 7's continuous requests over the replicas
     (a loop a replica at B/d rows, REFILL/d refills): chunk loop and
     device loop (captures a replica; eager launches plus each capture's
     record times its replays), both with launches as the one-card
     formulas give them, sampled chunk loop, each answer against the
     one-card runs of phases 5-10 (the share equal token for token; the
     agreement gates); (c) cli/serve on
     phase 11's text requests over the replicas, batched (equal to one
     card at B/d response for response) and the device loop (against
     phase 11's); (d) cli/run --mode test --avg_only on phase 13's files
     over the replicas (equal to one process at B/d). ``python3
     chip_smoke.py --only-replicas`` runs this phase alone with what it
     needs of phases 1-11, without (d), for a machine with several cards;
 18. serves and tests with each row's passage pool split over a device
     group ("pool axis", after phase 17 on the same model, requests,
     one-card runs and files; runtime/replicas.Replicas over groups of M
     devices, models/case.PooledCaSE): one group of M = 2 on cuda:0 (the query
     side once, each shard's 5 passages of every row, the joins and the
     decode on the group's first device). (a) make_replicated_predict
     greedy dense, mxu and pallas, beam 4, sampled and rank-only on a B=64
     batch against the unsplit one-card predict on the same rows: rank
     within 4 bf16 ulps, at least 95 % of answer tokens equal, and whether
     every output is equal bit for bit; each kernel's launches those of
     one card but fused_mha, 8 + 11 M a batch (6 + 8 M rank-only); (b)
     the 512 continuous requests through the chunk loop and the device
     loop over the group (the encodes split, the captures on the first
     card): launches as the one-card formulas give them with fused_mha
     8 + 11 M an encode, at least 99 % of answers equal to phase 7's
     one-card run token for token; (c) cli/serve --pool_shard 2 on phase
     11's text requests, batched: response for response equal to phase
     11's (a) where (a) found the split bit-equal, else (a)'s gates; (d)
     cli/run --mode test --avg_only --pool_shard --mesh_shape 1,2 on
     phase 13's files: the four files against one process's; (e) no gate:
     requests/s and device busy ms and idle share of the group against
     one card (greedy dense batches, and each continuous loop).
     ``python3 chip_smoke.py --only-pool`` runs this phase alone without
     (c) and (d): on one card as above; with two cards a group over
     cuda:0,cuda:1, and with four also two groups of two;
 19. prints one JSON line {"kernels": [...]} and, last, the device line
     {"ok": true, "device": {...}}.

Phase 17's room was made by cutting phases 5, 7, 14 and 15: the chunk
loop's reverse-order repeat of pallas and dense, the device-loop knee at
(4, 16), the other models' second B=64 batch, and a second load of the
greedy archive in 15 (b), which serves the program 15 (a) loaded. Phase
18's was made by cutting phases 12 to 14 and 17: phase 12 trains 6
steps a route, not 10; phase 13 tests epoch 0 and the average, not every
epoch; phase 14 serves 80 requests, not 128, and takes its no_host_sync
step as the last train step; phase 17 (b) serves 256 requests, not 512,
and (a) times the host threads without the GIL switch-interval and
intra-op variants.

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
# steps a route on one batch (10 until phase 18 needed the room)
TRAIN_STEPS, TRAIN_WARMUP = 6, 2

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
    most. Only the device's activity is recorded: the host's operator
    events, which no reading uses, cost seconds a call to gather
    (tools/probe_profile_cost.py)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_us(evt):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(evt, name):
                return float(getattr(evt, name))
        return 0.0

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    # (the reverse-order repeat of pallas and dense was cut to make room
    # for phase 17: compare their times within a call with care)
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
DL_KNEE = ((4, 8), (8, 4))          # (4, 16) cut to make room for phase 17
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
        runs[name] = dict(run.report(n),
                          chunk_to_batch_ms=res["chunk_to_batch_ms"],
                          native_tokenizer=res["native_tokenizer"])
        if name == "c_device_loop":
            # a second, profiled run of the device loop only (the batched
            # and chunk-loop modes' were cut to make room for phase 16)
            again, prof = serve_text_mode(common, extra, path, profiled=True)
            same_responses(again, got[name], f"{name}: a second run")
            runs[name]["profiled"] = prof.report(n)
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
    res["modes"] = runs
    res["phase_s"] = time.perf_counter() - t_phase
    # TEXT_DIR stays for phase 17, which serves it over the replicas
    res["ctx"] = {"common": common, "modes": modes, "got": got}
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


# ---- phase 13: CaSE from raw files (cli/prepare, cli/run, cli/evaluate) ----

RAW_DIR = os.path.join(ROOT, "build", "raw_files")   # .gitignore: build/
RAW_TOPICS = {"train": 64, "dev": 16, "test": 16}    # topics a split
RAW_TURNS = 8                  # queries a topic: 512 / 128 / 128 queries
RAW_PASSAGES, RAW_THEME, RAW_POOL = 3000, 12, 100
RAW_LR, RAW_WARMUP = 5e-4, 4   # learning shows within the run's 48 steps
RAW_MID_EVERY = 3              # the subprocess's --checkpoint_every_steps
# epochs: 0 in a subprocess (SIGTERM in epoch 1); 1-3 resumed in process
# (in-kernel dropout); 4 with caller-drawn masks; 5 under --profile_dir
RAW_RESUME_TO, RAW_EPOCHS = 4, 6
RAW_TESTED = (0, "avg")         # the checkpoints --mode test decodes


def raw_corpus(base, words, pieces):
    """Raw CAsT-format TSVs in ``base`` (formats as tests/fixtures.py), from
    seed 5: RAW_PASSAGES passages of 60-150 words in sentences of 10-25,
    from the phase-11 vocabulary's words (one in eight glued to a "##"
    piece); topics of RAW_TURNS turns, each drawing its gold passages (1-2
    a query) from a theme of RAW_THEME passages; a query is words of its
    gold passage and random words, its answer a 8-30 word span of the gold
    passage; each pool lists RAW_POOL candidates (the theme, then random
    passages; shuffled)."""
    rng = np.random.RandomState(5)
    words = np.array(words)
    tails = [p[2:] for p in pieces]

    def draw(n):
        ws = list(rng.choice(words, n))
        for i in np.flatnonzero(rng.rand(n) < 0.125):
            ws[i] += tails[rng.randint(len(tails))]
        return ws

    passages = {}
    for i in range(RAW_PASSAGES):
        ws, sents = draw(rng.randint(60, 151)), []
        while ws:
            k = rng.randint(10, 26)
            sents.append(" ".join(ws[:k]) + " .")
            ws = ws[k:]
        passages[f"P{i}"] = " ".join(sents)
    pids = sorted(passages)
    files = {k: [] for k in ("query", "answer", "pool", "qrel", "split")}
    topic = 0
    for split, n_topics in RAW_TOPICS.items():
        for _ in range(n_topics):
            topic += 1
            theme = [pids[j] for j in rng.choice(len(pids), RAW_THEME,
                                                 replace=False)]
            for turn in range(1, RAW_TURNS + 1):
                qid = f"{topic}_{turn}"
                gold = list(rng.choice(theme, rng.randint(1, 3),
                                       replace=False))
                gw = passages[gold[0]].split()
                a = rng.randint(0, len(gw) - 30)
                query = gw[a:a + rng.randint(2, 5)] + draw(rng.randint(2, 6))
                files["query"].append(f"{qid}\t{' '.join(query)} ?")
                ctx = ";".join(f"{topic}_{i}" for i in range(1, turn))
                answer = " ".join(gw[a:a + rng.randint(8, 31)])
                files["answer"].append(
                    f"{ctx}\t{qid}\t{';'.join(gold)}\t{answer}")
                pool = list(theme)
                while len(pool) < RAW_POOL:
                    c = pids[rng.randint(len(pids))]
                    if c not in pool:
                        pool.append(c)
                rng.shuffle(pool)
                files["pool"] += [f"{qid} Q0 {c} {r + 1} {1 / (r + 1):.4f} "
                                  "synth" for r, c in enumerate(pool)]
                files["qrel"] += [f"{qid} 0 {g} 1" for g in gold]
                files["split"].append(f"{qid}\t{split}")
    heads = {"query": "#query_id\t#query", "passage": "#passage_id\t#passage",
             "answer": "#context_id\t#query_id\t#passage_id\t#answer",
             "pool": "#query_id #Q0 #passage_id #rank #score #model",
             "qrel": "#query_id #0 #passage_id #relevance",
             "split": "#query_id\t#split"}
    files["passage"] = [f"{p}\t{passages[p]}" for p in pids]
    files["reformulation.query"] = files["query"]
    heads["reformulation.query"] = heads["query"]
    for name, rows in files.items():
        with open(os.path.join(base, f"cast.{name}"), "w") as f:
            f.write(heads[name] + "\n" + "\n".join(rows) + "\n")
    return {"queries": len(files["query"]), "passages": len(pids),
            "words": sum(len(t.split()) for t in passages.values())}


def same_run_lines(g, w, what) -> int:
    """Run lines (split on spaces) ``g`` against ``w``: the same passages
    in the same order but for positions whose scores lie within 1e-5 of a
    neighbour (compared as sets), scores within 1e-5. Returns the ties."""
    check(len(g) == len(w), f"{what}: {len(g)} lines, not {len(w)}")
    ties, i = 0, 0
    while i < len(w):
        j = i + 1
        while j < len(w) and w[j][0] == w[i][0] and \
                abs(float(w[j][4]) - float(w[j - 1][4])) < 1e-5:
            j += 1
        ties += j - i > 1
        check(sorted(x[2] for x in g[i:j]) == sorted(x[2] for x in w[i:j])
              and all(a[0] == b[0] and a[3] == b[3]
                      and abs(float(a[4]) - float(b[4])) <= 1e-5
                      for a, b in zip(g[i:j], w[i:j])),
              f"{what}: line {i}: {g[i:j]} vs {w[i:j]}")
        i = j
    return ties


def same_result_files(got_dir, want_dir, what, names=None):
    """Every .answer/.run of ``want_dir`` (or those of ``names``) in
    ``got_dir``: answers byte for byte; runs byte for byte or as
    ``same_run_lines`` holds them."""
    if names is None:
        names = sorted(os.listdir(want_dir))
        check(names and sorted(os.listdir(got_dir)) == names,
              f"{what}: files {sorted(os.listdir(got_dir))} vs {names}")
    ties = 0
    for name in names:
        with open(os.path.join(want_dir, name)) as f:
            want = f.read()
        with open(os.path.join(got_dir, name)) as f:
            got = f.read()
        if got == want:
            continue
        check(name.endswith(".run"), f"{what}: {name} differs")
        ties += same_run_lines([ln.split(" ") for ln in got.splitlines()],
                               [ln.split(" ") for ln in want.splitlines()],
                               f"{what}: {name}")
    return ties


def epoch_profile(trace_dir, epoch):
    """Device busy ms and idle share of the "train_epoch {epoch}" span of
    the Chrome trace that --profile_dir wrote, and its top kernels."""
    (name,) = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    (span,) = [e for e in events if e.get("name") == f"train_epoch {epoch}"
               and e.get("cat") == "user_annotation"]
    t0, t1 = span["ts"], span["ts"] + span["dur"]
    by_name = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") \
                and t0 <= e.get("ts", -1) < t1:
            ms, n = by_name.get(e["name"], (0.0, 0))
            by_name[e["name"]] = (ms + e["dur"] / 1e3, n + 1)
    busy = sum(ms for ms, _ in by_name.values())
    check(busy > 0, "raw files: the profile of the epoch has no device time")
    top = sorted(((ms, n, k[:80]) for k, (ms, n) in by_name.items()),
                 reverse=True)[:8]
    return {"trace_mb": os.path.getsize(os.path.join(trace_dir, name)) / 1e6,
            "wall_ms": span["dur"] / 1e3, "device_busy_ms": busy,
            "device_idle_share": 1 - busy / (span["dur"] / 1e3),
            "top_kernels": [{"name": k, "ms": ms, "launches": n}
                            for ms, n, k in top]}


def raw_files(dev, bare_ms):
    """CaSE from raw files (phase 13): cli/prepare, then cli/run --mode
    train --bf16_train preempted by SIGTERM and resumed, --mode avg,
    --mode test (batched, chunk loop, device loop) and cli/evaluate, each
    gated as PERF.md section 2 says. ``bare_ms``: phase 12's ms per bare
    train step (in-kernel dropout), printed beside fit's."""
    import argparse
    import re
    import shutil
    import signal
    from case_rg_tpu_torch.cli import run as cli_run
    from case_rg_tpu_torch.cli.evaluate import main as evaluate_main
    from case_rg_tpu_torch.cli.serve import load_model
    from case_rg_tpu_torch.data.batching import Batcher
    from case_rg_tpu_torch.data.prepare import load_prepared
    from case_rg_tpu_torch.data.vocab import Vocabulary
    from case_rg_tpu_torch.device import batch_to_device, no_host_sync
    from case_rg_tpu_torch.kernels import additive_attention as aa
    from case_rg_tpu_torch.kernels import train_attention as ta
    from case_rg_tpu_torch.models import multimem
    from case_rg_tpu_torch.ops import attention
    from case_rg_tpu_torch.runtime.continuous import (make_continuous_fns,
                                                      run_continuous)
    from case_rg_tpu_torch.runtime.inference import make_predict_fn
    from case_rg_tpu_torch.runtime.io import save_results
    from case_rg_tpu_torch.train import trainer as trainer_mod
    from case_rg_tpu_torch.train.checkpoint import (best_epoch,
                                                    latest_epoch,
                                                    load_checkpoint)

    t_phase = time.perf_counter()
    shutil.rmtree(RAW_DIR, ignore_errors=True)
    base = os.path.join(RAW_DIR, "cast")
    os.makedirs(base)
    vocab_file = os.path.join(RAW_DIR, "vocab.txt")
    words, pieces = text_vocab(vocab_file)
    res = {"corpus": raw_corpus(base, words, pieces)}

    # 1. cli/prepare as users run it: a process of its own, spawned workers
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "case_rg_tpu_torch.cli.prepare", "--data_path",
         RAW_DIR, "--dataset", "cast", "--models", "case", "--vocab_file",
         vocab_file, "--workers", "3"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"cli/prepare: exit {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    res["prepare_s"] = time.perf_counter() - t0
    prep = os.path.join(base, "prepared")
    splits = {s: load_prepared(prep, s, "case") for s in ("train", "dev",
                                                         "test")}
    res["prepared"] = {s: {k: list(v.shape) for k, v in a[0].items()}
                       for s, a in splits.items()}
    vocab = Vocabulary.load(os.path.join(prep, "vocab.txt"))
    check(len(vocab) == V, f"prepared vocabulary of {len(vocab)} words")
    n_train = len(splits["train"][0]["id"])
    n_batches = -(-n_train // B)
    print(f"raw files prepared: {res['prepare_s']:.1f} s, "
          + json.dumps(res["prepared"]), flush=True)

    out = os.path.join(RAW_DIR, "out")
    common = ["--model", "case", "--data_path", RAW_DIR, "--dataset", "cast",
              "--output_path", out, "--batch_size", str(B)]
    train_args = common + ["--mode", "train", "--bf16_train",
                           "--learning_rate", str(RAW_LR), "--warmup_steps",
                           str(RAW_WARMUP)]

    # 2a. train under torchrun, a world of one over NCCL (cli/run
    # --multihost; phase 13b holds it to one process), with mid-epoch
    # checkpoints every RAW_MID_EVERY steps; SIGTERM to the rank once epoch
    # 1's first one is on disk (the host runs ahead of the card, so a timer
    # cannot place the signal)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mid_args = ["--checkpoint_every_steps", str(RAW_MID_EVERY)]
    proc = subprocess.Popen(
        torchrun(1, train_args + ["--epoch", str(RAW_RESUME_TO)] + mid_args),
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    log = []
    mid = os.path.join(out, "model", "1.mid.pt")
    try:
        for line in proc.stdout:
            log.append(line)
            if line.startswith("[train] epoch 0 dev loss"):
                while proc.poll() is None and not os.path.exists(mid):
                    time.sleep(0.01)
                for pid in rank_pids(proc.pid):
                    os.kill(pid, signal.SIGTERM)
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = "".join(log)
    m = re.search(r"preempted at epoch (\d+) batch (\d+)", text)
    check(rc == 0 and m is not None and m.group(1) == "1"
          and os.path.exists(os.path.join(out, "model", "1.preempt.pt"))
          and os.path.exists(os.path.join(out, "model", "0.mid.pt"))
          and os.path.exists(mid)
          and not os.path.exists(os.path.join(out, "model", "1.pt"))
          and latest_epoch(out) == 0,
          f"train: SIGTERM in epoch 1: exit {rc}, log tail {text[-1500:]}")
    res["preempt"] = {"exit": rc, "epoch": 1, "batch": int(m.group(2)),
                      "of_batches": n_batches,
                      "subprocess_s": time.perf_counter() - t0,
                      "epoch0_last_loss": re.search(
                          r"epoch 0 done .* loss (\{[^}]*\})", text).group(1)}
    for tag in ("1.preempt", "0.mid", "1.mid"):
        os.remove(os.path.join(out, "model", f"{tag}.pt"))
    res["world_of_one"] = world_of_one_train(
        cli_run, train_args + ["--epoch", str(RAW_RESUME_TO)] + mid_args, out,
        text)

    # 2b. resumed in process, instrumented: the restored state against
    # epoch 0's checkpoint bit for bit; each step under no_host_sync; epoch
    # wall times, losses, checkpoint writes and dev evaluations timed
    T = trainer_mod.Trainer
    orig = {n: getattr(T, n) for n in ("resume_or_init", "train_step",
                                       "train_epoch", "eval_losses")}
    orig_save = trainer_mod.save_checkpoint
    rec = {"epochs": {}, "losses": {}, "eval_ms": [], "save": [],
           "restores": [], "epoch": None}

    def resume_or_init(self, output_path):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, start = orig["resume_or_init"](self, output_path)
        torch.cuda.synchronize()
        rec["load_s"] = time.perf_counter() - t0
        ck = load_checkpoint(output_path, start - 1)
        opt = ck["opt_state"]
        same = all(torch.equal(getattr(state, f)[k].detach().cpu(), src[k])
                   for f, src in (("params", ck["params"]),
                                  ("ema", ck["ema"]), ("mu", opt["mu"]),
                                  ("nu", opt["nu"])) for k in src)
        rec["restores"].append({
            "start_epoch": start, "bit_equal": same, "count": state.count,
            "step": state.step, "load_s": rec["load_s"],
            "bytes": os.path.getsize(os.path.join(output_path, "model",
                                                  f"{start - 1}.pt"))})
        check(same and (state.count, state.step, state.mini_step) ==
              (opt["count"], ck["step"], opt["mini_step"]),
              f"train: resumed state vs checkpoint {start - 1}: "
              f"{rec['restores'][-1]}")
        return state, start

    def train_step(self, state, batch, gen):
        with no_host_sync():
            o = orig["train_step"](self, state, batch, gen)
        rec["losses"].setdefault(rec["epoch"], []).append(o["total"])
        return o

    def train_epoch(self, state, batcher, epoch, gen, **kw):
        rec["epoch"] = epoch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = orig["train_epoch"](self, state, batcher, epoch, gen, **kw)
        torch.cuda.synchronize()
        rec["epochs"][epoch] = (time.perf_counter() - t0,
                                batcher.num_batches(epoch))
        return state

    def eval_losses(self, *a, **kw):
        t0 = time.perf_counter()
        o = orig["eval_losses"](self, *a, **kw)
        rec["eval_ms"].append((time.perf_counter() - t0) * 1e3)
        return o

    def save_checkpoint(output_path, epoch, state, update_latest=True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = orig_save(output_path, epoch, state, update_latest)
        rec["save"].append({"tag": str(epoch),
                            "s": time.perf_counter() - t0,
                            "bytes": os.path.getsize(path)})
        return path

    def counted(extra):
        """cli/run train with ``extra``, the training kernels' counters set
        to 0 just before and read just after."""
        torch.cuda.synchronize()
        for v in ("mask", "rng"):
            ta.LAUNCHES_FWD[v] = ta.LAUNCHES_BWD[v] = 0
        aa.LAUNCHES = aa.LAUNCHES_BWD = 0
        steps0 = sum(n for _, n in rec["epochs"].values())
        cli_run.main(train_args + extra)
        steps = sum(n for _, n in rec["epochs"].values()) - steps0
        return steps, {v: (ta.LAUNCHES_FWD[v], ta.LAUNCHES_BWD[v])
                       for v in ("mask", "rng")}, (aa.LAUNCHES,
                                                   aa.LAUNCHES_BWD)

    trace_dir = os.path.join(RAW_DIR, "trace")
    runs = {}
    try:
        for n, fn in (("resume_or_init", resume_or_init),
                      ("train_step", train_step),
                      ("train_epoch", train_epoch),
                      ("eval_losses", eval_losses)):
            setattr(T, n, fn)
        trainer_mod.save_checkpoint = save_checkpoint
        for name, variant, extra in (
                ("resumed", "rng", ["--epoch", str(RAW_RESUME_TO)]),
                ("caller_masks", "mask", ["--epoch", str(RAW_EPOCHS - 1),
                                          "--no-kernel_rng_dropout"]),
                ("profiled", "rng", ["--epoch", str(RAW_EPOCHS),
                                     "--profile_dir", trace_dir])):
            steps, launches, add = counted(extra)
            other = "mask" if variant == "rng" else "rng"
            want = TRAIN_SITES_PER_STEP * steps
            check(steps > 0 and launches[variant] == (want, want)
                  and launches[other] == (0, 0) and add == (2 * steps,) * 2,
                  f"train {name}: {steps} steps, launches {launches}, "
                  f"additive_scores {add}")
            runs[name] = {"steps": steps, "launches": launches,
                          "additive_launches": add}
    finally:
        for n, fn in orig.items():
            setattr(T, n, fn)
        trainer_mod.save_checkpoint = orig_save
        attention.set_fused_train_attention(None)
        attention.set_fused_train_attn_rng(True)
        attention.set_fused_attention(None)
        multimem.set_fused_stack(None)
    check([r["start_epoch"] for r in rec["restores"]] == [
        1, RAW_RESUME_TO, RAW_EPOCHS - 1],
          f"train: resumed at epochs {rec['restores']}")
    means = {e: float(torch.stack(v).mean()) for e, v in rec["losses"].items()}
    every = torch.cat([torch.stack(v) for v in rec["losses"].values()])
    check(bool(torch.isfinite(every).all()), "train: a loss is not finite")
    first, last = min(means), max(means)
    check(means[last] < means[first],
          f"train: mean loss of epoch {last} {means[last]} not below epoch "
          f"{first}'s {means[first]}")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        dev_rows = [json.loads(x) for x in f if "dev_total" in x]
    dev_totals = [r["dev_total"] for r in dev_rows]
    check(len(dev_rows) == RAW_EPOCHS and all(np.isfinite(dev_totals))
          and best_epoch(out) == int(np.argmin(dev_totals)),
          f"train: dev totals {dev_totals}, best.json {best_epoch(out)}")
    steady = [e for e in (2, 3) if e in rec["epochs"]]
    fit_ms = [rec["epochs"][e][0] * 1e3 / rec["epochs"][e][1]
              for e in steady]

    # the batch's host-to-device copy from pageable memory, as fit makes it,
    # and from pinned memory (is a pinned prefetch of the next batch needed?)
    batch = next(Batcher(splits["train"][0], B, shuffle=True,
                         seed=1).epoch(0))
    batch = {k: v for k, v in batch.items() if not k.startswith("_")}
    h2d = {}
    for how in ("pageable", "pinned"):
        ts = []
        for _ in range(7):
            src = batch if how == "pageable" else {
                k: torch.from_numpy(v).long().pin_memory()
                if v.dtype != np.float32 else torch.from_numpy(v).pin_memory()
                for k, v in batch.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch_to_device(src, dev)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            ts.append(((t1 - t0) * 1e3, (time.perf_counter() - t0) * 1e3))
        ts.sort()
        h2d[how] = {"host_ms": ts[3][0], "until_done_ms": ts[3][1]}
    h2d["bytes"] = sum(v.nbytes * (2 if v.dtype == np.int32 else 1)
                       for v in batch.values())
    res["train"] = {
        "steps_per_epoch": n_batches, "epochs": {
            e: {"s": s, "ms_per_step": s * 1e3 / n, "mean_loss": means.get(e)}
            for e, (s, n) in sorted(rec["epochs"].items())},
        "fit_ms_per_step_steady": fit_ms, "bare_train_step_ms": bare_ms,
        "dev_totals": dev_totals, "best_epoch": best_epoch(out),
        "dev_eval_ms": rec["eval_ms"], "checkpoint_writes": rec["save"],
        "restores": rec["restores"],
        "h2d_batch": h2d, "runs": runs,
        "sync_check": "every fit step under no_host_sync",
        "profile_epoch_5": epoch_profile(trace_dir, RAW_EPOCHS - 1)}
    print("raw files training: " + json.dumps(res["train"]), flush=True)

    # 3. --mode avg over the last three epochs: the mean of their params/EMA
    t0 = time.perf_counter()
    cli_run.main(common + ["--mode", "avg", "--epoch", str(RAW_EPOCHS)])
    res["avg_s"] = time.perf_counter() - t0
    avg = load_checkpoint(out, "avg")
    cks = [load_checkpoint(out, e) for e in range(RAW_EPOCHS - 3, RAW_EPOCHS)]
    for name in ("params", "ema"):
        for k, v in avg[name].items():
            want = np.mean(np.stack([c[name][k].numpy() for c in cks]), 0)
            check(np.array_equal(v.numpy(), want),
                  f"avg: {name} {k} is not the mean of epochs 3-5")
    del cks

    # 4. --mode test --bf16_eval: epoch 0 and the average, batched (every
    # epoch until phase 18 needed the room); the average through the chunk
    # loop and the device loop
    test_args = common + ["--mode", "test", "--bf16_eval"]
    result = os.path.join(out, "result")
    timed_runs = {}

    def test_run(name, extra, output=out):
        args = [x if x != out else output for x in test_args] + extra
        t0 = time.perf_counter()
        cli_run.main(args)
        timed_runs[name] = time.perf_counter() - t0
        return os.path.join(output, "result")

    test_run("batched_epoch_0", ["--epoch", "1"])
    test_run("batched_avg", ["--avg_only"])
    res["world_of_one"]["test"] = world_of_one_test(cli_run, test_args, out)
    cont_out, loop_out = (os.path.join(RAW_DIR, n) for n in ("cont", "loop"))
    for d in (cont_out, loop_out):
        os.makedirs(d)
        os.symlink(os.path.join(out, "model"), os.path.join(d, "model"))
    cont_result = test_run("chunk_loop_avg", [
        "--avg_only", "--continuous", "--fast_argmax", "pallas"], cont_out)
    loop_result = test_run("device_loop_avg", [
        "--avg_only", "--continuous", "--fast_argmax", "pallas",
        "--device_loop", "8", "--chunk_steps", "4", "--lookahead"], loop_out)

    # the same, driven directly: make_predict_fn on the prepared batches,
    # run_continuous on the same rows
    t0 = time.perf_counter()
    ref = os.path.join(RAW_DIR, "ref")
    serve_args = argparse.Namespace(
        model="case", output_path=out, device="cuda", bf16=True, ema=False,
        embedding_size=E, hidden_size=E, num_heads=H, max_target_length=T_ANS,
        beam_width=1, min_window_size=4, num_windows=1)
    for epoch in RAW_TESTED:
        cfg, model = load_model(serve_args, vocab, epoch)
        fn = make_predict_fn(model, cfg, T_ANS, device=dev)
        for s in ("dev", "test"):
            arrays, meta = splits[s][0], splits[s][1]
            save_results(trainer_mod.predict(arrays, fn, B), meta, vocab,
                         ref, 0, epoch, f"cast_{s}")
    ties = {"batched": same_result_files(result, os.path.join(ref, "result"),
                                         "test batched vs make_predict_fn")}
    ref_cont = os.path.join(RAW_DIR, "ref_cont")
    init_fn, chunk_fn, refill_fn = make_continuous_fns(
        model, T_ANS, 8, fast_argmax="pallas", device=dev)
    for s in ("dev", "test"):
        arrays, meta = splits[s][0], splits[s][1]
        rows = []
        run_continuous(
            ({"i": i} for i in range(len(arrays["id"]))),
            lambda reqs, k: {f: arrays[f][[r["i"] for r in reqs]
                                          + [reqs[-1]["i"]] * (k - len(reqs))]
                             for f in ("query", "passage")},
            init_fn, chunk_fn, refill_fn, B, B // 4,
            emit=lambda r, ids, rk: rows.append((r["i"], ids, rk)))
        save_results((({"id": [i], "_indices": [i]},
                       {"answer": ids[None], "rank": rk[None]})
                      for i, ids, rk in rows), meta, vocab, ref_cont, 0,
                     "avg", f"cast_{s}")
    del model
    ties["chunk_loop"] = same_result_files(
        cont_result, os.path.join(ref_cont, "result"),
        "test --continuous vs run_continuous")
    ties["device_loop"] = same_result_files(
        loop_result, cont_result, "test --device_loop vs --continuous")
    n_eval = sum(len(splits[s][0]["id"]) for s in ("dev", "test"))
    res["test"] = {
        "samples_per_checkpoint": n_eval, "cli_s": timed_runs,
        "samples_per_s": {k: n_eval / v for k, v in timed_runs.items()},
        "near_ties": ties, "references_s": time.perf_counter() - t0}

    # 5. cli/evaluate: every metric of every result finite
    t0 = time.perf_counter()
    report = evaluate_main(["--model", "case", "--data_path", RAW_DIR,
                            "--datasets", "cast", "--output_path", out])
    res["evaluate_s"] = time.perf_counter() - t0
    want = {"map", "ndcg", "recall_10", "ROUGE_1_F1", "ROUGE_2_F1",
            "ROUGE_L_F1", "BLEU", "METEOR"}
    prefixes = report["cast"]
    check(sorted(prefixes) == sorted(
        f"cast_{s}_{e}" for s in ("dev", "test") for e in RAW_TESTED),
        f"evaluate: prefixes {sorted(prefixes)}")
    for prefix, metrics in prefixes.items():
        check(want <= set(metrics) and all(
            np.isfinite(v) for k, v in metrics.items()
            if k != "METEOR_variant"), f"evaluate {prefix}: {metrics}")
    res["evaluate"] = {p: {k: m[k] for k in sorted(want)}
                       for p, m in prefixes.items()
                       if p.endswith(("_0", "_avg"))}
    print("raw files test and evaluate: " + json.dumps(
        {k: res[k] for k in ("test", "avg_s", "evaluate_s", "evaluate")}),
        flush=True)
    res["phase_s"] = time.perf_counter() - t_phase    # RAW_DIR stays for
    res["ctx"] = {"test_args": test_args, "out": out}  # phases 13b and 17
    return res


# ---- phase 13b: data-parallel training and testing (runtime/mesh) ----

DP_RANKS = 2
# torch's own matmul settings, read in main() before it turns the
# reduced-precision bf16 reductions off for the plain versions' products;
# the ranks torchrun starts keep them, so the in-process references that
# are held to a rank's results bit for bit run under them (torch_defaults)
TORCH_DEFAULTS = {}


def read_torch_defaults() -> None:
    m = torch.backends.cuda.matmul
    TORCH_DEFAULTS.update(
        tf32=m.allow_tf32, cudnn_tf32=torch.backends.cudnn.allow_tf32,
        bf16_reduction=m.allow_bf16_reduced_precision_reduction)


@contextlib.contextmanager
def torch_defaults():
    m = torch.backends.cuda.matmul
    saved = (m.allow_tf32, torch.backends.cudnn.allow_tf32,
             m.allow_bf16_reduced_precision_reduction)
    m.allow_tf32 = TORCH_DEFAULTS["tf32"]
    torch.backends.cudnn.allow_tf32 = TORCH_DEFAULTS["cudnn_tf32"]
    m.allow_bf16_reduced_precision_reduction = \
        TORCH_DEFAULTS["bf16_reduction"]
    try:
        yield
    finally:
        (m.allow_tf32, torch.backends.cudnn.allow_tf32,
         m.allow_bf16_reduced_precision_reduction) = saved


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def torchrun(nproc: int, argv):
    """The command that starts ``nproc`` ranks of ``python -m
    case_rg_tpu_torch.cli.run --multihost *argv`` under torchrun on a free
    local port."""
    return [sys.executable, "-u", "-m", "torch.distributed.run",
            "--nproc_per_node", str(nproc), "--master_addr", "127.0.0.1",
            "--master_port", str(free_port()), "-m",
            "case_rg_tpu_torch.cli.run", "--multihost"] + list(argv)


def rank_pids(agent: int):
    """The rank processes torchrun's agent ``agent`` started (its children
    running cli/run, read from /proc)."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{d}/cmdline", "rb") as f:
                cmd = f.read()
        except (OSError, ValueError, IndexError):
            continue
        if ppid == agent and b"case_rg_tpu_torch.cli.run" in cmd:
            out.append(int(d))
    check(len(out) == 1, f"torchrun {agent}: rank processes {out}")
    return out


@contextlib.contextmanager
def torchrun_env(port: int):
    """torchrun's environment for a world of one in this process."""
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def same_checkpoint(got, want) -> bool:
    """Two checkpoints equal bit for bit: parameters, EMA, Adam moments,
    counts and step."""
    go, wo = got["opt_state"], want["opt_state"]
    return (got["step"] == want["step"]
            and (go["count"], go["mini_step"]) == (wo["count"],
                                                   wo["mini_step"])
            and all(sorted(a) == sorted(b)
                    and all(torch.equal(a[k], b[k]) for k in b)
                    for a, b in ((got["params"], want["params"]),
                                 (got["ema"], want["ema"]),
                                 (go["mu"], wo["mu"]), (go["nu"], wo["nu"]))))


def logged_losses(text, epoch=0):
    """{batch: losses} of the "[train] epoch E batch j loss {...}" lines of
    a training log, the "epoch E done" line's as its last batch."""
    import ast
    import re
    out = {int(m.group(1)): ast.literal_eval(m.group(2)) for m in
           re.finditer(rf"\[train\] epoch {epoch} batch (\d+) loss "
                       r"(\{[^}]*\})", text)}
    done = re.search(rf"epoch {epoch} done \((\d+) batches\) loss "
                     r"(\{[^}]*\})", text)
    check(done is not None, f"no end of epoch {epoch} in {text[-1500:]}")
    out[int(done.group(1)) - 1] = ast.literal_eval(done.group(2))
    return out


def rel_diff(a: dict, b: dict) -> float:
    """The largest relative difference between two dicts of numbers."""
    check(sorted(a) == sorted(b), f"keys {sorted(a)} vs {sorted(b)}")
    return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30) for k in b)


def run_drift(got, want):
    """How far a training run (output dir, log) is from another of the
    same steps: each logged step of epoch 0's largest relative loss
    difference, the epoch's dev loss's, the relative L2 distance of the
    epoch-0 parameters and EMA, counts equal, and whether the epoch-0
    checkpoints are equal bit for bit."""
    from case_rg_tpu_torch.train.checkpoint import load_checkpoint
    (g_out, g_log), (w_out, w_log) = got, want
    g_steps, w_steps = logged_losses(g_log), logged_losses(w_log)
    check(sorted(g_steps) == sorted(w_steps),
          f"logged steps {sorted(g_steps)} vs {sorted(w_steps)}")

    def dev0(path):
        with open(os.path.join(path, "metrics.jsonl")) as f:
            row = [json.loads(x) for x in f if "dev_total" in x][0]
        return {k: v for k, v in row.items() if k.startswith("dev_")}

    gc, wc = load_checkpoint(g_out, 0), load_checkpoint(w_out, 0)

    def l2(part):
        num = sum(float((gc[part][k].double() - v.double()).square().sum())
                  for k, v in wc[part].items())
        den = sum(float(v.double().square().sum()) for v in wc[part].values())
        return (num / den) ** 0.5

    return {"step_losses_rel": {j: rel_diff(g_steps[j], w_steps[j])
                                for j in sorted(w_steps)},
            "dev_rel": rel_diff(dev0(g_out), dev0(w_out)),
            "params_rel_l2": l2("params"), "ema_rel_l2": l2("ema"),
            "counts_equal": (gc["step"], gc["opt_state"]["count"]) == (
                wc["step"], wc["opt_state"]["count"]),
            "checkpoint_bit_equal": same_checkpoint(gc, wc)}


def world_of_one_train(cli_run, train_args, out, text):
    """Phase 13b (1), training: epoch 0 of phase 13's torchrun world of one
    (``text``, its log; ``out``, its output; ``train_args`` its arguments,
    with its --epoch, which sets the learning-rate schedule) against the
    same cli/run in this process without --multihost, under torch's
    default matmul settings, stopped before epoch 1: the epoch-0
    checkpoint, the epoch's last losses and the dev loss equal bit for bit;
    both epochs' host seconds."""
    import io
    import re
    import shutil
    from case_rg_tpu_torch.train import trainer as trainer_mod
    ref = os.path.join(RAW_DIR, "one_process")
    T = trainer_mod.Trainer
    orig = T.train_epoch

    def stop_after_epoch_0(self, state, batcher, epoch, gen, **kw):
        if epoch > 0:
            raise KeyboardInterrupt("epoch 0 only")   # fit returns
        return orig(self, state, batcher, epoch, gen, **kw)

    t0 = time.perf_counter()
    log = io.StringIO()
    T.train_epoch = stop_after_epoch_0
    try:
        with torch_defaults(), contextlib.redirect_stdout(log):
            auto_routing()
            cli_run.main([x if x != out else ref for x in train_args])
    finally:
        T.train_epoch = orig
    def epoch0_s(t):      # the epoch's host seconds that train_epoch logs
        return float(re.search(r"epoch 0 done .* time ([0-9.]+)s",
                               t).group(1))

    res = {"backend": "nccl", "one_process_s": time.perf_counter() - t0,
           "epoch0_s": {"world_of_one": epoch0_s(text),
                        "one_process": epoch0_s(log.getvalue())},
           **run_drift((out, text), (ref, log.getvalue()))}
    check(res["checkpoint_bit_equal"] and res["counts_equal"]
          and max(res["step_losses_rel"].values()) == 0.0
          and res["dev_rel"] == 0.0,
          f"world of one vs one process: {res}")
    shutil.rmtree(ref, ignore_errors=True)
    return res


def world_of_one_test(cli_run, test_args, out):
    """Phase 13b (1), testing: cli/run --mode test --multihost --epoch 1 in
    this process, a world of one over NCCL (torchrun's environment set
    here), on phase 13's epoch-0 checkpoint: its result files equal phase
    13's --mode test of that epoch without --multihost (answers byte for
    byte, runs as ``same_run_lines`` holds them); the serving kernels'
    launches, their counters set to 0 just before and read just after,
    each above 0."""
    from case_rg_tpu_torch.kernels import additive_attention as aa
    from case_rg_tpu_torch.kernels import decode_attention as da
    from case_rg_tpu_torch.kernels import decoder_stack as ds
    from case_rg_tpu_torch.kernels import encoder_attention as ea
    from case_rg_tpu_torch.runtime import mesh
    one = os.path.join(RAW_DIR, "world_of_one")
    os.makedirs(one)
    os.symlink(os.path.join(out, "model"), os.path.join(one, "model"))
    t0 = time.perf_counter()
    with torchrun_env(free_port()):
        torch.cuda.synchronize()
        ea.LAUNCHES = ds.LAUNCHES = da.LAUNCHES = aa.LAUNCHES = 0
        cli_run.main([x if x != out else one for x in test_args]
                     + ["--multihost", "--epoch", "1"])
        launches = {"fused_mha": ea.LAUNCHES, "stack_step": ds.LAUNCHES,
                    "single_query_mha": da.LAUNCHES,
                    "additive_scores": aa.LAUNCHES}
    secs = time.perf_counter() - t0
    check(all(launches.values()), f"world of one test: launches {launches}")
    check(not mesh.is_distributed(), "world of one: the group was not left")
    names = sorted(os.listdir(os.path.join(one, "result")))
    check(names == sorted(f"cast_{s}_0.0.{k}" for s in ("dev", "test")
                          for k in ("answer", "run")),
          f"world of one test: files {names}")
    ties = same_result_files(os.path.join(one, "result"),
                             os.path.join(out, "result"),
                             "world of one test", names)
    return {"files_equal": len(names), "near_ties": ties, "s": secs,
            "launches": launches}


def gloo_cuda_probe():
    """Whether gloo's all-reduce and broadcast take CUDA tensors in this
    torch: a gloo world of one in this process."""
    import torch.distributed as dist
    with torchrun_env(free_port()):
        try:
            dist.init_process_group("gloo", init_method="env://")
            try:
                x = torch.arange(4.0, device="cuda")
                dist.all_reduce(x)
                dist.broadcast(x, 0)
                ok = bool(torch.equal(x.cpu(), torch.arange(4.0)))
                return {"ok": ok, "why": "" if ok else "wrong sum"}
            finally:
                dist.destroy_process_group()
        except Exception as e:    # noqa: BLE001 - the answer is the reason
            return {"ok": False, "why": f"{type(e).__name__}: {e}"[:300]}


def dp_emulate(trainer, state, rank_batches, gens):
    """One process stepping as a group of len(gens) ranks steps: each rank's
    batch through its own dropout generator, each loss divided by its
    denominator summed over the ranks (read from a pass without dropout),
    the rank gradients summed, then the optimiser. No collective runs: the
    group's loss normalisation and step, computed another way (CaSE's
    losses have no constant term, so ``rank_share`` is not needed). Returns
    the losses (with grad_norm) of each step."""
    from case_rg_tpu_torch.device import batch_to_device
    from case_rg_tpu_torch.models import base
    from case_rg_tpu_torch.train.trainer import _device_fields
    saved = base.batch_denominator
    steps = []
    try:
        for batches in zip(*rank_batches):
            on = [batch_to_device(_device_fields(b), trainer.device)
                  for b in batches]
            dens = []
            for b in on:
                rec = []
                base.batch_denominator = \
                    lambda d, rec=rec: rec.append(d.detach().float()) or d
                with torch.no_grad():     # f32: the counts are the same
                    trainer._run(state.params, b, None, False)
                dens.append(rec)
            total = [sum(ds) for ds in zip(*dens)]
            grads, losses = None, {}
            for b, gen in zip(on, gens):
                it = iter(total)
                base.batch_denominator = lambda d, it=it: next(it)
                part = trainer._run(state.params, b, gen, trainer._bf16)
                g = torch.autograd.grad(sum(part.values()),
                                        list(state.params.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
                grads = g if grads is None else [x + y for x, y in
                                                 zip(grads, g)]
                for k, v in part.items():
                    losses[k] = losses[k] + v.detach() if k in losses \
                        else v.detach()
            losses["total"] = sum(losses.values())
            losses["grad_norm"] = trainer.apply_gradients(
                state, dict(zip(state.params, grads)))
            steps.append({k: float(v) for k, v in losses.items()})
    finally:
        base.batch_denominator = saved
    return steps


COLLECTIVE_OPS = ("c10d", "gloo", "nccl", "all_reduce", "allreduce",
                  "broadcast", "barrier")


def rank_profile(trace_dir, steps):
    """One rank's numbers (the ranks run the same steps; a trace takes
    seconds to read), from the Chrome trace its --profile_dir wrote: the
    "train_epoch 0" span's wall ms, device busy ms and idle share, the ms
    of its collectives (the union of the host's spans of the process
    group's operations, COLLECTIVE_OPS, on any thread; NCCL's kernels on
    the card), ms a step with and without them, the collective operations
    seen, and the training kernels' launches."""
    import re
    name = sorted(os.listdir(trace_dir))[0]
    with open(os.path.join(trace_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    (span,) = [e for e in events if e.get("name") == "train_epoch 0"
               and e.get("cat") == "user_annotation"]
    t0, t1 = span["ts"], span["ts"] + span["dur"]
    inside = [e for e in events if t0 <= e.get("ts", -1) < t1 and "dur" in e]
    busy = sum(e["dur"] for e in inside if e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")) / 1e3
    coll = [e for e in inside if e.get("cat") in ("cpu_op", "user_annotation")
            and any(k in e["name"].lower() for k in COLLECTIVE_OPS)]
    ops = {}
    for e in coll:
        n, ms = ops.get(e["name"], (0, 0.0))
        ops[e["name"]] = (n + 1, ms + e["dur"] / 1e3)
    union, end = 0.0, -1.0
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in coll):
        if b > end:
            union += b - max(a, end)
            end = b
    coll_host = union / 1e3
    coll_dev = sum(e["dur"] for e in inside if e.get("cat") == "kernel"
                   and "nccl" in e["name"].lower()) / 1e3
    launches = {}
    for key, names in (("train_attention_fwd", ("fwd_short", "fwd_long")),
                       ("train_attention_bwd", ("bwd_tile", "bwd_rows")),
                       ("additive_fwd", ("fwd_kernel",)),
                       ("additive_bwd", ("bwd_kernel",))):
        pat = re.compile(r"(^|[ :])(" + "|".join(names) + r")[<(]")
        launches[key] = sum(1 for e in inside if e.get("cat") == "kernel"
                            and pat.search(e["name"]))
    wall = span["dur"] / 1e3
    coll_ms = max(coll_host, coll_dev)
    return {"trace_mb": os.path.getsize(os.path.join(trace_dir, name)) / 1e6,
            "wall_ms": wall, "steps": steps, "ms_per_step": wall / steps,
            "ms_per_step_without_collectives": (wall - coll_ms) / steps,
            "collective_ms_per_step": coll_ms / steps,
            "collective_host_ms": coll_host,
            "collective_device_ms": coll_dev,
            "collective_ops": {k: [n, ms] for k, (n, ms) in
                               sorted(ops.items())},
            "device_busy_ms": busy, "device_idle_share": 1 - busy / wall,
            "kernel_launches": launches}


def by_query(lines):
    """Run lines split on spaces, grouped by query id in their order."""
    out = {}
    for ln in lines:
        fields = ln.split(" ")
        out.setdefault(fields[0], []).append(fields)
    return out


def data_parallel(dev, card):
    """Phase 13b (2): two ranks through cli/run --multihost under torchrun on
    phase 13's raw files (NCCL over two cards, or gloo on one shared card
    where gloo takes CUDA tensors). Training (one epoch, B=64 a rank, bf16,
    profiled): the epoch's last losses against ``dp_emulate`` in this
    process, its parameters against the group's checkpoint, the replicas
    bit-identical (the
    trainer's check at the checkpoint), the dev loss against one process's
    at B=128 on the same checkpoint. Testing (--bf16_eval): the ranks'
    result files merged equal one process's. Prints ms a step with and
    without the collectives, the reduced bytes a step, the all-reduce's
    ms, device busy and idle share."""
    import re
    from case_rg_tpu_torch.cli import run as cli_run
    from case_rg_tpu_torch.config import TrainConfig
    from case_rg_tpu_torch.data.batching import Batcher
    from case_rg_tpu_torch.data.prepare import load_prepared
    from case_rg_tpu_torch.models import create_model
    from case_rg_tpu_torch.runtime.io import merge_shards
    from case_rg_tpu_torch.train.checkpoint import load_checkpoint
    from case_rg_tpu_torch.train.trainer import Trainer, epoch_generator

    t_phase = time.perf_counter()
    cards = torch.cuda.device_count()
    probe = gloo_cuda_probe()
    backend = "nccl" if cards >= DP_RANKS else ("gloo" if probe["ok"]
                                                  else None)
    res = {"card": card, "cards": cards, "gloo_takes_cuda": probe,
           "backend": backend}
    if backend is None:
        res["ran"] = False
        res["why"] = (f"{cards} card(s), and gloo does not take CUDA "
                      f"tensors here: {probe['why']}")
        print("data-parallel two ranks: not run: " + res["why"], flush=True)
        return res
    out = os.path.join(RAW_DIR, "dp2")
    trace_dir = os.path.join(RAW_DIR, "dp2_trace")
    common = ["--model", "case", "--data_path", RAW_DIR, "--dataset", "cast",
              "--batch_size", str(B), "--output_path", out]
    train_args = common + ["--mode", "train", "--bf16_train",
                           "--learning_rate", str(RAW_LR), "--warmup_steps",
                           str(RAW_WARMUP), "--epoch", "1",
                           "--profile_dir", trace_dir]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(torchrun(DP_RANKS, train_args), cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    res["train_launch_s"] = time.perf_counter() - t0
    text = proc.stdout
    check(proc.returncode == 0, f"two ranks train: exit {proc.returncode}: "
          f"{text[-1500:]} {proc.stderr[-2500:]}")
    logged = logged_losses(text)
    steps = max(logged) + 1
    agree = re.search(r"the 2 replicas agree bit for bit \(checksum (-?\d+)",
                      text)
    check(agree is not None, f"two ranks train: log {text[-2000:]}")

    # the same steps in this process (dp_emulate), from the CLI's model
    prep = os.path.join(RAW_DIR, "cast", "prepared")
    arrays = load_prepared(prep, "train", "case")[0]
    args = cli_run.build_parser().parse_args(train_args)
    _, _, _, vocab, mcfg = cli_run.setup(args, need_train=False)
    n = len(arrays["id"])
    model = create_model("case", mcfg, device=dev, seed=args.seed)
    n_params = sum(p.numel() for p in model.parameters())
    tc = TrainConfig(batch_size=B, epochs=1, learning_rate=RAW_LR,
                     warmup_steps=RAW_WARMUP, seed=args.seed,
                     compute_dtype="bfloat16")
    trainer = Trainer(model, tc, int(n / B) + 100, device=dev)
    state = trainer.init_state()
    batches = [list(Batcher(arrays, B, shuffle=True, seed=args.seed,
                            process_index=r, process_count=DP_RANKS)
                    .epoch(0)) for r in range(DP_RANKS)]
    gens = [epoch_generator(args.seed, 0, dev, r) for r in range(DP_RANKS)]
    args.mode = "train"
    try:
        with torch_defaults():
            cli_run.set_switches(args)
            emulated = dp_emulate(trainer, state, batches, gens)
    finally:
        auto_routing()
    check(len(batches[0]) == steps, f"two ranks: {steps} steps logged, "
          f"{len(batches[0])} batches a rank")
    rel = {j: rel_diff(logged[j], emulated[j]) for j in sorted(logged)}
    exact = {j: logged[j] == emulated[j] for j in sorted(logged)}
    check(max(rel.values()) <= FIRST_LOSS_RTOL,
          f"two ranks: step losses vs one process emulating the group: "
          f"{rel} {logged} {emulated}")
    ck = load_checkpoint(out, 0)
    p_diff = max(float((ck["params"][k].to(dev) - v.detach()).abs().max())
                 for k, v in state.params.items())

    # the dev loss: one process at B=128 on the group's checkpoint, f32
    dev_arrays = load_prepared(prep, "dev", "case")[0]
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(ck["params"][k])
    one_dev = trainer.eval_losses(trainer.init_state(), dev_arrays,
                                  batch_size=DP_RANKS * B)
    with open(os.path.join(out, "metrics.jsonl")) as f:
        dp_dev = [json.loads(x) for x in f if "dev_total" in x][0]
    dev_rel = abs(dp_dev["dev_total"] - one_dev["total"]) / abs(
        one_dev["total"])
    check(dev_rel <= 1e-5, f"two ranks: dev loss {dp_dev} vs one process "
          f"{one_dev}")
    del model, trainer, state, ck
    torch.cuda.empty_cache()

    # testing: the ranks' shards merged against one process
    t0 = time.perf_counter()
    test_args = common + ["--mode", "test", "--bf16_eval", "--epoch", "1"]
    proc = subprocess.run(torchrun(DP_RANKS, test_args), cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    res["test_launch_s"] = time.perf_counter() - t0
    check(proc.returncode == 0, f"two ranks test: exit {proc.returncode}: "
          f"{proc.stdout[-1500:]} {proc.stderr[-2500:]}")
    ref = os.path.join(RAW_DIR, "dp2_one")
    os.makedirs(ref)
    os.symlink(os.path.join(out, "model"), os.path.join(ref, "model"))
    try:
        with torch_defaults():
            cli_run.main([x if x != out else ref for x in test_args])
    finally:
        auto_routing()
    shards = sorted(os.listdir(os.path.join(out, "result")))
    check(shards == sorted(f"cast_{s}_0.{r}.{k}" for s in ("dev", "test")
                           for r in range(DP_RANKS)
                           for k in ("answer", "run")),
          f"two ranks test: files {shards}")
    merged = merge_shards(os.path.join(out, "result"))
    want = merge_shards(os.path.join(ref, "result"))
    lines, ties = {}, 0
    for prefix, kinds in want.items():
        for kind, path in kinds.items():
            with open(path) as f:
                w = f.read().splitlines()
            with open(merged[prefix][kind]) as f:
                g = f.read().splitlines()
            what = f"two ranks test: {prefix}.all.{kind}"
            if kind == "answer":        # the ranks' rows, merged rank by rank
                check(w and sorted(g) == sorted(w), f"{what} differs")
            else:                       # a query's lines in rank order
                gq, wq = by_query(g), by_query(w)
                check(w and sorted(gq) == sorted(wq), f"{what}: queries")
                ties += sum(same_run_lines(gq[q], wq[q], what) for q in wq)
            lines[f"{prefix}.{kind}"] = len(w)

    profile = rank_profile(trace_dir, steps)
    res.update(
        ran=True, steps=steps, ranks=DP_RANKS, global_batch=DP_RANKS * B,
        step_losses_rel_diff=rel, step_losses_bit_equal=exact,
        replicas_checksum=int(agree.group(1)),
        params_vs_emulation_max_abs=p_diff,
        dev_total=(dp_dev["dev_total"], one_dev["total"]),
        dev_rel_diff=dev_rel, merged_lines=lines, merged_run_ties=ties,
        # the flat all-reduce of the gradients and the loss terms, and one
        # all-reduce of each term's denominator (the host's gloo flag aside)
        reduced_bytes_per_step=4 * (n_params + 2 * (len(emulated[0]) - 2)),
        n_params=n_params, a_rank=profile,
        phase_s=time.perf_counter() - t_phase)
    return res


# ---- phase 14: the other models (Masque, S2SA, GTTP, GLKS, TMemNet) ----

OTHER_MODELS = ("masque", "s2sa", "gttp", "glks", "tmemnet")
RANK_MODELS = ("masque", "tmemnet")
COPY_MODELS = ("masque", "gttp", "glks")      # fast_argmax="pallas" combines
# requests of the continuous loops' warm-up runs (a full batch and a
# refill: every program shape of the loop, the device loop's capture)
WARM_REQUESTS = B + REFILL
# B + REFILL requests (the continuous loops' stream: a full batch and a
# refill; the one-shot batches) and 3 train steps a model: cut from 256
# and 10 to make room for phase 16, from 6 steps for phase 13b (a GRU
# model's step takes about 4 s of host time), and from 128 requests for
# phase 18. GLKS keeps 6: after 3 its loss without dropout had risen
# (16.73 -> 19.03, measured on one H100), and the gate asks it to fall
OTHER_REQUESTS = B + REFILL
OTHER_TRAIN_STEPS = {"glks": 6}
TMEMNET_LAYERS = 8
# The kernels of each model's serving path and their launches per B=64
# greedy batch (40 steps; dense argmax): Masque as CaSE without the
# token-identification tower (encoder 2 x 3 + the selection tower 3 + 5
# fused_mha sites; the passage stack's stack_step; the query stack's 4
# layers x 2 single-query attentions; the copy attention over both
# memories); TMemNet 8 encoder layers over the context and the pool, 8
# decoder layers x 2 single-query attentions a step; S2SA and GTTP the
# attention over the context and the background a step, GLKS three a step
# (copy, vocabulary-context, vocabulary-background; its knowledge
# selector's two sites go dense: ops/bilinear.DENSE_SITES).
OTHER_LAUNCHES = {
    "masque": {"fused_mha": 2 * ENC_LAYERS + 8, "stack_step": T_ANS,
               "single_query_mha": 2 * DEC_LAYERS * T_ANS,
               "additive_scores": 2 * T_ANS},
    "s2sa": {"additive_scores": 2 * T_ANS},
    "gttp": {"additive_scores": 2 * T_ANS},
    "glks": {"additive_scores": 3 * T_ANS},
    "tmemnet": {"fused_mha": 2 * TMEMNET_LAYERS,
                "single_query_mha": 2 * TMEMNET_LAYERS * T_ANS}}
OTHER_KERNELS = ("fused_mha", "stack_step", "single_query_mha",
                 "additive_scores", "combine_copy_mass")


def other_cfg(name, dtype):
    """``name`` at CaSE's serving widths: V=30522, E = H = 256, 8 heads;
    Masque 3 encoder and 2 x 4 decoder layers, TMemNet 8 + 8; the GRU
    models' JAX defaults (one GRU layer, embedding dropout 0.5, GLKS windows
    of 4); transformer dropout 0.1."""
    from case_rg_tpu_torch.config import ModelConfig
    return ModelConfig(name=name, vocab_size=V, embedding_size=E,
                       hidden_size=E, num_heads=H, enc_layers=ENC_LAYERS,
                       dec_layers=DEC_LAYERS, tmemnet_layers=TMEMNET_LAYERS,
                       max_dec_len=T_ANS, max_target_length=T_ANS,
                       dropout=RATE, param_dtype=dtype)


def as_model(name, reqs):
    """The requests of ``make_requests`` (query 60, pool 10 x 100) in
    ``name``'s fields: Masque's query and pool; TMemNet's context and pool;
    the GRU models' context and background (the pool's 1000 positions)."""
    q, pool = reqs["query"], reqs["passage"]
    if name == "masque":
        return {"query": q, "passage": pool}
    if name == "tmemnet":
        # TMemNet's featurizer fills a pool's missing passages with a lone
        # [UNK] (data/featurize.py); an empty one would pool over nothing
        pool = pool.copy()
        pool[:, :, 0] = np.where((pool != 0).any(-1), pool[:, :, 0], 2)
        return {"context": q[:, 0], "passage": pool}
    return {"context": q[:, 0], "background": pool.reshape(len(q), -1)}


def other_train_batch(name, cfg, data, rng):
    """A B=64 batch with what training reads: a response of variable
    length, a gold passage and, for GLKS, a one-hot window selection."""
    bt = take(data, slice(0, B))
    resp = rng.randint(4, V, size=(B, T_ANS)).astype(np.int32)
    for i, n in enumerate(rng.randint(T_ANS // 4, T_ANS + 1, size=B)):
        resp[i, n:] = 0
    bt["response"] = resp
    bt["passage_label"] = rng.randint(0, P, size=B).astype(np.int32)
    if name == "glks":
        w = (P * LP - cfg.min_window_size) // cfg.min_window_size + 1
        bt["selection"] = np.eye(w, dtype=np.float32)[rng.randint(0, w, B)]
    return bt


def additive_exact_sums(wq, uh, v):
    """additive_scores' function with its rounding points (wq + uh and the
    tanh to the input dtype) and the sum over h in f64, rounded once: the
    rounding witness of the copy attentions (as mha_exact_sums is of the
    encoder's)."""
    th = torch.tanh(wq[:, :, None, :] + uh[:, None, :, :])
    return (th.double() * v.double()).sum(-1).to(wq.dtype)


def kernel_counts():
    from case_rg_tpu_torch.kernels import (additive_attention, copy_argmax,
                                           decode_attention, decoder_stack,
                                           encoder_attention)
    mods = (encoder_attention, decoder_stack, decode_attention,
            additive_attention, copy_argmax)
    return {k: m.LAUNCHES for k, m in zip(OTHER_KERNELS, mods)}


def reset_kernel_counts():
    from case_rg_tpu_torch.kernels import (additive_attention, copy_argmax,
                                           decode_attention, decoder_stack,
                                           encoder_attention)
    for m in (encoder_attention, decoder_stack, decode_attention,
              additive_attention, copy_argmax):
        m.LAUNCHES = 0


class swapped:
    """Within ``with``, each serving kernel's wrapper at the modules that
    call it replaced by ``fns`` (fused_mha, stack_step, single_query_mha,
    additive_scores, combine_copy_mass)."""

    def __init__(self, *fns):
        from case_rg_tpu_torch.kernels import copy_argmax
        from case_rg_tpu_torch.models import multimem
        from case_rg_tpu_torch.ops import attention, bilinear
        self.sites = ((attention, "fused_mha"), (multimem, "stack_step"),
                      (attention, "single_query_mha"),
                      (bilinear, "additive_scores"),
                      (copy_argmax, "combine_copy_mass"))
        self.fns = fns

    def __enter__(self):
        self.saved = [getattr(m, n) for m, n in self.sites]
        for (m, n), f in zip(self.sites, self.fns):
            setattr(m, n, f)

    def __exit__(self, *exc):
        for (m, n), f in zip(self.sites, self.saved):
            setattr(m, n, f)


def plain_fns():
    from case_rg_tpu_torch.kernels import additive_attention as aa
    from case_rg_tpu_torch.kernels import copy_argmax as ca
    from case_rg_tpu_torch.kernels import decode_attention as da
    from case_rg_tpu_torch.kernels import decoder_stack as ds
    from case_rg_tpu_torch.kernels import encoder_attention as ea
    return (ea.fused_mha_plain, ds.stack_step_plain,
            da.single_query_mha_plain, aa.additive_scores_plain,
            ca.combine_copy_mass_plain)


def answers_agree(outs, refs, ranked: bool):
    """The shares of answer tokens and of first tokens that agree, and, for
    the models with a rank head, the rank scores' max bf16 ulps."""
    same = first = 0
    ulps = 0.0
    for o, r in zip(outs, refs):
        same += int((o["answer"] == r["answer"]).sum())
        first += int((o["answer"][:, 0] == r["answer"][:, 0]).sum())
        if ranked:
            ulps = max(ulps, bf16_ulps(o["rank"], r["rank"])[0])
    res = {"token_agreement": same / (len(outs) * B * T_ANS),
           "first_token_agreement": first / (len(outs) * B)}
    if ranked:
        res["rank_max_ulps"] = ulps
    return res


def check_agreement(got, what, witness=None):
    check(got["token_agreement"] >= MIN_TOKEN_AGREEMENT
          and got["first_token_agreement"] >= MIN_FIRST_TOKEN_AGREEMENT,
          f"{what}: {got}")
    if "rank_max_ulps" in got:
        check(got["rank_max_ulps"] <= RANK_ULPS, f"{what}: rank {got}")
    if witness is not None:
        for key in ("token_agreement", "first_token_agreement"):
            check(got[key] >= witness[key] - AGREEMENT_SLACK,
                  f"{what}: {key} {got[key]}, the exact-sum witness "
                  f"{witness[key]}")


def dense_sites_since(before):
    from case_rg_tpu_torch.ops import bilinear
    return {k: v - before.get(k, 0) for k, v in bilinear.DENSE_SITES.items()
            if v != before.get(k, 0)}


def serve_other(dev, name):
    """One model of the phase at full width (see OTHER_LAUNCHES and the
    module docstring, phase 14). Returns its printed record."""
    from case_rg_tpu_torch.models import create_model, perturb_affine
    from case_rg_tpu_torch.ops import bilinear
    from case_rg_tpu_torch.runtime.inference import make_predict_fn
    t_phase = time.perf_counter()
    cfg = other_cfg(name, "bfloat16")
    model = create_model(name, cfg, device=dev, seed=0)
    perturb_affine(model, torch.Generator(device=dev).manual_seed(1))
    reqs, caps = make_requests(np.random.RandomState(3), OTHER_REQUESTS)
    data = as_model(name, reqs)
    # one B=64 batch (two until phase 17 needed the room)
    batches = [take(data, slice(0, B))]
    ranked = name in RANK_MODELS
    res = {"params": sum(p.numel() for p in model.parameters())}

    # (a) greedy through make_predict_fn, launches counted; the kernels
    # against their plain versions and the exact-sum witness
    predict = make_predict_fn(model, cfg, T_ANS, device=dev)
    predict(batches[0])                                # warm-up
    torch.cuda.synchronize()
    dense_before = dict(bilinear.DENSE_SITES)
    reset_kernel_counts()
    outs, times = serve(predict, batches)
    launches = kernel_counts()
    res["dense_sites"] = dense_sites_since(dense_before)
    want = {k: OTHER_LAUNCHES[name].get(k, 0) * len(batches)
            for k in OTHER_KERNELS}
    check(launches == want, f"{name} greedy: launches {launches}, expected "
          f"{want}")
    for out in outs:
        a = out["answer"]
        check(tuple(a.shape) == (B, T_ANS) and a.dtype == torch.int32
              and bool(((a >= 0) & (a < V)).all()),
              f"{name}: answer {tuple(a.shape)} {a.dtype} out of the vocab")
        if ranked:
            check(tuple(out["rank"].shape) == (B, P)
                  and bool(torch.isfinite(out["rank"]).all()),
                  f"{name}: rank {tuple(out['rank'].shape)} not finite")
        else:
            check("rank" not in out, f"{name}: a rank without a rank head")
    plain = plain_fns()
    reset_kernel_counts()
    with swapped(*plain):
        plain_outs, plain_times = serve(predict, batches)
    check(not any(kernel_counts().values()),
          f"{name}: kernels launched with their plain versions swapped in")
    with swapped(mha_exact_sums, plain[1], plain[2], additive_exact_sums,
                 plain[4]):
        witness = answers_agree(serve(predict, batches)[0], plain_outs,
                                ranked)
    vs_plain = answers_agree(outs, plain_outs, ranked)
    check_agreement(vs_plain, f"{name} greedy, kernels vs plain versions",
                    witness)
    res.update(launches_per_batch={k: v // len(batches)
                                   for k, v in launches.items() if v},
               ms_per_batch=times, plain_ms_per_batch=plain_times,
               vs_plain=vs_plain, exact_sums_vs_plain=witness)
    encode = (lambda bt: model._select(bt)) if name == "masque" \
        else (lambda bt: model.encode(bt))
    from case_rg_tpu_torch.device import batch_to_device
    on_card = batch_to_device(batches[0], dev)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encode(on_card)
        torch.cuda.synchronize()
        res["encode_ms"] = (time.perf_counter() - t0) * 1e3
    res["profile"] = profile_device(predict, batches[:1])

    # (b) rank-only
    if ranked:
        rank_only = make_predict_fn(model, cfg, T_ANS, rank_only=True,
                                    device=dev)
        rank_only(batches[0])
        reset_kernel_counts()
        ro, ro_ms = serve(rank_only, batches[:1])
        got = kernel_counts()
        check(got == dict({k: 0 for k in OTHER_KERNELS},
                          fused_mha=OTHER_LAUNCHES[name]["fused_mha"]),
              f"{name} rank-only: launches {got}")
        ulps, _ = bf16_ulps(ro[0]["rank"], outs[0]["rank"])
        check(set(ro[0]) == {"rank"} and ulps <= 1,
              f"{name} rank-only vs predict: {ulps} bf16 ulps > 1")
        res["rank_only_ms"] = ro_ms

    # (c) beam search and sampling at top_k = 1
    beam = make_predict_fn(model, cfg, T_ANS, beam_width=BEAM_WIDTH,
                           device=dev)
    top1 = make_predict_fn(model, cfg, T_ANS, decoding="sample", top_k=1,
                           device=dev)
    b_out, b_ms = serve(beam, batches[:1])
    a = b_out[0]["answer"]
    check(tuple(a.shape) == (B, T_ANS) and bool(((a >= 0) & (a < V)).all()),
          f"{name} beam: answer {tuple(a.shape)} out of the vocab")
    s_out, s_ms = serve(top1, batches[:1])
    vs_greedy = answers_agree(s_out, outs[:1], ranked)
    check_agreement(vs_greedy, f"{name} sampling at top_k=1 vs greedy")
    res["beam"] = {"width": BEAM_WIDTH, "ms": b_ms,
                   "vs_greedy": answers_agree(b_out, outs[:1], ranked)}
    res["sample_top_k_1"] = {"ms": s_ms, "vs_greedy": vs_greedy}

    # (f) the scatter-free candidate argmax through combine_copy_mass
    if name in COPY_MODELS:
        fast = make_predict_fn(model, cfg, T_ANS, fast_argmax="pallas",
                               device=dev)
        fast(batches[0])
        reset_kernel_counts()
        f_out, f_ms = serve(fast, batches)
        f_launches = kernel_counts()
        check(f_launches["combine_copy_mass"] == T_ANS * len(batches),
              f"{name} pallas mode: launches {f_launches}")
        with swapped(*kernels_of(), plain[4]):
            fp_out, _ = serve(fast, batches)
        fvp = answers_agree(f_out, fp_out, ranked)
        check_agreement(fvp, f"{name} pallas mode, combine vs its plain "
                        "version")
        fvd = answers_agree(f_out, outs, ranked)
        check_agreement(fvd, f"{name} pallas vs dense mode")
        res["pallas_mode"] = {"ms_per_batch": f_ms,
                              "launches_per_batch": {
                                  k: v // len(batches)
                                  for k, v in f_launches.items() if v},
                              "combine_vs_plain": fvp, "vs_dense": fvd}

    # (d) continuous: the chunk loop and the device loop over the requests
    res["continuous"] = serve_other_continuous(dev, name, cfg, model, data,
                                               caps, predict)
    del beam, top1
    res["train"] = train_other(dev, name)
    res["phase_s"] = time.perf_counter() - t_phase
    return res


def kernels_of():
    from case_rg_tpu_torch.kernels import additive_attention as aa
    from case_rg_tpu_torch.kernels import decode_attention as da
    from case_rg_tpu_torch.kernels import decoder_stack as ds
    from case_rg_tpu_torch.kernels import encoder_attention as ea
    return (ea.fused_mha, ds.stack_step, da.single_query_mha,
            aa.additive_scores)


def serve_other_continuous(dev, name, cfg, model, data, caps, predict):
    """The requests through run_continuous (batch 64, refill 16, chunks of
    8 steps) and run_continuous_device (4 steps a chunk, 8 chunks a mega,
    a ring of 256, lookahead; a warm-up run captures the graph), launches
    counted around each (the device loop's as recorded launches x replays
    plus the counters' rise). The device loop's answers equal the chunk
    loop's token for token; the chunk loop's are held to the one-shot
    greedy answers of the same requests (cut at each cap and EOS), token
    for token."""
    from case_rg_tpu_torch.runtime import graphs
    from case_rg_tpu_torch.runtime.continuous import (make_continuous_fns,
                                                      make_device_loop_fns,
                                                      run_continuous,
                                                      run_continuous_device)
    n = len(caps)
    make_batch = batch_maker(data, caps)

    def drive(run):
        got = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = run(lambda r, ids, rk: got.__setitem__(r["i"], (ids.copy(),
                                                                rk)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(stats["served"] == n and sorted(got) == list(range(n)),
              f"{name} continuous: served {stats['served']} of {n}")
        return got, dict(stats, requests_per_s=n / wall, wall_s=wall)

    fns = make_continuous_fns(model, T_ANS, CHUNK_STEPS, device=dev)
    loop = lambda emit, k=n: run_continuous(
        items(k), make_batch, *fns, batch_size=B, refill=REFILL, emit=emit)
    loop(lambda r, ids, rk: None, WARM_REQUESTS)       # warm-up
    chunk = lambda: drive(loop)
    reset_kernel_counts()
    base, stats = chunk()
    res = {"chunk_loop": dict(stats, launches={
        k: v for k, v in kernel_counts().items() if v})}
    one = {}
    for s in range(0, n, B):
        # a last partial batch filled up from the first requests: every
        # one-shot batch is B rows, as the chunk loop's
        out = predict(take(data, np.arange(s, s + B) % n))
        for i, a in enumerate(out["answer"].cpu().numpy()[:n - s]):
            one[s + i] = (a, None)
    vs_one = answer_agreement(base, one, caps, cfg.eos_id)
    vs_one["identical_answers"] = sum(
        int(np.array_equal(base[i][0], answer_agreement_ref(one[i][0],
                                                           caps[i],
                                                           cfg.eos_id)))
        for i in range(n))
    check(vs_one["identical_answers"] == n,
          f"{name} chunk loop vs one-shot greedy: {vs_one}")
    res["chunk_loop"]["vs_one_shot"] = vs_one

    dfns = make_device_loop_fns(model, T_ANS, DL_STEPS, DL_K, DL_RING,
                                device=dev)
    dloop = lambda emit, k=n: run_continuous_device(
        items(k), make_batch, dfns, batch_size=B, refill=REFILL, emit=emit,
        max_len=T_ANS, lookahead=True)
    dloop(lambda r, ids, rk: None, WARM_REQUESTS)      # warm-up: captures
    device = lambda: drive(dloop)
    check(len(dfns.captures) == 1, f"{name} device loop: "
          f"{len(dfns.captures)} captures in the warm-up run")
    cap = dfns.captures[0]
    replays0 = cap["replays"]
    reset_kernel_counts()
    got, dstats = device()
    rise = graphs.launch_counts()
    replays = cap["replays"] - replays0
    check(replays == dstats["megas"], f"{name} device loop: {replays} "
          f"replays for {dstats['megas']} megas")
    launches = {k: rise[k] + cap["launches"][k] * replays for k in rise}
    bad = [i for i in got if not np.array_equal(got[i][0], base[i][0])]
    check(not bad, f"{name} device loop: {len(bad)} answers differ from the "
          f"chunk loop's (first: request {bad[:1]})")
    res["device_loop"] = dict(dstats, launches={k: v for k, v in
                                                launches.items() if v},
                              capture={k: cap[k] for k in cap
                                       if k != "launches"})
    return res


def answer_agreement_ref(row, cap, eos):
    """A one-shot answer as a request capped at ``cap`` emits it."""
    r = row.copy()
    hits = np.flatnonzero(r[:cap] == eos)
    r[(hits[0] + 1 if len(hits) else cap):] = 0
    return r


def train_other(dev, name):
    """bf16 training over f32 masters (the model's training-attention sites
    and copy attentions through their kernels): the first step's loss and
    gradient against the plain versions (same dropout bits),
    OTHER_TRAIN_STEPS steps on one batch, the last under no_host_sync (the
    loss must fall; launches counted). GLKS trains its ds_mle_mce_train
    losses."""
    from case_rg_tpu_torch.config import TrainConfig
    from case_rg_tpu_torch.device import batch_to_device, no_host_sync
    from case_rg_tpu_torch.kernels import additive_attention as aa
    from case_rg_tpu_torch.kernels import train_attention as ta
    from case_rg_tpu_torch.models import create_model, perturb_affine
    from case_rg_tpu_torch.ops import attention, bilinear
    from case_rg_tpu_torch.train.trainer import Trainer
    cfg = other_cfg(name, "float32")
    model = create_model(name, cfg, device=dev, seed=0)
    perturb_affine(model, torch.Generator(device=dev).manual_seed(1))
    init = {k: v.detach().clone() for k, v in model.named_parameters()}
    tc = TrainConfig(batch_size=B, learning_rate=2.5e-4, warmup_steps=1,
                     compute_dtype="bfloat16")
    trainer = Trainer(model, tc, total_steps=1000, device=dev,
                      loss_method_kwargs={"mode": "ds_mle_mce_train"}
                      if name == "glks" else None)
    reqs, _ = make_requests(np.random.RandomState(4), B)
    batch = other_train_batch(name, cfg, as_model(name, reqs),
                              np.random.RandomState(5))

    def fresh():
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(init[k])
        return trainer.init_state(), torch.Generator(device=dev).manual_seed(7)

    def routed(plain):
        attention.fused_train_mha = plain_mha if plain else ta.fused_train_mha
        attention.fused_train_mha_rng = (plain_mha_rng if plain
                                         else ta.fused_train_mha_rng)
        bilinear.additive_scores = (_PlainAdditive.apply if plain
                                    else aa.additive_scores)

    res = {}
    try:
        first = {}
        for route in ("kernels", "plain"):
            routed(route == "plain")
            st, gen = fresh()
            losses, grads = trainer.loss_and_grads(st, batch, gen)
            flat = torch.cat([g.float().flatten() for g in grads.values()])
            first[route] = (losses["total"].item(), flat)
        (lk, gk), (lp, gp) = first["kernels"], first["plain"]
        cosine = F.cosine_similarity(gk, gp, dim=0).item()
        check(abs(lk - lp) <= FIRST_LOSS_RTOL * abs(lp),
              f"{name} train: first loss {lk} vs plain {lp}")
        check(cosine >= FIRST_GRAD_COSINE,
              f"{name} train: first gradient cosine {cosine}")
        res.update(first_loss=lk, first_loss_plain=lp,
                   first_loss_rel_diff=abs(lk - lp) / abs(lp),
                   first_grad_cosine=cosine)
        routed(False)
        st, gen = fresh()
        # the batch's loss with dropout off, before and after the steps (the
        # GRU models' embedding dropout of 0.5 makes the steps' own losses
        # noisy)
        before = trainer.eval_batch(st, batch)["total"].item()
        torch.cuda.synchronize()
        ta.LAUNCHES_FWD["rng"] = ta.LAUNCHES_BWD["rng"] = 0
        aa.LAUNCHES = aa.LAUNCHES_BWD = 0
        losses, times = [], []
        on_card = batch_to_device(batch, dev)
        n_steps = OTHER_TRAIN_STEPS.get(name, 3)
        for step in range(n_steps):
            # the last step on the batch already on the card, under
            # no_host_sync: an operation that makes the host wait raises
            # (a step of its own until phase 18 needed the room)
            last = step == n_steps - 1
            t0 = time.perf_counter()
            with no_host_sync() if last else contextlib.nullcontext():
                o = trainer.train_step(st, on_card if last else batch, gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(o["total"].item())
        launches = {"train_attention": (ta.LAUNCHES_FWD["rng"],
                                        ta.LAUNCHES_BWD["rng"]),
                    "additive_scores": (aa.LAUNCHES, aa.LAUNCHES_BWD)}
        after = trainer.eval_batch(st, batch)["total"].item()
        check(all(np.isfinite(losses)) and after < before,
              f"{name} train: losses {losses}, without dropout {before} -> "
              f"{after}")
        transformer = name in ("masque", "tmemnet")
        check(all(c > 0 for c in launches["train_attention"]) == transformer
              and all(c > 0 for c in launches["additive_scores"])
              == (name != "tmemnet"),
              f"{name} train: launches {launches}")
        res.update(losses=losses, loss_without_dropout=(before, after),
                   ms_per_step=times[TRAIN_WARMUP:], launches=launches,
                   sync_check="the last step under no_host_sync")
    finally:
        routed(False)
    return res


def auto_routing():
    """Every kernel routing switch back at its default (auto: the kernels
    in bf16 on the card; in-kernel dropout): an earlier phase's cli/run and
    cli/serve calls set them for their own modes."""
    from case_rg_tpu_torch.models import multimem
    from case_rg_tpu_torch.ops import attention, bilinear
    for switch in (attention.set_fused_attention,
                   attention.set_fused_train_attention,
                   attention.set_single_query_attention,
                   bilinear.set_additive_kernel, multimem.set_fused_stack):
        switch(None)
    attention.set_fused_train_attn_rng(True)
    attention.set_bf16_scores(False)
    from case_rg_tpu_torch.ops.dropout import set_seeded_dropout
    set_seeded_dropout(False)


def other_models(dev):
    """Phase 14 over OTHER_MODELS: a record per model, printed as it ends
    ("other models <name>: {...}")."""
    auto_routing()
    out = {}
    for name in OTHER_MODELS:
        out[name] = serve_other(dev, name)
        print(f"other models {name}: " + json.dumps(out[name]), flush=True)
        torch.cuda.empty_cache()
    return out


# ---- phase 15: export and multi-model serving ----

EXPORT_DIR = os.path.join(ROOT, "build", "export_serving")  # .gitignore: build/
# what a B=64 batch of the exported CaSE launches, as the live predict does:
# fused_mha 19 times an encode (14 rank-only), stack_step once a step,
# single_query_mha twice a query-stack layer and step, additive_scores
# twice a step, combine_copy_mass once a step in the pallas argmax mode
EXPORT_VARIANTS = {
    "greedy": ([], None, {"fused_mha": MHA_PER_ENCODE, "stack_step": T_ANS,
                          "combine_copy_mass": 0,
                          "single_query_mha": 2 * DEC_LAYERS * T_ANS,
                          "additive_scores": 2 * T_ANS}),
    "pallas": (["--fast_argmax", "pallas"], "pallas",
               {"fused_mha": MHA_PER_ENCODE, "stack_step": T_ANS,
                "combine_copy_mass": T_ANS,
                "single_query_mha": 2 * DEC_LAYERS * T_ANS,
                "additive_scores": 2 * T_ANS}),
    "rank_only": (["--rank_only"], None,
                  {"fused_mha": RANK_ONLY_MHA, "stack_step": 0,
                   "combine_copy_mass": 0, "single_query_mha": 0,
                   "additive_scores": 0})}
# the router's backends and the device-loop flags passed through to both
ROUTER_MODELS = ("case", "masque")
ROUTER_FLAGS = ["--bf16", "--batch_size", str(B), "--warmup", "--continuous",
                "--device_loop", "8", "--chunk_steps", "4", "--fast_argmax",
                "pallas", "--pool_buckets", "5,10", "--lookahead"]


def text_checkpoint(name, vocab, out, dev):
    """``name`` at the serving widths from seed 0 with noisy biases and
    gains, saved in f32 as the port's checkpoint under ``out``; returns
    (cfg, model) cast to bf16, as ``--bf16`` casts at load."""
    from case_rg_tpu_torch.config import ModelConfig
    from case_rg_tpu_torch.models import (build_model_cfg, create_model,
                                          perturb_affine)
    from case_rg_tpu_torch.train.checkpoint import save_checkpoint
    cfg = build_model_cfg(ModelConfig(embedding_size=E, hidden_size=E,
                                      num_heads=H, max_target_length=T_ANS,
                                      max_dec_len=T_ANS), name, vocab)
    model = create_model(name, cfg, device=dev, seed=0)
    perturb_affine(model, torch.Generator(device=dev).manual_seed(1))
    params = dict(model.named_parameters())
    save_checkpoint(out, 0, {"params": params, "ema": params, "step": 0})
    del params
    return (cfg.replace(param_dtype="bfloat16"),
            model.to(torch.bfloat16).eval())


def exported_vs_live(art, live, batches, launches, what):
    """The loaded archive and the live predict on the same batches: outputs
    equal bit for bit, each kernel's launches a batch (the counters set to
    0 before each call) equal to each other and to ``launches`` (a dict,
    or a function of the batch's outputs that gives one), ms per batch by
    the host clock (after a warm call), and a profiled batch's device busy
    ms and idle share."""
    from case_rg_tpu_torch.runtime.graphs import launch_counts
    res, outs = {}, {}
    for name, fn in (("live", live), ("exported", art.call)):
        fn(batches[0])
        torch.cuda.synchronize()
        ms, counts, outs[name] = [], [], []
        want = []
        for bt in batches:
            for mod in graph_counters():
                mod.LAUNCHES = 0
            t0 = time.perf_counter()
            out = fn(bt)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            counts.append(launch_counts())
            outs[name].append({k: v.cpu() for k, v in out.items()})
            want.append(launches(outs[name][-1]) if callable(launches)
                        else launches)
        check(counts == want, f"export {what}: {name} launches {counts} a "
              f"batch, expected {want}")
        prof = profile_device(fn, batches[:1])
        res[name] = {"ms_per_batch": ms, "launches_per_batch": counts[0],
                     **{k: prof[k] for k in ("device_busy_ms_per_batch",
                                             "device_idle_share")}}
    for i, (g, w) in enumerate(zip(outs["exported"], outs["live"])):
        check(sorted(g) == sorted(w) and all(torch.equal(g[k], w[k])
                                             for k in w),
              f"export {what}: batch {i} differs from the live predict")
    return res


def serve_router(prep, outs, reqs):
    """cli/serve_multi with a backend per ROUTER_MODELS, ROUTER_FLAGS passed
    through, in a thread; TEXT_CLIENTS clients POST the requests TEXT_LINES
    to a POST (the clients' clock times the window); then one streamed
    request (the second, routed to the second backend: its answer equal to
    the one it got among the others), /healthz and /varz. Returns ({id:
    response}, the streamed lines, /varz, requests/s, startup s)."""
    import threading
    import urllib.request
    from case_rg_tpu_torch.cli.serve_multi import main as multi_main
    holder, ready = {}, threading.Event()

    def on_ready(server):
        holder["server"] = server
        ready.set()

    argv = ["--listen", "127.0.0.1:0", "--prepared_dir", prep]
    for m in ROUTER_MODELS:
        argv += ["--backend", f"{m}={outs[m]}"]
    t0 = time.perf_counter()
    router = threading.Thread(target=multi_main,
                              args=(argv + ["--"] + ROUTER_FLAGS,),
                              kwargs={"_server_ready": on_ready}, daemon=True)
    router.start()
    got, errors = {}, []
    try:
        check(ready.wait(timeout=600), "router: did not come up")
        startup_s = time.perf_counter() - t0
        base = "http://%s:%d" % holder["server"].server_address[:2]

        def post(lines):
            data = "".join(json.dumps(x) + "\n" for x in lines).encode()
            rq = urllib.request.Request(base + "/", data=data, method="POST")
            with urllib.request.urlopen(rq, timeout=300) as r:
                return [json.loads(x) for x in r.read().decode().splitlines()]

        posts = [reqs[i:i + TEXT_LINES]
                 for i in range(0, len(reqs), TEXT_LINES)]

        def client(c):
            try:
                for lines in posts[c::TEXT_CLIENTS]:
                    for resp in post(lines):
                        got[resp["id"]] = resp
            except Exception as e:        # reported by the main thread
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(TEXT_CLIENTS)]
        t1 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        window_s = time.perf_counter() - t1
        check(not errors, f"router: client errors {errors[:3]}")
        streamed = post([dict(reqs[1], id="stream", stream=True)])
        check(streamed[-1]["answer"] == got[reqs[1]["id"]]["answer"],
              "router: the streamed answer")
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            check(r.status == 200, "router: /healthz")
        with urllib.request.urlopen(base + "/varz", timeout=60) as r:
            varz = json.loads(r.read().decode())
    finally:
        if "server" in holder:
            holder["server"].shutdown()
        router.join(timeout=60)
    check(not router.is_alive(), "router: did not stop")
    return got, streamed, varz, len(reqs) / window_s, startup_s


def export_and_router(dev):
    """Phase 15 (module docstring): (a) cli/export_model of CaSE at the
    serving widths, greedy and rank-only, each loaded archive held to the
    live predict; (b) cli/serve --from_export against the checkpoint's
    fixed-trip serving on the text requests; (c) the router over CaSE and
    Masque device-loop backends against each backend alone. Returns the
    phase's record; prints a line per part."""
    import shutil
    from case_rg_tpu_torch.cli.export_model import main as export_main
    from case_rg_tpu_torch.config import DataConfig
    from case_rg_tpu_torch.data.vocab import Vocabulary
    from case_rg_tpu_torch.runtime.exported import (ExportedPredict,
                                                    export_predict, graph_ops)
    from case_rg_tpu_torch.runtime.inference import make_predict_fn
    from case_rg_tpu_torch.serving.featurize import chunk_to_batch

    t_phase = time.perf_counter()
    auto_routing()
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    prep = os.path.join(EXPORT_DIR, "prepared")
    os.makedirs(prep)
    words, pieces = text_vocab(os.path.join(prep, "vocab.txt"))
    vocab = Vocabulary.load(os.path.join(prep, "vocab.txt"))
    reqs = text_requests(words, pieces, N_TEXT)
    req_path = os.path.join(EXPORT_DIR, "requests.jsonl")
    with open(req_path, "w") as f:
        for r in reqs:
            f.write(json.dumps(r) + "\n")
    outs, models = {}, {}
    for m in ROUTER_MODELS:
        outs[m] = os.path.join(EXPORT_DIR, m)
        models[m] = text_checkpoint(m, vocab, outs[m], dev)
    cfg, model = models.pop("case")
    del models
    torch.cuda.empty_cache()
    dcfg = DataConfig(query_len=LQ, passage_len=LP, num_passage=P,
                      answer_len=T_ANS)
    batches = [chunk_to_batch(reqs[i:i + B], "case", vocab, dcfg, B)
               for i in (0, B)]
    res = {"setup_s": time.perf_counter() - t_phase}

    # (a) the export CLI, each variant's archive against the live predict
    common = ["--model", "case", "--prepared_dir", prep, "--output_path",
              outs["case"], "--bf16", "--batch_size", str(B)]
    arts = {}
    for name, (flags, mode, launches) in EXPORT_VARIANTS.items():
        live = make_predict_fn(model, cfg, T_ANS, early_exit=False,
                               fast_argmax=mode, rank_only=name == "rank_only",
                               device=dev)
        if name == "pallas":
            # traced in process, not saved: an archive's save and load
            # take about 30 s at these widths, and greedy's show them; kept
            # for phase 16 (b), its parameters the model's own
            t0 = time.perf_counter()
            program = export_predict(model, cfg, batches[0], T_ANS,
                                     fast_argmax=mode, device=dev)
            rec = {"export_s": time.perf_counter() - t0,
                   "ops": graph_ops(program),
                   "nodes": len(program.graph.nodes)}
            art = pallas = ExportedPredict(program, ["cuda"])
            del program
        else:
            arts[name] = os.path.join(EXPORT_DIR, f"case_{name}.pt2")
            rep = export_main(common + ["--out", arts[name], "--check"]
                              + flags)
            rec = {k: rep[k] for k in ("export_s", "save_s", "load_s",
                                       "ops", "nodes")}
            rec["artifact_mb"] = rep["bytes"] / 1e6
            art = rep.pop("artifact")
            if name == "greedy":
                loaded = art            # (b) serves it: one load a phase
        check(set(rec["ops"]) == {k for k, n in launches.items() if n},
              f"export {name}: ops in the graph {rec['ops']}")
        rec.update(exported_vs_live(art, live, batches, launches, name))
        del art
        res[f"a_{name}"] = rec
        print(f"export and multi-model serving (a) {name}: "
              + json.dumps(rec), flush=True)
    del live
    res["early_exit"] = early_exit_export(dev, cfg, model, batches,
                                          res["a_pallas"], pallas)
    print("early-exit export: " + json.dumps(res["early_exit"]), flush=True)
    del model, pallas
    torch.cuda.empty_cache()

    # (b) cli/serve --from_export = cli/serve --no-early_exit from the
    # checkpoint, on the text requests. The archive is the one (a) loaded
    # from the file (a load takes 20-23 s at these widths; cut to one a
    # phase to make room for phase 17)
    from case_rg_tpu_torch.runtime import exported as exported_mod
    real_load = exported_mod.load_exported
    exported_mod.load_exported = lambda path, platforms: (
        loaded if path == arts["greedy"] else real_load(path, platforms))
    try:
        got_art, run_art = serve_text_mode(
            ["--prepared_dir", prep, "--from_export", arts["greedy"],
             "--input", req_path, "--warmup"], [],
            os.path.join(EXPORT_DIR, "b_art.jsonl"))
    finally:
        exported_mod.load_exported = real_load
    del loaded
    got_ck, run_ck = serve_text_mode(
        common + ["--input", req_path, "--warmup"],
        ["--no-early_exit"], os.path.join(EXPORT_DIR, "b_ck.jsonl"))
    same_responses(got_art, got_ck, "(b) --from_export vs the checkpoint")
    res["b_from_export"] = {
        "from_export": run_art.report(N_TEXT),
        "checkpoint_no_early_exit": run_ck.report(N_TEXT)}
    print("export and multi-model serving (b): " + json.dumps(
        res["b_from_export"]), flush=True)

    # (c) the router: half the requests to each backend, each response equal
    # to that backend's alone through cli/serve
    routed = [dict(r, model=ROUTER_MODELS[i % 2]) for i, r in enumerate(reqs)]
    got, streamed, varz, rps, startup_s = serve_router(prep, outs, routed)
    rec = {"requests_per_s": rps, "startup_s": startup_s,
           "varz": {m: {k: varz[m].get(k) for k in (
               "requests_served", "errors", "continuous")} for m in varz}}
    check(set(varz) == set(ROUTER_MODELS), f"router: /varz {sorted(varz)}")
    check(streamed[-1].get("done") is True
          and all("delta" in x for x in streamed[:-1]),
          f"router: stream {streamed[-1]}")
    for m in ROUTER_MODELS:
        mine = [dict(r) for r in routed if r["model"] == m]
        for r in mine:
            del r["model"]
        path = os.path.join(EXPORT_DIR, f"c_{m}.jsonl")
        with open(path + ".in", "w") as f:
            for r in mine:
                f.write(json.dumps(r) + "\n")
        alone, run = serve_text_mode(
            ["--model", m, "--prepared_dir", prep, "--output_path", outs[m],
             "--input", path + ".in"], ROUTER_FLAGS, path)
        same_responses([got.get(r["id"]) for r in mine], alone,
                       f"(c) router vs {m} alone")
        check(varz[m]["requests_served"] == len(mine) + (m == "masque")
              and varz[m]["errors"] == 0, f"router: /varz of {m}")
        rec[f"{m}_alone"] = run.report(len(mine))
    res["c_router"] = rec
    print("export and multi-model serving (c): " + json.dumps(rec),
          flush=True)
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    res["phase_s"] = time.perf_counter() - t_phase
    return res


# ---- phase 16: training options and early-exit export ----

# the training options of one step, each against the default (cli/run's
# --seeded_dropout and --remat; the default is bf16 over f32 masters with
# the in-kernel-RNG training attention)
TRAIN_OPTIONS = {"default": (False, ""), "seeded_dropout": (True, ""),
                 "remat_dots": (False, "dots"),
                 "remat_dots_batch": (False, "dots_batch"),
                 "remat_nothing": (False, "nothing")}
OPTION_STEPS = 2            # timed steps an option, after one warm-up step
# a bf16-score step's loss against the f32-score step's, relative, and
# its gradients' cosine with theirs (computed in f64; they must differ)
BF16_SCORES_LOSS_RTOL = 0.01
BF16_SCORES_GRAD_COSINE = 0.999
# dense attend calls in a CaSE train step's forward: the decoders' causal
# self-attention (an additive bias keeps it off the kernels), a layer each
# of the two 4-layer stacks; the sites --bf16_scores reaches
DENSE_ATTEND = 2 * DEC_LAYERS


def option_steps(dev, trainer, fresh, batch, name):
    """One option's reading: the first step's losses and gradients (from
    the fresh parameters and generator), the training kernels' launches in
    it and its calls of the dense ``attend`` (all, and those that take
    bf16 scores), ms a step by the host clock over OPTION_STEPS steps
    after a warm-up, the peak of allocated device memory over those steps,
    and a profiled step's device busy ms."""
    from case_rg_tpu_torch.kernels import additive_attention as aa
    from case_rg_tpu_torch.kernels import train_attention as ta
    from case_rg_tpu_torch.ops import attention
    st, gen = fresh()
    torch.cuda.synchronize()
    ta.LAUNCHES_FWD["rng"] = ta.LAUNCHES_BWD["rng"] = 0
    aa.LAUNCHES = aa.LAUNCHES_BWD = 0
    dense, bf16 = attention.attend, []

    def counted(q, k, v, **kw):
        bf16.append(attention._score_dtype(q.dtype) == torch.bfloat16)
        return dense(q, k, v, **kw)
    attention.attend = counted
    try:
        losses, grads = trainer.loss_and_grads(st, batch, gen)
    finally:
        attention.attend = dense
    torch.cuda.synchronize()
    launches = {"train_mha_rng": [ta.LAUNCHES_FWD["rng"],
                                  ta.LAUNCHES_BWD["rng"]],
                "additive_scores": [aa.LAUNCHES, aa.LAUNCHES_BWD],
                "dense_attend": [len(bf16), sum(bf16)]}
    flat = torch.cat([g.float().flatten() for g in grads.values()])
    del grads
    st, gen = fresh()
    trainer.train_step(st, batch, gen)               # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    times = []
    for _ in range(OPTION_STEPS):
        t0 = time.perf_counter()
        o = trainer.train_step(st, batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    check(bool(torch.isfinite(o["total"])), f"options {name}: loss")
    prof = profile_device(lambda bt: trainer.train_step(st, bt, gen),
                          [batch])
    return losses["total"].item(), flat, {
        "launches": launches,
        "losses": {k: v.item() for k, v in losses.items()},
        "ms_per_step": times,
        "device_busy_ms_per_step": prof["device_busy_ms_per_batch"],
        "device_idle_share": prof["device_idle_share"],
        "peak_allocated_mb": peak / 1e6,
        "peak_above_state_mb": (peak - base) / 1e6}


def train_options(dev):
    """Phase 16 (a): CaSE at the serving widths, dropout 0.1, B=64, bf16
    over f32 masters, the default in-kernel-RNG training attention: a step
    from the same parameters and generator seed under each of
    TRAIN_OPTIONS, its loss equal to the default's bit for bit and its
    gradients at cosine >= FIRST_GRAD_COSINE (the embedding gradient's
    accumulating index_put adds in no fixed order), the training kernels'
    launches and the dense attend calls (remat runs each forward twice);
    then bf16 attention scores on and off (the DENSE_ATTEND sites take
    them, the gradients move at cosine >= BF16_SCORES_GRAD_COSINE), and a
    remat step under no_host_sync."""
    from case_rg_tpu_torch.config import ModelConfig, TrainConfig
    from case_rg_tpu_torch.device import batch_to_device, no_host_sync
    from case_rg_tpu_torch.models import create_model, perturb_affine
    from case_rg_tpu_torch.ops import attention
    from case_rg_tpu_torch.ops.dropout import set_seeded_dropout
    from case_rg_tpu_torch.train.trainer import Trainer

    auto_routing()
    cfg = ModelConfig(name="case", vocab_size=V, embedding_size=E,
                      hidden_size=E, num_heads=H, enc_layers=ENC_LAYERS,
                      dec_layers=DEC_LAYERS, max_dec_len=T_ANS,
                      max_target_length=T_ANS, dropout=RATE,
                      param_dtype="float32")
    model = create_model("case", cfg, device=dev, seed=0)
    perturb_affine(model, torch.Generator(device=dev).manual_seed(1))
    init = {k: v.detach().clone() for k, v in model.named_parameters()}
    batch = batch_to_device(make_train_batch(np.random.RandomState(1)), dev)

    def fresh():
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(init[k])
        return trainer.init_state(), torch.Generator(device=dev).manual_seed(7)

    res = {}
    try:
        ref = None
        for name, (seeded, remat) in TRAIN_OPTIONS.items():
            set_seeded_dropout(seeded)
            trainer = Trainer(model, TrainConfig(
                batch_size=B, learning_rate=2.5e-4, warmup_steps=1,
                compute_dtype="bfloat16", remat=remat), total_steps=1000,
                device=dev)
            loss, flat, rec = option_steps(dev, trainer, fresh, batch, name)
            fwd = TRAIN_SITES_PER_STEP * (2 if remat else 1)
            want = {"train_mha_rng": [fwd, TRAIN_SITES_PER_STEP],
                    "additive_scores": [4 if remat else 2, 2],
                    "dense_attend": [DENSE_ATTEND * (2 if remat else 1),
                                     0]}
            check(rec["launches"] == want, f"options {name}: launches "
                  f"{rec['launches']}, expected {want}")
            if ref is None:
                ref = (loss, flat)
            cosine = F.cosine_similarity(flat, ref[1], dim=0).item()
            check(loss == ref[0], f"options {name}: loss {loss} vs the "
                  f"default's {ref[0]}")
            check(cosine >= FIRST_GRAD_COSINE, f"options {name}: gradient "
                  f"cosine {cosine}")
            rec.update(loss=loss, grad_cosine=cosine,
                       grad_max_abs_diff=(flat - ref[1]).abs().max().item())
            del flat
            res[name] = rec
            print(f"training options {name}: " + json.dumps(rec),
                  flush=True)
        # bf16 scores: the default's step with the switch on; the default
        # keeps f32 scores
        set_seeded_dropout(False)
        trainer = Trainer(model, TrainConfig(
            batch_size=B, learning_rate=2.5e-4, warmup_steps=1,
            compute_dtype="bfloat16"), total_steps=1000, device=dev)
        attention.set_bf16_scores(True)
        loss, flat, rec = option_steps(dev, trainer, fresh, batch,
                                       "bf16_scores")
        attention.set_bf16_scores(False)
        l32 = res["default"]["loss"]
        # the switch reaches the dense sites, and their gradients move
        cosine = F.cosine_similarity(flat.double(), ref[1].double(),
                                     dim=0).item()
        diff = (flat - ref[1]).abs().max().item()
        del flat, ref
        check(rec["launches"]["dense_attend"] == [DENSE_ATTEND] * 2,
              f"options bf16_scores: dense attend calls (all, bf16 scores) "
              f"{rec['launches']['dense_attend']}, expected {DENSE_ATTEND}")
        check(np.isfinite(loss) and abs(loss - l32) <= BF16_SCORES_LOSS_RTOL
              * abs(l32), f"options bf16_scores: loss {loss} vs f32 scores "
              f"{l32}")
        check(diff > 0 and cosine >= BF16_SCORES_GRAD_COSINE,
              f"options bf16_scores: gradients vs f32 scores: largest "
              f"difference {diff}, cosine {cosine}")
        rec.update(loss=loss, f32_scores_loss=l32,
                   f32_scores_losses=res["default"]["losses"],
                   loss_rel_diff=abs(loss - l32) / abs(l32),
                   grad_cosine=cosine, grad_max_abs_diff=diff)
        res["bf16_scores"] = rec
        print("training options bf16_scores: " + json.dumps(rec),
              flush=True)
        trainer = Trainer(model, TrainConfig(
            batch_size=B, learning_rate=2.5e-4, warmup_steps=1,
            compute_dtype="bfloat16", remat="dots"), total_steps=1000,
            device=dev)
        st, gen = fresh()
        with no_host_sync():
            o = trainer.train_step(st, batch, gen)
        check(bool(torch.isfinite(o["total"])), "sync check: remat step")
        res["sync_check"] = "a remat dots step under no_host_sync"
    finally:
        set_seeded_dropout(False)
        attention.set_bf16_scores(False)
    del model, init, trainer, st
    torch.cuda.empty_cache()
    return res


# EOS pushes tried in turn (phase 16 (b)) until every row of a batch ends
# before T_ANS; then up to EOS_BISECT halvings of the last interval while
# the loop stops before a quarter of T_ANS (random weights flip from no
# row ending to every row ending at the first step over a narrow range)
EOS_PUSHES = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0)
EOS_BISECT = 10


def push_to_early_exit(model, cfg, live, batch):
    """Push CaSE's EOS (``push_eos``) until every row of ``batch`` ends
    before T_ANS in the live early-exit predict ``live``, aiming at a
    stop past T_ANS // 4 (EOS_PUSHES, EOS_BISECT). Returns (push, steps
    run); fails the run if no push ends every row early."""
    pushed, lo, hi, n = 0.0, 0.0, None, T_ANS
    dec = model.decoder
    base = (dec.gen1.bias.detach().clone(), dec.mix.bias.detach().clone())

    def to(x):
        nonlocal pushed
        push_eos(model, cfg, x, base)
        pushed = x
        return steps_run(live(batch)["answer"])
    for x in EOS_PUSHES:
        n = to(x)
        if n < T_ANS:
            hi = x
            break
        lo = x
    check(n < T_ANS, f"early exit: {n} steps run with the EOS logit pushed "
          f"by {pushed}")
    best = (hi, n)
    for _ in range(EOS_BISECT):
        if best[1] >= T_ANS // 4:
            break
        mid = (lo + hi) / 2
        m = to(mid)
        if m < T_ANS:
            hi, best = mid, (mid, m)
        else:
            lo = mid
    if pushed != best[0]:
        to(best[0])
    return best


def push_eos(model, cfg, x, base):
    """CaSE's EOS logit raised by ``x`` (the generator's hidden bias moved
    along the EOS row of its vocabulary projection, which has no bias) and
    the mix head's generation logit by ``x`` (random weights leave the
    copy distributions most of the mass), from ``base``, the two biases
    unpushed. In place: programs traced from ``model`` share its
    parameters and see the push too."""
    dec = model.decoder
    w = dec.gen2.weight[cfg.eos_id].float()
    with torch.no_grad():
        dec.gen1.bias.copy_(base[0] + (x * w / w.square().sum()).to(
            base[0].dtype))
        dec.mix.bias.copy_(base[1])
        dec.mix.bias[0] += x


def steps_run(answer) -> int:
    """Steps a greedy loop ran: the last column holding a token, plus 1."""
    cols = (answer != 0).any(0).nonzero()
    return int(cols.max()) + 1 if len(cols) else 0


def early_exit_export(dev, cfg, model, batches, fixed, fixed_art):
    """Phase 16 (b), run on phase 15's CaSE (bf16, the serving widths) and
    its two B=64 batches of text requests: the early-exit decode (a
    while_loop) traced in process with --fast_argmax pallas, held to the
    live early-exit predict (outputs equal bit for bit, each kernel's
    launches a batch equal, and as EXPORT_VARIANTS' pallas program says
    per step run); export s, graph nodes, steps run, ms a batch and device
    busy ms beside ``fixed``, the record of phase 15 (a)'s fixed-trip
    pallas program (``fixed_art``) on the same batches. Then the EOS logit
    pushed (EOS_PUSHES) until every row of the first batch ends before
    T_ANS: the early-exit program against the live early-exit predict
    again, its steps run below T_ANS, and the fixed-trip program against
    its live predict on that batch. Last, what the loop body's copies of
    the carried caches cost a step."""
    from case_rg_tpu_torch.runtime.exported import (ExportedPredict,
                                                    export_predict, graph_ops)
    from case_rg_tpu_torch.runtime.inference import make_predict_fn
    per_step = EXPORT_VARIANTS["pallas"][2]
    steps = []

    def launches(out):
        n = steps_run(out["answer"])
        steps.append(n)
        return {k: v if k == "fused_mha" else v // T_ANS * n
                for k, v in per_step.items()}

    live = make_predict_fn(model, cfg, T_ANS, early_exit=True,
                           fast_argmax="pallas", device=dev)
    t0 = time.perf_counter()
    program = export_predict(model, cfg, batches[0], T_ANS, early_exit=True,
                             fast_argmax="pallas", device=dev)
    rec = {"export_s": time.perf_counter() - t0,
           "nodes": len(program.graph.nodes), "ops": graph_ops(program),
           "body_nodes": len(
               program.graph_module.while_loop_body_graph_0.graph.nodes)}
    early = ExportedPredict(program, ["cuda"])
    del program
    rec.update(exported_vs_live(early, live, batches, launches,
                                "(16) early exit"))
    # launches() ran on the live outputs, then on the exported ones
    rec["steps_run"] = steps[:len(batches)]
    rec["fixed_trip"] = {k: fixed[k] for k in ("export_s", "nodes")}
    rec["fixed_trip"].update({k: fixed["exported"][k] for k in (
        "ms_per_batch", "device_busy_ms_per_batch", "device_idle_share")})

    # every row ending early
    pushed, n = push_to_early_exit(model, cfg, live, batches[0])
    steps.clear()
    ee = exported_vs_live(early, live, batches[:1], launches,
                          "(16) early exit, EOS pushed")
    check(steps == [n, n], f"early exit, EOS pushed: steps run {steps}, "
          f"the live predict's {n}")
    fixed_live = make_predict_fn(model, cfg, T_ANS, early_exit=False,
                                 fast_argmax="pallas", device=dev)
    ft = exported_vs_live(fixed_art, fixed_live, batches[:1], per_step,
                          "(16) fixed trip, EOS pushed")
    rec["eos_pushed"] = {
        "push": pushed, "steps_run": n,
        "early_exit": {k: ee["exported"][k] for k in (
            "ms_per_batch", "device_busy_ms_per_batch", "device_idle_share")},
        "live_early_exit": {k: ee["live"][k] for k in (
            "ms_per_batch", "device_busy_ms_per_batch")},
        "fixed_trip": {k: ft["exported"][k] for k in (
            "ms_per_batch", "device_busy_ms_per_batch", "device_idle_share")}}
    del early, live, fixed_live
    # the loop body's copies: the passage stack's [B, layers, T, 2E] cache,
    # the query stack's per-layer [B, T, 2E] caches and the [B, T] history
    caches = [torch.zeros(B, DEC_LAYERS, T_ANS, 2 * E, dtype=torch.bfloat16,
                          device=dev)]
    caches += [torch.zeros(B, T_ANS, 2 * E, dtype=torch.bfloat16, device=dev)
               for _ in range(DEC_LAYERS)]
    caches.append(torch.zeros(B, T_ANS, dtype=torch.bool, device=dev))
    rec["carry_copy"] = {
        "bytes_a_step": 2 * nbytes(*caches),
        "us_a_step": 1e3 * device_ms(lambda: [c.clone() for c in caches])}
    del caches
    torch.cuda.empty_cache()
    return rec


# ---- phase 17: serving over cards (runtime/replicas) ----

# Serving and testing split each batch by rows over one replica of the
# model a card (the JAX serving mesh's data axis). On a one-card machine
# the phase runs two replicas on cuda:0 (two threads, a stream each); with
# more cards also one a card (cuda:0,cuda:1).
REPLICA_BATCHES = 1           # B=64 batches a decode mode (2 timed)
# (b)'s continuous requests, the first of phase 7's N_REQUESTS (512 until
# phase 18 needed the room)
REPLICA_REQUESTS = 256
REPLICA_SEED = 21             # their requests
REPLICA_SAMPLE_SEED = 17
REPLICA_MODES = {
    "greedy_dense": {}, "greedy_pallas": {"fast_argmax": "pallas"},
    "sampled": dict(decoding="sample", sample_seed=REPLICA_SAMPLE_SEED,
                    **SAMPLE_CONTROLS),
    "beam4": {"beam_width": BEAM_WIDTH}, "rank_only": {"rank_only": True}}


def replica_specs():
    specs = ["cuda:0,cuda:0"]
    n = torch.cuda.device_count()
    if n > 1:
        specs.append("cuda:0,cuda:1")
    if n >= 4:
        specs.append("cuda:0,cuda:1,cuda:2,cuda:3")
    return specs


def host_out(out):
    """A predict's outputs as host tensors (bf16 as f32, as HostCopy)."""
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).cpu()
            for k, v in out.items()}


def replica_agreement(merged, full):
    """``agreement`` of merged replica outputs with one card's, for modes
    with or without answers."""
    if "answer" in merged[0]:
        return agreement(merged, full)
    ulps = max(bf16_ulps(m["rank"], f["rank"])[0]
               for m, f in zip(merged, full))
    return {"rank_max_ulps": ulps}


def replicas_predict(dev, cfg, model, spec, witness):
    """(a) make_replicated_predict in each REPLICA_MODES mode over the
    replicas of ``spec``: each replica's rows equal one replica's predict
    on the same row block bit for bit (the batch's sampling keys drawn once
    a call, a block its rows' keys), the kernels' launches a batch the sum
    over the blocks, and the merged batch held to one card at B=64 by the
    serving gates (rank within RANK_ULPS, token agreement beside the
    exact-sum ``witness``). Then requests/s and device busy/idle share of
    one replica against the replicas, greedy dense, in turns."""
    from case_rg_tpu_torch.decode.loops import keys_from_seed
    from case_rg_tpu_torch.device import resolve_devices
    from case_rg_tpu_torch.runtime.inference import (make_predict_fn,
                                                     make_replicated_predict)
    from case_rg_tpu_torch.runtime.replicas import Replicas
    reps = Replicas(model, resolve_devices(spec, [B]))
    d, res = len(reps), {}
    n = B // d
    rng = np.random.RandomState(REPLICA_SEED)
    batches = [make_batch(rng) for _ in range(REPLICA_BATCHES)]
    try:
        for name, kw in REPLICA_MODES.items():
            fn = make_replicated_predict(reps, cfg, T_ANS, **kw)
            one = make_predict_fn(model, cfg, T_ANS, device=dev, **kw)
            sampled = kw.get("decoding") == "sample"
            fn(batches[0]).get()                     # warm-up: call 0
            torch.cuda.synchronize()
            reset_kernel_counts()
            merged = [fn(bt).get() for bt in batches]
            torch.cuda.synchronize()
            launches = kernel_counts()
            keyed = [dict(bt, sample_key=keys_from_seed(
                REPLICA_SAMPLE_SEED, B, stream=1 + j).numpy())
                if sampled else bt for j, bt in enumerate(batches)]
            reset_kernel_counts()
            same = 0
            for m, bt in zip(merged, keyed):
                for i in range(d):
                    ref = host_out(one(take(bt, slice(i * n, (i + 1) * n))))
                    same += all(np.array_equal(m[k][i * n:(i + 1) * n],
                                               ref[k].numpy()) for k in ref)
            torch.cuda.synchronize()
            block_launches = kernel_counts()
            check(same == d * len(batches),
                  f"replicas {spec} {name}: {d * len(batches) - same} row "
                  "blocks differ from one replica's predict on them")
            check(launches == block_launches and any(launches.values()),
                  f"replicas {spec} {name}: launches {launches}, the blocks "
                  f"on one replica {block_launches}")
            full = [host_out(one(bt)) for bt in keyed]
            vs = replica_agreement([{k: torch.as_tensor(v) for k, v in
                                     m.items()} for m in merged], full)
            check(vs["rank_max_ulps"] <= RANK_ULPS,
                  f"replicas {spec} {name} vs one card: {vs}")
            if "token_agreement" in vs:        # every mode with answers
                check(vs["token_agreement"] >= MIN_TOKEN_AGREEMENT
                      and vs["first_token_agreement"]
                      >= MIN_FIRST_TOKEN_AGREEMENT,
                      f"replicas {spec} {name} vs one card: {vs}")
            if name.startswith("greedy"):      # rounding alone, as witnessed
                for key in ("token_agreement", "first_token_agreement"):
                    check(vs[key] >= witness[key] - AGREEMENT_SLACK,
                          f"replicas {spec} {name} vs one card: {vs}, the "
                          f"exact-sum witness {witness}")
            res[name] = {"launches": launches, "blocks_bit_equal": same,
                         "vs_one_card": vs}

        # requests/s and busy/idle share: one replica against the replicas,
        # greedy dense, 2 x REPLICA_BATCHES batches each, in turns
        alone = Replicas(model, [dev])
        fns = {1: make_replicated_predict(alone, cfg, T_ANS),
               d: make_replicated_predict(reps, cfg, T_ANS)}
        rate = {1: [], d: []}
        timed_batches = (batches * 2)[:2]
        for k in (1, d, d, 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pend = [fns[k](bt) for bt in timed_batches]
            for p in pend:
                p.get()
            torch.cuda.synchronize()
            rate[k].append(len(timed_batches) * B
                           / (time.perf_counter() - t0))
        res["requests_per_s"] = {f"{k} replica(s)": v for k, v in rate.items()}
        res["profile"] = {f"{k} replica(s)": {
            x: v for x, v in profile_device(
                lambda bt, f=fns[k]: f(bt).get(), batches).items()
            if x != "top_kernels"} for k in (1, d)}
        res["host_threads"] = replica_host_threads(
            alone, reps, fns[1], fns[d], timed_batches)
        res["guard"] = guard_cost(dev, res["greedy_dense"]["launches"], d)
    finally:
        reps.close()
    return res


def host_times(reps, fn, batches) -> dict:
    """``fn`` over ``batches``, a batch at a time: wall ms a batch, each
    replica thread's CPU ms a batch (``time.thread_time`` read in the
    thread), and the process's CPU ms a batch (every thread's, the
    intra-op pools' too)."""
    d = len(reps)
    cpu = lambda: reps.map(lambda i, _: time.thread_time(), [None] * d)
    torch.cuda.synchronize()
    c0, p0, t0 = cpu(), time.process_time(), time.perf_counter()
    for bt in batches:
        fn(bt).get()
    torch.cuda.synchronize()
    t1, p1, c1 = time.perf_counter(), time.process_time(), cpu()
    n = len(batches)
    return {"wall_ms": (t1 - t0) * 1e3 / n,
            "thread_cpu_ms": [(b - a) * 1e3 / n for a, b in zip(c0, c1)],
            "process_cpu_ms": (p1 - p0) * 1e3 / n}


def replica_host_threads(alone, reps, one, fn, batches) -> dict:
    """What the replicas' host threads spend a greedy batch on: one replica
    against d (``host_times``). A thread that waits for the GIL or for the
    card is off the CPU: its CPU ms fall short of the wall ms. (The GIL's
    switch interval at 0.1 and 20 ms and one intra-op thread a replica
    moved the wall by -2 to +16 %, PERF.md §6; cut to make room for phase
    18.)"""
    d = len(reps)
    return {"intra_op_threads": torch.get_num_threads(),
            "switch_interval_ms": sys.getswitchinterval() * 1e3,
            "1 replica": host_times(alone, one, batches),
            f"{d} replicas": host_times(reps, fn, batches)}


def guard_cost(dev, launches, d) -> dict:
    """The host time of the kernel wrappers' card guard
    (``kernels/_build.on_input_card`` around a launcher that does nothing)
    with the input's card current, against the bare call, a launch and a
    one-card greedy batch (``launches``: a batch's kernel launches over d
    replicas, each replica's block launching what one card's batch
    launches)."""
    from case_rg_tpu_torch.kernels import _build
    x, n = torch.zeros(1, device=dev), 20000

    def bare(x):
        return x
    guarded = _build.on_input_card(bare)

    def per_call(fn):
        t0 = time.perf_counter()
        for _ in range(n):
            fn(x)
        return (time.perf_counter() - t0) * 1e6 / n
    us = min(per_call(guarded) for _ in range(3)) \
        - min(per_call(bare) for _ in range(3))
    per_batch = sum(launches.values()) // (REPLICA_BATCHES * d)
    return {"us_per_launch": us, "launches_per_batch": per_batch,
            "ms_per_batch": us * per_batch / 1e3}


def replicas_continuous(dev, cfg, model, reqs, caps, spec, chunk_base,
                        sampled_base):
    """(b) The first REPLICA_REQUESTS continuous requests over the replicas
    of ``spec``
    (run_continuous_replicated: a loop a replica at B/d rows and REFILL/d
    refills): the chunk loop (launch counters set to 0 just before and read
    just after, as the one-card formula gives them; the replicas' first
    run, so its time includes their first calls), the sampled chunk loop
    and the device loop (ring DL_RING/d; warmed up, then timed). Each
    answer against the one-card run's (``chunk_base``, ``sampled_base``;
    the device loop = the chunk loop on one card): the share equal token
    for token, and the agreement gates."""
    from case_rg_tpu_torch.device import resolve_devices
    from case_rg_tpu_torch.runtime.continuous import (
        make_continuous_fns, make_device_loop_fns, run_continuous,
        run_continuous_device)
    from case_rg_tpu_torch.runtime.replicas import (Replicas,
                                                    run_continuous_replicated)
    n = REPLICA_REQUESTS
    reps = Replicas(model, resolve_devices(spec, [B, REFILL]))
    d = len(reps)
    b, r = B // d, REFILL // d
    keys = sample_keys(len(caps))
    res = {}

    def over(runs):
        return timed(lambda emit: run_continuous_replicated(
            items(n), runs, emit, [b + r] * d, replicas=reps), n)

    def chunk_runs(sampling):
        kw = dict(decoding="sample", **SAMPLE_CONTROLS) if sampling else \
            dict(fast_argmax="pallas")
        mb = batch_maker(reqs, caps, keys if sampling else None)
        fns = [make_continuous_fns(m, T_ANS, CHUNK_STEPS, device=dv, **kw)
               for m, dv in zip(reps.models, reps.devices)]
        return [lambda src, em, f=f: run_continuous(
            src, mb, *f, batch_size=b, refill=r, emit=em, ordered=False)
            for f in fns]

    def versus(got, base, what):
        equal = sum(np.array_equal(got[i][0], base[i][0]) for i in range(n))
        vs = dict(answer_agreement(got, base, caps, cfg.eos_id),
                  answers_equal=equal)
        check(vs["token_agreement"] >= MIN_TOKEN_AGREEMENT
              and vs["first_token_agreement"] >= MIN_FIRST_TOKEN_AGREEMENT,
              f"replicas {spec} {what} vs one card: {vs}")
        return vs

    try:
        runs = chunk_runs(False)
        reset_kernel_counts()
        got, stats = over(runs)
        launches = kernel_counts()
        steps = CHUNK_STEPS * stats["chunks"]
        want = {"fused_mha": MHA_PER_ENCODE * (d + stats["refills"]),
                "stack_step": steps, "combine_copy_mass": steps,
                "single_query_mha": 2 * DEC_LAYERS * steps,
                "additive_scores": 2 * steps}
        check(launches == want, f"replicas {spec} continuous launches "
              f"{launches}, expected {want}")
        res["chunk_loop"] = dict(stats, launches=launches,
                                 vs_one_card=versus(got, chunk_base,
                                                    "chunk loop"))
        got, stats = over(chunk_runs(True))
        res["sampled_chunk_loop"] = dict(stats, vs_one_card=versus(
            got, sampled_base, "sampled chunk loop"))
        dfns = [make_device_loop_fns(m, T_ANS, DL_STEPS, DL_K, DL_RING // d,
                                     fast_argmax="pallas", device=dv)
                for m, dv in zip(reps.models, reps.devices)]
        mb = batch_maker(reqs, caps)
        runs = [lambda src, em, f=f: run_continuous_device(
            src, mb, f, batch_size=b, refill=r, emit=em, max_len=T_ANS,
            ordered=False, lookahead=True) for f in dfns]
        timed(lambda emit: run_continuous_replicated(    # warm-up: captures
            items(WARM_REQUESTS), runs, emit, [b + r] * d, replicas=reps),
            WARM_REQUESTS)
        replays = [c["replays"] for f in dfns for c in f.captures]
        reset_kernel_counts()
        got, stats = over(runs)
        eager = kernel_counts()
        caps_ = [c for f in dfns for c in f.captures]
        # a capture records its own thread's launches (runtime/graphs.py),
        # so the replays give the loop's launches exactly, as in phase 9
        recorded = {k: sum(c["launches"][k] * (c["replays"] - r0)
                           for c, r0 in zip(caps_, replays)) for k in eager}
        launches = {k: eager[k] + recorded[k] for k in eager}
        steps_run = DL_STEPS * DL_K * stats["megas"]
        want = {"fused_mha": MHA_PER_ENCODE * (d + stats["refills"]),
                "stack_step": steps_run, "combine_copy_mass": steps_run,
                "single_query_mha": 2 * DEC_LAYERS * steps_run,
                "additive_scores": 2 * steps_run}
        n_replays = sum(c["replays"] - r0 for c, r0 in zip(caps_, replays))
        check(len(caps_) == d and n_replays == stats["megas"]
              and launches == want,
              f"replicas {spec} device loop: captures {len(caps_)}, "
              f"{n_replays} replays for {stats['megas']} megas, launches "
              f"{launches} (eager {eager}), expected {want}")
        res["device_loop"] = dict(stats, captures=len(caps_),
                                  launches_eager=eager,
                                  launches_by_replay=recorded,
                                  capture_s=[c["capture_s"] for c in caps_],
                                  vs_one_card=versus(got, chunk_base,
                                                     "device loop"))
    finally:
        reps.close()
    return res


def replicas_text(spec, text):
    """(c) cli/serve on phase 11's 256 text requests over the replicas of
    ``spec``: batched at B=64, equal response for response to one card
    serving at B/d (each replica's rows are one card's batch); the device
    loop (K 8, 4 steps, pool buckets, lookahead) against phase 11's
    one-card JSONL: the share of equal responses, and the agreement of
    answers word for word."""
    common, modes, got = text["common"], text["modes"], text["got"]
    d = spec.count(",") + 1
    res = {}
    per_card = common + ["--batch_size", str(B // d)]
    want, _ = serve_text_mode(per_card, [],
                              os.path.join(TEXT_DIR, "per_card.jsonl"))
    reset_kernel_counts()
    got_b, run = serve_text_mode(common + ["--device", spec], [],
                                 os.path.join(TEXT_DIR, "replicas_a.jsonl"))
    launches = kernel_counts()
    same_responses(got_b, want, f"replicas {spec} batched vs one card at "
                   f"B={B // d}")
    check(launches["stack_step"] > 0 and launches["fused_mha"] > 0,
          f"replicas {spec} text batched: launches {launches}")
    res["a_batched"] = dict(run.report(len(want)), launches=launches)
    got_c, run = serve_text_mode(common + ["--device", spec],
                                 modes["c_device_loop"],
                                 os.path.join(TEXT_DIR, "replicas_c.jsonl"))
    ref = got["c_device_loop"]
    equal = sum(g == w for g, w in zip(got_c, ref))
    words = sum(a == b for g, w in zip(got_c, ref)
                for a, b in zip(g["answer"].split(), w["answer"].split()))
    total = sum(len(w["answer"].split()) for w in ref)
    check(len(got_c) == len(ref) and [g["id"] for g in got_c]
          == [w["id"] for w in ref] and words >= MIN_TOKEN_AGREEMENT * total,
          f"replicas {spec} text device loop: {equal} of {len(ref)} equal, "
          f"{words} of {total} words")
    res["c_device_loop"] = dict(run.report(len(ref)), responses_equal=equal,
                                words_equal=words, words=total)
    return res


def replicas_test(spec, raw):
    """(d) cli/run --mode test --avg_only on phase 13's checkpoints over the
    replicas of ``spec`` at B=64, batched: its result files equal one
    process's at B/d (each replica's rows are that process's batch), the
    serving kernels launched."""
    from case_rg_tpu_torch.cli import run as cli_run
    test_args, out = raw["test_args"], raw["out"]
    d = spec.count(",") + 1
    dirs = {}
    for name in ("replicas", "per_card"):
        dirs[name] = os.path.join(RAW_DIR, f"test_{name}_{d}")
        os.makedirs(dirs[name])
        os.symlink(os.path.join(out, "model"),
                   os.path.join(dirs[name], "model"))
    args = lambda name: [x if x != out else dirs[name] for x in test_args]
    cli_run.main(args("per_card") + ["--avg_only", "--batch_size",
                                     str(B // d)])
    reset_kernel_counts()
    t0 = time.perf_counter()
    cli_run.main(args("replicas") + ["--avg_only", "--device", spec])
    secs = time.perf_counter() - t0
    launches = kernel_counts()
    check(launches["stack_step"] > 0 and launches["fused_mha"] > 0,
          f"replicas {spec} test: launches {launches}")
    ties = same_result_files(os.path.join(dirs["replicas"], "result"),
                             os.path.join(dirs["per_card"], "result"),
                             f"replicas {spec} test vs one process")
    return {"s": secs, "launches": launches, "near_ties": ties,
            "files": sorted(os.listdir(os.path.join(dirs["replicas"],
                                                    "result")))}


def serving_over_cards(dev, cfg, model, reqs, caps, chunk_base,
                       sampled_base, witness, text, raw):
    """Phase 17: (a)-(d) above for every spec of ``replica_specs`` ((d)
    only where phase 13's files are given: ``raw``)."""
    auto_routing()           # the earlier phases' CLIs set the switches
    t_phase = time.perf_counter()
    res = {"specs": replica_specs(), "cards": torch.cuda.device_count()}
    for spec in res["specs"]:
        t0 = time.perf_counter()
        one = {"predict": replicas_predict(dev, cfg, model, spec, witness)}
        print(f"serving over cards {spec} predict: "
              + json.dumps(one["predict"]), flush=True)
        one["continuous"] = replicas_continuous(
            dev, cfg, model, reqs, caps, spec, chunk_base, sampled_base)
        print(f"serving over cards {spec} continuous: "
              + json.dumps(one["continuous"]), flush=True)
        one["text"] = replicas_text(spec, text)
        print(f"serving over cards {spec} text: " + json.dumps(one["text"]),
              flush=True)
        one["test"] = replicas_test(spec, raw) if raw else "not run"
        one["s"] = time.perf_counter() - t0
        print(f"serving over cards {spec} test: " + json.dumps(one["test"]),
              flush=True)
        res[spec] = one
    res["phase_s"] = time.perf_counter() - t_phase
    return res


# ---- phase 18: the pool axis over a device group (runtime/replicas over
#      groups of M devices, models/case.PooledCaSE) ----

# Serving and testing split each row's passage pool M ways over a group of
# M devices (the JAX serving mesh's 'model' axis). On a one-card machine
# the phase runs one group of two on cuda:0 (the shards one after the
# other on one stream); ``--only-pool`` on several cards runs a group over
# two cards, and with four two groups of two.
POOL_M = 2
POOL_BATCHES = 1               # B=64 batches a decode mode (2 timed)
POOL_SEED = 23                 # their requests
POOL_SAMPLE_SEED = 19
POOL_MODES = {
    "greedy_dense": {}, "greedy_mxu": {"fast_argmax": "mxu"},
    "greedy_pallas": {"fast_argmax": "pallas"},
    "beam4": {"beam_width": BEAM_WIDTH},
    "sampled": dict(decoding="sample", sample_seed=POOL_SAMPLE_SEED,
                    **SAMPLE_CONTROLS),
    "rank_only": {"rank_only": True}}
# fused_mha sites an encode: the query side, once a group, and the pool
# side, once a shard (MHA_SITES' rows of B and of B * P)
POOL_QUERY_SITES = {False: MHA_SITES[(B, LQ, E)] + MHA_SITES[(B, LQ, 5 * E)],
                    True: 2 * ENC_LAYERS}
POOL_SHARD_SITES = {False: MHA_SITES[(B * P, LP, E)]
                    + MHA_SITES[(B * P, LP, 5 * E)],
                    True: RANK_ONLY_MHA - 2 * ENC_LAYERS}
# the split against one card (the passage side's GEMMs at B*P/M rows may
# take other cuBLAS algorithms): rank within 4 bf16 ulps, answer tokens at
# least 95 % equal; continuous answers at least 99 % equal
POOL_RANK_ULPS = 4
POOL_MIN_TOKEN_AGREEMENT = 0.95
POOL_MIN_CONT_EQUAL = 0.99


def pool_specs(only: bool):
    """(device list, M): one group of two on cuda:0; with ``only`` and
    more cards, a group over two cards, and two groups of two on four."""
    n = torch.cuda.device_count()
    if not only or n == 1:
        return [("cuda:0,cuda:0", POOL_M)]
    specs = [("cuda:0,cuda:1", POOL_M)]
    if n >= 4:
        specs.append(("cuda:0,cuda:1,cuda:2,cuda:3", POOL_M))
    return specs


def pool_encode_mha(m: int, rank_only: bool = False) -> int:
    """fused_mha launches of one encode over a group of m."""
    return POOL_QUERY_SITES[rank_only] + m * POOL_SHARD_SITES[rank_only]


def ref(one, bt, d):
    """``one`` (a one-card predict) on ``bt``'s d row blocks, the outputs
    on the host in row order: what d groups' predict is held to."""
    n = B // d
    outs = [host_out(one(take(bt, slice(i * n, (i + 1) * n))))
            for i in range(d)]
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def pool_predict(dev, cfg, model, spec, m):
    """(a) make_replicated_predict over groups of ``m`` in each POOL_MODES
    mode against the unsplit one-card predict on the same rows (each
    group's row block; sampled with the same keys): rank within
    POOL_RANK_ULPS, answer tokens at
    least POOL_MIN_TOKEN_AGREEMENT equal, and whether every output is
    equal bit for bit; launches exactly the one-card predict's on the
    row blocks, with fused_mha at the query side's sites once and the pool
    side's m times (8 + 11 m an encode, 6 + 8 m
    rank-only; ``pool_encode_mha``). Then (e): requests/s and device busy
    ms and idle share of the groups against one card, greedy dense, in
    turns (no gate)."""
    from case_rg_tpu_torch.decode.loops import keys_from_seed
    from case_rg_tpu_torch.device import resolve_devices
    from case_rg_tpu_torch.runtime.inference import (make_predict_fn,
                                                     make_replicated_predict)
    from case_rg_tpu_torch.runtime.replicas import Replicas
    reps = Replicas(model, resolve_devices(spec, [B], m))
    d, res = len(reps), {"groups": len(reps), "m": m}
    rng = np.random.RandomState(POOL_SEED)
    batches = [make_batch(rng) for _ in range(POOL_BATCHES)]
    try:
        for name, kw in POOL_MODES.items():
            split = make_replicated_predict(reps, cfg, T_ANS, **kw)
            one = make_predict_fn(model, cfg, T_ANS, device=dev, **kw)
            keyed = [dict(bt, sample_key=keys_from_seed(
                POOL_SAMPLE_SEED, B, stream=j).numpy())
                if kw.get("decoding") == "sample" else bt
                for j, bt in enumerate(batches)]
            split(keyed[0]).get()                    # warm-up
            one(keyed[0])
            torch.cuda.synchronize()
            reset_kernel_counts()
            got = [split(bt).get() for bt in keyed]
            torch.cuda.synchronize()
            launches = kernel_counts()
            reset_kernel_counts()
            full = [ref(one, bt, d) for bt in keyed]
            torch.cuda.synchronize()
            unsplit = kernel_counts()
            ro = name == "rank_only"
            want = dict(unsplit,
                        fused_mha=len(batches) * d * pool_encode_mha(m, ro))
            check(unsplit["fused_mha"] == len(batches) * d
                  * pool_encode_mha(1, ro) and launches == want,
                  f"pool {spec} {name}: launches {launches}, expected "
                  f"{want} (one card {unsplit})")
            if name.startswith("greedy") and d == 1:
                check(launches == {
                    "fused_mha": pool_encode_mha(m), "stack_step": T_ANS,
                    "single_query_mha": 2 * DEC_LAYERS * T_ANS,
                    "additive_scores": 2 * T_ANS,
                    "combine_copy_mass": T_ANS * (name == "greedy_pallas")},
                    f"pool {spec} {name}: launches {launches}")
            outs = [{k: torch.as_tensor(v) for k, v in g.items()}
                    for g in got]
            bit = all(torch.equal(o[k], f[k]) for o, f in zip(outs, full)
                      for k in f)
            vs = dict(replica_agreement(outs, full), bit_equal=bit)
            check(vs["rank_max_ulps"] <= POOL_RANK_ULPS,
                  f"pool {spec} {name} vs one card: {vs}")
            if "token_agreement" in vs:
                check(vs["token_agreement"] >= POOL_MIN_TOKEN_AGREEMENT,
                      f"pool {spec} {name} vs one card: {vs}")
            res[name] = {"launches": launches, "vs_one_card": vs}

        # (e) requests/s and busy/idle share: one card against the groups,
        # greedy dense, 2 x POOL_BATCHES batches each, in turns
        fns = {"one card": make_predict_fn(model, cfg, T_ANS, device=dev),
               spec: make_replicated_predict(reps, cfg, T_ANS)}
        run = {"one card": lambda bt: host_out(fns["one card"](bt)),
               spec: lambda bt: fns[spec](bt).get()}
        rate = {k: [] for k in fns}
        timed_batches = (batches * 2)[:2]
        for k in ("one card", spec, spec, "one card"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for bt in timed_batches:
                run[k](bt)
            torch.cuda.synchronize()
            rate[k].append(len(timed_batches) * B
                           / (time.perf_counter() - t0))
        res["requests_per_s"] = rate
        res["profile"] = {k: {x: v for x, v in profile_device(
            run[k], batches).items() if x != "top_kernels"} for k in fns}
    finally:
        reps.close()
    return res


def pool_continuous(dev, cfg, model, reqs, caps, spec, m, chunk_base):
    """(b) The N_REQUESTS continuous requests over groups of ``m``
    (run_continuous_replicated: a loop a group at B/d rows and REFILL/d
    refills, the encodes split, the decode on each group's first card):
    the chunk loop (pallas; launches as the one-card formulas give them,
    fused_mha ``pool_encode_mha(m)`` an encode) and the device loop (ring
    DL_RING/d; warmed up, then timed; a capture a group, on its first
    card). Each against phase 7's one-card chunk loop (``chunk_base``):
    at least POOL_MIN_CONT_EQUAL of the answers equal token for token.
    (e) Each loop's requests/s on one card, unsplit, beside (no gate)."""
    from case_rg_tpu_torch.device import resolve_devices
    from case_rg_tpu_torch.runtime.continuous import (
        make_continuous_fns, make_device_loop_fns, run_continuous,
        run_continuous_device)
    from case_rg_tpu_torch.runtime.replicas import (Replicas,
                                                    run_continuous_replicated)
    n = len(caps)
    reps = Replicas(model, resolve_devices(spec, [B, REFILL], m))
    alone = Replicas(model, [dev])
    d = len(reps)
    b, r = B // d, REFILL // d
    mb = batch_maker(reqs, caps)
    res = {}

    def over(runs, k=n):
        return timed(lambda emit: run_continuous_replicated(
            items(k), runs, emit, [b + r] * d, replicas=reps), k)

    def one_card(make_run, fns):
        """(e) the same loop on one card, unsplit: its requests/s after a
        warm-up run (no gate)."""
        run = [make_run(fns, B, REFILL)]
        go = lambda k: timed(lambda emit: run_continuous_replicated(  # noqa
            items(k), run, emit, [B + REFILL], replicas=alone), k)
        go(WARM_REQUESTS)
        return go(n)[1]["requests_per_s"]

    def versus(got, what):
        equal = sum(np.array_equal(got[i][0], chunk_base[i][0])
                    for i in range(n))
        vs = dict(answer_agreement(got, chunk_base, caps, cfg.eos_id),
                  answers_equal=equal)
        check(equal >= POOL_MIN_CONT_EQUAL * n,
              f"pool {spec} {what} vs one card: {vs}")
        return vs

    try:
        def chunk_run(f, rows, refill):
            return lambda src, em: run_continuous(
                src, mb, *f, batch_size=rows, refill=refill, emit=em,
                ordered=False)

        def device_run(f, rows, refill):
            return lambda src, em: run_continuous_device(
                src, mb, f, batch_size=rows, refill=refill, emit=em,
                max_len=T_ANS, ordered=False, lookahead=True)

        fns = [make_continuous_fns(x, T_ANS, CHUNK_STEPS,
                                   fast_argmax="pallas", device=dv)
               for x, dv in zip(reps.models, reps.devices)]
        runs = [chunk_run(f, b, r) for f in fns]
        over(runs, WARM_REQUESTS)                # warm-up
        reset_kernel_counts()
        got, stats = over(runs)
        launches = kernel_counts()
        steps = CHUNK_STEPS * stats["chunks"]
        want = {"fused_mha": pool_encode_mha(m) * (d + stats["refills"]),
                "stack_step": steps, "combine_copy_mass": steps,
                "single_query_mha": 2 * DEC_LAYERS * steps,
                "additive_scores": 2 * steps}
        check(launches == want, f"pool {spec} continuous launches "
              f"{launches}, expected {want}")
        res["chunk_loop"] = dict(stats, launches=launches,
                                 vs_one_card=versus(got, "chunk loop"))
        res["chunk_loop"]["one_card_requests_per_s"] = one_card(
            chunk_run, make_continuous_fns(model, T_ANS, CHUNK_STEPS,
                                           fast_argmax="pallas", device=dev))
        dfns = [make_device_loop_fns(x, T_ANS, DL_STEPS, DL_K, DL_RING // d,
                                     fast_argmax="pallas", device=dv)
                for x, dv in zip(reps.models, reps.devices)]
        runs = [device_run(f, b, r) for f in dfns]
        over(runs, WARM_REQUESTS)                # warm-up: the captures
        caps_ = [c for f in dfns for c in f.captures]
        replays = [c["replays"] for c in caps_]
        reset_kernel_counts()
        got, stats = over(runs)
        eager = kernel_counts()
        recorded = {k: sum(c["launches"][k] * (c["replays"] - r0)
                           for c, r0 in zip(caps_, replays)) for k in eager}
        launches = {k: eager[k] + recorded[k] for k in eager}
        steps_run = DL_STEPS * DL_K * stats["megas"]
        want = {"fused_mha": pool_encode_mha(m) * (d + stats["refills"]),
                "stack_step": steps_run, "combine_copy_mass": steps_run,
                "single_query_mha": 2 * DEC_LAYERS * steps_run,
                "additive_scores": 2 * steps_run}
        check(len(caps_) == d and launches == want,
              f"pool {spec} device loop: {len(caps_)} captures, launches "
              f"{launches} (eager {eager}), expected {want}")
        res["device_loop"] = dict(stats, launches=launches,
                                  vs_one_card=versus(got, "device loop"))
        res["device_loop"]["one_card_requests_per_s"] = one_card(
            device_run, make_device_loop_fns(
                model, T_ANS, DL_STEPS, DL_K, DL_RING, fast_argmax="pallas",
                device=dev))
    finally:
        reps.close()
        alone.close()
    return res


def pool_text(spec, m, text, bit_equal):
    """(c) cli/serve --pool_shard ``m`` on phase 11's 256 text requests,
    batched at B=64 (every pool padded to 10 passages), against phase 11's
    one-card (a): response for response where (a) found the split predict
    bit-equal to one card (``bit_equal``), else the answers' words at
    POOL_MIN_TOKEN_AGREEMENT; fused_mha ``pool_encode_mha(m)`` an encode."""
    ref = text["got"]["a_batched"]
    got, run = serve_text_mode(
        text["common"] + ["--device", spec, "--pool_shard", str(m)], [],
        os.path.join(TEXT_DIR, f"pool_{m}_a.jsonl"))
    equal = sum(g == w for g, w in zip(got, ref))
    if bit_equal:
        same_responses(got, ref, f"pool {spec} batched vs one card")
    words = sum(a == b for g, w in zip(got, ref)
                for a, b in zip(g["answer"].split(), w["answer"].split()))
    total = sum(len(w["answer"].split()) for w in ref)
    check(len(got) == len(ref) and [g["id"] for g in got]
          == [w["id"] for w in ref]
          and words >= POOL_MIN_TOKEN_AGREEMENT * total,
          f"pool {spec} text: {equal} of {len(ref)} equal, {words} of "
          f"{total} words")
    n = run.launches
    check(n["fused_mha"] > 0 and n["fused_mha"] % pool_encode_mha(m) == 0
          and n["stack_step"] > 0,
          f"pool {spec} text: launches {n}")
    return dict(run.report(len(ref)), responses_equal=equal,
                words_equal=words, words=total)


def pool_test(spec, m, raw):
    """(d) cli/run --mode test --avg_only --pool_shard --mesh_shape 1,m on
    phase 13's checkpoints at B=64, batched: its four files (dev and test,
    .answer and .run) against phase 13's one process (answers byte for
    byte, runs byte for byte or within same_run_lines' near ties)."""
    from case_rg_tpu_torch.cli import run as cli_run
    test_args, out = raw["test_args"], raw["out"]
    mine = os.path.join(RAW_DIR, f"test_pool_{m}")
    os.makedirs(mine)
    os.symlink(os.path.join(out, "model"), os.path.join(mine, "model"))
    reset_kernel_counts()
    t0 = time.perf_counter()
    cli_run.main([x if x != out else mine for x in test_args]
                 + ["--avg_only", "--device", spec, "--pool_shard",
                    "--mesh_shape", f"1,{m}"])
    secs = time.perf_counter() - t0
    launches = kernel_counts()
    check(launches["fused_mha"] > 0
          and launches["fused_mha"] % pool_encode_mha(m) == 0
          and launches["stack_step"] > 0,
          f"pool {spec} test: launches {launches}")
    # phase 13's result folder also holds cli/evaluate's merged ".all."
    # files; cli/run writes one process's ".0." files
    want_dir, got_dir = os.path.join(out, "result"), os.path.join(mine,
                                                                  "result")
    names = sorted(x for x in os.listdir(want_dir) if "_avg.0." in x)
    check(len(names) == 4 and names == sorted(os.listdir(got_dir)),
          f"pool {spec} test: files {sorted(os.listdir(got_dir))}, "
          f"expected {names}")
    ties = same_result_files(got_dir, want_dir,
                             f"pool {spec} test vs one process", names)
    return {"s": secs, "launches": launches, "near_ties": ties,
            "files": names}


def pool_axis(dev, cfg, model, reqs, caps, chunk_base, text, raw,
              only=False):
    """Phase 18: (a)-(e) above for every spec of ``pool_specs`` ((c) only
    where phase 11's text is given, (d) where phase 13's files are)."""
    auto_routing()
    t_phase = time.perf_counter()
    res = {"specs": [s for s, _ in pool_specs(only)],
           "cards": torch.cuda.device_count()}
    for spec, m in pool_specs(only):
        t0 = time.perf_counter()
        one = {"predict": pool_predict(dev, cfg, model, spec, m)}
        print(f"pool axis {spec} predict: " + json.dumps(one["predict"]),
              flush=True)
        one["continuous"] = pool_continuous(dev, cfg, model, reqs, caps,
                                            spec, m, chunk_base)
        print(f"pool axis {spec} continuous: "
              + json.dumps(one["continuous"]), flush=True)
        bit = one["predict"]["greedy_dense"]["vs_one_card"]["bit_equal"]
        one["text"] = pool_text(spec, m, text, bit) if text else "not run"
        print(f"pool axis {spec} text: " + json.dumps(one["text"]),
              flush=True)
        one["test"] = pool_test(spec, m, raw) if raw else "not run"
        one["s"] = time.perf_counter() - t0
        print(f"pool axis {spec} test: " + json.dumps(one["test"]),
              flush=True)
        res[spec] = one
    res["phase_s"] = time.perf_counter() - t_phase
    return res


def pool_only(dev, card, elapsed) -> int:
    """``--only-pool``: phase 18 with what it needs of the phases before it
    (the serving model, phase 7's one-card chunk loop over the continuous
    requests), without phase 11's text and phase 13's files, so (c) and
    (d) are not run. For a machine with several cards: each spec of
    ``pool_specs(only=True)``."""
    from case_rg_tpu_torch.runtime.continuous import (make_continuous_fns,
                                                      run_continuous)
    cfg, model = serving_model(dev)
    reqs, caps = make_requests(np.random.RandomState(3), N_REQUESTS)
    fns = make_continuous_fns(model, T_ANS, CHUNK_STEPS,
                              fast_argmax="pallas", device=dev)
    drive = lambda k: timed(lambda emit: run_continuous(  # noqa: E731
        items(k), batch_maker(reqs, caps), *fns, batch_size=B,
        refill=REFILL, emit=emit), k)
    drive(WARM_REQUESTS)
    base, _ = drive(N_REQUESTS)
    elapsed("the one-card references")
    res = pool_axis(dev, cfg, model, reqs, caps, base, None, None, only=True)
    print("pool axis: " + json.dumps(
        {k: res[k] for k in ("specs", "cards", "phase_s")}), flush=True)
    elapsed("the pool axis")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def replicas_only(dev, card, elapsed) -> int:
    """``--only-replicas``: phase 17 with what it needs of the phases before
    it (the serving model, the exact-sum witness of "case serving", the
    one-card continuous and sampled runs, phase 11's text serving), without
    phase 13's files, so (d) is not run. For a machine with several cards:
    the phase alone, each spec of ``replica_specs``."""
    import shutil
    cfg, model = serving_model(dev)
    serve = serve_case(dev, cfg, model)
    reqs, caps = make_requests(np.random.RandomState(3), N_REQUESTS)
    _, cont_base = serve_continuous(dev, cfg, model, reqs, caps)
    _, sampled_base = serve_continuous_sampled(dev, cfg, model, reqs, caps)
    elapsed("the one-card references")
    text = serve_text(dev)
    elapsed("text serving")
    try:
        cards = serving_over_cards(dev, cfg, model, reqs, caps, cont_base,
                                   sampled_base,
                                   serve["exact_sums_vs_plain"],
                                   text["ctx"], None)
    finally:
        shutil.rmtree(TEXT_DIR, ignore_errors=True)
    print("serving over cards: " + json.dumps(
        {k: cards[k] for k in ("specs", "cards", "phase_s")}), flush=True)
    elapsed("serving over cards")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv not in ([], ["--only-replicas"], ["--only-pool"]):
        print("usage: python3 chip_smoke.py [--only-replicas | --only-pool]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from case_rg_tpu_torch.kernels import _build

    # the plain versions' products accumulate in full f32, as the kernels do
    read_torch_defaults()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    def elapsed(what):
        print(f"elapsed after {what}: {time.perf_counter() - t_start:.1f} s",
              flush=True)
    card = smi()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    if argv in (["--only-replicas"], ["--only-pool"]):
        t0 = time.perf_counter()
        _build.build_all()
        print(f"kernel build: {time.perf_counter() - t0:.1f} s", flush=True)
        only = replicas_only if argv == ["--only-replicas"] else pool_only
        return only(dev, card, elapsed)
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
    elapsed("CaSE serving")
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
    elapsed("continuous serving")
    dloop = serve_device_loop(dev, cfg, model, reqs, caps, cont_base,
                              sampled_base)
    print("device-loop serving: " + json.dumps(dloop), flush=True)
    elapsed("the device loop")
    text = serve_text(dev)
    print("text serving: " + json.dumps({k: v for k, v in text.items()
                                          if k not in ("modes", "ctx")}),
          flush=True)
    elapsed("text serving")
    tmha = train_attention_phase(dev, gen, instances)
    train = train_case(dev)
    print("case training: " + json.dumps(train), flush=True)
    elapsed("training")
    raw = raw_files(dev, float(np.median(train["rng"]["kernels"][
        "ms_per_step"])))
    print("raw files: " + json.dumps({k: raw[k] for k in (
        "corpus", "prepare_s", "preempt", "avg_s", "evaluate_s",
        "phase_s")}), flush=True)
    elapsed("raw files")
    import shutil
    try:
        dp = data_parallel(dev, card)
        print("data-parallel training and testing: " + json.dumps(
            {"world_of_one": raw["world_of_one"], **dp}), flush=True)
        elapsed("data parallelism")
        cards = serving_over_cards(dev, cfg, model, reqs, caps, cont_base,
                                   sampled_base,
                                   serve["exact_sums_vs_plain"],
                                   text["ctx"], raw["ctx"])
        print("serving over cards: " + json.dumps(
            {k: cards[k] for k in ("specs", "cards", "phase_s")}), flush=True)
        elapsed("serving over cards")
        pool = pool_axis(dev, cfg, model, reqs, caps, cont_base,
                         text["ctx"], raw["ctx"])
    finally:
        shutil.rmtree(RAW_DIR, ignore_errors=True)
        shutil.rmtree(TEXT_DIR, ignore_errors=True)
    print("pool axis: " + json.dumps(
        {k: pool[k] for k in ("specs", "cards", "phase_s")}), flush=True)
    elapsed("the pool axis")
    t0 = time.perf_counter()
    others = other_models(dev)
    print("other models: " + json.dumps({
        "phase_s": time.perf_counter() - t0,
        "ms_per_batch": {n: others[n]["ms_per_batch"] for n in others},
        "dense_sites": {n: others[n]["dense_sites"] for n in others}}),
        flush=True)
    elapsed("the other models")
    routed = export_and_router(dev)
    print("export and multi-model serving: " + json.dumps({
        "phase_s": routed["phase_s"],
        "export_s": {k[2:]: routed[k]["export_s"] for k in routed
                     if k.startswith("a_")},
        "router_requests_per_s": routed["c_router"]["requests_per_s"]}),
        flush=True)
    elapsed("export and the router")
    t0 = time.perf_counter()
    options = train_options(dev)
    early = routed["early_exit"]
    print("training options and early-exit export: " + json.dumps({
        "phase_s": time.perf_counter() - t0, "card": card,
        "ms_per_step": {k: float(np.median(v["ms_per_step"]))
                        for k, v in options.items() if k in TRAIN_OPTIONS},
        "peak_allocated_mb": {k: v["peak_allocated_mb"]
                              for k, v in options.items()
                              if k in TRAIN_OPTIONS},
        "export_s": {"early_exit": early["export_s"],
                     "fixed_trip": early["fixed_trip"]["export_s"]},
        "steps_run": early["steps_run"],
        "eos_pushed": early["eos_pushed"],
        "carry_copy": early["carry_copy"]}), flush=True)
    elapsed("the training options")

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
