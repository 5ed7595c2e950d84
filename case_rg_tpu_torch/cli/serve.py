"""Online serving CLI: JSONL requests in, answers (+ passage rankings) out
(port of ``case_rg_tpu/cli/serve.py``).

Requests are tokenized and featurized on the host with the same code path
as the offline pipeline (``data/featurize.py``), and batches are
dispatched pipelined: up to ``--pipeline_depth`` batches are enqueued on
the card before the first one's results are read back, each through a
pinned host copy started at its dispatch.

This module is the CLI entry point (argument surface, checkpoint loading,
warm-up); the serving machinery lives in ``case_rg_tpu_torch/serving/``
(featurize, lanes, http, offline).

Request format (one JSON object per line):

    {"id": "r1", "query": "current question",
     "history": ["previous turn", ...],           # optional
     "passages": ["candidate passage text", ...], # the retrieval pool
     "max_tokens": 20,                            # optional per-request
                                                  # response-length cap
     "seed": 7,                                   # optional (--continuous
                                                  # --decoding sample):
                                                  # per-request seed
     "temperature": 0.7, "top_k": 40, "top_p": 0.9,  # optional per-request
                                                  # sampling controls
                                                  # (--request_controls)
     "stream": true}                              # optional (--listen
                                                  # --continuous): stream
                                                  # token deltas as JSONL
                                                  # lines while the row
                                                  # decodes; final line
                                                  # carries "done": true

Response format (one JSON object per line, in request order):

    {"id": "r1", "answer": "generated answer text", "ranking": [2, 0, 1]}

Usage:
    python -m case_rg_tpu_torch.cli.serve --model case \\
        --prepared_dir ./dataset/cast/prepared --output_path ./output/case \\
        --input requests.jsonl --output answers.jsonl \\
        [--epoch N] [--bf16] [--batch_size 64] [--beam_width K] \\
        [--continuous [--device_loop K]] [--pool_buckets 5,10] \\
        [--listen HOST:PORT] [--device cpu]

The card is the default (``--device cuda``); without one the command
raises. ``--device cpu`` runs on the CPU, with each kernel's plain
version. ``output_path/model`` holds the port's checkpoints
(``{epoch}.pt``) or the JAX package's (``{epoch}.ckpt``, flax msgpack);
``train/checkpoint.load_checkpoint`` reads either. The weights are loaded,
cast (``--bf16``) and moved to the card once, before the first request.

``--input -`` reads stdin; requests are consumed in batch_size chunks as
they arrive and each chunk's responses are flushed as soon as they are
fetched. ``--pool_buckets 2,5,10`` routes each request to the smallest
static pool size >= its passage count instead of padding every pool to
``num_passage`` (the bucketed pool holds no dummy rows for absent
passages, so answers can differ slightly from padded-pool serving); output
order is preserved by a reorder buffer, and a part-filled bucket
dispatches when full, when ``--bucket_flush_after`` newer requests have
streamed past its oldest entry, or at end of input. With ``--continuous``
each bucket becomes its own continuous-decode lane.

``--listen HOST:PORT`` turns the CLI into an HTTP micro-batching server
(stdlib http.server; ``serving/http.py``): POST JSONL request lines to
``/``, receive JSONL responses; GET ``/healthz`` for liveness and
``/varz`` for serving stats.

``--model`` is any of the six; "ranking" comes back for the models with a
rank head (case, masque, tmemnet), and ``--rank_only`` refuses the others.

``--from_export ARCHIVE`` serves a ``torch.export`` archive written by
``cli/export_model.py`` instead of a checkpoint: its ``.json`` sidecar
supplies the model, batch size, beam width, ``rank_only``, answer length
and data shapes, and it must have been traced for ``--device``'s type.
Every flag that would change the exported program is refused ("does not
apply"); the offline and ``--listen`` front ends both serve it.

``--bf16_scores`` turns on bf16 attention scores for bf16 inputs in the
dense attention paths (``ops/attention.set_bf16_scores``; the kernels keep
f32 scores), process-wide, as the JAX CLI does; with ``--from_export`` it
is refused, since the archive fixes its program.

Several devices: as the JAX CLI's serving mesh, a batch splits by rows
over one replica of the model a device (``runtime/replicas.py``) when
``--device`` is a comma list of the replicas (``cuda:0,cuda:1``;
``cpu,cpu`` on the CPU). ``--device cuda`` (the default) and ``cuda:i``
are one card.
``--batch_size``, ``--batch_buckets`` and ``--refill`` stay global: the
replicas are the first d devices, d = gcd(every batch bucket, the refill
bucket under ``--continuous``, the devices), and each holds B/d rows.
``--continuous`` runs one loop (its lanes, its device loop) a replica;
arrivals go to the replica with the fewest requests in hand, and answers
come back in request order, as on one card. ``--from_export`` serves on
one device.

``--pool_shard N`` (the JAX CLI's pool axis) makes each replica a group of
N devices of the ``--device`` list (``cpu,cpu`` or ``cuda:0,cuda:0``: one
group on one device; ``cuda:0,cuda:1,cuda:2,cuda:3`` with N = 2: two
groups of two cards): each request's passage pool splits N ways over its
group, and the query side and the decode run on the group's first device
(``models/case.PooledCaSE``). N must divide the devices and every served
pool size (``--num_passage``, each ``--pool_buckets`` size); batched,
``--continuous``, ``--device_loop`` and ``--listen`` alike. CaSE only:
Masque and TMemNet refuse it (ROADMAP Queue 1 item "7b (ii)
Masque/TMemNet"), the models without a pool refuse it, and so does
``--from_export``, as in the JAX CLI.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import sys
import time
from typing import List

import numpy as np
import torch

from ..config import DataConfig, ModelConfig
from ..data.vocab import Vocabulary
from ..device import resolve_device, resolve_devices
from ..models import build_model_cfg, create_model
from ..runtime.inference import make_replicated_predict
from ..runtime.replicas import Pending, Replicas
from ..runtime.io import ids_to_sentence, remove_duplicate
from ..serving.featurize import chunk_to_batch, parse_buckets
from ..serving.http import serve_http
from ..serving.offline import run_offline_batched, run_offline_continuous
from ..train.checkpoint import (best_epoch, checkpoint_exists, latest_epoch,
                                load_checkpoint)

def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--model", type=str, default=None,
                   choices=["case", "masque", "glks", "tmemnet", "gttp",
                            "s2sa"],
                   help="the model to serve")
    p.add_argument("--prepared_dir", type=str, required=True,
                   help="prepared dir holding vocab.txt (+ freq.json)")
    p.add_argument("--output_path", type=str, default=None,
                   help="training output dir holding model/ checkpoints")
    p.add_argument("--from_export", type=str, default="",
                   help="serve a torch.export archive written by "
                        "cli/export_model.py (its <path>.json sidecar "
                        "supplies the model, batch size and data shapes) "
                        "instead of --model/--output_path")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default: one card; raises without a card), "
                        "cuda:i, cpu, or a comma list of replicas "
                        "(cuda:0,cuda:1; cpu,cpu)")
    p.add_argument("--epoch", type=str, default=None,
                   help="checkpoint epoch (default: latest); 'best' serves "
                        "the best-dev-loss epoch (model/best.json); 'avg' "
                        "serves the averaged checkpoint")
    p.add_argument("--input", type=str, default="-")
    p.add_argument("--output", type=str, default="-")
    p.add_argument("--batch_size", type=int, default=None,
                   help="device batch width (default 64; 128 for "
                        "--rank_only, the JAX package's knees)")
    p.add_argument("--embedding_size", type=int, default=256)
    p.add_argument("--hidden_size", type=int, default=256)
    p.add_argument("--num_heads", type=int, default=8)
    p.add_argument("--max_target_length", type=int, default=40)
    p.add_argument("--beam_width", type=int, default=1)
    p.add_argument("--early_exit", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="greedy decode stops once every row in the batch "
                        "has emitted EOS (sentence-identical to the fixed "
                        "loop; --no-early_exit disables)")
    from .flags import add_fast_argmax_flag
    add_fast_argmax_flag(p)
    p.add_argument("--rank_only", action="store_true",
                   help="return passage rankings only, skipping answer "
                        "generation")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 parameters (the f32 checkpoint cast once "
                        "at load)")
    p.add_argument("--bf16_scores", action="store_true",
                   help="bf16 attention scores for bf16 inputs in the dense "
                        "attention paths (the kernels keep f32 scores)")
    p.add_argument("--fused_attn", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="the fused_mha CUDA kernel for bf16 encoder "
                        "attention on the card (--no-fused_attn: the plain "
                        "PyTorch attention)")
    p.add_argument("--query_len", type=int, default=60)
    p.add_argument("--passage_len", type=int, default=100)
    p.add_argument("--num_passage", type=int, default=10)
    p.add_argument("--min_window_size", type=int, default=4)
    p.add_argument("--num_windows", type=int, default=1)
    p.add_argument("--ema", action="store_true", help="serve EMA weights")
    p.add_argument("--decoding", type=str, default="greedy",
                   choices=["greedy", "sample"],
                   help="sampling-based serving (--decoding sample). With "
                        "--continuous, per-request keys ride in the decode "
                        "rows (seeded by --sample_seed + the request's "
                        "optional \"seed\" field), so sampled answers are "
                        "reproducible per request whatever the batch")
    p.add_argument("--sample_seed", type=int, default=123456)
    p.add_argument("--warmup", action="store_true",
                   help="run every serving program once before reading "
                        "input / binding --listen (one synthetic request "
                        "per pool bucket x batch width; with --device_loop "
                        "this captures the CUDA graphs)")
    p.add_argument("--request_controls", action="store_true",
                   help="--continuous --decoding sample: honor per-request "
                        "\"temperature\"/\"top_k\"/\"top_p\" fields; rows "
                        "without a field use the global flags")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=0)
    p.add_argument("--top_p", type=float, default=1.0)
    p.add_argument("--pipeline_depth", type=int, default=4,
                   help="max batches in flight before fetching results")
    p.add_argument("--continuous", action="store_true",
                   help="continuous batching: rows progress independently; "
                        "finished rows are refilled mid-flight with newly "
                        "arrived requests (runtime/continuous). Composes "
                        "with --pool_buckets: one lane per bucket")
    p.add_argument("--chunk_steps", type=int, default=8,
                   help="--continuous: decode steps per chunk between "
                        "harvest/refill points")
    p.add_argument("--refill", type=int, default=0,
                   help="--continuous: refill bucket size (encode width "
                        "for newly arrived requests); 0 = batch_size/4")
    p.add_argument("--lookahead", action="store_true",
                   help="--continuous: keep one chunk (or mega) dispatched "
                        "ahead so the harvest's host copy overlaps the "
                        "next one's compute")
    p.add_argument("--device_loop", type=int, default=0, metavar="K",
                   help="--continuous: device loop - K chunks per "
                        "dispatch, harvest + refills on the card from a "
                        "ring of encoded requests, each mega one replay of "
                        "a CUDA graph on the card (runtime/continuous/"
                        "device_loop). Composes with --lookahead, "
                        "--pool_buckets, --decoding sample, "
                        "--request_controls and streaming")
    p.add_argument("--stage_rows", type=int, default=0,
                   help="--device_loop: ring size in rows (0 = auto: "
                        "~batch*K*chunk_steps/10)")
    p.add_argument("--fused_stack", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="the stack_step CUDA kernel for the passage-memory "
                        "decoder stack; default auto")
    p.add_argument("--async_harvest", action="store_true",
                   help="--continuous: read each chunk's flags one round "
                        "later, from a host copy started at dispatch")
    p.add_argument("--refill_min", type=int, default=1,
                   help="--continuous: coalesce refills - wait until this "
                        "many rows are free before a mid-flight refill")
    p.add_argument("--pool_shard", type=int, default=1,
                   help="split each passage pool over a group of N devices "
                        "of the --device list (N must divide the devices "
                        "and every served pool size); CaSE only")
    p.add_argument("--pool_buckets", type=str, default="",
                   help="comma-separated static pool sizes (e.g. 2,5,10); "
                        "requests are routed to the smallest bucket that "
                        "fits their passage count. Empty = every pool "
                        "padded to --num_passage")
    p.add_argument("--listen", type=str, default="",
                   help="HOST:PORT: serve over HTTP instead of files/stdin "
                        "(POST JSONL request lines to /, GET /healthz, "
                        "/varz)")
    p.add_argument("--max_wait_ms", type=float, default=20.0,
                   help="micro-batching window: how long the HTTP "
                        "dispatcher waits to fill a batch after the first "
                        "queued request")
    p.add_argument("--request_timeout", type=float, default=1800.0,
                   help="HTTP mode: seconds a request waits for its result "
                        "before a 503")
    p.add_argument("--bucket_flush_after", type=int, default=0,
                   help="offline --pool_buckets: dispatch a part-filled "
                        "bucket once this many newer requests have been "
                        "read since its oldest entry (0 = 2x batch_size)")
    p.add_argument("--batch_buckets", type=str, default="",
                   help="comma-separated static batch sizes (e.g. 8,64): a "
                        "part-filled chunk runs at the smallest batch size "
                        "that fits it instead of padding to --batch_size")
    return p


def resolve_batch_size(batch_size, rank_only):
    """The JAX package's serving batch defaults: 64 for full predict, 128
    for rank-only (no sequential decode). An explicit --batch_size always
    wins."""
    if batch_size is not None:
        return batch_size
    return 128 if rank_only else 64


def _pool_devices(args, dcfg) -> int:
    """``--pool_shard``'s group size, which must divide every served pool
    size (the JAX CLI's check and message)."""
    n = max(1, args.pool_shard)
    if n > 1:
        pools = (parse_buckets(args.pool_buckets, dcfg.num_passage)
                 if args.pool_buckets else [dcfg.num_passage])
        bad = [k for k in pools if k % n]
        if bad:
            raise SystemExit(
                f"--pool_shard {n} must divide every served pool size; "
                f"offending: {bad} (pool buckets {pools})")
    return n


def _from_export_args(args) -> dict:
    """``--from_export``: refuse every flag that the archive fixes or that
    does not bear on it, read its sidecar, take the model, batch size,
    decode and data shapes from it, and check that it was traced for
    ``--device``. Returns the sidecar."""
    for bad, name in [
            (args.continuous, "--continuous"),
            (args.pool_buckets, "--pool_buckets"),
            (args.batch_buckets, "--batch_buckets"),
            (args.pool_shard > 1, "--pool_shard"),
            (args.decoding != "greedy", "--decoding sample"),
            (args.request_controls, "--request_controls"),
            (args.epoch is not None, "--epoch"),
            (args.ema, "--ema"), (args.bf16, "--bf16"),
            (args.bf16_scores, "--bf16_scores"),
            (args.rank_only, "--rank_only"),
            (args.model is not None, "--model"),
            (args.output_path is not None, "--output_path")]:
        if bad:
            raise SystemExit(f"--from_export serves the artifact as "
                             f"exported; {name} does not apply (it is "
                             f"fixed by — or irrelevant to — the "
                             f"artifact)")
    from ..runtime.exported import check_platform, read_sidecar
    try:
        sidecar = read_sidecar(args.from_export)
    except (OSError, json.JSONDecodeError) as e:
        raise SystemExit(f"--from_export: cannot read sidecar "
                         f"{args.from_export}.json: {e}")
    try:
        check_platform(sidecar.get("platforms", []), args.device)
    except RuntimeError as e:
        raise SystemExit(f"--from_export: {e}")
    args.model = sidecar["model"]
    args.batch_size = int(sidecar["batch_size"])
    args.max_target_length = int(sidecar["max_target_length"])
    args.beam_width = int(sidecar.get("beam_width", 1))
    args.rank_only = bool(sidecar.get("rank_only"))
    d = sidecar["data"]
    args.query_len = int(d["query_len"])
    args.passage_len = int(d["passage_len"])
    args.num_passage = int(d["num_passage"])
    return sidecar


def _resolve_epoch(args):
    if args.epoch is None:
        epoch = latest_epoch(args.output_path)
    elif args.epoch == "best":
        epoch = best_epoch(args.output_path)
        if epoch is None:
            raise SystemExit("--epoch best: no model/best.json under "
                             f"{args.output_path} (train with --dev_eval)")
    elif args.epoch == "avg":
        epoch = "avg"   # averaged checkpoint (run --mode avg)
    else:
        try:
            epoch = int(args.epoch)
        except ValueError:
            raise SystemExit("--epoch must be an integer, 'best', or "
                             f"'avg'; got {args.epoch!r}")
    if epoch is None or not checkpoint_exists(args.output_path, epoch):
        raise SystemExit(f"no checkpoint for epoch {epoch!r} under "
                         f"{args.output_path}/model")
    return epoch


def load_model(args, vocab: Vocabulary, epoch):
    """(model config, the model with the checkpoint's weights on the device):
    built, loaded and, with ``--bf16``, cast once."""
    from ..bridge import load_state
    base = ModelConfig(embedding_size=args.embedding_size,
                       hidden_size=args.hidden_size, num_heads=args.num_heads,
                       max_target_length=args.max_target_length,
                       max_dec_len=args.max_target_length,
                       beam_width=args.beam_width,
                       min_window_size=args.min_window_size,
                       num_windows=args.num_windows,
                       param_dtype="bfloat16" if args.bf16 else "float32")
    mcfg = build_model_cfg(base, args.model, vocab)
    try:
        model = create_model(args.model, mcfg, device=args.device)
    except ValueError as e:
        raise SystemExit(str(e))
    ck = load_checkpoint(args.output_path, epoch)
    load_state(model, ck["ema"] if args.ema else ck["params"])
    return mcfg, model


def main(argv=None, _server_ready=None):
    """``_server_ready``: test hook - called with the HTTPServer instance
    (from the serving thread) once ``--listen`` is bound, so a test can
    send requests and ``shutdown()`` it."""
    args = build_parser().parse_args(argv)
    sidecar = _from_export_args(args) if args.from_export else None
    if sidecar is None and (args.model is None or args.output_path is None):
        raise SystemExit("--model and --output_path are required (unless "
                         "--from_export)")
    args.batch_size = resolve_batch_size(args.batch_size, args.rank_only)
    if sidecar is not None and "," in args.device:
        raise SystemExit("--from_export serves on one device; --device "
                         f"{args.device} names several")
    dev = resolve_device(args.device)

    if not args.fused_attn:
        from ..ops.attention import set_fused_attention
        set_fused_attention(False)
    if args.bf16_scores:
        from ..ops.attention import set_bf16_scores
        set_bf16_scores(True)
    from ..models.multimem import set_fused_stack
    set_fused_stack(args.fused_stack)

    vocab = Vocabulary.load(os.path.join(args.prepared_dir, "vocab.txt"))
    dcfg = DataConfig(query_len=args.query_len, passage_len=args.passage_len,
                      num_passage=args.num_passage,
                      answer_len=args.max_target_length,
                      min_window_size=args.min_window_size,
                      num_windows=args.num_windows)
    bs = args.batch_size
    detok = vocab.detokenizer()
    served = 0

    bbuckets = parse_buckets(args.batch_buckets, bs, "--batch_buckets") \
        if args.batch_buckets else [bs]
    if args.continuous:
        args.refill = args.refill or max(bs // 4, 1)
        if not 1 <= args.refill <= bs:
            raise SystemExit(f"--refill must be in [1, batch_size]; got "
                             f"{args.refill} (batch_size {bs})")
        if args.chunk_steps < 1:
            raise SystemExit(f"--chunk_steps must be >= 1; got "
                             f"{args.chunk_steps}")
        if not 1 <= args.refill_min <= args.refill:
            raise SystemExit(f"--refill_min must be in [1, refill]; got "
                             f"{args.refill_min} (refill {args.refill})")
        bbuckets = sorted(set(bbuckets + [args.refill]))

    reps = None
    if sidecar is not None:
        # the archive is the whole predict program with the parameters in
        # it (cli/export_model.py): nothing to build or restore. One fixed
        # (batch_size x pool) shape, on one device.
        from ..runtime.exported import load_exported
        try:
            call = load_exported(args.from_export, sidecar["platforms"]).call
        except ValueError as e:   # not a torch.export archive
            raise SystemExit(f"--from_export: {e}")
        epoch = "export:" + str(sidecar.get("epoch"))

        def run_predict(batch):
            return Pending([call(batch)])
    else:
        # the serving mesh: a replica a device of the data axis, or a group
        # of --pool_shard devices, d = gcd(every batch bucket, the devices
        # / the group size); one device is one replica
        pool = _pool_devices(args, dcfg)
        try:
            groups = resolve_devices(args.device, bbuckets, pool)
        except ValueError as e:
            raise SystemExit(str(e))
        epoch = _resolve_epoch(args)
        mcfg, model = load_model(args, vocab, epoch)
        try:
            reps = Replicas(model, groups)
            run_predict = make_replicated_predict(
                reps, mcfg, args.max_target_length,
                beam_width=args.beam_width, early_exit=args.early_exit,
                fast_argmax=args.fast_argmax, decoding=args.decoding,
                sample_seed=args.sample_seed, temperature=args.temperature,
                top_k=args.top_k, top_p=args.top_p, rank_only=args.rank_only)
        except ValueError as e:   # --rank_only without a rank head, a model
            raise SystemExit(str(e))   # without a pool split

    def responses_for(chunk, out, dcfg_k, default_ids=None) -> List[dict]:
        nonlocal served
        if isinstance(out, Pending):
            out = out.get()
        sents = None
        if "answer" in out:
            ids = np.asarray(out["answer"])
            # per-request max_tokens: truncate host-side (greedy/sampled
            # prefixes don't depend on later steps; the continuous path
            # already stopped the row at its cap)
            caps = [min(int(r["max_tokens"]), ids.shape[1])
                    if isinstance(r, dict) and "max_tokens" in r
                    else ids.shape[1] for r in chunk]
            sents = [ids_to_sentence(row[:max(c, 1)], vocab)
                     for row, c in zip(ids, caps)]
            remove_duplicate(sents)
        resps = []
        for i, req in enumerate(chunk):
            default = default_ids[i] if default_ids is not None else served + i
            resp = {"id": req.get("id", default)}
            if sents is not None:
                resp["answer"] = detok(sents[i])
            if "rank" in out:
                scores = np.asarray(out["rank"][i])
                n_real = min(len(req.get("passages", [])),
                             dcfg_k.num_passage)
                order = np.argsort(-scores[:max(n_real, 1)], kind="stable")
                resp["ranking"] = [int(j) for j in order[:n_real]]
            resps.append(resp)
        served += len(chunk)
        return resps

    if args.request_controls and not (args.continuous
                                      and args.decoding == "sample"):
        raise SystemExit("--request_controls applies to --continuous "
                         "--decoding sample serving only")

    cont = None
    if args.continuous:
        # continuous batching: per-row decode progress, finished rows
        # refilled mid-flight (runtime/continuous). A request's answer is
        # the one-shot predict's; throughput tracks the mean answer length
        # instead of the max.
        if args.batch_buckets or args.rank_only or args.beam_width > 1:
            raise SystemExit("--continuous composes with none of "
                             "--batch_buckets/--rank_only/--beam_width>1")
        if args.pool_buckets and args.lookahead and not args.device_loop:
            raise SystemExit("--lookahead applies to single-lane "
                             "--continuous only; with --pool_buckets the "
                             "multi-lane chunk loop already overlaps "
                             "each lane's harvest with the other lanes' "
                             "chunks (the device loop's multi-lane loop "
                             "does take --lookahead: per-lane "
                             "double-dispatch)")

        # sampled continuous serving: each request gets its own key (it
        # rides in the batch and then in the row's decode state), derived
        # from --sample_seed and the request's optional "seed" field
        # (fallback: an arrival counter), so a request with a seed samples
        # the same answer whatever its batch, refill timing, lane or card.
        # Over replicas the fallback is drawn in arrival order, before any
        # replica featurizes the request.
        key_counter = itertools.count()
        fallback = {}

        def arrive(req):
            if isinstance(req, dict) and req.get("seed") is None:
                fallback[id(req)] = next(key_counter)

        def request_keys(chunk, width):
            ks = []
            for r in chunk:
                ent = r.get("seed") if isinstance(r, dict) else None
                if ent is None:
                    ent = fallback.pop(id(r), None)
                ent = next(key_counter) if ent is None else int(ent)
                ks.append(np.random.SeedSequence(
                    [args.sample_seed, ent]).generate_state(2, np.uint32))
            ks += [ks[-1]] * (width - len(ks))   # pad rows never emit
            return np.stack(ks)

        def request_ctls(chunk, width):
            """Per-row (temperature, top_k, top_p), request fields
            overriding the global flags; validated here so a bad value
            fails only its own featurize chunk."""
            from ..decode.loops import validate_controls
            cs = []
            for r in chunk:
                t = float(r.get("temperature", args.temperature))
                k = int(r.get("top_k", args.top_k))
                tp = float(r.get("top_p", args.top_p))
                validate_controls(t, k, tp)
                cs.append((t, float(k), tp))
            cs += [cs[-1]] * (width - len(cs))
            return np.asarray(cs, np.float32)

        def cont_make_batch_for(dk):
            def mb(chunk, k):
                batch = chunk_to_batch(chunk, args.model, vocab, dk, k)
                if args.decoding == "sample":
                    batch["sample_key"] = request_keys(chunk, k)
                    if args.request_controls:
                        batch["sample_ctl"] = request_ctls(chunk, k)
                return batch
            return mb

        def row_out(ids_row, rank_row):
            out = {"answer": ids_row[None]}
            if rank_row is not None:
                out["rank"] = rank_row[None]
            return out

        from ..runtime.continuous import run_continuous
        base = {"make_batch": cont_make_batch_for(dcfg),
                "run": run_continuous, "row_out": row_out,
                "lookahead": args.lookahead,
                "refill_min": args.refill_min,
                "async_harvest": args.async_harvest}
        if args.pool_buckets:
            # multi-lane continuous serving: one lane (own decode state)
            # per static pool size; requests route to the smallest bucket
            # that fits and still refill mid-flight
            cbuckets = parse_buckets(args.pool_buckets, dcfg.num_passage)
            base["buckets"] = cbuckets
            base["make_batch_for"] = {
                k: cont_make_batch_for(
                    dataclasses.replace(dcfg, num_passage=k))
                for k in cbuckets}
        d = len(reps)
        conts = [_replica_cont(args, base, m, dv, bs // d, args.refill // d)
                 for m, dv in zip(reps.models, reps.devices)]
        cont = conts[0]
        if d > 1:
            cont = dict(base, replicas=conts, replica_set=reps,
                        arrive=arrive, batch_size=bs,
                        refill_size=args.refill)

    if args.warmup:
        _warmup(args, dcfg, vocab, bbuckets, cont, run_predict, dev, reps)

    if args.listen:
        serve_http(args, dcfg, responses_for, run_predict, vocab, bbuckets,
                   _server_ready, cont=cont)
        return

    src = sys.stdin if args.input == "-" else open(args.input,
                                                  encoding="utf-8")
    sink = sys.stdout if args.output == "-" else open(args.output, "w",
                                                      encoding="utf-8")
    try:
        if cont is not None:
            stats = run_offline_continuous(src, sink, args, dcfg, cont,
                                           responses_for)
        else:
            run_offline_batched(src, sink, args, dcfg, vocab, bbuckets,
                                run_predict, responses_for)
    finally:
        if src is not sys.stdin:
            src.close()
        if sink is not sys.stdout:
            sink.close()
        if reps is not None:
            reps.close()
    if served == 0:
        print("[serve] no requests", file=sys.stderr)
        return
    precision = sidecar["dtype"] if sidecar is not None else \
        ("bf16" if args.bf16 else "f32")
    where = "" if reps is None or len(reps) == 1 else \
        f", {len(reps)} replicas"
    if reps is not None and reps.pool > 1:
        where += f", pool split {reps.pool} ways"
    if cont is not None:
        print(f"[serve] {served} requests answered continuously "
              f"({stats['chunks']} chunks, {stats['refills']} refills, "
              f"epoch {epoch}, {precision}{where})", file=sys.stderr)
    else:
        print(f"[serve] {served} requests answered (epoch {epoch}, "
              f"{precision}{where})", file=sys.stderr)


def _replica_cont(args, base: dict, model, device, bs: int, refill: int
                  ) -> dict:
    """One replica's continuous serving: ``base`` (the featurizers, the
    lanes' buckets, the loop options) with the replica's programs, built on
    its model and device, at its share of the rows and refills."""
    from ..runtime.continuous import make_continuous_fns
    init_fn, chunk_fn, refill_fn = make_continuous_fns(
        model, args.max_target_length, args.chunk_steps,
        fast_argmax=args.fast_argmax, decoding=args.decoding,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        device=device)
    cont = dict(base, init=init_fn, chunk=chunk_fn, refill=refill_fn,
                batch_size=bs, refill_size=refill)
    if args.device_loop:
        from ..runtime.continuous.device_loop import make_device_loop_fns
        d = args.batch_size // bs
        stage = max(args.stage_rows // d, refill) if args.stage_rows else \
            max(refill, bs * args.device_loop * args.chunk_steps // 10)
        cont["device_fns"] = make_device_loop_fns(
            model, args.max_target_length, args.chunk_steps,
            n_chunks=args.device_loop, stage_rows=stage,
            refill_bound=refill, fast_argmax=args.fast_argmax,
            decoding=args.decoding, temperature=args.temperature,
            top_k=args.top_k, top_p=args.top_p, device=device)
    return cont


def _warmup(args, dcfg, vocab, bbuckets, cont, run_predict, dev,
            reps=None) -> None:
    """Run every serving program once before accepting traffic, with a
    synthetic request per (pool bucket x batch width): the first call's
    one-time work (kernel builds, cuBLAS handles, the allocator's pools,
    the device loop's CUDA-graph captures) happens here, before any
    request. Each replica's continuous programs run in its own thread (its
    card current), a replicated predict over every replica."""
    t0 = time.time()

    def warm_req(k):
        # explicit seed: keep the sampled-serving arrival-counter key
        # stream identical with and without --warmup
        return {"query": "warm up", "passages": ["warm up ."] * k,
                "seed": 0}

    pools = cont["buckets"] if cont is not None and "buckets" in cont \
        else (parse_buckets(args.pool_buckets, dcfg.num_passage)
              if args.pool_buckets else [dcfg.num_passage])

    def warm_cont(c):
        bs, refill = c["batch_size"], c["refill_size"]
        mbs = c["make_batch_for"] if "buckets" in c else \
            {pools[0]: c["make_batch"]}
        dfns = c.get("device_fns")
        for k, mb in mbs.items():
            for width in {bs, refill}:
                if dfns is not None:
                    # device-loop serving runs ITS programs (the encode at
                    # both widths; wrap, ring and mega at batch width, which
                    # captures the lane's graph); the chunk-loop programs
                    # never run
                    st, _ = dfns.init_fn(mb([warm_req(k)], width))
                    if width != bs:
                        continue
                    from ..runtime.continuous.device_loop import \
                        _empty_stage
                    uid = np.arange(bs, dtype=np.int64)
                    wrap = dfns.wrap_fn(st, uid, uid >= 0)
                    dfns.mega_fn(wrap, _empty_stage(dfns, wrap), 0)
                    continue
                st, _ = c["init"](mb([warm_req(k)], width))
                if width == bs:
                    c["chunk"](st)
        if dev.type == "cuda":
            torch.cuda.synchronize()

    if cont is not None and "replicas" in cont:
        cont["replica_set"].map(lambda i, c: warm_cont(c), cont["replicas"])
    elif cont is not None:
        warm_cont(cont)
    else:
        for k in pools:
            dk = dataclasses.replace(dcfg, num_passage=k)
            for width in bbuckets:
                run_predict(chunk_to_batch([warm_req(k)], args.model, vocab,
                                           dk, width)).get()
    kind = "continuous" if cont is not None else "predict"
    n = "" if reps is None or len(reps) == 1 else f" on {len(reps)} replicas"
    print(f"[serve] warmup ran the {kind} programs (pools {pools}){n} in "
          f"{time.time() - t0:.0f}s", file=sys.stderr)


if __name__ == "__main__":
    main()
