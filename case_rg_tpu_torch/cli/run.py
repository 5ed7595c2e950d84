"""CLI: train, test and average the six models (port of
``case_rg_tpu/cli/run.py``).

    python -m case_rg_tpu_torch.cli.run --model case --mode train \
        --data_path ./dataset/ --dataset cast --bf16_train
    python -m case_rg_tpu_torch.cli.run --model case --mode avg ...
    python -m case_rg_tpu_torch.cli.run --model case --mode test ...

``--model`` is case, masque, s2sa, gttp, glks or tmemnet; GLKS trains
with its ``ds_mle_mce_train`` losses, and ``--mode ps_train`` trains the
ranker of masque or tmemnet alone.

The JAX CLI's flags, defaults and output files. ``--device`` defaults to
cuda: without a card every mode but ``avg`` raises, and ``--device cpu``
runs on the CPU with each kernel's plain version.

Training resumes from the last completed epoch automatically
(``model/latest.json``; ``--no_resume`` starts afresh); SIGTERM or SIGINT
writes the salvage checkpoint ``model/{epoch}.preempt.pt`` at the next
batch boundary and exits 0. Each epoch writes ``model/{epoch}.pt`` with the
optimiser state, the dev loss (``--dev_eval``) goes to metrics.jsonl and
``model/best.json``. With ``--bf16_train`` the training attention runs the
``fused_train_mha_rng`` CUDA kernel (``--no-kernel_rng_dropout``:
``fused_train_mha`` with caller-drawn masks; ``--no-fused_train_attn``: the
plain attention), as the JAX CLI's auto rule routes its Pallas kernels.

Testing decodes every saved epoch (or ``--best_only``, ``--avg_only``) over
the prepared dev and test splits and writes ``result/{dataset}_{split}_
{epoch}.0.answer`` and ``.run`` (``runtime/io.save_results``); ``--mode
avg`` writes ``model/avg.pt``, the mean of several epochs' parameters and
EMA.

The training options, as the JAX CLI has them: ``--seeded_dropout``
(``ops/dropout.py``: the backward draws each dropout mask again from the
generator's saved state instead of keeping it), ``--remat
{dots,dots_batch,nothing}`` (``TrainConfig.remat``: the forward recomputed
in the backward under ``torch.utils.checkpoint``) and ``--bf16_scores``
(``ops/attention.set_bf16_scores``: bf16 attention scores for bf16 inputs
in the dense attention paths; the kernels keep f32 scores). Its default is
the JAX CLI's auto rule: on exactly for ``--mode train/ps_train
--bf16_train``. Every switch is set both ways on each ``main()``.

Several cards (``runtime/mesh``): one process a card, started by torchrun,
each with ``--multihost``::

    torchrun --nproc_per_node 4 -m case_rg_tpu_torch.cli.run --multihost \
        --model case --mode train ...

joins the process group of torchrun's environment (NCCL with a card a
rank; gloo where ranks share cards, and with ``--device cpu``).
``--batch_size`` is each rank's batch, so the global batch is that times
the ranks, as in the JAX package and the reference. ``--mode
train/ps_train`` trains data-parallel (``train/trainer``: the global
batch's loss and gradient, one state on every rank, checkpoints by rank
0); ``--mode test`` decodes rows ``[rank::count]`` on each rank and writes
``result/{dataset}_{split}_{epoch}.{rank}.answer`` and ``.run``, which
``cli/evaluate`` merges; ``--mode avg`` writes on rank 0. ``--mesh_shape
D`` or ``D,1`` must name the world size. ``--multihost`` without
torchrun's environment raises.

Flags with no effect in the port: ``--fast_rng``/``--no-fast_rng`` (the
port has one dropout generator, Philox on the card) and the JAX package's
XLA compile cache. Refused, each with the ROADMAP item that holds it:
``--pool_shard`` and a ``--mesh_shape`` model axis above 1 (item 7b: the
pool and vocabulary axes over cards) and ``--ckpt_backend orbax`` (item 2:
the card has no orbax, and no slice needs its on-disk format).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..config import ModelConfig, TrainConfig
from ..data.prepare import load_prepared
from ..data.vocab import Vocabulary
from ..models import build_model_cfg
from ..runtime import mesh
from ..runtime.io import save_results
from ..train.checkpoint import (best_epoch, checkpoint_exists,
                                load_checkpoint, save_checkpoint)

# the fields each model's decode reads (--continuous feeds these alone)
_DECODE_INPUTS = {"case": ("query", "passage"), "masque": ("query", "passage"),
                  "tmemnet": ("context", "passage"),
                  "s2sa": ("context", "background"),
                  "gttp": ("context", "background"),
                  "glks": ("context", "background")}


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--model", type=str, required=True,
                   choices=["case", "masque", "glks", "tmemnet", "gttp", "s2sa"],
                   help="the model to train, test or average")
    p.add_argument("--mode", type=str, required=True,
                   choices=["train", "test", "ps_train", "avg"])
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--data_path", type=str, default="./dataset/")
    p.add_argument("--dataset", type=str, default="cast")
    p.add_argument("--prepared_dir", type=str, default=None)
    p.add_argument("--output_path", type=str, default=None)
    p.add_argument("--embedding_size", type=int, default=256)
    p.add_argument("--hidden_size", type=int, default=256)
    p.add_argument("--num_heads", type=int, default=8)
    p.add_argument("--max_span_size", type=int, default=4)
    p.add_argument("--max_target_length", type=int, default=40)
    p.add_argument("--accumulation_steps", type=int, default=1)
    p.add_argument("--epoch", type=int, default=20)
    # global batch; the default resolves in main(): 64, except --mode test
    # --rank_only, which uses 128, as serve does
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--learning_rate", type=float, default=2.5e-4)
    p.add_argument("--warmup_steps", type=int, default=2000)
    p.add_argument("--beam_width", type=int, default=1)
    p.add_argument("--decoding", type=str, default="greedy",
                   choices=["greedy", "sample"],
                   help="test-time decoding; with the default 'greedy', "
                        "beam_width>1 selects beam search; 'sample' draws "
                        "from the model distribution (seeded by --seed) and "
                        "is incompatible with beam_width>1")
    p.add_argument("--ckpt_backend", type=str, default="msgpack",
                   choices=["msgpack", "orbax"],
                   help="msgpack: the port writes its own model/{epoch}.pt "
                        "(and reads the JAX package's msgpack); orbax is "
                        "refused (ROADMAP Queue 1 item 2)")
    from .flags import add_fast_argmax_flag
    add_fast_argmax_flag(p)
    p.add_argument("--fused_stack", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="the stack_step CUDA kernel for the passage-memory "
                        "decoder stack's decode step; default auto (bf16 "
                        "on the card, long memories)")
    p.add_argument("--rank_only", action="store_true",
                   help="--mode test: write only the .run ranking files, "
                        "skipping answer generation")
    p.add_argument("--fused_train_attn",
                   action=argparse.BooleanOptionalAction, default=None,
                   help="training: the CUDA training attention (forward and "
                        "backward with prob dropout) at the encoder and "
                        "tower self-attention sites. Default: on for "
                        "--bf16_train, off for f32 (the parity dtype)")
    p.add_argument("--kernel_rng_dropout",
                   action=argparse.BooleanOptionalAction, default=None,
                   help="training: draw the training attention's dropout "
                        "mask inside the kernel (Philox4x32-10, "
                        "fused_train_mha_rng) instead of passing a "
                        "caller-drawn mask (fused_train_mha). Default: on "
                        "for --bf16_train")
    p.add_argument("--seeded_dropout", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="training: each dropout mask is drawn again in the "
                        "backward from the generator's saved state instead "
                        "of being kept (same losses and gradients, less "
                        "memory)")
    p.add_argument("--temperature", type=float, default=1.0,
                   help="sampling temperature (--decoding sample)")
    p.add_argument("--top_k", type=int, default=0,
                   help="top-k sampling cutoff (0 = off)")
    p.add_argument("--top_p", type=float, default=1.0,
                   help="nucleus sampling mass (1.0 = off)")
    p.add_argument("--early_exit", action="store_true",
                   help="stop decoding once every row emitted EOS "
                        "(sentence-identical, faster)")
    p.add_argument("--bf16_eval", action="store_true",
                   help="cast parameters to bfloat16 for inference (the "
                        "serving kernels run; softmax stays f32)")
    p.add_argument("--bf16_scores", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="bf16 attention scores for bf16 inputs in the dense "
                        "attention paths (the kernels keep f32 scores). "
                        "Default: on for --mode train/ps_train --bf16_train, "
                        "off otherwise")
    p.add_argument("--fused_attn", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="the fused_mha CUDA kernel for bf16 encoder "
                        "attention on the card (--no-fused_attn: the plain "
                        "PyTorch attention)")
    p.add_argument("--ema_eval", action="store_true",
                   help="--mode test: decode with the EMA weights")
    p.add_argument("--no_resume", action="store_true")
    p.add_argument("--seed", type=int, default=123456)
    p.add_argument("--min_window_size", type=int, default=4)
    p.add_argument("--num_windows", type=int, default=1)
    p.add_argument("--multihost", action="store_true",
                   help="join the process group of torchrun's environment "
                        "(one process a card; runtime/mesh.init_distributed)")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="training: a torch.profiler trace of the loop "
                        "under this directory (runtime/profiling.trace)")
    p.add_argument("--early_stop", type=int, default=0,
                   help="stop training once the per-epoch dev loss "
                        "(--dev_eval) hasn't improved for this many "
                        "consecutive epochs; 0 = train the full --epoch "
                        "count. The best epoch is recorded in "
                        "model/best.json either way")
    p.add_argument("--best_only", action="store_true",
                   help="--mode test: decode only the best-dev-loss epoch "
                        "(model/best.json, written by --dev_eval training) "
                        "instead of every checkpoint")
    p.add_argument("--avg_epochs", type=str, default="",
                   help="--mode avg: comma-separated epochs to average "
                        "(default: the last 3 existing checkpoints)")
    p.add_argument("--avg_only", action="store_true",
                   help="--mode test: decode only the averaged checkpoint "
                        "(model/avg.pt, written by --mode avg)")
    p.add_argument("--dev_eval", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="deterministic dev loss after every training epoch "
                        "(logged as dev_* in metrics.jsonl; picks epochs "
                        "without decoding every checkpoint)")
    p.add_argument("--continuous", action="store_true",
                   help="--mode test: continuous-batching offline predict "
                        "(per-row decode progress + row refill). Answers "
                        "identical to the batch path")
    p.add_argument("--chunk_steps", type=int, default=8,
                   help="--continuous: decode steps between harvest/refill")
    p.add_argument("--refill", type=int, default=0,
                   help="--continuous: refill bucket size (0 = batch/4)")
    p.add_argument("--refill_min", type=int, default=1,
                   help="--continuous: coalesce refills - wait for this "
                        "many free rows before a mid-flight refill")
    p.add_argument("--lookahead", action="store_true",
                   help="--continuous: keep one chunk (or mega) dispatched "
                        "ahead (harvest fetch overlaps the next one's "
                        "compute)")
    p.add_argument("--device_loop", type=int, default=0, metavar="K",
                   help="--continuous: device loop - K chunks per "
                        "dispatch, harvest + refills on the card from a "
                        "ring of encoded requests, each mega one replay of "
                        "a CUDA graph on the card (runtime/continuous/"
                        "device_loop). 0 = the per-chunk host loop")
    p.add_argument("--stage_rows", type=int, default=0,
                   help="--device_loop: ring size in rows (0 = auto: "
                        "~batch*K*chunk_steps/10)")
    p.add_argument("--async_harvest", action="store_true",
                   help="--continuous: read each chunk's flags one round "
                        "later, from a host copy started at dispatch")
    p.add_argument("--checkpoint_every_steps", type=int, default=0,
                   help="mid-epoch salvage checkpoints every N steps")
    p.add_argument("--bf16_train", action="store_true",
                   help="mixed-precision training (bf16 compute, f32 master)")
    p.add_argument("--remat", type=str, default="",
                   choices=["", "dots", "dots_batch", "nothing"],
                   help="training: recompute the forward in the backward "
                        "(torch.utils.checkpoint): '' keeps every residual, "
                        "'dots' keeps matmul outputs, 'dots_batch' also "
                        "batched ones, 'nothing' recomputes all")
    p.add_argument("--mesh_shape", type=str, default="",
                   help="'D' or 'D,1': the data axis, which must be the "
                        "world size; a model axis above 1 is not ported "
                        "(ROADMAP Queue 1 item 7b): refused")
    p.add_argument("--pool_shard", action="store_true",
                   help="not ported (ROADMAP Queue 1 item 7b): refused")
    p.add_argument("--fast_rng", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="no effect in the port: dropout masks come from one "
                        "Philox generator on the card either way")
    return p


def _refuse_unported(args) -> None:
    if args.mode == "ps_train" and args.model not in ("masque", "tmemnet"):
        raise SystemExit("--mode ps_train is only defined for masque and "
                         "tmemnet (their rank-only training)")
    if args.pool_shard:
        raise SystemExit("--pool_shard: the pool axis over a 'model' mesh "
                         f"axis is not ported yet ({mesh.MODEL_AXIS_ITEM}); "
                         "data parallelism over cards is --multihost")
    if args.ckpt_backend == "orbax":
        raise SystemExit("--ckpt_backend orbax: not ported (ROADMAP Queue 1 "
                         "item 2: the port writes its own checkpoints and "
                         "reads the JAX package's msgpack ones); run "
                         "without it")


def setup(args, need_train: bool = True):
    """(prepared dir, output dir, train arrays or None, vocabulary, model
    config)."""
    prepared = args.prepared_dir or os.path.join(args.data_path, args.dataset,
                                                 "prepared")
    output = args.output_path or os.path.join("./output", args.model)
    arrays = None
    if need_train:
        arrays, _meta, vocab, _ = load_prepared(prepared, "train", args.model)
    else:
        vocab = Vocabulary.load(os.path.join(prepared, "vocab.txt"))
    base = ModelConfig(embedding_size=args.embedding_size,
                       hidden_size=args.hidden_size, num_heads=args.num_heads,
                       max_span_size=args.max_span_size,
                       max_target_length=args.max_target_length,
                       max_dec_len=args.max_target_length,
                       beam_width=args.beam_width,
                       min_window_size=args.min_window_size,
                       num_windows=args.num_windows)
    return prepared, output, arrays, vocab, build_model_cfg(base, args.model,
                                                            vocab)


def train(args):
    from ..models import create_model
    from ..train.trainer import Trainer

    prepared, output, arrays, vocab, mcfg = setup(args)
    n = len(arrays["id"])
    total_steps = int(args.epoch * n / (args.batch_size *
                                        args.accumulation_steps)) + 100
    tc = TrainConfig(batch_size=args.batch_size, epochs=args.epoch,
                     learning_rate=args.learning_rate,
                     warmup_steps=args.warmup_steps,
                     accumulation_steps=args.accumulation_steps,
                     seed=args.seed, output_path=output,
                     resume=not args.no_resume,
                     checkpoint_every_steps=args.checkpoint_every_steps,
                     compute_dtype="bfloat16" if args.bf16_train
                     else "float32", remat=args.remat,
                     mesh_shape=_mesh_shape(args))
    model = create_model(args.model, mcfg, device=args.device, seed=args.seed)
    loss_kwargs = {}
    if args.mode == "ps_train":
        loss_kwargs = {"mode": "ps_train"}
    elif args.model == "glks":
        loss_kwargs = {"mode": "ds_mle_mce_train"}
    trainer = Trainer(model, tc, total_steps, device=args.device,
                      loss_method_kwargs=loss_kwargs)
    state, start_epoch = trainer.resume_or_init(output)
    if mesh.process_index() == 0:
        print(f"[run] {args.model} train: {n} samples, {total_steps} steps, "
              f"start epoch {start_epoch}, {mesh.process_count()} rank(s)",
              flush=True)
    # per-epoch dev loss (epoch selection without decoding every
    # checkpoint); logged as dev_* in metrics.jsonl
    eval_arrays = None
    if args.dev_eval:
        dev_path = os.path.join(prepared, f"dev.{args.model}.npz")
        if os.path.exists(dev_path):
            eval_arrays, _, _, _ = load_prepared(prepared, "dev", args.model)
            if len(eval_arrays["id"]) == 0:
                eval_arrays = None
    if args.early_stop and eval_arrays is None:
        raise SystemExit("--early_stop needs --dev_eval and a prepared dev "
                         "split")
    trainer.fit(state, arrays, args.epoch, output, seed=args.seed,
                start_epoch=start_epoch, profile_dir=args.profile_dir,
                eval_arrays=eval_arrays, early_stop=args.early_stop)


def _load_weights(args, vocab, epoch, model):
    """The model (built on the first call, on the device, with ``--bf16_eval``
    in bf16) holding epoch ``epoch``'s parameters or, with ``--ema_eval``,
    its EMA: loaded, cast and moved once."""
    from ..bridge import load_state
    from .serve import load_model
    if model is None:
        serve_args = argparse.Namespace(**vars(args), bf16=args.bf16_eval,
                                        ema=args.ema_eval)
        return load_model(serve_args, vocab, epoch)[1]
    ck = load_checkpoint(args.output_path, epoch)
    load_state(model, ck["ema"] if args.ema_eval else ck["params"])
    return model


def test(args):
    from ..device import resolve_device
    from ..runtime.inference import make_predict_fn
    from ..train.trainer import predict

    prepared, output, _unused, vocab, mcfg = setup(args, need_train=False)
    args.output_path = output
    resolve_device(args.device)
    if args.continuous:
        if args.rank_only or args.beam_width > 1 or args.decoding != "greedy":
            raise SystemExit("--continuous is greedy full predict; it "
                             "composes with none of --rank_only/"
                             "--beam_width>1/--decoding sample")
        refill = args.refill or max(args.batch_size // 4, 1)
        if not 1 <= refill <= args.batch_size or args.chunk_steps < 1:
            raise SystemExit(f"--refill must be in [1, batch_size] and "
                             f"--chunk_steps >= 1; got refill {refill}, "
                             f"chunk_steps {args.chunk_steps}")

    splits = []
    for split in ("dev", "test"):
        path = os.path.join(prepared, f"{split}.{args.model}.npz")
        if os.path.exists(path):
            arrays, meta, _, _ = load_prepared(prepared, split, args.model)
            if len(meta) > 0:
                splits.append((split, arrays, meta))
    if not splits:
        print("[run] no dev/test splits prepared; nothing to do", flush=True)
        return

    epochs_to_test = range(args.epoch)
    if args.avg_only:
        if not checkpoint_exists(output, "avg"):
            raise SystemExit("--avg_only: no model/avg checkpoint under "
                             f"{output} (run --mode avg first)")
        print("[run] test averaged checkpoint only (model/avg)", flush=True)
        epochs_to_test = ["avg"]
    elif args.best_only:
        be = best_epoch(output)
        if be is None:
            raise SystemExit("--best_only: no model/best.json under "
                             f"{output} (train with --dev_eval first)")
        print(f"[run] test best epoch only: {be} (model/best.json)",
              flush=True)
        epochs_to_test = [be]

    model = predict_fn = cont = None
    for epoch in epochs_to_test:
        if not checkpoint_exists(output, epoch):
            continue
        model = _load_weights(args, vocab, epoch, model)
        if predict_fn is None:
            try:
                predict_fn = make_predict_fn(
                    model, model.cfg, args.max_target_length,
                    beam_width=args.beam_width, early_exit=args.early_exit,
                    fast_argmax=args.fast_argmax, decoding=args.decoding,
                    sample_seed=args.seed, temperature=args.temperature,
                    top_k=args.top_k, top_p=args.top_p,
                    rank_only=args.rank_only, device=args.device)
            except ValueError as e:
                raise SystemExit(str(e))
            if args.continuous:
                cont = _continuous_fns(args, model)
        print(f"[run] test epoch {epoch}", flush=True)
        for split, arrays, meta in splits:
            if cont is not None:
                preds = _predict_continuous(args, cont, arrays)
            else:
                preds = predict(arrays, predict_fn, args.batch_size)
            save_results(preds, meta, vocab, output, mesh.process_index(),
                         epoch, f"{args.dataset}_{split}")


def _continuous_fns(args, model):
    """The continuous decode's functions for ``--continuous``: (init, chunk,
    refill) of the chunk loop, or the device loop's ``DeviceLoopFns``
    (its buffers and captured graphs are kept across epochs and splits; new
    weights are captured again)."""
    refill = args.refill or max(args.batch_size // 4, 1)
    if args.device_loop:
        from ..runtime.continuous.device_loop import make_device_loop_fns
        stage = args.stage_rows or max(
            refill, args.batch_size * args.device_loop
            * args.chunk_steps // 10)
        return make_device_loop_fns(
            model, args.max_target_length, args.chunk_steps,
            n_chunks=args.device_loop, stage_rows=stage,
            refill_bound=refill, fast_argmax=args.fast_argmax,
            device=args.device)
    from ..runtime.continuous import make_continuous_fns
    return make_continuous_fns(model, args.max_target_length,
                               args.chunk_steps, fast_argmax=args.fast_argmax,
                               device=args.device)


def _predict_continuous(args, fns, arrays):
    """Offline continuous-batching predict (--mode test --continuous): rows
    decode at their own pace, freed slots refill from the remaining
    dataset rows. Answers equal the batch path's. Yields (host_batch,
    outputs) rows for save_results, in dataset order."""
    from ..runtime.continuous import run_continuous, run_continuous_device

    refill = args.refill or max(args.batch_size // 4, 1)
    feed = {k: arrays[k] for k in _DECODE_INPUTS[args.model]}

    def make_batch(reqs, k):
        sel = [r["i"] for r in reqs]
        sel = sel + [sel[-1]] * (k - len(sel))
        return {kk: vv[sel] for kk, vv in feed.items()}

    collected = []
    emit = lambda r, ids, rk: collected.append((r["i"], ids, rk))  # noqa: E731
    rows = range(len(arrays["id"]))[mesh.process_index()::
                                    mesh.process_count()]
    reqs = ({"i": i} for i in rows)
    if args.device_loop:
        run_continuous_device(reqs, make_batch, fns, args.batch_size, refill,
                              emit, max_len=args.max_target_length,
                              lookahead=args.lookahead)
    else:
        init_fn, chunk_fn, refill_fn = fns
        run_continuous(reqs, make_batch, init_fn, chunk_fn, refill_fn,
                       args.batch_size, refill, emit=emit,
                       lookahead=args.lookahead,
                       refill_min=max(1, min(args.refill_min, refill)),
                       async_harvest=args.async_harvest)
    for i, ids, rk in collected:
        out = {"answer": ids[None]}
        if rk is not None:
            out["rank"] = rk[None]
        yield {"id": [i], "_indices": [i]}, out


def average(args):
    """--mode avg: write model/avg.pt, the uniform average of several epoch
    checkpoints' parameters and EMA shadows (the optimiser state and step
    of the last). Decode it with ``--mode test --avg_only``; serve it with
    ``cli/serve --epoch avg``. Touches no device."""
    import torch

    output = args.output_path or os.path.join("./output", args.model)
    if args.avg_epochs:
        epochs = [int(x) for x in args.avg_epochs.split(",") if x]
    else:
        epochs = [e for e in range(args.epoch)
                  if checkpoint_exists(output, e)][-3:]
    missing = [e for e in epochs if not checkpoint_exists(output, e)]
    if not epochs or missing:
        raise SystemExit(f"--mode avg: no checkpoints to average "
                         f"(epochs {epochs}, missing {missing})")
    cks = [load_checkpoint(output, e) for e in epochs]

    def mean(name):
        # numpy's mean over the stacked epochs, as the JAX package takes it
        return {k: torch.from_numpy(np.mean(np.stack(
            [ck[name][k].numpy() for ck in cks], 0), 0))
            for k in cks[-1][name]}

    last = cks[-1]
    state = {"params": mean("params"), "ema": mean("ema"),
             "step": last["step"], **(last["opt_state"] or {})}
    save_checkpoint(output, "avg", state, update_latest=False)
    print(f"[run] averaged epochs {epochs} -> {output}/model/avg.pt",
          flush=True)


def set_switches(args) -> None:
    """Set the process-wide routing and training switches from ``args``,
    both ways (``main()`` is re-entered in-process). ``None`` defaults are
    the JAX CLI's auto rules: the training attention kernels and bf16
    scores on exactly for ``--mode train/ps_train --bf16_train``."""
    from ..models.multimem import set_fused_stack
    from ..ops import attention
    from ..ops.dropout import set_seeded_dropout
    training = args.mode in ("train", "ps_train") and args.bf16_train
    attention.set_fused_train_attention(
        training if args.fused_train_attn is None else args.fused_train_attn)
    attention.set_fused_train_attn_rng(
        training if args.kernel_rng_dropout is None
        else args.kernel_rng_dropout)
    attention.set_bf16_scores(
        training if args.bf16_scores is None else args.bf16_scores)
    set_seeded_dropout(args.seeded_dropout)
    attention.set_fused_attention(None if args.fused_attn else False)
    set_fused_stack(args.fused_stack)


def _mesh_shape(args) -> tuple:
    """``--mesh_shape`` as (D, M), checked against the world size; () when
    not given."""
    if not args.mesh_shape:
        return ()
    try:
        return mesh.parse_mesh_shape(args.mesh_shape)
    except ValueError as e:
        raise SystemExit(str(e))


def main(argv=None):
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    if args.batch_size is None:
        # rank-only test mode has no sequential decode: serve's B=128 knee
        args.batch_size = (128 if args.mode == "test" and args.rank_only
                           else 64)
    np.random.seed(args.seed)
    set_switches(args)
    if args.multihost:
        try:
            mesh.init_distributed(args.device)
        except RuntimeError as e:
            raise SystemExit(str(e))
    try:
        _mesh_shape(args)
        if args.mode in ("train", "ps_train"):
            train(args)
        elif args.mode == "avg":
            average(args)
        else:
            test(args)
    finally:
        if args.multihost:
            mesh.shutdown()


if __name__ == "__main__":
    main()
