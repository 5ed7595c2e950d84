"""Export the serving predict program as a ``torch.export`` archive (port
of ``case_rg_tpu/cli/export_model.py``): the checkpoint's parameters ride
inside it, so it runs with nothing but torch, this package's custom ops
(``kernels/library.py``) and the archive: no model code is called, and no
checkpoint or vocabulary is read.

The archive is shape-specialized (one per batch_size x pool size, like
every serving program here) and traced for one device: exporting on the
card (the default) yields a CUDA program whose graph launches the
hand-written kernels through their ops; ``--device cpu`` yields a CPU
program that runs their plain versions.

Usage:
    python -m case_rg_tpu_torch.cli.export_model --model case \\
        --prepared_dir ./dataset/cast/prepared --output_path ./output/case \\
        --out case_b64.pt2 [--epoch best|avg|N] [--batch_size 64] \\
        [--bf16] [--rank_only] [--check] [--device cpu]

Writes ``--out`` (``torch.export.save``) plus a ``.json`` sidecar with the
input spec (key -> shape/dtype), the device it was traced on
(``platforms``) and provenance. ``--check`` loads the archive again and
verifies that its outputs equal the live predict program's on a synthetic
batch. Load and call later with::

    from case_rg_tpu_torch.runtime.exported import load_exported
    fn = load_exported("case_b64.pt2")      # .call(batch_dict)

The decode is the fixed-trip one: ``--early_exit`` (a host read of every
row's EOS flag each step) cannot be traced and is refused.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--model", type=str, required=True,
                   choices=["case", "masque", "glks", "tmemnet", "gttp",
                            "s2sa"])
    p.add_argument("--prepared_dir", type=str, required=True)
    p.add_argument("--output_path", type=str, required=True)
    p.add_argument("--out", type=str, required=True,
                   help="artifact path (sidecar lands at <out>.json)")
    p.add_argument("--epoch", type=str, default=None,
                   help="int, 'best', or 'avg' (default: latest)")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--embedding_size", type=int, default=256)
    p.add_argument("--hidden_size", type=int, default=256)
    p.add_argument("--num_heads", type=int, default=8)
    p.add_argument("--max_target_length", type=int, default=40)
    p.add_argument("--beam_width", type=int, default=1)
    p.add_argument("--early_exit", action=argparse.BooleanOptionalAction,
                   default=False,
                   help="early-exit greedy decode: not exportable (refused; "
                        "the artifact runs the fixed-trip decode)")
    from .flags import add_fast_argmax_flag
    add_fast_argmax_flag(p)
    p.add_argument("--rank_only", action="store_true")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--ema", action="store_true")
    p.add_argument("--query_len", type=int, default=60)
    p.add_argument("--passage_len", type=int, default=100)
    p.add_argument("--num_passage", type=int, default=10)
    p.add_argument("--min_window_size", type=int, default=4)
    p.add_argument("--num_windows", type=int, default=1)
    p.add_argument("--check", action="store_true",
                   help="load the artifact again and verify it matches "
                        "the live predict program on a synthetic batch")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None) -> dict:
    """Returns what it printed: the sidecar, the artifact's bytes, export
    and save seconds and the custom ops in the graph by name; with
    ``--check`` also the loaded artifact and its load seconds."""
    args = build_parser().parse_args(argv)
    if args.early_exit:
        raise SystemExit("--early_exit: the early-exit decode reads every "
                         "row's EOS flag on the host each step, which "
                         "torch.export cannot trace; the artifact runs the "
                         "fixed-trip decode (ROADMAP Queue 1, export with "
                         "early exit)")
    from ..config import DataConfig
    from ..data.vocab import Vocabulary
    from ..device import resolve_device
    from ..runtime.exported import export_predict, graph_ops, load_exported
    from ..runtime.inference import RANK_MODELS, make_predict_fn
    from ..serving.featurize import chunk_to_batch
    from .serve import _resolve_epoch, load_model

    if args.rank_only and args.model not in RANK_MODELS:
        raise SystemExit(f"model {args.model!r} has no rank head (--rank_only "
                         f"needs one of {RANK_MODELS})")
    dev = resolve_device(args.device)
    vocab = Vocabulary.load(os.path.join(args.prepared_dir, "vocab.txt"))
    dcfg = DataConfig(query_len=args.query_len, passage_len=args.passage_len,
                      num_passage=args.num_passage,
                      answer_len=args.max_target_length,
                      min_window_size=args.min_window_size,
                      num_windows=args.num_windows)
    epoch = _resolve_epoch(args)
    mcfg, model = load_model(args, vocab, epoch)

    # the synthetic batch fixes the artifact's shapes (the featurizer
    # serving uses, so the artifact and serve agree on the input spec)
    warm = {"query": "export shape probe",
            "passages": ["export shape probe ."] * dcfg.num_passage}
    batch = chunk_to_batch([warm], args.model, vocab, dcfg, args.batch_size)
    opts = dict(beam_width=args.beam_width, fast_argmax=args.fast_argmax,
                rank_only=args.rank_only)
    t0 = time.perf_counter()
    try:
        program = export_predict(model, mcfg, batch, args.max_target_length,
                                 device=dev, **opts)
    except ValueError as e:   # a combination the model does not take
        raise SystemExit(str(e))
    t1 = time.perf_counter()
    torch.export.save(program, args.out)
    t2 = time.perf_counter()
    sidecar = {
        "model": args.model, "epoch": str(epoch),
        "platforms": [dev.type],
        "batch_size": args.batch_size,
        "dtype": "bfloat16" if args.bf16 else "float32",
        "rank_only": args.rank_only, "beam_width": args.beam_width,
        "max_target_length": args.max_target_length,
        "data": {"query_len": dcfg.query_len,
                 "passage_len": dcfg.passage_len,
                 "num_passage": dcfg.num_passage},
        "inputs": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in batch.items()},
    }
    with open(args.out + ".json", "w") as f:
        json.dump(sidecar, f, indent=1)
    ops = graph_ops(program)
    size = os.path.getsize(args.out)
    print(f"[export] {args.out}: {size / 1e6:.1f} MB, platforms "
          f"{sidecar['platforms']}, inputs {sorted(batch)}, traced in "
          f"{t1 - t0:.1f}s, ops {ops}", file=sys.stderr)
    report = {"sidecar": sidecar, "bytes": size, "export_s": t1 - t0,
              "save_s": t2 - t1, "ops": ops}

    if args.check:
        t0 = time.perf_counter()
        art = load_exported(args.out)
        report.update(load_s=time.perf_counter() - t0, artifact=art)
        got = art.call(batch)
        want = make_predict_fn(model, mcfg, args.max_target_length,
                               device=dev, **opts)(batch)
        if sorted(got) != sorted(want) or not all(
                torch.equal(got[k], want[k]) for k in want):
            raise SystemExit("[export] check FAILED: the artifact's output "
                             "differs from the live predict's")
        print("[export] check OK: artifact output == live predict",
              file=sys.stderr)
    return report


if __name__ == "__main__":
    main()
