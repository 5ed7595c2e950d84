"""CLI: offline data preparation (a copy of ``case_rg_tpu/cli/prepare.py``;
no device is touched, and torch is not imported).

Usage (mirrors the reference's ``python Prepare_dataset.py``):

    python -m case_rg_tpu_torch.cli.prepare --data_path ./dataset/ \
        --dataset cast [--models case] [--vocab_file vocab.txt] [--workers 4]
"""

import argparse

from ..config import DataConfig, MODEL_NAMES
from ..data.prepare import prepare_dataset


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", type=str, default="./dataset/")
    p.add_argument("--dataset", type=str, default="cast")
    p.add_argument("--out_dir", type=str, default=None)
    p.add_argument("--models", type=str, default=",".join(MODEL_NAMES))
    p.add_argument("--vocab_file", type=str, default=None)
    p.add_argument("--query_len", type=int, default=60)
    p.add_argument("--passage_len", type=int, default=100)
    p.add_argument("--num_passage", type=int, default=10)
    p.add_argument("--answer_len", type=int, default=40)
    p.add_argument("--min_window_size", type=int, default=4)
    p.add_argument("--num_windows", type=int, default=1)
    p.add_argument("--workers", type=int, default=0,
                   help="featurize the (split x model) jobs in a process "
                        "pool of this size (0/1 = serial; output identical)")
    args = p.parse_args(argv)

    # data-drop-in observability: passage sentence splitting defers to
    # nltk punkt when its data is installed (exact reference parity);
    # otherwise the curated rule splitter stands in. Log which, so any
    # corpus-parity run records its provenance.
    from ..data.text import sentence_splitter_variant
    sv = sentence_splitter_variant()
    print(f"[prepare] sentence splitter: {sv}"
          + (" (nltk punkt — exact reference parity)" if sv == "punkt" else
             " (curated fallback; install nltk punkt data for exact "
             "reference parity — data/text.py)"), flush=True)

    cfg = DataConfig(dataset=args.dataset, data_path=args.data_path,
                     query_len=args.query_len, passage_len=args.passage_len,
                     num_passage=args.num_passage, answer_len=args.answer_len,
                     min_window_size=args.min_window_size,
                     num_windows=args.num_windows, vocab_file=args.vocab_file)
    prepare_dataset(args.data_path, args.dataset, cfg, args.out_dir,
                    models=args.models.split(","), workers=args.workers)


if __name__ == "__main__":
    main()
