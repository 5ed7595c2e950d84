"""CLI: evaluate result files (rank + answer metrics) (a copy of
``case_rg_tpu/cli/evaluate.py``).

Replaces Run_Evaluation.py:

    python -m case_rg_tpu_torch.cli.evaluate --model case \
        --data_path ./dataset/ --datasets cast
"""

import argparse
import json
import os

from ..evaluation.harness import eval_all


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", type=str, required=True)
    p.add_argument("--data_path", type=str, default="./dataset/")
    p.add_argument("--datasets", type=str, default="cast",
                   help="comma-separated dataset names (ref evaluates "
                        "marco,quac,cast; Run_Evaluation.py:88-90)")
    p.add_argument("--output_path", type=str, default=None)
    p.add_argument("--report", type=str, default=None,
                   help="optional path to dump the metric report as JSON")
    args = p.parse_args(argv)

    output = args.output_path or os.path.join("./output", args.model)
    result_dir = os.path.join(output, "result")
    full_report = {}
    for ds in args.datasets.split(","):
        qrel = os.path.join(args.data_path, ds, f"{ds}.qrel")
        gold = os.path.join(args.data_path, ds, f"{ds}.answer")
        report = eval_all(result_dir, qrel, gold)
        full_report[ds] = report
    if args.report:
        with open(args.report, "w") as f:
            json.dump(full_report, f, indent=2)
    return full_report


if __name__ == "__main__":
    main()
