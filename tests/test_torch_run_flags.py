"""``cli/run``'s refused flags and the training options' switches, and its
entry points without a card (moved from ``tests/test_torch_run.py``).

They read the toy corpus of ``tests/test_torch_run.py``'s ``jax_run``,
prepared here by the port's ``cli/prepare`` (the JAX package's files:
``tests/test_torch_prepare.py``), without its JAX checkpoints: every test
here refuses before it reads a checkpoint or trains afresh."""

import json
import os

import numpy as np
import pytest
import torch

from case_rg_tpu_torch.cli.run import main as run_main
from fixtures import make_dataset
from tests.test_torch_kernels import one_torch_thread  # noqa: F401
from tests.test_torch_run import DATA, SHAPES, routing  # noqa: F401


@pytest.fixture(scope="module")
def toy_corpus(tmp_path_factory):
    """``jax_run``'s toy corpus prepared by the port, its output directory
    (no checkpoint) and the CLI's arguments."""
    from case_rg_tpu_torch.cli.prepare import main as prepare_main
    root = str(tmp_path_factory.mktemp("flags"))
    make_dataset(root, "toy", n_queries=12, n_passages=20)
    prepare_main(["--data_path", root, "--dataset", "toy", "--models",
                  "case", "--answer_len", "10"] + DATA)
    out = os.path.join(root, "out")
    common = ["--model", "case", "--data_path", root, "--dataset", "toy",
              "--output_path", out, "--batch_size", "4"] + SHAPES
    return {"root": root, "prep": os.path.join(root, "toy", "prepared"),
            "out": out, "common": common}


@pytest.mark.parametrize("extra, message", [
    (["--model", "glks", "--mode", "ps_train"], "only defined for masque"),
    (["--multihost"], "start every rank with torchrun"),
    (["--mesh_shape", "2,1"], "not the world size 1"),
    (["--pool_shard"], r"item 7b \(ii\) training"),
    (["--mode", "test", "--pool_shard", "--mesh_shape", "1,2", "--device",
      "cpu,cpu"], None),
    (["--ckpt_backend", "orbax"], "item 2"), (["--remat", "dots"], None),
    (["--seeded_dropout"], None), (["--bf16_scores", "--bf16_train"], None),
    (["--mesh_shape", "1"], None)],
    ids=["ps_train_glks", "multihost", "mesh_shape", "pool_shard",
         "model_axis", "orbax", "remat", "seeded_dropout",
         "bf16_scores", "mesh_shape_one"])
def test_refused_flags(toy_corpus, tmp_path, extra, message):
    """The flags still refused exit naming their ROADMAP item: training
    over the pool axis (item "7b (ii) training"), orbax (item 2).
    ``--multihost`` outside torchrun's environment exits naming torchrun
    (never a quiet world of one), and a ``--mesh_shape`` data axis must be
    the world size (``tests/test_torch_distributed.py`` runs the group
    itself). The training options (``--remat``, ``--seeded_dropout``,
    ``--bf16_scores``) and ``--mesh_shape 1`` (a world of one) train an
    epoch of the toy corpus: the checkpoint is written, its losses are
    finite and the switch is set. ``--mode test --pool_shard --mesh_shape
    1,2`` over ``cpu,cpu`` tests that epoch with the pool split in two and
    writes both splits' result files (their contents against the unsplit
    run: ``tests/test_torch_pool_cli.py``)."""
    from case_rg_tpu_torch.ops import attention, dropout
    from case_rg_tpu_torch.train.checkpoint import load_checkpoint
    argv = ["--model", "case", "--mode", "train", "--output_path",
            str(tmp_path)]
    testing = "test" in extra
    for flag in ("--model", "--mode"):
        if flag in extra:
            i = argv.index(flag)
            del argv[i:i + 2]
    if message is not None:
        with pytest.raises(SystemExit, match=message):
            run_main(argv + extra)
        return
    data = ["--data_path", toy_corpus["root"], "--dataset", "toy", "--epoch",
            "1", "--batch_size", "4", "--warmup_steps", "1"] + SHAPES
    if testing:
        run_main(["--model", "case", "--mode", "train", "--output_path",
                  str(tmp_path), "--device", "cpu"] + data)
        run_main(argv + extra + data)
        names = sorted(os.listdir(os.path.join(tmp_path, "result")))
        assert names == [f"toy_{s}_0.0.{x}" for s in ("dev", "test")
                         for x in ("answer", "run")]
        return
    run_main(argv + extra + ["--device", "cpu"] + data)
    ck = load_checkpoint(str(tmp_path), 0)
    assert ck["step"] > 0
    with open(os.path.join(tmp_path, "metrics.jsonl")) as f:
        rows = [json.loads(x) for x in f]
    assert rows and all(np.isfinite(v) for r in rows for k, v in r.items()
                        if k.startswith("dev_"))
    assert dropout.seeded_dropout_enabled() == ("--seeded_dropout" in extra)
    assert attention._BF16_SCORES == ("--bf16_scores" in extra)


def test_entry_points_need_a_card_unless_asked(toy_corpus, monkeypatch):
    from case_rg_tpu_torch.pipeline import Pipeline
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = os.path.join(toy_corpus["root"], "nocard")
    for mode in ("train", "test"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_main([x if x != toy_corpus["out"] else out
                      for x in toy_corpus["common"]] + ["--mode", mode])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Pipeline.from_checkpoint("case", output_path=toy_corpus["out"],
                                 prepared_dir=toy_corpus["prep"])
