"""``cli/run`` trains and tests each of the other models on the toy corpus, and
the card's tests of ``cli/run`` (moved from ``tests/test_torch_run.py``)."""

import json
import os

import numpy as np
import pytest
import torch

from case_rg_tpu_torch.cli.run import main as run_main
from fixtures import make_dataset
from tests.test_torch_kernels import cuda, one_torch_thread  # noqa: F401
from tests.test_torch_run import DATA, SHAPES, ck_cfg, routing  # noqa: F401


@pytest.mark.parametrize("name, mode, losses", [
    ("masque", "train", {"select", "gen"}), ("s2sa", "train", {"mle"}),
    ("tmemnet", "ps_train", {"select"}),
    ("glks", "train", {"mle", "mce", "ds"})],
    ids=["masque", "s2sa", "ps_train", "glks"])
def test_cli_runs_the_other_models(tmp_path, name, mode, losses):
    """cli/run trains each of the other models one epoch on the toy corpus
    (prepared for it by the port's cli/prepare) with its losses (GLKS's
    ds_mle_mce_train, ps_train the ranker alone: the decoder keeps its
    seeded weights), then --mode test writes its answers (and, for the
    models with a rank head, rankings) for both splits."""
    from case_rg_tpu_torch.cli.prepare import main as prepare_main
    from case_rg_tpu_torch.models import create_model
    from case_rg_tpu_torch.train.checkpoint import load_checkpoint

    root = str(tmp_path)
    make_dataset(root, "toy", n_queries=12, n_passages=20)
    prepare_main(["--data_path", root, "--dataset", "toy", "--models", name,
                  "--answer_len", "10"] + DATA)
    out = os.path.join(root, "out")
    common = ["--model", name, "--data_path", root, "--dataset", "toy",
              "--output_path", out, "--batch_size", "4", "--device", "cpu",
              "--epoch", "1"] + SHAPES
    run_main(common + ["--mode", mode, "--learning_rate", "1e-3",
                       "--warmup_steps", "1"])
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = [json.loads(x) for x in f]
    assert {k[4:] for r in rows for k in r if k.startswith("dev_")} == \
        losses | {"total"}
    ck = load_checkpoint(out, 0)
    if mode == "ps_train":
        init = dict(create_model(name, ck_cfg(ck, name), device="cpu",
                                 seed=123456).named_parameters())
        moved = {k for k, v in ck["params"].items()
                 if not torch.equal(v, init[k].detach())}
        assert moved and all(not k.startswith(("decoder.", "dec_", "gen."))
                             for k in moved), sorted(moved)
    run_main(common + ["--mode", "test"])
    result = os.path.join(out, "result")
    for split in ("dev", "test"):
        with open(os.path.join(result, f"toy_{split}_0.0.answer")) as f:
            assert len(f.read().splitlines()) > 0
        assert os.path.exists(os.path.join(
            result, f"toy_{split}_0.0.run")) == (name != "s2sa" and
                                                 name != "glks")


@pytest.mark.cuda
def test_train_and_test_on_the_card(cuda, tmp_path):
    """One bf16 epoch through cli/run on the card (the training-attention
    and additive_scores kernels launched), then --mode test --bf16_eval:
    its files equal ``make_predict_fn`` on the prepared batches written by
    ``save_results``, token for token and ranking for ranking."""
    import argparse

    from case_rg_tpu_torch.cli.prepare import main as prepare_main
    from case_rg_tpu_torch.cli.serve import load_model
    from case_rg_tpu_torch.data.prepare import load_prepared
    from case_rg_tpu_torch.data.vocab import Vocabulary
    from case_rg_tpu_torch.kernels import additive_attention, train_attention
    from case_rg_tpu_torch.runtime.inference import make_predict_fn
    from case_rg_tpu_torch.runtime.io import save_results
    from case_rg_tpu_torch.train.trainer import predict

    root = str(tmp_path)
    make_dataset(root, "toy", n_queries=24, n_passages=40)
    prepare_main(["--data_path", root, "--dataset", "toy", "--models",
                  "case", "--query_len", "24", "--passage_len", "100",
                  "--num_passage", "6", "--answer_len", "12"])
    out = os.path.join(root, "out")
    common = ["--model", "case", "--data_path", root, "--dataset", "toy",
              "--output_path", out, "--batch_size", "8",
              "--max_target_length", "12", "--epoch", "1"]
    fwd, bwd = train_attention.LAUNCHES_FWD["rng"], \
        additive_attention.LAUNCHES_BWD
    run_main(common + ["--mode", "train", "--bf16_train",
                       "--learning_rate", "1e-3", "--warmup_steps", "1"])
    assert train_attention.LAUNCHES_FWD["rng"] > fwd
    assert additive_attention.LAUNCHES_BWD > bwd
    run_main(common + ["--mode", "test", "--bf16_eval", "--fast_argmax",
                       "pallas"])
    prep = os.path.join(root, "toy", "prepared")
    args = argparse.Namespace(
        model="case", output_path=out, device="cuda", bf16=True, ema=False,
        embedding_size=256, hidden_size=256, num_heads=8,
        max_target_length=12, beam_width=1, min_window_size=4,
        num_windows=1)
    vocab = Vocabulary.load(os.path.join(prep, "vocab.txt"))
    cfg, model = load_model(args, vocab, 0)
    fn = make_predict_fn(model, cfg, 12, fast_argmax="pallas", device=cuda)
    ref = os.path.join(root, "ref")
    for split in ("dev", "test"):
        arrays, meta, _, _ = load_prepared(prep, split, "case")
        save_results(predict(arrays, fn, 8), meta, vocab, ref, 0, 0,
                     f"toy_{split}")
    for name in os.listdir(os.path.join(ref, "result")):
        with open(os.path.join(ref, "result", name)) as f:
            want = f.read()
        with open(os.path.join(out, "result", name)) as f:
            assert f.read() == want, name


@pytest.mark.cuda
def test_remat_step_under_no_host_sync_on_the_card(cuda):
    """A bf16 CaSE train step on the card with the in-kernel-RNG training
    attention, under ``--remat dots`` and under ``device.no_host_sync``:
    its loss equals the step without remat bit for bit, its gradients
    agree at cosine >= 0.9999 (the embedding gradient's accumulating
    index_put adds in no fixed order), and the recompute runs each
    training-attention forward again."""
    from case_rg_tpu_torch.config import ModelConfig, TrainConfig
    from case_rg_tpu_torch.device import batch_to_device, no_host_sync
    from case_rg_tpu_torch.kernels import train_attention
    from case_rg_tpu_torch.models import create_model
    from case_rg_tpu_torch.train.trainer import Trainer
    cfg = ModelConfig(name="case", vocab_size=1000, embedding_size=256,
                      hidden_size=256, num_heads=8, enc_layers=1,
                      dec_layers=2, max_dec_len=12, max_target_length=12,
                      dropout=0.1)
    rng = np.random.RandomState(0)
    b, p, lp = 4, 6, 100
    batch = {"query": rng.randint(4, 1000, (b, 1, 24)),
             "passage": rng.randint(4, 1000, (b, p, lp)),
             "response": rng.randint(4, 1000, (b, 12)),
             "passage_label": rng.randint(0, p, b),
             "token_label": (rng.rand(b, p, lp) > .9).astype(np.float32),
             "token_weight": np.ones((b, p, lp), np.float32)}
    batch["response"][:, 9:] = 0
    batch = batch_to_device({k: v.astype(np.int32) if v.dtype == np.int64
                             else v for k, v in batch.items()}, cuda)
    runs = []
    for remat in ("", "dots"):
        model = create_model("case", cfg, device=cuda, seed=0)
        trainer = Trainer(model, TrainConfig(compute_dtype="bfloat16",
                                             remat=remat),
                          total_steps=10, device=cuda)
        st = trainer.init_state()
        gen = torch.Generator(device=cuda).manual_seed(3)
        trainer.loss_and_grads(st, batch, gen)     # first-call work
        gen = torch.Generator(device=cuda).manual_seed(3)
        before = train_attention.LAUNCHES_FWD["rng"]
        with no_host_sync():
            losses, grads = trainer.loss_and_grads(st, batch, gen)
        torch.cuda.synchronize()
        runs.append((losses["total"].item(),
                     torch.cat([g.float().flatten() for g in grads.values()]),
                     train_attention.LAUNCHES_FWD["rng"] - before))
    (l0, g0, f0), (l1, g1, f1) = runs
    assert l1 == l0 and f1 == 2 * f0 > 0
    assert torch.nn.functional.cosine_similarity(g0, g1, dim=0) >= 0.9999
