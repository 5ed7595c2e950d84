"""``cli/serve``'s refused flags, the other models served from text, serving
without a card, and the card's test of the CLI (moved from
``tests/test_torch_serve.py``, whose docstring describes them).

They read ``served``'s toy corpus, requests and arguments without its JAX
checkpoint and JAX CLI run: every test here refuses before it reads a
checkpoint, or serves one it writes."""

import json
import os

import numpy as np
import pytest
import torch

from case_rg_tpu_torch.cli.serve import main as port_main
from tests.test_torch_export import shared_export_loads  # noqa: F401
from tests.test_torch_kernels import cuda, one_torch_thread  # noqa: F401
from tests.test_torch_serve import (  # noqa: F401
    SHAPES, WORDS, _port, _requests, _write, saved_programs_served)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """``tests/test_torch_serve.py``'s ``served`` up to its checkpoint: the
    toy corpus prepared by the JAX package's cli/prepare, the requests and
    the CLI's arguments, an output directory with no checkpoint."""
    from case_rg_tpu.cli.prepare import main as prepare_main
    from fixtures import make_dataset

    root = str(tmp_path_factory.mktemp("serve_flags"))
    make_dataset(root, "toy", n_queries=12, n_passages=20)
    prepare_main(["--data_path", root, "--dataset", "toy", "--models",
                  "case", "--query_len", "24", "--passage_len", "24",
                  "--num_passage", "4", "--answer_len", "10"])
    prep = os.path.join(root, "toy", "prepared")
    out = os.path.join(root, "out")
    reqs = _requests()
    req_path = os.path.join(root, "reqs.jsonl")
    _write(req_path, reqs)
    common = ["--model", "case", "--prepared_dir", prep, "--output_path",
              out, "--input", req_path, "--batch_size", "4"] + SHAPES
    return {"root": root, "common": common, "reqs": reqs, "prep": prep,
            "out": out}


@pytest.mark.parametrize("extra, message", [
    (["--from_export", "artifact", "--continuous"],
     "--continuous does not apply"),
    (["--from_export", "artifact", "--bf16"], "--bf16 does not apply"),
    (["--from_export", "artifact", "--pool_shard", "2"],
     "--pool_shard does not apply"),
    (["--from_export", "artifact", "--bf16_scores"],
     "--bf16_scores does not apply"),
], ids=["from_export-continuous", "from_export-bf16", "pool_shard",
        "bf16_scores"])
def test_refused_flags(served, extra, message):
    """Each refused flag exits with its message. ``--bf16_scores`` is
    refused only with ``--from_export`` (the archive fixes its program);
    on its own it is served (``test_bf16_scores_is_served``). So is
    ``--pool_shard``, which serves over a device group
    (``tests/test_torch_pool_cli.py``) but not an exported program, as in
    the JAX CLI."""
    with pytest.raises(SystemExit, match=message):
        _port(served, "refused", *extra)


@pytest.mark.parametrize("name", ["masque", "glks", "tmemnet"])
def test_serves_the_other_models(served, tmp_path, name):
    """The port's CLI serves the other models from a port checkpoint (random
    weights with noisy biases): its JSONL equals ``make_predict_fn`` on
    ``chunk_to_batch`` of the same requests, detokenized as the CLI does,
    and rankings (masque, tmemnet) order each pool by the rank scores."""
    from case_rg_tpu_torch.config import DataConfig, ModelConfig
    from case_rg_tpu_torch.data.vocab import Vocabulary
    from case_rg_tpu_torch.models import (build_model_cfg, create_model,
                                          perturb_affine)
    from case_rg_tpu_torch.runtime.inference import make_predict_fn
    from case_rg_tpu_torch.runtime.io import ids_to_sentence, remove_duplicate
    from case_rg_tpu_torch.serving.featurize import chunk_to_batch
    from case_rg_tpu_torch.train.checkpoint import save_checkpoint

    vocab = Vocabulary.load(os.path.join(served["prep"], "vocab.txt"))
    cfg = build_model_cfg(ModelConfig(embedding_size=16, hidden_size=16,
                                      num_heads=2, max_target_length=10,
                                      max_dec_len=10), name, vocab)
    model = create_model(name, cfg, device="cpu", seed=3)
    perturb_affine(model, torch.Generator().manual_seed(4))
    params = dict(model.named_parameters())
    out = str(tmp_path / "out")
    save_checkpoint(out, 0, {"params": params, "ema": params, "step": 0})
    common = [x if x != served["out"] else out for x in served["common"]]
    common[common.index("--model") + 1] = name
    path = str(tmp_path / "got.jsonl")
    port_main(common + ["--output", path, "--device", "cpu"])
    with open(path) as f:
        got = [json.loads(x) for x in f]

    dcfg = DataConfig(query_len=24, passage_len=24, num_passage=4,
                      answer_len=10)
    predict = make_predict_fn(model, cfg, 10, device="cpu")
    detok = vocab.detokenizer()
    reqs = served["reqs"]
    assert len(got) == len(reqs)
    for i in range(0, len(reqs), 4):
        chunk = reqs[i:i + 4]
        pred = predict(chunk_to_batch(chunk, name, vocab, dcfg, 4))
        caps = [min(r.get("max_tokens", 10), 10) for r in chunk]
        sents = [ids_to_sentence(row[:c], vocab) for row, c in
                 zip(pred["answer"].numpy(), caps)]
        remove_duplicate(sents)
        for j, (resp, req) in enumerate(zip(got[i:i + 4], chunk)):
            assert resp["id"] == req.get("id", i + j)
            assert resp["answer"] == detok(sents[j])
            assert ("ranking" in resp) == (name != "glks")
            if name != "glks":
                n_real = min(len(req["passages"]), 4)
                scores = pred["rank"][j].numpy()[:max(n_real, 1)]
                assert resp["ranking"] == [int(k) for k in np.argsort(
                    -scores, kind="stable")[:n_real]]
    assert any(r["answer"] for r in got)


def test_serve_needs_a_card_unless_asked(served, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_main(served["common"] + ["--output", os.path.join(
            served["root"], "nocard.jsonl")])


@pytest.mark.cuda
def test_cli_on_the_card_equals_the_serving_loops(cuda, tmp_path):
    """bf16 on the card: the CLI's batched answers equal ``make_predict_fn``
    on ``chunk_to_batch`` of the same requests, and its device-loop answers
    ``run_continuous_device`` on the same batches, token for token (as the
    CLI detokenizes them)."""
    from case_rg_tpu_torch.config import DataConfig, ModelConfig
    from case_rg_tpu_torch.data.vocab import Vocabulary
    from case_rg_tpu_torch.models import (build_model_cfg, create_model,
                                          perturb_affine)
    from case_rg_tpu_torch.runtime.continuous import (make_device_loop_fns,
                                                      run_continuous_device)
    from case_rg_tpu_torch.runtime.inference import make_predict_fn
    from case_rg_tpu_torch.runtime.io import ids_to_sentence, remove_duplicate
    from case_rg_tpu_torch.serving.featurize import chunk_to_batch
    from case_rg_tpu_torch.train.checkpoint import save_checkpoint

    prep, out = tmp_path / "prepared", str(tmp_path / "out")
    prep.mkdir()
    vocab = Vocabulary.build_from_texts([WORDS + [w + "s" for w in WORDS]])
    vocab.save(str(prep / "vocab.txt"))
    vocab = Vocabulary.load(str(prep / "vocab.txt"))
    n_pass, lq, lp, t = 6, 24, 100, 12
    cfg = build_model_cfg(ModelConfig(embedding_size=256, hidden_size=256,
                                      num_heads=8, max_target_length=t,
                                      max_dec_len=t), "case", vocab)
    f32 = create_model("case", cfg, device=cuda)
    perturb_affine(f32, torch.Generator(device=cuda).manual_seed(1))
    params = dict(f32.named_parameters())
    save_checkpoint(out, 0, {"params": params, "ema": params, "step": 0})
    model = f32.to(torch.bfloat16)
    reqs = _requests(24, seed=3)
    for r in reqs:
        r["passages"] = r["passages"] * 3
    req_path = str(tmp_path / "reqs.jsonl")
    _write(req_path, reqs)
    dcfg = DataConfig(query_len=lq, passage_len=lp, num_passage=n_pass,
                      answer_len=t)
    common = ["--model", "case", "--prepared_dir", str(prep),
              "--output_path", out, "--input", req_path, "--batch_size",
              "8", "--bf16", "--fast_argmax", "pallas",
              "--max_target_length", str(t), "--query_len", str(lq),
              "--passage_len", str(lp), "--num_passage", str(n_pass)]
    detok = vocab.detokenizer()

    def answers(ids_rows, chunk):
        caps = [min(r.get("max_tokens", t), t) for r in chunk]
        sents = [ids_to_sentence(row[:max(c, 1)], vocab)
                 for row, c in zip(ids_rows, caps)]
        remove_duplicate(sents)
        return [detok(s) for s in sents]

    def cli(*extra):
        path = str(tmp_path / "got.jsonl")
        port_main(common + ["--output", path] + list(extra))
        with open(path) as f:
            return [json.loads(x)["answer"] for x in f]

    predict = make_predict_fn(model, cfg, t, early_exit=True,
                              fast_argmax="pallas", device=cuda)
    want = []
    for i in range(0, len(reqs), 8):
        chunk = reqs[i:i + 8]
        ids = predict(chunk_to_batch(chunk, "case", vocab, dcfg, 8))
        want += answers(ids["answer"].cpu().numpy(), chunk)
    assert cli() == want

    fns = make_device_loop_fns(model, t, 2, 2, 8, refill_bound=2,
                               fast_argmax="pallas", device=cuda)
    got = {}
    run_continuous_device(
        iter(reqs), lambda c, k: chunk_to_batch(c, "case", vocab, dcfg, k),
        fns, 8, 2, lambda r, ids, rk: got.__setitem__(id(r), ids), t)
    direct = [answers([got[id(r)]], [r])[0] for r in reqs]
    assert cli("--continuous", "--device_loop", "2", "--chunk_steps", "2",
               "--refill", "2", "--stage_rows", "8") == direct
