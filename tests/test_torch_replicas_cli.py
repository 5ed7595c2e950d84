"""The port's serving and testing entry points over several replicas in
one process (``cli/run --mode test``, ``train/trainer.predict``,
``cli/serve`` batched, continuous, device loop and HTTP,
``Pipeline.from_checkpoint``), on the CPU with ``--device cpu,cpu`` (and
four replicas), against the same entry point on one device.

A module fixture prepares the toy corpus with the port's ``cli/prepare``
and trains CaSE two epochs through the port's ``cli/run`` (f32, B=4), so
the test runs cover two checkpoints (the replicas take each epoch's new
weights). Held here:

* ``cli/run --mode test`` over replicas writes the one-process result
  files: ``.answer`` byte for byte, ``.run`` the same rankings with each
  score within 1e-5 (``tests/test_torch_run._same_run``: a GEMM over a
  replica's row block may round otherwise than over the whole batch);
  batched (``trainer.predict``, four replicas), the chunk loop and the
  device loop (two replicas, one loop each);
* ``cli/serve`` over two replicas writes the one-device JSONL: the same
  answers, and rankings equal but for the order of rank scores within
  1e-5 of each other (``tests/test_torch_serve._same_responses``; a
  request encoded in a refill of another width may round otherwise):
  batched with batch buckets, the continuous chunk loop with
  lookahead, the device loop with pool buckets, sampled continuous
  serving whose requests carry no seed (the arrival-order keys), and the
  HTTP server's continuous loop (by response id);
* ``Pipeline.from_checkpoint(device="cpu,cpu")`` answers as on one device.

``tests/test_torch_replicas.py`` holds each replica's rows to one device
on the same row block bit for bit, and the replicas to the JAX package's
``local_mesh`` predict.
"""

import json
import os
import shutil

import pytest

from case_rg_tpu_torch.cli.run import main as run_main
from case_rg_tpu_torch.cli.serve import build_parser, load_model
from case_rg_tpu_torch.cli.serve import main as serve_main
from case_rg_tpu_torch.config import DataConfig
from case_rg_tpu_torch.data.vocab import Vocabulary
from case_rg_tpu_torch.runtime.inference import make_predict_fn
from case_rg_tpu_torch.serving.featurize import bucket_for, chunk_to_batch
from fixtures import make_dataset
from tests.test_torch_kernels import one_torch_thread  # noqa: F401
from tests.test_torch_run import _same_results, _stems
from tests.test_torch_serve import _http, _requests, _same_responses, _write

SHAPES = ["--embedding_size", "16", "--hidden_size", "16", "--num_heads",
          "2", "--max_target_length", "10"]
DATA = ["--query_len", "24", "--passage_len", "24", "--num_passage", "4"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The toy corpus prepared by the port, CaSE trained 2 epochs by the
    port's cli/run on the CPU, and 16 serving requests."""
    from case_rg_tpu_torch.cli.prepare import main as prepare_main

    root = str(tmp_path_factory.mktemp("replicas"))
    make_dataset(root, "toy", n_queries=12, n_passages=20)
    prepare_main(["--data_path", root, "--dataset", "toy", "--models",
                  "case", "--answer_len", "10"] + DATA)
    out = os.path.join(root, "out")
    common = ["--model", "case", "--data_path", root, "--dataset", "toy",
              "--batch_size", "4"] + SHAPES
    run_main(common + ["--output_path", out, "--device", "cpu", "--mode",
                       "train", "--epoch", "2", "--learning_rate", "3e-3",
                       "--warmup_steps", "1"])
    reqs = _requests(16, seed=3)
    _write(os.path.join(root, "reqs.jsonl"), reqs)
    prep = os.path.join(root, "toy", "prepared")
    serve = ["--model", "case", "--prepared_dir", prep, "--output_path", out,
             "--input", os.path.join(root, "reqs.jsonl"),
             "--batch_size", "4"] + SHAPES + DATA
    # each request's rank scores on one device, to find near-ties
    vocab = Vocabulary.load(os.path.join(prep, "vocab.txt"))
    mcfg, model = load_model(build_parser().parse_args(
        serve + ["--device", "cpu"]), vocab, 1)
    rank = make_predict_fn(model, mcfg, 10, rank_only=True, device="cpu")
    scores = {"padded": {}, "bucketed": {}}
    for i, req in enumerate(reqs):
        for kind, pool in (("padded", 4), ("bucketed", bucket_for(
                len(req["passages"]), [2, 4]))):
            dcfg = DataConfig(query_len=24, passage_len=24,
                              num_passage=pool, answer_len=10)
            scores[kind][req.get("id", i)] = rank(chunk_to_batch(
                [req], "case", vocab, dcfg, 1))["rank"][0].numpy()
    return {"root": root, "out": out, "common": common, "serve": serve,
            "reqs": reqs, "scores": scores}


def _test_run(trained, name, device, extra):
    """``cli/run --mode test`` of both epochs into a copy of the trained
    output directory; returns the result directory."""
    out = os.path.join(trained["root"], name)
    shutil.copytree(os.path.join(trained["out"], "model"),
                    os.path.join(out, "model"))
    run_main(trained["common"] + ["--output_path", out, "--device", device,
                                  "--mode", "test", "--epoch", "2"] + extra)
    return os.path.join(out, "result")


@pytest.mark.parametrize("device, extra", [
    ("cpu,cpu,cpu,cpu", []),
    ("cpu,cpu", ["--continuous", "--refill", "2", "--chunk_steps", "3"]),
    ("cpu,cpu", ["--continuous", "--refill", "2", "--device_loop", "2",
                 "--chunk_steps", "2"])],
    ids=["batched", "chunk-loop", "device-loop"])
def test_cli_test_over_replicas_writes_the_one_process_files(trained, device,
                                                             extra):
    tag = "-".join(extra).replace("--", "") or "batched"
    want = _test_run(trained, f"one-{tag}", "cpu", extra)
    got = _test_run(trained, f"reps-{tag}", device, extra)
    names = sorted(os.listdir(want))
    assert names == sorted(os.listdir(got))
    assert len(names) == 8      # 2 splits x 2 epochs x (.answer, .run)
    _same_results(os.path.dirname(got), os.path.dirname(want),
                  _stems([0, 1]))


def _serve(trained, name, device, extra):
    path = os.path.join(trained["root"], f"{name}-{device}.jsonl")
    serve_main(trained["serve"] + ["--output", path, "--device", device]
               + extra)
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("extra", [
    ["--batch_buckets", "2,4", "--pool_buckets", "2,4"],
    ["--continuous", "--refill", "2", "--chunk_steps", "3", "--lookahead"],
    ["--continuous", "--refill", "2", "--device_loop", "2", "--chunk_steps",
     "2", "--pool_buckets", "2,4", "--warmup"],
    ["--continuous", "--refill", "2", "--chunk_steps", "2", "--decoding",
     "sample", "--sample_seed", "5", "--top_k", "20"]],
    ids=["batched", "chunk-loop", "device-loop", "sampled"])
def test_cli_serve_over_replicas_equals_one_device(trained, extra, capsys):
    """Two replicas (d = gcd(buckets, refill, 2) = 2) answer every request
    as one device does, in request order."""
    name = "-".join(extra).replace("--", "")
    want = _serve(trained, name, "cpu", extra)
    assert "replicas" not in capsys.readouterr().err
    got = _serve(trained, name, "cpu,cpu", extra)
    assert ", 2 replicas)" in capsys.readouterr().err
    assert len(want.splitlines()) == len(trained["reqs"])
    _same_responses([json.loads(x) for x in got.splitlines()],
                    [json.loads(x) for x in want.splitlines()],
                    trained["scores"]["bucketed" if "--pool_buckets" in extra
                                      else "padded"])


def test_http_and_pipeline_over_replicas(trained):
    """The HTTP server's continuous loop over two replicas answers each
    request as the one-device offline run does; ``Pipeline`` over two
    replicas answers as on one device."""
    from case_rg_tpu_torch.pipeline import Pipeline

    extra = ["--continuous", "--refill", "2", "--chunk_steps", "2"]
    want = {json.loads(x)["id"]: json.loads(x) for x in
            _serve(trained, "http-ref", "cpu", extra).splitlines()}
    reqs = [r for r in trained["reqs"] if "id" in r]
    got, varz, _ = _http(None, extra + ["--device", "cpu,cpu"],
                         [reqs[i::3] for i in range(3)],
                         common=trained["serve"])
    assert varz["errors"] == 0 and varz["requests_served"] == len(reqs)
    _same_responses([got[r["id"]] for r in reqs],
                    [want[r["id"]] for r in reqs],
                    trained["scores"]["padded"])

    kw = dict(output_path=trained["out"],
              prepared_dir=os.path.join(trained["root"], "toy", "prepared"),
              batch_size=4, embedding_size=16, hidden_size=16, num_heads=2,
              max_target_length=10, query_len=24, passage_len=24,
              num_passage=4)
    one = Pipeline.from_checkpoint("case", device="cpu", **kw)
    two = Pipeline.from_checkpoint("case", device="cpu,cpu", **kw)
    reqs = trained["reqs"][:6]

    def answers(pipe):
        return [dict(r, id=q["id"]) for r, q in zip(pipe.batch(reqs), reqs)]
    _same_responses(answers(two), answers(one), trained["scores"]["padded"])
