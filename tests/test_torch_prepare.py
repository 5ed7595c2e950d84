"""The port's offline data path and evaluation against the JAX package's,
on the CPU (numpy only on both sides; nothing is compared by tolerance):

* ``cli/prepare`` on the toy corpus of tests/fixtures.py (query 24,
  passage 24, 4 passages, answer 10, every model): each npz array (dtype,
  shape, values), ``vocab.txt``, ``freq.json`` and the three meta files
  equal the JAX ``cli/prepare``'s, serially in process and with
  ``--workers 2`` in a subprocess where ``import torch`` raises (the CLI
  and its spawned workers import no torch);
* the ``Batcher``: every batch of three epochs equal, shuffled or not, with
  a padded final batch, and per-process shards;
* the metrics (BLEU, ROUGE, METEOR, overlap, TREC) and ``cli/evaluate``'s
  report equal on the same result files.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from fixtures import make_dataset
from tests.test_torch_kernels import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ["--query_len", "24", "--passage_len", "24", "--num_passage", "4",
          "--answer_len", "10"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The toy corpus prepared by the JAX CLI and by the port's, twice."""
    from case_rg_tpu.cli.prepare import main as jax_prepare
    from case_rg_tpu_torch.cli.prepare import main as port_prepare

    root = str(tmp_path_factory.mktemp("prepare"))
    make_dataset(root, "toy", n_queries=12, n_passages=20)
    common = ["--data_path", root, "--dataset", "toy"] + SHAPES
    dirs = {k: os.path.join(root, k) for k in ("jax", "port", "workers")}
    jax_prepare(common + ["--out_dir", dirs["jax"]])
    port_prepare(common + ["--out_dir", dirs["port"]])

    # a torch that cannot be imported, ahead of the real one on the path
    fake = os.path.join(root, "no_torch")
    os.makedirs(os.path.join(fake, "torch"))
    with open(os.path.join(fake, "torch", "__init__.py"), "w") as f:
        f.write("raise ImportError('torch imported by the prepare path')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([fake, ROOT]))
    proc = subprocess.run(
        [sys.executable, "-m", "case_rg_tpu_torch.cli.prepare"] + common
        + ["--out_dir", dirs["workers"], "--workers", "2"],
        env=env, cwd=root, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return root, dirs


@pytest.mark.parametrize("which", ["port", "workers"])
def test_prepare_equals_the_jax_package(corpus, which):
    _, dirs = corpus
    want, got = dirs["jax"], dirs[which]
    names = sorted(os.listdir(want))
    assert sorted(os.listdir(got)) == names
    npz = [n for n in names if n.endswith(".npz")]
    assert len(npz) == 18                       # 3 splits x 6 models
    for name in names:
        if name.endswith(".npz"):
            a, b = np.load(os.path.join(want, name)), \
                np.load(os.path.join(got, name))
            assert sorted(a.files) == sorted(b.files), name
            for k in a.files:
                assert a[k].dtype == b[k].dtype, (name, k)
                np.testing.assert_array_equal(b[k], a[k], err_msg=name + k)
        else:
            with open(os.path.join(want, name), "rb") as f:
                a = f.read()
            with open(os.path.join(got, name), "rb") as f:
                assert f.read() == a, name


def _arrays(n=11, seed=0):
    rng = np.random.RandomState(seed)
    labels = rng.randint(-1, 4, (n, 3)).astype(np.int32)
    labels[:, 0] = np.abs(labels[:, 0])
    return {"id": np.arange(n, dtype=np.int32),
            "query": rng.randint(0, 50, (n, 1, 6)).astype(np.int32),
            "token_label": rng.rand(n, 4, 5).astype(np.float32),
            "passage_labels": labels}


@pytest.mark.parametrize("shuffle, procs", [(True, 1), (False, 1),
                                            (True, 2)],
                         ids=["shuffled", "in-order", "two-processes"])
def test_batcher_equals_the_jax_package(shuffle, procs):
    from case_rg_tpu.data.batching import Batcher as JBatcher
    from case_rg_tpu_torch.data.batching import Batcher

    arrays = _arrays()
    for rank in range(procs):
        kw = dict(shuffle=shuffle, seed=5, process_index=rank,
                  process_count=procs)
        port, ref = Batcher(arrays, 4, **kw), JBatcher(arrays, 4, **kw)
        for epoch in range(3):
            assert port.num_batches(epoch) == ref.num_batches(epoch)
            got, want = list(port.epoch(epoch)), list(ref.epoch(epoch))
            assert len(got) == len(want) == ref.num_batches(epoch)
            assert want[-1]["sample_weight"].min() == 0 or procs > 1
            for g, w in zip(got, want):
                assert sorted(g) == sorted(w)
                for k in w:
                    assert g[k].dtype == w[k].dtype, k
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _result_files(root, dirs):
    """Synthetic .answer/.run shards for the toy dev and test queries:
    answers cut and reordered from the gold ones, runs scoring each pool
    from a seed; two epochs, the test split in two shards."""
    rng = np.random.RandomState(3)
    base = os.path.join(root, "toy")
    with open(os.path.join(base, "toy.answer")) as f:
        gold = [ln.rstrip("\n").split("\t") for ln in list(f)[1:]]
    meta = {s: json.load(open(os.path.join(dirs["jax"], f"{s}.meta.json")))
            for s in ("dev", "test")}
    out = os.path.join(root, "results")
    os.makedirs(os.path.join(out, "result"))
    for split, rows in meta.items():
        for epoch in (0, 1):
            shards = {0: ([], [])} if split == "dev" else {0: ([], []),
                                                           1: ([], [])}
            for i, m in enumerate(rows):
                answers, runs = shards[i % len(shards)]
                words = [g[3] for g in gold if g[1] == m["query_id"]][0]
                words = words.split()
                cut = words[rng.randint(0, 3):][:rng.randint(2, 12)]
                if rng.rand() < .5:
                    cut = cut[::-1]
                answers.append("\t".join([";".join(m["context_id"]),
                                          m["query_id"],
                                          ";".join(m["passage_id"]),
                                          " ".join(cut) or "[UNK]"]))
                scores = rng.randn(len(m["passage_pool_id"]))
                for r, j in enumerate(np.argsort(-scores)):
                    runs.append(f"{m['query_id']} Q0 "
                                f"{m['passage_pool_id'][j]} {r + 1} "
                                f"{scores[j]} system")
            for rank, (answers, runs) in shards.items():
                stem = os.path.join(out, "result",
                                    f"toy_{split}_{epoch}.{rank}")
                with open(stem + ".answer", "w") as f:
                    f.write("\n".join(answers) + "\n")
                with open(stem + ".run", "w") as f:
                    f.write("\n".join(runs) + "\n")
    return out


def test_evaluate_report_equals_the_jax_package(corpus, tmp_path):
    from case_rg_tpu.cli.evaluate import main as jax_evaluate
    from case_rg_tpu_torch.cli.evaluate import main as port_evaluate

    root, dirs = corpus
    out = _result_files(root, dirs)
    args = ["--model", "case", "--data_path", root, "--datasets", "toy",
            "--output_path", out]
    want = jax_evaluate(args + ["--report", str(tmp_path / "jax.json")])
    got = port_evaluate(args + ["--report", str(tmp_path / "port.json")])
    assert got == want
    prefixes = want["toy"]
    assert sorted(prefixes) == ["toy_dev_0", "toy_dev_1", "toy_test_0",
                                "toy_test_1"]
    for metrics in prefixes.values():
        assert {"map", "ndcg", "recall_10", "ROUGE_1_F1", "ROUGE_2_F1",
                "ROUGE_L_F1", "BLEU",
                "METEOR"} <= set(metrics), metrics
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()


def test_metrics_equal_the_jax_package():
    import case_rg_tpu.evaluation as J
    import case_rg_tpu_torch.evaluation as P

    rng = np.random.RandomState(1)
    words = ("the cat sat on a mat dog ran fast slow energy motion kinetic "
             "heat ocean whale big small").split()

    def sent():
        return list(rng.choice(words, rng.randint(1, 12)))

    hyps = [sent() for _ in range(20)]
    refs = [[sent() for _ in range(rng.randint(1, 3))] for _ in range(20)]
    assert P.eval_bleu(hyps, refs) == J.eval_bleu(hyps, refs)
    assert P.eval_meteor(hyps, refs) == J.eval_meteor(hyps, refs)
    assert P.eval_rouge([" ".join(h) for h in hyps],
                        [[" ".join(r) for r in rs] for rs in refs]) == \
        J.eval_rouge([" ".join(h) for h in hyps],
                     [[" ".join(r) for r in rs] for rs in refs])
    assert P.eval_overlap(hyps, [sum(rs, []) for rs in refs]) == \
        J.eval_overlap(hyps, [sum(rs, []) for rs in refs])
    for h, rs in zip(hyps, refs):
        assert P.sentence_bleu(rs, h) == J.sentence_bleu(rs, h)
        assert P.meteor_score(rs, h) == J.meteor_score(rs, h)
        assert P.rouge_scores(" ".join(h), " ".join(rs[0])) == \
            J.rouge_scores(" ".join(h), " ".join(rs[0]))
    run = {f"q{i}": {f"p{j}": float(rng.randn()) for j in range(8)}
           for i in range(6)}
    qrel = {f"q{i}": {f"p{j}": int(rng.randint(0, 3)) for j in range(0, 8, 3)}
            for i in range(6)}
    assert P.eval_trec(run, qrel) == J.eval_trec(run, qrel)
