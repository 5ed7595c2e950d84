"""CaSE trained, tested and averaged through the port's entry points
(``train/trainer``, ``train/checkpoint``, ``cli/run``, ``pipeline``)
against the JAX package's, in f32 on the CPU.

* ``fit`` over 2 epochs (dropout 0, B=4 with a padded final batch, weights
  from ``_seeded_tree`` bridged into both) against the JAX package's
  ``make_optimizer`` and EMA rule on the JAX gradients of the same
  ``Batcher`` batches: parameters and EMA within TRAIN_ATOL 3e-5 (the
  bound of tests/test_torch_train.py), each dev loss within 1e-5
  relative, ``best.json``'s epoch equal.
* At dropout 0.1: fit 1 epoch, ``resume_or_init``, fit epoch 2 equals an
  unbroken 2-epoch fit bit for bit. A preemption after batch j writes
  ``{e}.preempt.pt`` and leaves ``latest.json``; ``checkpoint_every_steps``
  writes ``{e}.mid.pt``.
* A JAX msgpack checkpoint whose optimiser state comes from
  ``make_optimizer`` after 2 updates (and one in ``MultiSteps``): the port
  restores mu, nu, count (and the accumulated mean) equal to it, and one
  more update equals ``tx.update`` within 1e-6.
* ``cli/run --mode test --device cpu`` on JAX checkpoints writes the JAX
  CLI's ``.answer`` files byte for byte, and its ``.run`` files with every
  field but the score byte for byte (ranking positions of scores within
  1e-5 compared as sets) and each score within 1e-5; also ``--best_only``,
  ``--avg_only``, ``--continuous`` (chunk loop and device loop).
  ``--mode avg`` equals the JAX ``--mode avg`` within 1e-7.
  ``Pipeline.batch`` equals the port's ``cli/serve`` JSONL.
* The port's own train -> resume -> test -> evaluate through the CLIs;
  each refused flag exits naming its ROADMAP item; ``cli/run`` and
  ``Pipeline`` raise without a card unless asked for the CPU.

One module fixture holds every JAX CLI call (one ``--mode avg``, one
``--mode test``; the checkpoints' init weights come from the port through
``tests/test_torch_bridge.jax_tree_from_port``, so no JAX init is traced
there). The ``cuda`` test (skips without a
card) trains one epoch through ``cli/run`` on the card and holds ``--mode
test`` to ``make_predict_fn``; JAX is imported only inside the CPU
fixtures and tests, so README's ``cuda`` command can run this file where
JAX is not installed.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from case_rg_tpu_torch.cli.run import main as run_main
from fixtures import make_dataset
from tests.test_torch_kernels import cuda, one_torch_thread  # noqa: F401

TOY = dict(name="case", vocab_size=64, embedding_size=16, hidden_size=16,
           num_heads=2, enc_layers=1, dec_layers=2, max_dec_len=8)
SHAPES = ["--embedding_size", "16", "--hidden_size", "16", "--num_heads",
          "2", "--max_target_length", "10"]
DATA = ["--query_len", "24", "--passage_len", "24", "--num_passage", "4"]
TIE = 1e-5


@pytest.fixture(autouse=True)
def routing():
    """``cli/run`` sets the process-wide routing switches; put them back."""
    from case_rg_tpu_torch.models import multimem
    from case_rg_tpu_torch.ops import attention, dropout
    yield
    attention.set_fused_train_attention(None)
    attention.set_fused_train_attn_rng(True)
    attention.set_fused_attention(None)
    attention.set_bf16_scores(False)
    multimem.set_fused_stack(None)
    dropout.set_seeded_dropout(False)


def _arrays(n, seed, v=TOY["vocab_size"]):
    """Prepared-style CaSE arrays of the toy shapes, with padding."""
    rng = np.random.RandomState(seed)
    q = rng.randint(4, v, (n, 1, 10)).astype(np.int32)
    p = rng.randint(4, v, (n, 3, 12)).astype(np.int32)
    resp = rng.randint(4, v, (n, 8)).astype(np.int32)
    q[:, :, 7:] = 0
    p[:, :, 9:] = 0
    p[1, 2] = 0
    resp[:, 6:] = 0
    labels = rng.randint(-1, 3, (n, 2)).astype(np.int32)
    labels[:, 0] = np.abs(labels[:, 0])
    return {"id": np.arange(n, dtype=np.int32), "query": q, "passage": p,
            "response": resp, "passage_labels": labels,
            "token_label": (rng.rand(n, 3, 12) > .7).astype(np.float32),
            "token_weight": (1 + rng.rand(n, 3, 12)).astype(np.float32)}


def _toy_trainer(seed=0, **tc):
    from case_rg_tpu_torch.config import ModelConfig, TrainConfig
    from case_rg_tpu_torch.models import create_model
    from case_rg_tpu_torch.train.trainer import Trainer
    model = create_model("case", ModelConfig(**dict(TOY, dropout=0.1)),
                         device="cpu", seed=seed)
    kw = dict(batch_size=4, learning_rate=1e-3, warmup_steps=1)
    kw.update(tc)
    return Trainer(model, TrainConfig(**kw), total_steps=20, device="cpu")


def _same_state(a, b):
    for name in ("params", "ema", "mu", "nu"):
        da, db = getattr(a, name), getattr(b, name)
        assert sorted(da) == sorted(db)
        for k in da:
            assert torch.equal(da[k], db[k]), (name, k)
    assert (a.count, a.mini_step, a.step) == (b.count, b.mini_step, b.step)


def _fast_jit(fn):
    """``jax.jit(fn)`` compiled once, unoptimised, at its first call's
    shapes (every later call has them): these programs run a few times, and
    unoptimised code compiles faster on the CPU."""
    compiled = []

    def call(*args):
        import jax
        if not compiled:
            compiled.append(jax.jit(fn).lower(*args).compile(
                {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}))
        return compiled[0](*args)
    return call


# ---- fit, resume and preemption ----

# ---- a JAX checkpoint's optimiser state ----

def _jax_tree(seed, like):
    import jax
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: (0.1 * rng.randn(*x.shape)).astype(np.float32), like)


class _Small(torch.nn.Module):
    """Parameters named as the bridge names the tree of ``_small_tree``."""

    def __init__(self):
        super().__init__()
        self.dense = torch.nn.Linear(4, 3)
        self.norm = torch.nn.LayerNorm(3)
        self.embed = torch.nn.Module()
        self.embed.weight = torch.nn.Parameter(torch.zeros(5, 4))


def _small_tree(seed):
    rng = np.random.RandomState(seed)
    return {"dense": {"kernel": rng.randn(4, 3).astype(np.float32),
                      "bias": rng.randn(3).astype(np.float32)},
            "norm": {"scale": rng.randn(3).astype(np.float32),
                     "bias": rng.randn(3).astype(np.float32)},
            "embed": {"embedding": rng.randn(5, 4).astype(np.float32)}}


# ---- cli/run --mode test and avg, Pipeline, against the JAX CLI ----

@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The toy corpus prepared; JAX checkpoints of epochs 0 and 1 (init
    weights drawn by the port and laid out as the JAX tree, seeded noise,
    an optimiser state after 2 updates, best epoch 0); the JAX ``--mode
    avg`` of both, also copied to epoch 2; and the JAX ``--mode test`` of
    epochs 0-2 (f32, B=4)."""
    import jax

    from case_rg_tpu.cli.prepare import main as prepare_main
    from case_rg_tpu.cli.run import main as jax_main
    from case_rg_tpu.config import ModelConfig, TrainConfig
    from case_rg_tpu.data.prepare import load_prepared
    from case_rg_tpu.models import build_model_cfg
    from case_rg_tpu.train.checkpoint import save_best, save_checkpoint
    from case_rg_tpu.train.trainer import TrainState, make_optimizer
    from case_rg_tpu_torch.config import ModelConfig as PortConfig
    from case_rg_tpu_torch.models import create_model as port_create
    from tests.test_torch_bridge import jax_tree_from_port

    root = str(tmp_path_factory.mktemp("run"))
    make_dataset(root, "toy", n_queries=12, n_passages=20)
    prepare_main(["--data_path", root, "--dataset", "toy", "--models",
                  "case", "--answer_len", "10"] + DATA)
    prep = os.path.join(root, "toy", "prepared")
    _, _, vocab, _ = load_prepared(prep, "train", "case")
    mcfg = build_model_cfg(ModelConfig(embedding_size=16, hidden_size=16,
                                       num_heads=2, max_target_length=10,
                                       max_dec_len=10), "case", vocab)
    tc = TrainConfig(batch_size=4, learning_rate=1e-3, warmup_steps=1)
    # the init weights drawn by the port (the flax initializers' laws), laid
    # out as the JAX package's tree: no JAX init traced here
    params = jax_tree_from_port(port_create("case", PortConfig(**{
        k: getattr(mcfg, k) for k in PortConfig.__dataclass_fields__}),
        device="cpu"))
    tx = make_optimizer(tc, total_steps=20)
    opt = tx.init(params)
    state = TrainState(params=params, opt_state=opt, ema=params,
                       step=np.int32(0))
    rng = np.random.RandomState(1)

    def noisy(scale):
        def fn(path, x):
            x = np.asarray(x, np.float32)
            name = path[-1].key
            if name in ("bias", "qkv_bias"):
                return x + scale * rng.randn(*x.shape).astype(np.float32)
            if name == "scale":
                return x * (1 + scale * rng.randn(*x.shape).astype(np.float32))
            return x + 0.2 * scale * rng.randn(*x.shape).astype(np.float32)
        return fn

    out = os.path.join(root, "jax")
    for epoch in (0, 1):
        for i in range(2):
            _, opt = tx.update(_jax_tree(50 + 2 * epoch + i, params), opt,
                               params)
        params = jax.tree_util.tree_map_with_path(noisy(0.1), params)
        ema = jax.tree_util.tree_map_with_path(noisy(0.05), params)
        save_checkpoint(out, epoch, jax.device_get(state.replace(
            params=params, ema=ema, opt_state=opt,
            step=np.int32(2 * epoch + 2))))
    save_best(out, 0, 1.0)
    common = ["--model", "case", "--data_path", root, "--dataset", "toy",
              "--output_path", out, "--batch_size", "4"] + SHAPES
    # the JAX CLI sets these process-wide; later JAX tests expect them back
    saved = {k: getattr(jax.config, k) for k in (
        "jax_default_prng_impl", "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs")}
    try:
        jax_main(common + ["--mode", "avg", "--avg_epochs", "0,1"])
        shutil.copy(os.path.join(out, "model", "avg.ckpt"),
                    os.path.join(out, "model", "2.ckpt"))
        jax_main(common + ["--mode", "test", "--epoch", "3"])
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return {"root": root, "prep": prep, "out": out, "common": common}


def _port_out(jax_run, name):
    """A fresh output dir holding a copy of the JAX checkpoints (epochs 0
    and 1, best.json; with "avg", the JAX average too)."""
    out = os.path.join(jax_run["root"], name)
    os.makedirs(os.path.join(out, "model"))
    for f in ("0.ckpt", "1.ckpt", "best.json", "latest.json", "avg.ckpt"):
        shutil.copy(os.path.join(jax_run["out"], "model", f),
                    os.path.join(out, "model", f))
    return out


def _run_lines(text):
    """{query: [(passage, rank, score)]} of a .run file's lines."""
    out = {}
    for ln in text.splitlines():
        q, q0, p, r, s, sysname = ln.split(" ")
        assert (q0, sysname) == ("Q0", "system")
        out.setdefault(q, []).append((p, int(r), float(s)))
    return out


def _same_run(got: str, want: str) -> None:
    """Byte for byte, or: the same queries and ranks, each score within
    TIE, ranking positions of scores within TIE of a neighbour as sets."""
    if got == want:
        return
    g, w = _run_lines(got), _run_lines(want)
    assert list(g) == list(w)
    for q in w:
        assert [r for _, r, _ in g[q]] == [r for _, r, _ in w[q]]
        gs, ws = {p: s for p, _, s in g[q]}, {p: s for p, _, s in w[q]}
        assert sorted(gs) == sorted(ws)
        for p in ws:
            assert abs(gs[p] - ws[p]) <= TIE, (q, p, gs[p], ws[p])
        groups = []
        for p, _, s in w[q]:
            if groups and abs(groups[-1][-1][1] - s) < TIE:
                groups[-1].append((p, s))
            else:
                groups.append([(p, s)])
        pos = 0
        for grp in groups:
            if len(grp) > 1:
                print(f"near-tie in {q}: {[p for p, _ in grp]} within {TIE}")
            assert sorted(p for p, _, _ in g[q][pos:pos + len(grp)]) == \
                sorted(p for p, _ in grp), (q, g[q], w[q])
            pos += len(grp)


def _same_results(got_dir, want_dir, names, exts=("answer", "run")):
    """``names``: {port file stem: JAX file stem} of result files."""
    for got, want in names.items():
        for ext in exts:
            with open(os.path.join(want_dir, "result",
                                   f"{want}.0.{ext}")) as f:
                w = f.read()
            with open(os.path.join(got_dir, "result", f"{got}.0.{ext}")) as f:
                g = f.read()
            if ext == "answer":
                assert g == w, (got, want)
            else:
                _same_run(g, w)


def _stems(epochs, port_epochs=None):
    port_epochs = port_epochs or epochs
    return {f"toy_{s}_{pe}": f"toy_{s}_{e}" for s in ("dev", "test")
            for e, pe in zip(epochs, port_epochs)}


def _port_run(jax_run, out, *extra):
    common = [x if x != jax_run["out"] else out for x in jax_run["common"]]
    run_main(common + ["--device", "cpu"] + list(extra))


@pytest.mark.parametrize("extra", [
    [], ["--continuous", "--refill", "1", "--chunk_steps", "3"],
    ["--continuous", "--device_loop", "2", "--chunk_steps", "2",
     "--lookahead"], ["--rank_only"]],
    ids=["batched", "chunk-loop", "device-loop", "rank-only"])
def test_cli_test_equals_the_jax_package(jax_run, extra):
    """Greedy batched (the JAX CLI's run), the continuous loops and
    rank-only write the JAX CLI's greedy files."""
    out = _port_out(jax_run, "test_" + "_".join(extra))
    _port_run(jax_run, out, "--mode", "test", "--epoch", "2", *extra)
    exts = ("run",) if "--rank_only" in extra else ("answer", "run")
    assert sorted(os.listdir(os.path.join(out, "result"))) == sorted(
        f"toy_{s}_{e}.0.{x}" for s in ("dev", "test") for e in (0, 1)
        for x in exts)
    _same_results(out, jax_run["out"], _stems([0, 1]), exts)


def test_cli_test_sampled_is_seeded(jax_run):
    """--decoding sample: the same --seed writes the same files."""
    outs = []
    for name in ("sample_a", "sample_b"):
        out = _port_out(jax_run, name)
        _port_run(jax_run, out, "--mode", "test", "--epoch", "1",
                  "--decoding", "sample", "--top_k", "5", "--seed", "3")
        outs.append(out)
    _same_results(outs[0], outs[1], {f"toy_{s}_0": f"toy_{s}_0"
                                     for s in ("dev", "test")})


def test_cli_test_ema_eval(jax_run):
    """--ema_eval decodes the EMA: the files of a checkpoint whose
    parameters are epoch 1's EMA."""
    from case_rg_tpu_torch.train.checkpoint import (load_checkpoint,
                                                    save_checkpoint)
    out = _port_out(jax_run, "ema")
    _port_run(jax_run, out, "--mode", "test", "--epoch", "2", "--ema_eval")
    ck = load_checkpoint(jax_run["out"], 1)
    swapped = os.path.join(jax_run["root"], "ema_swapped")
    save_checkpoint(swapped, 1, {"params": ck["ema"], "ema": ck["params"],
                                 "step": ck["step"]})
    _port_run(jax_run, swapped, "--mode", "test", "--epoch", "2")
    _same_results(out, swapped, {f"toy_{s}_1": f"toy_{s}_1"
                                 for s in ("dev", "test")})
    with open(os.path.join(out, "result", "toy_test_1.0.answer")) as f:
        ema = f.read()
    with open(os.path.join(jax_run["out"], "result",
                           "toy_test_1.0.answer")) as f:
        assert f.read() != ema          # the EMA answers differently


def test_cli_best_and_avg(jax_run):
    """--best_only decodes epoch 0 (best.json); --mode avg equals the JAX
    average within 1e-7 and keeps the last epoch's optimiser state;
    --avg_only decodes it as the JAX CLI decoded its own (epoch 2)."""
    from case_rg_tpu_torch.train.checkpoint import load_checkpoint
    out = _port_out(jax_run, "best_avg")
    _port_run(jax_run, out, "--mode", "test", "--best_only")
    assert sorted(os.listdir(os.path.join(out, "result"))) == sorted(
        f"toy_{s}_0.0.{x}" for s in ("dev", "test") for x in ("answer", "run"))
    _same_results(out, jax_run["out"], _stems([0]))

    os.remove(os.path.join(out, "model", "avg.ckpt"))
    _port_run(jax_run, out, "--mode", "avg", "--avg_epochs", "0,1")
    got = load_checkpoint(out, "avg")
    want = load_checkpoint(jax_run["out"], "avg")
    last = load_checkpoint(jax_run["out"], 1)
    for name in ("params", "ema"):
        for k, v in want[name].items():
            np.testing.assert_allclose(got[name][k].numpy(), v.numpy(),
                                       rtol=0, atol=1e-7, err_msg=k)
    assert got["step"] == last["step"] == 4
    assert got["opt_state"]["count"] == last["opt_state"]["count"]
    for k, v in last["opt_state"]["nu"].items():
        assert torch.equal(got["opt_state"]["nu"][k], v), k
    _port_run(jax_run, out, "--mode", "test", "--avg_only")
    _same_results(out, jax_run["out"], _stems([2], ["avg"]))


def test_pipeline_equals_cli_serve(jax_run):
    from case_rg_tpu_torch.cli.serve import main as serve_main
    from case_rg_tpu_torch.pipeline import Pipeline

    rng = np.random.RandomState(4)
    words = ("energy motion kinetic heat whale ocean salary nurse storage "
             "battery power wind water").split()

    def sent(n):
        return " ".join(rng.choice(words, n))

    reqs = [{"query": sent(4) + " ?",
             "passages": [sent(8) + ". " + sent(6) + "." for _ in range(i % 5)],
             **({"history": [sent(3)]} if i % 2 else {}),
             **({"max_tokens": 3} if i % 3 == 1 else {})} for i in range(7)]
    path = os.path.join(jax_run["root"], "pipe_reqs.jsonl")
    with open(path, "w") as f:
        f.write("".join(json.dumps(r) + "\n" for r in reqs))
    served = os.path.join(jax_run["root"], "pipe_served.jsonl")
    serve_main(["--model", "case", "--prepared_dir", jax_run["prep"],
                "--output_path", jax_run["out"], "--input", path,
                "--output", served, "--batch_size", "4", "--device", "cpu"]
               + SHAPES + DATA)
    with open(served) as f:
        want = [{k: v for k, v in json.loads(x).items() if k != "id"}
                for x in f]
    pipe = Pipeline.from_checkpoint(
        "case", output_path=jax_run["out"], prepared_dir=jax_run["prep"],
        batch_size=4, embedding_size=16, hidden_size=16, num_heads=2,
        max_target_length=10, query_len=24, passage_len=24, num_passage=4,
        device="cpu")
    assert pipe.batch(reqs) == want
    assert pipe(**{k: reqs[3][k] for k in ("query", "passages",
                                           "history")}) == want[3]
    assert pipe.provenance["epoch"] == "1" and pipe.model == "case"
    with pytest.raises(FileNotFoundError, match="no sidecar artifact.json"):
        Pipeline.from_export("artifact", prepared_dir=jax_run["prep"],
                             device="cpu")


# ---- the port end to end, refusals, no card ----

def test_port_train_resume_test_evaluate(jax_run, tmp_path):
    """cli/run trains the toy corpus 1 epoch, resumes for a second (with
    --checkpoint_every_steps and --profile_dir), tests every epoch and
    cli/evaluate reports on the result files."""
    from case_rg_tpu_torch.cli.evaluate import main as eval_main
    out = str(tmp_path / "own")
    common = [x if x != jax_run["out"] else out for x in jax_run["common"]]
    common += ["--device", "cpu", "--learning_rate", "1e-3",
               "--warmup_steps", "2"]
    run_main(common + ["--mode", "train", "--epoch", "1"])
    run_main(common + ["--mode", "train", "--epoch", "2",
                       "--checkpoint_every_steps", "1",
                       "--profile_dir", str(tmp_path / "trace")])
    model_dir = os.path.join(out, "model")
    assert {"0.pt", "1.pt", "1.mid.pt", "best.json"} <= \
        set(os.listdir(model_dir))
    assert not os.path.exists(os.path.join(model_dir, "0.mid.pt"))
    traces = os.listdir(tmp_path / "trace")
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
    with open(tmp_path / "trace" / traces[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"train_epoch 1", "checkpoint 1", "dev_eval 1"} <= names
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rows = [json.loads(x) for x in f]
    assert [r["step"] for r in rows if "dev_total" in r] == [2, 4]
    run_main(common + ["--mode", "test", "--epoch", "2"])
    report = eval_main(["--model", "case", "--data_path", jax_run["root"],
                        "--datasets", "toy", "--output_path", out])
    assert sorted(report["toy"]) == ["toy_dev_0", "toy_dev_1", "toy_test_0",
                                     "toy_test_1"]
    for metrics in report["toy"].values():
        assert all(np.isfinite(v) for k, v in metrics.items()
                   if k != "METEOR_variant"), metrics


def ck_cfg(ck, name):
    """The toy model config of a checkpoint's vocabulary size."""
    from case_rg_tpu_torch.config import ModelConfig
    v = ck["params"]["enc_embedding.weight"].shape[0]
    return ModelConfig(name=name, vocab_size=v, embedding_size=16,
                       hidden_size=16, num_heads=2, max_target_length=10,
                       max_dec_len=10)


# ---- on the card ----
