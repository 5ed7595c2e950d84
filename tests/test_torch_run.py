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
import signal
import threading

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

def test_fit_tracks_the_jax_optimizer(tmp_path):
    """Two epochs of fit against make_optimizer + EMA on the JAX gradients
    of the same batches; dev loss after each epoch and best.json."""
    import jax
    import jax.numpy as jnp

    from case_rg_tpu.config import ModelConfig as JConfig
    from case_rg_tpu.config import TrainConfig as JTrainConfig
    from case_rg_tpu.data.batching import Batcher as JBatcher
    from case_rg_tpu.models import create_model as jcreate
    from case_rg_tpu.train.trainer import make_optimizer
    from case_rg_tpu_torch.bridge import state_dict_from_jax
    from case_rg_tpu_torch.config import TrainConfig
    from case_rg_tpu_torch.train.trainer import Trainer
    from tests.test_torch_train import (TRAIN_ATOL, _k_bias_free, _port,
                                        _seeded_tree)

    fields = dict(TOY, dropout=0.0)
    train, dev = _arrays(10, 1), _arrays(5, 2)
    kw = dict(batch_size=4, learning_rate=1e-3, warmup_steps=1,
              ema_decay=0.9)
    tree = _seeded_tree(5)
    model = jcreate("case", JConfig(**fields))

    def loss_fn(params, batch):
        losses = model.apply({"params": params}, batch, deterministic=False,
                             rngs={"dropout": jax.random.PRNGKey(3)},
                             method=type(model).train_losses)
        return sum(losses.values()), losses

    vg = _fast_jit(jax.value_and_grad(loss_fn, has_aux=True))
    tx = make_optimizer(JTrainConfig(**kw), total_steps=20)

    @_fast_jit
    def apply(grads, opt_state, params, ema):
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        ema = jax.tree_util.tree_map(lambda e, p: 0.1 * p + 0.9 * e, ema,
                                     params)
        return opt_state, params, ema

    def jbatch(b):
        return {k: jnp.asarray(v) for k, v in b.items()
                if not k.startswith("_")}

    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt_state, ema = tx.init(params), params
    dev_totals = []
    for epoch in range(2):
        for b in JBatcher(train, 4, shuffle=True, seed=7).epoch(epoch):
            _, grads = vg(params, jbatch(b))
            opt_state, params, ema = apply(grads, opt_state, params, ema)
        sums, weight = {}, 0.0
        for b in JBatcher(dev, 4, shuffle=False).epoch(0):
            (_, losses), _ = vg(params, jbatch(b))
            w = float(b["sample_weight"].sum())
            for k, v in losses.items():
                sums[k] = sums.get(k, 0.0) + float(v) * w
            weight += w
        out = {k: v / weight for k, v in sums.items()}
        out["total"] = sum(out.values())
        dev_totals.append(out)
    ref_p = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    ref_e = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, ema))

    trainer = Trainer(_port(tree, fields), TrainConfig(**kw), total_steps=20,
                      device="cpu")
    state = trainer.fit(trainer.init_state(), train, 2, str(tmp_path),
                        seed=7, eval_arrays=dev)
    assert state.step == 6 and state.count == 6
    for name, p in state.params.items():
        for got, ref in ((p.detach().numpy(), ref_p[name]),
                         (state.ema[name].numpy(), ref_e[name])):
            np.testing.assert_allclose(_k_bias_free(name, got),
                                       _k_bias_free(name, ref), rtol=0,
                                       atol=TRAIN_ATOL, err_msg=name)
            np.testing.assert_allclose(got, ref, rtol=0, atol=3e-3,
                                       err_msg=name)
    with open(tmp_path / "metrics.jsonl") as f:
        rows = [json.loads(x) for x in f]
    got_dev = [r for r in rows if "dev_total" in r]
    assert len(got_dev) == 2
    for got, want in zip(got_dev, dev_totals):
        for k, v in want.items():
            assert abs(got[f"dev_{k}"] - v) <= 1e-5 * abs(v), (k, got, want)
    with open(tmp_path / "model" / "best.json") as f:
        best = json.load(f)
    assert best["epoch"] == int(np.argmin([d["total"] for d in dev_totals]))
    assert sorted(os.listdir(tmp_path / "model")) == \
        ["0.pt", "1.pt", "best.json", "latest.json"]


def test_resume_equals_an_unbroken_run(tmp_path):
    """Dropout 0.1: fit epoch 0, then resume_or_init in a new trainer and
    fit epoch 1: the state and the epoch-1 checkpoint equal an unbroken
    2-epoch fit's bit for bit."""
    from case_rg_tpu_torch.train.checkpoint import load_checkpoint
    train, dev = _arrays(10, 3), _arrays(5, 4)
    whole, parts = str(tmp_path / "whole"), str(tmp_path / "parts")
    a = _toy_trainer()
    sa = a.fit(a.init_state(), train, 2, whole, seed=11, eval_arrays=dev)
    b = _toy_trainer()
    b.fit(b.init_state(), train, 1, parts, seed=11, eval_arrays=dev)
    c = _toy_trainer(seed=99)                 # other initial weights
    sc, start = c.resume_or_init(parts)
    assert start == 1 and sc.step == 3
    sc = c.fit(sc, train, 2, parts, seed=11, start_epoch=start,
               eval_arrays=dev)
    _same_state(sc, sa)
    ka, kc = load_checkpoint(whole, 1), load_checkpoint(parts, 1)
    for name in ("params", "ema"):
        for k in ka[name]:
            assert torch.equal(ka[name][k], kc[name][k]), (name, k)
    for name in ("mu", "nu"):
        for k in ka["opt_state"][name]:
            assert torch.equal(ka["opt_state"][name][k],
                               kc["opt_state"][name][k]), (name, k)
    with open(os.path.join(whole, "model", "best.json")) as f:
        wb = json.load(f)
    with open(os.path.join(parts, "model", "best.json")) as f:
        assert json.load(f) == wb
    c2 = _toy_trainer(resume=False)
    assert c2.resume_or_init(parts)[1] == 0


def test_resume_with_accumulation(tmp_path):
    """k = 2 over 3 batches an epoch: epoch 0 ends mid-accumulation; the
    running mean rides in the checkpoint and the resumed run equals the
    unbroken one bit for bit."""
    train = _arrays(12, 5)
    a = _toy_trainer(accumulation_steps=2)
    sa = a.fit(a.init_state(), train, 2, str(tmp_path / "a"), seed=3)
    b = _toy_trainer(accumulation_steps=2)
    b.fit(b.init_state(), train, 1, str(tmp_path / "b"), seed=3)
    c = _toy_trainer(accumulation_steps=2)
    sc, start = c.resume_or_init(str(tmp_path / "b"))
    assert (start, sc.mini_step, sc.step) == (1, 1, 1)
    assert any(bool(v.any()) for v in sc.acc.values())
    with pytest.raises(ValueError, match="accumulation"):
        _toy_trainer().resume_or_init(str(tmp_path / "b"))
    sc = c.fit(sc, train, 2, str(tmp_path / "b"), seed=3, start_epoch=1)
    _same_state(sc, sa)
    for k in sa.acc:
        assert torch.equal(sa.acc[k], sc.acc[k]), k


def test_preemption_and_mid_epoch_checkpoints(tmp_path, monkeypatch):
    """A guard set after batch 2 of epoch 1: ``1.preempt.pt`` holds the
    state after those 2 steps, ``latest.json`` stays at epoch 0, and
    ``fit`` returns. ``checkpoint_every_steps=1`` wrote ``0.mid.pt``. The
    signal handler that ``fit`` installs sets the guard; the previous
    handlers are back afterwards."""
    from case_rg_tpu_torch.train import trainer as trainer_mod
    from case_rg_tpu_torch.train.checkpoint import (latest_epoch,
                                                    load_checkpoint)
    assert threading.current_thread() is threading.main_thread()
    out = str(tmp_path)
    train = _arrays(16, 6)
    t = _toy_trainer(checkpoint_every_steps=1)
    step = t.train_step
    calls = []

    def stepping(state, batch, gen):
        losses = step(state, batch, gen)
        calls.append(state.step)
        if len(calls) == 6:            # epoch 1, after its batch 1
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
        return losses

    monkeypatch.setattr(t, "train_step", stepping)
    before = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    state = t.fit(t.init_state(), train, 3, out, seed=1)
    assert {s: signal.getsignal(s) for s in before} == before
    assert calls == [1, 2, 3, 4, 5, 6]
    assert latest_epoch(out) == 0
    names = sorted(os.listdir(os.path.join(out, "model")))
    assert names == ["0.mid.pt", "0.pt", "1.mid.pt", "1.preempt.pt",
                     "latest.json"], names
    ck = load_checkpoint(out, "1.preempt")
    assert ck["step"] == 6 == state.step
    for k, v in state.params.items():
        assert torch.equal(ck["params"][k], v.detach()), k
    assert load_checkpoint(out, "0.mid")["step"] == 4   # batch 3 of 0-3

    guard = trainer_mod.PreemptionGuard()
    guard.requested = True
    with pytest.raises(KeyboardInterrupt):
        t.train_epoch(state, trainer_mod.Batcher(train, 4), 2,
                      torch.Generator(), output_path=out, guard=guard)
    assert load_checkpoint(out, "2.preempt")["step"] == 6


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


@pytest.mark.parametrize("accum", [1, 2], ids=["adam", "multisteps"])
def test_jax_optimizer_state_carries_over(tmp_path, accum):
    """make_optimizer after 2 updates (MultiSteps: 1 update and a
    mini-step), saved by the JAX package; the port restores it field by
    field and one more update (MultiSteps: the one that applies) equals
    ``tx.update`` within 1e-6; so does the EMA."""
    import jax

    from case_rg_tpu.config import TrainConfig as JTrainConfig
    from case_rg_tpu.train.checkpoint import save_checkpoint
    from case_rg_tpu.train.trainer import TrainState, make_optimizer
    from case_rg_tpu_torch.bridge import load_jax_params, state_dict_from_jax
    from case_rg_tpu_torch.config import TrainConfig
    from case_rg_tpu_torch.train.checkpoint import load_checkpoint
    from case_rg_tpu_torch.train.trainer import Trainer

    kw = dict(batch_size=4, learning_rate=1e-3, warmup_steps=1,
              accumulation_steps=accum)
    tx = make_optimizer(JTrainConfig(**kw), total_steps=20)
    params = _small_tree(6)
    opt = tx.init(params)
    calls = 2 if accum == 1 else 3     # 2 updates; 1 update + a mini-step
    for i in range(calls):
        _, opt = tx.update(_jax_tree(10 + i, params), opt, params)
    ema = _jax_tree(30, params)
    save_checkpoint(str(tmp_path), 0, jax.device_get(TrainState(
        params=params, opt_state=opt, ema=ema, step=np.int32(2))))

    ck = load_checkpoint(str(tmp_path), 0)
    got = ck["opt_state"]
    inner = opt.inner_opt_state if accum > 1 else opt
    adam = inner[1][0]
    assert got["count"] == int(adam.count) == (2 if accum == 1 else 1)
    assert got["mini_step"] == (1 if accum > 1 else 0)
    for name in ("mu", "nu"):
        want = state_dict_from_jax(jax.tree_util.tree_map(
            np.asarray, getattr(adam, name)))
        for k, v in want.items():
            assert np.array_equal(got[name][k].numpy(), v), (name, k)
    if accum > 1:
        want = state_dict_from_jax(jax.tree_util.tree_map(
            np.asarray, opt.acc_grads))
        for k, v in want.items():
            assert np.array_equal(got["acc"][k].numpy(), v), k
    else:
        assert "acc" not in got

    grads = _jax_tree(40, params)
    updates, _ = tx.update(grads, opt, params)
    new = jax.tree_util.tree_map(lambda p, u: np.asarray(p + u), params,
                                 updates)
    want = state_dict_from_jax(new)
    want_ema = state_dict_from_jax(jax.tree_util.tree_map(
        lambda e, p: 0.005 * p + 0.995 * e, ema, new))
    model = _Small()
    load_jax_params(model, _small_tree(99))
    trainer = Trainer(model, TrainConfig(**kw), total_steps=20, device="cpu")
    state = trainer.restore(trainer.init_state(), ck)
    assert state.step == 2
    trainer.apply_gradients(state, {k: torch.from_numpy(v) for k, v in
                                    state_dict_from_jax(grads).items()})
    assert (state.mini_step, state.count, state.step) == \
        (0, 3 if accum == 1 else 2, 3)
    for k, v in want.items():
        np.testing.assert_allclose(state.params[k].detach().numpy(), v,
                                   rtol=0, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(state.ema[k].numpy(), want_ema[k],
                                   rtol=0, atol=1e-6, err_msg=k)


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

def test_one_hot_labels_out_of_range_match_jax():
    """A gold passage past the scored pool (data prepared with the default
    10-passage pool, trained with --num_passage 4, as the toy corpus is)
    gives a row of zeros, as ``jax.nn.one_hot`` does."""
    import jax.numpy as jnp

    from case_rg_tpu.models.base import one_hot_labels as jax_one_hot
    from case_rg_tpu_torch.models.base import one_hot_labels
    idx = np.array([-1, 0, 3, 4, 9], np.int32)
    np.testing.assert_array_equal(
        one_hot_labels(torch.from_numpy(idx), 4).numpy(),
        np.asarray(jax_one_hot(jnp.asarray(idx), 4)))



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


def ck_cfg(ck, name):
    """The toy model config of a checkpoint's vocabulary size."""
    from case_rg_tpu_torch.config import ModelConfig
    v = ck["params"]["enc_embedding.weight"].shape[0]
    return ModelConfig(name=name, vocab_size=v, embedding_size=16,
                       hidden_size=16, num_heads=2, max_target_length=10,
                       max_dec_len=10)


@pytest.mark.parametrize("extra, message", [
    (["--model", "glks", "--mode", "ps_train"], "only defined for masque"),
    (["--multihost"], "start every rank with torchrun"),
    (["--mesh_shape", "2,1"], "not the world size 1"),
    (["--pool_shard"], "item 7b"), (["--mesh_shape", "1,2"], "item 7b"),
    (["--ckpt_backend", "orbax"], "item 2"), (["--remat", "dots"], None),
    (["--seeded_dropout"], None), (["--bf16_scores", "--bf16_train"], None),
    (["--mesh_shape", "1"], None)],
    ids=["ps_train_glks", "multihost", "mesh_shape", "pool_shard",
         "model_axis", "orbax", "remat", "seeded_dropout", "bf16_scores",
         "mesh_shape_one"])
def test_refused_flags(jax_run, tmp_path, extra, message):
    """The flags still refused exit naming their ROADMAP item: the pool
    axis and a model axis (item 7b), orbax (item 2). ``--multihost``
    outside torchrun's environment exits naming torchrun (never a quiet
    world of one), and a ``--mesh_shape`` data axis must be the world size
    (``tests/test_torch_distributed.py`` runs the group itself). The
    training options (``--remat``, ``--seeded_dropout``, ``--bf16_scores``)
    and ``--mesh_shape 1`` (a world of one) train an epoch of the toy
    corpus: the checkpoint is written, its losses are finite and the
    switch is set."""
    from case_rg_tpu_torch.ops import attention, dropout
    from case_rg_tpu_torch.train.checkpoint import load_checkpoint
    argv = ["--model", "case", "--mode", "train", "--output_path",
            str(tmp_path)]
    for flag in ("--model", "--mode"):
        if flag in extra:
            i = argv.index(flag)
            del argv[i:i + 2]
    if message is not None:
        with pytest.raises(SystemExit, match=message):
            run_main(argv + extra)
        return
    run_main(argv + extra + ["--data_path", jax_run["root"], "--dataset",
                             "toy", "--device", "cpu", "--epoch", "1",
                             "--batch_size", "4", "--warmup_steps", "1"]
             + SHAPES)
    ck = load_checkpoint(str(tmp_path), 0)
    assert ck["step"] > 0
    with open(os.path.join(tmp_path, "metrics.jsonl")) as f:
        rows = [json.loads(x) for x in f]
    assert rows and all(np.isfinite(v) for r in rows for k, v in r.items()
                        if k.startswith("dev_"))
    assert dropout.seeded_dropout_enabled() == ("--seeded_dropout" in extra)
    assert attention._BF16_SCORES == ("--bf16_scores" in extra)


def test_entry_points_need_a_card_unless_asked(jax_run, monkeypatch):
    from case_rg_tpu_torch.pipeline import Pipeline
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = _port_out(jax_run, "nocard")
    for mode in ("train", "test"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_main([x if x != jax_run["out"] else out
                      for x in jax_run["common"]] + ["--mode", mode])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Pipeline.from_checkpoint("case", output_path=jax_run["out"],
                                 prepared_dir=jax_run["prep"])


# ---- on the card ----

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
