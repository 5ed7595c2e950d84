"""CaSE trained through the port's ``fit``, resumed and preempted, and a JAX
checkpoint's optimiser state, against the JAX package's ``make_optimizer``
(moved from ``tests/test_torch_run.py``, whose docstring describes them;
its helpers are shared)."""

import json
import os
import signal
import threading

import numpy as np
import pytest
import torch

from tests.test_torch_kernels import one_torch_thread  # noqa: F401
from tests.test_torch_run import (  # noqa: F401
    TOY, _Small, _arrays, _fast_jit, _jax_tree, _same_state, _small_tree,
    _toy_trainer, routing)


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
