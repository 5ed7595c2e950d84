"""The training slice: CaSE ``train_losses`` and the train step in the port
against the JAX package, in f32 on the CPU, with weights from a numpy seed
bridged into both.

* ``train_losses`` with dropout 0 in training mode (every dropout site
  live, every mask all-keep): the three losses within 1e-5 relative and
  every parameter's gradient within atol 1e-5 / rtol 1e-4 (the JAX package's
  own end-to-end bound, tests/test_kernels.py), with the training-attention
  gate off and forced through the plain versions of both kernels.
* With dropout 0.1 and one generator, the gated path (caller mask drawn
  with the dense path's draw) gives the dense path's losses and gradients.
* The trainer against ``case_rg_tpu.train.trainer.Trainer``: parameters and
  EMA after 3 steps at lr 1e-3, warmup 1, within 3e-5 (the largest
  difference read was 1.02e-5); accumulation over two half-batches against
  one full batch; the schedule against the transformers formula.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from case_rg_tpu.config import ModelConfig as JConfig
from case_rg_tpu.config import TrainConfig as JTrainConfig
from case_rg_tpu.models import create_model as jcreate
from case_rg_tpu_torch.bridge import load_jax_params, state_dict_from_jax
from case_rg_tpu_torch.config import ModelConfig, TrainConfig
from case_rg_tpu_torch.models import create_model
from case_rg_tpu_torch.ops import attention
from case_rg_tpu_torch.train.schedule import cosine_hard_restarts_with_warmup
from case_rg_tpu_torch.train.trainer import Trainer
from tests.test_torch_bridge import TOY, jax_case_params
from tests.test_torch_kernels import one_torch_thread  # noqa: F401

torch.set_float32_matmul_precision("highest")
CFG = dict(TOY, dropout=0.0)
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
# 3 % of a step at lr 1e-3. Adam divides each gradient by its own RMS, so
# an element whose gradient is tiny turns the two frameworks' rounding into
# a visible part of a step; the largest difference read was 1.02e-5.
TRAIN_ATOL = 3e-5


def _seeded_tree(seed=0):
    """A CaSE param tree of the JAX package's shapes, filled from a numpy
    seed: weights ~ N(0, 0.3), biases ~ N(0, 0.1), LayerNorm gains
    1 + N(0, 0.1)."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name in ("bias", "qkv_bias"):
            return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.randn(*leaf.shape)).astype(np.float32)
        return (0.3 * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(
        fill, jax_case_params(abstract=True))


def _batch(seed, b=4, padded=True):
    rng = np.random.RandomState(seed)
    v = TOY["vocab_size"]
    q = rng.randint(4, v, (b, 1, 10)).astype(np.int32)
    p = rng.randint(4, v, (b, 3, 12)).astype(np.int32)
    resp = rng.randint(4, v, (b, 8)).astype(np.int32)
    if padded:
        q[:, :, 7:] = 0
        p[:, :, 9:] = 0
        p[1, 2] = 0                         # a passage that is all padding
        resp[:, 6:] = 0
        resp[0, 3:] = 0
    return {"query": q, "passage": p, "response": resp,
            "passage_label": rng.randint(0, 3, b).astype(np.int32),
            "token_label": (rng.rand(b, 3, 12) > .7).astype(np.float32),
            "token_weight": (1 + rng.rand(b, 3, 12)).astype(np.float32)}


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype != np.float32
            else torch.from_numpy(v) for k, v in batch.items()}


def _port(tree, fields=CFG):
    model = create_model("case", ModelConfig(**fields), device="cpu")
    load_jax_params(model, tree)
    return model


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX side: (jitted ``value_and_grad`` of the summed CaSE train
    losses, dropout 0 in training mode, as ``Trainer.step_fn`` takes it;
    the weights; one batch; that batch's losses and gradients)."""
    tree = _seeded_tree()
    batch = _batch(1)
    model = jcreate("case", JConfig(**CFG))

    def loss_fn(params, batch):
        losses = model.apply({"params": params}, batch, deterministic=False,
                             rngs={"dropout": jax.random.PRNGKey(3)},
                             method=type(model).train_losses)
        return sum(losses.values()), losses

    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (_, losses), grads = vg(tree, {k: jnp.asarray(v) for k, v in batch.items()})
    return vg, tree, batch, {k: float(v) for k, v in losses.items()}, \
        state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads))


def _k_bias_free(name, arr, e=TOY["hidden_size"]):
    """The in-projection bias without its k third. Softmax is invariant to
    a shift of a row's scores, so the true gradient of the k bias is 0 and
    what the two frameworks compute is rounding noise, which Adam's
    normalisation turns into steps of up to lr: that third is held to a
    bound of a few lr instead."""
    if name.endswith("in_proj_bias"):
        width = arr.shape[0] // 3
        return np.concatenate([arr[:width], arr[2 * width:]])
    return arr


@pytest.mark.parametrize("gate", ["off", "forced-mask", "forced-rng"])
def test_train_losses_and_grads_match_jax(jax_ref, gate):
    _, tree, batch, ref_losses, ref_grads = jax_ref
    port = _port(tree)
    try:
        attention.set_fused_train_attention(gate != "off")
        attention.set_fused_train_attn_rng(gate == "forced-rng")
        losses = port.train_losses(_torch_batch(batch),
                                   torch.Generator().manual_seed(0))
        sum(losses.values()).backward()
    finally:
        attention.set_fused_train_attention(None)
        attention.set_fused_train_attn_rng(True)
    assert set(losses) == set(ref_losses)
    for k, v in losses.items():
        assert abs(v.item() - ref_losses[k]) <= LOSS_RTOL * abs(ref_losses[k]), k
    params = dict(port.named_parameters())
    assert set(params) == set(ref_grads)
    for name, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name],
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_gated_path_matches_dense_path_with_dropout():
    """Dropout 0.1, one generator seed: the fused training attention (its
    plain versions here, caller mask drawn with the dense draw) gives the
    dense path's losses and gradients."""
    fields = dict(TOY, dropout=0.1)
    tree = _seeded_tree(1)
    batch = _torch_batch(_batch(2))
    runs = []
    try:
        attention.set_fused_train_attn_rng(False)
        for gate in (False, True):
            attention.set_fused_train_attention(gate)
            port = _port(tree, fields)
            losses = port.train_losses(batch, torch.Generator().manual_seed(5))
            sum(losses.values()).backward()
            runs.append(({k: v.item() for k, v in losses.items()},
                         {n: p.grad for n, p in port.named_parameters()}))
    finally:
        attention.set_fused_train_attention(None)
        attention.set_fused_train_attn_rng(True)
    (dl, dg), (fl, fg) = runs
    for k in dl:
        assert abs(dl[k] - fl[k]) < 1e-5, (k, dl[k], fl[k])
    for name in dg:
        np.testing.assert_allclose(fg[name].numpy(), dg[name].numpy(),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_trainer_matches_jax_trainer(jax_ref):
    """Three steps (lr 1e-3, warmup 1: the first at lr 0) from the same
    weights on three batches, against the JAX package's step: its
    ``make_optimizer`` (clip, Adam, schedule) on the gradients of the loss
    ``Trainer.step_fn`` differentiates, then its EMA rule. Parameters and
    EMA agree within TRAIN_ATOL (k third of the in-projection biases: 3 lr,
    see _k_bias_free)."""
    from case_rg_tpu.train.trainer import make_optimizer
    vg, _, _, _, _ = jax_ref
    tree = _seeded_tree(2)
    batches = [_batch(10 + i) for i in range(3)]
    kw = dict(batch_size=4, learning_rate=1e-3, warmup_steps=1,
              ema_decay=0.9)
    tx = make_optimizer(JTrainConfig(**kw), total_steps=20)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt_state, ema = tx.init(params), params

    @jax.jit
    def apply(grads, opt_state, params, ema):
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        ema = jax.tree_util.tree_map(lambda e, p: 0.1 * p + 0.9 * e, ema,
                                     params)
        return opt_state, params, ema

    for bt in batches:
        _, grads = vg(params, {k: jnp.asarray(v) for k, v in bt.items()})
        opt_state, params, ema = apply(grads, opt_state, params, ema)
    ref_p = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    ref_e = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, ema))

    port = _port(tree)
    trainer = Trainer(port, TrainConfig(**kw), total_steps=20, device="cpu")
    st = trainer.init_state()
    gen = torch.Generator().manual_seed(0)
    for bt in batches:
        out = trainer.train_step(st, bt, gen)
        assert all(torch.isfinite(v) for v in out.values())
    assert st.step == 3
    init = state_dict_from_jax(tree)
    moved = 0.0
    for name, p in st.params.items():
        for got, ref in ((p.detach().numpy(), ref_p[name]),
                         (st.ema[name].numpy(), ref_e[name])):
            np.testing.assert_allclose(_k_bias_free(name, got),
                                       _k_bias_free(name, ref), rtol=0,
                                       atol=TRAIN_ATOL, err_msg=name)
            np.testing.assert_allclose(got, ref, rtol=0, atol=3e-3,
                                       err_msg=name)
        moved = max(moved, float(np.abs(ref_p[name] - init[name]).max()))
    assert moved > 1e-3          # the steps did move the weights


def test_accumulation_of_two_half_batches_equals_one_full_batch():
    """k = 2 over two half-batches equals one step on the full batch (the
    losses are means over equal counts, so the mean of the two halves'
    gradients is the full batch's)."""
    tree = _seeded_tree(3)
    full = _batch(20, b=8, padded=False)
    halves = [{k: v[:4] for k, v in full.items()},
              {k: v[4:] for k, v in full.items()}]
    gen = torch.Generator().manual_seed(0)
    runs = []
    for k, parts in ((1, [full, full]), (2, halves + halves)):
        port = _port(tree)
        trainer = Trainer(port, TrainConfig(learning_rate=1e-3,
                                            warmup_steps=1,
                                            accumulation_steps=k),
                          total_steps=20, device="cpu")
        st = trainer.init_state()
        steps = []
        for bt in parts:
            trainer.train_step(st, bt, gen)
            steps.append(st.step)
        runs.append((st, steps))
    (sf, steps_f), (sa, steps_a) = runs
    assert steps_f == [1, 2] and steps_a == [0, 1, 1, 2]
    for name, p in sf.params.items():
        got, ref = sa.params[name].detach().numpy(), p.detach().numpy()
        np.testing.assert_allclose(_k_bias_free(name, got),
                                   _k_bias_free(name, ref), rtol=0,
                                   atol=TRAIN_ATOL, err_msg=name)
        np.testing.assert_allclose(got, ref, rtol=0, atol=3e-3, err_msg=name)


def test_schedule_matches_hf_formula():
    sched = cosine_hard_restarts_with_warmup(2.5e-4, warmup_steps=10,
                                             total_steps=100, num_cycles=1)
    for step in [0, 1, 5, 9, 10, 30, 55, 99, 120]:
        if step < 10:
            expected = 2.5e-4 * step / 10
        else:
            progress = (step - 10) / (100 - 10)
            expected = 0.0 if progress >= 1.0 else 2.5e-4 * max(
                0.0, 0.5 * (1 + math.cos(math.pi * ((1 * progress) % 1.0))))
        assert abs(sched(step) - expected) < 1e-9, step


def test_bf16_step_keeps_f32_masters():
    """compute_dtype bfloat16 casts inside the step: the masters stay f32,
    the losses are finite f32, and the step moves the masters."""
    port = _port(_seeded_tree(4), dict(TOY, dropout=0.1))
    trainer = Trainer(port, TrainConfig(learning_rate=1e-3, warmup_steps=1,
                                        compute_dtype="bfloat16"),
                      total_steps=20, device="cpu")
    st = trainer.init_state()
    before = {k: v.detach().clone() for k, v in st.params.items()}
    gen = torch.Generator().manual_seed(0)
    for seed in (30, 31):
        out = trainer.train_step(st, _batch(seed), gen)
        assert all(v.dtype == torch.float32 and torch.isfinite(v)
                   for v in out.values())
    assert all(p.dtype == torch.float32 for p in st.params.values())
    assert any(not torch.equal(p, before[k]) for k, p in st.params.items())
    ev = trainer.eval_batch(st, _batch(32))
    assert torch.isfinite(ev["total"])


def test_train_entry_refuses_the_cpu_unless_asked(monkeypatch):
    port = create_model("case", ModelConfig(**CFG), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(port, TrainConfig(), total_steps=10)
