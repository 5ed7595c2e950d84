"""The training options of the port (``--seeded_dropout``, ``--remat``,
``--bf16_scores``) on the CPU, in f32 unless said otherwise, at the toy
widths of ``tests/test_torch_train.py``.

* Seeded dropout (``ops/dropout.set_seeded_dropout``): with dropout 0.1 and
  one generator seed, CaSE's losses and every gradient equal the default
  path's bit for bit, through the dense attention's probability dropout
  and through the training attention's caller-drawn mask (which it leaves
  alone); at dropout 0 the seeded losses and gradients match the JAX
  package's ``train_losses`` at the 1e-5 bounds of the train tests.
* Remat (``TrainConfig.remat``): for "dots", "dots_batch" and "nothing",
  with dropout 0.1, 3 steps give the no-remat losses (equal) and parameters
  within rtol 1e-5 / atol 1e-6 (``tests/test_trainer.py``'s bound for the
  JAX package's remat), also with the training attention's in-kernel
  mask (its plain version); with the generator's rewind taken out, the
  recompute draws other masks and the parameters move elsewhere. "dots"
  against the JAX package's ``jax.checkpoint`` of the same loss at
  dropout 0.
* bf16 scores (``ops/attention.set_bf16_scores``): the port's ``attend``
  on bf16 inputs against the JAX ``attend`` under the same switch within
  atol 0.05 (``tests/test_ops_attention.py``'s bound), bf16 out; f32 the
  same bit for bit with the switch on; the dense single-query path
  follows the switch; and ``cli/run``'s auto rule.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from case_rg_tpu.config import ModelConfig as JConfig
from case_rg_tpu.models import create_model as jcreate
from case_rg_tpu_torch.bridge import state_dict_from_jax
from case_rg_tpu_torch.config import TrainConfig
from case_rg_tpu_torch.ops import attention, dropout
from case_rg_tpu_torch.train import trainer as trainer_mod
from case_rg_tpu_torch.train.trainer import Trainer
from tests.test_torch_bridge import TOY
from tests.test_torch_kernels import one_torch_thread  # noqa: F401
from tests.test_torch_train import (GRAD_ATOL, GRAD_RTOL, LOSS_RTOL, _batch,
                                    _port, _seeded_tree, _torch_batch)

torch.set_float32_matmul_precision("highest")
DROP = dict(TOY, dropout=0.1)


@pytest.fixture(autouse=True)
def switches():
    """Every switch this module turns is back at its default afterwards."""
    yield
    dropout.set_seeded_dropout(False)
    attention.set_bf16_scores(False)
    attention.set_fused_train_attention(None)
    attention.set_fused_train_attn_rng(True)


def _losses_and_grads(port, batch, seed):
    losses = port.train_losses(batch, torch.Generator().manual_seed(seed))
    sum(losses.values()).backward()
    return ({k: v.detach() for k, v in losses.items()},
            {n: p.grad.clone() for n, p in port.named_parameters()})


# ---- seeded dropout ----

@pytest.mark.parametrize("gate", ["dense", "forced-mask"])
def test_seeded_dropout_equals_the_default_bit_for_bit(gate):
    """Dropout 0.1: the same losses and gradients bit for bit; "dense"
    takes every site through ``dropout`` (the probabilities' too),
    "forced-mask" the training attention's caller-drawn mask (not
    seeded) beside the seeded module sites."""
    tree = _seeded_tree(5)
    batch = _torch_batch(_batch(6))
    runs = []
    attention.set_fused_train_attention(gate != "dense")
    attention.set_fused_train_attn_rng(False)
    for seeded in (False, True):
        dropout.set_seeded_dropout(seeded)
        runs.append(_losses_and_grads(_port(tree, DROP), batch, 7))
    (dl, dg), (sl, sg) = runs
    assert all(torch.equal(dl[k], sl[k]) for k in dl), (dl, sl)
    assert set(dg) == set(sg)
    for name in dg:
        assert torch.equal(dg[name], sg[name]), name


def test_seeded_dropout_keeps_no_mask():
    """The seeded Function's backward draws the mask again from the saved
    state: its gradient is where(keep, g / kp, 0) for the forward's keep,
    and its only saved state is the generator's."""
    x = torch.randn(4, 50, requires_grad=True)
    gen = torch.Generator().manual_seed(3)
    dropout.set_seeded_dropout(True)
    y = dropout.dropout(x, 0.3, gen)
    assert y.grad_fn.saved_tensors == ()
    g = torch.randn(4, 50)
    y.backward(g)
    keep = y != 0
    assert keep.float().mean().item() == pytest.approx(0.7, abs=0.1)
    assert torch.equal(x.grad, torch.where(keep, g / 0.7, 0.0))


@pytest.fixture(scope="module")
def jax_remat_ref():
    """The JAX side at dropout 0 in training mode: the summed CaSE train
    losses under ``jax.checkpoint`` with the "dots" policy, as
    ``Trainer.step_fn`` wraps them for ``TrainConfig.remat="dots"``; the
    weights, one batch, its losses and gradients."""
    tree = _seeded_tree()
    batch = _batch(1)
    model = jcreate("case", JConfig(**dict(TOY, dropout=0.0)))

    def loss_fn(params, batch):
        losses = model.apply({"params": params}, batch, deterministic=False,
                             rngs={"dropout": jax.random.PRNGKey(3)},
                             method=type(model).train_losses)
        return sum(losses.values()), losses

    policy = jax.checkpoint_policies.dots_with_no_batch_dims_saveable
    vg = jax.jit(jax.value_and_grad(jax.checkpoint(loss_fn, policy=policy),
                                    has_aux=True))
    (_, losses), grads = vg(tree, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    return tree, batch, {k: float(v) for k, v in losses.items()}, \
        state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads))


def _match_jax(losses, grads, ref_losses, ref_grads):
    assert set(losses) == set(ref_losses)
    for k, v in losses.items():
        assert abs(float(v) - ref_losses[k]) <= LOSS_RTOL * abs(
            ref_losses[k]), k
    assert set(grads) == set(ref_grads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref_grads[name],
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_seeded_dropout_at_rate_zero_matches_jax(jax_remat_ref):
    tree, batch, ref_losses, ref_grads = jax_remat_ref
    dropout.set_seeded_dropout(True)
    losses, grads = _losses_and_grads(_port(tree), _torch_batch(batch), 0)
    _match_jax(losses, grads, ref_losses, ref_grads)


# ---- remat ----

def _three_steps(tree, remat, gate="dense"):
    """3 steps at lr 1e-2, warmup 1, dropout 0.1, one generator: the
    losses and the parameters after them."""
    attention.set_fused_train_attention(gate != "dense")
    attention.set_fused_train_attn_rng(gate == "forced-rng")
    port = _port(tree, DROP)
    trainer = Trainer(port, TrainConfig(batch_size=4, learning_rate=1e-2,
                                        warmup_steps=1, remat=remat),
                      total_steps=100, device="cpu")
    st = trainer.init_state()
    gen = torch.Generator().manual_seed(11)
    losses = [trainer.train_step(st, _batch(40 + i), gen)["total"].item()
              for i in range(3)]
    return losses, {k: v.detach().clone() for k, v in st.params.items()}


def _params_close(got, want):
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("remat, gate", [
    ("dots", "dense"), ("dots_batch", "dense"), ("nothing", "dense"),
    ("dots", "forced-rng"), ("nothing", "forced-mask")],
    ids=["dots", "dots_batch", "nothing", "dots-rng", "nothing-mask"])
def test_remat_matches_no_remat(remat, gate):
    tree = _seeded_tree(7)
    base_losses, base_params = _three_steps(tree, "", gate)
    losses, params = _three_steps(tree, remat, gate)
    assert losses == base_losses
    _params_close(params, base_params)


def test_remat_without_the_rewind_is_another_function(monkeypatch):
    """Without the generator's rewind, the recompute draws the next masks:
    the first loss is the same, the gradients (so the parameters) are
    not."""
    tree = _seeded_tree(7)
    base_losses, base_params = _three_steps(tree, "")
    monkeypatch.setattr(trainer_mod, "_rewinder", lambda gen: (lambda: gen,
                                                               gen))
    losses, params = _three_steps(tree, "nothing")
    assert losses[0] == base_losses[0]
    with pytest.raises(AssertionError):
        _params_close(params, base_params)


def test_remat_leaves_the_generator_where_one_forward_does():
    tree = _seeded_tree(8)
    states = []
    for remat in ("", "dots"):
        port = _port(tree, DROP)
        trainer = Trainer(port, TrainConfig(remat=remat), total_steps=10,
                          device="cpu")
        gen = torch.Generator().manual_seed(2)
        trainer.loss_and_grads(trainer.init_state(), _batch(9), gen)
        states.append(gen.get_state())
    assert torch.equal(states[0], states[1])


def test_remat_dots_matches_jax_remat(jax_remat_ref):
    tree, batch, ref_losses, ref_grads = jax_remat_ref
    port = _port(tree)
    trainer = Trainer(port, TrainConfig(remat="dots"), total_steps=10,
                      device="cpu")
    losses, grads = trainer.loss_and_grads(trainer.init_state(), batch,
                                           torch.Generator().manual_seed(0))
    del losses["total"]
    _match_jax(losses, grads, ref_losses, ref_grads)


def test_remat_policy_names():
    with pytest.raises(ValueError, match="remat 'all'"):
        Trainer(_port(_seeded_tree(0)), TrainConfig(remat="all"),
                total_steps=10, device="cpu")


# ---- bf16 scores ----

def _attend_inputs():
    rng = np.random.RandomState(7)
    q = rng.standard_normal((4, 2, 10, 16)).astype(np.float32)
    k = rng.standard_normal((4, 2, 12, 16)).astype(np.float32)
    v = rng.standard_normal((4, 2, 12, 16)).astype(np.float32)
    keep = np.arange(12)[None, :] < rng.randint(6, 13, size=(4,))[:, None]
    return q, k, v, keep


def test_bf16_scores_attend_matches_jax():
    from case_rg_tpu.ops import attention as jatt
    q, k, v, keep = _attend_inputs()
    bias = np.triu(np.full((10, 12), -1e9, np.float32), 3)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    tkeep, tbias = torch.from_numpy(keep), torch.from_numpy(bias)
    f32_off, _ = attention.attend(tq, tk, tv, key_keep=tkeep, attn_bias=tbias)
    try:
        jatt.set_bf16_scores(True)
        want, _ = jatt.attend(*(jnp.asarray(x, jnp.bfloat16)
                                for x in (q, k, v)),
                              key_keep=jnp.asarray(keep),
                              attn_bias=jnp.asarray(bias))
    finally:
        jatt.set_bf16_scores(False)
    attention.set_bf16_scores(True)
    got, _ = attention.attend(*(x.bfloat16() for x in (tq, tk, tv)),
                              key_keep=tkeep, attn_bias=tbias)
    f32_on, _ = attention.attend(tq, tk, tv, key_keep=tkeep, attn_bias=tbias)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=0.05)
    assert torch.equal(f32_on, f32_off)
    attention.set_bf16_scores(False)
    base, _ = attention.attend(*(x.bfloat16() for x in (tq, tk, tv)),
                               key_keep=tkeep, attn_bias=tbias)
    assert not torch.equal(base, got)       # the switch did change it
    np.testing.assert_allclose(got.float().numpy(), base.float().numpy(),
                               atol=0.05)


def test_bf16_scores_reach_the_dense_single_query_path(monkeypatch):
    """``attend_with_kv_merged`` off the kernel (the CPU) takes the score
    dtype from the switch; the kernel's plain version keeps f32."""
    from case_rg_tpu_torch.kernels import decode_attention
    from case_rg_tpu_torch.ops.attention import MultiHeadAttention
    seen = []
    real = decode_attention.single_query_mha_plain

    def spy(*args):
        seen.append(args[5] if len(args) > 5 else torch.float32)
        return real(*args)

    monkeypatch.setattr(attention, "single_query_mha_plain", spy)
    mha = MultiHeadAttention(16, 2, dtype=torch.bfloat16)
    with torch.no_grad():
        for p in mha.parameters():
            p.normal_(0, 0.3)
    x = torch.randn(3, 1, 16).bfloat16()
    kv = torch.randn(3, 9, 16).bfloat16()
    outs = []
    for on in (False, True):
        attention.set_bf16_scores(on)
        with torch.no_grad():
            outs.append(mha.attend_with_kv_merged(x, kv, kv)[0])
    assert seen == [torch.float32, torch.bfloat16]
    np.testing.assert_allclose(outs[1].float().numpy(),
                               outs[0].float().numpy(), atol=0.05)


@pytest.mark.parametrize("argv, want", [
    (["--mode", "train", "--bf16_train"], True),
    (["--mode", "ps_train", "--model", "masque", "--bf16_train"], True),
    (["--mode", "train"], False),
    (["--mode", "test", "--bf16_train"], False),
    (["--mode", "train", "--bf16_train", "--no-bf16_scores"], False),
    (["--mode", "test", "--bf16_scores"], True)],
    ids=["train-bf16", "ps_train-bf16", "train-f32", "test-bf16_train",
         "explicit-off", "explicit-on"])
def test_cli_bf16_scores_auto_rule(argv, want):
    """The JAX CLI's rule: None is on exactly for train/ps_train with
    --bf16_train; an explicit flag wins. Seeded dropout is set both
    ways too."""
    from case_rg_tpu_torch.cli.run import build_parser, set_switches
    attention.set_bf16_scores(not want)
    dropout.set_seeded_dropout(True)
    if "--model" not in argv:
        argv = argv + ["--model", "case"]
    set_switches(build_parser().parse_args(argv))
    assert attention._BF16_SCORES is want
    assert not dropout.seeded_dropout_enabled()
    set_switches(build_parser().parse_args(argv + ["--seeded_dropout"]))
    assert dropout.seeded_dropout_enabled()
