"""The training options' switches: seeded dropout against the default bit for
bit, the remat policies' names, bf16 scores against the JAX package's rule
and on the dense single-query path, and the CLI's auto rule (moved from
``tests/test_torch_train_options.py``, whose docstring describes them)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from case_rg_tpu_torch.config import TrainConfig
from case_rg_tpu_torch.ops import attention, dropout
from case_rg_tpu_torch.train.trainer import Trainer
from tests.test_torch_kernels import one_torch_thread  # noqa: F401
from tests.test_torch_train import (  # noqa: F401
    GRAD_ATOL, GRAD_RTOL, LOSS_RTOL, _batch, _port, _seeded_tree, _torch_batch)
from tests.test_torch_train_options import (  # noqa: F401
    DROP, _attend_inputs, _losses_and_grads, switches)


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


def test_remat_policy_names():
    with pytest.raises(ValueError, match="remat 'all'"):
        Trainer(_port(_seeded_tree(0)), TrainConfig(remat="all"),
                total_steps=10, device="cpu")


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
