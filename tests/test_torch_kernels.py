"""The port's kernel modules (case_rg_tpu_torch/kernels).

On the CPU the wrappers run their plain PyTorch versions; these are held
against the JAX package's Pallas kernels run in interpret mode, in f32:
``fused_mha`` at 1e-5, ``fold_stack_weights`` at 1e-6, ``stack_step`` at
2e-4 (the bound tests/test_fused_stack.py holds the JAX kernel to). The
decoder stacks carry seeded noise on every bias and LayerNorm gain, so that
each folded operand is nonzero.

Tests marked ``cuda`` hold each CUDA kernel against its plain version on the
card, in bf16 (``fused_mha`` within 4 and ``stack_step`` within 16 bf16
ulps per element, the limits chip_smoke.py states), and skip without one. They need no JAX (the module imports it
only inside the tests that compare with it), so on a card without JAX they
run with ``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``
(tests/conftest.py imports JAX).
"""

import numpy as np
import pytest
import torch

from case_rg_tpu_torch.bridge import load_jax_params
from case_rg_tpu_torch.kernels import decoder_stack as tds
from case_rg_tpu_torch.kernels import encoder_attention as tea
from case_rg_tpu_torch.ops.transformer import Decoder as TDecoder

torch.set_float32_matmul_precision("highest")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while a module of the port's tests runs (the
    port's test modules import this fixture): the suite runs six workers on
    one host, and small ops spread over every core stall each other (16
    tests of small ops took 84 s with 8 threads and 10 s with 1 under that
    load). Restored afterwards."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def jx():
    """The JAX side: jax, jax.numpy and the JAX package's kernel modules."""
    import types
    import jax
    import jax.numpy as jnp
    from case_rg_tpu.kernels import decoder_stack, encoder_attention
    from case_rg_tpu.ops.transformer import Decoder
    return types.SimpleNamespace(jax=jax, jnp=jnp, ds=decoder_stack,
                                 ea=encoder_attention, Decoder=Decoder)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    # the plain versions' products accumulate in full f32, as the kernels do
    saved = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = saved


def _mha_inputs(r, lq, lk, e, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(r, n, e).astype(np.float32)
               for n in (lq, lk, lk))
    keep = rng.rand(r, lk) > 0.3
    keep[0] = False                                   # a fully padded row
    return q, k, v, keep


@pytest.mark.parametrize("r,lq,lk,e,h", [
    (3, 5, 7, 16, 2),      # Lq != Lk
    (4, 9, 9, 32, 4),
    (2, 6, 8, 40, 4),      # d = 10
])
def test_fused_mha_plain_matches_jax(jx, r, lq, lk, e, h):
    q, k, v, keep = _mha_inputs(r, lq, lk, e, seed=r + lq)
    jargs = [jx.jnp.asarray(a) for a in (q, k, v, keep)]
    ref_kernel = np.asarray(jx.ea.fused_mha(*jargs, h, True))
    ref_xla = np.asarray(jx.ea.fused_mha_xla(*jargs, h))
    out = tea.fused_mha(*[torch.from_numpy(a) for a in (q, k, v, keep)],
                        h).numpy()
    np.testing.assert_allclose(out, ref_kernel, rtol=0, atol=1e-5)
    np.testing.assert_allclose(out, ref_xla, rtol=0, atol=1e-5)
    assert np.isfinite(out).all() and (out[0] == 0).all()
    # no mask at all
    out = tea.fused_mha(*[torch.from_numpy(a) for a in (q, k, v)], None, h)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jx.ea.fused_mha(*jargs[:3], None, h, True)),
        rtol=0, atol=1e-5)


def perturb_affine_tree(tree, seed, scale=0.1):
    """A copy of a numpy param tree with seeded noise on every bias
    (``bias``, ``qkv_bias``) and LayerNorm gain (``scale``): 0 and 1 at
    init, so without it the folded stack's ``u`` and ``bout`` would be 0."""
    rng = np.random.RandomState(seed)

    def walk(node):
        out = {}
        for key in sorted(node):
            leaf = node[key]
            if hasattr(leaf, "items"):
                out[key] = walk(leaf)
            elif key in ("bias", "qkv_bias"):
                out[key] = (scale * rng.randn(*leaf.shape)).astype(leaf.dtype)
            elif key == "scale":
                out[key] = (1 + scale * rng.randn(*leaf.shape)).astype(
                    leaf.dtype)
            else:
                out[key] = leaf
        return out

    return walk(tree)


def _stack(jx, seed, b=4, e=32, h=4, nl=2, lm=24):
    """A JAX decoder stack with noisy biases and LayerNorm gains, its
    bridged port, and numpy inputs."""
    rng = np.random.RandomState(seed)
    m = rng.randn(b, lm, e).astype(np.float32)
    x = rng.randn(b, e).astype(np.float32)
    mem_keep = rng.rand(b, lm) > 0.2
    mem_keep[:, 0] = True
    dec = jx.Decoder(nl, e, h, d_ff=e, dropout=0.0, activation="gelu")
    params = perturb_affine_tree(jx.jax.tree_util.tree_map(
        np.asarray, dec.init(jx.jax.random.PRNGKey(seed), x[:, None], m,
                             None, None)["params"]), seed)
    port = TDecoder(nl, e, h, d_ff=e)
    load_jax_params(port, params)
    return dec, params, port, m, x, mem_keep


def test_fold_stack_weights_matches_jax(jx):
    _, params, port, *_ = _stack(jx, seed=0)
    ref = jx.ds.fold_stack_weights(params, 2, 4, jx.jnp.float32)
    out = tds.fold_stack_weights(port, 2, 4, torch.float32)
    assert set(out) == set(ref) == set(tds.WEIGHT_KEYS)
    for key in tds.WEIGHT_KEYS:
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   rtol=0, atol=1e-6, err_msg=key)
        assert np.abs(np.asarray(ref[key])).max() > 1e-2, key   # no dead operand


def test_stack_step_plain_matches_jax_self_fed(jx):
    """Four self-fed steps with a scalar t: outputs and caches."""
    jnp, jds = jx.jnp, jx.ds
    _, params, port, m, x, mem_keep = _stack(jx, seed=1)
    b, e = x.shape
    t_max = 6
    jfold = jds.fold_stack_weights(params, 2, 4, jnp.float32)
    tfold = tds.fold_stack_weights(port, 2, 4, torch.float32)
    jc = jnp.zeros((b, 2, t_max, 2 * e), jnp.float32)
    tc = torch.zeros(b, 2, t_max, 2 * e)
    hist = np.zeros((b, t_max), bool)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    for t in range(4):
        hist[:, t] = True
        xj, jc = jds.stack_step(xj, jnp.int32(t), jc, jnp.asarray(m),
                                jnp.asarray(mem_keep), jnp.asarray(hist),
                                jfold, 4, rows_per_block=2, interpret=True)
        xt, tc = tds.stack_step(xt, t, tc, torch.from_numpy(m),
                                torch.from_numpy(mem_keep),
                                torch.from_numpy(hist), tfold, 4)
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                                   atol=2e-4)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=2e-4)


def test_stack_step_plain_per_row_t_skips_done_rows(jx):
    """Per-row t: rows pointed at T skip their cache write, live rows write
    only their own slot, and outputs match the JAX kernel."""
    jnp, jds = jx.jnp, jx.ds
    _, params, port, m, x, mem_keep = _stack(jx, seed=2)
    b, e = x.shape
    t_max = 6
    c0 = np.random.RandomState(3).randn(b, 2, t_max, 2 * e).astype(np.float32)
    hist = np.ones((b, t_max), bool)
    t_rows = np.array([1, t_max, 2, t_max], np.int32)
    yj, cj = jds.stack_step(jnp.asarray(x), jnp.asarray(t_rows),
                            jnp.asarray(c0), jnp.asarray(m),
                            jnp.asarray(mem_keep), jnp.asarray(hist),
                            jds.fold_stack_weights(params, 2, 4, jnp.float32),
                            4, rows_per_block=2, interpret=True)
    yt, ct = tds.stack_step(torch.from_numpy(x), torch.from_numpy(t_rows),
                            torch.from_numpy(c0.copy()), torch.from_numpy(m),
                            torch.from_numpy(mem_keep),
                            torch.from_numpy(hist),
                            tds.fold_stack_weights(port, 2, 4, torch.float32),
                            4)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=2e-4)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=2e-4)
    c = ct.numpy()
    np.testing.assert_array_equal(c[1], c0[1])
    np.testing.assert_array_equal(c[3], c0[3])
    np.testing.assert_array_equal(c[0, :, 0], c0[0, :, 0])
    np.testing.assert_array_equal(c[0, :, 2:], c0[0, :, 2:])
    assert not np.array_equal(c[0, :, 1], c0[0, :, 1])


# ---- on the card: each CUDA kernel against its plain version (bf16) ----

def _bf16_close(out, ref, ulps):
    """|out - ref| <= ulps bf16 ulps, element by element, at the larger of
    the element's magnitude and its row's RMS (rows along the last dim)."""
    o, r = out.float(), ref.float()
    rms = r.square().mean(-1, keepdim=True).sqrt()
    mag = torch.maximum(r.abs(), rms).clamp_min(2.0 ** -100)
    err = ((o - r).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)).max()
    assert err.item() <= ulps, err.item()
    return err.item()
