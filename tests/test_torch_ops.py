"""The port's ops (case_rg_tpu_torch/ops) against the JAX package's, in f32
on the CPU: the same numpy inputs and bridged weights go through both, and
the outputs agree within 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from case_rg_tpu.ops import attention as jattn
from case_rg_tpu.ops import bilinear as jbil
from case_rg_tpu.ops import blocks as jblocks
from case_rg_tpu.ops import cache as jcache
from case_rg_tpu.ops import copynet as jcopy
from case_rg_tpu.ops import embedding as jemb
from case_rg_tpu.ops import interaction as jinter
from case_rg_tpu.ops import masking as jmask
from case_rg_tpu.ops import positional as jpos
from case_rg_tpu.ops import transformer as jtr
from case_rg_tpu_torch.bridge import load_jax_params
from case_rg_tpu_torch.ops import attention as tattn
from case_rg_tpu_torch.ops import bilinear as tbil
from case_rg_tpu_torch.ops import blocks as tblocks
from case_rg_tpu_torch.ops import cache as tcache
from case_rg_tpu_torch.ops import copynet as tcopy
from case_rg_tpu_torch.ops import embedding as temb
from case_rg_tpu_torch.ops import interaction as tinter
from case_rg_tpu_torch.ops import masking as tmask
from case_rg_tpu_torch.ops import positional as tpos
from case_rg_tpu_torch.ops import transformer as ttr
from tests.test_torch_kernels import one_torch_thread  # noqa: F401

TOL = 1e-5
torch.set_float32_matmul_precision("highest")


def np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def bridged(torch_module, params):
    load_jax_params(torch_module, np_tree(params))
    return torch_module.eval()


def close(port, ref, tol=TOL):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    np.testing.assert_allclose(port, np.asarray(ref), rtol=0, atol=tol)


def test_embedding_random_row0():
    """Row 0 of a bridged table is random: the lookup must still give
    zeros at PAD positions."""
    mod = jemb.Embedding(64, 16)
    ids = np.random.RandomState(0).randint(0, 64, (3, 7))
    ids[:, -2:] = 0
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"]
    assert np.abs(np.asarray(params["embedding"][0])).sum() > 0
    ref = mod.apply({"params": params}, jnp.asarray(ids))
    port = bridged(temb.Embedding(64, 16), params)(torch.from_numpy(ids))
    close(port, ref)
    assert (port[:, -2:] == 0).all()


@pytest.mark.parametrize("offset", ["zero", "scalar", "rows"])
def test_positional(offset):
    rng = np.random.RandomState(1)
    x = rng.randn(3, 4, 16).astype(np.float32)
    off = {"zero": 0, "scalar": 5, "rows": np.array([0, 3, 7])}[offset]
    ref = jpos.PositionalEmbedding(16, dropout=0.0).apply(
        {}, jnp.asarray(x), offset=jnp.asarray(off) if offset == "rows"
        else off)
    port = tpos.PositionalEmbedding(16)(
        torch.from_numpy(x),
        offset=torch.from_numpy(off) if offset == "rows" else off)
    close(port, ref)


def test_masked_softmax_fully_masked_row():
    rng = np.random.RandomState(2)
    x = rng.randn(3, 5, 6).astype(np.float32)
    mask = rng.rand(3, 5, 6) > 0.4
    mask[1, 2] = False
    ref = jmask.masked_softmax(jnp.asarray(x), jnp.asarray(mask), axis=-1)
    port = tmask.masked_softmax(torch.from_numpy(x), torch.from_numpy(mask))
    close(port, ref)
    assert torch.isfinite(port).all() and (port[1, 2] == 0).all()


def test_attend_fully_masked_row_gives_zeros():
    """A row whose keys are all padding gives zero context and no NaN
    (SDPA would give NaN)."""
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(3, 2, 5, 8).astype(np.float32) for _ in range(3))
    keep = rng.rand(3, 5) > 0.3
    keep[2] = False
    ref, _ = jattn.attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          key_keep=jnp.asarray(keep))
    port, _ = tattn.attend(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v),
                           key_keep=torch.from_numpy(keep))
    close(port, ref)
    assert torch.isfinite(port).all() and (port[2] == 0).all()


def test_masked_mean():
    rng = np.random.RandomState(4)
    x = rng.randn(3, 6, 8).astype(np.float32)
    keep = rng.rand(3, 6) > 0.3
    keep[:, 0] = True
    close(tmask.masked_mean(torch.from_numpy(x), torch.from_numpy(keep)),
          jmask.masked_mean(jnp.asarray(x), jnp.asarray(keep)))


@pytest.mark.parametrize("per_row", [False, True])
def test_write_step(per_row):
    """Scalar t writes every row; per-row t skips rows pointed out of
    range (the JAX drop semantics), in place."""
    rng = np.random.RandomState(5)
    buf = rng.randn(4, 6, 8).astype(np.float32)
    val = rng.randn(4, 1, 8).astype(np.float32)
    t = np.array([1, 6, 3, 6], np.int32) if per_row else 2
    ref = jcache.write_step(jnp.asarray(buf), jnp.asarray(val),
                            jnp.asarray(t))
    tb = torch.from_numpy(buf.copy())
    out = tcache.write_step(tb, torch.from_numpy(val),
                            torch.from_numpy(t) if per_row else t)
    assert out is tb
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_encoder_layer():
    rng = np.random.RandomState(6)
    x = rng.randn(3, 7, 16).astype(np.float32)
    keep = rng.rand(3, 7) > 0.3
    keep[:, 0] = True
    mod = jtr.EncoderLayer(16, 2, 16, dropout=0.0)
    params = mod.init(jax.random.PRNGKey(1), jnp.asarray(x),
                      jnp.asarray(keep))["params"]
    ref = mod.apply({"params": params}, jnp.asarray(x), jnp.asarray(keep))
    port = bridged(ttr.EncoderLayer(16, 2, 16), params)(
        torch.from_numpy(x), torch.from_numpy(keep))
    close(port, ref)


@pytest.mark.parametrize("din", [16, 80])
def test_transformer_block(din):
    """The tower block, including the 5D -> D first block."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 3, 6, din).astype(np.float32)
    keep = rng.rand(2, 3, 6) > 0.3
    keep[1, 2] = False                          # a fully padded sequence
    mod = jblocks.TransformerBlock(2, din, 16, dropout=0.0)
    params = mod.init(jax.random.PRNGKey(2), jnp.asarray(x),
                      jnp.asarray(keep))["params"]
    ref = mod.apply({"params": params}, jnp.asarray(x), jnp.asarray(keep))
    port = bridged(tblocks.TransformerBlock(2, din, 16), params)(
        torch.from_numpy(x), torch.from_numpy(keep))
    close(port, ref)


def test_interaction_single_query():
    """nq=1 against several passages: the query side is broadcast, then
    max-pooled over passages."""
    rng = np.random.RandomState(8)
    enc1 = rng.randn(2, 1, 5, 16).astype(np.float32)
    enc2 = rng.randn(2, 3, 7, 16).astype(np.float32)
    m1 = rng.rand(2, 1, 5) > 0.2
    m2 = rng.rand(2, 3, 7) > 0.2
    m2[0, 1] = False
    args = [jnp.asarray(a) for a in (enc1, enc2, m1, m2)]
    mod = jinter.Interaction(16)
    params = mod.init(jax.random.PRNGKey(3), *args)["params"]
    ref_q, ref_p = mod.apply({"params": params}, *args)
    port_q, port_p = bridged(tinter.Interaction(16), params)(
        *[torch.from_numpy(a) for a in (enc1, enc2, m1, m2)])
    close(port_q, ref_q)
    close(port_p, ref_p)


def test_decoder_layer_step_with_cache():
    """DecoderLayer.step over several self-fed steps: outputs and the
    packed K|V cache track the JAX layer."""
    rng = np.random.RandomState(9)
    b, e, t_max, lm = 3, 16, 6, 9
    mem = rng.randn(b, lm, e).astype(np.float32)
    mem_keep = rng.rand(b, lm) > 0.3
    mem_keep[:, 0] = True
    x0 = rng.randn(b, 1, e).astype(np.float32)
    mod = jtr.DecoderLayer(e, 2, e, dropout=0.0)
    params = mod.init(jax.random.PRNGKey(4), jnp.asarray(x0),
                      jnp.asarray(mem))["params"]
    v = {"params": params}
    ck, cv = mod.apply(v, jnp.asarray(mem),
                       method=jtr.DecoderLayer.precompute_memory)
    port = bridged(ttr.DecoderLayer(e, 2, e), params)
    tck, tcv = port.precompute_memory(torch.from_numpy(mem))
    close(tck, ck)
    close(tcv, cv)
    cache = jnp.zeros((b, t_max, 2 * e), jnp.float32)
    tcache_ = torch.zeros(b, t_max, 2 * e)
    hist = np.zeros((b, t_max), bool)
    xj, xt = jnp.asarray(x0), torch.from_numpy(x0)
    for t in range(4):
        hist[:, t] = True
        xj, cache = mod.apply(v, xj, jnp.int32(t), cache, jnp.asarray(hist),
                              ck, cv, jnp.asarray(mem_keep),
                              method=jtr.DecoderLayer.step)
        xt, tcache_ = port.step(xt, t, tcache_, torch.from_numpy(hist), tck,
                                tcv, torch.from_numpy(mem_keep))
        close(xt, xj)
    close(tcache_, cache)


def test_bilinear_attention():
    rng = np.random.RandomState(10)
    q = rng.randn(2, 3, 32).astype(np.float32)
    key = rng.randn(2, 7, 16).astype(np.float32)
    mask = rng.rand(2, 3, 7) > 0.3
    mask[1, 0] = False
    mod = jbil.BilinearAttention(32, 16, 16)
    params = mod.init(jax.random.PRNGKey(5), jnp.asarray(q), jnp.asarray(key),
                      jnp.asarray(key), jnp.asarray(mask))["params"]
    ref = mod.apply({"params": params}, jnp.asarray(q), jnp.asarray(key),
                    jnp.asarray(key), jnp.asarray(mask))
    port = bridged(tbil.BilinearAttention(32, 16, 16), params)
    out = port(torch.from_numpy(q), torch.from_numpy(key),
               torch.from_numpy(key), torch.from_numpy(mask))
    for o, r in zip(out, ref):      # masked raw scores are -1e20 in both
        close(o, r)
    # the decode path: precomputed key projection
    uh = port.key_proj(torch.from_numpy(key))
    ctx, _, norm = port.attend_from_proj(torch.from_numpy(q), uh,
                                         torch.from_numpy(key),
                                         torch.from_numpy(mask))
    close(ctx, ref[0])
    close(norm, ref[2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_copy_scatter(dtype):
    """Duplicate ids accumulate; bf16 weights accumulate in f32."""
    rng = np.random.RandomState(11)
    w = rng.rand(3, 2, 9).astype(np.float32)
    ids = rng.randint(0, 6, (3, 9)).astype(np.int32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    ref = jcopy.copy_scatter(jnp.asarray(w, jd), jnp.asarray(ids), 12)
    port = tcopy.copy_scatter(torch.from_numpy(w).to(td),
                              torch.from_numpy(ids), 12)
    assert port.dtype == td
    close(port.float(), np.asarray(ref, np.float32))
