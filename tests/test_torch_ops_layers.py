"""The port's layers (encoder layer, transformer block, interaction, decoder
layer with its cache, bilinear attention, copy scatter) against the JAX
package's, in f32 on the CPU (moved from ``tests/test_torch_ops.py``,
whose docstring describes them)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from case_rg_tpu.ops import bilinear as jbil
from case_rg_tpu.ops import blocks as jblocks
from case_rg_tpu.ops import copynet as jcopy
from case_rg_tpu.ops import interaction as jinter
from case_rg_tpu.ops import transformer as jtr
from case_rg_tpu_torch.ops import bilinear as tbil
from case_rg_tpu_torch.ops import blocks as tblocks
from case_rg_tpu_torch.ops import copynet as tcopy
from case_rg_tpu_torch.ops import interaction as tinter
from case_rg_tpu_torch.ops import transformer as ttr
from tests.test_torch_kernels import one_torch_thread  # noqa: F401
from tests.test_torch_ops import bridged, close  # noqa: F401


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
