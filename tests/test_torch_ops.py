"""The port's ops (case_rg_tpu_torch/ops) against the JAX package's, in f32
on the CPU: the same numpy inputs and bridged weights go through both, and
the outputs agree within 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from case_rg_tpu.ops import attention as jattn
from case_rg_tpu.ops import cache as jcache
from case_rg_tpu.ops import embedding as jemb
from case_rg_tpu.ops import masking as jmask
from case_rg_tpu.ops import positional as jpos
from case_rg_tpu_torch.bridge import load_jax_params
from case_rg_tpu_torch.ops import attention as tattn
from case_rg_tpu_torch.ops import cache as tcache
from case_rg_tpu_torch.ops import embedding as temb
from case_rg_tpu_torch.ops import masking as tmask
from case_rg_tpu_torch.ops import positional as tpos
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
