"""The GRU family's building blocks in the port (case_rg_tpu_torch/ops/gru.py,
ops/highway.py, models/components.GRUSeqEncoder) against the JAX package,
in f32 on the CPU, with the JAX parameters bridged leaf for leaf.

Held here (tolerance 1e-5 absolute on values, 1e-4 on gradients):

* the masked-scan GRU, two layers, one and both directions, over
  rows of uneven lengths (one of them empty): outputs zero at padding,
  final states [B, layers*dirs, H] layer-major, and the gradients of a
  loss through them;
* the same GRU against ``torch.nn.GRU`` over packed sequences (the
  reference's semantics), and its one-step form against the scan;
* the Highway network, and ``GRUSeqEncoder`` (two layers, one shared
  embedding or one a layer, every layer after the first re-concatenating
  the embedding).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from case_rg_tpu.models.components import GRUSeqEncoder as JGRUSeqEncoder
from case_rg_tpu.ops.gru import GRU as JGRU
from case_rg_tpu.ops.highway import Highway as JHighway
from case_rg_tpu_torch.bridge import load_jax_params
from case_rg_tpu_torch.models.components import GRUSeqEncoder
from case_rg_tpu_torch.ops.gru import GRU
from case_rg_tpu_torch.ops.highway import Highway
from tests.test_torch_kernels import one_torch_thread  # noqa: F401

TOL = 1e-5
GRAD_TOL = 1e-4
LENGTHS = np.array([9, 5, 0, 1, 7])
torch.set_float32_matmul_precision("highest")


def _params(module, *args, seed=1):
    """A parameter tree of the module's shapes (traced, not compiled), each
    leaf 0.3 * N(0, 1) from ``seed``: weights and nonzero biases."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args))["params"]
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda s: (0.3 * rng.randn(*s.shape)).astype(np.float32), shapes)


def _inputs(b=5, l=9, d=12, seed=0):
    x = np.random.RandomState(seed).randn(b, l, d).astype(np.float32)
    mask = np.arange(l)[None, :] < LENGTHS[:b, None]
    return x, mask


@pytest.mark.parametrize("bidirectional", [False, True],
                         ids=["forward", "bidirectional"])
def test_gru_matches_jax(bidirectional):
    """Two layers (the second reads the first's outputs)."""
    num_layers = 2
    x, mask = _inputs()
    jgru = JGRU(input_size=12, hidden_size=8, num_layers=num_layers,
                bidirectional=bidirectional)
    params = _params(jgru, jnp.asarray(x), jnp.asarray(mask))
    w = np.random.RandomState(3).randn(5, 9, 8 * (1 + bidirectional)
                                       ).astype(np.float32)

    def jloss(p, xx):      # one loss through outputs and final states
        o, s = jgru.apply({"params": p}, xx, jnp.asarray(mask))
        return jnp.sum(o * w) + jnp.sum(s ** 2), (o, s)

    (_, (want_out, want_state)), (jg_p, jg_x) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    gru = GRU(12, 8, num_layers=num_layers, bidirectional=bidirectional)
    load_jax_params(gru, params)
    xt = torch.from_numpy(x).requires_grad_()
    out, state = gru(xt, torch.from_numpy(mask))
    dirs = 2 if bidirectional else 1
    assert out.shape == (5, 9, 8 * dirs)
    assert state.shape == (5, num_layers * dirs, 8)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(state.detach().numpy(),
                               np.asarray(want_state), rtol=0, atol=TOL)
    assert not out[~torch.from_numpy(mask)].any(), "padding must be zero"
    ((out * torch.from_numpy(w)).sum() + (state ** 2).sum()).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg_x), rtol=0,
                               atol=GRAD_TOL)
    for name, p in gru.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg_p[name]),
                                   rtol=0, atol=GRAD_TOL, err_msg=name)


def _torch_packed(ref, x, lengths):
    """torch.nn.GRU over packed sequences, zero-filled, final states
    [B, layers*dirs, H]."""
    lengths_t = torch.tensor(lengths)
    order = torch.argsort(lengths_t, descending=True, stable=True)
    inv = torch.argsort(order, stable=True)
    packed = torch.nn.utils.rnn.pack_padded_sequence(
        torch.from_numpy(x)[order], lengths_t[order], batch_first=True)
    out, state = ref(packed)
    out, _ = torch.nn.utils.rnn.pad_packed_sequence(
        out, batch_first=True, total_length=x.shape[1])
    return out[inv], state.transpose(0, 1)[inv]


def test_gru_matches_torch_packed_sequences():
    """The reference's semantics: pack, run, unpack (rows of length >= 1:
    packing takes no empty row)."""
    torch.manual_seed(0)
    lengths = np.array([9, 5, 1, 7])
    x, _ = _inputs(b=4)
    mask = np.arange(9)[None, :] < lengths[:, None]
    ref = torch.nn.GRU(12, 8, num_layers=2, bidirectional=True,
                       batch_first=True)
    gru = GRU(12, 8, num_layers=2, bidirectional=True)
    with torch.no_grad():
        for layer in range(2):
            for d, suffix in ((0, ""), (1, "_reverse")):
                tag, rt = f"l{layer}_d{d}", f"l{layer}{suffix}"
                getattr(gru, f"w_ih_{tag}").copy_(
                    getattr(ref, f"weight_ih_{rt}").T)
                getattr(gru, f"w_hh_{tag}").copy_(
                    getattr(ref, f"weight_hh_{rt}").T)
                for w in ("ih", "hh"):
                    getattr(gru, f"b_{w}_{tag}").copy_(
                        getattr(ref, f"bias_{w}_{rt}"))
        want_out, want_state = _torch_packed(ref, x, lengths)
        out, state = gru(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), want_out.numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(state.numpy(), want_state.numpy(), rtol=0,
                               atol=TOL)


def test_gru_step_matches_the_scan():
    torch.manual_seed(1)
    gru = GRU(6, 8, num_layers=2)
    with torch.no_grad():
        for p in gru.parameters():
            p.copy_(0.3 * torch.randn(p.shape))
        x = torch.randn(3, 5, 6)
        out, state = gru(x)
        h = torch.zeros(3, 2, 8)
        for t in range(5):
            o, h = gru.step(x[:, t], h)
            np.testing.assert_allclose(o.numpy(), out[:, t].numpy(), rtol=0,
                                       atol=TOL)
    np.testing.assert_allclose(h.numpy(), state.numpy(), rtol=0, atol=TOL)


def test_highway_matches_jax():
    x = np.random.RandomState(2).randn(3, 7, 10).astype(np.float32)
    jhw = JHighway(10, 10, num_layers=2)
    params = _params(jhw, jnp.asarray(x))
    hw = Highway(10, 10, num_layers=2)
    load_jax_params(hw, params)
    with torch.no_grad():
        got = hw(torch.from_numpy(x)).numpy()
    want = jax.jit(jhw.apply)({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("share", [True, False], ids=["shared", "per-layer"])
def test_gru_seq_encoder_matches_jax(share):
    ids = np.random.RandomState(4).randint(1, 30, (5, 9)).astype(np.int32)
    ids[np.arange(9)[None, :] >= LENGTHS[:, None]] = 0
    jenc = JGRUSeqEncoder(num_layers=2, vocab_size=30, embedding_size=6,
                          hidden_size=8, share_embedding_per_layer=share)
    params = _params(jenc, jnp.asarray(ids))
    want_out, want_states = jax.jit(jenc.apply)({"params": params},
                                                jnp.asarray(ids))
    enc = GRUSeqEncoder(2, 30, 6, 8, share_embedding_per_layer=share)
    load_jax_params(enc, params)
    with torch.no_grad():
        out, states = enc(torch.from_numpy(ids).long())
    assert out.shape == (5, 2, 9, 8) and states.shape == (5, 2, 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(states.numpy(), np.asarray(want_states),
                               rtol=0, atol=TOL)
