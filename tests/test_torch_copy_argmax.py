"""The port's copy-argmax module (case_rg_tpu_torch/kernels/copy_argmax.py)
against the JAX package's, in f32 on the CPU.

``combine_copy_mass`` runs its plain version here (a CPU tensor); it is held
within 1e-6 of the JAX Pallas kernel run in interpret mode and of its XLA
reference, on ids with duplicate groups and padding, at an odd batch and a
source longer than one 128-wide tile. The candidate argmax and the argmax
mode table are held to the JAX package's exactly. Tests marked ``cuda`` hold
the CUDA kernel to its plain version on the card and skip without one."""

import numpy as np
import pytest
import torch

from case_rg_tpu_torch.kernels import copy_argmax as tca
from case_rg_tpu_torch.models.multimem import MultiMemoryDecoder
from tests.test_torch_kernels import cuda, one_torch_thread  # noqa: F401

TOL = 1e-6
# (B, Ls): duplicate groups in every case; an odd batch; Ls past one tile
SHAPES = [(8, 60), (5, 77), (3, 300)]


def copy_inputs(seed, b, ls, distinct=12, dtype=np.float32):
    """Copy mass and source ids as decoding gives them: ids drawn from a few
    distinct tokens (so groups have several members), a padded tail of id 0
    with weight 0, and weights that sum to at most 1 per row."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(4, 4 + distinct, (b, ls)).astype(np.int32)
    cw = rng.rand(b, ls).astype(np.float32)
    for r, n in enumerate(rng.randint(ls // 2, ls + 1, b)):
        ids[r, n:] = 0
        cw[r, n:] = 0
    cw = cw / cw.sum(-1, keepdims=True) * rng.uniform(0.2, 1.0, (b, 1))
    return cw.astype(dtype), ids


@pytest.fixture(scope="module")
def jca():
    from case_rg_tpu.kernels import copy_argmax
    return copy_argmax


@pytest.mark.parametrize("b,ls", SHAPES)
def test_combine_plain_matches_jax_kernel_and_xla(jca, b, ls):
    import jax.numpy as jnp
    cw, ids = copy_inputs(b * ls, b, ls)
    got = tca.combine_copy_mass(torch.from_numpy(cw), torch.from_numpy(ids))
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, ls)
    kernel = np.asarray(jca.combine_copy_mass(jnp.asarray(cw),
                                              jnp.asarray(ids), True))
    xla = np.asarray(jca.combine_copy_mass_xla(jnp.asarray(cw),
                                               jnp.asarray(ids)))
    np.testing.assert_allclose(got.numpy(), kernel, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.numpy(), xla, rtol=0, atol=TOL)
    # every member of a group carries the group's whole mass
    for r in range(b):
        for v in np.unique(ids[r]):
            members = got[r, torch.from_numpy(ids[r] == v)].numpy()
            np.testing.assert_allclose(members, cw[r][ids[r] == v].sum(),
                                       rtol=0, atol=TOL)


def test_combine_plain_bf16_weights_match_jax(jca):
    import jax.numpy as jnp
    cw, ids = copy_inputs(3, 5, 77)
    cw16 = torch.from_numpy(cw).to(torch.bfloat16)
    got = tca.combine_copy_mass(cw16, torch.from_numpy(ids).long())
    want = np.asarray(jca.combine_copy_mass_xla(
        jnp.asarray(cw16.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(ids)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def _dense_argmax(logits, gate, cw, ids):
    """argmax of gate * softmax(logits) + scatter(cw, ids), in f64."""
    lf = logits.astype(np.float64)
    p = np.exp(lf - lf.max(-1, keepdims=True))
    dist = gate[:, None] * p / p.sum(-1, keepdims=True)
    for r in range(len(dist)):
        np.add.at(dist[r], ids[r], cw[r])
    return dist.argmax(-1)


@pytest.mark.parametrize("b,ls", SHAPES)
def test_candidate_argmax_matches_jax(jca, b, ls):
    """Both candidate-argmax forms pick the JAX package's index, and the
    dense scatter's."""
    import jax.numpy as jnp
    v = 97
    cw, ids = copy_inputs(7 + ls, b, ls)
    rng = np.random.RandomState(ls)
    logits = (2 * rng.randn(b, v)).astype(np.float32)
    gate = rng.uniform(0.05, 0.9, b).astype(np.float32)
    # half the rows: copy mass too small to beat the generator's argmax
    cw[::2] *= 1e-3
    l_at = np.take_along_axis(logits, ids.astype(np.int64), -1)
    base = (gate[:, None] * np.exp(logits - logits.max(-1, keepdims=True))
            / np.exp(logits - logits.max(-1, keepdims=True)).sum(
                -1, keepdims=True)).astype(np.float32)
    t = torch.from_numpy
    got = tca.candidate_argmax_from_logits(t(logits), t(l_at), t(gate), t(cw),
                                           t(ids))
    got_generic = tca.candidate_argmax(t(base), t(cw), t(ids))
    assert got.dtype == torch.int32 and got_generic.dtype == torch.int32
    saved = jca._FORCE_INTERPRET
    jca._FORCE_INTERPRET = True
    try:
        want = np.asarray(jca.candidate_argmax_from_logits(
            jnp.asarray(logits), jnp.asarray(l_at), jnp.asarray(gate),
            jnp.asarray(cw), jnp.asarray(ids)))
        want_generic = np.asarray(jca.candidate_argmax(
            jnp.asarray(base), jnp.asarray(cw), jnp.asarray(ids)))
    finally:
        jca._FORCE_INTERPRET = saved
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_generic.numpy(), want_generic)
    np.testing.assert_array_equal(got.numpy(), _dense_argmax(logits, gate,
                                                             cw, ids))
    assert (got.numpy()[::2] == logits[::2].argmax(-1)).all()


def test_gather_weight_columns_matches_jax(jca):
    import jax.numpy as jnp
    rng = np.random.RandomState(0)
    kernel = rng.randn(16, 50).astype(np.float32)     # flax Dense [d, V]
    bias = rng.randn(50).astype(np.float32)
    ids = rng.randint(0, 50, (3, 20))
    w_at, b_at = tca.gather_weight_columns(torch.from_numpy(kernel.T.copy()),
                                           torch.from_numpy(ids),
                                           torch.from_numpy(bias))
    jw, jb = jca.gather_weight_columns(jnp.asarray(kernel.T), jnp.asarray(ids),
                                       jnp.asarray(bias))
    np.testing.assert_array_equal(w_at.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(b_at.numpy(), np.asarray(jb))


def test_resolve_fast_argmax_modes_match_jax(jca):
    """The mode table is the JAX package's where its Pallas kernel is
    available; the port's "pallas" never falls back to "mxu"."""
    import jax.numpy as jnp
    from case_rg_tpu.models.multimem import MultiMemoryDecoder as JDecoder
    jdec = JDecoder(vocab_size=16, hidden_size=8, num_heads=2, num_layers=1)
    modes = ["auto", "dense", "mxu", "pallas", "MXU", None, False, True]
    saved = jca._FORCE_INTERPRET
    jca._FORCE_INTERPRET = True
    try:
        want = [jdec._resolve_fast_argmax(m, None, jnp.float32)
                for m in modes]
        with pytest.raises(ValueError):
            jdec._resolve_fast_argmax("bogus", None, jnp.float32)
    finally:
        jca._FORCE_INTERPRET = saved
    got = [MultiMemoryDecoder._resolve_fast_argmax(m) for m in modes]
    assert got == [tuple(bool(x) for x in w) for w in want]
    assert got[modes.index("pallas")] == (True, True)
    with pytest.raises(ValueError, match="not in"):
        MultiMemoryDecoder._resolve_fast_argmax("bogus")


# ---- on the card ----

@pytest.mark.cuda
@pytest.mark.parametrize("b,ls", [(64, 1060), (5, 77), (8, 3000)])
@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_combine_kernel_matches_plain(cuda, b, ls, dtype):
    """Per element within 1e-5 of the row's total mass (the f32 sums run in
    another order), one launch counted per call."""
    cw, ids = copy_inputs(ls, b, ls, distinct=max(12, ls // 20))
    cw_t = torch.from_numpy(cw).to(cuda)
    if dtype == "bf16":
        cw_t = cw_t.to(torch.bfloat16)
    ids_t = torch.from_numpy(ids).to(cuda)
    before = tca.LAUNCHES
    got = tca.combine_copy_mass(cw_t, ids_t)
    ref = tca.combine_copy_mass_plain(cw_t, ids_t)
    torch.cuda.synchronize()
    assert tca.LAUNCHES == before + 1
    mass = cw_t.float().sum(-1, keepdim=True)
    assert bool(((got - ref).abs() <= 1e-5 * mass).all())


@pytest.mark.cuda
def test_combine_kernel_refuses_what_it_does_not_take(cuda):
    cw = torch.rand(4, 10, device=cuda)
    ids = torch.randint(0, 5, (4, 10), device=cuda, dtype=torch.int32)
    with pytest.raises(ValueError):
        tca.combine_copy_mass(cw.half(), ids)
    with pytest.raises(ValueError):
        tca.combine_copy_mass(cw, ids[:, :9])
    with pytest.raises(ValueError):
        tca.combine_copy_mass(cw.t(), ids.t())
