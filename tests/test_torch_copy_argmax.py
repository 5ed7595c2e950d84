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


# ---- the kernel's launch plan (pure Python) ----

SMEM_LIMIT = 232448       # bytes of shared memory a block may use on sm_90


@pytest.mark.parametrize("ls,body,n", [
    (77, "brute", 77), (384, "brute", 384), (385, "sort", 512),
    (1060, "sort", 2048), (3000, "sort", 4096), (4096, "sort", 4096),
    (4097, "brute", 4097), (tca.MAX_FAST_LS, "brute", tca.MAX_FAST_LS)])
def test_combine_copy_mass_plan(ls, body, n):
    """The sort body (a block a row, n / 8 threads, n = Ls rounded up to a
    power of two, at least 256) from 385 to 4096 positions, the brute body
    (a block a row and tile of 128 positions) on shorter and longer rows;
    shared memory within a block's."""
    for b in (1, 64, 65535):
        plan = tca.combine_copy_mass_plan(b, ls)
        assert (plan["body"], plan["n"]) == (body, n)
        if body == "sort":
            assert plan["threads"] == n // 8 and plan["blocks"] == b
            assert plan["smem"] == 22 * n + 768
        else:
            assert plan["threads"] == 128
            assert plan["blocks"] == b * -(-ls // 128)
            assert plan["smem"] == 8 * (-(-ls // 4) * 4)
        assert plan["smem"] <= SMEM_LIMIT


def test_combine_copy_mass_plan_takes_every_shape_the_wrapper_takes():
    """Every row length up to MAX_FAST_LS and every batch up to 65535 is
    planned onto a kernel body (no plain fallback); the brute body takes
    every length, the sort body every length to 4096 and none past it;
    beyond the wrapper's limits the plan refuses."""
    for ls in list(range(1, 300)) + [1023, 1024, 1025, 2049, 4095, 4096,
                                     4097, 10000, tca.MAX_FAST_LS]:
        plan = tca.combine_copy_mass_plan(65535, ls)
        assert plan["smem"] <= SMEM_LIMIT
        for body in ("brute",) + (("sort",) if ls <= 4096 else ()):
            assert tca.combine_copy_mass_plan(1, ls, body=body)["smem"] \
                <= SMEM_LIMIT
    for b, ls in ((1, tca.MAX_FAST_LS + 1), (65536, 10), (0, 10), (1, 0)):
        with pytest.raises(ValueError):
            tca.combine_copy_mass_plan(b, ls)
    with pytest.raises(ValueError):
        tca.combine_copy_mass_plan(1, 4097, body="sort")


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


def _zipf_row(rng, n, ranks=1000, vocab=30522):
    """n ids as text repeats them: Zipf ranks (exponent 1) over ``ranks``
    random vocabulary ids."""
    p = 1.0 / np.arange(1, ranks + 1)
    words = rng.choice(np.arange(4, vocab), ranks, replace=False)
    return words[rng.choice(ranks, n, p=p / p.sum())].astype(np.int32)


def _combine_card(b, ls, kind, seed, cuda):
    """bf16 copy mass and int32 ids on the card: Zipf ids with a padded
    tail of id 0 and weight 0 ("zipf"), one id ("equal"), every id
    distinct ("distinct"), a 500-long group of id 0 that carries weight
    ("pad500"), or Zipf ids spread up to 2^31 ("bigids": too large for the
    sort's 32-bit keys)."""
    rng = np.random.RandomState(seed)
    ids = np.zeros((b, ls), np.int32)
    for r in range(b):
        n = rng.randint(ls // 2, ls + 1)
        ids[r, :n] = _zipf_row(rng, n)
    if kind == "equal":
        ids[:] = 7
    if kind == "distinct":
        ids = np.tile(np.arange(ls, dtype=np.int32) * 3 + 1, (b, 1))
    if kind == "bigids":
        ids = (ids.astype(np.int64) * 70001 % 2147483000).astype(np.int32)
    cw = rng.rand(b, ls) * (ids != 0)
    if kind == "pad500":
        ids[:, 100:600] = 0
        cw[:, 100:600] = rng.rand(b, 500)
    cw = cw / cw.sum(-1, keepdims=True) * rng.uniform(0.2, 1.0, (b, 1))
    cw = torch.from_numpy(cw.astype(np.float32)).to(cuda)
    return cw.to(torch.bfloat16), torch.from_numpy(ids).to(cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("b,ls,kind,body", [
    (4, 1000, "equal", "sort"), (4, 1000, "distinct", "sort"),
    (4, 1060, "pad500", "sort"), (4, 1060, "bigids", "sort"),
    (64, 1060, "zipf", "sort"),
    (5, 77, "zipf", "brute"), (8, 3000, "zipf", "sort"),
    (2, 4097, "zipf", "brute"), (1, tca.MAX_FAST_LS, "zipf", "brute")])
def test_combine_bodies_match_plain(cuda, monkeypatch, b, ls, kind, body):
    """The planned body, and the other where it takes the row: within 1e-5
    of the row's mass of the plain version, every member of a group equal
    to the group's first member bit for bit, two launches equal bit for
    bit."""
    cw, ids = _combine_card(b, ls, kind, ls, cuda)
    assert tca.combine_copy_mass_plan(b, ls)["body"] == body
    ref = tca.combine_copy_mass_plain(cw, ids)
    mass = cw.float().sum(-1, keepdim=True)
    first = torch.empty(b, ls, dtype=torch.long, device=cuda)
    pos = torch.arange(ls, device=cuda)
    for r in range(b):             # each position's group's first position
        _, inv = torch.unique(ids[r], return_inverse=True)
        first[r] = torch.full((int(inv.max()) + 1,), ls, device=cuda
                              ).scatter_reduce(0, inv, pos, "amin")[inv]
    for forced in ("sort", "brute") if ls <= 4096 else ("brute",):
        monkeypatch.setattr(tca, "combine_copy_mass_launch",
                            lambda b_, l_: tca.combine_copy_mass_plan(
                                b_, l_, body=forced))
        before = tca.LAUNCHES
        got = tca.combine_copy_mass(cw, ids)
        again = tca.combine_copy_mass(cw, ids)
        torch.cuda.synchronize()
        assert tca.LAUNCHES == before + 2
        assert torch.equal(got, again)
        assert bool(((got - ref).abs() <= 1e-5 * mass).all())
        assert torch.equal(got, got.gather(1, first))
