"""The training-attention kernel module (case_rg_tpu_torch/kernels/
train_attention.py).

On the CPU the wrappers run their plain versions. These are held, in f32
with the same numpy dropout mask, against the JAX package's Pallas kernels
in interpret mode and against ``fused_train_mha_xla`` under ``jax.grad``, at
2e-6 (the bound tests/test_kernels.py holds the JAX kernel to); the autograd
Function's analytic backward against torch autograd of the plain forward at
1e-5; and the in-kernel-RNG variant against the caller-mask variant fed
``philox_keep_mask``, exactly. The Philox helper is held to the Random123
known-answer vectors of Philox4x32-10. ``train_mha_plan`` is held, at the
CaSE sites and the corners of the range, to the kernels' limits (a path,
shared memory, the short path where it fits, a grid that covers every key
tile), and a numpy emulation of the kernels' shared Philox draw (one draw
per query and 4-key group, words swapped between lanes) to
``philox_keep_mask``.

Tests marked ``cuda`` hold the CUDA kernels against their plain versions on
the card, in bf16 (forward within 4 and gradients within 8 bf16 ulps per
element, the limits chip_smoke.py states), at the CaSE training sites and
the plan's path boundaries, recover the in-kernel
mask with the JAX package's probe on the short and the long path, check
that two launches draw the same bits, and hold the plan's shared-memory
bytes to the kernels' own count. They skip without a card. They need
no JAX: on a card without it run them with the README's command.
"""

import numpy as np
import pytest
import torch

from case_rg_tpu_torch.kernels import train_attention as ta
from tests.test_torch_kernels import one_torch_thread  # noqa: F401

torch.set_float32_matmul_precision("highest")
RATE = 0.1


def _inputs(r, lq, lk, e, h, seed, rate=RATE):
    rng = np.random.RandomState(seed)
    q = rng.standard_normal((r, lq, e)).astype(np.float32)
    k = rng.standard_normal((r, lk, e)).astype(np.float32)
    v = rng.standard_normal((r, lk, e)).astype(np.float32)
    keep = rng.rand(r, lk) > 0.2
    keep[min(2, r - 1)] = False                        # an all-padding row
    mask = rng.rand(r, h, lq, lk) > rate
    return q, k, v, keep, mask


def _t(*arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad and a.dtype == np.float32)
            for a in arrays]


@pytest.mark.parametrize("r,lq,lk,e,h", [
    (6, 12, 12, 32, 4),
    (4, 5, 18, 32, 4),      # Lq != Lk: the teacher-forced cross-attention
])
def test_plain_matches_jax_kernel_and_xla(r, lq, lk, e, h):
    import jax
    import jax.numpy as jnp
    from case_rg_tpu.kernels.train_attention import (fused_train_mha as jk,
                                                     fused_train_mha_xla as jx)
    q, k, v, keep, mask = _inputs(r, lq, lk, e, h, seed=r + lk)
    jq, jkk, jv = (jnp.asarray(a) for a in (q, k, v))
    jkeep = jnp.asarray(keep)
    keepf = jkeep.astype(jnp.float32)[:, None, :]
    jmask = jnp.asarray(mask.astype(np.float32))
    out = ta.fused_train_mha_plain(*_t(q, k, v, keep, mask), h, RATE)
    ref_kernel = np.asarray(jk(jq, jkk, jv, keepf, jmask, h, RATE, True))
    ref_xla = np.asarray(jx(jq, jkk, jv, jkeep, jmask, h, RATE))
    np.testing.assert_allclose(out.numpy(), ref_kernel, rtol=0, atol=2e-6)
    np.testing.assert_allclose(out.numpy(), ref_xla, rtol=0, atol=2e-6)
    assert (out.numpy()[min(2, r - 1)] == 0).all()

    # gradients of sum(sin(out)): do = cos(out)
    do = torch.cos(out)
    grads = ta.fused_train_mha_plain_bwd(*_t(q, k, v, keep, mask), do, h,
                                         RATE)
    gk = jax.grad(lambda *a: jnp.sum(jnp.sin(jk(*a, keepf, jmask, h, RATE,
                                                True))),
                  argnums=(0, 1, 2))(jq, jkk, jv)
    gx = jax.grad(lambda *a: jnp.sum(jnp.sin(jx(*a, jkeep, jmask, h, RATE))),
                  argnums=(0, 1, 2))(jq, jkk, jv)
    for name, g, a, b in zip("qkv", grads, gk, gx):
        np.testing.assert_allclose(g.numpy(), np.asarray(a), rtol=0,
                                   atol=2e-6, err_msg=f"d{name} vs kernel")
        np.testing.assert_allclose(g.numpy(), np.asarray(b), rtol=0,
                                   atol=2e-6, err_msg=f"d{name} vs xla")


@pytest.mark.parametrize("rng_variant", [False, True])
def test_function_backward_matches_autograd_of_plain(rng_variant):
    r, lq, lk, e, h = 3, 7, 9, 16, 2
    q, k, v, keep, mask = _inputs(r, lq, lk, e, h, seed=5)
    tq, tk, tv = _t(q, k, v, grad=True)
    keep_t = torch.tensor(keep)
    if rng_variant:
        seed = torch.tensor([12345, 678], dtype=torch.int64)
        out = ta.fused_train_mha_rng(tq, tk, tv, keep_t, seed, h, RATE)
        mask_t = ta.philox_keep_mask(seed, r, h, lq, lk, RATE)
    else:
        mask_t = torch.tensor(mask)
        out = ta.fused_train_mha(tq, tk, tv, keep_t, mask_t, h, RATE)
    g = torch.autograd.grad(torch.sin(out).sum(), (tq, tk, tv))
    rq, rk, rv = _t(q, k, v, grad=True)
    ref = ta.fused_train_mha_plain(rq, rk, rv, keep_t, mask_t, h, RATE)
    np.testing.assert_array_equal(out.detach().numpy(), ref.detach().numpy())
    gr = torch.autograd.grad(torch.sin(ref).sum(), (rq, rk, rv))
    for name, a, b in zip("qkv", g, gr):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5,
                                   err_msg=f"d{name}")


def test_rng_variant_equals_mask_variant_fed_philox_mask():
    r, lq, lk, e, h = 4, 6, 11, 32, 4
    q, k, v, keep, _ = _inputs(r, lq, lk, e, h, seed=7)
    seed = torch.tensor([2 ** 32 - 1, 99], dtype=torch.int64)
    mask = ta.philox_keep_mask(seed, r, h, lq, lk, RATE)
    outs, grads = [], []
    for fn, src in ((ta.fused_train_mha_rng, seed), (ta.fused_train_mha, mask)):
        tq, tk, tv = _t(q, k, v, grad=True)
        out = fn(tq, tk, tv, torch.tensor(keep), src, h, RATE)
        outs.append(out.detach())
        grads.append(torch.autograd.grad(torch.sin(out).sum(), (tq, tk, tv)))
    assert torch.equal(outs[0], outs[1])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_philox_known_answers():
    """Random123's known-answer vectors for Philox4x32-10."""
    cases = [((0, 0, 0, 0), (0, 0),
              (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
             ((0xffffffff,) * 4, (0xffffffff,) * 2,
              (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
             ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
              (0xa4093822, 0x299f31d0),
              (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    t = lambda x: torch.tensor(x, dtype=torch.int64)
    for ctr, key, want in cases:
        got = ta.philox4x32(*map(t, ctr), *map(t, key))
        assert tuple(int(x) for x in got) == want


def test_philox_mask_is_a_function_of_its_indices():
    """The mask of a row does not depend on how many rows are drawn, its
    keep share is near 1 - rate, and another seed gives another mask."""
    seed = torch.tensor([7, 11], dtype=torch.int64)
    big = ta.philox_keep_mask(seed, 6, 4, 20, 50, 0.25)
    small = ta.philox_keep_mask(seed, 2, 4, 20, 50, 0.25)
    assert torch.equal(big[:2], small)
    assert abs(big.float().mean().item() - 0.75) < 0.02
    other = ta.philox_keep_mask(torch.tensor([8, 11]), 6, 4, 20, 50, 0.25)
    assert not torch.equal(big, other)
    assert ta.philox_keep_mask(seed, 2, 2, 3, 5, 0.0).all()


# ---- the launch plan (train_mha_plan) and the shared Philox draw ----

# (Lq, Lk, d) of the six CaSE training sites, then the corners of the range
PLAN_SITES = [(60, 60, 32), (100, 100, 32), (60, 60, 160), (100, 100, 160),
              (40, 60, 32), (40, 1000, 32)]
PLAN_CORNERS = [(lq, lk, d) for lq in (1, 16, 17, 128)
                for lk in (1, 128, 129, 4096) for d in (32, 160)]


@pytest.mark.parametrize("lq,lk,d", PLAN_SITES + PLAN_CORNERS)
def test_train_mha_plan(lq, lk, d):
    """The plan picks a path, every launch fits a block's shared memory,
    at most 128 keys take the short path where it fits, and the grid covers
    every (row, head) and key tile (the grid is (R, H, z))."""
    wq = -(-lq // 16)
    for rng in (False, True):
        plan = ta.train_mha_plan(lq, lk, d, rng)
        assert set(plan["path"].values()) <= {"short", "long"}
        for ln in plan["fwd"] + plan["bwd"]:
            assert 0 < ln.smem <= 232448
            assert ln.smem == ta._smem(ln.kind, lq, lk, d, ln.kt, ln.wk,
                                       ln.nbuf, rng)
            assert 1 <= ln.warps <= 8 and ln.warps == wq * ln.wk
            if ln.kind == "bwd_keys":          # a block per 64-key tile
                assert ln.z * ln.kt >= lk > (ln.z - 1) * ln.kt
            else:                              # a block holds or sweeps all
                assert ln.z == 1
            if ln.kind.endswith("short"):
                assert lk <= ln.kt <= 128
        short_bwd = ta._smem("bwd_short", lq, lk, d,
                             next(n for n in (64, 112, 128) if lk <= n), 1, 1,
                             rng) if lk <= 128 else None
        assert plan["path"]["fwd"] == ("short" if lk <= 128 else "long")
        assert plan["path"]["bwd"] == (
            "short" if short_bwd is not None and short_bwd <= 232448
            else "long")
        kinds = [ln.kind for ln in plan["bwd"]]
        assert kinds == (["bwd_short"] if plan["path"]["bwd"] == "short"
                         else ["bwd_rows", "bwd_keys"])
    # the one shape of the range whose short backward does not fit
    assert ta.train_mha_plan(128, 128, 160)["path"]["bwd"] == "long"
    assert ta.train_mha_plan(100, 100, 160, False)["path"]["bwd"] == "short"
    # shared memory for one key tile only: the backward rows pass of d = 160
    # at 128 x 4096 (a SITES shape on the card), two tiles elsewhere
    for rng in (False, True):
        assert ta.train_mha_plan(128, 4096, 160, rng)["bwd"][0].nbuf == 1
        assert ta.train_mha_plan(40, 1000, 32, rng)["bwd"][0].nbuf == 2


def _keep_rows(words, thresh, i0, j0, rows_drawn):
    """numpy emulation of the kernel's keep_rows for one 16 x 16 step (rows
    = queries i0.., columns = keys j0..): each lane (gid, tig) draws Philox
    group (j0 + 8n) / 4 + tig // 2 of query i0 + gid + 8 (tig & 1) for
    n = 0, 1, and lanes tig, tig ^ 1 swap two words with one shuffle.
    ``words(group, query)`` gives the four u32 words. Returns the [16, 16]
    tile of keep bits the lanes hold, in the accumulator layout."""
    mine = np.zeros(32, np.uint32)
    for lane in range(32):
        gid, tig = lane >> 2, lane & 3
        odd = tig & 1
        for n in range(2):
            grp, i = (j0 + 8 * n) // 4 + (tig >> 1), i0 + gid + 8 * odd
            rows_drawn.append((i, grp))
            w = words(grp, i)
            bits4 = sum(int(w[b] < thresh) << b for b in range(4))
            mine[lane] |= bits4 << (4 * n)
    send = np.array([(m & 0x33) if (lane & 1) else ((m >> 2) & 0x33)
                     for lane, m in enumerate(mine)], np.uint32)
    tile = np.zeros((16, 16), bool)
    for lane in range(32):
        gid, tig = lane >> 2, lane & 3
        odd, recv = tig & 1, int(send[lane ^ 1])
        for n in range(2):
            lo = ((recv if odd else int(mine[lane])) >> (4 * n)) & 3
            hi = ((int(mine[lane]) >> (4 * n + 2)) if odd
                  else (recv >> (4 * n))) & 3
            nib = lo | hi << 2
            for x in range(4):
                tile[gid + 8 * (x >> 1), 8 * n + 2 * tig + (x & 1)] = \
                    (nib >> x) & 1
    return tile


@pytest.mark.parametrize("i0,j0", [(0, 0), (16, 48), (96, 992)])
def test_shared_philox_draw_assignment(i0, j0):
    """One Philox draw per (query, 4-key group) of a 16 x 16 step, and the
    words the lanes keep after the shuffle are philox_keep_mask's tile."""
    seed = torch.tensor([0x243F6A88, 1234], dtype=torch.int64)
    r, h, rate = 3, 5, 0.3
    thresh = ta.keep_threshold(rate)

    def words(grp, i):
        t = lambda x: torch.tensor(x, dtype=torch.int64)
        return [int(w) for w in ta.philox4x32(t(grp), t(i), t(h), t(r),
                                              seed[0], seed[1])]

    drawn = []
    tile = _keep_rows(words, thresh, i0, j0, drawn)
    want = {(i0 + a, j0 // 4 + g) for a in range(16) for g in range(4)}
    assert sorted(drawn) == sorted(want)          # each group exactly once
    mask = ta.philox_keep_mask(seed, r + 1, h + 1, i0 + 16, j0 + 16, rate)
    np.testing.assert_array_equal(tile, mask[r, h, i0:, j0:].numpy())


# ---- on the card: each CUDA kernel against its plain version (bf16) ----

# the six CaSE sites (fewer rows), then the plan's boundaries: 128 and 129
# keys, 1 and 128 queries, d = 160 at 128 x 128, whose backward leaves the
# short path, and d = 160 at 128 x 4096, whose backward rows pass holds one
# key tile at a time
SITES = [(8, 60, 60, 256), (16, 100, 100, 256), (4, 60, 60, 1280),
         (4, 100, 100, 1280), (8, 40, 60, 256), (4, 40, 1000, 256),
         (4, 60, 128, 256), (4, 60, 129, 256), (4, 1, 100, 256),
         (4, 128, 300, 256), (3, 128, 128, 1280), (3, 128, 4096, 1280)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    saved = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = saved


def _ulps(out, ref):
    """Max |out - ref| in bf16 ulps, element by element, at the larger of
    the element's magnitude and its row's RMS (rows along the last dim)."""
    o, r = out.float(), ref.float()
    rms = r.square().mean(-1, keepdim=True).sqrt()
    mag = torch.maximum(r.abs(), rms).clamp_min(2.0 ** -100)
    return ((o - r).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)
            ).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("rng_variant", [False, True])
@pytest.mark.parametrize("r,lq,lk,e", SITES)
def test_kernels_match_plain(cuda, r, lq, lk, e, rng_variant):
    h = 8
    q, k, v, keep, mask = _inputs(r, lq, lk, e, h, seed=lk)
    q, k, v = (torch.tensor(a, device=cuda).to(torch.bfloat16)
               for a in (q, k, v))
    keep = torch.tensor(keep, device=cuda)
    src = (torch.tensor([3, 4], dtype=torch.int64, device=cuda) if rng_variant
           else torch.tensor(mask, device=cuda))
    mask = ta.philox_keep_mask(src, r, h, lq, lk, RATE) if rng_variant \
        else src
    variant = "rng" if rng_variant else "mask"
    f0, b0 = ta.LAUNCHES_FWD[variant], ta.LAUNCHES_BWD[variant]
    fn = ta.fused_train_mha_rng if rng_variant else ta.fused_train_mha
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fn(*xs, keep, src, h, RATE)
    do = torch.randn(out.shape, device=cuda).to(torch.bfloat16)
    grads = torch.autograd.grad(out, xs, do)
    torch.cuda.synchronize()
    assert (ta.LAUNCHES_FWD[variant], ta.LAUNCHES_BWD[variant]) == (f0 + 1,
                                                                    b0 + 1)
    ref = ta.fused_train_mha_plain(q, k, v, keep, mask, h, RATE)
    assert _ulps(out, ref) <= 4
    ref_g = ta.fused_train_mha_plain_bwd(q, k, v, keep, mask, do, h, RATE)
    for g, rg in zip(grads, ref_g):
        assert _ulps(g, rg) <= 8
    assert (out[2] == 0).all() and all((g[2] == 0).all() for g in grads)


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk,e,path", [(12, 32, 256, "short"),
                                          (40, 200, 256, "long"),
                                          (20, 60, 1280, "short")])
def test_rng_kernel_mask_recovered_by_probe(cuda, lq, lk, e, path):
    """q = 0 makes the probabilities uniform; v's lanes of each head are
    basis vectors over a chunk of d keys, so the output is the dropped
    probability row: its nonzeros are the kernel's mask, which must equal
    philox_keep_mask bit for bit, on the short and the long path. Two
    launches with one seed agree."""
    r, h = 6, 8
    d = e // h
    assert ta.train_mha_plan(lq, lk, d)["path"]["fwd"] == path
    seed = torch.tensor([0xDEADBEEF, 17], dtype=torch.int64, device=cuda)
    z = torch.zeros(r, lq, e, dtype=torch.bfloat16, device=cuda)
    zk = torch.zeros(r, lk, e, dtype=torch.bfloat16, device=cuda)
    got = torch.empty(r, h, lq, lk, dtype=torch.bool, device=cuda)
    for c0 in range(0, lk, d):
        n = min(d, lk - c0)
        v = torch.zeros(r, lk, e, device=cuda)
        for hh in range(h):
            v[:, c0:c0 + n, hh * d:hh * d + n] = torch.eye(n, device=cuda)
        v = v.to(torch.bfloat16)
        out = ta.fused_train_mha_rng(z, zk, v, None, seed, h, 0.25)
        again = ta.fused_train_mha_rng(z, zk, v, None, seed, h, 0.25)
        assert torch.equal(out, again)
        for hh in range(h):
            got[:, hh, :, c0:c0 + n] = out[:, :, hh * d:hh * d + n] != 0
    assert torch.equal(got, ta.philox_keep_mask(seed, r, h, lq, lk, 0.25))


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lk,d", PLAN_SITES + PLAN_CORNERS)
def test_plan_smem_matches_kernel_layout(cuda, lq, lk, d):
    """The plan's shared-memory bytes are the kernels' own count
    (train_mha_smem_need), for every launch, both mask sources."""
    lib = ta._lib()
    for rng in (False, True):
        plan = ta.train_mha_plan(lq, lk, d, rng)
        for ln in plan["fwd"] + plan["bwd"]:
            assert ln.smem == lib.train_mha_smem_need(
                ta._KINDS.index(ln.kind), lq, lk, d, ln.kt, ln.wk, ln.nbuf,
                int(rng))
