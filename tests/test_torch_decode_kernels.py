"""The port's decode-attention and additive-attention kernels
(case_rg_tpu_torch/kernels/decode_attention.py, additive_attention.py).

On the CPU the wrappers run their plain PyTorch versions; these are held
against the JAX package in f32 at 1e-5 (the gradients at 1e-5 absolute
and relative): ``single_query_mha_plain`` against
``single_query_mha_xla`` and the Pallas kernel in interpret mode (L = 600
crosses its 512-key tile; one row has no valid key), and
``additive_scores`` forward and gradients against the JAX
``additive_scores`` in interpret mode and ``jax.grad`` through its custom
VJP (L = 130 crosses its 128-key tile). A strided view of a packed K|V
cache gives what contiguous K and V give, and on the CPU both routing
switches run the plain versions.

Tests marked ``cuda`` hold each CUDA kernel against its plain version on
the card, in bf16 ulps per element (the limits chip_smoke.py states), and
skip without one.
"""

import numpy as np
import pytest
import torch

from case_rg_tpu_torch.kernels import additive_attention as taa
from case_rg_tpu_torch.kernels import decode_attention as tda
from case_rg_tpu_torch.ops import attention, bilinear
from case_rg_tpu_torch.ops.attention import MultiHeadAttention
from case_rg_tpu_torch.ops.bilinear import BilinearAttention
from tests.test_torch_kernels import (_bf16_close, cuda,  # noqa: F401
                                      one_torch_thread)

torch.set_float32_matmul_precision("highest")
# per element, in bf16 ulps at the larger of the element's magnitude and its
# row's RMS: the limits chip_smoke.py holds the kernels to
SQ_ULPS = 2
ADD_FWD_ULPS = 2
ADD_BWD_ULPS = 4


@pytest.fixture(scope="module")
def jx():
    import types
    import jax
    import jax.numpy as jnp
    from case_rg_tpu.kernels import additive_attention, decode_attention
    return types.SimpleNamespace(jax=jax, jnp=jnp, aa=additive_attention,
                                 da=decode_attention)


def _sq_inputs(b, l, e, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, 1, e).astype(np.float32)
    k, v = (rng.randn(b, l, e).astype(np.float32) for _ in range(2))
    keep = rng.rand(b, l) > 0.3
    keep[1] = False                               # a row with no valid key
    return q, k, v, keep


@pytest.mark.parametrize("l", [5, 37, 600])
def test_single_query_mha_plain_matches_jax(jx, l):
    b, e, h = 3, 32, 4
    q, k, v, keep = _sq_inputs(b, l, e, seed=l)
    before = tda.LAUNCHES
    got = tda.single_query_mha(*map(torch.from_numpy, (q, k, v, keep)), h)
    assert tda.LAUNCHES == before
    want_xla = jx.da.single_query_mha_xla(*map(jx.jnp.asarray,
                                               (q, k, v, keep)), h)
    want_pallas = jx.da.single_query_mha(*map(jx.jnp.asarray,
                                              (q, k, v, keep)), h, True)
    for want in (want_xla, want_pallas):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
    assert (got[1] == 0).all()


def test_single_query_mha_reads_a_packed_cache_in_place():
    """K and V as the two halves of a packed [B, T, 2E] cache (row stride
    2E) give what contiguous copies give, in the wrapper and through the
    decode attention."""
    b, t, e, h = 3, 9, 32, 4
    rng = np.random.RandomState(4)
    cache = torch.from_numpy(rng.randn(b, t, 2 * e).astype(np.float32))
    q = torch.from_numpy(rng.randn(b, 1, e).astype(np.float32))
    keep = torch.from_numpy(rng.rand(b, t) > 0.4)
    k, v = cache[..., :e], cache[..., e:]
    assert k.stride() == (t * 2 * e, 2 * e, 1)
    got = tda.single_query_mha(q, k, v, keep, h)
    want = tda.single_query_mha(q, k.contiguous(), v.contiguous(), keep, h)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    mha = MultiHeadAttention(e, h)
    torch.nn.init.normal_(mha.in_proj_weight, std=0.2)
    with torch.no_grad():
        a, _ = mha.attend_with_kv_merged(q, k, v, key_keep=keep)
        c, _ = mha.attend_with_kv_merged(q, k.contiguous(), v.contiguous(),
                                         key_keep=keep)
    np.testing.assert_array_equal(a.numpy(), c.numpy())


def _add_inputs(b, t, l, h, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, t, h).astype(np.float32),
            rng.randn(b, l, h).astype(np.float32),
            rng.randn(h).astype(np.float32),
            rng.randn(b, t, l).astype(np.float32))


def test_additive_scores_plain_and_grads_match_jax(jx):
    """Forward against the interpret-mode Pallas kernel and _scores_xla;
    the gradients of sum(s * g) against jax.grad through the custom VJP."""
    jnp = jx.jnp
    wq, uh, v, g = _add_inputs(2, 3, 130, 16, seed=0)
    xs = [torch.from_numpy(a).requires_grad_() for a in (wq, uh, v)]
    before = (taa.LAUNCHES, taa.LAUNCHES_BWD)
    out = taa.additive_scores(*xs)
    grads = torch.autograd.grad(out, xs, torch.from_numpy(g))
    assert (taa.LAUNCHES, taa.LAUNCHES_BWD) == before
    ja = [jnp.asarray(a) for a in (wq, uh, v)]
    for want in (jx.aa.additive_scores(*ja, True), jx.aa._scores_xla(*ja)):
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=1e-5)
    want_g = jx.jax.grad(
        lambda a, b_, c: jnp.sum(jx.aa.additive_scores(a, b_, c, True)
                                 * jnp.asarray(g)), argnums=(0, 1, 2))(*ja)
    # dv sums B*T*L = 780 terms of magnitude ~40: held at 1e-5 relative too
    for got, want in zip(grads, want_g):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_routing_switches_run_the_plain_versions_on_the_cpu():
    """Forced on, both routes run their plain versions on CPU tensors (no
    launch) and agree with the dense paths; auto keeps the CPU dense."""
    torch.manual_seed(0)
    mha = MultiHeadAttention(32, 4)
    torch.nn.init.normal_(mha.in_proj_weight, std=0.2)
    att = BilinearAttention(32, 32, 16)
    q, kv = torch.randn(3, 1, 32), torch.randn(3, 7, 32)
    keep = torch.rand(3, 7) > 0.3
    uh = att.key_proj(kv)
    assert not attention._single_query_ok(q)
    assert not bilinear._additive_kernel_ok(q.new_zeros(3, 1, 16), uh)
    outs = {}
    before = (tda.LAUNCHES, taa.LAUNCHES)
    try:
        for on in (True, False):
            attention.set_single_query_attention(on)
            bilinear.set_additive_kernel(on)
            assert attention._single_query_ok(q) == on
            with torch.no_grad():
                outs[on] = (mha.attend_with_kv_merged(q, kv, kv,
                                                      key_keep=keep)[0],
                            att.matching_from_proj(q, uh))
    finally:
        attention.set_single_query_attention(None)
        bilinear.set_additive_kernel(None)
    assert (tda.LAUNCHES, taa.LAUNCHES) == before
    for a, b_ in zip(outs[True], outs[False]):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=0, atol=1e-6)


def test_decode_paths_hand_the_kernel_views_it_reads_in_place(monkeypatch):
    """With the route forced on, every single-query attention of a greedy,
    beam and sampled CaSE decode passes the kernel's layout check (the
    query third of a packed QKV projection, the halves of the packed K|V
    cache), so on the card no call copies or raises."""
    from case_rg_tpu_torch.config import ModelConfig
    from case_rg_tpu_torch.models import create_model
    from case_rg_tpu_torch.runtime.inference import make_predict_fn
    cfg = ModelConfig(name="case", vocab_size=64, embedding_size=16,
                      hidden_size=16, num_heads=2, enc_layers=1,
                      dec_layers=2, max_dec_len=5)
    model = create_model("case", cfg, device="cpu")
    rng = np.random.RandomState(0)
    batch = {"query": rng.randint(4, 64, (3, 1, 6)).astype(np.int32),
             "passage": rng.randint(4, 64, (3, 2, 7)).astype(np.int32)}
    seen = []

    def spy(q, k, v, keep, num_heads):
        tda.check_layout(q, k, v, keep)
        seen.append(k.is_contiguous())
        return tda.single_query_mha_plain(q, k, v, keep, num_heads)

    monkeypatch.setattr(attention, "single_query_mha", spy)
    try:
        attention.set_single_query_attention(True)
        for kw in ({}, {"beam_width": 2}, {"decoding": "sample"}):
            make_predict_fn(model, cfg, 5, device="cpu", **kw)(batch)
    finally:
        attention.set_single_query_attention(None)
    # 3 decodes x 5 steps x 2 stacks x 2 layers x (self + cross)
    assert len(seen) == 120
    assert not all(seen), "no strided cache view reached the kernel"


def test_plain_decode_attention_moves_nothing_from_the_host():
    """The dense path of the decode attention copies no host tensor to the
    device: a blocking copy would synchronise the stream in every decode
    step (the scale was once a 0-dim CPU tensor moved per call). Run on
    meta tensors, every copy between devices shows in the dispatch log."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Copies(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            ins = [a for a in args if isinstance(a, torch.Tensor)]
            if isinstance(out, torch.Tensor) and any(
                    a.device != out.device for a in ins):
                self.seen.append(str(func))
            return out

    q = torch.empty(3, 1, 32, device="meta", dtype=torch.bfloat16)
    kv = torch.empty(3, 9, 32, device="meta", dtype=torch.bfloat16)
    keep = torch.empty(3, 9, device="meta", dtype=torch.bool)
    with Copies() as mode:
        tda.single_query_mha_plain(q, kv, kv, keep, 4)
    assert not mode.seen, mode.seen


# ---- the kernel's launch plan (pure Python) ----

SMEM_LIMIT = 232448       # bytes of shared memory a block may use on sm_90


@pytest.mark.parametrize("d", [32, 64, 8])
@pytest.mark.parametrize("l", [1, 32, 33, 40, 60, 64, 65, 600, 1000])
def test_single_query_mha_plan(l, d):
    """A warp a (row, head) while a warp's lanes hold every key (8 keys a
    lane, 256 / d keys a pass: 64 at d = 32, so every decode shape), else a
    block a (row, head) with the row's f32 scores in shared memory; the
    layout does not depend on the batch."""
    for b in (64, 256):
        plan = tda.single_query_mha_plan(b, l, d)
        warp = l <= 8 * 256 // d
        assert plan["layout"] == ("warp" if warp else "block")
        assert plan["smem"] == (0 if warp else 4 * (5 * d + l + 4))
        assert plan["smem"] <= SMEM_LIMIT and plan["threads"] == 128


def test_single_query_mha_plan_takes_every_shape_the_wrapper_takes():
    """Every head width the wrapper takes, up to the longest L a block's
    shared memory holds, is planned onto a kernel (no plain fallback);
    longer rows, other widths and a forced layout that cannot hold the
    keys are refused."""
    for d in (8, 16, 32, 64, 128, 256):
        longest = SMEM_LIMIT // 4 - 5 * d - 4
        for l in (1, 8 * 256 // d, 8 * 256 // d + 1, 1000, longest):
            assert tda.single_query_mha_plan(1, l, d)["smem"] <= SMEM_LIMIT
            assert tda.single_query_mha_plan(
                1, l, d, layout="block")["layout"] == "block"
        with pytest.raises(ValueError):
            tda.single_query_mha_plan(1, longest + 1, d)
        with pytest.raises(ValueError):
            tda.single_query_mha_plan(1, 8 * 256 // d + 1, d, layout="warp")
    for d in (4, 24, 48, 512):
        with pytest.raises(ValueError):
            tda.single_query_mha_plan(1, 60, d)


@pytest.mark.parametrize("b,t,l,keys,bwd,cluster", [
    (64, 1, 1000, 8, "partials", (8, 1)),
    (64, 1, 60, 4, "cluster", (1, 1)),
    (256, 1, 1000, 8, "partials", (8, 1)),
    (64, 40, 1000, 8, "partials", (8, 1)),
    (64, 40, 60, 8, "cluster", (1, 3)),
    (64, 40, 500, 8, "cluster", (8, 1)),
    (64, 40, 3000, 8, "partials", (8, 1)),
    (8, 100, 1000, 8, "partials", (8, 1)),
])
def test_additive_scores_plan(b, t, l, keys, bwd, cluster):
    """The forward a warp 8 keys of a query row where that still gives 16
    warps an SM, else 4, at every T; the backward in one cluster a row up
    to 8 key tiles of 64 (the 60-key memory splits its queries over the
    cluster instead), in partials beyond; every grid covers the shape and
    every block fits."""
    plan = taa.additive_scores_plan(b, t, l, 256)
    f, w = plan["fwd"], plan["bwd"]
    assert (f["keys_a_warp"], w["layout"], w["cluster"]) == (keys, bwd,
                                                             cluster)
    assert f["grid"][0] == b * t
    assert f["grid"][1] * 4 * f["keys_a_warp"] >= l
    gx, split, gz = w["grid"]
    assert gz == b and gx * 64 >= l and gx % w["cluster"][0] == 0
    assert split * w["queries_a_block"] >= t and w["chunk"] <= 48
    assert 2 * (w["smem"] + 1024) <= 228 * 1024      # two blocks an SM
    assert w["cluster"][0] * w["cluster"][1] <= 16
    assert w["smem"] <= SMEM_LIMIT
    assert w["clusters"] == gx // w["cluster"][0] * b


def test_additive_scores_plan_refuses_what_no_layout_takes():
    for h in (264, 12, 4, 0):
        with pytest.raises(ValueError):
            taa.additive_scores_plan(64, 1, 60, h)
    for shape in ((0, 1, 60, 256), (65536, 1, 60, 256), (64, 0, 60, 256),
                  (64, 1, 0, 256)):
        with pytest.raises(ValueError):
            taa.additive_scores_plan(*shape)
    with pytest.raises(ValueError):       # 47 key tiles: beyond a cluster
        taa.additive_scores_plan(64, 40, 3000, 256, bwd="cluster")
    with pytest.raises(ValueError):
        taa.additive_scores_plan(64, 40, 60, 256, bwd="dense")
    with pytest.raises(ValueError):       # 93750 forward block rows > 65535
        taa.additive_scores_plan(1, 1, 3_000_000, 256)
    for h in (8, 16, 24, 128, 256):       # every width the kernels take
        for t, l in ((1, 1), (40, 60), (100, 3000)):
            taa.additive_scores_plan(3, t, l, h)
            taa.additive_scores_plan(3, t, l, h, bwd="partials")


def test_shared_memory_limits_are_raised_only_through_allow_smem():
    """Every kernel source raises a kernel's shared-memory (and cluster)
    limit through sm90.cuh's allow_smem, once per process, device and
    kernel: cudaFuncSetAttribute appears nowhere else under csrc/."""
    import pathlib
    import re
    csrc = pathlib.Path(taa.__file__).resolve().parent.parent / "csrc"
    found = {}
    for path in sorted(csrc.glob("*.cu*")):
        text = path.read_text()
        n = len(re.findall(r"cudaFuncSetAttribute\s*\(", text))
        if n:
            found[path.name] = n
    assert set(found) == {"sm90.cuh"}, found
    text = (csrc / "sm90.cuh").read_text()
    body = text[text.index("inline cudaError_t allow_smem("):]
    body = body[:body.index("\n}\n")]
    assert len(re.findall(r"cudaFuncSetAttribute\s*\(", body)) \
        == found["sm90.cuh"]
    for path in sorted(csrc.glob("*.cu")):
        if "allow_smem(" in path.read_text():
            assert '#include "sm90.cuh"' in path.read_text()


# ---- on the card: each CUDA kernel against its plain version (bf16) ----

@pytest.mark.cuda
@pytest.mark.parametrize("b,l,e,h,packed", [
    (64, 1000, 256, 8, False), (64, 60, 256, 8, False),
    (64, 40, 256, 8, True), (256, 60, 256, 8, False), (5, 600, 64, 2, True),
])
def test_single_query_mha_kernel_matches_plain(cuda, b, l, e, h, packed):
    q, k, v, keep = _sq_inputs(b, l, e, seed=l)
    q = torch.from_numpy(q).to(cuda).to(torch.bfloat16)
    if packed:                 # q: the first third of a packed projection
        q = torch.cat([q, torch.zeros_like(q), torch.zeros_like(q)],
                      -1)[..., :e]
        cache = torch.from_numpy(np.concatenate([k, v], -1)).to(cuda)
        cache = cache.to(torch.bfloat16)
        k, v = cache[..., :e], cache[..., e:]
    else:
        k, v = (torch.from_numpy(x).to(cuda).to(torch.bfloat16)
                for x in (k, v))
    keep = torch.from_numpy(keep).to(cuda)
    before = tda.LAUNCHES
    out = tda.single_query_mha(q, k, v, keep, h)
    torch.cuda.synchronize()
    assert tda.LAUNCHES == before + 1
    ref = tda.single_query_mha_plain(q, k, v, keep, h)
    _bf16_close(out, ref, ulps=SQ_ULPS)
    assert (out[1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,l,h", [
    (64, 1, 1000, 256), (64, 40, 60, 256), (4, 40, 1000, 256),
    (3, 5, 37, 16), (256, 1, 1000, 256), (64, 40, 3000, 256),
    (8, 100, 1000, 256), (3, 5, 37, 8),
])
def test_additive_scores_kernels_match_plain(cuda, monkeypatch, b, t, l, h):
    """The forward, and every backward layout that takes the shape (the
    beam's 256 rows, a row beyond one cluster's keys, T beyond one chunk,
    narrow H): within the stated ulps of the plain versions; two backward
    runs equal bit for bit."""
    wq, uh, v, g = (torch.from_numpy(a).to(cuda).to(torch.bfloat16)
                    for a in _add_inputs(b, t, l, h, seed=t))
    want = taa.additive_scores_plain(wq, uh, v)
    want_g = taa.additive_scores_plain_bwd(wq, uh, v, g)
    xs = [x.clone().requires_grad_() for x in (wq, uh, v)]
    ran = []
    for bwd in ("cluster", "partials"):
        try:
            taa.additive_scores_plan(b, t, l, h, bwd)
        except ValueError:
            continue
        monkeypatch.setattr(
            taa, "additive_scores_launch",
            lambda b_, t_, l_, h_, w=bwd:
            taa.additive_scores_plan(b_, t_, l_, h_, w))
        before = (taa.LAUNCHES, taa.LAUNCHES_BWD)
        out = taa.additive_scores(*xs)
        grads = torch.autograd.grad(out, xs, g)
        again = torch.autograd.grad(taa.additive_scores(*xs), xs, g)
        torch.cuda.synchronize()
        assert (taa.LAUNCHES, taa.LAUNCHES_BWD) == (before[0] + 2,
                                                    before[1] + 2)
        _bf16_close(out, want, ADD_FWD_ULPS)
        for got, ref in zip(grads, want_g):
            _bf16_close(got, ref, ADD_BWD_ULPS)
        assert all(torch.equal(a, b_) for a, b_ in zip(grads, again))
        ran.append(bwd)
    assert ran


def _sq_card(b, l, e, seed, cuda, packed=False, masked=(1,)):
    """bf16 inputs on the card: q (a third of a packed projection where
    ``packed``), K and V (the halves of a packed cache where ``packed``),
    keep with random lengths and the rows ``masked`` all masked."""
    rng = np.random.RandomState(seed)
    q = torch.from_numpy(rng.randn(b, 1, e).astype(np.float32)).to(cuda)
    q = q.to(torch.bfloat16)
    kv = torch.from_numpy(rng.randn(b, l, 2 * e).astype(np.float32))
    kv = kv.to(cuda).to(torch.bfloat16)
    if packed:
        q = torch.cat([q, q, q], -1)[..., :e]
        k, v = kv[..., :e], kv[..., e:]
    else:
        k, v = kv[..., :e].contiguous(), kv[..., e:].contiguous()
    lengths = torch.from_numpy(rng.randint(1, l + 1, b)).to(cuda)
    keep = torch.arange(l, device=cuda)[None, :] < lengths[:, None]
    keep[list(masked)] = False
    return q, k, v, keep


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,e,h,packed,layout", [
    (64, 1, 256, 8, False, "warp"), (64, 33, 256, 8, False, "warp"),
    (64, 60, 256, 8, False, "warp"), (64, 40, 256, 8, True, "warp"),
    (256, 60, 256, 8, False, "warp"), (64, 65, 256, 8, False, "block"),
    (64, 1000, 256, 8, False, "block"), (7, 200, 64, 8, True, "warp"),
    (7, 30, 512, 8, False, "warp"), (7, 16, 1024, 8, False, "warp"),
    (7, 8, 2048, 8, False, "warp"), (7, 60, 1024, 8, False, "block"),
])
def test_single_query_mha_layouts_match_plain(cuda, monkeypatch, b, l, e, h,
                                              packed, layout):
    """The planned layout at the decode shapes and corners (L across the
    warp layout's edge at 64, head widths 8 to 256), and the other layout
    wherever it takes the shape: within the stated ulps of the plain
    version, exact zeros on all-masked rows, two launches equal bit for
    bit."""
    q, k, v, keep = _sq_card(b, l, e, l, cuda, packed, masked=(1, b - 1))
    assert tda.single_query_mha_plan(b, l, e // h)["layout"] == layout
    ref = tda.single_query_mha_plain(q, k, v, keep, h)
    outs = {}
    for lay in ("warp", "block"):
        try:
            tda.single_query_mha_plan(b, l, e // h, layout=lay)
        except ValueError:
            continue
        monkeypatch.setattr(tda, "single_query_mha_launch",
                            lambda b_, l_, d_: tda.single_query_mha_plan(
                                b_, l_, d_, layout=lay))
        before = tda.LAUNCHES
        out = tda.single_query_mha(q, k, v, keep, h)
        again = tda.single_query_mha(q, k, v, keep, h)
        torch.cuda.synchronize()
        assert tda.LAUNCHES == before + 2
        assert torch.equal(out, again)
        _bf16_close(out, ref, ulps=SQ_ULPS)
        assert (out[1] == 0).all() and (out[b - 1] == 0).all()
        outs[lay] = out
    assert layout in outs
