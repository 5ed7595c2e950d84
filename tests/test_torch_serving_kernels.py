"""The serving kernels of the port as redesigned for Hopper (fused_mha in
csrc/encoder_attention.cu, stack_step in csrc/decoder_stack.cu), their
launch plans, and the step loops' freedom from host synchronisation.

On the CPU: ``fused_mha_plan`` and ``stack_step_plan`` at the served sites
and at their corners (shared memory within a block's 232,448 bytes, the
longest memory the first stack kernel took, the one-wave rule), and the
two scales that were built on the host every call (the positional
embedding's sqrt(d), ``attend``'s 1/sqrt(d)) are now Python floats: no
tensor is built or copied per call, and the values are unchanged.

Tests marked ``cuda`` hold each kernel against its plain version on the
card (bf16 ulps per element, the limits chip_smoke.py states), check that
two launches give identical bits, and run a greedy decode step, a
``decode_chunk`` and a train step under ``no_host_sync`` (any operation
that makes the host wait on the card raises). They skip without a card.
"""

import numpy as np
import pytest
import torch

from case_rg_tpu_torch.kernels import decoder_stack as tds
from case_rg_tpu_torch.kernels import encoder_attention as tea
from case_rg_tpu_torch.ops import attention, positional
from tests.test_torch_kernels import (_bf16_close, _mha_inputs,  # noqa: F401
                                      cuda, one_torch_thread)

SMEM_LIMIT = 232448     # bytes of shared memory one block may use on sm_90
MHA_ULPS = 4
STACK_ULPS = 16


# ---- the per-call host tensors are gone ----

def test_positional_scale_builds_no_tensor_per_call(monkeypatch):
    """sqrt(d) rounded to x's dtype is a Python float built once per dtype:
    a 0-dim tensor made on the card every call is a blocking copy, a
    synchronisation of the stream in every decode step."""
    pe = positional.PositionalEmbedding(24)
    x32 = torch.from_numpy(np.random.RandomState(0).randn(2, 5, 24)
                           .astype(np.float32))
    offset = torch.tensor([0, 3])
    for dtype in (torch.float32, torch.bfloat16):
        x = x32.to(dtype)
        table = pe.table.to(dtype)
        scale = torch.tensor(np.sqrt(24), dtype=dtype)
        want = [x * scale + table[:5],
                x * scale + table[torch.tensor([[0, 1, 2, 3, 4],
                                                [3, 4, 5, 6, 7]])]]
        pe(x)                     # the first call of a dtype may build it
        built = []
        real = torch.tensor
        monkeypatch.setattr(torch, "tensor",
                            lambda *a, **k: built.append(a) or real(*a, **k))
        got = [pe(x), pe(x, offset=offset)]
        monkeypatch.undo()
        assert built == []
        for g, w in zip(got, want):
            assert g.dtype == dtype and torch.equal(g, w)


class _Copies:
    """Records every op whose output lies on another device than an input:
    on meta tensors, each host-to-device copy shows here."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        seen = self.seen = []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                ins = [a for a in args if isinstance(a, torch.Tensor)]
                if isinstance(out, torch.Tensor) and any(
                        a.device != out.device for a in ins):
                    seen.append(str(func))
                return out

        self.mode = Mode()


def test_attend_moves_nothing_from_the_host():
    """``attend`` (the teacher-forced decoders' causal self-attention, 8
    calls a train step) copies no host tensor to the device: its scale was
    a CPU tensor moved on every call. The value is unchanged."""
    q = torch.empty(2, 4, 3, 8, device="meta", dtype=torch.bfloat16)
    kv = torch.empty(2, 4, 5, 8, device="meta", dtype=torch.bfloat16)
    bias = torch.empty(3, 5, device="meta")
    keep = torch.empty(2, 5, device="meta", dtype=torch.bool)
    rec = _Copies()
    with rec.mode:
        attention.attend(q, kv, kv, attn_bias=bias, key_keep=keep)
    assert not rec.seen, rec.seen
    rng = np.random.RandomState(1)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.from_numpy(rng.randn(2, 4, n, 8).astype(np.float32))
                   .to(dtype) for n in (3, 5, 5))
        scale = torch.tensor(1.0 / np.sqrt(np.float32(8)),
                             dtype=torch.float32).to(dtype)
        s = torch.matmul((q * scale).float(), k.float().transpose(-1, -2))
        want = torch.matmul(torch.softmax(s, -1).to(dtype), v)
        got, _ = attention.attend(q, k, v)
        assert torch.equal(got, want)


# ---- launch plans ----

@pytest.mark.parametrize("lq,lk,d,warps,kt,inst", [
    (60, 60, 32, 4, 64, "<32,4>"), (100, 100, 32, 7, 112, "<32,7>"),
    (60, 60, 160, 4, 64, "<160,4>"), (100, 100, 160, 7, 112, "<160,7>"),
    (13, 17, 16, 1, 64, "<0,4>"), (128, 128, 32, 8, 128, "<32,8>"),
    (200, 50, 32, 8, 64, "<32,4>"),
])
def test_fused_mha_plan(lq, lk, d, warps, kt, inst):
    """A warp per 16 queries (at most 8), the 16-key steps the keys need,
    the instance of the width, and shared memory as the C launcher counts
    it: q, K and V tiles with rows padded by 8 bf16, and the key mask."""
    plan = tea.fused_mha_plan(lq, lk, d)
    mpad = -(-lq // 16) * 16
    assert (plan["warps"], plan["kt"], plan["instance"]) == (warps, kt, inst)
    assert plan["smem"] == 2 * (mpad + 2 * kt) * (d + 8) + kt
    assert plan["smem"] <= SMEM_LIMIT
    if (lq, lk, d) == (100, 100, 160):     # two blocks an SM at the widest site
        assert 2 * (plan["smem"] + 1024) <= 233472


@pytest.mark.parametrize("lq,lk,d", [(60, 129, 32), (60, 60, 24),
                                     (60, 0, 32), (2000, 128, 160)])
def test_fused_mha_plan_refuses(lq, lk, d):
    with pytest.raises(ValueError):
        tea.fused_mha_plan(lq, lk, d)


# two-block clusters an H100 SXM holds at once at the served shapes (one
# block an SM; cudaOccupancyMaxActiveClusters, printed by chip_smoke.py)
H100_CLUSTERS = 66


@pytest.mark.parametrize("b", [64, 256])
@pytest.mark.parametrize("l,span", [(500, 256), (1000, 512), (3000, 1504)])
def test_stack_step_plan_served(b, l, span):
    """B = 64 rows (a predict, continuous serving's 64 slots) fit one wave
    of two-block clusters: a row runs on two blocks, each owning half of
    its memory (rounded up to 16 positions). The beam's 256 rows would
    take four waves of clusters, and run on one block a row (two waves)."""
    plan = tds.stack_step_plan(b, l, 40, 8, 256, H100_CLUSTERS)
    cluster = 2 if b == 64 else 1
    assert plan["cluster"] == cluster and plan["blocks"] == cluster * b
    assert plan["span"] == (span if cluster == 2 else l)
    assert plan["span"] * cluster >= l
    assert plan["smem"] == tds.stack_step_smem(cluster, 40, l, 8, 256)
    assert plan["smem"] <= SMEM_LIMIT


def _first_kernel_max_l(tmax, h, f):
    """The longest memory the first stack kernel took (one 512-thread block
    a row, all of a row's scores in shared memory)."""
    fixed = 5 * 256 + 8 * 256 // 2 + max(8 * 256, f) + 8 * 512 \
        + 8 * 8 * 256 + 32 + tmax
    return (SMEM_LIMIT // 4 - fixed) // h


@pytest.mark.parametrize("tmax,h,f", [(40, 8, 256), (40, 1, 256),
                                      (8, 4, 1024)])
def test_stack_step_plan_streams_the_longest_memory(tmax, h, f):
    """Every memory the first kernel took is still taken, at any batch:
    the longest runs on two blocks a row (each streams and scores half of
    it), which then take memories up to about twice as long; one position
    past what two blocks hold is refused."""
    l = _first_kernel_max_l(tmax, h, f)
    for b in (1, 64, 256):
        plan = tds.stack_step_plan(b, l, tmax, h, f, H100_CLUSTERS)
        assert plan["cluster"] == 2 and plan["smem"] <= SMEM_LIMIT
    longest = l
    while tds.stack_step_smem(2, tmax, longest + 1, h, f) <= SMEM_LIMIT:
        longest += 1
    assert longest > 1.7 * l
    assert tds.stack_step_plan(256, longest, tmax, h, f,
                               H100_CLUSTERS)["cluster"] == 2
    with pytest.raises(ValueError):
        tds.stack_step_plan(1, longest + 1, tmax, h, f, H100_CLUSTERS)


def test_stack_step_plan_rows():
    """Two blocks a row where one wave of clusters holds the batch (up to
    the card's max active clusters, whatever the card), one block a row
    beyond it."""
    for mac in (H100_CLUSTERS, 57):
        for b in (1, 7, mac):
            plan = tds.stack_step_plan(b, 1000, 40, 8, 256, mac)
            assert (plan["cluster"], plan["span"], plan["blocks"]) == \
                (2, 512, 2 * b)
        plan = tds.stack_step_plan(mac + 1, 1000, 40, 8, 256, mac)
        assert (plan["cluster"], plan["span"]) == (1, 1000)


# ---- on the card ----

def _mha_case(dev, r, lq, lk, e, seed):
    q, k, v, keep = _mha_inputs(r, lq, lk, e, seed)
    args = [torch.from_numpy(a).to(dev).to(torch.bfloat16) for a in (q, k, v)]
    return args, torch.from_numpy(keep).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("r,lq,lk,e", [
    (64, 60, 60, 256), (640, 100, 100, 256), (64, 60, 60, 1280),
    (640, 100, 100, 1280),                             # the served sites
    (3, 5, 1, 256), (4, 60, 128, 256), (4, 128, 100, 1280),
    (5, 13, 17, 128), (2, 200, 50, 256), (3, 30, 40, 384),
])
def test_fused_mha_kernel_sites_and_corners(cuda, r, lq, lk, e):
    """The served sites, Lk = 1, Lk = 128, Lq = 128, d = 16, a query count
    that loops over the warps, d = 48 (the run-time width): within
    MHA_ULPS of the plain version, exact zeros for the all-padding row 0,
    and a second launch gives identical bits."""
    (q, k, v), keep = _mha_case(cuda, r, lq, lk, e, seed=lq + lk)
    before = tea.LAUNCHES
    out = tea.fused_mha(q, k, v, keep, 8)
    again = tea.fused_mha(q, k, v, keep, 8)
    torch.cuda.synchronize()
    assert tea.LAUNCHES == before + 2
    _bf16_close(out, tea.fused_mha_plain(q, k, v, keep, 8), ulps=MHA_ULPS)
    assert (out[0] == 0).all()
    assert torch.equal(out, again)


def _stack_case(dev, b, l, nl=4, t_max=40, seed=0):
    from case_rg_tpu_torch.models import init_weights, perturb_affine
    from case_rg_tpu_torch.ops.transformer import Decoder
    e, h = 256, 8
    dec = Decoder(nl, e, h, d_ff=e, device=dev)
    init_weights(dec, torch.Generator(device=dev).manual_seed(seed))
    perturb_affine(dec, torch.Generator(device=dev).manual_seed(seed + 2))
    fold = tds.fold_stack_weights(dec, nl, h, torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    m = torch.randn(b, l, e, generator=g, device=dev).to(torch.bfloat16)
    x = torch.randn(b, e, generator=g, device=dev).to(torch.bfloat16)
    lengths = torch.randint(l // 2, l + 1, (b,), generator=g, device=dev)
    mem_keep = torch.arange(l, device=dev)[None, :] < lengths[:, None]
    mem_keep[0] = False                           # a row with no memory
    caches = torch.randn(b, nl, t_max, 2 * e, generator=g,
                         device=dev).to(torch.bfloat16)
    return fold, m, x, mem_keep, caches, g


def _force(monkeypatch, cluster):
    """Run stack_step in the given layout (None: the plan's on this card)."""
    if cluster is not None:
        monkeypatch.setattr(tds, "stack_step_launch",
                            lambda b, l, tmax, h, f: tds.stack_step_plan(
                                b, l, tmax, h, f, b if cluster == 2 else 0))


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,cluster,planned", [
    (64, 1000, None, 2), (64, 1000, 1, 1), (256, 1000, None, 1),
    (256, 1000, 2, 2), (7, 1000, None, 2), (5, 3000, None, 2),
    (3, 4151, 2, 2), (3, 7264, 2, 2), (9, 60, None, 2),
])
def test_stack_step_kernel_self_fed(cuda, monkeypatch, b, l, cluster,
                                    planned):
    """Three self-fed steps from a random cache, the history growing: the
    served shape on two blocks a row (the plan's) and on one, beam rows on
    one block (the plan's) and on two in waves, an odd B, 3000 positions,
    the longest memory the first kernel took and the longest two blocks
    hold, and a short memory. Outputs and caches within STACK_ULPS of the
    plain version."""
    fold, m, x, mem_keep, c0, g = _stack_case(cuda, b, l)
    _force(monkeypatch, cluster)
    assert tds.stack_step_launch(b, l, 40, 8, 256)["cluster"] == planned
    hist = torch.rand(b, 40, generator=g, device=cuda) > 0.5
    ck, cp = c0.clone(), c0.clone()
    xk = xp = x
    for t in range(3):
        hist[:, t] = True
        xk, ck = tds.stack_step(xk, t, ck, m, mem_keep, hist, fold, 8)
        xp, cp = tds.stack_step_plain(xp, t, cp, m, mem_keep, hist, fold, 8)
        torch.cuda.synchronize()
        _bf16_close(xk, xp, ulps=STACK_ULPS)
    _bf16_close(ck, cp, ulps=STACK_ULPS)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2])
def test_stack_step_kernel_per_row_t_and_repeat(cuda, monkeypatch, cluster):
    """Per-row t with every fourth row at T (no cache write): as the plain
    version, those rows' caches untouched, and a second launch on the same
    inputs gives identical bits, in both layouts."""
    b, l = 64, 1000
    fold, m, x, mem_keep, c0, g = _stack_case(cuda, b, l, seed=5)
    _force(monkeypatch, cluster)
    t = torch.randint(0, 40, (b,), generator=g, device=cuda)
    t[::4] = 40
    hist = torch.rand(b, 40, generator=g, device=cuda) > 0.3
    outs = []
    for _ in range(2):
        ck = c0.clone()
        y, ck = tds.stack_step(x, t, ck, m, mem_keep, hist, fold, 8)
        outs.append((y, ck))
    yp, cp = tds.stack_step_plain(x, t, c0.clone(), m, mem_keep, hist, fold, 8)
    torch.cuda.synchronize()
    (yk, ck), (y2, c2) = outs
    _bf16_close(yk, yp, ulps=STACK_ULPS)
    _bf16_close(ck, cp, ulps=STACK_ULPS)
    assert torch.equal(ck[::4], c0[::4])
    assert torch.equal(yk, y2) and torch.equal(ck, c2)


def _small_case(dev, param_dtype):
    from case_rg_tpu_torch.config import ModelConfig
    from case_rg_tpu_torch.models import create_model
    cfg = ModelConfig(name="case", vocab_size=1000, embedding_size=256,
                      hidden_size=256, num_heads=8, enc_layers=1,
                      dec_layers=2, max_dec_len=8, max_target_length=8,
                      param_dtype=param_dtype)
    rng = np.random.RandomState(0)
    b, p, lp, lq = 4, 6, 100, 20            # 600 positions: the fused stack
    q = rng.randint(4, 1000, size=(b, 1, lq)).astype(np.int32)
    pas = rng.randint(4, 1000, size=(b, p, lp)).astype(np.int32)
    q[:, :, lq - 5:] = 0
    pas[:, :, lp - 10:] = 0
    batch = {"query": q, "passage": pas}
    return cfg, create_model("case", cfg, device=dev, seed=0), batch


@pytest.mark.cuda
def test_decode_steps_do_not_sync(cuda):
    """A greedy decode step (every ``_step_core`` of a predict) and a
    ``decode_chunk`` in the dense and pallas argmax modes run without any
    operation that makes the host wait on the card; the stack kernel runs
    in them."""
    from case_rg_tpu_torch.device import batch_to_device, no_host_sync
    from case_rg_tpu_torch.runtime.continuous import make_continuous_fns
    from case_rg_tpu_torch.runtime.inference import make_predict_fn
    cfg, model, batch = _small_case(cuda, "bfloat16")
    predict = make_predict_fn(model, cfg, 8, device=cuda)
    predict(batch)                               # warm-up
    dec = model.decoder
    core = dec._step_core

    def checked(*args, **kw):
        with no_host_sync():
            return core(*args, **kw)

    before = tds.LAUNCHES
    dec._step_core = checked
    try:
        out = predict(batch_to_device(batch, cuda))
    finally:
        del dec._step_core
    assert out["answer"].shape == (4, 8) and tds.LAUNCHES == before + 8
    for mode in ("dense", "pallas"):
        init_fn, chunk_fn, _ = make_continuous_fns(model, 8, 4,
                                                   fast_argmax=mode,
                                                   device=cuda)
        state, _ = init_fn(batch)
        state = chunk_fn(state)                  # warm-up
        with no_host_sync():
            state = chunk_fn(state)
        torch.cuda.synchronize()
        assert state["out"].shape == (4, 8)


@pytest.mark.cuda
def test_train_step_does_not_sync(cuda):
    """A CaSE train step (bf16 compute, in-kernel dropout) on a batch
    already on the card runs without any operation that makes the host
    wait on the card, and its loss is finite."""
    from case_rg_tpu_torch.config import TrainConfig
    from case_rg_tpu_torch.device import batch_to_device, no_host_sync
    from case_rg_tpu_torch.train.trainer import Trainer
    cfg, model, batch = _small_case(cuda, "float32")
    rng = np.random.RandomState(1)
    b, p, lp = batch["passage"].shape
    resp = rng.randint(4, 1000, size=(b, 8)).astype(np.int32)
    resp[:, 6:] = 0
    batch.update(response=resp,
                 passage_label=rng.randint(0, p, size=b).astype(np.int32),
                 token_label=((rng.rand(b, p, lp) < 0.1)
                              & (batch["passage"] != 0)).astype(np.float32),
                 token_weight=(1 + rng.rand(b, p, lp)).astype(np.float32))
    trainer = Trainer(model, TrainConfig(batch_size=b, learning_rate=1e-4,
                                         warmup_steps=1,
                                         compute_dtype="bfloat16"),
                      total_steps=10, device=cuda)
    st = trainer.init_state()
    gen = torch.Generator(device=cuda).manual_seed(0)
    batch = batch_to_device(batch, cuda)
    trainer.train_step(st, batch, gen)           # warm-up
    with no_host_sync():
        out = trainer.train_step(st, batch, gen)
    assert bool(torch.isfinite(out["total"]))


# ---- the other models' kernel routes on the card ----

# (model, hidden width) of the route check (heads of 32): Masque at 256,
# the width stack_step takes; GLKS at 160 puts its matching attention at
# 2H = 320, past the additive kernel's 256, so it goes dense
OTHER_MODELS = (("masque", 256), ("s2sa", 64), ("gttp", 64), ("glks", 160),
                ("tmemnet", 64))


def _other_batch(name, b=4, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randint(4, 500, (b, 12))
    pool = rng.randint(4, 500, (b, 6, 100))
    pool[:, :, 80:] = 0
    resp = rng.randint(4, 500, (b, 6))
    resp[:, 4:] = 0
    bt = {"response": resp, "passage_label": rng.randint(0, 6, b)}
    if name == "masque":
        bt.update(query=q[:, None], passage=pool)
    elif name == "tmemnet":
        bt.update(context=q, passage=pool)
    else:
        bt.update(context=q, background=pool.reshape(b, -1))
    bt = {k: v.astype(np.int32) for k, v in bt.items()}
    if name == "glks":
        bt["selection"] = np.eye(150, dtype=np.float32)[rng.randint(0, 150,
                                                                     b)]
    return bt


@pytest.mark.cuda
@pytest.mark.parametrize("name, hidden", OTHER_MODELS,
                         ids=[m for m, _ in OTHER_MODELS])
def test_other_models_route_their_kernels_on_the_card(cuda, name, hidden):
    """bf16 on the card, small widths: greedy (and, for the copy models,
    the pallas argmax mode) launches the kernels of the model's path, the
    additive sites the plan refuses go dense and are counted, and a bf16
    train step launches the training attention (Masque, TMemNet) and
    additive_scores' backward (the others but TMemNet)."""
    from case_rg_tpu_torch.config import ModelConfig, TrainConfig
    from case_rg_tpu_torch.kernels import additive_attention as taa
    from case_rg_tpu_torch.kernels import copy_argmax as tca
    from case_rg_tpu_torch.kernels import decode_attention as tda
    from case_rg_tpu_torch.kernels import train_attention as tta
    from case_rg_tpu_torch.models import create_model, perturb_affine
    from case_rg_tpu_torch.ops import bilinear
    from case_rg_tpu_torch.runtime.inference import make_predict_fn
    from case_rg_tpu_torch.train.trainer import Trainer

    fields = dict(name=name, vocab_size=500, embedding_size=hidden,
                  hidden_size=hidden, num_heads=hidden // 32, enc_layers=1,
                  dec_layers=1, tmemnet_layers=1, max_dec_len=6,
                  min_window_size=4, num_windows=1, dropout=0.1)
    cfg = ModelConfig(param_dtype="bfloat16", **fields)
    model = create_model(name, cfg, device=cuda, seed=0)
    perturb_affine(model, torch.Generator(device=cuda).manual_seed(1))
    batch = _other_batch(name)
    counters = (tea, tds, tda, taa, tca)
    for m in counters:
        m.LAUNCHES = 0
    bilinear.DENSE_SITES.clear()
    out = make_predict_fn(model, cfg, 6, device=cuda)(batch)
    torch.cuda.synchronize()
    assert out["answer"].shape == (4, 6)
    got = {m.__name__.rsplit(".", 1)[-1]: m.LAUNCHES for m in counters}
    want = {"masque": {"encoder_attention", "decoder_stack",
                       "decode_attention", "additive_attention"},
            "tmemnet": {"encoder_attention", "decode_attention"}}.get(
                name, {"additive_attention"})
    assert {k for k, v in got.items() if v} == want, got
    if name == "glks":
        assert any(k.startswith("the plan refuses") and k.endswith("H=320")
                   for k in bilinear.DENSE_SITES), bilinear.DENSE_SITES
    if name in ("masque", "gttp", "glks"):
        tca.LAUNCHES = 0
        make_predict_fn(model, cfg, 6, fast_argmax="pallas",
                        device=cuda)(batch)
        assert tca.LAUNCHES == 6
    trainer = Trainer(create_model(name, ModelConfig(**fields), device=cuda),
                      TrainConfig(batch_size=4, compute_dtype="bfloat16",
                                  warmup_steps=1), 10, device=cuda,
                      loss_method_kwargs={"mode": "ds_mle_mce_train"}
                      if name == "glks" else None)
    tta.LAUNCHES_FWD["rng"] = tta.LAUNCHES_BWD["rng"] = 0
    taa.LAUNCHES_BWD = 0
    losses = trainer.train_step(trainer.init_state(), batch,
                                torch.Generator(device=cuda).manual_seed(2))
    assert torch.isfinite(losses["total"])
    assert (tta.LAUNCHES_BWD["rng"] > 0) == (name in ("masque", "tmemnet"))
    assert (taa.LAUNCHES_BWD > 0) == (name != "tmemnet")
