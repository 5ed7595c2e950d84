"""S2SA, GTTP, GLKS (and, through tests/test_torch_tmemnet.py, TMemNet) in
the port against the JAX package, in f32
on the CPU, at toy widths (V = 50, E = H = 16, context 10, background 20,
a pool of 3 x 8 for TMemNet, answers of T = 6), with the JAX parameters
bridged leaf for leaf.

One module fixture builds each model once, lazily: random weights with
noisy biases, an EOS that the greedy decode really emits (so rows end at
staggered steps), and the JAX package's outputs, each program compiled
once (unoptimised: these programs run once or twice). Held here, per
model:

* the bridge maps every leaf the JAX model reads, and only those;
* ``train_losses`` (GLKS's ``ds_mle_mce_train``, TMemNet's ``ps_train``
  too) within 1e-5 relative, every gradient within 1e-4 relative plus
  1e-4 of the parameter's largest |gradient|, dropout off;
* greedy answers token-identical through ``make_predict_fn`` (with and
  without ``early_exit``), GTTP's and GLKS's scatter-free ``fast_argmax``
  path too (through the port's plain ``combine_copy_mass``); beam width 3
  token-identical; TMemNet's rank within 1e-5. The JAX package's greedy
  answers are taken from its chunked decode run uncapped, which it holds
  equal to its one-shot greedy decode (one program less to compile);
* sampling at top_k = 1 equals the JAX package's greedy answer under the
  sampling bookkeeping;
* ``continuous_decode_init``/``continuous_decode_chunk`` in lockstep with
  the JAX package's: ``out``, ``trow`` and ``done`` equal after every
  chunk, rows capped at their own lengths; the chunk loop and the device
  loop serve every request its one-shot answer, greedy and sampled.

Also the additive-attention gate: ``additive_scores_fits`` agrees with
``additive_scores_plan``, and GLKS's matching attention at full width (2H
= 512) and its window attention go to the dense path with the kernel
forced.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from case_rg_tpu.config import ModelConfig as JConfig
from case_rg_tpu.models import create_model as jcreate
from case_rg_tpu.models.predict import (continuous_decode_chunk as
                                        jdecode_chunk,
                                        continuous_decode_init as
                                        jdecode_init)
from case_rg_tpu.runtime.inference import make_predict_fn as jmake_predict
from case_rg_tpu_torch.bridge import load_jax_params, state_dict_from_jax
from case_rg_tpu_torch.config import ModelConfig
from case_rg_tpu_torch.device import batch_to_device
from case_rg_tpu_torch.kernels import additive_attention as taa
from case_rg_tpu_torch.models import create_model
from case_rg_tpu_torch.models.glks import KnowledgeSelector
from case_rg_tpu_torch.models.predict import (continuous_decode_chunk,
                                              continuous_decode_init)
from case_rg_tpu_torch.ops import bilinear
from case_rg_tpu_torch.runtime.continuous import (make_continuous_fns,
                                                  make_device_loop_fns,
                                                  run_continuous,
                                                  run_continuous_device)
from case_rg_tpu_torch.runtime.inference import make_predict_fn
from tests.test_torch_bridge import jax_tree_from_port
from tests.test_torch_continuous import random_tree
from tests.test_torch_kernels import one_torch_thread  # noqa: F401

# the GRU family; TMemNet's cases (these tests, run on "tmemnet") are in
# tests/test_torch_tmemnet.py, so that no file of the port's tests takes
# more than half a minute on one worker
MODELS = ("s2sa", "gttp", "glks")
T = 6
B = 6
V = 50
CFG = dict(vocab_size=V, embedding_size=16, hidden_size=16, num_heads=2,
           tmemnet_layers=1, max_dec_len=T, min_window_size=4, num_windows=1)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4         # relative, and of the largest |gradient| absolute
RANK_TOL = 1e-5
# weights x this over the seeded tree: the copy models' greedy answers
# repeat one token a row at the tree's scale
WEIGHT_SCALE = {"s2sa": 2.0, "gttp": 3.0, "glks": 3.0, "tmemnet": 1.0}
# CPU compile options for the JAX programs: unoptimised code compiles
# about a quarter faster, and these programs run once
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
torch.set_float32_matmul_precision("highest")


def run_jit(fn, *args):
    """``fn(*args)`` through one jit, compiled with ``FAST_COMPILE``."""
    jitted = fn if hasattr(fn, "lower") else jax.jit(fn)
    return jitted.lower(*args).compile(FAST_COMPILE)(*args)


def batch(seed, n):
    """Every model's fields, padded tails at random lengths."""
    rng = np.random.RandomState(seed)
    out = {"context": rng.randint(4, V, (n, 10)),
           "background": rng.randint(4, V, (n, 20)),
           "passage": rng.randint(4, V, (n, 3, 8)),
           "response": rng.randint(4, V, (n, T)),
           "passage_label": rng.randint(0, 3, n)}
    for i in range(n):
        out["context"][i, rng.randint(4, 11):] = 0
        out["background"][i, rng.randint(8, 21):] = 0
        out["passage"][i, :, rng.randint(3, 9):] = 0
        out["response"][i, rng.randint(2, T + 1):] = 0
    out = {k: v.astype(np.int32) for k, v in out.items()}
    out["selection"] = np.eye(5, dtype=np.float32)[rng.randint(0, 5, n)]
    out["sample_weight"] = np.ones(n, np.float32)
    out["sample_weight"][-1] = 0.5
    return out


def take(arrays, idx):
    return {k: v[idx] for k, v in arrays.items()}


def jbatch(arrays):
    return {k: jnp.asarray(v) for k, v in arrays.items()}


def ended(answer, eos, unk):
    """Rows that ended: an EOS, or an EOS at step 0 written as UNK and PAD
    after it."""
    return (answer == eos).any(-1) | ((answer[:, 0] == unk)
                                      & (answer[:, 1:] == 0).all(-1))


def sampled_bookkeeping(greedy, eos, unk):
    """Greedy answers under the sampling loop's bookkeeping: a row that has
    not ended before the last step ends there with EOS."""
    out = greedy.copy()
    out[~ended(greedy[:, :-1], eos, unk), -1] = eos
    return out


def cut(row, cap, eos):
    """A row capped at ``cap``: tokens up to the cap and the first EOS."""
    out = np.zeros(T, np.int32)
    hits = np.flatnonzero(row[:cap] == eos)
    end = hits[0] + 1 if len(hits) else cap
    out[:end] = row[:end]
    return out


LOSS_MODE = {"glks": "ds_mle_mce_train"}   # the CLI's mode per model


def loss_modes(name):
    return ["train", "ps_train"] if name == "tmemnet" \
        else [LOSS_MODE.get(name, "train")]


class Models:
    """Each model built on first use (see the module docstring)."""

    def __init__(self):
        self._built = {}

    def __getitem__(self, name):
        if name not in self._built:
            self._built[name] = self._build(name)
        return self._built[name]

    @staticmethod
    def _build(name):
        # the JAX tree's layout from the port's model (no JAX init traced);
        # test_bridge_maps_every_leaf holds it to the JAX model's reads
        layout = jax_tree_from_port(create_model(
            name, ModelConfig(name=name, **CFG), device="cpu"))
        params = jax.tree_util.tree_map(lambda a: a * WEIGHT_SCALE[name],
                                        random_tree(layout, seed=1))
        pool = batch(2, 24)

        def port_model(eos):
            m = create_model(name, ModelConfig(name=name, eos_id=eos, **CFG),
                             device="cpu")
            load_jax_params(m, params)
            return m

        # the EOS: a token in about half the rows' greedy answers
        ids = make_predict_fn(port_model(3), ModelConfig(name=name, **CFG),
                              T, device="cpu")(pool)["answer"].numpy()
        rows_with = {v: int((ids == v).any(-1).sum()) for v in np.unique(ids)}
        eos = max(rows_with, key=lambda v: min(rows_with[v],
                                               len(ids) - rows_with[v]))
        first = np.array([np.flatnonzero(r == eos)[0] if (r == eos).any()
                          else T for r in ids])
        assert len(set(first[first < T])) > 1, (name, first)
        ending = np.flatnonzero(first < T)
        never = np.flatnonzero(first == T)
        assert len(ending) >= 3 and len(never) >= 3, (name, first)
        parity = take(pool, np.concatenate([ending[:3], never[:3]]))
        jcfg = JConfig(name=name, eos_id=eos, **CFG)
        jmodel = jcreate(name, jcfg)
        variables, jb = {"params": params}, jbatch(parity)
        ref = {"beam3": run_jit(jmake_predict(jmodel, jcfg, T, beam_width=3),
                                variables, jb)}

        def grads(p, b):
            def losses(p):
                out = jmodel.apply({"params": p}, b, deterministic=True,
                                   method=type(jmodel).train_losses)
                return jnp.stack([out[k] for k in sorted(out)]), out
            if name != "tmemnet":
                (_, out), g = jax.value_and_grad(
                    lambda p: (lambda v, o: (v.sum(), o))(*losses(p)),
                    has_aux=True)(p)
                return {LOSS_MODE.get(name, "train"): (out, g)}
            # one reverse pass for both losses (cheaper to build than a
            # second program for ps_train): a row of gradients each;
            # ps_train trains on the unscaled selection loss, 4x the train
            # mode's "select" (TMemNetModel.train_losses)
            rows, out = jax.jacrev(losses, has_aux=True)(p)
            at = sorted(out).index("select")
            return {"train": (out, jax.tree_util.tree_map(
                        lambda r: r.sum(0), rows)),
                    "ps_train": ({"select": 4.0 * out["select"]},
                                 jax.tree_util.tree_map(
                                     lambda r: 4.0 * r[at], rows))}

        ref.update(run_jit(grads, params, jb))

        def init(p, b):
            return jmodel.apply({"params": p}, b, max_len=T,
                                method=jdecode_init)

        def chunk(p, state):
            return jmodel.apply({"params": p}, state, n_steps=2,
                                method=jdecode_chunk)

        caps = np.array([T, 3, T, 5, 2, T])
        b = dict(jb, response_cap=jnp.asarray(caps))
        start = jax.jit(init).lower(params, b).compile(FAST_COMPILE)
        state, _ = start(params, b)
        step = jax.jit(chunk).lower(params, state).compile(FAST_COMPILE)

        def chunks(state):
            seen = []
            for _ in range(T // 2):
                state = step(params, state)
                seen.append((state["out"], state["trow"], state["done"]))
            return seen

        ref["lockstep"] = chunks(state)
        # uncapped, the chunked decode's answers are the greedy ones (the
        # JAX package holds them equal to run_greedy's)
        state, rank = start(params, dict(
            jb, response_cap=jnp.full((len(caps),), T, jnp.int32)))
        ref["greedy"] = {"answer": chunks(state)[-1][0], "rank": rank}
        ref = jax.tree_util.tree_map(np.asarray, ref)
        return {"name": name, "params": params, "eos": eos, "caps": caps,
                "cfg": ModelConfig(name=name, eos_id=eos, **CFG),
                "port": port_model(eos), "parity": parity, "pool": pool,
                "ref": ref}


@pytest.fixture(scope="module")
def models():
    return Models()


@pytest.mark.parametrize("name", MODELS)
def test_bridge_maps_every_leaf(models, name):
    """The tree maps onto every port parameter, and every leaf of it is one
    the JAX model reads: its train-mode gradient there is nonzero (and
    flax checked the shape of each leaf it read)."""
    m = models[name]
    sd = state_dict_from_jax(m["params"])
    params = dict(m["port"].named_parameters())
    assert set(sd) == set(params)
    for k, arr in sd.items():
        np.testing.assert_array_equal(params[k].detach().numpy(), arr,
                                      err_msg=k)
    grads = state_dict_from_jax(m["ref"][loss_modes(name)[0]][1])
    assert set(grads) == set(sd)
    assert [k for k, g in grads.items() if not g.any()] == []


@pytest.mark.parametrize("name, mode", [(n, mode) for n in MODELS
                                        for mode in loss_modes(n)])
def test_losses_and_gradients_match_jax(models, name, mode):
    m = models[name]
    jlosses, jgrads = m["ref"][mode]
    model = m["port"]
    tb = batch_to_device(m["parity"], torch.device("cpu"))
    kw = {} if mode == "train" else {"mode": mode}
    losses = model.train_losses(tb, None, **kw)
    assert set(losses) == set(jlosses)
    for k, v in losses.items():
        np.testing.assert_allclose(float(v), float(jlosses[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(sum(losses.values()), list(params.values()),
                                allow_unused=True, materialize_grads=True)
    want = state_dict_from_jax(jgrads)
    for (k, p), g in zip(params.items(), grads):
        np.testing.assert_allclose(g.numpy(), want[k], rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(want[k]).max(),
                                   err_msg=k)
    if mode == "ps_train":       # the ranker alone: the decoder stays still
        assert all(not g.any() for k, g in zip(params, grads)
                   if k.startswith(("decoder.", "dec_", "gen.")))


@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("name", MODELS)
def test_greedy_matches_jax(models, name, early_exit):
    m = models[name]
    out = make_predict_fn(m["port"], m["cfg"], T, early_exit=early_exit,
                          device="cpu")(m["parity"])
    want = m["ref"]["greedy"]
    np.testing.assert_array_equal(out["answer"].numpy(), want["answer"])
    assert ended(out["answer"].numpy(), m["eos"], m["cfg"].unk_id).sum() >= 3
    if name == "tmemnet":
        np.testing.assert_allclose(out["rank"].numpy(), want["rank"], rtol=0,
                                   atol=RANK_TOL)
        rank = make_predict_fn(m["port"], m["cfg"], T, rank_only=True,
                               device="cpu")(m["parity"])
        assert set(rank) == {"rank"}
        np.testing.assert_allclose(rank["rank"].numpy(), want["rank"],
                                   rtol=0, atol=RANK_TOL)
    else:
        assert set(out) == {"answer"}
        with pytest.raises(ValueError, match="rank head"):
            make_predict_fn(m["port"], m["cfg"], T, rank_only=True,
                            device="cpu")


@pytest.mark.parametrize("name", ["gttp", "glks"])
def test_fast_copy_greedy_matches_jax(models, name):
    """The scatter-free candidate argmax (``run_greedy_copy``, through the
    plain ``combine_copy_mass`` here) gives the JAX package's greedy
    answers."""
    m = models[name]
    got = make_predict_fn(m["port"], m["cfg"], T, fast_argmax="pallas",
                          device="cpu")(m["parity"])["answer"].numpy()
    np.testing.assert_array_equal(got, m["ref"]["greedy"]["answer"])


@pytest.mark.parametrize("name", ["gttp", "glks"])
def test_decode_step_parts_add_up_to_the_step(models, name):
    """``decode_step_parts``' vocabulary mass plus its copy mass scattered
    onto the background ids is ``decode_step``'s distribution, to f32
    rounding (the math ``decode_step_fast`` rests on), and the two steps
    leave the same state."""
    from case_rg_tpu_torch.ops.copynet import copy_scatter
    m = models[name]
    model, cpu = m["port"], torch.device("cpu")
    with torch.inference_mode():
        enc = model.encode(batch_to_device(m["parity"], cpu))
        prev = torch.full((B,), m["cfg"].bos_id, dtype=torch.int32)
        dist, state = model.decode_step(enc, enc["init_state"], prev)
        vocab, copy, state_parts = model.decode_step_parts(
            enc, enc["init_state"], prev)
    got = vocab + copy_scatter(copy, enc["background"], V)
    np.testing.assert_allclose(got.numpy(), dist.numpy(), rtol=0, atol=1e-6)
    assert torch.equal(state, state_parts)


@pytest.mark.parametrize("name", MODELS)
def test_beam_width_3_matches_jax(models, name):
    m = models[name]
    out = make_predict_fn(m["port"], m["cfg"], T, beam_width=3,
                          device="cpu")(m["parity"])
    np.testing.assert_array_equal(out["answer"].numpy(),
                                  m["ref"]["beam3"]["answer"])
    if name == "tmemnet":
        np.testing.assert_allclose(out["rank"].numpy(),
                                   m["ref"]["beam3"]["rank"], rtol=0,
                                   atol=RANK_TOL)


@pytest.mark.parametrize("name", MODELS)
def test_sample_top_k_1_is_jax_greedy(models, name):
    m = models[name]
    got = make_predict_fn(m["port"], m["cfg"], T, decoding="sample",
                          top_k=1, sample_seed=3,
                          device="cpu")(m["parity"])["answer"].numpy()
    want = sampled_bookkeeping(m["ref"]["greedy"]["answer"], m["eos"],
                               m["cfg"].unk_id)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", MODELS)
def test_chunked_decode_lockstep_matches_jax(models, name):
    """Chunks of 2 steps with per-row caps: ``out``, ``trow`` and ``done``
    equal the JAX package's after every chunk; the decoder state keeps its
    storage (advanced in place)."""
    m = models[name]
    tb = batch_to_device(dict(m["parity"], response_cap=m["caps"]),
                         torch.device("cpu"))
    with torch.inference_mode():
        state, rank = continuous_decode_init(m["port"], tb, max_len=T)
        assert (rank is None) == (name != "tmemnet")
        dec = state["dec"]
        for i, (out, trow, done) in enumerate(m["ref"]["lockstep"]):
            state = continuous_decode_chunk(m["port"], state, n_steps=2)
            np.testing.assert_array_equal(state["out"].numpy(), out,
                                          err_msg=f"chunk {i}")
            np.testing.assert_array_equal(state["trow"].numpy(), trow)
            np.testing.assert_array_equal(state["done"].numpy(), done)
            assert state["dec"] is dec


def _serve(fns, reqs, caps, make, device_loop):
    got = {}

    def emit(r, ids, rk):
        got[r["i"]] = ids.copy()

    items = iter([{"i": i} for i in range(len(caps))])
    if device_loop:
        stats = run_continuous_device(items, make, fns, 4, 2, emit,
                                      max_len=T)
    else:
        stats = run_continuous(items, make, *fns, batch_size=4, refill=2,
                               emit=emit)
    assert stats["served"] == len(caps)
    return got


@pytest.mark.parametrize("device_loop", [False, True],
                         ids=["chunk-loop", "device-loop"])
@pytest.mark.parametrize("name", MODELS)
def test_continuous_serving_equals_one_shot(models, name, device_loop):
    """10 requests, batch 4, refill 2, chunks of 2 steps, caps per
    request: each answer is the one-shot greedy answer cut at its cap."""
    m = models[name]
    reqs = take(m["pool"], np.arange(10))
    caps = np.random.RandomState(4).randint(2, T + 1, 10)
    one_shot = make_predict_fn(m["port"], m["cfg"], T,
                               device="cpu")(reqs)["answer"].numpy()

    def make(items, bs):
        idx = [r["i"] for r in items]
        idx += [idx[-1]] * (bs - len(idx))
        return dict(take(reqs, idx), response_cap=caps[idx])

    if device_loop:
        fns = make_device_loop_fns(m["port"], T, 2, n_chunks=2, stage_rows=4,
                                   device="cpu")
    else:
        fns = make_continuous_fns(m["port"], T, 2, device="cpu")
    got = _serve(fns, reqs, caps, make, device_loop)
    for i in range(10):
        np.testing.assert_array_equal(got[i], cut(one_shot[i], caps[i],
                                                  m["eos"]),
                                      err_msg=f"request {i}")


@pytest.mark.parametrize("name", MODELS)
def test_sampled_continuous_equals_one_shot(models, name):
    """Sampled chunks draw each request's one-shot sample of its key, bit
    for bit, whatever its batch and refill order; per-row controls ride
    with their rows. The controls are temperatures and top_k = 1: GTTP
    and GLKS sample from the log-softmax of their mixture probabilities
    (the JAX package's rule), a near-flat distribution whose top-k and
    top-p boundaries fall among near-ties that the CPU's products at
    another batch width move by an ulp."""
    m = models[name]
    reqs = take(m["pool"], np.arange(8))
    keys = np.stack([np.random.SeedSequence([5, i]).generate_state(
        2, np.uint32) for i in range(8)])
    ctl = np.tile(np.array([[0.9, 0, 1.0]], np.float32), (8, 1))
    ctl[::3] = (1.3, 0, 1.0)
    ctl[1::3] = (1.0, 1, 1.0)
    one_shot = [make_predict_fn(
        m["port"], m["cfg"], T, decoding="sample",
        temperature=float(ctl[i, 0]), top_k=int(ctl[i, 1]),
        top_p=float(ctl[i, 2]), device="cpu")(dict(
            take(reqs, [i]), sample_key=keys[[i]]))["answer"].numpy()[0]
        for i in range(8)]

    def make(items, bs):
        idx = [r["i"] for r in items]
        idx += [idx[-1]] * (bs - len(idx))
        return dict(take(reqs, idx), sample_key=keys[idx],
                    sample_ctl=ctl[idx])

    fns = make_continuous_fns(m["port"], T, 2, decoding="sample",
                              device="cpu")
    got = _serve(fns, reqs, np.full(8, T), make, device_loop=False)
    for i in range(8):
        np.testing.assert_array_equal(got[i], one_shot[i],
                                      err_msg=f"request {i}")


@pytest.mark.parametrize("name", MODELS + ("tmemnet", "masque"))
def test_create_model_refuses_the_cpu_unless_asked(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(name=name, **CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model(name, cfg)
    assert create_model(name, cfg, device="cpu").cfg is cfg


# ---- the additive-attention gate ----

@pytest.mark.parametrize("shape, fits", [
    ((64, 1, 1000, 256), True), ((64, 40, 60, 256), True),
    ((64, 1000, 60, 512), False), ((65536, 1, 60, 256), False),
    ((1, 1, 3_000_000, 256), False)],
    ids=["h256-decode", "h256-teacher", "h512", "batch-past-grid",
         "keys-past-grid"])
def test_additive_predicate_agrees_with_the_plan(shape, fits):
    assert taa.additive_scores_fits(*shape) is fits
    if fits:
        taa.additive_scores_plan(*shape)
    else:
        with pytest.raises(ValueError):
            taa.additive_scores_plan(*shape)


def test_glks_full_width_attention_sites_go_dense():
    """With the kernel forced, GLKS's knowledge selector at full width
    (H = 256: the matching attention at 2H = 512; windows of 4 over the
    background) sends both of its sites dense and counts them in
    ``DENSE_SITES`` (a short background here; the gate reads shapes only,
    so the served shape is held on zero-stride views); a CaSE-shaped site
    still takes the kernel."""
    gen = torch.Generator().manual_seed(0)
    ks = KnowledgeSelector(256, 4, 1)
    with torch.no_grad():
        for p in ks.parameters():
            p.normal_(0, 0.05, generator=gen)
    b_out = torch.randn(2, 12, 256, generator=gen)
    c_out = torch.randn(2, 5, 256, generator=gen)
    c_state = torch.randn(2, 1, 256, generator=gen)
    b_keep = torch.ones(2, 12, dtype=torch.bool)
    c_keep = torch.ones(2, 5, dtype=torch.bool)
    zeros = lambda *shape: torch.zeros(()).expand(*shape)
    bilinear.DENSE_SITES.clear()
    try:
        bilinear.set_additive_kernel(True)
        with torch.no_grad():
            segment, p_s, _ = ks(b_out, c_out, c_state, b_keep, c_keep)
        served = bilinear._additive_kernel_ok(zeros(64, 1000, 512),
                                              zeros(64, 60, 512))
        case_site = bilinear._additive_kernel_ok(zeros(64, 1, 256),
                                                 zeros(64, 1000, 256))
    finally:
        bilinear.set_additive_kernel(None)
    assert segment.shape == (2, 1, 256) and p_s.shape == (2, 3)
    assert not served and case_site
    assert bilinear.DENSE_SITES == {
        "the plan refuses: B=2 T=12 L=5 H=512": 1,
        "leading shapes differ: wq (2, 1, 1, 256) uh (2, 3, 4, 256)": 1,
        "the plan refuses: B=64 T=1000 L=60 H=512": 1}
