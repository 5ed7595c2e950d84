"""Masque in the port against the JAX package, in f32 on the CPU, at toy
widths (V = 64, E = H = 16, 2 heads, one encoder layer, one decoder layer
per memory, the 3 + 5 tower blocks; a query of 10 and a pool of 3 x 12),
with the JAX parameters bridged leaf for leaf and noisy biases and gains.

One module fixture builds the model and the JAX package's outputs, each
program compiled once (unoptimised: they run once or twice). Its EOS is a
token the greedy decode really emits, so rows end at staggered steps.
Held here:

* the bridge maps every leaf the JAX model reads, and only those;
* ``train_losses`` and ``mode="ps_train"`` (the ranker alone) within 1e-5
  relative, every gradient within 1e-4 relative plus 1e-4 of the
  parameter's largest |gradient|, dropout off;
* greedy answers token-identical up to their first EOS (the decoder, as
  the reference, keeps arg-maxing past it; the printed answer ends there)
  in the dense and the pallas argmax modes (the port's plain
  ``combine_copy_mass``), with the layer chain and with the fused stack
  forced; beam width 3 token-identical; rank scores, also rank-only,
  within 1e-4; sampling at top_k = 1 equals the greedy answer under the
  sampling bookkeeping. The JAX package's greedy answers are its chunked
  decode's run uncapped (one program less to compile), which it holds
  equal to its one-shot decode's cut at EOS;
* ``decode_init``/``decode_chunk`` in lockstep with the JAX package's
  (``out``, ``trow``, ``done`` after every chunk, rows capped at their own
  lengths); the chunk loop and the device loop serve every request its
  one-shot answer, greedy and sampled.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from case_rg_tpu.config import ModelConfig as JConfig
from case_rg_tpu.models import create_model as jcreate
from case_rg_tpu.runtime.inference import make_predict_fn as jmake_predict
from case_rg_tpu_torch.bridge import load_jax_params, state_dict_from_jax
from case_rg_tpu_torch.config import ModelConfig
from case_rg_tpu_torch.device import batch_to_device
from case_rg_tpu_torch.models import create_model, multimem
from case_rg_tpu_torch.runtime.continuous import (make_continuous_fns,
                                                  make_device_loop_fns,
                                                  run_continuous,
                                                  run_continuous_device)
from case_rg_tpu_torch.runtime.inference import make_predict_fn
from tests.test_torch_baselines import (FAST_COMPILE, GRAD_TOL, LOSS_RTOL,
                                        run_jit, take)
from tests.test_torch_bridge import TOY, jax_tree_from_port
from tests.test_torch_continuous import random_tree
from tests.test_torch_kernels import one_torch_thread  # noqa: F401

T = 8
CFG = dict(TOY, name="masque", dec_layers=1, max_dec_len=T)
RANK_TOL = 1e-4
CAPS = np.array([T, 3, T, 5, 2, T])
torch.set_float32_matmul_precision("highest")


def requests(seed, n):
    rng = np.random.RandomState(seed)
    q = rng.randint(4, CFG["vocab_size"], (n, 1, 10)).astype(np.int32)
    p = rng.randint(4, CFG["vocab_size"], (n, 3, 12)).astype(np.int32)
    for i in range(n):
        q[i, :, rng.randint(5, 11):] = 0
        p[i, :, rng.randint(6, 13):] = 0
    p[1, -1] = 0                          # a passage that is all padding
    r = rng.randint(4, CFG["vocab_size"], (n, T)).astype(np.int32)
    r[:, -2:] = 0
    return {"query": q, "passage": p, "response": r,
            "passage_label": rng.randint(0, 3, n).astype(np.int32),
            "sample_weight": np.linspace(1.0, 0.5, n).astype(np.float32)}


def cut(row, cap, eos):
    out = np.zeros(T, np.int32)
    hits = np.flatnonzero(row[:cap] == eos)
    end = hits[0] + 1 if len(hits) else cap
    out[:end] = row[:end]
    return out


def sample_bookkeeping(row, eos, unk):
    """The sampling loop's bookkeeping on a greedy row (EOS at step 0 ->
    UNK, the last step EOS, PAD after the first EOS)."""
    out = row.copy()
    if out[0] == eos:
        out[0] = unk
    out[-1] = eos
    hits = np.flatnonzero(row == eos)
    if len(hits):
        out[hits[0] + 1:] = 0
    return out


@pytest.fixture(scope="module")
def toy():
    # the JAX tree's layout from the port's model (no JAX init traced);
    # test_bridge_maps_every_leaf holds it to the JAX model's reads
    params = random_tree(jax_tree_from_port(create_model(
        "masque", ModelConfig(**CFG), device="cpu")), seed=0)
    pool = requests(1, 24)

    def port_model(eos):
        m = create_model("masque", ModelConfig(**dict(CFG, eos_id=eos)),
                         device="cpu")
        load_jax_params(m, params)
        return m

    ids = make_predict_fn(port_model(3), ModelConfig(**CFG), T,
                          device="cpu")(pool)["answer"].numpy()
    rows_with = {v: int((ids == v).any(-1).sum()) for v in np.unique(ids)}
    eos = max(rows_with, key=lambda v: min(rows_with[v],
                                           len(ids) - rows_with[v]))
    first = np.array([np.flatnonzero(r == eos)[0] if (r == eos).any() else T
                      for r in ids])
    ending, never = np.flatnonzero(first < T), np.flatnonzero(first == T)
    assert len(ending) >= 3 and len(never) >= 3
    assert len(set(first[ending])) > 1
    parity = take(pool, np.concatenate([ending[:3], never[:3]]))
    jcfg = JConfig(**dict(CFG, eos_id=eos))
    jmodel = jcreate("masque", jcfg)
    variables, jb = {"params": params}, {k: jnp.asarray(v)
                                         for k, v in parity.items()}
    ref = {"beam3": run_jit(jmake_predict(jmodel, jcfg, T, beam_width=3),
                            variables, jb)}

    def grads(p, b):
        def losses(p):
            out = jmodel.apply({"params": p}, b, deterministic=True,
                               method=type(jmodel).train_losses)
            return jnp.stack([out["select"], out["gen"]]), out
        # one reverse pass for both losses (cheaper to build than a second
        # program for ps_train): a row of gradients each; ps_train trains
        # on the unscaled selection loss, 4x the train mode's "select"
        # (MasqueModel.train_losses)
        rows, out = jax.jacrev(losses, has_aux=True)(p)
        return {"train": (out, jax.tree_util.tree_map(lambda r: r.sum(0),
                                                      rows)),
                "ps_train": ({"select": 4.0 * out["select"]},
                             jax.tree_util.tree_map(lambda r: 4.0 * r[0],
                                                    rows))}

    ref.update(run_jit(grads, params, jb))

    def init(p, b):
        return jmodel.apply({"params": p}, b, max_len=T,
                            method=type(jmodel).decode_init)

    def chunk(p, st):
        return jmodel.apply({"params": p}, st, n_steps=2,
                            method=type(jmodel).decode_chunk)

    b = dict(jb, response_cap=jnp.asarray(CAPS))
    start = jax.jit(init).lower(params, b).compile(FAST_COMPILE)
    st, _ = start(params, b)
    step = jax.jit(chunk).lower(params, st).compile(FAST_COMPILE)

    def chunks(st):
        seen = []
        for _ in range(T // 2):
            st = step(params, st)
            seen.append({k: st[k] for k in ("out", "trow", "done")})
        return seen

    ref["lockstep"] = chunks(st)
    # uncapped, the chunked decode's answers are the one-shot greedy
    # answers cut at their first EOS (the JAX package holds them equal)
    st, rank = start(params, dict(jb, response_cap=jnp.full(
        (len(CAPS),), T, jnp.int32)))
    ref["greedy"] = {"answer": chunks(st)[-1]["out"], "rank": rank}
    ref = jax.tree_util.tree_map(np.asarray, ref)
    return {"params": params, "eos": eos,
            "cfg": ModelConfig(**dict(CFG, eos_id=eos)),
            "port": port_model(eos), "parity": parity, "pool": pool,
            "ref": ref}


def test_bridge_maps_every_leaf(toy):
    """The tree maps onto every port parameter, and every leaf of it is one
    the JAX model reads: its train-mode gradient there is nonzero (and
    flax checked the shape of each leaf it read)."""
    sd = state_dict_from_jax(toy["params"])
    params = dict(toy["port"].named_parameters())
    assert set(sd) == set(params)
    for k, arr in sd.items():
        np.testing.assert_array_equal(params[k].detach().numpy(), arr,
                                      err_msg=k)
    grads = state_dict_from_jax(toy["ref"]["train"][1])
    assert set(grads) == set(sd)
    assert [k for k, g in grads.items() if not g.any()] == []


@pytest.mark.parametrize("mode", ["train", "ps_train"])
def test_losses_and_gradients_match_jax(toy, mode):
    jlosses, jgrads = toy["ref"][mode]
    model = toy["port"]
    tb = batch_to_device(toy["parity"], torch.device("cpu"))
    losses = model.train_losses(tb, None, mode=mode)
    assert set(losses) == set(jlosses)
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), float(jlosses[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(sum(losses.values()), list(params.values()),
                                allow_unused=True, materialize_grads=True)
    want = state_dict_from_jax(jgrads)
    for (k, p), g in zip(params.items(), grads):
        np.testing.assert_allclose(g.numpy(), want[k], rtol=GRAD_TOL,
                                   atol=GRAD_TOL * np.abs(want[k]).max(),
                                   err_msg=k)
    if mode == "ps_train":
        assert all(not g.any() for k, g in zip(params, grads)
                   if k.startswith("decoder."))


@pytest.mark.parametrize("fused", [False, True], ids=["chain", "fused"])
@pytest.mark.parametrize("mode", ["dense", "pallas"])
def test_greedy_matches_jax(toy, mode, fused):
    try:
        multimem.set_fused_stack(fused)
        out = make_predict_fn(toy["port"], toy["cfg"], T, fast_argmax=mode,
                              device="cpu")(toy["parity"])
    finally:
        multimem.set_fused_stack(None)
    got = np.stack([cut(r, T, toy["eos"]) for r in out["answer"].numpy()])
    np.testing.assert_array_equal(got, toy["ref"]["greedy"]["answer"])
    np.testing.assert_allclose(out["rank"].numpy(),
                               toy["ref"]["greedy"]["rank"], rtol=0,
                               atol=RANK_TOL)


def test_rank_only_matches_jax(toy):
    out = make_predict_fn(toy["port"], toy["cfg"], T, rank_only=True,
                          device="cpu")(toy["parity"])
    assert set(out) == {"rank"}
    np.testing.assert_allclose(out["rank"].numpy(),
                               toy["ref"]["greedy"]["rank"], rtol=0,
                               atol=RANK_TOL)


def test_beam_width_3_matches_jax(toy):
    out = make_predict_fn(toy["port"], toy["cfg"], T, beam_width=3,
                          device="cpu")(toy["parity"])
    np.testing.assert_array_equal(out["answer"].numpy(),
                                  toy["ref"]["beam3"]["answer"])
    np.testing.assert_allclose(out["rank"].numpy(),
                               toy["ref"]["beam3"]["rank"], rtol=0,
                               atol=RANK_TOL)


def test_sample_top_k_1_is_jax_greedy(toy):
    got = make_predict_fn(toy["port"], toy["cfg"], T, decoding="sample",
                          top_k=1, sample_seed=3,
                          device="cpu")(toy["parity"])["answer"].numpy()
    want = np.stack([sample_bookkeeping(r, toy["eos"], toy["cfg"].unk_id)
                     for r in toy["ref"]["greedy"]["answer"]])
    np.testing.assert_array_equal(got, want)


def test_chunked_decode_lockstep_matches_jax(toy):
    batch = batch_to_device(dict(toy["parity"], response_cap=CAPS),
                            torch.device("cpu"))
    with torch.inference_mode():
        st, _ = toy["port"].decode_init(batch, max_len=T)
        for i, want in enumerate(toy["ref"]["lockstep"]):
            st = toy["port"].decode_chunk(st, n_steps=2)
            for k in ("out", "trow", "done"):
                np.testing.assert_array_equal(st[k].numpy(), want[k],
                                              err_msg=f"chunk {i} {k}")
    assert toy["ref"]["lockstep"][-1]["done"].all()


@pytest.mark.parametrize("device_loop", [False, True],
                         ids=["chunk-loop", "device-loop"])
def test_continuous_serving_equals_one_shot(toy, device_loop):
    reqs = take(toy["pool"], np.arange(10))
    caps = np.random.RandomState(4).randint(2, T + 1, 10)
    one_shot = make_predict_fn(toy["port"], toy["cfg"], T, device="cpu")(
        reqs)
    got, ranks = {}, {}

    def make(items, bs):
        idx = [r["i"] for r in items]
        idx += [idx[-1]] * (bs - len(idx))
        return dict(take(reqs, idx), response_cap=caps[idx])

    def emit(r, ids, rk):
        got[r["i"]], ranks[r["i"]] = ids.copy(), rk

    items = iter([{"i": i} for i in range(10)])
    if device_loop:
        fns = make_device_loop_fns(toy["port"], T, 2, n_chunks=2,
                                   stage_rows=4, fast_argmax="pallas",
                                   device="cpu")
        run_continuous_device(items, make, fns, 4, 2, emit, max_len=T)
    else:
        run_continuous(items, make, *make_continuous_fns(
            toy["port"], T, 2, fast_argmax="pallas", device="cpu"),
            batch_size=4, refill=2, emit=emit)
    for i in range(10):
        np.testing.assert_array_equal(
            got[i], cut(one_shot["answer"][i].numpy(), caps[i], toy["eos"]),
            err_msg=f"request {i}")
        np.testing.assert_allclose(ranks[i], one_shot["rank"][i].numpy(),
                                   rtol=0, atol=1e-5)


def test_sampled_continuous_equals_one_shot(toy):
    reqs = take(toy["pool"], np.arange(8))
    keys = np.stack([np.random.SeedSequence([5, i]).generate_state(
        2, np.uint32) for i in range(8)])
    ctl = np.tile(np.array([[0.9, 20, 0.95]], np.float32), (8, 1))
    ctl[::3] = (1.3, 0, 1.0)
    one_shot = [make_predict_fn(
        toy["port"], toy["cfg"], T, decoding="sample",
        temperature=float(ctl[i, 0]), top_k=int(ctl[i, 1]),
        top_p=float(ctl[i, 2]), device="cpu")(dict(
            take(reqs, [i]), sample_key=keys[[i]]))["answer"].numpy()[0]
        for i in range(8)]
    got = {}

    def make(items, bs):
        idx = [r["i"] for r in items]
        idx += [idx[-1]] * (bs - len(idx))
        return dict(take(reqs, idx), sample_key=keys[idx],
                    sample_ctl=ctl[idx])

    run_continuous(iter([{"i": i} for i in range(8)]), make,
                   *make_continuous_fns(toy["port"], T, 2, decoding="sample",
                                        device="cpu"),
                   batch_size=4, refill=2,
                   emit=lambda r, ids, rk: got.__setitem__(r["i"],
                                                           ids.copy()))
    for i in range(8):
        np.testing.assert_array_equal(got[i], one_shot[i],
                                      err_msg=f"request {i}")
