"""CaSE's greedy argmax modes, chunked decode and continuous-batching
serving in the port, against the JAX package, in f32 on the CPU.

One toy CaSE (bridged weights with noisy biases and LayerNorm gains, one
decoder layer per stack) serves everything. Its EOS is a token the greedy
decode really emits, so rows end at staggered steps. Held here:

* ``predict`` in the dense, mxu and pallas argmax modes, with and without
  ``early_exit``: answers token-identical to the JAX package's (its Pallas
  combine run in interpret mode);
* ``decode_init`` + ``decode_chunk`` in lockstep with the JAX package's
  chunked decode: ``out``, ``done`` and ``trow`` equal after every chunk,
  with the layer chain and with the fused stack step;
* ``refill_rows``, ``run_continuous`` in every combination of its options
  and from a queue fed by another thread, and ``run_continuous_multi`` over
  two pool buckets: every request's answer
  equals the port's one-shot ``predict``, cut at the request's cap and at
  its EOS, in arrival order;
* the entry points refuse the CPU unless asked.
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from case_rg_tpu.config import ModelConfig as JConfig
from case_rg_tpu.kernels import copy_argmax as jca
from case_rg_tpu.models import create_model as jcreate
from case_rg_tpu_torch.bridge import load_jax_params
from case_rg_tpu_torch.config import ModelConfig
from case_rg_tpu_torch.device import batch_to_device
from case_rg_tpu_torch.models import create_model, multimem
from case_rg_tpu_torch.runtime.continuous import (make_continuous_fns,
                                                  refill_rows)
from case_rg_tpu_torch.runtime.inference import make_predict_fn
from tests.test_torch_bridge import TOY, jax_case_params
from tests.test_torch_kernels import one_torch_thread  # noqa: F401

MAX_LEN = 12
CFG = dict(TOY, vocab_size=128, dec_layers=1, max_dec_len=MAX_LEN)
MODES = ("dense", "mxu", "pallas")
N_REQ = 8           # requests served by the continuous drivers
torch.set_float32_matmul_precision("highest")


def random_tree(shapes, seed):
    """A CaSE param tree of numpy arrays from a seed: Glorot-scaled
    weights, noisy biases, LayerNorm gains near 1."""
    rng = np.random.RandomState(seed)

    def walk(node):
        out = {}
        for key in sorted(node):
            leaf = node[key]
            if hasattr(leaf, "items"):
                out[key] = walk(leaf)
            elif key in ("bias", "qkv_bias"):
                out[key] = 0.1 * rng.randn(*leaf.shape)
            elif key == "scale":
                out[key] = 1 + 0.1 * rng.randn(*leaf.shape)
            else:
                fan = sum(leaf.shape[-2:]) if leaf.ndim > 1 else 2 * leaf.size
                out[key] = np.sqrt(2.0 / fan) * rng.randn(*leaf.shape)
            if not hasattr(leaf, "items"):
                out[key] = out[key].astype(np.float32)
        return out

    return walk(shapes)


def requests(seed, n, pools=3):
    """Query and pool ids with padded tails (one passage all padding)."""
    rng = np.random.RandomState(seed)
    q = rng.randint(4, CFG["vocab_size"], (n, 1, 10)).astype(np.int32)
    p = rng.randint(4, CFG["vocab_size"], (n, pools, 12)).astype(np.int32)
    for i in range(n):
        q[i, :, rng.randint(5, 11):] = 0
        p[i, :, rng.randint(6, 13):] = 0
    p[1, -1] = 0
    return {"query": q, "passage": p}


def take(arrays, idx):
    return {k: v[idx] for k, v in arrays.items()}


def cut(row, cap, eos):
    """What a row capped at ``cap`` emits: tokens up to its cap and its
    first EOS, PAD after."""
    out = np.zeros(MAX_LEN, np.int32)
    end = cap
    hits = np.flatnonzero(row[:cap] == eos)
    if len(hits):
        end = hits[0] + 1
    out[:end] = row[:end]
    return out


@pytest.fixture(scope="module")
def toy():
    """The JAX model and the bridged port at a live EOS, the batch the
    parity tests decode (every row emits EOS, at staggered steps), the
    requests the continuous drivers serve, and the port's one-shot answers
    for them."""
    params = random_tree(jax_case_params(CFG, abstract=True), seed=0)
    pool = requests(1, 40)

    def port_model(eos):
        m = create_model("case", ModelConfig(**dict(CFG, eos_id=eos)),
                         device="cpu")
        load_jax_params(m, params)
        return m

    # the EOS: the token found in the most rows' greedy answers
    ids = make_predict_fn(port_model(3), ModelConfig(**CFG), MAX_LEN,
                          device="cpu")(pool)["answer"].numpy()
    rows_with = {v: int((ids == v).any(-1).sum()) for v in np.unique(ids)}
    eos = max(rows_with, key=rows_with.get)
    first = np.array([np.flatnonzero(r == eos)[0] if (r == eos).any()
                      else MAX_LEN for r in ids])
    ending = [i for i in np.argsort(first, kind="stable") if first[i] < MAX_LEN]
    assert len(ending) >= 8 and len(set(first[ending[:8]])) > 1
    cfg = ModelConfig(**dict(CFG, eos_id=eos))
    port = port_model(eos)
    # parity batch: 8 rows that all end; served requests: half never end
    never = np.flatnonzero(first == MAX_LEN)
    assert len(never) >= N_REQ // 2
    parity = take(pool, ending[:8])
    served = take(pool, np.concatenate([ending[4:4 + N_REQ // 2],
                                        never[:N_REQ // 2]]))
    caps = np.random.RandomState(2).randint(3, MAX_LEN + 1, N_REQ)
    caps[:2] = MAX_LEN
    one_shot = make_predict_fn(port, cfg, MAX_LEN, fast_argmax="pallas",
                               device="cpu")(served)
    return {"params": params, "eos": eos, "cfg": cfg, "port": port,
            "jmodel": jcreate("case", JConfig(**dict(CFG, eos_id=eos))),
            "parity": parity, "served": served, "caps": caps,
            "answers": one_shot["answer"].numpy(),
            "rank": one_shot["rank"].numpy(), "jax": {}}


def jax_decoder_inputs(toy):
    """The JAX package's decoder inputs for the parity batch (one jit)."""
    if "inputs" not in toy["jax"]:
        def stages(p, b):
            def f(mdl, b):
                return mdl._decoder_inputs(b, mdl.stages(b, deterministic=True))
            return toy["jmodel"].apply({"params": p}, b, method=f)
        batch = {k: jnp.asarray(v) for k, v in toy["parity"].items()}
        toy["jax"]["inputs"] = jax.jit(stages)(toy["params"], batch)
    return toy["jax"]["inputs"]


def with_interpret(fn):
    saved = jca._FORCE_INTERPRET
    jca._FORCE_INTERPRET = True
    try:
        return fn()
    finally:
        jca._FORCE_INTERPRET = saved


@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_predict_modes_match_jax(toy, mode, early_exit):
    memories, keeps, weights, src_ids, feat = jax_decoder_inputs(toy)

    def decode(p):
        return toy["jmodel"].apply({"params": p}, method=lambda m: m.decoder
                                   .decode(memories, keeps, weights, src_ids,
                                           MAX_LEN, feature=feat,
                                           early_exit=early_exit,
                                           fast_argmax=mode))

    want = np.asarray(with_interpret(lambda: jax.jit(decode)(toy["params"])))
    got = make_predict_fn(toy["port"], toy["cfg"], MAX_LEN,
                          early_exit=early_exit, fast_argmax=mode,
                          device="cpu")(toy["parity"])["answer"].numpy()
    np.testing.assert_array_equal(got, want)
    if early_exit:
        # every row ends, so the decode stopped early and left PAD behind
        assert (got[:, -1] == 0).all() and (got == toy["eos"]).any(-1).all()


@pytest.mark.parametrize("fused", [False, True])
def test_chunked_decode_lockstep_matches_jax(toy, fused):
    """Chunks of 3 steps, per-row caps, pallas mode: the port's state after
    every chunk equals the JAX package's (layer chain or fused stack)."""
    memories, keeps, weights, src_ids, feat = jax_decoder_inputs(toy)
    caps = np.array([MAX_LEN, 4, MAX_LEN, 7, 2, MAX_LEN, 9, MAX_LEN])
    if "chunks" not in toy["jax"]:
        def init(p):
            return toy["jmodel"].apply({"params": p}, method=lambda m: m
                                       .decoder.chunk_init(
                                           memories, keeps, weights, src_ids,
                                           MAX_LEN, feature=feat,
                                           fast_argmax="pallas",
                                           row_max=jnp.asarray(caps)))

        def step(p, st):
            return toy["jmodel"].apply({"params": p}, method=lambda m: m
                                       .decoder.chunk_step(
                                           st, 3, fast_argmax="pallas"))

        def run():
            st = jax.jit(init)(toy["params"])
            chunk = jax.jit(step)
            seen = []
            for _ in range(MAX_LEN // 3 + 1):
                st = chunk(toy["params"], st)
                seen.append({k: np.asarray(st[k])
                             for k in ("out", "done", "trow")})
            return seen

        toy["jax"]["chunks"] = with_interpret(run)
    want = toy["jax"]["chunks"]
    batch = batch_to_device(dict(toy["parity"], response_cap=caps),
                            torch.device("cpu"))
    try:
        multimem.set_fused_stack(fused)
        with torch.inference_mode():
            st, rank = toy["port"].decode_init(batch, max_len=MAX_LEN,
                                               fast_argmax="pallas")
            assert all((c is None) == fused for c in st["cross"])
            for w in want:
                prev_out = st["out"]
                st = toy["port"].decode_chunk(st, n_steps=3,
                                              fast_argmax="pallas")
                assert st["out"] is not prev_out
                for k in ("out", "done", "trow"):
                    np.testing.assert_array_equal(st[k].numpy(), w[k],
                                                  err_msg=k)
    finally:
        multimem.set_fused_stack(None)
    assert want[-1]["done"].all()
    assert len(set(want[-1]["trow"].tolist())) > 2, "rows ended in lockstep"


def _expected(toy, i):
    return cut(toy["answers"][i], toy["caps"][i], toy["eos"])


def _make_batch(arrays, caps):
    def make_batch(reqs, bs):
        idx = [r["i"] for r in reqs]
        idx += [idx[-1]] * (bs - len(idx))       # padding rows repeat
        return dict(take(arrays, idx), response_cap=caps[idx])
    return make_batch


def test_refill_rows_drops_padding_rows(toy):
    """Rows 1 and 3 of a half-decoded state take a fresh state's rows 0
    and 1; the padding entries (>= B) are dropped; every row then decodes
    as its request's one-shot answer."""
    init_fn, chunk_fn, refill_fn = make_continuous_fns(
        toy["port"], MAX_LEN, 3, fast_argmax="pallas", device="cpu")
    mb = _make_batch(toy["served"], toy["caps"])
    state, _ = init_fn(mb([{"i": i} for i in range(4)], 4))
    state = chunk_fn(chunk_fn(state))
    new_state, _ = init_fn(mb([{"i": 4}, {"i": 5}], 4))
    kept = {k: state[k].clone() for k in ("out", "trow", "done")}
    assert refill_rows(state, new_state, np.array([1, 3, 4, 99])) is state
    for k, v in kept.items():
        np.testing.assert_array_equal(state[k][[0, 2]].numpy(),
                                      v[[0, 2]].numpy())
        np.testing.assert_array_equal(state[k][[1, 3]].numpy(),
                                      new_state[k][[0, 1]].numpy())
    for _ in range(MAX_LEN // 3 + 2):
        state = chunk_fn(state)
    assert state["done"].all()
    for row, i in zip(range(4), (0, 4, 2, 5)):
        np.testing.assert_array_equal(state["out"][row].numpy(),
                                      _expected(toy, i), err_msg=f"row {row}")


MATRIX = [pytest.param(la, ah, rm, od, sc,
                       id=f"la{la:d}-ah{ah:d}-rm{rm}-od{od:d}-st{sc:d}")
          for la, ah, rm, od, sc in itertools.product(
              (False, True), (False, True), (1, 2), (True, False),
              (False, True))]
