"""CaSE's beam search and categorical sampling in the port, against the JAX
package, in f32 on the CPU (case_rg_tpu_torch/decode/loops.py,
models/multimem.py ``sample``/``beam``/sampled ``chunk_step``).

Held here:

* ``sampling_controls`` and ``sampling_controls_rows`` equal the JAX
  package's over a grid of (temperature, top_k, top_p);
* beam search at width 1 is the port's greedy decode (cut at its first
  EOS), and at width 3 token-identical to the JAX package's
  ``CaSEModel.predict(beam_width=3)``, with the layer chain's caches and
  with the fused stack's, reordered by beam every step;
* sampling at top_k = 1 (all mass on one token, so the draw does not
  matter) is the JAX package's greedy answer under the sampling
  bookkeeping (EOS at step 0 -> UNK, the last step EOS, PAD after EOS), and
  its ``predict`` with ``sample_rng`` and top_k = 1;
* sampled continuous serving gives every request the one-shot ``sample``
  answer of its key, bit for bit, whatever the batch width, chunk and
  refill order; a repeat with the same keys is the same; sampling with
  ``beam_width > 1`` and sampled chunks without keys raise, and the new
  entry points refuse the CPU unless asked.

The JAX package's threefry streams are not reproduced: real sampling is
held to the port's own one-shot draw, not to JAX's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from case_rg_tpu.config import ModelConfig as JConfig
from case_rg_tpu.decode import loops as jloops
from case_rg_tpu.models import create_model as jcreate
from case_rg_tpu.runtime.inference import make_predict_fn as jmake_predict
from case_rg_tpu_torch.bridge import load_jax_params
from case_rg_tpu_torch.config import ModelConfig
from case_rg_tpu_torch.decode import loops
from case_rg_tpu_torch.device import batch_to_device
from case_rg_tpu_torch.models import create_model, multimem
from case_rg_tpu_torch.runtime.continuous import (make_continuous_fns,
                                                  run_continuous)
from case_rg_tpu_torch.runtime.inference import make_predict_fn
from tests.test_torch_bridge import TOY, jax_case_params
from tests.test_torch_continuous import random_tree, requests, take
from tests.test_torch_kernels import one_torch_thread  # noqa: F401

MAX_LEN = 10
CFG = dict(TOY, vocab_size=128, dec_layers=1, max_dec_len=MAX_LEN)
CONTROLS = dict(temperature=0.9, top_k=20, top_p=0.95)
torch.set_float32_matmul_precision("highest")


@pytest.fixture(scope="module")
def toy():
    """The JAX model and the bridged port at an EOS the greedy decode
    really emits, and a batch of 6 rows of which some end early."""
    params = random_tree(jax_case_params(CFG, abstract=True), seed=0)
    pool = requests(1, 24)

    def port_model(eos):
        m = create_model("case", ModelConfig(**dict(CFG, eos_id=eos)),
                         device="cpu")
        load_jax_params(m, params)
        return m

    ids = make_predict_fn(port_model(3), ModelConfig(**CFG), MAX_LEN,
                          device="cpu")(pool)["answer"].numpy()
    rows_with = {v: int((ids == v).any(-1).sum()) for v in np.unique(ids)}
    eos = max(rows_with, key=rows_with.get)
    ending = [i for i in range(len(ids)) if (ids[i] == eos).any()]
    others = [i for i in range(len(ids)) if i not in ending]
    assert len(ending) >= 3 and len(others) >= 3
    cfg = ModelConfig(**dict(CFG, eos_id=eos))
    return {"params": params, "eos": eos, "cfg": cfg,
            "port": port_model(eos),
            "jmodel": jcreate("case", JConfig(**dict(CFG, eos_id=eos))),
            "jcfg": JConfig(**dict(CFG, eos_id=eos)),
            "batch": take(pool, ending[:3] + others[:3]), "pool": pool}


def _logits(seed, b=6, v=50):
    return np.random.RandomState(seed).randn(b, v).astype(np.float32) * 2


@pytest.mark.parametrize("temperature", [1.0, 0.7])
@pytest.mark.parametrize("top_k", [0, 1, 7])
@pytest.mark.parametrize("top_p", [1.0, 0.9, 0.4])
def test_sampling_controls_match_jax(temperature, top_k, top_p):
    x = _logits(top_k)
    got = loops.sampling_controls(torch.from_numpy(x), temperature, top_k,
                                  top_p)
    want = jloops.sampling_controls(jnp.asarray(x), temperature, top_k, top_p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampling_controls_rows_match_jax():
    grid = [(t, k, p) for t in (1.0, 0.7, 1.3) for k in (0, 1, 7)
            for p in (1.0, 0.9, 0.4)]
    x = _logits(5, b=len(grid))
    ctl = np.array(grid, np.float32)
    got = loops.sampling_controls_rows(
        torch.from_numpy(x), torch.from_numpy(ctl[:, 0]),
        torch.from_numpy(ctl[:, 1]).long(), torch.from_numpy(ctl[:, 2]))
    want = jloops.sampling_controls_rows(
        jnp.asarray(x), jnp.asarray(ctl[:, 0]),
        jnp.asarray(ctl[:, 1]).astype(jnp.int32), jnp.asarray(ctl[:, 2]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for r, (t, k, p) in enumerate(grid):      # each row is the batch form
        np.testing.assert_array_equal(
            got[r:r + 1].numpy(),
            loops.sampling_controls(torch.from_numpy(x[r:r + 1]), t, int(k),
                                    p).numpy())


def _decoder_inputs(port, batch):
    with torch.inference_mode():
        bt = batch_to_device(batch, torch.device("cpu"))
        return port._decoder_inputs(bt, port.stages(bt))


def _after_eos(row, eos):
    out = row.copy()
    hits = np.flatnonzero(out == eos)
    if len(hits):
        out[hits[0] + 1:] = 0
    return out


def test_beam_width_1_is_greedy(toy):
    memories, keeps, weights, src_ids, feat = _decoder_inputs(toy["port"],
                                                              toy["batch"])
    with torch.inference_mode():
        beam = toy["port"].decoder.beam(memories, keeps, weights, src_ids,
                                        MAX_LEN, 1, feature=feat).numpy()
    greedy = make_predict_fn(toy["port"], toy["cfg"], MAX_LEN,
                             device="cpu")(toy["batch"])["answer"].numpy()
    assert (greedy == toy["eos"]).any(-1).sum() >= 3
    np.testing.assert_array_equal(
        beam, np.stack([_after_eos(r, toy["eos"]) for r in greedy]))


@pytest.mark.parametrize("fused", [False, True])
def test_beam_width_3_matches_jax(toy, fused):
    """With the layer chain's per-layer caches, and with the fused stack's
    [B*W, n_layers, T, 2E] cache (its plain version), reordered by beam
    every step."""
    if "beam3" not in toy:
        toy["beam3"] = np.asarray(jmake_predict(
            toy["jmodel"], toy["jcfg"], MAX_LEN, beam_width=3)(
            {"params": toy["params"]},
            {k: jnp.asarray(v) for k, v in toy["batch"].items()})["answer"])
    try:
        multimem.set_fused_stack(fused)
        got = make_predict_fn(toy["port"], toy["cfg"], MAX_LEN, beam_width=3,
                              device="cpu")(toy["batch"])["answer"].numpy()
    finally:
        multimem.set_fused_stack(None)
    np.testing.assert_array_equal(got, toy["beam3"])
    assert (got == toy["eos"]).any(-1).sum() >= 1


def _bookkeeping(row, eos, unk):
    """The sampling loops' EOS bookkeeping on a greedy row."""
    out = row.copy()
    if out[0] == eos:
        out[0] = unk
    out[-1] = eos
    hits = np.flatnonzero(row == eos)
    if len(hits):
        out[hits[0] + 1:] = 0
    return out


def test_sample_top_k_1_is_jax_greedy(toy):
    jbatch = {k: jnp.asarray(v) for k, v in toy["batch"].items()}
    greedy = np.asarray(jmake_predict(toy["jmodel"], toy["jcfg"], MAX_LEN)(
        {"params": toy["params"]}, jbatch)["answer"])
    jsample = np.asarray(jmake_predict(
        toy["jmodel"], toy["jcfg"], MAX_LEN, decoding="sample", top_k=1)(
        {"params": toy["params"]}, jbatch)["answer"])
    got = make_predict_fn(toy["port"], toy["cfg"], MAX_LEN,
                          decoding="sample", top_k=1, sample_seed=3,
                          device="cpu")(toy["batch"])["answer"].numpy()
    want = np.stack([_bookkeeping(r, toy["eos"], toy["cfg"].unk_id)
                     for r in greedy])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jsample)


def _keys(n, seed=5):
    return np.stack([np.random.SeedSequence([seed, i]).generate_state(
        2, np.uint32) for i in range(n)])


@pytest.mark.parametrize("batch_size,refill,chunk,per_row", [
    (4, 2, 3, False), (3, 1, 4, False), (4, 3, 2, True)])
def test_sampled_continuous_matches_one_shot(toy, batch_size, refill, chunk,
                                             per_row):
    """Each request's sampled answer through continuous batching is the
    one-shot sample of its key, bit for bit, whatever the batch width,
    chunk size and refill order; per-row controls ride with their rows."""
    n = 10
    reqs = take(toy["pool"], np.arange(n))
    keys = _keys(n)
    ctl = np.tile(np.array([[CONTROLS["temperature"], CONTROLS["top_k"],
                             CONTROLS["top_p"]]], np.float32), (n, 1))
    if per_row:
        ctl[::3] = (1.0, 1, 1.0)             # greedy rows among sampled ones
        ctl[1::3] = (1.3, 0, 1.0)
    one_shot = {}
    for i in range(n):
        fn = make_predict_fn(toy["port"], toy["cfg"], MAX_LEN,
                             decoding="sample", temperature=float(ctl[i, 0]),
                             top_k=int(ctl[i, 1]), top_p=float(ctl[i, 2]),
                             device="cpu")
        one_shot[i] = fn(dict(take(reqs, [i]), sample_key=keys[[i]])
                         )["answer"].numpy()[0]

    def make_batch(items, bs):
        idx = [r["i"] for r in items]
        idx += [idx[-1]] * (bs - len(idx))
        bt = dict(take(reqs, idx), sample_key=keys[idx])
        if per_row:
            bt["sample_ctl"] = ctl[idx]
        return bt

    fns = make_continuous_fns(toy["port"], MAX_LEN, chunk, decoding="sample",
                              device="cpu", **CONTROLS)
    for _ in range(2):                        # a repeat draws the same
        got = {}
        stats = run_continuous(iter([{"i": i} for i in range(n)]),
                               make_batch, *fns, batch_size=batch_size,
                               refill=refill,
                               emit=lambda r, ids, rk: got.__setitem__(
                                   r["i"], ids.copy()))
        assert stats["served"] == n and stats["refills"] >= 1
        for i in range(n):
            np.testing.assert_array_equal(got[i], one_shot[i],
                                          err_msg=f"request {i}")
    greedy = make_predict_fn(toy["port"], toy["cfg"], MAX_LEN,
                             device="cpu")(reqs)["answer"].numpy()
    assert any(not np.array_equal(one_shot[i][:-1], greedy[i][:-1])
               for i in range(n)), "sampling drew only greedy answers"


def test_sampling_refuses_beams_and_missing_keys(toy):
    with pytest.raises(ValueError, match="beam_width"):
        make_predict_fn(toy["port"], toy["cfg"], MAX_LEN, decoding="sample",
                        beam_width=2, device="cpu")
    with pytest.raises(ValueError, match="beam_width"):
        toy["port"].predict(batch_to_device(toy["batch"], torch.device("cpu")),
                            max_len=MAX_LEN, beam_width=2, sample_seed=0)
    with pytest.raises(ValueError, match="temperature"):
        make_predict_fn(toy["port"], toy["cfg"], MAX_LEN, decoding="sample",
                        temperature=0.0, device="cpu")
    init_fn, _, _ = make_continuous_fns(toy["port"], MAX_LEN, 3,
                                        decoding="sample", device="cpu")
    with pytest.raises(ValueError, match="sample_key"):
        init_fn(toy["batch"])
    fn = make_predict_fn(toy["port"], toy["cfg"], MAX_LEN, decoding="sample",
                         sample_seed=11, device="cpu")
    a, b = fn(toy["batch"])["answer"], fn(toy["batch"])["answer"]
    assert not torch.equal(a, b), "successive calls drew the same keys"
    again = make_predict_fn(toy["port"], toy["cfg"], MAX_LEN,
                            decoding="sample", sample_seed=11,
                            device="cpu")(toy["batch"])["answer"]
    assert torch.equal(a, again)


def test_new_entry_points_refuse_the_cpu_unless_asked(toy, monkeypatch):
    """Beam and sampled serving, one-shot and continuous, default to the
    card and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({"beam_width": 3}, {"decoding": "sample"}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_predict_fn(toy["port"], toy["cfg"], MAX_LEN, **kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_continuous_fns(toy["port"], MAX_LEN, 3, decoding="sample")
