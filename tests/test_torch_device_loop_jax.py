"""The device loop against the JAX package's ``run_continuous_device``, its
multi-lane driver, and its refusal of the CPU (moved from
``tests/test_torch_device_loop.py``, whose module fixture and docstring
they share)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from case_rg_tpu.runtime.continuous.device_loop import (
    make_device_loop_fns as jmake_device_loop_fns,
    run_continuous_device as jrun_continuous_device)
from case_rg_tpu_torch.runtime.continuous import (DeviceLane,
                                                  make_device_loop_fns,
                                                  run_continuous_device_multi)
from case_rg_tpu_torch.runtime.inference import make_predict_fn
from tests.test_torch_continuous import (  # noqa: F401
    MAX_LEN, N_REQ, _expected, _make_batch, cut, take, toy, with_interpret)
from tests.test_torch_device_loop import _serve  # noqa: F401
from tests.test_torch_kernels import one_torch_thread  # noqa: F401


def test_device_loop_matches_jax_device_loop(toy):
    """b 4, refill 2, a ring of 2 (it wraps), 4 chunks of 2 steps a mega,
    pallas mode: the JAX package's loop and the port's serve the same
    answers, ranks and stats."""
    b, refill, stage, n_chunks, chunk_steps = 4, 2, 2, 4, 2
    caps = toy["caps"]

    def jmake_batch(reqs, bs):
        idx = [r["i"] for r in reqs]
        idx += [idx[-1]] * (bs - len(idx))
        return {k: jnp.asarray(v) for k, v in
                dict(take(toy["served"], idx), response_cap=caps[idx]).items()}

    jfns = jmake_device_loop_fns(toy["jmodel"], MAX_LEN, chunk_steps,
                                 n_chunks, stage, fast_argmax="pallas")
    want = []
    jstats = with_interpret(lambda: jrun_continuous_device(
        iter([{"i": i} for i in range(N_REQ)]), jmake_batch, jfns,
        {"params": toy["params"]}, batch_size=b, refill=refill,
        emit=lambda r, ids, rk: want.append((r["i"], np.asarray(ids).copy(),
                                             np.asarray(rk).copy())),
        max_len=MAX_LEN))
    fns = make_device_loop_fns(toy["port"], MAX_LEN, chunk_steps, n_chunks,
                               stage, fast_argmax="pallas", device="cpu")
    got, stats = _serve(toy, fns, b, refill)
    assert stats == jstats
    assert jstats["refills"] >= 2 and jstats["megas"] >= 2
    assert [i for i, _, _ in got] == [i for i, _, _ in want]
    for (i, ids, rk), (_, jids, jrk) in zip(got, want):
        np.testing.assert_array_equal(ids, jids, err_msg=f"request {i}")
        np.testing.assert_allclose(rk, jrk, rtol=0, atol=1e-6)


def test_device_loop_multi_two_buckets(toy):
    """Requests routed by pool size to a 2-passage and a 3-passage lane of
    one DeviceLoopFns (buffers kept per lane shape): each answer equals the
    single-lane device loop's at its bucket, in arrival order."""
    small = {"query": toy["served"]["query"],
             "passage": toy["served"]["passage"][:, :2]}
    route_small = np.arange(N_REQ) % 3 == 0
    fns = make_device_loop_fns(toy["port"], MAX_LEN, 3, 2, 3,
                               fast_argmax="pallas", device="cpu")
    single = {}
    for key, arrays in (("small", small), ("full", toy["served"])):
        got, _ = _serve(toy, fns, 3, 2, arrays=arrays)
        single[key] = {i: ids for i, ids, _ in got}
    lanes = {key: DeviceLane(key, _make_batch(arrays, toy["caps"]), fns,
                             batch_size=3, refill=2)
             for key, arrays in (("small", small), ("full", toy["served"]))}
    got = []
    stats = run_continuous_device_multi(
        iter([{"i": i} for i in range(N_REQ)]), list(lanes.values()),
        lambda r: lanes["small" if route_small[r["i"]] else "full"],
        emit=lambda r, ids, rk: got.append((r["i"], ids.copy())),
        max_len=MAX_LEN, lookahead=True)
    assert stats["served"] == N_REQ and stats["megas"] >= 2
    assert [i for i, _ in got] == list(range(N_REQ))
    for i, ids in got:
        want = single["small" if route_small[i] else "full"][i]
        np.testing.assert_array_equal(ids, want, err_msg=f"request {i}")
    # the small bucket's answers are its own one-shot predict's
    one = make_predict_fn(toy["port"], toy["cfg"], MAX_LEN,
                          fast_argmax="pallas", device="cpu")(
        take(small, np.flatnonzero(route_small)))["answer"].numpy()
    for row, i in zip(one, np.flatnonzero(route_small)):
        np.testing.assert_array_equal(
            single["small"][i], cut(row, toy["caps"][i], toy["eos"]))


def test_device_loop_refuses_the_cpu_unless_asked(toy, monkeypatch):
    port = toy["port"]
    with pytest.raises(ValueError, match="unknown decoding"):
        make_device_loop_fns(port, MAX_LEN, 3, 2, 4, decoding="beam",
                             device="cpu")
    fns = make_device_loop_fns(port, MAX_LEN, 3, 2, 4, decoding="sample",
                               device="cpu")
    with pytest.raises(ValueError, match="sample_key"):
        fns.init_fn(_make_batch(toy["served"], toy["caps"])([{"i": 0}], 2))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_device_loop_fns(port, MAX_LEN, 3, 2, 4)
