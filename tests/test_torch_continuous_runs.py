"""The port's continuous drivers (``run_continuous`` over the option
matrix, from a queue, ``run_continuous_multi`` over two pool buckets)
against its one-shot predict, and the entry points' refusal of the CPU
(moved from ``tests/test_torch_continuous.py``, whose module fixture and
docstring they share)."""

import queue
import threading
import time

import numpy as np
import pytest
import torch

from case_rg_tpu_torch.device import batch_to_device
from case_rg_tpu_torch.runtime.continuous import (Lane, QueueSource,
                                                  make_continuous_fns,
                                                  run_continuous,
                                                  run_continuous_multi)
from case_rg_tpu_torch.runtime.inference import make_predict_fn
from tests.test_torch_continuous import (  # noqa: F401
    MATRIX, MAX_LEN, N_REQ, _expected, _make_batch, cut, take, toy)
from tests.test_torch_kernels import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def fns(toy):
    return make_continuous_fns(toy["port"], MAX_LEN, 3, fast_argmax="pallas",
                               device="cpu")


@pytest.mark.parametrize("lookahead,async_harvest,refill_min,ordered,stream",
                         MATRIX)
def test_run_continuous_matrix(toy, fns, lookahead, async_harvest, refill_min,
                               ordered, stream):
    """Staggered ends and refills: every request is served once, with its
    one-shot answer and rank; in arrival order when ``ordered``; streamed
    prefixes never retract a token."""
    seen = {}

    def stream_cb(host, slots):
        for r, slot in enumerate(slots):
            if slot is not None:
                i = slot[1]["i"]
                pref = host["out"][r][:int(host["trow"][r])].copy()
                old = seen.get(i, pref[:0])
                np.testing.assert_array_equal(pref[:len(old)], old[:len(pref)])
                if len(pref) > len(old):
                    seen[i] = pref

    got, chunks = [], []
    stats = run_continuous(
        iter([{"i": i} for i in range(N_REQ)]),
        _make_batch(toy["served"], toy["caps"]), *fns, batch_size=4,
        refill=2, emit=lambda r, ids, rk: got.append((r["i"], ids.copy(),
                                                      rk.copy())),
        ordered=ordered, on_chunk=chunks.append, lookahead=lookahead,
        stream_cb=stream_cb if stream else None, refill_min=refill_min,
        async_harvest=async_harvest)
    assert stats["served"] == N_REQ and stats["refills"] >= 1
    assert chunks == list(range(1, stats["chunks"] + 1))
    order = [i for i, _, _ in got]
    assert sorted(order) == list(range(N_REQ))
    if ordered:
        assert order == list(range(N_REQ)), "arrival order violated"
    for i, ids, rk in got:
        np.testing.assert_array_equal(ids, _expected(toy, i),
                                      err_msg=f"request {i}")
        np.testing.assert_allclose(rk, toy["rank"][i], rtol=0, atol=1e-6)
        if stream and i in seen:
            np.testing.assert_array_equal(ids[:len(seen[i])], seen[i])


def test_run_continuous_from_a_queue(toy, fns):
    """A QueueSource fed by another thread, ended by its stop sentinel:
    every request served once, with its one-shot answer, in arrival
    order."""
    q, stop = queue.Queue(), object()

    def feed():
        for i in range(N_REQ):
            q.put({"i": i})
            time.sleep(0.002)
        q.put(stop)

    feeder = threading.Thread(target=feed)
    feeder.start()
    got = []
    try:
        stats = run_continuous(
            QueueSource(q, stop), _make_batch(toy["served"], toy["caps"]),
            *fns, batch_size=4, refill=2,
            emit=lambda r, ids, rk: got.append((r["i"], ids.copy())))
    finally:
        feeder.join(timeout=30)
    assert not feeder.is_alive()
    assert stats["served"] == N_REQ
    assert [i for i, _ in got] == list(range(N_REQ))
    for i, ids in got:
        np.testing.assert_array_equal(ids, _expected(toy, i))


@pytest.mark.parametrize("async_harvest", [False, True])
def test_run_continuous_multi_two_buckets(toy, async_harvest):
    """Requests routed by pool size to a 2-passage and a 3-passage lane;
    each answer equals the one-shot answer of its bucket's batch."""
    small = {"query": toy["served"]["query"],
             "passage": toy["served"]["passage"][:, :2]}
    route_small = np.arange(N_REQ) % 3 == 0
    port, cfg = toy["port"], toy["cfg"]
    want_small = make_predict_fn(port, cfg, MAX_LEN, fast_argmax="pallas",
                                 device="cpu")(small)["answer"].numpy()
    lanes = {}
    for key, arrays in (("small", small), ("full", toy["served"])):
        lanes[key] = Lane(key, _make_batch(arrays, toy["caps"]),
                          *make_continuous_fns(port, MAX_LEN, 3,
                                               fast_argmax="pallas",
                                               device="cpu"),
                          batch_size=3, refill=2)
    got = []
    stats = run_continuous_multi(
        iter([{"i": i} for i in range(N_REQ)]), list(lanes.values()),
        lambda r: lanes["small" if route_small[r["i"]] else "full"],
        emit=lambda r, ids, rk: got.append((r["i"], ids.copy())),
        async_harvest=async_harvest)
    assert stats["served"] == N_REQ
    assert [i for i, _ in got] == list(range(N_REQ))
    for i, ids in got:
        row = want_small[i] if route_small[i] else toy["answers"][i]
        np.testing.assert_array_equal(
            ids, cut(row, toy["caps"][i], toy["eos"]), err_msg=f"request {i}")


def test_entry_points_refuse_the_cpu_unless_asked(toy, monkeypatch):
    port, cfg = toy["port"], toy["cfg"]
    with pytest.raises(ValueError, match="unknown decoding"):
        make_continuous_fns(port, MAX_LEN, 3, decoding="beam", device="cpu")
    # sampled chunks need the rows' keys (tests/test_torch_decoding.py)
    with pytest.raises(ValueError, match="row_keys"), \
            torch.inference_mode():
        st, _ = port.decode_init(batch_to_device(
            take(toy["parity"], [0]), torch.device("cpu")), max_len=MAX_LEN)
        port.decode_chunk(st, n_steps=1, sampling=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_continuous_fns(port, MAX_LEN, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_predict_fn(port, cfg, MAX_LEN, fast_argmax="pallas")
