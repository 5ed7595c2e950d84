"""The port's device loop (``runtime/continuous/device_loop``) on the CPU,
in f32, at the toy size of tests/test_torch_continuous.py (its model,
requests and one-shot answers).

* Over a matrix of batch, refill width, ring size, chunks a mega, steps a
  chunk and lookahead (a copy of tests/test_device_loop.py's, with the
  fused stack step, streaming and unordered emission on some rows), every
  request is served once, in arrival order when ordered, with the port's
  one-shot answer cut at its cap and EOS, and its rank within 1e-6.
* One configuration against the JAX package's own
  ``run_continuous_device`` (bridged weights, the same requests, its Pallas
  combine in interpret mode): answers token-identical, ranks within 1e-6,
  and the stats dict equal key for key, which holds the port's fixed-K
  mega and cumsum compaction to JAX's ``while_loop`` and ``nonzero``.
* Sampled decoding, per-request controls and arrivals trickling from a
  queue: the device loop's answers equal the chunk loop's.
* ``run_continuous_device_multi`` over two pool buckets sharing one
  ``DeviceLoopFns``: each answer equals the single-lane loop's at its
  bucket.
* The entry point refuses the CPU unless asked.

Its CUDA graphs are held on the card by tests/test_torch_graphs.py.
"""

import queue
import threading
import time

import numpy as np
import pytest


from case_rg_tpu_torch.models import multimem
from case_rg_tpu_torch.runtime.continuous import (QueueSource,
                                                  make_continuous_fns,
                                                  make_device_loop_fns,
                                                  run_continuous,
                                                  run_continuous_device)
from tests.test_torch_continuous import (  # noqa: F401
    MAX_LEN, N_REQ, _expected, _make_batch, cut, take, toy, with_interpret)
from tests.test_torch_kernels import one_torch_thread  # noqa: F401

MATRIX = [
    # b, refill, stage, n_chunks, chunk_steps, lookahead, fused, stream,
    # ordered
    (4, 2, 4, 2, 3, False, False, False, True),   # small ring, short megas
    (4, 2, 2, 4, 2, False, False, True, True),    # ring < batch: wraps
    (6, 3, 6, 3, 3, False, True, False, True),    # a part-filled bucket
    (4, 2, 4, 2, 3, True, False, True, False),    # double dispatch
    (6, 3, 6, 3, 3, True, False, False, True),
    (3, 1, 2, 3, 2, False, True, False, False),   # one-row refills
]


def _first_eos(toy, i):
    """Where request i's greedy answer (cut at its cap) first emits EOS, or
    None."""
    hits = np.flatnonzero(_expected(toy, i) == toy["eos"])
    return int(hits[0]) if len(hits) else None


def _length(toy, i):
    """Tokens request i emits: up to its first EOS, else its cap."""
    end = _first_eos(toy, i)
    return int(toy["caps"][i]) if end is None else end + 1


def _serve(toy, fns, b, refill, arrays=None, source=None, make_batch=None,
           **opts):
    """Run the port's device loop over the served requests: ([(request,
    answer, rank)], stats)."""
    make_batch = make_batch or _make_batch(
        toy["served"] if arrays is None else arrays, toy["caps"])
    got = []
    stats = run_continuous_device(
        source if source is not None else iter([{"i": i}
                                                for i in range(N_REQ)]),
        make_batch, fns, batch_size=b, refill=refill,
        emit=lambda r, ids, rk: got.append((r["i"], ids.copy(), rk.copy())),
        max_len=MAX_LEN, **opts)
    return got, stats


@pytest.mark.parametrize(
    "b,refill,stage,n_chunks,chunk_steps,lookahead,fused,stream,ordered",
    MATRIX)
def test_device_loop_matches_predict(toy, b, refill, stage, n_chunks,
                                     chunk_steps, lookahead, fused, stream,
                                     ordered):
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

    megas = []
    try:
        multimem.set_fused_stack(fused)
        fns = make_device_loop_fns(toy["port"], MAX_LEN, chunk_steps,
                                   n_chunks, stage, fast_argmax="pallas",
                                   device="cpu")
        got, stats = _serve(toy, fns, b, refill, lookahead=lookahead,
                            ordered=ordered, on_mega=megas.append,
                            stream_cb=stream_cb if stream else None)
    finally:
        multimem.set_fused_stack(None)
    assert stats["served"] == N_REQ and stats["refills"] >= 1
    assert megas == list(range(1, stats["megas"] + 1))
    assert 0 < stats["chunks"] <= n_chunks * stats["megas"]
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
    assert stats["steps_served"] == sum(_length(toy, i)
                                        for i in range(N_REQ))


def _sampled_batches(toy, ctls=None):
    keys = np.random.RandomState(21).randint(0, 2 ** 32, (N_REQ, 2),
                                             dtype=np.int64)
    base = _make_batch(toy["served"], toy["caps"])

    def make_batch(reqs, bs):
        batch = base(reqs, bs)
        idx = [r["i"] for r in reqs]
        idx += [idx[-1]] * (bs - len(idx))
        batch["sample_key"] = keys[idx]
        if ctls is not None:
            batch["sample_ctl"] = ctls[idx]
        return batch
    return make_batch


def _chunk_loop(toy, make_batch, **kw):
    fns = make_continuous_fns(toy["port"], MAX_LEN, 3, device="cpu", **kw)
    got = []
    run_continuous(iter([{"i": i} for i in range(N_REQ)]), make_batch, *fns,
                   batch_size=4, refill=2,
                   emit=lambda r, ids, rk: got.append((r["i"], ids.copy())))
    return dict(got)


@pytest.mark.parametrize("controls", [False, True])
def test_device_loop_sampled_equals_chunk_loop(toy, controls):
    """Sampled rows carry their keys (and, with ``controls``, their own
    temperature/top_k/top_p) through refills and megas: every answer is
    the chunk loop's with the same keys, whatever the batch; with controls,
    a top_k=1 row whose greedy answer ends on an EOS after its first
    token and before its cap's last one is that greedy answer."""
    ctls = None
    kw = dict(decoding="sample", temperature=0.8, top_k=5, top_p=0.9)
    if controls:
        ctls = np.asarray([(1.0, 1.0, 1.0) if i % 3 == 0 else
                           (0.7 + 0.1 * (i % 4), float(i % 5),
                            0.8 + 0.04 * (i % 5)) for i in range(N_REQ)],
                          np.float32)
        kw = dict(decoding="sample")
    make_batch = _sampled_batches(toy, ctls)
    fns = make_device_loop_fns(toy["port"], MAX_LEN, 3, 2, 4, device="cpu",
                               **kw)
    got, stats = _serve(toy, fns, 3, 2, make_batch=make_batch)
    assert stats["served"] == N_REQ
    want = _chunk_loop(toy, make_batch, **kw)
    greedy_like = [i for i in range(N_REQ) if controls and i % 3 == 0
                   and _first_eos(toy, i) is not None
                   and 0 < _first_eos(toy, i) < toy["caps"][i] - 1]
    assert greedy_like or not controls, "no top_k=1 row ends on its own EOS"
    for i, ids, _ in got:
        np.testing.assert_array_equal(ids, want[i], err_msg=f"request {i}")
        if i in greedy_like:
            np.testing.assert_array_equal(ids, _expected(toy, i),
                                          err_msg=f"top_k=1 request {i}")


def test_device_loop_trickle_arrivals(toy):
    """Requests trickle in from another thread through a QueueSource (b 3,
    refill 1, a ring of 2, 3 chunks of 2 steps): each is served once, in
    arrival order, with its one-shot answer."""
    q, stop = queue.Queue(), object()

    def feed():
        for i in range(N_REQ):
            q.put({"i": i})
            time.sleep(0.002)
        q.put(stop)

    feeder = threading.Thread(target=feed)
    feeder.start()
    try:
        fns = make_device_loop_fns(toy["port"], MAX_LEN, 2, 3, 2,
                                   fast_argmax="pallas", device="cpu")
        got, stats = _serve(toy, fns, 3, 1, source=QueueSource(q, stop))
    finally:
        feeder.join(timeout=30)
    assert not feeder.is_alive()
    assert stats["served"] == N_REQ
    assert [i for i, _, _ in got] == list(range(N_REQ))
    for i, ids, _ in got:
        np.testing.assert_array_equal(ids, _expected(toy, i))
