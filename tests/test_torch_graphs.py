"""CUDA-graph capture (``runtime/graphs``) and the device loop
(``runtime/continuous/device_loop``) on the card, and the host-to-device
copies of a refill.

On the CPU: ``CapturedGraph`` refuses to run without a card, the launch
counters it reads are the serving kernels', the device loop never captures
on the CPU, and ``refill_rows`` builds its row indices from pinned memory
only on a card.

Tests marked ``cuda`` (a small bf16 CaSE whose passage stack runs the fused
stack step; they skip without a card):

* the captured megas serve the answers the eager body serves, token for
  token, and one capture is replayed once a mega, with the launches the
  body records;
* new weights loaded between two megas of one lane's graph make the next
  mega capture again, and the answers are the eager chunk loop's under the
  new weights;
* a round's host side (encode, ring push, wrap, the ``written`` fill, the
  replay, the harvest copy) and a chunk-loop refill run under
  ``device.no_host_sync``;
* a capture sets no process-wide sync mode: another thread that blocks on
  the card with ``.item()`` while the capture warms up does not raise.

No JAX here: on a card without it, README's ``cuda`` command runs this
file.
"""

import numpy as np
import pytest
import torch

from case_rg_tpu_torch.device import no_host_sync
from case_rg_tpu_torch.runtime import graphs
from case_rg_tpu_torch.runtime.continuous import (base, make_continuous_fns,
                                                  make_device_loop_fns,
                                                  refill_rows, run_continuous,
                                                  run_continuous_device)
from tests.test_torch_kernels import cuda, one_torch_thread  # noqa: F401

MAX_LEN, N, B, REFILL, RING, K, STEPS = 12, 24, 8, 4, 8, 3, 2


def _case(dev, param_dtype="bfloat16", e=256, heads=8, p=6):
    """A small CaSE (with 6 passages, the fused stack on the 600-position
    passage memory in bf16), N requests and their caps."""
    from case_rg_tpu_torch.config import ModelConfig
    from case_rg_tpu_torch.models import create_model, perturb_affine
    cfg = ModelConfig(name="case", vocab_size=1000, embedding_size=e,
                      hidden_size=e, num_heads=heads, enc_layers=1,
                      dec_layers=2, max_dec_len=MAX_LEN,
                      max_target_length=MAX_LEN, param_dtype=param_dtype)
    model = create_model("case", cfg, device=dev, seed=0)
    perturb_affine(model, torch.Generator(device=dev).manual_seed(1))
    rng = np.random.RandomState(0)
    q = rng.randint(4, 1000, size=(N, 1, 20)).astype(np.int32)
    pas = rng.randint(4, 1000, size=(N, p, 100)).astype(np.int32)
    for i in range(N):
        q[i, :, rng.randint(8, 21):] = 0
        pas[i, :, rng.randint(50, 101):] = 0
    caps = rng.randint(3, MAX_LEN + 1, N).astype(np.int32)

    def make_batch(reqs, bs):
        idx = [r["i"] for r in reqs]
        idx += [idx[-1]] * (bs - len(idx))
        return {"query": q[idx], "passage": pas[idx],
                "response_cap": caps[idx]}
    return cfg, model, make_batch


def _device_loop(fns, make_batch, **opts):
    got = {}
    stats = run_continuous_device(
        iter([{"i": i} for i in range(N)]), make_batch, fns, batch_size=B,
        refill=REFILL, emit=lambda r, ids, rk: got.__setitem__(r["i"],
                                                               ids.copy()),
        max_len=MAX_LEN, **opts)
    assert stats["served"] == N and sorted(got) == list(range(N))
    return got, stats


def _chunk_loop(model, make_batch, dev):
    got = {}
    run_continuous(iter([{"i": i} for i in range(N)]), make_batch,
                   *make_continuous_fns(model, MAX_LEN, STEPS,
                                        fast_argmax="pallas", device=dev),
                   batch_size=B, refill=REFILL,
                   emit=lambda r, ids, rk: got.__setitem__(r["i"], ids.copy()))
    return got


def _same(got, want):
    bad = [i for i in want if not np.array_equal(got[i], want[i])]
    assert not bad, f"{len(bad)} answers differ (first: request {bad[0]})"


# ---- on the CPU ----

def test_captured_graph_needs_a_card(monkeypatch):
    assert set(graphs.launch_counts()) == {
        "fused_mha", "stack_step", "combine_copy_mass", "single_query_mha",
        "additive_scores"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graphs.CapturedGraph(lambda: None, lambda: None)


def test_device_loop_runs_eagerly_on_the_cpu():
    """No capture on the CPU: every mega runs the body itself, and a second
    run on the same DeviceLoopFns reuses the lane's buffers."""
    _, model, make_batch = _case(torch.device("cpu"), "float32", e=32,
                                 heads=2, p=2)
    fns = make_device_loop_fns(model, MAX_LEN, STEPS, K, RING,
                               fast_argmax="pallas", device="cpu")
    first, _ = _device_loop(fns, make_batch)
    lanes = dict(fns._lanes)
    again, _ = _device_loop(fns, make_batch)
    assert fns.captures == [] and len(lanes) == 1 and fns._lanes == lanes
    _same(again, first)


def test_refill_rows_pins_its_indices_only_on_a_card(monkeypatch):
    pinned = []
    real = torch.Tensor.pin_memory
    monkeypatch.setattr(torch.Tensor, "pin_memory",
                        lambda t: pinned.append(t) or real(t))
    state = {"out": torch.zeros(4, 3), "x": [torch.zeros(4, 2), None]}
    new = {"out": torch.ones(2, 3), "x": [torch.ones(2, 2), None]}
    refill_rows(state, new, [2, 7])
    assert pinned == []
    assert state["out"][2].eq(1).all() and state["out"][[0, 1, 3]].eq(0).all()
    assert state["x"][0][2].eq(1).all() and state["x"][1] is None
    assert base.host_to_device(np.arange(3), torch.device("cpu")).tolist() \
        == [0, 1, 2]


# ---- on the card ----

@pytest.mark.cuda
def test_captured_megas_match_the_eager_body(cuda):
    _, model, make_batch = _case(cuda)
    fns = make_device_loop_fns(model, MAX_LEN, STEPS, K, RING,
                               fast_argmax="pallas", device=cuda)
    graph_got, stats = _device_loop(fns, make_batch, lookahead=True)
    assert len(fns.captures) == 1
    cap = fns.captures[0]
    assert cap["replays"] == stats["megas"]
    assert cap["launches"]["stack_step"] == K * STEPS
    assert cap["launches"]["combine_copy_mass"] == K * STEPS
    assert cap["launches"]["fused_mha"] == 0
    # the same body run eagerly on the card, mega by mega
    eager = make_device_loop_fns(model, MAX_LEN, STEPS, K, RING,
                                 fast_argmax="pallas", device=cuda)

    class Eager:
        def __init__(self, lane):
            self.lane = lane

        def replay(self):
            eager._body(self.lane)

    eager._graph = Eager
    eager_got, eager_stats = _device_loop(eager, make_batch, lookahead=True)
    assert eager.captures == [] and eager_stats == stats
    _same(graph_got, eager_got)
    _same(graph_got, _chunk_loop(model, make_batch, cuda))


@pytest.mark.cuda
def test_new_weights_capture_again(cuda):
    from case_rg_tpu_torch.models import perturb_affine
    _, model, make_batch = _case(cuda)
    fns = make_device_loop_fns(model, MAX_LEN, STEPS, K, RING,
                               fast_argmax="pallas", device=cuda)
    before, _ = _device_loop(fns, make_batch)
    assert len(fns.captures) == 1
    _device_loop(fns, make_batch)
    assert len(fns.captures) == 1             # same weights: replays only
    with torch.no_grad():                     # new weights, in place
        perturb_affine(model, torch.Generator(device=cuda).manual_seed(7),
                       scale=0.5)
    after, _ = _device_loop(fns, make_batch)
    assert len(fns.captures) == 2
    want = _chunk_loop(model, make_batch, cuda)
    _same(after, want)
    assert any(not np.array_equal(before[i], want[i]) for i in want)


@pytest.mark.cuda
def test_device_loop_round_waits_for_nothing(cuda):
    """After a run that captured the lane's graph, a whole run with every
    host-side program under no_host_sync; and a chunk-loop refill."""
    _, model, make_batch = _case(cuda)
    fns = make_device_loop_fns(model, MAX_LEN, STEPS, K, RING,
                               fast_argmax="pallas", device=cuda)
    first, _ = _device_loop(fns, make_batch)

    def checked(fn):
        def run(*args, **kw):
            with no_host_sync():
                return fn(*args, **kw)
        return run

    for name in ("init_fn", "wrap_fn", "stage_fn", "push_fn", "mega_fn"):
        setattr(fns, name, checked(getattr(fns, name)))
    real_copy = base.HostCopy.__init__
    try:
        base.HostCopy.__init__ = checked(real_copy)
        got, _ = _device_loop(fns, make_batch, lookahead=True)
    finally:
        base.HostCopy.__init__ = real_copy
    assert len(fns.captures) == 1
    _same(got, first)
    init_fn, _, refill_fn = make_continuous_fns(model, MAX_LEN, STEPS,
                                                fast_argmax="pallas",
                                                device=cuda)
    state, _ = init_fn(make_batch([{"i": i} for i in range(B)], B))
    new, _ = init_fn(make_batch([{"i": 0}, {"i": 1}], REFILL))
    with no_host_sync():
        refill_fn(state, new, np.array([5, 2, B, B]))
    torch.cuda.synchronize()
    assert torch.equal(state["out"][[5, 2]], new["out"][:2])


@pytest.mark.cuda
def test_captures_from_two_threads_while_a_third_launches(cuda):
    """Several backends in one process: two threads capture a graph each
    at once (``CAPTURE_LOCK`` takes them one after the other, in
    "thread_local" mode) while a third launches products on the default
    stream; every replay gives what the eager body gives, and the third
    thread's results are right."""
    import threading
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(256, 256, device=cuda, generator=gen)
    results, errors = {}, []
    stop = threading.Event()

    def capture(i):
        try:
            x = torch.randn(64, 256, device=cuda, generator=None) * (i + 1)
            out = torch.empty(64, 256, device=cuda)

            def body():
                out.copy_(torch.tanh(x @ a) + i)

            g = graphs.CapturedGraph(body, body)
            out.zero_()
            g.replay()
            torch.cuda.synchronize()
            results[i] = torch.equal(out, torch.tanh(x @ a) + i)
        except Exception as e:      # noqa: BLE001  (reported below)
            errors.append(repr(e))

    def launch():
        n = 0
        while not stop.is_set():
            y = a @ a
            n += 1
        torch.cuda.synchronize()
        results["third"] = (n, torch.allclose(y, a @ a))

    third = threading.Thread(target=launch)
    third.start()
    threads = [threading.Thread(target=capture, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    stop.set()
    third.join(timeout=60)
    assert not errors, errors
    assert results[0] and results[1]
    assert results["third"][0] > 0 and results["third"][1]


@pytest.mark.cuda
def test_a_serving_capture_leaves_other_threads_free_to_block(cuda):
    """While a capture warms up, a second thread reads a result with
    ``.item()``, which waits on the card: the warm-up must set no
    process-wide sync mode (under ``no_host_sync`` that read raises)."""
    import threading
    entered, done = threading.Event(), threading.Event()
    calls, errors, read = [], [], []
    a = torch.randn(128, 128, device=cuda)
    out = torch.empty(128, 128, device=cuda)

    def body():
        out.copy_(torch.tanh(a @ a))

    def warmup():
        body()
        calls.append(1)
        if len(calls) == 2:         # the second warm-up
            entered.set()
            done.wait(timeout=60)

    def reader():
        entered.wait(timeout=60)
        try:
            read.append((a.sum() * 0 + 1).item())
        except Exception as e:      # noqa: BLE001  (reported below)
            errors.append(repr(e))
        finally:
            done.set()

    t = threading.Thread(target=reader)
    t.start()
    g = graphs.CapturedGraph(body, warmup)
    t.join(timeout=60)
    assert not errors, errors
    assert read == [1.0] and len(calls) == 2
    out.zero_()
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, torch.tanh(a @ a))
