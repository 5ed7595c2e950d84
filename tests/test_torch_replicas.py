"""The serving mesh's data axis in the port (``runtime/replicas.py``,
``runtime/inference.make_replicated_predict``) against the JAX package's
predict over ``local_mesh`` with ``shard_batch``, in f32 on the CPU.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``
(one compile a decode mode, in a module fixture); the port's side runs
with two and four CPU replicas (``cpu,cpu``, ``cpu,cpu,cpu,cpu``), each in
its own thread. Held here:

* greedy (dense and pallas argmax), beam width 3 and sampling at top_k = 1
  are token-identical to the JAX package, and ranks within 1e-4;
* each replica's rows equal one CPU replica's predict on the same row
  block, bit for bit;
* a sampled batch split over replicas samples what the unsplit batch
  samples (the batch's keys are drawn once and sliced);
* a launch-counted kernel wrapper keeps exact counts, and each thread's
  own tally, when several threads launch at once (the CPU has no kernel:
  the C launch is stubbed).
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from case_rg_tpu.config import ModelConfig as JConfig
from case_rg_tpu.kernels import copy_argmax as jca
from case_rg_tpu.models import create_model as jcreate
from case_rg_tpu.runtime.inference import make_predict_fn as jmake_predict
from case_rg_tpu.runtime.mesh import local_mesh, replicated, shard_batch
from case_rg_tpu_torch.bridge import load_jax_params
from case_rg_tpu_torch.config import ModelConfig
from case_rg_tpu_torch.decode import loops
from case_rg_tpu_torch.device import resolve_devices
from case_rg_tpu_torch.kernels import _build
from case_rg_tpu_torch.models import create_model
from case_rg_tpu_torch.runtime.inference import (make_predict_fn,
                                                 make_replicated_predict)
from case_rg_tpu_torch.runtime.replicas import Replicas
from tests.test_torch_bridge import TOY, jax_case_params
from tests.test_torch_continuous import random_tree, requests
from tests.test_torch_kernels import one_torch_thread  # noqa: F401

MAX_LEN = 8
B = 8
CFG = dict(TOY, vocab_size=128, dec_layers=1, max_dec_len=MAX_LEN)
TOL = 1e-4
MODES = {"greedy": dict(), "pallas": dict(fast_argmax="pallas"),
         "beam3": dict(beam_width=3),
         "sample_top_k_1": dict(decoding="sample", top_k=1, sample_seed=3)}
torch.set_float32_matmul_precision("highest")


def _interpret(fn):
    saved = jca._FORCE_INTERPRET
    jca._FORCE_INTERPRET = True
    try:
        return fn()
    finally:
        jca._FORCE_INTERPRET = saved


@pytest.fixture(scope="module")
def mesh_pair():
    """The bridged port model, a batch of 8 rows, and the JAX package's
    outputs for it over ``local_mesh(8)`` (the 8 virtual CPU devices, the
    parameters replicated, the batch sharded by rows): one jit a mode."""
    params = random_tree(jax_case_params(CFG, abstract=True), seed=0)
    batch = requests(1, B)
    port = create_model("case", ModelConfig(**CFG), device="cpu")
    load_jax_params(port, params)
    jmodel, jcfg = jcreate("case", JConfig(**CFG)), JConfig(**CFG)
    mesh = local_mesh(B)
    assert dict(mesh.shape) == {"data": 8, "model": 1}
    variables = {"params": jax.device_put(params, replicated(mesh))}
    sharded = shard_batch(mesh, {k: jnp.asarray(v) for k, v in batch.items()})
    ref = {}
    for name, kw in MODES.items():
        fn = jmake_predict(jmodel, jcfg, MAX_LEN, **kw)
        ref[name] = jax.tree_util.tree_map(
            np.asarray, jax.device_get(_interpret(
                lambda: fn(variables, sharded))))
    return {"port": port, "cfg": ModelConfig(**CFG), "batch": batch,
            "ref": ref}


@pytest.mark.parametrize("mode", list(MODES))
def test_replicated_predict_matches_jax_local_mesh(mesh_pair, mode):
    kw = MODES[mode]
    port, cfg, batch = mesh_pair["port"], mesh_pair["cfg"], mesh_pair["batch"]
    one = make_predict_fn(port, cfg, MAX_LEN, device="cpu", **kw)
    if kw.get("decoding") == "sample":
        # the replicated call draws the batch's keys; one replica on a
        # row block gets that block's keys, as its replica does
        keys = loops.keys_from_seed(kw["sample_seed"], B)
        batch = dict(batch, sample_key=keys.numpy())
    for spec in ("cpu,cpu", "cpu,cpu,cpu,cpu"):
        devs = resolve_devices(spec, [B])
        reps = Replicas(port, devs)
        try:
            got = make_replicated_predict(reps, cfg, MAX_LEN, **kw)(
                batch).get()
            blocks = reps.split(batch)
        finally:
            reps.close()
        assert len(reps) == spec.count(",") + 1
        np.testing.assert_array_equal(got["answer"],
                                      mesh_pair["ref"][mode]["answer"])
        np.testing.assert_allclose(got["rank"], mesh_pair["ref"][mode]["rank"],
                                   rtol=0, atol=TOL)
        # each replica's rows: one replica's predict on the same row block,
        # bit for bit (a GEMM over another row count may round otherwise)
        n = B // len(reps)
        for i, blk in enumerate(blocks):
            for k, v in one(blk).items():
                assert got[k].dtype == v.numpy().dtype
                np.testing.assert_array_equal(got[k][i * n:(i + 1) * n],
                                              v.numpy())


def test_sampled_split_samples_the_unsplit_batch(mesh_pair):
    """Real sampling (0.9 / 20 / 0.95): the batch's keys drawn once a call
    from the seed and the call's index, each replica its rows' keys; two
    calls in a row draw two streams, on one replica and on four alike."""
    port, cfg, batch = mesh_pair["port"], mesh_pair["cfg"], mesh_pair["batch"]
    kw = dict(decoding="sample", sample_seed=11, temperature=0.9, top_k=20,
              top_p=0.95)
    one = make_predict_fn(port, cfg, MAX_LEN, device="cpu", **kw)
    want = [one(batch)["answer"].numpy() for _ in range(2)]
    assert (want[0] != want[1]).any()
    reps = Replicas(port, resolve_devices("cpu,cpu,cpu,cpu", [B]))
    try:
        fn = make_replicated_predict(reps, cfg, MAX_LEN, **kw)
        got = [fn(batch).get()["answer"] for _ in range(2)]
    finally:
        reps.close()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_replicas_refuse_what_does_not_split(mesh_pair):
    """A batch whose rows do not divide over the replicas raises, and the
    model must live on the first replica's device."""
    port = mesh_pair["port"]
    reps = Replicas(port, [torch.device("cpu")] * 3)
    try:
        with pytest.raises(ValueError, match="does not split"):
            reps.split(mesh_pair["batch"])
    finally:
        reps.close()
    with pytest.raises(ValueError, match="lives on"):
        Replicas(port, [torch.device("meta")])


def test_launch_counters_stay_exact_under_threads(monkeypatch):
    """Four threads drive the real ``single_query_mha`` wrapper (its
    checks, its card guard, its counter and its thread's tally) 3000 times
    each, with the C launch stubbed (the CPU has no kernel) and the GIL
    switching as often as it can: the module's counter rises by every
    launch, and each thread's tally by its own."""
    import contextlib
    import sys
    import time
    import types

    from case_rg_tpu_torch.kernels import decode_attention as da

    b, l, e, h, n = 2, 8, 16, 2, 3000
    plan = da.single_query_mha_launch(b, l, e // h)

    def launch(*args):
        time.sleep(0)                     # let another thread take the GIL
        return 0
    lib = types.SimpleNamespace(
        single_query_mha_smem_bytes=lambda *a: plan["smem"],
        single_query_mha_bf16=launch)
    monkeypatch.setattr(da, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(b, r, e, generator=g).bfloat16()
               for r in (1, l, l))
    keep = torch.ones(b, l, dtype=torch.bool)
    saved, switch = da.LAUNCHES, sys.getswitchinterval()
    da.LAUNCHES = 0
    tallies = []

    def drive():
        t0 = _build.thread_tally().get("single_query_mha", 0)
        for _ in range(n):
            da.single_query_mha_cuda(q, k, v, keep, h)
        tallies.append(_build.thread_tally()["single_query_mha"] - t0)
    try:
        sys.setswitchinterval(1e-6)
        ts = [threading.Thread(target=drive) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert da.LAUNCHES == 4 * n and tallies == [n] * 4
    finally:
        sys.setswitchinterval(switch)
        da.LAUNCHES = saved
