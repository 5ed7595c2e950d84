"""The pool axis in the port (``runtime/mesh.local_groups`` and
``split_pool``, ``runtime/replicas.Replicas`` over groups of M devices,
``models/case.PooledCaSE``) against the JAX package's pool sharding over
the 'model' axis of ``local_mesh``, in f32 on the CPU.

* The group geometry is the JAX ``local_mesh``'s (the cases of
  ``tests/test_sharding.py``'s ``test_local_mesh_model_axis_geometry``),
  and what does not split is refused with the JAX package's messages; so
  are Masque, TMemNet, a model with no pool, and training over a group.
* The port's split predict equals the JAX ``Trainer.predict(pool_devices=
  2)`` on the 8 virtual CPU devices of ``tests/conftest.py``, with
  ``tests/test_sharding.py``'s toy configuration: answers equal, rank
  within that test's rtol 2e-5, atol 1e-6.
* Split over ``cpu,cpu`` (M = 2, also two groups of two over four CPU
  devices) and ``cpu,cpu,cpu,cpu`` (M = 4) on a pool of 4, every decode
  mode and rank-only give the unsplit port's tokens and ranks bit for bit,
  and the continuous chunk loop and the device loop its tokens (ranks
  within 1e-5: a refill encodes a few rows, whose GEMMs over P/M passages
  may round otherwise).
* Each shard runs the per-passage attention sites on its P/M passages and
  the query side runs once: with a 3-layer encoder, 8 + 11*M of the fused
  attention's sites a predict, 6 + 8*M rank-only (the launches
  ``chip_smoke.py`` counts on the card).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from case_rg_tpu.config import ModelConfig as JConfig
from case_rg_tpu.kernels import decoder_stack as jds
from case_rg_tpu.models import create_model as jcreate
from case_rg_tpu_torch.bridge import load_jax_params
from case_rg_tpu_torch.config import ModelConfig
from case_rg_tpu_torch.device import resolve_devices
from case_rg_tpu_torch.models import create_model
from case_rg_tpu_torch.runtime import mesh
from case_rg_tpu_torch.runtime.inference import (make_predict_fn,
                                                 make_replicated_predict)
from case_rg_tpu_torch.runtime.replicas import Replicas
from tests.test_torch_bridge import TOY, jax_case_params
from tests.test_torch_continuous import random_tree, requests
from tests.test_torch_kernels import one_torch_thread  # noqa: F401

MAX_LEN = 8
B = 8
P = 4
CFG = dict(TOY, vocab_size=128, dec_layers=1, max_dec_len=MAX_LEN)
MODES = {"dense": dict(fast_argmax="dense"), "mxu": dict(fast_argmax="mxu"),
         "pallas": dict(fast_argmax="pallas"),
         "early_exit": dict(early_exit=True), "beam3": dict(beam_width=3),
         "sample": dict(decoding="sample", sample_seed=3, temperature=0.9,
                        top_k=20, top_p=0.95),
         "rank_only": dict(rank_only=True)}
torch.set_float32_matmul_precision("highest")


@pytest.fixture(scope="module")
def toy():
    """The port's CaSE with random weights (the JAX tree's shapes) and a
    batch of 8 rows over a pool of 4 (padded tails, one empty passage)."""
    params = random_tree(jax_case_params(CFG, abstract=True), seed=0)
    port = create_model("case", ModelConfig(**CFG), device="cpu")
    load_jax_params(port, params)
    return {"port": port, "cfg": ModelConfig(**CFG),
            "batch": requests(1, B, pools=P)}


def _group(port, spec, pool, sizes=(B,)):
    return Replicas(port, resolve_devices(spec, sizes, pool))


def test_groups_take_local_meshs_layout():
    """d groups of M devices, d = gcd(batch, n / M), in the JAX
    ``local_mesh``'s order (``devices[:d*M].reshape(d, M)``); M that does
    not divide the devices is refused with the JAX message, as is M above
    1 from a device list the size of one card."""
    from case_rg_tpu.runtime.mesh import local_mesh
    n = len(jax.local_devices())
    names = ",".join(f"cpu:{i}" for i in range(n))
    saved = jds._DATA_SHARDS       # local_mesh sets the kernel's hint
    try:
        for b, m in ((8, 2), (6, 4), (8, 1), (3, 2)):
            want = local_mesh(b, model=m)
            got = mesh.local_groups([b], names, model=m)
            ids = np.vectorize(lambda d: d.id)(want.devices)
            assert [[d.index for d in g] for g in got] == ids.tolist()
        with pytest.raises(ValueError) as jerr:
            local_mesh(8, model=3)
    finally:
        jds.set_data_shards(saved)
    with pytest.raises(ValueError, match="model axis 3 does not divide the "
                                         "8 local devices") as err:
        mesh.local_groups([8], names, model=3)
    assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError, match="does not divide the 1 local"):
        resolve_devices("cpu", [B], pool=2)
    assert resolve_devices("cpu,cpu,cpu,cpu", [6], pool=2) == \
        [[torch.device("cpu")] * 2] * 2
    assert mesh.local_groups([6], "cpu,cpu,cpu,cpu") == \
        [[torch.device("cpu")]] * 2


def test_split_pool_and_what_is_refused(toy, monkeypatch):
    """``split_pool`` cuts the ``POOL_AXIS_KEYS`` fields into contiguous
    blocks along the pool axis and keeps the rest whole; a pool that M
    does not divide, a model without a pool split (Masque and TMemNet
    naming their ROADMAP item, S2SA having no pool), training over a group
    and a predict function split otherwise than asked are refused."""
    from case_rg_tpu.runtime.mesh import POOL_AXIS_KEYS
    from case_rg_tpu_torch.train.trainer import predict

    assert mesh.POOL_AXIS_KEYS == POOL_AXIS_KEYS
    batch = dict(toy["batch"], token_weight=np.ones((B, P, 12), np.float32),
                 response=np.ones((B, 5), np.int32))
    parts = mesh.split_pool(batch, 2)
    for j, part in enumerate(parts):
        for k in ("passage", "token_weight"):
            np.testing.assert_array_equal(part[k],
                                          batch[k][:, 2 * j:2 * j + 2])
        assert part["query"] is batch["query"]
        assert part["response"] is batch["response"]
    with pytest.raises(ValueError, match=r"'passage' pool axis \(4\) is not "
                                         r"divisible by the 'model' mesh axis "
                                         r"\(3\)"):
        mesh.split_pool(batch, 3)

    for name, item in (("masque", r"item 7b \(ii\) Masque/TMemNet"),
                       ("tmemnet", r"item 7b \(ii\) Masque/TMemNet"),
                       ("s2sa", "no passage pool to split")):
        model = create_model(name, ModelConfig(**dict(CFG, name=name)),
                             device="cpu")
        with pytest.raises(ValueError, match=item):
            Replicas(model, [[torch.device("cpu")] * 2])
    reps = _group(toy["port"], "cpu,cpu", 2)
    try:
        with pytest.raises(NotImplementedError,
                           match=r"item 7b \(ii\) training"):
            reps.models[0].train_losses(batch)
        with pytest.raises(NotImplementedError,
                           match=r"item 7b \(ii\) training"):
            reps.models[0].stages(batch, torch.Generator())
        fn = make_replicated_predict(reps, toy["cfg"], MAX_LEN)
        assert fn.pool_devices == 2
        arrays = dict(toy["batch"], id=np.arange(B))
        with pytest.raises(ValueError, match="splits the pool 2 way"):
            list(predict(arrays, fn, B, pool_devices=1))
        odd = dict(arrays, passage=arrays["passage"][:, :3])
        with pytest.raises(ValueError, match=r"pool axis \(3\)"):
            list(predict(odd, fn, B, pool_devices=2))
    finally:
        reps.close()
    with pytest.raises(ValueError, match="model axis 2 does not divide the 3"):
        resolve_devices("cpu,cpu,cpu", [B], pool=2)


def test_split_predict_matches_jax_trainer_predict():
    """``tests/test_sharding.py``'s pool-sharded ``Trainer.predict``
    (pool_devices=2 on the 8 virtual CPU devices: 4 x 2) and the port's
    ``trainer.predict`` over one group of ``cpu,cpu`` on the same weights
    and batch: answers equal, ranks within that test's tolerance."""
    from case_rg_tpu.config import TrainConfig as JTrainConfig
    from case_rg_tpu.train.trainer import Trainer, TrainState
    from case_rg_tpu_torch.train.trainer import predict

    fields = dict(name="case", vocab_size=2056, embedding_size=32,
                  hidden_size=32, num_heads=2, enc_layers=1, dec_layers=1,
                  max_dec_len=6)
    b, lq, lp = 8, 12, 16
    params = random_tree(jax_case_params(fields, (b, lq, P, lp, 8),
                                         abstract=True), seed=4)
    rng = np.random.RandomState(4)
    arrays = {"id": np.arange(b),
              "query": rng.randint(4, 2056, (b, 1, lq)).astype(np.int32),
              "passage": rng.randint(4, 2056, (b, P, lp)).astype(np.int32)}
    arrays["passage"][:, :, 11:] = 0
    arrays["passage"][2, 1] = 0

    jmodel = jcreate("case", JConfig(**fields))
    fn = jax.jit(lambda vs, bt: jmodel.apply(
        vs, bt, max_len=6, method=type(jmodel).predict))
    state = TrainState(params=params, opt_state=(), ema=params,
                       step=jnp.zeros((), jnp.int32))
    saved = jds._DATA_SHARDS
    try:
        trainer = Trainer(jmodel, JTrainConfig(batch_size=b), total_steps=10)
        want = [jax.device_get(o) for _, o in
                trainer.predict(state, arrays, fn, b, pool_devices=2)]
    finally:
        jds.set_data_shards(saved)

    port = create_model("case", ModelConfig(**fields), device="cpu")
    load_jax_params(port, params)
    reps = _group(port, "cpu,cpu", 2, [b])
    try:
        got = [o for _, o in predict(
            arrays, make_replicated_predict(reps, ModelConfig(**fields), 6),
            b, pool_devices=2)]
    finally:
        reps.close()
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(got[0]["answer"],
                                  np.asarray(want[0]["answer"]))
    np.testing.assert_allclose(got[0]["rank"], np.asarray(want[0]["rank"]),
                               rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("spec, pool", [("cpu,cpu", 2),
                                        ("cpu,cpu,cpu,cpu", 4)],
                         ids=["M2", "M4"])
def test_split_predict_equals_unsplit(toy, spec, pool):
    """Every decode mode and rank-only over a group of M equals the
    unsplit port bit for bit (tokens and ranks); at M = 2 also over two
    groups of two (four CPU devices, a group a replica thread). A sampled
    batch draws its keys once a call, as unsplit."""
    port, cfg, batch = toy["port"], toy["cfg"], toy["batch"]
    layouts = [(spec, pool)] + ([("cpu,cpu,cpu,cpu", 2)] if pool == 2
                                else [])
    for name, kw in MODES.items():
        want = make_predict_fn(port, cfg, MAX_LEN, device="cpu", **kw)
        want = {k: v.numpy() for k, v in want(batch).items()}
        for devs, m in layouts:
            reps = _group(port, devs, m)
            try:
                assert len(reps) * m == devs.count(",") + 1
                got = make_replicated_predict(reps, cfg, MAX_LEN, **kw)(
                    batch).get()
            finally:
                reps.close()
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k],
                                              err_msg=f"{name} {devs} {k}")


@pytest.mark.parametrize("loop", ["chunk", "device"])
def test_split_continuous_loops_equal_unsplit(toy, loop):
    """The continuous chunk loop (with lookahead) and the device loop over
    groups of 2 and of 4 serve every request the unsplit loop's answer, and
    its rank within 1e-5: the encodes and refills split the pool, the
    decode runs on the group's first device."""
    from case_rg_tpu_torch.runtime.continuous import (make_continuous_fns,
                                                      make_device_loop_fns,
                                                      run_continuous,
                                                      run_continuous_device)
    port, arrays = toy["port"], requests(5, 13, pools=P)
    caps = np.random.RandomState(2).randint(2, MAX_LEN + 1, 13)

    def make_batch(reqs, k):
        idx = [r["i"] for r in reqs]
        idx += [idx[-1]] * (k - len(idx))
        return {"query": arrays["query"][idx], "passage": arrays["passage"][
            idx], "response_cap": caps[idx].astype(np.int32)}

    def serve(model):
        got = {}
        emit = lambda r, ids, rk: got.update(  # noqa: E731
            {r["i"]: (ids.copy(), rk.copy())})
        reqs = iter([{"i": i} for i in range(13)])
        if loop == "chunk":
            fns = make_continuous_fns(model, MAX_LEN, 3, fast_argmax="pallas",
                                      device="cpu")
            run_continuous(reqs, make_batch, *fns, 4, 2, emit,
                           lookahead=True)
        else:
            fns = make_device_loop_fns(model, MAX_LEN, 2, 3, 4,
                                       fast_argmax="pallas", device="cpu")
            run_continuous_device(reqs, make_batch, fns, 4, 2, emit, MAX_LEN)
        return got

    want = serve(port)
    assert len(want) == 13
    for spec, m in (("cpu,cpu", 2), ("cpu,cpu,cpu,cpu", 4)):
        reps = _group(port, spec, m, [4, 2])
        try:
            got = serve(reps.models[0])
        finally:
            reps.close()
        assert got.keys() == want.keys()
        for i in want:
            np.testing.assert_array_equal(got[i][0], want[i][0],
                                          err_msg=f"{spec} {i}")
            # a refill's passage GEMMs over 2 rows x P/M passages may round
            # otherwise than over 2 x P
            np.testing.assert_allclose(got[i][1], want[i][1], rtol=0,
                                       atol=1e-5, err_msg=f"{spec} {i}")


def test_each_shard_runs_its_passages(toy, monkeypatch):
    """With the fused attention's sites forced on (its plain version on
    the CPU), a predict over a group of M calls the query-side sites once
    at B rows (the encoder's n layers, the towers' 3 + 2 query blocks) and
    each shard's pool-side sites at B*P/M passage rows (n + 5 + 3): at the
    CAsT encoder's n = 3, 8 + 11*M sites, 6 + 8*M rank-only, against 19
    and 14 unsplit; the answers stay the unsplit ones."""
    from case_rg_tpu_torch.ops import attention

    rows = []
    real = attention.fused_mha

    def counted(q, *a):
        rows.append(q.shape[0])
        return real(q, *a)
    monkeypatch.setattr(attention, "fused_mha", counted)
    attention.set_fused_attention(True)
    port, cfg, batch = toy["port"], toy["cfg"], toy["batch"]
    try:
        n = CFG["enc_layers"]
        for kw, query_sites, pool_sites in ((dict(), n + 5, n + 8),
                                            (dict(rank_only=True), n + 3,
                                             n + 5)):
            rows.clear()
            want = make_predict_fn(port, cfg, MAX_LEN, device="cpu", **kw)
            want = {k: v.numpy() for k, v in want(batch).items()}
            assert sorted(rows) == sorted([B] * query_sites
                                          + [B * P] * pool_sites)
            for spec, m in (("cpu,cpu", 2), ("cpu,cpu,cpu,cpu", 4)):
                rows.clear()
                reps = _group(port, spec, m)
                try:
                    got = make_replicated_predict(reps, cfg, MAX_LEN, **kw)(
                        batch).get()
                finally:
                    reps.close()
                assert sorted(rows) == sorted(
                    [B] * query_sites + [B * P // m] * (pool_sites * m))
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k])
    finally:
        attention.set_fused_attention(None)
