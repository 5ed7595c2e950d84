"""``runtime/mesh`` and the ``Batcher``'s shards on the host, without a
process group (the 2-rank group itself: ``tests/test_torch_distributed.
py``):

* ``Batcher`` shards of 3 ranks at n = 10, B = 3 step in lockstep (each
  rank 2 batches, every row once with weight 1, the padding weight 0);
  one process batches exactly as the JAX package's copy does;
* ``init_distributed`` without torchrun's environment raises naming
  torchrun, and on a card-less host raises for ``cuda``;
  ``parse_mesh_shape`` takes ``D`` and ``D,1`` and refuses a model axis
  (ROADMAP item 7b) and a data axis that is not the world size;
  ``TrainConfig.pool_shard`` and a wrong ``mesh_shape`` are refused by the
  trainer.
"""

import numpy as np
import pytest
import torch

from tests import torch_dp_worker as W
from tests.test_torch_kernels import one_torch_thread  # noqa: F401


def test_batcher_shards_step_in_lockstep():
    from case_rg_tpu_torch.data.batching import Batcher
    arrays = W.arrays(10, 4)
    seen, counts = [], set()
    for r in range(3):
        b = Batcher(arrays, 3, seed=2, process_index=r, process_count=3)
        batches = list(b.epoch(1))
        counts.add((b.num_batches(1), len(batches)))
        for x in batches:
            seen.extend(x["_indices"][x["sample_weight"] > 0])
    assert counts == {(2, 2)}
    assert sorted(seen) == list(range(10))


@pytest.mark.parametrize("kw", [dict(shuffle=True, seed=5),
                                dict(shuffle=False)],
                         ids=["shuffled", "in_order"])
def test_one_process_batches_as_the_jax_copy(kw):
    from case_rg_tpu.data.batching import Batcher as JBatcher
    from case_rg_tpu_torch.data.batching import Batcher
    arrays = W.arrays(10, 4)
    got = list(Batcher(arrays, 3, **kw).epoch(2))
    want = list(JBatcher(arrays, 3, **kw).epoch(2))
    assert len(got) == len(want) == 4
    for x, y in zip(got, want):
        assert x.keys() == y.keys()
        for k in x:
            assert np.array_equal(x[k], y[k]) and x[k].dtype == y[k].dtype


def test_multihost_needs_torchrun(monkeypatch):
    from case_rg_tpu_torch.runtime import mesh
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        mesh.init_distributed("cpu")
    assert not mesh.is_distributed()
    assert (mesh.process_index(), mesh.process_count()) == (0, 1)
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1"}.items():
        monkeypatch.setenv(k, v)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.init_distributed("cuda")
    assert not mesh.is_distributed()


def test_parse_mesh_shape():
    from case_rg_tpu_torch.runtime import mesh
    assert mesh.parse_mesh_shape("1") == (1, 1)
    assert mesh.parse_mesh_shape("1,1") == (1, 1)
    assert mesh.parse_mesh_shape("4,1", world=4) == (4, 1)
    with pytest.raises(ValueError, match="item 7b"):
        mesh.parse_mesh_shape("2,2", world=2)
    with pytest.raises(ValueError, match="world size 1"):
        mesh.parse_mesh_shape("2")
    for bad in ("", "a", "1,1,1", "0"):
        with pytest.raises(ValueError, match="not 'D' or 'D,M'"):
            mesh.parse_mesh_shape(bad)


def test_trainer_refuses_pool_shard_and_a_wrong_mesh():
    from case_rg_tpu_torch.config import TrainConfig
    with pytest.raises(ValueError, match="item 7b"):
        W.toy_trainer(pool_shard=True)
    with pytest.raises(ValueError, match="world size"):
        W.toy_trainer(mesh_shape=(2, 1))
    assert W.toy_trainer(mesh_shape=(1,)).tc == TrainConfig(
        batch_size=W.B, learning_rate=1e-3, warmup_steps=1, mesh_shape=(1,))
