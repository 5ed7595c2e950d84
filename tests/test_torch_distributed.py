"""Data parallelism in the port (``runtime/mesh``, the data-parallel
``train/trainer``, ``cli/run --multihost``), on the CPU with gloo.

One module fixture spawns a 2-rank group once (``tests/torch_dp_worker``:
one process a rank, ``torch.multiprocessing`` spawn, free ports) and runs
every scenario there, while ``torch.distributed.run`` runs ``cli/run
--mode test`` with two ranks; the tests hold what the ranks wrote against
one process and against the JAX package, in f32:

* three steps of toy CaSE on ranks whose shards hold different PAD counts,
  the last batch padded: the losses, ``grad_norm`` and parameters equal
  one process's steps on the two ranks' batches concatenated (1e-6
  relative; the state's elements also to 1e-6 of the largest element of
  their part, since Adam steps tiny gradients by about lr whatever their
  rounding; the in-projection's k-bias third, whose true gradient is 0, to
  a few learning rates, as ``tests/test_torch_train.py`` holds it); the
  parameters, moments and EMA bit-identical across the ranks;
* the same at ``accumulation_steps=2``;
* the first step's summed gradients and losses equal the JAX package's
  ``train_losses`` and ``jax.grad`` on the global batch (1e-5 and
  1e-5/1e-4), which pins the normalisation to the global batch's, not to
  DDP's mean of rank means;
* dropout on the same rows differs across the ranks (each rank's
  generator folds in its rank; a world of one keeps the single-process
  generator);
* a SIGTERM to one rank stops both before the same step, with one salvage
  checkpoint;
* the dev loss equals one process's at batch ``B * ranks``;
* ``cli/run --mode test`` through ``torch.distributed.run`` with two ranks,
  and ``--continuous`` with and without ``--device_loop``: the merged
  ``.all.answer`` / ``.all.run`` hold one process's lines.

Without a group (the Batcher's shards, ``runtime/mesh``'s refusals):
``tests/test_torch_mesh.py``.
"""

import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests import torch_dp_worker as W
from tests.test_torch_kernels import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ["--embedding_size", "16", "--hidden_size", "16", "--num_heads",
          "2", "--max_target_length", "10"]
DATA = ["--query_len", "24", "--passage_len", "24", "--num_passage", "4"]
RTOL = 1e-6
K_BIAS_ATOL = 5e-3              # a few learning rates (lr 1e-3)
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _lines(result_dir, stem, kind):
    with open(os.path.join(result_dir, f"{stem}.all.{kind}")) as f:
        return sorted(f.read().splitlines())


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The toy corpus prepared and trained one epoch in one process (the
    checkpoint every test run decodes); ``cli/run --mode test`` of it
    through ``torch.distributed.run`` with two ranks, while the 2-rank
    group plays its scenarios (``torch_dp_worker.run``); then in one
    process; every result directory merged."""
    from case_rg_tpu_torch.cli.prepare import main as prepare_main
    from case_rg_tpu_torch.cli.run import main as run_main
    from case_rg_tpu_torch.runtime.io import merge_shards
    from fixtures import make_dataset

    root = str(tmp_path_factory.mktemp("dp"))
    make_dataset(root, "toy", n_queries=12, n_passages=20)
    prepare_main(["--data_path", root, "--dataset", "toy", "--models",
                  "case", "--answer_len", "10"] + DATA)
    args = ["--model", "case", "--data_path", root, "--dataset", "toy",
            "--batch_size", "2", "--learning_rate", "1e-3",
            "--warmup_steps", "1"] + SHAPES
    one = os.path.join(root, "one")
    cpu = ["--epoch", "1", "--device", "cpu"]
    run_main(args + cpu + ["--mode", "train", "--output_path", one])
    for name in ("cli", "continuous", "device_loop"):
        shutil.copytree(os.path.join(one, "model"),
                        os.path.join(root, name, "model"))
    ports = _free_ports(5)
    test = ["--mode", "test"] + cpu
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--master_addr", "127.0.0.1", "--master_port", str(ports[4]),
         "-m", "case_rg_tpu_torch.cli.run", "--multihost"] + args + test
        + ["--output_path", os.path.join(root, "cli")],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        torch.multiprocessing.spawn(W.run, args=(2, ports[:4], root, args),
                                    nprocs=2, join=True)
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-3000:]
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt")) for r in (0, 1)]
    run_main(args + test + ["--output_path", one])
    results = {}
    for name in ("one", "cli", "continuous", "device_loop"):
        d = os.path.join(root, name, "result")
        results[name] = (d, sorted(os.listdir(d)))
        merge_shards(d)
    return {"root": root, "ranks": ranks, "results": results,
            "dp_train": sorted(os.listdir(os.path.join(root, "dp_train",
                                                       "model")))}


def _global_batches(k):
    """One process's view of the group's first ``k`` steps: each step the
    two ranks' batches concatenated."""
    a, b = (W.shard_batches(r, 2, k) for r in (0, 1))
    return [{key: np.concatenate([x[key], y[key]]) for key in x}
            for x, y in zip(a, b)]


def _one_process(k, **tc):
    t = W.toy_trainer(**tc)
    state = t.init_state()
    losses = [{n: float(v) for n, v in t.train_step(state, b, None).items()}
              for b in _global_batches(k)]
    return t, state, losses


def _k_bias_free(name, arr):
    if name.endswith("in_proj_bias"):
        width = arr.shape[0] // 3
        return np.concatenate([arr[:width], arr[2 * width:]])
    return arr


def _same_as_one_process(rank_res, state, losses):
    assert rank_res["step"] == state.step and rank_res["count"] == state.count
    assert len(rank_res["losses"]) == len(losses)
    for got, want in zip(rank_res["losses"], losses):
        assert set(got) == set(want)
        for k, v in want.items():
            assert abs(got[k] - v) <= RTOL * abs(v), (k, got[k], v)
    for name in ("params", "ema", "mu", "nu"):
        part = getattr(state, name)
        scale = max(float(v.detach().abs().max()) for v in part.values())
        for k, v in part.items():
            got = rank_res["state"][name][k].numpy()
            want = v.detach().numpy()
            np.testing.assert_allclose(_k_bias_free(k, got),
                                       _k_bias_free(k, want), rtol=RTOL,
                                       atol=RTOL * scale,
                                       err_msg=f"{name} {k}")
            np.testing.assert_allclose(got, want, rtol=0, atol=K_BIAS_ATOL,
                                       err_msg=f"{name} {k}")


def _ranks_bit_identical(a, b):
    for name in ("params", "ema", "mu", "nu"):
        for k in a[name]:
            assert torch.equal(a[name][k], b[name][k]), (name, k)


def test_step_equals_one_process_on_the_global_batch(dp):
    a, b = (W.shard_batches(r, 2, 3) for r in (0, 1))
    # the shards hold different PAD counts, and a padded final batch
    assert [x["sample_weight"].sum() for x in a] == [4, 4, 1]
    assert [x["sample_weight"].sum() for x in b] == [4, 4, 1]
    assert any((x["response"] == 0).sum() != (y["response"] == 0).sum()
               for x, y in zip(a, b))
    _, state, losses = _one_process(3)
    r0, r1 = (r["exact"] for r in dp["ranks"])
    # cli/run --multihost --mode train: rank 0 wrote the epoch
    assert dp["dp_train"] == ["0.pt", "best.json", "latest.json"]
    _same_as_one_process(r0, state, losses)
    _ranks_bit_identical(r0["state"], r1["state"])
    assert r0["losses"] == r1["losses"]
    assert r0["checksum"] == r1["checksum"]
    # the initial state was broadcast from rank 0
    _ranks_bit_identical(dp["ranks"][0]["init"], dp["ranks"][1]["init"])


def test_accumulation_equals_one_process(dp):
    _, state, losses = _one_process(4, accumulation_steps=2)
    r0, r1 = (r["accum"] for r in dp["ranks"])
    assert r0["count"] == 2 and r0["step"] == 2
    _same_as_one_process(r0, state, losses)
    _ranks_bit_identical(r0["state"], r1["state"])


def test_first_step_equals_jax_on_the_global_batch(dp):
    """The group's summed gradients and reduced losses against the JAX
    package's ``train_losses`` and ``jax.grad`` at the same weights
    (rank 0's initial parameters) on the concatenated batch."""
    import jax
    import jax.numpy as jnp

    from case_rg_tpu.config import ModelConfig as JConfig
    from case_rg_tpu.models import create_model as jcreate
    from case_rg_tpu_torch.bridge import load_state, state_dict_from_jax
    from tests.test_torch_bridge import jax_tree_from_port

    t = W.toy_trainer()
    load_state(t.model, dp["ranks"][0]["init"]["params"])
    tree = jax_tree_from_port(t.model)
    model = jcreate("case", JConfig(**dict(W.TOY, dropout=0.1)))
    batch = {k: jnp.asarray(v) for k, v in _global_batches(1)[0].items()
             if not k.startswith("_")}

    def loss_fn(params):
        losses = model.apply({"params": params}, batch, deterministic=True,
                             method=type(model).train_losses)
        return sum(losses.values()), losses

    (_, ref), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)) \
        .lower(tree).compile({"xla_backend_optimization_level": 0,
                              "xla_llvm_disable_expensive_passes": True})(tree)
    ref_grads = state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                           grads))
    got = dp["ranks"][0]["exact"]["losses"][0]
    for k, v in ref.items():
        assert abs(got[k] - float(v)) <= LOSS_RTOL * abs(float(v)), k
    assert set(dp["ranks"][0]["grads"]) == set(ref_grads)
    for name, g in dp["ranks"][0]["grads"].items():
        np.testing.assert_allclose(g.numpy(), ref_grads[name],
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
        assert torch.equal(g, dp["ranks"][1]["grads"][name]), name


def _seed_of(seq):
    s = seq.generate_state(2, np.uint32)
    return int(s[0]) << 32 | int(s[1])


def test_dropout_differs_across_ranks(dp):
    from case_rg_tpu_torch.train.trainer import epoch_generator
    a, b = (r["dropout"] for r in dp["ranks"])
    assert set(a) == set(b) and all(a[k] != b[k] for k in a), (a, b)
    cpu = torch.device("cpu")
    # rank 0's key (seed, epoch, 0) is one process's (seed, epoch): numpy's
    # SeedSequence ignores trailing zeros of its entropy
    assert torch.equal(epoch_generator(5, 2, cpu, 0).get_state(), torch.Generator(
        ).manual_seed(_seed_of(np.random.SeedSequence([5, 2]))).get_state())
    assert not torch.equal(epoch_generator(5, 2, cpu, 0).get_state(),
                           epoch_generator(5, 2, cpu, 1).get_state())


def test_a_sigterm_to_one_rank_stops_both(dp):
    """Rank 1 alone is signalled after its second step; both ranks stop
    before their third, and rank 0 alone writes ``0.preempt.pt``."""
    a, b = (r["preempt"] for r in dp["ranks"])
    assert a["calls"] == b["calls"] == [1, 2]
    assert a["step"] == b["step"] == 2
    assert a["files"] == b["files"] == ["0.preempt.pt"]


def test_dev_loss_equals_one_process(dp):
    t = W.toy_trainer()
    state = t.init_state()
    for name in ("params", "ema"):
        for k, v in getattr(state, name).items():
            v.data.copy_(dp["ranks"][0]["exact"]["state"][name][k])
    want = t.eval_losses(state, W.arrays(W.N_DEV, 2), batch_size=2 * W.B)
    a, b = (r["dev"] for r in dp["ranks"])
    assert a == b
    for k, v in want.items():
        assert abs(a[k] - v) <= RTOL * abs(v), (k, a[k], v)


@pytest.mark.parametrize("name", ["cli", "continuous", "device_loop"])
def test_two_rank_test_merges_to_one_process(dp, name):
    """Each rank writes ``{stem}.{rank}.answer/.run``; merged, they hold
    one process's lines (``cli``: through ``torch.distributed.run``)."""
    d, files = dp["results"][name]
    stems = {f.split(".")[0] for f in files}
    assert stems == {"toy_dev_0", "toy_test_0"}
    for stem in stems:
        assert {f"{stem}.0.answer", f"{stem}.1.answer", f"{stem}.0.run",
                f"{stem}.1.run"} <= set(files)
        for kind in ("answer", "run"):
            want = _lines(dp["results"]["one"][0], stem, kind)
            assert want and _lines(d, stem, kind) == want, (stem, kind)
