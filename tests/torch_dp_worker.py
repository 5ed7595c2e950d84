"""The ranks of ``tests/test_torch_distributed.py``: one process a rank, a
gloo group on the CPU (``torch.multiprocessing`` spawn). Imports no JAX.

``run(rank, world, ports, root, prepared_args)`` plays every scenario of
the module fixture and writes what it saw to ``{root}/rank{rank}.pt``:

* ``cli``: ``cli/run --multihost --mode train`` one epoch of the prepared
  toy corpus, then ``--mode test --continuous`` (chunk loop, and device
  loop) of the parent's checkpoint into their own output directories,
  each call joining and leaving its own group (a port of ``ports``
  each);
* ``exact``: three train steps of toy CaSE (dropout off) on the rank's
  ``Batcher`` shard, the first split into ``loss_and_grads`` (its summed
  gradients kept) and ``apply_gradients``; the losses a step and the state
  after them;
* ``accum``: four calls at ``accumulation_steps=2``;
* ``dropout``: the rank's local losses of one batch, the same rows on
  every rank, with the rank's epoch generator;
* ``dev``: ``eval_losses`` of the dev split at the state after ``exact``;
* ``preempt``: ``fit`` with a SIGTERM to rank 1 alone after its second
  step; the steps each rank took and the model directory.
"""

import os
import signal

import numpy as np
import torch

TOY = dict(name="case", vocab_size=64, embedding_size=16, hidden_size=16,
           num_heads=2, enc_layers=1, dec_layers=1, max_dec_len=8)
B = 4
N_TRAIN, N_DEV = 18, 7
SEED = 11


def arrays(n, seed, v=TOY["vocab_size"]):
    """Prepared-style CaSE arrays of the toy shapes; every row's answer,
    query and passages have their own length, so the ranks' shards hold
    different PAD counts."""
    rng = np.random.RandomState(seed)
    q = rng.randint(4, v, (n, 1, 10)).astype(np.int32)
    p = rng.randint(4, v, (n, 3, 12)).astype(np.int32)
    resp = rng.randint(4, v, (n, 8)).astype(np.int32)
    for i in range(n):
        q[i, :, 3 + i % 7:] = 0
        p[i, :, 5 + (3 * i) % 7:] = 0
        resp[i, 2 + (5 * i) % 6:] = 0
    p[1, 2] = 0
    labels = rng.randint(-1, 3, (n, 2)).astype(np.int32)
    labels[:, 0] = np.abs(labels[:, 0])
    return {"id": np.arange(n, dtype=np.int32), "query": q, "passage": p,
            "response": resp, "passage_labels": labels,
            "token_label": (rng.rand(n, 3, 12) > .7).astype(np.float32),
            "token_weight": (1 + rng.rand(n, 3, 12)).astype(np.float32)}


def toy_trainer(**tc):
    from case_rg_tpu_torch.config import ModelConfig, TrainConfig
    from case_rg_tpu_torch.models import create_model
    from case_rg_tpu_torch.train.trainer import Trainer
    model = create_model("case", ModelConfig(**dict(TOY, dropout=0.1)),
                         device="cpu", seed=3)
    kw = dict(batch_size=B, learning_rate=1e-3, warmup_steps=1)
    kw.update(tc)
    return Trainer(model, TrainConfig(**kw), total_steps=20, device="cpu")


def shard_batches(rank, count, k, train=None):
    """The first ``k`` batches of the rank's shard of the training split
    (epochs 0, 1, ... of a ``Batcher`` shuffled by SEED)."""
    from case_rg_tpu_torch.data.batching import Batcher
    batcher = Batcher(arrays(N_TRAIN, 1) if train is None else train, B,
                      shuffle=True, seed=SEED, process_index=rank,
                      process_count=count)
    out, epoch = [], 0
    while len(out) < k:
        out.extend(batcher.epoch(epoch))
        epoch += 1
    return out[:k]


def _state(state):
    return {name: {k: v.detach().clone() for k, v in getattr(
        state, name).items()} for name in ("params", "ema", "mu", "nu")}


def _vals(losses):
    return {k: float(v) for k, v in losses.items()}


def _env(rank, world, port):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))


def _cli(rank, world, ports, root, prepared_args):
    """cli/run --multihost: train one epoch into ``{root}/dp_train``, then
    test the checkpoint the parent put under ``{root}/continuous`` and
    ``{root}/device_loop`` through the continuous loops."""
    from case_rg_tpu_torch.cli.run import main as run_main
    argv = prepared_args + ["--multihost", "--device", "cpu"]
    _env(rank, world, ports[0])
    run_main(argv + ["--mode", "train", "--epoch", "1",
                     "--output_path", os.path.join(root, "dp_train")])
    for i, (name, extra) in enumerate((
            ("continuous", ["--continuous", "--chunk_steps", "3"]),
            ("device_loop", ["--continuous", "--chunk_steps", "3",
                             "--device_loop", "2"]))):
        _env(rank, world, ports[1 + i])
        run_main(argv + ["--mode", "test", "--epoch", "1", "--output_path",
                         os.path.join(root, name)] + extra)


def run(rank, world, ports, root, prepared_args):
    torch.set_num_threads(1)
    from case_rg_tpu_torch.runtime import mesh
    from case_rg_tpu_torch.train.trainer import epoch_generator
    _cli(rank, world, ports, root, prepared_args)
    res = {}
    _env(rank, world, ports[3])
    mesh.init_distributed("cpu")
    try:
        # exact: three steps, dropout off
        t = toy_trainer()
        state = t.init_state()
        res["init"] = _state(state)
        steps = []
        for j, batch in enumerate(shard_batches(rank, world, 3)):
            if j == 0:
                losses, grads = t.loss_and_grads(state, batch, None)
                res["grads"] = {k: v.clone() for k, v in grads.items()}
                losses["grad_norm"] = t.apply_gradients(state, grads)
            else:
                losses = t.train_step(state, batch, None)
            steps.append(_vals(losses))
        res["exact"] = {"losses": steps, "state": _state(state),
                        "count": state.count, "step": state.step,
                        "checksum": t.check_replicas(state)}
        res["dev"] = t.eval_losses(state, arrays(N_DEV, 2))

        # accumulation 2: four calls, two updates
        t = toy_trainer(accumulation_steps=2)
        state = t.init_state()
        steps = [_vals(t.train_step(state, b, None))
                 for b in shard_batches(rank, world, 4)]
        res["accum"] = {"losses": steps, "state": _state(state),
                        "count": state.count, "step": state.step}

        # dropout: the same rows on every rank, each rank's generator
        batch = shard_batches(0, world, 1)[0]
        from case_rg_tpu_torch.device import batch_to_device
        from case_rg_tpu_torch.train.trainer import _device_fields
        gen = epoch_generator(SEED, 0, torch.device("cpu"), rank)
        with torch.no_grad():
            local = t._run(state.params, batch_to_device(
                _device_fields(batch), t.device), gen, False)
        res["dropout"] = _vals(local)

        # preemption: SIGTERM to rank 1 alone, after its second step
        t = toy_trainer()
        calls = []
        step = t.train_step

        def stepping(state, batch, gen):
            losses = step(state, batch, gen)
            calls.append(state.step)
            if rank == 1 and len(calls) == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return losses

        t.train_step = stepping
        out = os.path.join(root, "preempt")
        state = t.fit(t.init_state(), arrays(N_TRAIN, 1), 3, out, seed=SEED)
        res["preempt"] = {"calls": calls, "step": state.step,
                          "files": sorted(os.listdir(os.path.join(out,
                                                                  "model")))}
        mesh.barrier()
    finally:
        mesh.shutdown()
    torch.save(res, os.path.join(root, f"rank{rank}.pt"))
