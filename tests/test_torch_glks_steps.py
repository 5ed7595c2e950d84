"""GLKS over three optimiser steps in the port against the JAX package, in
f32 on the CPU (ROADMAP Queue 3 item 2: on the card, GLKS's loss without
dropout rose over its first bf16 train steps on one batch).

One toy batch, dropout off on both sides, the schedule of chip_smoke.py's
training phase (learning rate 2.5e-4, one warm-up step, so the first step
is at rate 0; 1000 total steps): three steps of the port's ``Trainer``
(``ds_mle_mce_train``) against three steps of the JAX package's
``make_optimizer`` (clip, Adam, schedule) on the JAX gradients of
``GLKSModel.train_losses`` at the same weights (the JAX ``Trainer`` is not
compiled). Each step's losses agree within the first-step test's
tolerance (``tests/test_torch_baselines.LOSS_RTOL``), and so does the loss
after the third step; the parameters agree within
``tests/test_torch_train.TRAIN_ATOL``.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from case_rg_tpu.config import ModelConfig as JConfig
from case_rg_tpu.config import TrainConfig as JTrainConfig
from case_rg_tpu.models import create_model as jcreate
from case_rg_tpu.train.trainer import make_optimizer
from case_rg_tpu_torch.bridge import load_jax_params, state_dict_from_jax
from case_rg_tpu_torch.config import ModelConfig, TrainConfig
from case_rg_tpu_torch.models import create_model
from case_rg_tpu_torch.train.trainer import Trainer
from tests.test_torch_baselines import (CFG, FAST_COMPILE, LOSS_RTOL,
                                        WEIGHT_SCALE, batch, jbatch)
from tests.test_torch_bridge import jax_tree_from_port
from tests.test_torch_continuous import random_tree
from tests.test_torch_kernels import one_torch_thread  # noqa: F401
from tests.test_torch_train import TRAIN_ATOL

STEPS = 3
SCHEDULE = dict(batch_size=6, learning_rate=2.5e-4, warmup_steps=1)
torch.set_float32_matmul_precision("highest")


def test_glks_three_steps_track_the_jax_optimizer():
    layout = jax_tree_from_port(create_model(
        "glks", ModelConfig(name="glks", **CFG), device="cpu"))
    params = jax.tree_util.tree_map(lambda a: a * WEIGHT_SCALE["glks"],
                                    random_tree(layout, seed=1))
    bt = batch(2, 6)
    bt["sample_weight"][:] = 1.0

    jmodel = jcreate("glks", JConfig(name="glks", **CFG))
    tx = make_optimizer(JTrainConfig(**SCHEDULE), total_steps=1000)

    def losses(p, b):
        out = jmodel.apply({"params": p}, b, deterministic=True,
                           method=type(jmodel).train_losses)
        return sum(out.values()), out

    def step(p, opt, b):
        (_, out), g = jax.value_and_grad(losses, has_aux=True)(p, b)
        updates, opt = tx.update(g, opt, p)
        return jax.tree_util.tree_map(lambda a, u: a + u, p, updates), opt, out

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt = tx.init(jp)
    jb = jbatch(bt)
    jstep = jax.jit(step).lower(jp, opt, jb).compile(FAST_COMPILE)
    want = []
    for _ in range(STEPS):
        jp, opt, out = jstep(jp, opt, jb)
        want.append({k: float(v) for k, v in out.items()})
    jlast = jax.jit(losses).lower(jp, jb).compile(FAST_COMPILE)(jp, jb)[1]
    want_last = {k: float(v) for k, v in jlast.items()}

    port = create_model("glks", ModelConfig(name="glks", **CFG), device="cpu")
    load_jax_params(port, params)
    trainer = Trainer(port, TrainConfig(**SCHEDULE), total_steps=1000,
                      device="cpu",
                      loss_method_kwargs={"mode": "ds_mle_mce_train"})
    st = trainer.init_state()
    got = []
    for _ in range(STEPS):
        out = trainer.train_step(st, bt, None)
        got.append({k: float(out[k]) for k in want[0]})
    last = trainer.eval_batch(st, bt)
    got_last = {k: float(last[k]) for k in want_last}

    for g, w in zip(got + [got_last], want + [want_last]):
        assert set(g) == set(w) == {"ds", "mle", "mce"}
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL, err_msg=k)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    for name, p in st.params.items():
        np.testing.assert_allclose(p.detach().numpy(), ref[name], rtol=0,
                                   atol=TRAIN_ATOL, err_msg=name)
    # the record: the summed loss before the steps, after each, after all
    totals = [sum(w.values()) for w in want + [want_last]]
    print(f"glks f32 losses (JAX): {totals}")
