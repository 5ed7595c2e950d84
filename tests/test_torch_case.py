"""The whole slice: CaSE serving in the port against the JAX package, with
bridged weights, in f32 on the CPU. Rank scores agree within 1e-4 and
greedy answers token for token. Also the port's own rules: it imports
nothing of JAX or of the JAX package, and its entry points refuse to run on
the CPU unless asked to."""

import ast
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from case_rg_tpu.config import ModelConfig as JConfig
from case_rg_tpu.models import create_model as jcreate
from case_rg_tpu.runtime.inference import make_predict_fn as jmake_predict_fn
from case_rg_tpu_torch.bridge import load_jax_params
from case_rg_tpu_torch.config import ModelConfig
from case_rg_tpu_torch.models import create_model, multimem
from case_rg_tpu_torch.ops import attention
from case_rg_tpu_torch.runtime.inference import make_predict_fn
from tests.test_torch_bridge import TOY, init_batch
from tests.test_torch_kernels import one_torch_thread  # noqa: F401
from tests.test_torch_kernels import perturb_affine_tree

ROOT = pathlib.Path(__file__).resolve().parent.parent
MAX_LEN = 8
TOL = 1e-4
torch.set_float32_matmul_precision("highest")


def _batch(seed, b=4):
    rng = np.random.RandomState(seed)
    q = rng.randint(4, TOY["vocab_size"], (b, 1, 10)).astype(np.int32)
    p = rng.randint(4, TOY["vocab_size"], (b, 3, 12)).astype(np.int32)
    q[:, :, 7:] = 0                 # padded query tail
    p[:, :, 9:] = 0                 # padded passage tails
    p[1, 2] = 0                     # a passage that is all padding
    return {"query": q, "passage": p}


@pytest.fixture(scope="module")
def slice_pair():
    """JAX CaSE and its bridged port (noisy biases and LayerNorm gains, as
    a checkpoint's), plus the JAX outputs on two batches."""
    jmodel = jcreate("case", JConfig(**TOY))
    params = perturb_affine_tree(jax.tree_util.tree_map(
        np.asarray, jax.jit(lambda: jmodel.init(
            {"params": jax.random.PRNGKey(0),
             "dropout": jax.random.PRNGKey(1)},
            init_batch(2, 10, 3, 12, MAX_LEN),
            method=type(jmodel).train_losses)["params"])()), seed=0)
    variables = {"params": params}
    jpredict = jmake_predict_fn(jmodel, JConfig(**TOY), MAX_LEN)
    jrank = jmake_predict_fn(jmodel, JConfig(**TOY), MAX_LEN, rank_only=True)
    batches = [_batch(1), _batch(2)]
    ref = []
    for bt in batches:
        jb = {k: jnp.asarray(v) for k, v in bt.items()}
        out = jax.device_get(jpredict(variables, jb))
        out["rank_only"] = np.asarray(jax.device_get(jrank(variables, jb))
                                      ["rank"])
        ref.append(out)
    port = create_model("case", ModelConfig(**TOY), device="cpu")
    load_jax_params(port, params)
    return port, batches, ref


def test_rank_only_matches_jax(slice_pair):
    port, batches, ref = slice_pair
    fn = make_predict_fn(port, ModelConfig(**TOY), MAX_LEN, rank_only=True,
                         device="cpu")
    for bt, r in zip(batches, ref):
        out = fn(bt)
        assert set(out) == {"rank"}
        np.testing.assert_allclose(out["rank"].numpy(), r["rank_only"],
                                   rtol=0, atol=TOL)


def test_predict_rank_and_answers_match_jax(slice_pair):
    port, batches, ref = slice_pair
    fn = make_predict_fn(port, ModelConfig(**TOY), MAX_LEN, device="cpu")
    for bt, r in zip(batches, ref):
        out = fn(bt)
        np.testing.assert_allclose(out["rank"].numpy(), np.asarray(r["rank"]),
                                   rtol=0, atol=TOL)
        assert out["answer"].dtype == torch.int32
        assert out["answer"].shape == (4, MAX_LEN)
        np.testing.assert_array_equal(out["answer"].numpy(),
                                      np.asarray(r["answer"]))


def test_fused_stack_forced_decodes_like_layer_chain(slice_pair):
    """Forcing every stack through the fused step (its plain, folded
    version here) decodes the same tokens as the per-layer chain."""
    port, batches, ref = slice_pair
    fn = make_predict_fn(port, ModelConfig(**TOY), MAX_LEN, device="cpu")
    try:
        multimem.set_fused_stack(True)
        fused = [fn(bt) for bt in batches]
        multimem.set_fused_stack(False)
        chain = [fn(bt) for bt in batches]
    finally:
        multimem.set_fused_stack(None)
    for f, c, r in zip(fused, chain, ref):
        np.testing.assert_array_equal(f["answer"].numpy(), c["answer"].numpy())
        np.testing.assert_array_equal(f["answer"].numpy(),
                                      np.asarray(r["answer"]))


def test_fused_attention_forced_matches_dense(slice_pair):
    """Routing every self-attention site through fused_mha (its plain
    version here) gives the dense path's rank scores and answers."""
    port, batches, _ = slice_pair
    fn = make_predict_fn(port, ModelConfig(**TOY), MAX_LEN, device="cpu")
    try:
        attention.set_fused_attention(True)
        fused = [fn(bt) for bt in batches]
        attention.set_fused_attention(False)
        dense = [fn(bt) for bt in batches]
    finally:
        attention.set_fused_attention(None)
    for f, d in zip(fused, dense):
        np.testing.assert_allclose(f["rank"].numpy(), d["rank"].numpy(),
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(f["answer"].numpy(), d["answer"].numpy())


_FORBIDDEN = ("jax", "flax", "optax", "msgpack", "case_rg_tpu")


def _imports(path):
    """Top-level names of every module ``path`` imports (relative imports
    stay inside their package and are skipped)."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_nothing_of_jax():
    files = sorted((ROOT / "case_rg_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    scanned = {str(f.relative_to(ROOT)) for f in files}
    for mod in ("kernels/decode_attention.py", "kernels/additive_attention.py",
                "decode/loops.py", "cli/serve.py", "serving/http.py",
                "train/checkpoint.py", "data/text.py", "native/__init__.py",
                "train/trainer.py", "data/batching.py", "data/loaders.py",
                "data/prepare.py", "cli/prepare.py", "cli/run.py",
                "cli/evaluate.py", "runtime/profiling.py", "pipeline.py",
                "evaluation/harness.py", "evaluation/meteor.py",
                "evaluation/synonyms.py"):
        assert f"case_rg_tpu_torch/{mod}" in scanned, mod
    bad = [(str(f.relative_to(ROOT)), name) for f in files
           for name in _imports(f) if name in _FORBIDDEN]
    assert not bad, bad


def test_entry_points_refuse_the_cpu_unless_asked(slice_pair, monkeypatch):
    """With no card, the entry points raise instead of running on the CPU;
    ``device="cpu"`` is the only way onto it."""
    port, batches, _ = slice_pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_predict_fn(port, ModelConfig(**TOY), MAX_LEN)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_predict_fn(port, ModelConfig(**TOY), MAX_LEN, rank_only=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model("case", ModelConfig(**TOY))
