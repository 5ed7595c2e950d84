"""The weight bridge (case_rg_tpu_torch/bridge.py): a CaSE init tree from
the JAX package maps leaf for leaf onto the port's parameters, and a
leftover leaf, an unset parameter or a shape mismatch raises.
``jax_tree_from_port`` (the bridge's inverse, for the tests: a JAX
parameter tree built from a port model without tracing the JAX model's
init) gives the JAX init tree's structure and shapes."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from torch import nn

from case_rg_tpu.config import ModelConfig as JConfig
from case_rg_tpu.models import create_model as jcreate
from case_rg_tpu_torch.bridge import load_jax_params, state_dict_from_jax
from case_rg_tpu_torch.config import ModelConfig
from case_rg_tpu_torch.models import create_model
from case_rg_tpu_torch.models.case import CaSEModel
from case_rg_tpu_torch.ops.embedding import Embedding
from tests.test_torch_kernels import one_torch_thread  # noqa: F401

TOY = dict(name="case", vocab_size=64, embedding_size=16, hidden_size=16,
           num_heads=2, enc_layers=1, dec_layers=2, max_dec_len=8)


def init_batch(b, lq, p, lp, t):
    return {"query": jnp.ones((b, 1, lq), jnp.int32),
            "passage": jnp.ones((b, p, lp), jnp.int32),
            "response": jnp.ones((b, t), jnp.int32),
            "passage_label": jnp.zeros((b,), jnp.int32),
            "token_label": jnp.zeros((b, p, lp), jnp.float32),
            "token_weight": jnp.ones((b, p, lp), jnp.float32)}


def jax_case_params(fields=TOY, shapes=(2, 10, 3, 12, 8), abstract=False):
    """The JAX package's CaSE init tree as numpy arrays (or, with
    ``abstract``, zero-stride placeholders of the right shapes)."""
    model = jcreate("case", JConfig(**fields))
    init = lambda: model.init({"params": jax.random.PRNGKey(0),
                               "dropout": jax.random.PRNGKey(1)},
                              init_batch(*shapes),
                              method=type(model).train_losses)["params"]
    if abstract:
        return jax.tree_util.tree_map(
            lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape),
            jax.eval_shape(init))
    return jax.tree_util.tree_map(np.asarray, jax.jit(init)())


def jax_tree_from_port(model: nn.Module) -> dict:
    """The JAX package's parameter tree (numpy, f32) holding ``model``'s
    parameters: the bridge's rules run backwards, so
    ``state_dict_from_jax(jax_tree_from_port(m))`` is ``m``'s state."""
    tree = {}
    for name, p in model.named_parameters():
        *path, leaf = name.split(".")
        mod = model.get_submodule(".".join(path))
        arr = p.detach().float().cpu().numpy()
        if leaf == "in_proj_weight":
            key, arr = "qkv_kernel", arr.T
        elif leaf == "in_proj_bias":
            key = "qkv_bias"
        elif path and path[-1] == "dual_att":
            path, key, arr = path[:-1], "dual_att_kernel", arr.T
        elif isinstance(mod, nn.LayerNorm) and leaf == "weight":
            key = "scale"
        elif isinstance(mod, Embedding):
            key = "embedding"
        elif isinstance(mod, nn.Linear) and leaf == "weight":
            key, arr = "kernel", arr.T
        else:
            key = leaf                  # biases and the GRU's own names
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[key] = np.ascontiguousarray(arr)
    return tree


@pytest.fixture(scope="module")
def toy_tree():
    return jax_case_params()


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def test_case_tree_maps_leaf_for_leaf(toy_tree):
    model = create_model("case", ModelConfig(**TOY), device="cpu")
    load_jax_params(model, toy_tree)
    params = dict(model.named_parameters())
    sd = state_dict_from_jax(toy_tree)
    assert len(sd) == len(params) == len(_leaves(toy_tree))
    for name, arr in sd.items():
        np.testing.assert_array_equal(params[name].detach().numpy(), arr,
                                      err_msg=name)
    # spot checks of the layout rules
    enc = toy_tree["encoder"]["enc"]["layer0"]["self_attn"]
    np.testing.assert_array_equal(
        model.encoder.enc.layer0.self_attn.in_proj_weight.detach().numpy(),
        enc["qkv_kernel"].T)
    np.testing.assert_array_equal(
        model.ps_tower.interaction.dual_att.weight.detach().numpy(),
        toy_tree["ps_tower"]["interaction"]["dual_att_kernel"].T)


def test_case_tree_at_bench_widths():
    """At the serving widths (V=30522, E=256, H=8, 3+4 layers) the tree has
    365 leaves and 61.9 M parameters, and every one has a port parameter
    of the same shape."""
    fields = dict(TOY, vocab_size=30522, embedding_size=256, hidden_size=256,
                  num_heads=8, enc_layers=3, dec_layers=4, max_dec_len=40)
    tree = jax_case_params(fields, shapes=(1, 60, 10, 100, 40), abstract=True)
    sd = state_dict_from_jax(tree)
    params = dict(CaSEModel(ModelConfig(**fields),
                            device="meta").named_parameters())
    assert len(sd) == len(params) == 365
    assert {k: tuple(v.shape) for k, v in sd.items()} == \
        {k: tuple(v.shape) for k, v in params.items()}
    n = sum(int(np.prod(v.shape)) for v in sd.values())
    assert round(n / 1e6, 1) == 61.9


def test_port_tree_is_the_jax_tree(toy_tree):
    """``jax_tree_from_port`` of the port's CaSE has the JAX init tree's
    paths and shapes, and maps back onto the port's parameters."""
    model = create_model("case", ModelConfig(**TOY), device="cpu")
    tree = jax_tree_from_port(model)
    shapes = lambda t: jax.tree_util.tree_map(lambda a: a.shape, t)
    assert shapes(tree) == shapes(toy_tree)
    for name, arr in state_dict_from_jax(tree).items():
        np.testing.assert_array_equal(
            dict(model.named_parameters())[name].detach().numpy(), arr)


def _copy_tree(tree):
    return jax.tree_util.tree_map(lambda a: a, tree)


def test_bridge_rejects_leftover_leaf(toy_tree):
    tree = _copy_tree(toy_tree)
    tree["decoder"]["gen2"]["bias"] = np.zeros(64, np.float32)
    model = create_model("case", ModelConfig(**TOY), device="cpu")
    with pytest.raises(ValueError, match="unused leaves"):
        load_jax_params(model, tree)


def test_bridge_rejects_unset_parameter(toy_tree):
    tree = _copy_tree(toy_tree)
    del tree["sti_norm_p"]["bias"]
    model = create_model("case", ModelConfig(**TOY), device="cpu")
    with pytest.raises(ValueError, match="unset parameters"):
        load_jax_params(model, tree)


def test_bridge_rejects_shape_mismatch(toy_tree):
    tree = _copy_tree(toy_tree)
    tree["ps_scorer"]["kernel"] = np.zeros((16, 2), np.float32)
    model = create_model("case", ModelConfig(**TOY), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(model, tree)


def test_bridge_rejects_unknown_leaf_name(toy_tree):
    tree = _copy_tree(toy_tree)
    tree["ps_scorer"]["gamma"] = np.zeros(1, np.float32)
    with pytest.raises(KeyError):
        state_dict_from_jax(tree)


def test_perturb_affine_moves_every_bias_and_gain_only():
    """``perturb_affine`` (used by the on-card checks) puts seeded noise on
    every bias and LayerNorm gain and leaves every other weight as it was."""
    import torch
    from case_rg_tpu_torch.models import perturb_affine
    model = create_model("case", ModelConfig(**TOY), device="cpu")
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    perturb_affine(model, torch.Generator().manual_seed(0))
    gains = {f"{n}.weight" for n, m in model.named_modules()
             if isinstance(m, torch.nn.LayerNorm)}
    moved = 0
    for name, p in model.named_parameters():
        if name.endswith("bias") or name in gains:
            assert not torch.equal(p, before[name]), name
            ref = 1.0 if name in gains else 0.0
            assert float((p.detach() - ref).abs().max()) < 1.0, name
            moved += 1
        else:
            assert torch.equal(p, before[name]), name
    assert moved > 50
