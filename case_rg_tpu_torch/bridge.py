"""Weight bridge: the JAX package's flax param tree -> the port's weights.

The caller hands over the tree as a nested mapping of numpy arrays (for
example ``jax.tree_util.tree_map(np.asarray, params)``); this module never
sees JAX. Names map one for one ("a/b/c/kernel" -> "a.b.c.weight"):

* a Dense ``kernel`` [in, out] -> ``weight`` [out, in];
* ``qkv_kernel`` [E, 3E] / ``qkv_bias`` -> ``in_proj_weight`` [3E, E] /
  ``in_proj_bias``, the packed q | k | v in-projection;
* a LayerNorm ``scale`` -> ``weight``; an Embedding ``embedding`` ->
  ``weight``;
* the interaction's ``dual_att_kernel`` [3D, 1] -> ``dual_att.weight``
  [1, 3D] (the bilinear ``v/kernel`` [H, 1] is an ordinary Dense kernel);
* a GRU's ``w_ih_l{layer}_d{dir}`` / ``w_hh_...`` / ``b_ih_...`` /
  ``b_hh_...`` keep their names and layout (``ops/gru.GRU`` holds them
  as the JAX package does).

The load is strict: an unused leaf, a parameter left unset or a shape
mismatch raises.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, Tuple

import re

import numpy as np
import torch

# leaf name -> (port's attribute path, whether the array is transposed)
_LEAVES = {
    "kernel": (("weight",), True),
    "bias": (("bias",), False),
    "scale": (("weight",), False),
    "embedding": (("weight",), False),
    "qkv_kernel": (("in_proj_weight",), True),
    "qkv_bias": (("in_proj_bias",), False),
    "dual_att_kernel": (("dual_att", "weight"), True),
}


_GRU_LEAF = re.compile(r"[wb]_(ih|hh)_l\d+_d\d+$")


def _flatten(tree, prefix=()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = prefix + (str(k),)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def state_dict_from_jax(tree: Mapping) -> Dict[str, np.ndarray]:
    """Port parameter name -> f32 array in the port's layout."""
    out = {}
    for path, arr in _flatten(tree).items():
        if _GRU_LEAF.match(path[-1]):
            attr, transpose = (path[-1],), False
        elif path[-1] in _LEAVES:
            attr, transpose = _LEAVES[path[-1]]
        else:
            raise KeyError(f"bridge: no mapping for leaf {'/'.join(path)}")
        arr = np.asarray(arr, dtype=np.float32)
        out[".".join(path[:-1] + attr)] = arr.T if transpose else arr
    return out


def load_state(model: torch.nn.Module, sd: Mapping) -> None:
    """Copy a state dict (port parameter name -> array or tensor) into
    ``model``'s parameters, cast to each parameter's dtype and device.
    Strict: an unused name, a parameter left unset or a shape mismatch
    raises."""
    params = dict(model.named_parameters())
    unused = sorted(set(sd) - set(params))
    unset = sorted(set(params) - set(sd))
    if unused or unset:
        raise ValueError(f"bridge: unused leaves {unused}; unset "
                         f"parameters {unset}")
    for name, arr in sd.items():
        if tuple(arr.shape) != tuple(params[name].shape):
            raise ValueError(f"bridge: {name} has shape {tuple(arr.shape)}, "
                             f"the port expects {tuple(params[name].shape)}")
    with torch.no_grad():
        for name, arr in sd.items():
            p = params[name]
            src = arr if isinstance(arr, torch.Tensor) else \
                torch.tensor(np.asarray(arr))
            p.copy_(src.to(device=p.device, dtype=p.dtype))


def load_jax_params(model: torch.nn.Module, tree: Mapping) -> None:
    """Copy a JAX param tree into ``model``'s parameters (cast to each
    parameter's dtype and device)."""
    load_state(model, state_dict_from_jax(tree))
