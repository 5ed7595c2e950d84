"""Mixed precision (port of ``case_rg_tpu/train/precision.py``,
``cast_params``).

bf16 training is a cast, not autocast: every f32 master parameter is cast
to bf16 inside the differentiated function and the whole forward runs in
bf16 (LayerNorm, softmax and reductions included, as in the JAX package;
``torch.autocast`` would keep those in f32 and compute another function).
Gradients reach the f32 masters through the cast.
"""

from __future__ import annotations

from typing import Dict

import torch


def cast_params(params: Dict[str, torch.Tensor],
                dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Every float32 tensor cast to ``dtype`` (others untouched);
    differentiable."""
    return {k: v.to(dtype) if v.dtype == torch.float32 else v
            for k, v in params.items()}
