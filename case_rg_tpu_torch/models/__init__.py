"""Models of the port (counterparts of ``case_rg_tpu/models``): CaSE,
Masque, S2SA, GTTP, GLKS and TMemNet."""

from __future__ import annotations

import math

import torch
from torch import nn

from ..config import ModelConfig
from ..device import resolve_device
from ..ops.attention import MultiHeadAttention
from ..ops.embedding import Embedding
from ..ops.gru import GRU

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _xavier_uniform_(w: torch.Tensor, generator: torch.Generator) -> None:
    """Glorot uniform over a 2-D weight (fans are symmetric in the bound,
    so the [out, in] layout draws from the same range as flax's [in, out])."""
    bound = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
    w.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """The flax initializers: xavier-uniform for Dense weights, the packed
    QKV projection, embeddings and GRU weights; zero biases; LayerNorm
    ones/zeros."""
    for mod in module.modules():
        if isinstance(mod, nn.Linear):
            _xavier_uniform_(mod.weight, generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, Embedding):
            _xavier_uniform_(mod.weight, generator)
        elif isinstance(mod, MultiHeadAttention):
            _xavier_uniform_(mod.in_proj_weight, generator)
            mod.in_proj_bias.zero_()
        elif isinstance(mod, GRU):
            for name, p in mod.named_parameters(recurse=False):
                if name.startswith("w_"):
                    _xavier_uniform_(p, generator)
                else:
                    p.zero_()


@torch.no_grad()
def perturb_affine(module: nn.Module, generator: torch.Generator,
                   scale: float = 0.1) -> None:
    """Seeded noise on every bias (GRU biases included) and LayerNorm gain:
    biases become ``scale * N(0, 1)`` and gains ``1 + scale * N(0, 1)``.
    The flax init leaves them 0 and 1, where a checkpoint's are not; checks
    of code that reads them (the folded decoder stack's ``u`` and ``bout``)
    need them nonzero."""
    def noise(p):
        return scale * torch.randn(p.shape, generator=generator,
                                   device=p.device).to(p.dtype)

    for mod in module.modules():
        if isinstance(mod, nn.LayerNorm):
            mod.weight.copy_(1.0 + noise(mod.weight))
        for name in ("bias", "in_proj_bias"):
            p = getattr(mod, name, None)
            if isinstance(p, nn.Parameter):
                p.copy_(noise(p))
        if isinstance(mod, GRU):
            for name, p in mod.named_parameters(recurse=False):
                if name.startswith("b_"):
                    p.copy_(noise(p))


def build_model_cfg(base: ModelConfig, name: str, vocab) -> ModelConfig:
    """Fill vocabulary-dependent fields of a ModelConfig."""
    return base.replace(name=name, vocab_size=len(vocab),
                        pad_id=vocab.pad_id, bos_id=vocab.bos_id,
                        unk_id=vocab.unk_id, eos_id=vocab.eos_id)


def create_model(name: str, cfg: ModelConfig, *, device="cuda",
                 seed: int = 0) -> nn.Module:
    """Build ``name`` (one of ``config.MODEL_NAMES``) with weights drawn
    from ``seed`` on ``device`` (in f32, then cast once to
    ``cfg.param_dtype``). Raises without a card unless ``device="cpu"``."""
    from .case import CaSEModel
    from .glks import GLKSModel
    from .gttp import GTTPModel
    from .masque import MasqueModel
    from .s2sa import S2SAModel
    from .tmemnet import TMemNetModel
    classes = {"case": CaSEModel, "masque": MasqueModel, "s2sa": S2SAModel,
               "gttp": GTTPModel, "glks": GLKSModel, "tmemnet": TMemNetModel}
    if name not in classes:
        raise ValueError(f"unknown model {name!r} (one of {sorted(classes)})")
    dev = resolve_device(device)
    model = classes[name](cfg, device=dev, dtype=torch.float32)
    init_weights(model, torch.Generator(device=dev).manual_seed(seed))
    return model.to(_DTYPES[cfg.param_dtype]).eval()
