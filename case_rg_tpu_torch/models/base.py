"""Loss helpers (port of ``case_rg_tpu/models/base.py``), each with an
optional per-sample weight vector, so a padded final batch is
loss-identical to a ragged one:

* ``nll_from_probs``: mean of -log(p + 1e-8) over non-PAD target tokens;
* ``bce_with_logits``: elementwise sigmoid BCE, mean over all elements;
* ``one_hot_labels``: the scatter(1, label, 1) one-hot.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _expand_weight(sample_weight, n: int, device) -> torch.Tensor:
    if sample_weight is None:
        return torch.ones(n, dtype=torch.float32, device=device)
    return sample_weight.float()


def nll_from_probs(probs_at_target: torch.Tensor, targets: torch.Tensor,
                   sample_weight=None, eps: float = 1e-8) -> torch.Tensor:
    """-log(p + eps) averaged over non-PAD target tokens."""
    w = _expand_weight(sample_weight, targets.shape[0], targets.device)
    tok_w = (targets != 0).float() * w[:, None]
    loss = -torch.log(probs_at_target + eps)
    return (loss * tok_w).sum() / tok_w.sum().clamp_min(1.0)


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                    sample_weight=None) -> torch.Tensor:
    """Elementwise sigmoid BCE, mean over all elements (optionally
    batch-weighted)."""
    w = _expand_weight(sample_weight, logits.shape[0], logits.device)
    per = (logits.clamp_min(0) - logits * labels
           + torch.log1p(torch.exp(-logits.abs())))
    per_b = per.reshape(logits.shape[0], -1)
    elems = per_b.shape[1]
    return (per_b.sum(dim=1) * w).sum() / (w.sum() * elems).clamp_min(1.0)


def one_hot_labels(indices: torch.Tensor, num: int) -> torch.Tensor:
    """scatter_(1, label, 1) one-hot, f32."""
    return F.one_hot(indices.long(), num).float()
