"""Loss helpers (port of ``case_rg_tpu/models/base.py``), each with an
optional per-sample weight vector, so a padded final batch is
loss-identical to a ragged one:

* ``nll_from_probs``: mean of -log(p + 1e-8) over non-PAD target tokens;
* ``cross_entropy``: token cross entropy over non-PAD targets (S2SA's and
  TMemNet's loss);
* ``bce_with_logits``: elementwise sigmoid BCE, mean over all elements;
* ``one_hot_labels``: the scatter(1, label, 1) one-hot (zeros out of
  range).
"""

from __future__ import annotations

import torch


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
    """scatter_(1, label, 1) one-hot, f32; an index outside [0, num) gives
    a row of zeros, as ``jax.nn.one_hot`` does (a gold passage can sit past
    the scored pool when the data was prepared with more pool passages
    than ``num_passage``)."""
    return (indices.long()[..., None]
            == torch.arange(num, device=indices.device)).float()


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  sample_weight=None) -> torch.Tensor:
    """Token-level cross entropy over non-PAD targets (ignore_index 0).
    logits: [B, T, V], targets: [B, T]."""
    w = _expand_weight(sample_weight, targets.shape[0], targets.device)
    tok_w = (targets != 0).float() * w[:, None]
    logp = torch.log_softmax(logits, dim=-1)
    picked = logp.gather(-1, targets.long()[..., None])[..., 0]
    return -(picked * tok_w).sum() / tok_w.sum().clamp_min(1.0)
