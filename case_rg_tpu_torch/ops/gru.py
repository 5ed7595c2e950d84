"""GRU over padded sequences as a masked scan (port of
``case_rg_tpu/ops/gru.py``).

No packing: sequences keep their fixed shape and padding (on the right) is
handled by a mask inside a Python loop over time steps:

* forward direction: at a padded step the hidden state passes through
  unchanged, so the final state is the state at each row's last valid
  token (the packed final state);
* backward direction: the scan runs over the time-reversed sequence from
  h0; padding is on the right, so the state stays at h0 until the first
  valid token, as if only the valid suffix were processed;
* outputs at padded steps are zero (the packed zero fill).

The gate math is ``torch.nn.GRU``'s (r/z/n gate order, ``n = tanh(W_in x +
b_in + r * (W_hn h + b_hn))``). Weights keep the JAX package's layout and
names (``w_ih_l{layer}_d{dir}`` [in, 3H], ``w_hh_...`` [H, 3H], ``b_ih_...``,
``b_hh_...`` [3H]), so the weight bridge maps them as they are. The
input-to-hidden projection of the whole sequence is one product hoisted out
of the loop; only the recurrent half runs per step (eager, several launches
a step on the card).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn


def gru_gates(gx: torch.Tensor, h: torch.Tensor, w_hh: torch.Tensor,
              b_hh: torch.Tensor, hidden_size: int) -> torch.Tensor:
    """The recurrent half given precomputed input gates ``gx``."""
    hs = hidden_size
    gh = h @ w_hh + b_hh
    r = torch.sigmoid(gx[..., :hs] + gh[..., :hs])
    z = torch.sigmoid(gx[..., hs:2 * hs] + gh[..., hs:2 * hs])
    n = torch.tanh(gx[..., 2 * hs:] + r * gh[..., 2 * hs:])
    return (1.0 - z) * n + z * h


class GRU(nn.Module):
    """Multi-layer, optionally bidirectional GRU (``torch.nn.GRU(
    batch_first=True)``'s function): outputs [B, L, dirs*H] (both
    directions concatenated per position) and the final state
    [B, num_layers*dirs, H], layer-major and direction-minor."""

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1, bidirectional: bool = False, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.bidirectional = bidirectional
        dirs = 2 if bidirectional else 1
        for layer in range(num_layers):
            in_size = input_size if layer == 0 else hidden_size * dirs
            for d in range(dirs):
                tag = f"l{layer}_d{d}"
                for name, shape in (
                        (f"w_ih_{tag}", (in_size, 3 * hidden_size)),
                        (f"w_hh_{tag}", (hidden_size, 3 * hidden_size)),
                        (f"b_ih_{tag}", (3 * hidden_size,)),
                        (f"b_hh_{tag}", (3 * hidden_size,))):
                    self.register_parameter(
                        name, nn.Parameter(torch.empty(shape, **kw)))

    def _weights(self, idx: int) -> List[torch.Tensor]:
        dirs = 2 if self.bidirectional else 1
        tag = f"l{idx // dirs}_d{idx % dirs}"
        return [getattr(self, f"{w}_{tag}")
                for w in ("w_ih", "w_hh", "b_ih", "b_hh")]

    def _scan_direction(self, idx: int, x: torch.Tensor, mask: torch.Tensor,
                        h: torch.Tensor, reverse: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        w_ih, w_hh, b_ih, b_hh = self._weights(idx)
        gx = x @ w_ih + b_ih                 # [B, L, 3H]: one product
        steps = range(x.shape[1] - 1, -1, -1) if reverse \
            else range(x.shape[1])
        keep = mask[:, :, None]
        zero = torch.zeros((), dtype=h.dtype, device=h.device)
        outs = [None] * x.shape[1]
        for t in steps:
            h_new = gru_gates(gx[:, t], h, w_hh, b_hh, self.hidden_size)
            h = torch.where(keep[:, t], h_new, h)
            outs[t] = torch.where(keep[:, t], h_new, zero)
        return torch.stack(outs, dim=1), h

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [B, L, In]; mask: bool [B, L] (True = a real token); h0:
        [B, num_layers*dirs, H] (zeros by default)."""
        b, l, _ = x.shape
        dirs = 2 if self.bidirectional else 1
        if mask is None:
            mask = torch.ones(b, l, dtype=torch.bool, device=x.device)
        if h0 is None:
            h0 = torch.zeros(b, self.num_layers * dirs, self.hidden_size,
                             dtype=x.dtype, device=x.device)
        finals = []
        out = x
        for layer in range(self.num_layers):
            outs_dir = []
            for d in range(dirs):
                idx = layer * dirs + d
                o, hf = self._scan_direction(idx, out, mask, h0[:, idx],
                                             reverse=d == 1)
                outs_dir.append(o)
                finals.append(hf)
            out = torch.cat(outs_dir, dim=-1) if dirs == 2 else outs_dir[0]
        return out, torch.stack(finals, dim=1)

    def step(self, x_t: torch.Tensor, h: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One decode step (unidirectional only). x_t: [B, In], h: [B,
        num_layers, H] -> (top layer's output [B, H], new state [B,
        num_layers, H])."""
        assert not self.bidirectional
        new_h = []
        out = x_t
        for layer in range(self.num_layers):
            w_ih, w_hh, b_ih, b_hh = self._weights(layer)
            gx = out @ w_ih + b_ih
            out = gru_gates(gx, h[:, layer], w_hh, b_hh, self.hidden_size)
            new_h.append(out)
        return out, torch.stack(new_h, dim=1)
