"""Decode-cache write helper (port of ``case_rg_tpu/ops/cache.py``).

Unlike the JAX function, which returns a new buffer, ``write_step`` updates
``buf`` IN PLACE and returns it: a decode step writes one slot of a
[B, T, ...] buffer instead of copying it whole.
"""

from __future__ import annotations

import torch


def write_step(buf: torch.Tensor, val: torch.Tensor, t) -> torch.Tensor:
    """Write ``val`` [B, 1, ...] into ``buf`` [B, T, ...] at step ``t``.

    ``t`` int: every row writes slot t (an out-of-range t writes nothing).
    ``t`` [B] tensor: each row writes its own slot; rows whose ``t`` is out
    of range (done rows are pointed at T) skip their write. The per-row
    form gathers the old value for skipped rows and writes it back, so it
    never synchronises with the device.
    """
    tmax = buf.shape[1]
    if not isinstance(t, torch.Tensor) or t.ndim == 0:
        t = int(t)
        if 0 <= t < tmax:
            buf[:, t] = val[:, 0]
        return buf
    rows = torch.arange(buf.shape[0], device=buf.device)
    live = (t >= 0) & (t < tmax)
    tc = t.clamp(0, tmax - 1).long()
    old = buf[rows, tc]
    live = live.reshape((-1,) + (1,) * (old.ndim - 1))
    buf[rows, tc] = torch.where(live, val[:, 0].to(buf.dtype), old)
    return buf
