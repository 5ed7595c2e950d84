"""Device resolution for the port's entry points.

The entry points default to ``device="cuda"``. Without a card they raise
instead of running on the CPU; the CPU is used only when a caller asks for
it (the tests do). In a process group that ``runtime/mesh.init_distributed``
made on the card, "cuda" is this rank's card, ``cuda:LOCAL_RANK``."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .runtime.mesh import local_device


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "case_rg_tpu_torch: a CUDA device was requested but torch sees "
            "none; pass device='cpu' to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        return local_device() or dev
    return dev


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """A batch of numpy arrays or tensors on ``device``: integer fields as
    int64 (ids, labels, u32 sampling keys), float fields as they are."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            if v.dtype == np.uint32:
                v = v.astype(np.int64)
            v = torch.from_numpy(v)
        if not v.is_floating_point():
            v = v.long()
        out[k] = v.to(device, non_blocking=True)
    return out


@contextlib.contextmanager
def no_host_sync():
    """Inside the block, any operation that makes the host wait on the card
    (a blocking copy, ``.item()``, a stream or device synchronise) raises
    (``torch.cuda.set_sync_debug_mode("error")``). The step loops run under
    it in the ``cuda`` tests and in chip_smoke.py."""
    saved = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(saved)
