"""Continuous batching for greedy and sampled serving (port of
``case_rg_tpu/runtime/continuous``; CaSE).

A fixed-batch decode runs every row for all ``max_len`` steps (or, with
early exit, until the last row ends). Here rows progress on their own:
finished rows are harvested between chunks of ``chunk_steps`` decode steps
and their slots refilled with new requests mid-flight, so a batch's cost
tracks the mean answer length instead of the longest.

The decode state is a dict of fixed-shape [B, ...] tensors (per-row step
indices, KV caches, memories, copy operands: ``models/multimem.py``
``chunk_init``/``chunk_step``); a refill is a row scatter of a freshly
encoded state of ``refill`` rows into the live one. The decode math is
row-independent (a sampled row draws from its own key), so a request's
answer is the one-shot ``predict``'s whatever the batch it rides in (bit
for bit in f32 on the CPU; on a card the encode at another batch width may
take other GEMM algorithms).

Unlike the JAX package's functional state, the KV caches are updated in
place on one CUDA stream; what a harvest reads (``done``, ``out``,
``trow``) goes to the host through ``HostCopy``, a non-blocking copy into
pinned memory enqueued before the next chunk.

Layout: ``base`` (program builders, ``refill_rows``, host copies, request
sources, the lazy rank handle), ``single`` (the one-lane driver
``run_continuous``), ``multi`` (``Lane`` and the per-pool-bucket driver
``run_continuous_multi``). The device-resident driver of the JAX package
(``device_loop``) is not ported yet.
"""

from .base import (HostCopy, IterSource, QueueSource, _LazyRank,
                   make_continuous_fns, refill_rows)
from .multi import Lane, run_continuous_multi
from .single import run_continuous

__all__ = [
    "HostCopy", "IterSource", "QueueSource", "Lane", "make_continuous_fns",
    "refill_rows", "run_continuous", "run_continuous_multi",
]
