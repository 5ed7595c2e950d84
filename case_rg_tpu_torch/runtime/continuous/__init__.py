"""Continuous batching for greedy and sampled serving (port of
``case_rg_tpu/runtime/continuous``; every model: CaSE's and Masque's own
chunked decode, the others' through ``models/predict.py``).

A fixed-batch decode runs every row for all ``max_len`` steps (or, with
early exit, until the last row ends). Here rows progress on their own:
finished rows are harvested between chunks of ``chunk_steps`` decode steps
and their slots refilled with new requests mid-flight, so a batch's cost
tracks the mean answer length instead of the longest.

The decode state is a dict of fixed-shape [B, ...] tensors (per-row step
indices, KV caches, memories, copy operands: ``models/multimem.py``
``chunk_init``/``chunk_step``, or ``models/predict.py``'s encode and
decoder state); a refill is a row scatter of a freshly
encoded state of ``refill`` rows into the live one. The decode math is
row-independent (a sampled row draws from its own key), so a request's
answer is the one-shot ``predict``'s whatever the batch it rides in (bit
for bit in f32 on the CPU; on a card the encode at another batch width may
take other GEMM algorithms).

Unlike the JAX package's functional state, the KV caches are updated in
place on one CUDA stream; what a harvest reads (``done``, ``out``,
``trow``) goes to the host through ``HostCopy``, a non-blocking copy into
pinned memory enqueued before the next chunk.

The device loop (``device_loop``) takes the host out of the chunk loop:
the live state, a ring of encoded requests and a harvest log are static
buffers on the card, and one ``mega_fn`` call runs K chunks with the card
itself harvesting finished rows into the log and refilling free rows from
the ring between them. On the card each mega is captured once per lane
shape as a CUDA graph (``runtime/graphs.CapturedGraph``: warmed up on a
side stream, then captured on a private memory pool; a failed capture
raises) and replayed, so a mega costs the host one replay, a ``fill_`` of
the ring's row count and one harvest copy, however many steps it runs.
The host tops up the ring with encoded buckets while a mega runs. Where
the JAX module's loop exits early, the graph runs all K chunks; the idle
ones change no result (see ``device_loop``).

Over a device group of M devices (a replica of ``runtime/replicas.
Replicas``) the model is ``models/case.PooledCaSE``: every encode (a cold
start or a refill bucket) splits each row's passage pool M ways over the
group, and the decode state it returns, and so every chunk, refill and
harvest, lives on the group's first device. The loops need nothing of
their own for it.

Layout: ``base`` (program builders, ``refill_rows``, the decode-state tree
walk, host copies both ways, request sources, the lazy rank handle),
``single`` (the one-lane driver ``run_continuous``), ``multi`` (``Lane``
and the per-pool-bucket driver ``run_continuous_multi``), ``device_loop``
(``make_device_loop_fns``, ``run_continuous_device``, ``DeviceLane`` and
``run_continuous_device_multi``).
"""

from .base import (HostCopy, IterSource, QueueSource, _LazyRank,
                   make_continuous_fns, refill_rows)
from .device_loop import (DeviceLane, DeviceLoopFns, make_device_loop_fns,
                          run_continuous_device, run_continuous_device_multi)
from .multi import Lane, run_continuous_multi
from .single import run_continuous

__all__ = [
    "DeviceLane", "DeviceLoopFns", "HostCopy", "IterSource", "QueueSource",
    "Lane", "make_continuous_fns", "make_device_loop_fns", "refill_rows",
    "run_continuous", "run_continuous_device", "run_continuous_device_multi",
    "run_continuous_multi",
]
