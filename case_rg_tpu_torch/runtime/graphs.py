"""CUDA graphs for the port's decode loops: a body of plain tensor code,
captured once and replayed (``runtime/continuous/device_loop`` captures one
mega of K chunks per lane shape).

``CapturedGraph(body, warmup)``:

* warms up on a side stream first, twice: once for the work a first call
  does (nvcc builds, ``allow_smem``'s first ``cudaFuncSetAttribute``,
  ``stack_step_plan``'s ``cudaOccupancyMaxActiveClusters``,
  ``MultiMemoryDecoder._folded``'s fold), then once under
  ``device.no_host_sync``, so a body that would make the host wait on the
  card raises here with the operation's name rather than as a failed
  capture;
* captures ``body`` with ``torch.cuda.graph`` on a private memory pool of
  its own, in PyTorch's default ``capture_error_mode="global"``: the thread
  that captures is the only one that calls CUDA (a ``QueueSource`` reader
  thread only puts requests on a queue), so the stricter mode costs nothing
  and would catch a stray call from another thread;
* raises if the capture fails: there is no eager fallback;
* keeps ``stats``: warm-up and capture seconds, the pool's bytes (the
  growth of device memory reserved across the capture, the cache emptied
  before it), the kernel launches recorded into
  the graph (each wrapper's ``LAUNCHES`` counts a launch when it is
  recorded, not when it is replayed: a run's launches are these times
  ``replays``) and the replay count.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import torch

from ..device import no_host_sync
from ..kernels import (additive_attention, copy_argmax, decode_attention,
                       decoder_stack, encoder_attention)


def launch_counts() -> Dict[str, int]:
    """The serving kernels' launch counters, by kernel name."""
    return {"fused_mha": encoder_attention.LAUNCHES,
            "stack_step": decoder_stack.LAUNCHES,
            "combine_copy_mass": copy_argmax.LAUNCHES,
            "single_query_mha": decode_attention.LAUNCHES,
            "additive_scores": additive_attention.LAUNCHES}


class CapturedGraph:
    """``body`` captured as a CUDA graph after ``warmup`` (a call of the
    same code on buffers whose contents may be thrown away) ran twice on a
    side stream. ``replay()`` launches it on the current stream."""

    def __init__(self, body: Callable[[], None], warmup: Callable[[], None]):
        if not torch.cuda.is_available():
            raise RuntimeError("CapturedGraph: torch sees no CUDA device")
        t0 = time.perf_counter()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            warmup()
            with no_host_sync():
                warmup()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        # the warm-up's cached blocks go now (the capture's entry would free
        # them anyway), so the reserve grows by the graph's pool alone
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        before, reserved = launch_counts(), torch.cuda.memory_reserved()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            body()
        after = launch_counts()
        self.stats = {
            "warmup_s": t1 - t0, "capture_s": time.perf_counter() - t1,
            "pool_bytes": torch.cuda.memory_reserved() - reserved,
            "launches": {k: after[k] - before[k] for k in after},
            "replays": 0}

    def replay(self) -> None:
        self.graph.replay()
        self.stats["replays"] += 1
