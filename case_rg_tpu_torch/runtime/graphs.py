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
  its own, in ``capture_error_mode="thread_local"``: other threads may
  call CUDA while a capture is under way (``cli/serve_multi`` serves
  several backends in one process, each with its own serving thread, so
  one backend launches and reads results while another captures); their
  work goes to the default stream, which the capture's stream (a
  non-blocking one) does not wait on, and only the capturing thread is
  barred from unsafe calls;
* holds the process-wide ``CAPTURE_LOCK`` from the first warm-up to the
  end of the capture, so two backends never warm up or capture at once
  (the warm-up's ``no_host_sync`` sets a process-wide mode: while it
  holds, a thread that blocks on the card raises; serving threads read
  results through ``HostCopy``'s event, which it does not flag);
* raises if the capture fails: there is no eager fallback;
* keeps ``stats``: warm-up and capture seconds, the pool's bytes (the
  growth of device memory reserved across the capture, the cache emptied
  before it), the kernel launches recorded into
  the graph (each wrapper's ``LAUNCHES`` counts a launch when it is
  recorded, not when it is replayed: a run's launches are these times
  ``replays``) and the replay count. Both the pool's bytes and the
  launches also take in what other threads allocate and launch during
  the capture: with several backends, read them from a capture made
  alone (``--warmup`` captures before a backend takes requests).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict

import torch

from ..device import no_host_sync
from ..kernels import (additive_attention, copy_argmax, decode_attention,
                       decoder_stack, encoder_attention)


CAPTURE_LOCK = threading.Lock()


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
        with CAPTURE_LOCK:
            self._capture(body, warmup)

    def _capture(self, body, warmup) -> None:
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
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
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
