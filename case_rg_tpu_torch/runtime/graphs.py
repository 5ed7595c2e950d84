"""CUDA graphs for the port's decode loops: a body of plain tensor code,
captured once and replayed (``runtime/continuous/device_loop`` captures one
mega of K chunks per lane shape).

``CapturedGraph(body, warmup)``:

* warms up on a side stream first, twice: once for the work a first call
  does (nvcc builds, ``allow_smem``'s first ``cudaFuncSetAttribute``,
  ``stack_step_plan``'s ``cudaOccupancyMaxActiveClusters``,
  ``MultiMemoryDecoder._folded``'s fold), then again. Neither runs under
  ``device.no_host_sync``: that mode is process-wide, and another thread
  that blocks on the card while it holds would raise. The capture in
  "thread_local" mode refuses a body that synchronises, as a failed
  capture; the tests and chip_smoke.py run whole rounds under
  ``no_host_sync`` to name the operation;
* captures ``body`` with ``torch.cuda.graph`` on a private memory pool of
  its own, in ``capture_error_mode="thread_local"``: other threads may
  call CUDA while a capture is under way (``cli/serve_multi`` serves
  several backends in one process, each with its own serving thread, so
  one backend launches and reads results while another captures); their
  work goes to the default stream, which the capture's stream (a
  non-blocking one) does not wait on, and only the capturing thread is
  barred from unsafe calls;
* holds the process-wide ``CAPTURE_LOCK`` from the first warm-up to the
  end of the capture, so two backends, or two replicas of one backend
  (``runtime/replicas.py``: a card and a thread a replica), never warm up
  or capture at once. No capture changes the process-wide sync-debug
  mode, and the capture mode is the capturing thread's own, so a replica
  that captures leaves the others free to launch and read their results
  on their own streams;
* runs on ``device`` (default: the current card): its warm-up and
  capture streams, synchronisation and memory pool are that card's,
  whatever the calling thread's current device, and ``CUDAGraph.replay``
  makes the capture's card current itself;
* raises if the capture fails: there is no eager fallback;
* keeps ``stats``: warm-up and capture seconds, the pool's bytes (the
  growth of device memory reserved across the capture, the cache emptied
  before it), the kernel launches recorded into the graph (the capturing
  thread's own launches, ``kernels/_build.thread_tally``: each wrapper
  counts a launch when it is recorded, not when it is replayed, so a
  run's launches are these times ``replays``, whatever other threads
  launch meanwhile) and the replay count. The pool's bytes also take in
  what other threads allocate on the card during the capture: with
  several backends, read them from a capture made alone (``--warmup``
  captures before a backend takes requests).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict

import torch

from ..kernels import (_build, additive_attention, copy_argmax,
                       decode_attention, decoder_stack, encoder_attention)


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

    def __init__(self, body: Callable[[], None], warmup: Callable[[], None],
                 device=None):
        if not torch.cuda.is_available():
            raise RuntimeError("CapturedGraph: torch sees no CUDA device")
        self.device = torch.device("cuda", torch.cuda.current_device()) \
            if device is None else torch.device(device)
        with CAPTURE_LOCK, torch.cuda.device(self.device):
            self._capture(body, warmup)

    def _capture(self, body, warmup) -> None:
        t0 = time.perf_counter()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            warmup()
            warmup()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize(self.device)
        # the warm-up's cached blocks go now (the capture's entry would free
        # them anyway), so the reserve grows by the graph's pool alone
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        before = _build.thread_tally()
        reserved = torch.cuda.memory_reserved(self.device)
        self.graph = torch.cuda.CUDAGraph()
        # a capture stream of this card: torch.cuda.graph's default one is
        # made once a process, on the card current at its first capture
        with torch.cuda.graph(self.graph, stream=torch.cuda.Stream(),
                              capture_error_mode="thread_local"):
            body()
        after = _build.thread_tally()
        self.stats = {
            "warmup_s": t1 - t0, "capture_s": time.perf_counter() - t1,
            "pool_bytes": torch.cuda.memory_reserved(self.device) - reserved,
            "launches": {k: after.get(k, 0) - before.get(k, 0)
                         for k in launch_counts()},
            "replays": 0}

    def replay(self) -> None:
        self.graph.replay()          # on its card: CUDAGraph guards it
        self.stats["replays"] += 1
