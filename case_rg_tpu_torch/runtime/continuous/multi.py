"""Multi-lane continuous serving: one continuous-decode lane per pool
bucket (port of ``case_rg_tpu/runtime/continuous/multi.py``). See the
package docstring for the design.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from .base import HostCopy, IterSource, _LazyRank


class Lane:
    """One continuous-decode lane: its own (init, chunk, refill) functions
    and a fixed-width slot table. Multi-lane serving runs one lane per pool
    bucket: requests with small retrieval pools decode against a compact
    memory while still refilling mid-flight."""

    def __init__(self, key, make_batch, init_fn, chunk_fn, refill_fn,
                 batch_size: int, refill: int, refill_min: int = 1):
        self.key = key
        self.make_batch = make_batch
        self.init_fn = init_fn
        self.chunk_fn = chunk_fn
        self.refill_fn = refill_fn
        self.b = batch_size
        self.refill = max(1, min(refill, batch_size))
        self.refill_min = max(1, min(refill_min, self.refill))
        self.state = None
        self.slots: List[Optional[tuple]] = [None] * batch_size
        self.queue: List[tuple] = []   # routed (arrival_idx, req) FIFO
        self.inflight = None  # async_harvest: (host copy, slots snapshot)

    def occupied(self) -> bool:
        return any(s is not None for s in self.slots)

    def free_rows(self) -> List[int]:
        return [r for r in range(self.b) if self.slots[r] is None]

    def fill(self, stats) -> None:
        """Move queued requests into free rows (cold init or row refill).
        Mid-flight refills coalesce to ``refill_min`` free rows (see
        ``run_continuous``); a lane with no live rows always fills."""
        free = self.free_rows()
        if not free or not self.queue:
            return
        if (self.state is not None and self.occupied()
                and len(free) < self.refill_min):
            return
        width = self.b if self.state is None else self.refill
        take = self.queue[: min(len(free), width)]
        del self.queue[: len(take)]
        batch = self.make_batch([req for _, req in take], width)
        if batch is None:   # featurize failure: the caller reported it
            return
        k = len(take)
        if self.state is None:
            self.state, rank = self.init_fn(batch)
        else:
            new_state, rank = self.init_fn(batch)
            idx = np.asarray(free[:k] + [self.b] * (width - k), np.int64)
            self.state = self.refill_fn(self.state, new_state, idx)
            stats["refills"] += 1
        lazy = None if rank is None else _LazyRank(rank)
        for i, (aidx, req) in enumerate(take):
            self.slots[free[i]] = (aidx, req,
                                   None if lazy is None else (lazy, i))


def run_continuous_multi(source, lanes: List[Lane], route,
                         emit: Callable[[dict, np.ndarray, np.ndarray], None],
                         ordered: bool = True,
                         on_chunk: Optional[Callable[[int], None]] = None,
                         stream_cb: Optional[Callable] = None,
                         async_harvest: bool = False) -> Dict[str, int]:
    """Drive several continuous lanes over one request source.

    ``route(req) -> Lane`` picks a lane per request (e.g. the smallest pool
    bucket that fits). Per round, every occupied lane's chunk is dispatched,
    each followed by the host copy of its flags, before any lane's flags are
    read, so one lane's harvest overlaps the other lanes' compute. Emission
    order and semantics match ``run_continuous`` (a global arrival-order
    reorder buffer when ``ordered``).

    ``async_harvest=True``: each lane's flags are read at the top of the
    next round, from the copy started at its dispatch, before that round's
    fill and dispatch; refilled slots are skipped by snapshot identity.
    Emitted answers are the same."""
    if not hasattr(source, "take"):
        source = IterSource(source)
    next_emit = 0
    held: Dict[int, tuple] = {}

    def finish(idx: int, req: dict, ids: np.ndarray, rank):
        nonlocal next_emit
        if not ordered:
            emit(req, ids, rank)
            return
        held[idx] = (req, ids, rank)
        while next_emit in held:
            r, i, k = held.pop(next_emit)
            emit(r, i, k)
            next_emit += 1

    arrival = 0
    stats = {"served": 0, "chunks": 0, "refills": 0}

    def pump(wait: bool) -> None:
        """Route newly arrived requests onto lane queues."""
        nonlocal arrival
        room = sum(len(lane.free_rows()) + lane.b for lane in lanes)
        for req in source.take(room, wait):
            lane = route(req)
            lane.queue.append((arrival, req))
            arrival += 1

    def harvest(lane: Lane, copy: HostCopy, live) -> None:
        got = copy.get()
        done, out = got[0], got[1]
        if stream_cb is not None:
            stream_cb({"out": out, "trow": got[2]}, live)
        for r in range(lane.b):
            if live[r] is not None and done[r]:
                aidx, req, rk = lane.slots[r]
                finish(aidx, req, out[r],
                       None if rk is None else rk[0].row(rk[1]))
                lane.slots[r] = None
                stats["served"] += 1

    while True:
        if async_harvest:
            for lane in lanes:
                if lane.inflight is not None:
                    copy, snap = lane.inflight
                    lane.inflight = None
                    harvest(lane, copy,
                            [snap[r] if (snap[r] is not None
                                         and snap[r] is lane.slots[r])
                             else None for r in range(lane.b)])
        busy = [ln for ln in lanes if ln.occupied()]
        queued = any(ln.queue for ln in lanes)
        if not busy and not queued:
            if source.finished():
                break
            pump(wait=True)
            queued = any(ln.queue for ln in lanes)
            if not queued and source.finished():
                break
        for lane in lanes:
            lane.fill(stats)
        active = [ln for ln in lanes if ln.occupied()]
        copies = []
        for lane in active:
            lane.state = lane.chunk_fn(lane.state)
            stats["chunks"] += 1
            st = lane.state
            copies.append(HostCopy(
                [st["done"], st["out"]]
                + ([st["trow"]] if stream_cb is not None else [])))
        if on_chunk is not None:
            on_chunk(stats["chunks"])
        for lane, copy in zip(active, copies):
            if async_harvest:
                lane.inflight = (copy, list(lane.slots))
            else:
                harvest(lane, copy, list(lane.slots))
        if not source.finished():
            pump(wait=False)
    return stats
