"""Single-lane continuous-batching driver, ``run_continuous`` (port of
``case_rg_tpu/runtime/continuous/single.py``). See the package docstring
for the design; the program builders and request sources live in ``base``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from .base import HostCopy, IterSource, _LazyRank


def run_continuous(source,
                   make_batch: Callable[[List[dict], int], Optional[dict]],
                   init_fn, chunk_fn, refill_fn,
                   batch_size: int, refill: int,
                   emit: Callable[[dict, np.ndarray, np.ndarray], None],
                   ordered: bool = True,
                   on_chunk: Optional[Callable[[int], None]] = None,
                   lookahead: bool = False,
                   stream_cb: Optional[Callable] = None,
                   refill_min: int = 1,
                   async_harvest: bool = False) -> Dict[str, int]:
    """Drive the continuous decode loop over a request source.

    ``source`` is an ``IterSource``/``QueueSource`` (a plain iterator is
    wrapped). ``make_batch(chunk, bs)`` featurizes up to ``bs`` requests
    into a fixed-``bs`` batch (padding rows repeat); returning None drops
    that chunk (the caller already reported the failure). ``emit(req,
    ids_row, rank_row)`` receives finished requests (host arrays): in
    arrival order when ``ordered``, on completion otherwise.
    ``on_chunk(chunks_so_far)`` is called after every chunk. Returns
    counters (requests served, chunks run, refills).

    ``lookahead=True`` keeps one chunk dispatched ahead: the host copy of
    a chunk's flags is enqueued before the next chunk, so the harvest's
    wait overlaps the next chunk's compute; refills land one chunk later.

    ``stream_cb(host, slots)`` is called after every chunk, before the
    harvest, with ``host`` = {"out": [B, max_len], "trow": [B]} host arrays
    (fetched with ``done`` in one copy); ``slots[r]`` is ``(arrival_idx,
    request, rank)`` or None. A finished row's ``emit`` follows its last
    delta.

    ``refill_min`` coalesces refills: free rows accumulate until at least
    ``min(refill_min, refill)`` are free before a mid-flight refill runs
    (each refill pays a fixed-width encode however many rows it fills).
    Free rows are retired either way, so coalescing never deadlocks.

    ``async_harvest=True`` reads each chunk's flags one round later, from
    a host copy started when the chunk was dispatched, so no round waits
    for the device. Slots refilled since a copy was taken are skipped by
    snapshot identity. Round order: with ``lookahead``, the next chunk is
    dispatched before the harvest (refills land in the state dispatched
    ahead); without, the landed flags are read first, freed slots refilled
    into the current state, then the chunk is dispatched.

    Emitted answers are the same in every mode."""
    b = batch_size
    refill = max(1, min(refill, b))
    refill_min = max(1, min(refill_min, refill))
    if not hasattr(source, "take"):
        source = IterSource(source)

    # arrival-order reorder buffer (ordered mode)
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

    # slots[r] = (arrival_idx, request, (lazy rank, row)) or None (free)
    slots: List[Optional[tuple]] = [None] * b
    arrival = 0
    stats = {"served": 0, "chunks": 0, "refills": 0}
    state = None     # the state whose flags the next harvest reads
    pending = None   # lookahead: one chunk already dispatched from `state`
    inflight = None  # async_harvest: (host copy, slots snapshot)

    def flags(st) -> HostCopy:
        """Start the host copy of what a harvest reads."""
        return HostCopy([st["done"], st["out"]]
                        + ([st["trow"]] if stream_cb is not None else []))

    def harvest(copy: HostCopy, live: List[Optional[tuple]]) -> None:
        got = copy.get()
        done, out = got[0], got[1]
        if stream_cb is not None:
            stream_cb({"out": out, "trow": got[2]}, live)
        for r in range(b):
            if live[r] is not None and done[r]:
                idx, req, rk = slots[r]
                finish(idx, req, out[r],
                       None if rk is None else rk[0].row(rk[1]))
                slots[r] = None
                stats["served"] += 1

    def fill(rows: List[int], wait: bool) -> bool:
        """Take up to ``refill`` (or b, at cold start) requests and scatter
        them into ``rows``; True if any were added. With lookahead the
        scatter targets the already dispatched ``pending`` state."""
        nonlocal state, pending, arrival
        width = b if state is None else refill
        newreqs = source.take(min(len(rows), width), wait)
        if not newreqs:
            return False
        k = len(newreqs)
        batch = make_batch(newreqs, width)
        if batch is None:   # featurize failure: the caller reported it
            return False
        if state is None:
            state, rank = init_fn(batch)
            pending = None
        else:
            new_state, rank = init_fn(batch)
            idx = np.asarray(rows[:k] + [b] * (width - k), np.int64)
            if lookahead and pending is not None:
                pending = refill_fn(pending, new_state, idx)
            else:
                state = refill_fn(state, new_state, idx)
            stats["refills"] += 1
        lazy = None if rank is None else _LazyRank(rank)
        for i, req in enumerate(newreqs):
            slots[rows[i]] = (arrival, req, None if lazy is None else (lazy, i))
            arrival += 1
        return True

    if async_harvest and not lookahead:
        # harvest-first: read last round's landed copy, refill the freed
        # slots into the current state, dispatch, start the next copy
        while True:
            if inflight is not None:
                copy, snap = inflight
                inflight = None
                harvest(copy, [snap[r] if (snap[r] is not None
                                           and snap[r] is slots[r]) else None
                               for r in range(b)])
            if not any(s is not None for s in slots):
                if source.finished():
                    break
                if not fill(list(range(b)), wait=True):
                    continue   # the stream may have ended; the loop checks
            else:
                free = [r for r in range(b) if slots[r] is None]
                if len(free) >= refill_min and not source.finished():
                    fill(free, wait=False)
            state = chunk_fn(state)
            stats["chunks"] += 1
            if on_chunk is not None:
                on_chunk(stats["chunks"])
            inflight = (flags(state), list(slots))
        return stats

    while True:
        if not any(s is not None for s in slots):
            if source.finished():
                break
            if not fill(list(range(b)), wait=True):
                continue   # the stream may have ended; the loop checks
        if lookahead:
            cur = pending if pending is not None else chunk_fn(state)
            copy = flags(cur)              # enqueued before the next chunk
            pending = chunk_fn(cur)        # computes while we harvest
            state = cur
        else:
            state = chunk_fn(state)
            copy = flags(state)
        stats["chunks"] += 1
        if on_chunk is not None:
            on_chunk(stats["chunks"])
        if async_harvest:
            # dispatch-first: harvest the previous round's landed copy
            ready, inflight = inflight, (copy, list(slots))
            if ready is None:
                continue   # first round: nothing landed yet
            copy, snap = ready
            harvest(copy, [snap[r] if (snap[r] is not None
                                       and snap[r] is slots[r]) else None
                           for r in range(b)])
        else:
            harvest(copy, list(slots))
        free = [r for r in range(b) if slots[r] is None]
        if len(free) >= refill_min and not source.finished():
            fill(free, wait=False)
    return stats
