"""Device-resident continuous batching (port of
``case_rg_tpu/runtime/continuous/device_loop.py``): K chunks per dispatch,
with the card itself harvesting finished rows and refilling free ones
between chunks from an on-card ring of encoded requests. On the card each
such mega of K chunks is one replay of a CUDA graph.

The chunk loop (``single.run_continuous``) issues every decode step of
every chunk from Python and reads ``done`` and ``out`` back once a chunk.
Here, per lane shape, the port keeps static buffers:

* the live decode state (every leaf [B+1, ...]; the model runs on the
  [:B] views), with ``uid`` (the request a row holds, -1 for none),
  ``alive`` (a live, unharvested request) and ``cursor`` (ring rows
  consumed);
* the ring of encoded requests (every leaf [S, ...], ``uid`` [S]) that the
  host tops up with ``push_fn`` (a row scatter) while the card decodes,
  and ``written``, the count of rows ever pushed;
* the harvest log: ``uid`` [E+1], ``out`` [E+1, L], ``trow`` [E+1],
  ``count`` and ``chunks``, with E = B + S.

``mega_fn`` runs K chunks of ``chunk_steps`` steps. Before each chunk, and
once after the last, a boundary appends newly done live rows to the log
(uid, out, trow) and refills the first R free rows from the ring, R =
``refill_bound`` (default ``min(B, S)``). The host replays the log to emit
finished requests by uid (ranks were copied at encode time, as in the
chunk loop) and pays one round trip per mega instead of one per chunk.
Answers are the one-shot predict's, for the same reasons as the chunk
loop's (row-independent decode math; tests/test_torch_device_loop.py).

What does not carry over from the JAX module, and what the port does:

* ``jax.lax.while_loop``'s early exit. A CUDA graph holds no loop on a
  device value, so every mega runs all K chunks. A chunk whose loop
  condition (a row alive, or the ring not dry) fails changes no result: its
  boundary harvests and refills nothing, and its decode moves only rows no
  live request owns, every leaf of which a later refill overwrites (caches
  and ``hist`` included). Within a mega ``alive`` comes back only through
  the ring, so the condition, once false, stays false: the card counts the
  chunks where it held into the log's ``chunks``, and the ``chunks`` stat
  (and the occupancy read from it) equals the JAX package's. The cost: up
  to K-1 idle chunks at the tail of a stream.
* ``jnp.nonzero(..., size=)`` and ``.at[].set(mode="drop")``.
  ``torch.nonzero`` waits for the card and torch has no drop mode. A
  boundary compacts by a ``cumsum`` over the flags (log slots in row order,
  as in JAX) and scatters with ``index_copy_``; an entry that JAX drops
  goes to a dump row (row B of the live state and of ``uid``/``alive``,
  row E of the log), the only row that ever receives duplicate indices and
  one nothing reads. The ring is only read inside a mega, so it needs no
  dump row: ``push_fn`` drops padding rows (row S, as in JAX) on the host.
  The refill stays JAX's R-row gather from the ring, not a B-row ``where``
  over it (a state row is about 2 MB at the bench shapes).
* ``jax.lax.cond`` around the refill. The port has JAX's
  ``refill_cond=False`` path only, the unconditional drop-mode refill,
  which a graph can hold (tests/test_device_loop.py holds the two equal),
  and so no ``refill_cond`` argument.
* Donation. The buffers above are static: the graph reads and writes them
  in place. ``chunk_step`` returns fresh ``prev``, ``trow``, ``done`` and
  ``out``; the body copies them back, so the next replay chains.
  ``wrap_fn`` and ``stage_fn`` copy a bucket into the lane's buffers and do
  not rebind them. ``written`` is a device scalar set before each replay
  by ``fill_`` (a launch with the value as its argument: no copy, no
  wait). The harvest's tensors are the static buffers themselves: the
  driver copies them to the host (``HostCopy``) right after the replay and
  before the next, which is what lets ``lookahead`` read one mega's log
  while the next overwrites it.
* Weights after capture. The graph reads the parameters, and the folded
  stack weights ``MultiMemoryDecoder._folded`` cached, where they lay when
  it was captured. Before each replay ``mega_fn`` compares every
  parameter's and buffer's ``(data_ptr, _version)`` (host reads) with the
  capture's; if one differs it captures again.

Buffers, and on the card the graph, are kept per lane shape (the row
shapes of the decode state) on the ``DeviceLoopFns``, as the JAX package's
jit keeps one executable per shape: runs that reuse a ``DeviceLoopFns``
reuse them, so they must not interleave on one shape (the lanes of
``run_continuous_device_multi`` have distinct pool buckets).
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ...decode.loops import validate_controls
from ...device import batch_to_device, resolve_device
from ..graphs import CapturedGraph
from .base import (HostCopy, IterSource, _LazyRank, host_to_device, leaves,
                   refill_rows, tree_map)

_HARVEST = ("uid", "out", "trow", "count", "chunks", "cursor")
_LIVE = ("live_uid", "live_alive", "live_out", "live_trow")


def _shape_key(state) -> tuple:
    return tuple((tuple(x.shape[1:]), x.dtype) for x in leaves(state))


class _Lane:
    """The static buffers of one lane shape (see the module docstring), its
    captured graph and the parameter key it was captured under."""

    def __init__(self, state, b: int, s: int, max_len: int, rbound: int):
        dev = leaves(state)[0].device
        self.device, self.b, self.s, self.e = dev, b, s, b + s
        self.rbound = rbound

        def rows(n):       # a zero leaf of n rows shaped as the state's
            return lambda x: torch.zeros((n,) + x.shape[1:], dtype=x.dtype,
                                         device=dev)

        self.m = tree_map(rows(b + 1), state)
        self.uid = torch.full((b + 1,), -1, dtype=torch.long, device=dev)
        self.alive = torch.zeros(b + 1, dtype=torch.bool, device=dev)
        self.cursor = torch.zeros((), dtype=torch.long, device=dev)
        self.written = torch.zeros((), dtype=torch.long, device=dev)
        self.ring = {"m": tree_map(rows(s), state),
                     "uid": torch.full((s,), -1, dtype=torch.long,
                                       device=dev)}
        self.log = {"uid": torch.full((self.e + 1,), -1, dtype=torch.long,
                                      device=dev),
                    "out": torch.zeros(self.e + 1, max_len, dtype=torch.int32,
                                       device=dev),
                    "trow": torch.zeros(self.e + 1, dtype=torch.long,
                                        device=dev),
                    "count": torch.zeros((), dtype=torch.long, device=dev),
                    "chunks": torch.zeros((), dtype=torch.long, device=dev)}
        self.rows = torch.arange(b, device=dev)
        self.takes = torch.arange(rbound, device=dev)
        self.graph: Optional[CapturedGraph] = None
        self.key = None
        self._views()

    def _views(self) -> None:
        self.live = tree_map(lambda x: x[:self.b], self.m)
        self.m_leaves = leaves(self.m)
        self.ring_leaves = leaves(self.ring["m"])

    def scratch(self) -> "_Lane":
        """A copy whose live state, flags and log are clones (the ring,
        ``written`` and the constants are shared: a mega only reads them),
        for a warm-up whose results are thrown away."""
        c = object.__new__(_Lane)
        c.__dict__.update(self.__dict__)
        c.m = tree_map(torch.clone, self.m)
        c.uid, c.alive = self.uid.clone(), self.alive.clone()
        c.cursor = self.cursor.clone()
        c.log = {k: v.clone() for k, v in self.log.items()}
        c.graph = None
        c._views()
        return c

    def harvest(self) -> Dict[str, torch.Tensor]:
        e, b = self.e, self.b
        return {"uid": self.log["uid"][:e], "out": self.log["out"][:e],
                "trow": self.log["trow"][:e], "count": self.log["count"],
                "chunks": self.log["chunks"], "cursor": self.cursor,
                "live_uid": self.uid[:b], "live_alive": self.alive[:b],
                "live_out": self.live["out"], "live_trow": self.live["trow"]}


class DeviceLoopFns:
    """The device loop's programs and static configuration (see
    ``make_device_loop_fns``). ``captures`` holds the stats of every graph
    captured so far (``CapturedGraph.stats``; on the card only)."""

    def __init__(self, model, max_len: int, chunk_steps: int, n_chunks: int,
                 stage_rows: int, refill_bound: Optional[int], fast_argmax,
                 extra: dict, sampling: bool):
        self.model = model
        self.max_len = max_len
        self.chunk_steps = chunk_steps
        self.n_chunks = n_chunks
        self.stage_rows = stage_rows
        self.refill_bound = refill_bound
        self.captures: List[dict] = []
        self._fa = fast_argmax
        self._extra = extra
        self._sampling = sampling
        self._where = next(model.parameters()).device
        self._lanes: Dict[tuple, _Lane] = {}

    # ---- host-side programs ----

    def init_fn(self, batch):
        """(state, rank) of one encoded bucket (a cold-start batch, or a
        refill bucket for the ring)."""
        if self._sampling and batch.get("sample_key") is None:
            raise ValueError("decoding='sample' needs per-row 'sample_key' "
                             "keys in the batch")
        with torch.inference_mode():
            return self.model.decode_init(
                batch_to_device(batch, self._where), max_len=self.max_len,
                fast_argmax=self._fa)

    def _lane(self, state, b: Optional[int] = None) -> _Lane:
        key = _shape_key(state)
        lane = self._lanes.get(key)
        if lane is None or (b is not None and lane.b != b):
            if b is None:
                raise ValueError("stage_fn: no live state of this shape yet "
                                 "(wrap_fn comes first)")
            rbound = self.refill_bound or min(b, self.stage_rows)
            lane = _Lane(state, b, self.stage_rows, self.max_len, rbound)
            self._lanes[key] = lane
        return lane

    @torch.inference_mode()
    def wrap_fn(self, state, uid, alive) -> dict:
        """Copy a cold-start bucket (``state``, its rows' ``uid`` and
        ``alive`` host arrays) into its lane's live buffers and reset the
        lane's cursor. Returns the wrap: {"m", "uid", "alive", "cursor"}
        views of the buffers, and the lane."""
        b = leaves(state)[0].shape[0]
        lane = self._lane(state, b)
        tree_map(lambda d, x: d.copy_(x), lane.live, state)
        lane.uid[:b].copy_(host_to_device(np.asarray(uid, np.int64),
                                          lane.device))
        lane.alive[:b].copy_(host_to_device(np.asarray(alive, bool),
                                            lane.device))
        lane.uid[b:].fill_(-1)
        lane.alive[b:].fill_(False)
        lane.cursor.zero_()
        return {"m": lane.live, "uid": lane.uid[:b], "alive": lane.alive[:b],
                "cursor": lane.cursor, "lane": lane}

    def stage_fn(self, state, uid) -> dict:
        """The lane's ring, emptied (every uid -1) and seeded with the rows
        of ``state`` whose ``uid`` is not -1 at rows [0, r)."""
        lane = self._lane(state)
        uid = np.asarray(uid, np.int64)
        with torch.inference_mode():
            lane.ring["uid"].fill_(-1)
        stage = dict(lane.ring, lane=lane)
        rows = np.where(uid >= 0, np.arange(len(uid)), self.stage_rows)
        return self.push_fn(stage, {"m": state, "uid": uid}, rows)

    def push_fn(self, stage, bucket, rows) -> dict:
        """Scatter an encoded bucket ({"m": state, "uid": host array}) into
        ring ``rows``, in place (rows >= S, the padding of a part-filled
        bucket, are dropped on the host)."""
        dev = stage["lane"].device
        refill_rows({"m": stage["m"], "uid": stage["uid"]},
                    {"m": bucket["m"], "uid": host_to_device(
                        np.asarray(bucket["uid"], np.int64), dev)}, rows)
        return stage

    def mega_fn(self, wrap, stage, written: int):
        """Up to ``n_chunks`` chunks with harvest and refill between them
        (the module docstring). ``written`` is the host's count of rows ever
        pushed into the ring. Returns (wrap, harvest): the harvest's "uid"
        [E] (-1 on unused entries), "out" [E, L], "trow" [E], "count",
        "chunks" (chunks in which a row was alive or the ring not dry) and
        "cursor", and the live rows' "live_uid", "live_alive", "live_out",
        "live_trow" for streaming, are the lane's static buffers: copy them
        before the next ``mega_fn`` call."""
        lane = wrap["lane"]
        if stage["lane"] is not lane:
            raise ValueError("mega_fn: the ring belongs to another lane")
        with torch.inference_mode():
            lane.written.fill_(int(written))
            if lane.device.type == "cuda":
                self._graph(lane).replay()
            else:
                self._body(lane)
        return wrap, lane.harvest()

    def _graph(self, lane: _Lane) -> CapturedGraph:
        """The lane's graph, captured again if any parameter or buffer of
        the model moved or changed since it was captured."""
        key = tuple((t.data_ptr(), t._version) for t in itertools.chain(
            self.model.parameters(), self.model.buffers()))
        if lane.graph is None or lane.key != key:
            lane.graph = None       # its pool goes before the next one
            scratch = lane.scratch()
            lane.graph = CapturedGraph(lambda: self._body(lane),
                                       lambda: self._body(scratch))
            lane.key = key
            self.captures.append(lane.graph.stats)
        return lane.graph

    # ---- the mega: plain tensor code, no host reads ----

    def _body(self, lane: _Lane) -> None:
        log = lane.log
        log["uid"].fill_(-1)
        log["out"].zero_()
        log["trow"].zero_()
        log["count"].zero_()
        log["chunks"].zero_()
        live = lane.live
        running = torch.ones((), dtype=torch.bool, device=lane.device)
        for _ in range(self.n_chunks):
            running &= lane.alive[:lane.b].any() | (lane.cursor
                                                    < lane.written)
            log["chunks"] += running
            self._boundary(lane)
            new = self.model.decode_chunk(live, n_steps=self.chunk_steps,
                                          fast_argmax=self._fa, **self._extra)
            for k in ("prev", "trow", "done", "out"):
                live[k].copy_(new[k])
        self._boundary(lane)

    @staticmethod
    def _boundary(lane: _Lane) -> None:
        """Harvest newly done rows into the log, then refill the first R
        free rows from the ring (dropped entries go to the dump rows)."""
        b, e, r = lane.b, lane.e, lane.rbound
        log, live, alive = lane.log, lane.live, lane.alive[:lane.b]
        newly = live["done"] & alive
        slot = log["count"] + newly.cumsum(0) - 1
        hpos = torch.where(newly & (slot < e), slot, e)
        log["uid"].index_copy_(0, hpos, lane.uid[:b])
        log["out"].index_copy_(0, hpos, live["out"])
        log["trow"].index_copy_(0, hpos, live["trow"])
        log["count"] += newly.sum()
        alive &= ~newly
        free = ~alive
        rank = free.cumsum(0) - 1
        fslots = torch.full((r + 1,), b, dtype=torch.long, device=lane.device)
        fslots.index_copy_(0, torch.where(free & (rank < r), rank, r),
                           lane.rows)
        take = lane.cursor + lane.takes
        can = (fslots[:r] < b) & (take < lane.written)
        src = take % lane.s
        tgt = torch.where(can, fslots[:r], b)
        for d, x in zip(lane.m_leaves, lane.ring_leaves):
            d.index_copy_(0, tgt, x.index_select(0, src))
        lane.uid.index_copy_(0, tgt, lane.ring["uid"].index_select(0, src))
        lane.alive.index_fill_(0, tgt, True)
        lane.cursor += can.sum()


def make_device_loop_fns(model, max_len: int, chunk_steps: int,
                         n_chunks: int, stage_rows: int,
                         refill_bound: Optional[int] = None,
                         fast_argmax=None, decoding: str = "greedy",
                         temperature: float = 1.0, top_k: int = 0,
                         top_p: float = 1.0, device="cuda") -> DeviceLoopFns:
    """The device loop's programs for a model with ``decode_init`` and
    ``decode_chunk`` (CaSE), as a ``DeviceLoopFns``:

    * ``init_fn(batch)`` -> (state, rank): one encoded bucket;
    * ``wrap_fn(state, uid, alive)`` -> wrap: the bucket as the lane's live
      state;
    * ``stage_fn(state, uid)`` -> stage: the lane's ring, seeded with the
      bucket's rows;
    * ``push_fn(stage, bucket, rows)``: a freshly encoded bucket into ring
      rows (rows >= ``stage_rows`` dropped);
    * ``mega_fn(wrap, stage, written)`` -> (wrap, harvest): ``n_chunks``
      chunks of ``chunk_steps`` steps with harvest and refill between them,
      on the card one replay of a CUDA graph.

    ``refill_bound`` caps the refills of one boundary (default
    ``min(batch, stage_rows)``); free rows beyond it wait for the next
    boundary. ``fast_argmax``, ``decoding`` and the sampling controls are
    ``make_continuous_fns``'s. Raises without a card unless
    ``device="cpu"``, and for a model without a chunked decode."""
    if decoding not in ("greedy", "sample"):
        raise ValueError(f"unknown decoding {decoding!r}")
    sampling = decoding == "sample"
    if sampling:
        validate_controls(temperature, top_k, top_p)
    dev = resolve_device(device)
    where = next(model.parameters()).device
    if where.type != dev.type:
        raise ValueError(f"model lives on {where}, not on {dev}")
    if not hasattr(model, "decode_init"):
        raise ValueError(f"{type(model).__name__} has no chunked decode "
                         "(not ported yet)")
    if stage_rows < 1 or n_chunks < 1 or chunk_steps < 1:
        raise ValueError("stage_rows, n_chunks and chunk_steps must be >= 1")
    fa = False if sampling else fast_argmax
    extra = dict(sampling=True, temperature=temperature, top_k=top_k,
                 top_p=top_p) if sampling else {}
    return DeviceLoopFns(model, max_len, chunk_steps, n_chunks, stage_rows,
                         refill_bound, fa, extra, sampling)


def _empty_stage(fns: DeviceLoopFns, wrap) -> dict:
    """The lane's ring with nothing available (before any refill bucket;
    ``written`` stays 0, so the card never takes its rows)."""
    b = wrap["uid"].shape[0]
    return fns.stage_fn(wrap["m"], np.full((b,), -1, np.int64))


def _harvest_copy(harvest, stream: bool) -> HostCopy:
    """Start the host copy of what the driver reads of a mega's harvest."""
    return HostCopy([harvest[k] for k in _HARVEST + (_LIVE if stream
                                                     else ())])


def _ring_rows(written: int, uids: np.ndarray, s: int) -> np.ndarray:
    """Ring rows of a bucket's requests: the next ones after ``written``,
    wrapping at ``s``; padding rows go to ``s`` (dropped)."""
    return np.where(uids >= 0, (written + np.arange(len(uids))) % s, s)


def run_continuous_device(source,
                          make_batch: Callable[[List[dict], int],
                                               Optional[dict]],
                          fns: DeviceLoopFns, batch_size: int, refill: int,
                          emit: Callable[[dict, np.ndarray, np.ndarray],
                                         None],
                          max_len: int, ordered: bool = True,
                          on_mega: Optional[Callable[[int], None]] = None,
                          lookahead: bool = False,
                          stream_cb: Optional[Callable] = None
                          ) -> Dict[str, int]:
    """Drive the device loop over a request source.

    As ``single.run_continuous``: ``make_batch(reqs, width)`` featurizes up
    to ``width`` requests into a fixed-width batch (None drops them: the
    caller reported the failure), ``emit(req, ids_row, rank_row)`` receives
    finished requests (in arrival order when ``ordered``). Per round the
    host (1) tops up the ring with freshly encoded ``refill``-row buckets,
    which queue behind the mega in flight, (2) dispatches the next mega,
    (3) reads the harvest log and emits. Returns {"served", "megas",
    "refills", "steps_served", "chunks"}; "chunks" counts the chunks in
    which a row was alive or the ring not dry (the JAX loop's chunks).

    ``lookahead=True`` dispatches the next mega before reading the last
    one's log (detection of a finished request lags one mega; the round
    trip hides behind device work). ``stream_cb(host, slots)`` is called
    once per harvested mega with the live rows' prefixes, ``host`` = {"out":
    [B, L], "trow": [B]} and ``slots[r]`` = (arrival_idx, req, rank_ref) or
    None, as the chunk loops do, a mega apart."""
    b = batch_size
    s = fns.stage_rows
    # a refill bucket's width is bounded by the ring, not by the batch
    refill = max(1, min(refill, s))
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

    stats = {"served": 0, "megas": 0, "refills": 0, "steps_served": 0,
             "chunks": 0}
    byuid: Dict[int, tuple] = {}   # uid -> (arrival_idx, req, rank_ref)
    next_uid = 0
    written = 0        # rows ever pushed into the ring (host view)
    consumed = 0       # the cursor at the last harvest read (host view)
    stage = None
    wrap = None
    pending = None     # lookahead: the dispatched mega's harvest copy

    def encode(reqs, width):
        """Featurize and encode one bucket: (state, uids) or None. Rank
        copies start here, keyed by uid."""
        nonlocal next_uid
        batch = make_batch(reqs, width)
        if batch is None:
            return None
        state, rank = fns.init_fn(batch)
        lazy = None if rank is None else _LazyRank(rank)
        uids = np.full((width,), -1, np.int64)
        for i, req in enumerate(reqs):
            uids[i] = next_uid
            byuid[next_uid] = (next_uid, req,
                               None if lazy is None else (lazy, i))
            next_uid += 1
        return state, uids

    while True:
        if wrap is None:
            # cold start: one full-width bucket becomes the live state
            if source.finished() and not byuid:
                break
            reqs = source.take(b, wait=True)
            if not reqs:
                continue
            enc = encode(reqs, b)
            if enc is None:
                continue
            state, uids = enc
            wrap = fns.wrap_fn(state, uids, uids >= 0)
        # top up the ring; with nothing in flight and the ring drained,
        # block for the next request instead of running empty megas
        while (written - consumed) + refill <= s and not source.finished():
            idle = not byuid and written == consumed
            reqs = source.take(refill, wait=idle)
            if not reqs:
                break
            enc = encode(reqs, refill)
            if enc is None:
                continue
            state, uids = enc
            k = int((uids >= 0).sum())
            if stage is None and written == 0 and k == refill:
                stage = fns.stage_fn(state, uids)
            else:
                if stage is None:
                    stage = _empty_stage(fns, wrap)
                stage = fns.push_fn(stage, {"m": state, "uid": uids},
                                    _ring_rows(written, uids, s))
            written += k
            stats["refills"] += 1
        if stage is None:
            stage = _empty_stage(fns, wrap)
        wrap, harvest = fns.mega_fn(wrap, stage, written)
        copy = _harvest_copy(harvest, stream_cb is not None)
        stats["megas"] += 1
        if on_mega is not None:
            on_mega(stats["megas"])
        if lookahead:
            copy, pending = pending, copy
            if copy is None:
                continue
        got = copy.get()
        h_uid, h_out, h_trow, h_count, h_chunks, consumed = got[:6]
        consumed = int(consumed)
        stats["chunks"] += int(h_chunks)
        if stream_cb is not None:
            l_uid, l_alive, l_out, l_trow = got[6:]
            slots = [byuid.get(int(l_uid[r])) if l_alive[r] else None
                     for r in range(l_uid.shape[0])]
            stream_cb({"out": l_out, "trow": l_trow}, slots)
        for i in range(int(h_count)):
            arrival, req, rk = byuid.pop(int(h_uid[i]))
            finish(arrival, req, h_out[i],
                   None if rk is None else rk[0].row(rk[1]))
            stats["served"] += 1
            stats["steps_served"] += int(h_trow[i]) + 1
        if source.finished() and not byuid and written == consumed:
            break
    return stats


class DeviceLane:
    """One device-loop lane for one static pool bucket: its own live state
    and ring (buffers and graph kept by ``fns`` per lane shape, so lanes of
    distinct buckets may share one ``DeviceLoopFns``), as the chunk loop's
    ``Lane``."""

    def __init__(self, key, make_batch, fns: DeviceLoopFns, batch_size: int,
                 refill: int):
        self.key = key
        self.make_batch = make_batch
        self.fns = fns
        self.b = batch_size
        self.s = fns.stage_rows
        self.refill = max(1, min(refill, self.s))   # ring-bounded
        self.queue: List[tuple] = []   # routed (arrival_idx, req) FIFO
        self.wrap = None
        self.stage = None
        self.written = 0       # ring rows ever pushed (host view)
        self.consumed = 0      # the cursor at the last harvest read
        self.inflight = 0      # uids encoded, not yet harvested
        self.pending = None    # lookahead: the dispatched mega's copy


def run_continuous_device_multi(source, lanes: List[DeviceLane], route,
                                emit: Callable[[dict, np.ndarray,
                                                np.ndarray], None],
                                max_len: int, ordered: bool = True,
                                on_mega: Optional[Callable[[int],
                                                           None]] = None,
                                lookahead: bool = False,
                                stream_cb: Optional[Callable] = None
                                ) -> Dict[str, int]:
    """One device loop per pool bucket over one source (the scheduler of
    ``multi.run_continuous_multi``): per round every active lane's mega is
    dispatched before any lane's log is read, so one lane's round trip
    overlaps the others' device work. ``route(req) -> DeviceLane`` picks a
    lane per request (the smallest pool bucket that fits). Emission is in
    global arrival order when ``ordered``; a request's answer is the
    single-lane loop's at its bucket. ``lookahead`` and ``stream_cb`` as in
    ``run_continuous_device``, per lane."""
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

    stats = {"served": 0, "megas": 0, "refills": 0, "steps_served": 0,
             "chunks": 0}
    byuid: Dict[int, tuple] = {}   # uid -> (arrival_idx, req, rank_ref)
    next_uid = 0
    arrival = 0

    def pump(wait: bool) -> None:
        """Route arrivals onto lane queues, bounded by each lane's live
        rows and ring room not yet queued (backpressure on the source)."""
        nonlocal arrival
        room = sum(max(0, lane.b + lane.s - len(lane.queue))
                   for lane in lanes)
        for req in source.take(max(room, 1) if wait else room, wait):
            lane = route(req)
            lane.queue.append((arrival, req))
            arrival += 1

    def encode(lane: DeviceLane, entries, width):
        nonlocal next_uid
        batch = lane.make_batch([req for _, req in entries], width)
        if batch is None:   # featurize failure: the caller reported it
            return None
        state, rank = lane.fns.init_fn(batch)
        lazy = None if rank is None else _LazyRank(rank)
        uids = np.full((width,), -1, np.int64)
        for i, (aidx, req) in enumerate(entries):
            uids[i] = next_uid
            byuid[next_uid] = (aidx, req,
                               None if lazy is None else (lazy, i))
            next_uid += 1
            lane.inflight += 1
        return state, uids

    def topup(lane: DeviceLane) -> None:
        if lane.wrap is None and lane.queue:
            take = lane.queue[: lane.b]
            del lane.queue[: len(take)]
            enc = encode(lane, take, lane.b)
            if enc is None:
                return
            state, uids = enc
            lane.wrap = lane.fns.wrap_fn(state, uids, uids >= 0)
        while (lane.wrap is not None and lane.queue
               and (lane.written - lane.consumed) + lane.refill <= lane.s):
            take = lane.queue[: lane.refill]
            del lane.queue[: len(take)]
            enc = encode(lane, take, lane.refill)
            if enc is None:
                continue
            state, uids = enc
            if lane.stage is None:
                lane.stage = _empty_stage(lane.fns, lane.wrap)
            lane.stage = lane.fns.push_fn(
                lane.stage, {"m": state, "uid": uids},
                _ring_rows(lane.written, uids, lane.s))
            lane.written += int((uids >= 0).sum())
            stats["refills"] += 1

    def process(lane: DeviceLane, copy: HostCopy) -> None:
        got = copy.get()
        h_uid, h_out, h_trow, h_count, h_chunks, cur = got[:6]
        lane.consumed = int(cur)
        stats["chunks"] += int(h_chunks)
        if stream_cb is not None:
            l_uid, l_alive, l_out, l_trow = got[6:]
            slots = [byuid.get(int(l_uid[r])) if l_alive[r] else None
                     for r in range(l_uid.shape[0])]
            stream_cb({"out": l_out, "trow": l_trow}, slots)
        for i in range(int(h_count)):
            aidx, req, rk = byuid.pop(int(h_uid[i]))
            finish(aidx, req, h_out[i],
                   None if rk is None else rk[0].row(rk[1]))
            lane.inflight -= 1
            stats["served"] += 1
            stats["steps_served"] += int(h_trow[i]) + 1

    while True:
        pump(wait=False)
        if not any(ln.inflight > 0 or ln.queue for ln in lanes):
            if source.finished():
                break
            pump(wait=True)
            if (not any(ln.queue for ln in lanes)) and source.finished():
                break
        for lane in lanes:
            topup(lane)
        dispatched = []
        for lane in lanes:
            if lane.wrap is None or lane.inflight <= 0:
                continue
            if lane.stage is None:
                lane.stage = _empty_stage(lane.fns, lane.wrap)
            lane.wrap, harvest = lane.fns.mega_fn(lane.wrap, lane.stage,
                                                  lane.written)
            stats["megas"] += 1
            dispatched.append((lane, _harvest_copy(harvest,
                                                   stream_cb is not None)))
        if on_mega is not None and dispatched:
            on_mega(stats["megas"])
        for lane, copy in dispatched:
            if lookahead:
                copy, lane.pending = lane.pending, copy
                if copy is None:
                    continue
            process(lane, copy)
    return stats
