"""One replica of a model on each device of the process: the serving
mesh's data axis (port of ``replicated`` and ``shard_batch`` of
``case_rg_tpu/runtime/mesh.py``, over the device groups of ``local_groups``).

The JAX package replicates the parameters over the 'data' axis of
``local_mesh`` and shards each batch by rows; XLA runs each shard on its
device, and the outputs come back as one array in row order. The port does
the same by hand:

* ``Replicas(model, groups)`` copies the loaded, cast model to each
  device once (the first replica is ``model`` itself);
* ``split`` cuts a batch into d contiguous row blocks (the shards of
  ``shard_batch``), ``Pending.get`` puts the outputs back in row order;
* ``map(fn, items)`` runs ``fn(i, item)`` for every replica i in that
  replica's own host thread. The thread's current stream is a stream of
  its own on the replica's card, set once when the thread starts
  (``torch.nn.parallel.parallel_apply`` sets one per call); setting it
  makes that card the thread's current device, which torch's calls with
  no device argument use. The kernel wrappers do not rely on it: each
  launches on its input's card (``kernels/_build.on_input_card``). So a
  replica's kernels run on its card while the other replicas' host work
  runs, and two replicas on one card overlap on it. One replica runs
  inline in the caller's thread: a single device serves as before;
* ``run_continuous_replicated`` drives one continuous loop a replica over
  one request source.

The decode math is row-independent, so a replica's answers for its rows
are what one device gives for the same rows.

Over groups of M devices (``--pool_shard``) a replica is a group, the
JAX ``local_mesh``'s 'model' axis (``runtime/mesh.local_groups``): the
model is copied once to each other device of the group, and the
replica's model is the model over its group (``CaSEModel.over_pool`` ->
``models/case.PooledCaSE``), which splits each row's passage pool M ways
and decodes on the group's first device. One host thread drives a group;
its current stream is a stream of its own on each card of the group.
Models without a pool split refuse it (Masque and TMemNet name their
ROADMAP item).
"""

from __future__ import annotations

import copy
import itertools
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .continuous.base import HostCopy, IterSource, QueueSource


def _enter(group: Sequence[torch.device], threads: int) -> None:
    """A replica thread's start: a stream of its own on each card of its
    group (the first card's set last, so it is the thread's current
    device), and the creating thread's count of intra-op CPU threads (a
    new thread would otherwise take the host's default)."""
    torch.set_num_threads(threads)
    for dev in dict.fromkeys(reversed(group)):
        if dev.type == "cuda":
            torch.cuda.set_stream(torch.cuda.Stream(dev))


class Replicas:
    """``model`` (already loaded and cast, on the first group's first
    device) and a copy of it on each other device of ``groups``: a replica
    a group, each with a host thread. A group is a device (a replica of
    one device) or a list of devices (``runtime/mesh.local_groups``; the
    replica's model is then the model over its group, ``over_pool``).
    ``devices`` holds each replica's first device and ``models`` each
    replica's model."""

    def __init__(self, model: torch.nn.Module, groups: Sequence):
        self.groups = [[torch.device(d) for d in g]
                       if isinstance(g, (list, tuple)) else [torch.device(g)]
                       for g in groups]
        self.devices = [g[0] for g in self.groups]
        self.pool = max((len(g) for g in self.groups), default=1)
        where = next(model.parameters()).device
        if not self.devices or where != _canonical(self.devices[0]):
            raise ValueError(f"the model lives on {where}, not on the first "
                             f"replica's device {self.devices[:1]}")
        if self.pool > 1 and not hasattr(model, "over_pool"):
            raise ValueError(f"--pool_shard: {type(model).__name__} has no "
                             f"passage pool to split")
        # caches derived from the weights (MultiMemoryDecoder's folds) are
        # keyed by the weights' storage, so a copy folds its own again
        self._source, self._copies, self.models = model, [], []
        for group in self.groups:
            first = model if not self.models else self._copy(model,
                                                             group[0])
            on = {_canonical(group[0]): first}
            for d in group[1:]:
                if _canonical(d) not in on:
                    on[_canonical(d)] = self._copy(first, d)
            self.models.append(first if len(group) == 1 else first.over_pool(
                [on[_canonical(d)] for d in group], group))
        self._sync_cards()
        self._pools = None
        if len(self.devices) > 1:
            self._pools = [ThreadPoolExecutor(
                1, initializer=_enter, initargs=(g, torch.get_num_threads()))
                for g in self.groups]

    def _copy(self, model: torch.nn.Module, dev: torch.device):
        """A copy of ``model`` on ``dev``, kept for ``sync``."""
        self._copies.append(copy.deepcopy(model).to(dev))
        return self._copies[-1]

    def _sync_cards(self) -> None:
        """Wait for the copies, before other streams read them."""
        for d in {x for g in self.groups for x in g}:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    @torch.no_grad()
    def sync(self) -> None:
        """Copy the first replica's parameters and buffers (new weights
        loaded into it) into every copy: the other replicas' and the
        groups' shard models."""
        src = list(self._source.parameters()) + \
            list(self._source.buffers())
        for m in self._copies:
            dst = list(m.parameters()) + list(m.buffers())
            for a, b in zip(dst, src):
                a.copy_(b)
        self._sync_cards()

    def __len__(self) -> int:
        return len(self.devices)

    def split(self, batch: dict) -> List[dict]:
        """``batch``'s rows in ``len(self)`` contiguous blocks (every field
        cut along its first axis; the rows must divide evenly)."""
        d = len(self.devices)
        if d == 1:
            return [batch]
        rows = {int(v.shape[0]) for v in batch.values()}
        if len(rows) != 1 or next(iter(rows)) % d:
            raise ValueError(f"a batch of {sorted(rows)} rows does not split "
                             f"over {d} replicas")
        n = next(iter(rows)) // d
        return [{k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                for i in range(d)]

    def map(self, fn: Callable, items: Sequence) -> list:
        """[fn(i, items[i])], each call in replica i's thread (inline with
        one replica). Raises the first replica's error after all ended."""
        if self._pools is None:
            return [fn(0, items[0])]
        futs = [p.submit(fn, i, x)
                for i, (p, x) in enumerate(zip(self._pools, items))]
        return [f.result() for f in futs]

    def close(self) -> None:
        for p in self._pools or ():
            p.shutdown(wait=True)
        self._pools = None


def _canonical(dev: torch.device) -> torch.device:
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Pending:
    """A batch's outputs on their way to the host: a ``HostCopy`` a row
    block, started in the block's replica thread. ``get`` returns the
    blocks' numpy arrays concatenated in row order."""

    __slots__ = ("_keys", "_copies")

    def __init__(self, outs: List[Dict[str, torch.Tensor]]):
        self._keys = list(outs[0])
        self._copies = [HostCopy([o[k] for k in self._keys]) for o in outs]

    @classmethod
    def of_blocks(cls, copies: list) -> "Pending":
        self = cls.__new__(cls)
        self._keys = copies[0]._keys
        self._copies = [c for p in copies for c in p._copies]
        return self

    def get(self) -> Dict[str, np.ndarray]:
        got = [c.get() for c in self._copies]
        if len(got) == 1:
            return dict(zip(self._keys, got[0]))
        return {k: np.concatenate([g[j] for g in got])
                for j, k in enumerate(self._keys)}


def run_continuous_replicated(source, runs: Sequence[Callable], emit,
                              capacity: Sequence[int], ordered: bool = True,
                              replicas: Optional[Replicas] = None,
                              arrive: Optional[Callable[[dict], None]] = None
                              ) -> Dict[str, int]:
    """One continuous loop a replica over one request source.

    ``runs[i](source_i, emit_i)`` runs replica i's loop (``run_continuous``,
    ``run_continuous_device`` or a multi-lane driver, with ``ordered=False``)
    over ``source_i``, a ``QueueSource`` that this function feeds, and
    returns its stats; it runs in replica i's thread (``replicas.map``).
    The calling thread takes the arrivals from ``source`` and hands each to
    the replica with the fewest requests in hand (handed and not yet
    emitted), at most ``capacity[i]`` each (its rows and a refill), so a
    replica whose rows free up takes the next arrivals. ``arrive(req)`` is
    called for each request in arrival order, before any replica sees it.
    ``emit(req, ids_row, rank_row)`` gets every request, in arrival order
    when ``ordered``. Returns the replicas' stats summed."""
    d = len(runs)
    if not hasattr(source, "take"):
        source = IterSource(source)
    stop = object()
    queues = [queue.Queue() for _ in range(d)]
    cond = threading.Condition()
    held: Dict[int, tuple] = {}
    in_hand = [0] * d
    order: Dict[int, tuple] = {}        # id(req) -> (arrival, replica, req)
    state = {"next": 0, "failed": None}

    def emit_from(req, ids, rank):
        with cond:
            idx, i, _ = order.pop(id(req))
            in_hand[i] -= 1
            cond.notify_all()
            if not ordered:
                emit(req, ids, rank)
                return
            held[idx] = (req, ids, rank)
            while state["next"] in held:
                r, a, k = held.pop(state["next"])
                emit(r, a, k)
                state["next"] += 1

    def run_one(i, _):
        try:
            return runs[i](QueueSource(queues[i], stop), emit_from)
        except BaseException as e:
            with cond:
                state["failed"] = e
                cond.notify_all()
            raise

    arrival = itertools.count()

    def hand_out(reqs) -> None:
        for req in reqs:
            if arrive is not None:
                arrive(req)
            with cond:
                i = min(range(d), key=lambda j: in_hand[j] / capacity[j])
                in_hand[i] += 1
                order[id(req)] = (next(arrival), i, req)
            queues[i].put(req)

    # the first arrivals go out before the loops start, so each replica's
    # first (cold) batch takes as many rows as there are
    hand_out(source.take(sum(capacity), wait=True))
    pool = ThreadPoolExecutor(1)
    if replicas is not None:
        fut = pool.submit(replicas.map, run_one, [None] * d)
    else:
        fut = pool.submit(lambda: [run_one(i, None) for i in range(d)])
    try:
        while not source.finished():
            with cond:
                while state["failed"] is None and all(
                        in_hand[i] >= capacity[i] for i in range(d)):
                    cond.wait()
                if state["failed"] is not None:
                    break
                room = sum(max(capacity[i] - in_hand[i], 0)
                           for i in range(d))
            hand_out(source.take(room, wait=True))
    finally:
        for q in queues:
            q.put(stop)
        results = fut.result()
        pool.shutdown()
    total: Dict[str, int] = {}
    for st in results:
        for k, v in (st or {}).items():
            total[k] = total.get(k, 0) + v
    return total
