"""Shared continuous-batching pieces (port of
``case_rg_tpu/runtime/continuous/base.py``): the program builders
(init/chunk/refill), the host copies a harvest reads, request sources, and
the lazy rank handle. See the package docstring for the design.
"""

from __future__ import annotations

import queue
from typing import Iterator, List

import numpy as np
import torch

from ...decode.loops import validate_controls
from ...device import batch_to_device, resolve_device


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of a decode state (dicts, lists and
    tuples of tensors; None stays None), the other trees walked in step."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *leaves)
                          for leaves in zip(tree, *rest))
    if tree is None:
        return None
    raise TypeError(f"unexpected decode-state leaf {type(tree)}")


def leaves(tree) -> List[torch.Tensor]:
    """The tensor leaves of a decode state, in ``tree_map``'s order."""
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def host_to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without making the host wait: on a card,
    a non-blocking copy from pinned memory. The pinned block comes from
    PyTorch's caching host allocator, which records the copy's stream and
    does not hand the block out again before the copy has run."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


@torch.inference_mode()
def refill_rows(state: dict, new_state: dict, rows) -> dict:
    """Scatter ``new_state``'s rows into ``state`` at ``rows``, IN PLACE,
    and return ``state``.

    ``rows`` (a host sequence) has ``new_state``'s batch size; entries
    outside [0, B) of ``state``'s batch size B (padding slots of a
    part-filled refill) are dropped here on the host, since an index out of
    range raises. The row indices reach the card by ``host_to_device``, so
    a refill does not wait for the chunk in flight."""
    rows = np.asarray(rows, dtype=np.int64).reshape(-1)
    first = leaves(state)[0]
    b, dev = first.shape[0], first.device
    src = np.flatnonzero((rows >= 0) & (rows < b))
    if len(src):
        dst_t = host_to_device(rows[src], dev)
        src_t = host_to_device(src, dev)
        tree_map(lambda s, n: s.index_copy_(0, dst_t,
                                            n.index_select(0, src_t)),
                 state, new_state)
    return state


def make_continuous_fns(model, max_len: int, chunk_steps: int,
                        fast_argmax=None, decoding: str = "greedy",
                        temperature: float = 1.0, top_k: int = 0,
                        top_p: float = 1.0, device="cuda"):
    """(init_fn, chunk_fn, refill_fn) for a model with ``decode_init`` and
    ``decode_chunk`` (CaSE).

    init_fn(batch) -> (state, rank) moves the batch to the model's device
    and encodes it; chunk_fn(state) advances every live row by
    ``chunk_steps`` decode steps and returns the new state (the KV caches
    are updated in place, so only the returned state may be advanced
    again); refill_fn(state, new_state, rows) is ``refill_rows``.
    ``fast_argmax`` is the greedy argmax mode (``MultiMemoryDecoder``).

    ``decoding="sample"`` samples each step instead (the temperature/top_k/
    top_p controls, or a batch's per-row "sample_ctl" [B, 3]). Batches must
    then carry "sample_key" [B, 2] per-row keys: a key rides with its row,
    so a request's sampled answer is the one-shot ``sample``'s with the
    same key, whatever its batch, chunk size or refill timing. Raises
    without a card unless ``device="cpu"``."""
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
    # sampling reads the dense extended distribution: no argmax operands
    # ride in its state
    fa = False if sampling else fast_argmax
    extra = dict(sampling=True, temperature=temperature, top_k=top_k,
                 top_p=top_p) if sampling else {}

    def init_fn(batch):
        if sampling and batch.get("sample_key") is None:
            raise ValueError("decoding='sample' needs per-row 'sample_key' "
                             "keys in the batch")
        with torch.inference_mode():
            return model.decode_init(batch_to_device(batch, where),
                                     max_len=max_len, fast_argmax=fa)

    def chunk_fn(state):
        with torch.inference_mode():
            return model.decode_chunk(state, n_steps=chunk_steps,
                                      fast_argmax=fa, **extra)

    return init_fn, chunk_fn, refill_rows


class HostCopy:
    """Copies of device tensors to the host, started now and read later.

    On a card the copies are non-blocking, into pinned host memory, behind
    an event recorded on the current stream: a pageable target would make
    the copy synchronous, and reading before the event completes would read
    garbage. The copy takes the values that the tensors hold at this point
    of the stream, whatever is enqueued after it. On the CPU the copies are
    plain."""

    __slots__ = ("_host", "_event")

    def __init__(self, tensors):
        self._event = None
        if tensors[0].device.type == "cuda":
            self._host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                          for t in tensors]
            for h, t in zip(self._host, tensors):
                h.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(tensors[0].device))
        else:
            self._host = [t.clone() for t in tensors]

    def get(self) -> List[np.ndarray]:
        """The copies as numpy arrays (bf16, which numpy lacks, as f32)."""
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        return [(h.float() if h.dtype == torch.bfloat16 else h).numpy()
                for h in self._host]


class _LazyRank:
    """Keeps a refill's rank fetch off the critical path: the host copy
    starts when the handle is made and is read at the first row access
    (usually chunks later, when the request finishes and the copy has
    landed)."""

    __slots__ = ("_copy", "_np")

    def __init__(self, arr: torch.Tensor):
        self._copy = HostCopy([arr])
        self._np = None

    def row(self, i: int):
        if self._np is None:
            self._np = self._copy.get()[0]
            self._copy = None
        return self._np[i]


class IterSource:
    """Request source over a plain iterator. ``take`` blocks on the
    iterator until it yields or ends (``wait`` is advisory here): fine for
    in-memory iterators and files, not for a trickling stream, which goes
    through a reader thread and a ``QueueSource``."""

    def __init__(self, it: Iterator[dict]):
        self._it = iter(it)
        self._done = False

    def take(self, n: int, wait: bool) -> List[dict]:
        out: List[dict] = []
        while len(out) < n and not self._done:
            try:
                out.append(next(self._it))
            except StopIteration:
                self._done = True
        return out

    def finished(self) -> bool:
        return self._done


class QueueSource:
    """Request source over a ``queue.Queue``: ``wait=True`` blocks for the
    first item; further items are drained without blocking, so the decode
    loop never stalls on an idle queue. A ``stop`` sentinel marks the end
    of the stream."""

    def __init__(self, q, stop):
        self._q = q
        self._stop = stop
        self._done = False

    def take(self, n: int, wait: bool) -> List[dict]:
        out: List[dict] = []
        if self._done:
            return out
        if wait:
            item = self._q.get()
            if item is self._stop:
                self._done = True
                return out
            out.append(item)
        while len(out) < n:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is self._stop:
                self._done = True
                break
            out.append(item)
        return out

    def finished(self) -> bool:
        return self._done
