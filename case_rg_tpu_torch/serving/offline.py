"""Offline (stdin/file) serving loops for ``cli/serve`` (port of
``case_rg_tpu/serving/offline.py``).

Two loops:

* ``run_offline_batched`` - consume batch_size chunks as they arrive,
  keep up to pipeline_depth batches in flight, flush each chunk's
  responses as soon as its result is fetched (pipelined dispatch: a
  batch's outputs come back through pinned host copies started at
  dispatch, so the host featurizes and enqueues the next batches while the
  card runs). With ``--pool_buckets``: per-bucket chunk accumulation, one
  static pool size per bucket, input order restored by a seqno reorder
  buffer.
* ``run_offline_continuous`` - drive the continuous decode loop
  (``runtime/continuous``: the chunk loop or the device loop) from a file
  or a long-lived stdin pipe, one loop a replica over the devices named
  (``serving/lanes.run_serving``).
"""

from __future__ import annotations

import json
import sys
from collections import deque
from typing import Dict, List

from .featurize import bucket_for, chunk_to_batch, parse_buckets, \
    read_chunks, read_requests
from .lanes import run_serving


def run_offline_continuous(src, sink, args, dcfg, cont, responses_for):
    """Continuous decode over a file/stdin source; returns loop stats."""
    def emit(req, ids_row, rank_row):
        resp = responses_for([req], cont["row_out"](ids_row, rank_row),
                             dcfg)[0]
        sink.write(json.dumps(resp) + "\n")
        sink.flush()

    # stdin may be a long-lived trickling pipe: a blocking read must
    # not stall in-flight rows (IterSource docstring), so stream it
    # through a reader thread + QueueSource; regular files read
    # without meaningful blocking and keep the plain iterator
    if src is sys.stdin:
        import queue as _queue
        import threading as _threading

        from ..runtime.continuous import QueueSource
        _q: "_queue.Queue" = _queue.Queue()
        _stop = object()

        def _reader():
            for r in read_requests(src):
                _q.put(r)
            _q.put(_stop)

        _threading.Thread(target=_reader, daemon=True).start()
        source = QueueSource(_q, _stop)
    else:
        source = read_requests(src)

    return run_serving(source, cont, emit, args.max_target_length,
                       arrive=cont.get("arrive"))


def run_offline_batched(src, sink, args, dcfg, vocab, bbuckets,
                        run_predict, responses_for):
    """Pipelined chunked predict over a file/stdin source."""
    bs = args.batch_size
    inflight: deque = deque()

    if not args.pool_buckets:
        def write_responses(chunk, out, dcfg_k):
            for resp in responses_for(chunk, out, dcfg_k):
                sink.write(json.dumps(resp) + "\n")
            sink.flush()

        for chunk in read_chunks(src, bs):
            batch = chunk_to_batch(chunk, args.model, vocab, dcfg,
                                   bucket_for(len(chunk), bbuckets))
            inflight.append((chunk, run_predict(batch), dcfg))
            while len(inflight) >= max(args.pipeline_depth, 1):
                write_responses(*inflight.popleft())
        while inflight:
            write_responses(*inflight.popleft())
        return

    # bucketed pools: per-bucket chunk accumulation, one static pool size
    # per bucket; input order restored by a seqno reorder buffer before
    # writing
    import dataclasses
    buckets = parse_buckets(args.pool_buckets, dcfg.num_passage)
    dcfgs = {k: dataclasses.replace(dcfg, num_passage=k)
             for k in buckets}
    # a part-filled bucket dispatches once flush_after newer requests
    # have been read past its oldest entry: bounds response latency and
    # reorder-buffer growth when streaming from a long-lived stdin pipe
    flush_after = args.bucket_flush_after or 2 * bs
    accum: Dict[int, List] = {k: [] for k in buckets}  # (seq, req)
    pending: Dict[int, dict] = {}
    next_emit = 0

    def emit_ready():
        nonlocal next_emit
        wrote = False
        while next_emit in pending:
            sink.write(json.dumps(pending.pop(next_emit)) + "\n")
            next_emit += 1
            wrote = True
        if wrote:
            sink.flush()

    def drain_one():
        chunk, seqs, out, dcfg_k = inflight.popleft()
        resps = responses_for(chunk, out, dcfg_k, default_ids=seqs)
        for s, resp in zip(seqs, resps):
            pending[s] = resp
        emit_ready()

    def dispatch(k):
        entries = accum[k]
        accum[k] = []
        seqs = [s for s, _ in entries]
        chunk = [r for _, r in entries]
        batch = chunk_to_batch(chunk, args.model, vocab, dcfgs[k],
                               bucket_for(len(chunk), bbuckets))
        inflight.append((chunk, seqs, run_predict(batch), dcfgs[k]))
        while len(inflight) >= max(args.pipeline_depth, 1):
            drain_one()

    for seq, req in enumerate(read_requests(src)):
        k = bucket_for(len(req.get("passages", [])), buckets)
        accum[k].append((seq, req))
        if len(accum[k]) == bs:
            dispatch(k)
        for j in buckets:   # age out part-filled buckets
            if accum[j] and seq - accum[j][0][0] >= flush_after:
                dispatch(j)
    for k in buckets:
        if accum[k]:
            dispatch(k)
    while inflight:
        drain_one()
