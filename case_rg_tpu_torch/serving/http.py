"""HTTP micro-batching server (``cli/serve --listen``; port of
``case_rg_tpu/serving/http.py``).

Handler threads only enqueue requests and wait on per-request events; a
single dispatcher thread owns all device work (featurize -> dispatch), and
a completer thread waits for each batch's pinned host copy (started by the
dispatcher) and releases the waiters - the dispatch/fetch split pipelines
the host round trip exactly like the offline path. Requests arriving
within ``--max_wait_ms`` of each other coalesce into one device batch (up
to ``--batch_size``). With ``--pool_buckets``, each coalesced batch runs at
the smallest static pool size that fits its largest request.

With ``--continuous`` one worker thread replaces the pair: it featurizes,
encodes, decodes, copies results to the host and detokenizes; handler
threads touch only queues and host memory. Over several replicas
(``--device`` naming several devices) the worker hands the
arrivals out and each replica's thread runs its own loop on its card
(``serving/lanes.run_serving``); a device-loop capture runs in its
replica's thread, or in the replicas' threads with ``--warmup`` before the
server binds (``runtime/graphs.CapturedGraph``). The batched path's
micro-batches coalesce as on one card and split by rows over the
replicas.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict

from .featurize import bucket_for, chunk_to_batch, parse_buckets
from .lanes import run_serving


def serve_http(args, dcfg, responses_for, run_predict, vocab, bbuckets,
               server_ready=None, cont=None):
    """Run the ``--listen`` server until interrupted.

    ``cont`` (from ``--continuous``) replaces dispatcher+completer with
    one worker driving the continuous decode loop: requests join the
    in-flight batch as rows free up (no coalescing window needed — the
    decode state IS the batch), and each waiter is released the moment
    its row finishes (``ordered=False``)."""
    import dataclasses
    import queue
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    bs = args.batch_size
    buckets = parse_buckets(args.pool_buckets, dcfg.num_passage) \
        if args.pool_buckets else []
    dcfgs = {k: dataclasses.replace(dcfg, num_passage=k) for k in buckets}
    arrival = iter(range(1 << 62))   # fallback ids = arrival order
    arrival_lock = threading.Lock()
    stats = {"requests": 0, "batches": 0, "errors": 0,
             "batch_rows": 0, "batch_seconds": 0.0}
    stats_lock = threading.Lock()
    from collections import deque as _deque
    latencies: "_deque" = _deque(maxlen=1000)   # last-N request latencies

    def note_done(items):
        now = time.monotonic()
        with stats_lock:
            for p in items:
                if "t_in" in p:
                    latencies.append(now - p["t_in"])

    reqq: queue.Queue = queue.Queue()
    doneq: queue.Queue = queue.Queue(maxsize=max(args.pipeline_depth, 1))
    stop = object()
    lane_holder: Dict[str, list] = {}   # multi-lane worker publishes lanes

    def fail_items(items, exc):
        # a bad request must not kill the serving threads: release its
        # waiters with an error payload and keep going
        print(f"[serve] batch failed: {exc!r}", file=sys.stderr)
        note_done(items)
        with stats_lock:
            stats["errors"] += len(items)
        for p in items:
            p["resp"] = {"id": p["req"].get("id", p["seq"])
                         if isinstance(p["req"], dict) else p["seq"],
                         "error": str(exc)}
            if "stream_q" in p:   # unblock a streaming handler too
                p["stream_q"].put(dict(p["resp"], done=True))
            p["event"].set()

    def dispatcher():
        while True:
            item = reqq.get()
            if item is stop:
                doneq.put(stop)
                return
            items = [item]
            deadline = time.monotonic() + args.max_wait_ms / 1000.0
            while len(items) < bs:
                t = deadline - time.monotonic()
                if t <= 0:
                    break
                try:
                    nxt = reqq.get(timeout=t)
                except queue.Empty:
                    break
                if nxt is stop:
                    reqq.put(stop)   # re-queue: stop after this batch
                    break
                items.append(nxt)
            try:
                chunk = [p["req"] for p in items]
                if buckets:
                    k = bucket_for(max(len(r.get("passages", []))
                                       for r in chunk), buckets)
                    dk = dcfgs[k]
                else:
                    dk = dcfg
                batch = chunk_to_batch(chunk, args.model, vocab, dk,
                                       bucket_for(len(chunk), bbuckets))
                doneq.put((items, run_predict(batch), dk, time.monotonic()))
            except Exception as e:   # malformed request, featurize error, ...
                fail_items(items, e)

    def continuous_worker():
        from ..runtime.continuous import QueueSource

        live = []   # items in slots, for failure cleanup

        def wrap_mb(mb):
            def make_batch(items, k):
                try:
                    batch = mb([p["req"] for p in items], k)
                    live.extend(items)
                    return batch
                except Exception as e:   # malformed request, featurize error
                    fail_items(items, e)
                    return None
            return make_batch

        def emit(item, ids_row, rank_row):
            try:
                item["resp"] = responses_for(
                    [item["req"]], cont["row_out"](ids_row, rank_row), dcfg,
                    default_ids=[item["seq"]])[0]
                if "stream_q" in item:   # final authoritative line
                    item["stream_q"].put(dict(item["resp"], done=True))
                item["event"].set()
                note_done([item])
                with stats_lock:
                    stats["requests"] += 1
            except Exception as e:
                fail_items([item], e)
            finally:
                # drop the streaming cursor on BOTH outcomes (seq keys are
                # never reused, so a missed pop could only leak, not
                # poison a later stream — but don't leak either)
                last_sent.pop(item["seq"], None)
            if item in live:
                live.remove(item)

        def on_chunk(chunks):
            with stats_lock:
                stats["batches"] = chunks

        # token streaming ("stream": true requests): after every chunk,
        # push the newly decoded words of each live streaming row to its
        # handler. Deltas are detokenized word fragments (wordpiece joins
        # can differ across a fragment boundary); the final line carries
        # the authoritative full answer + ranking.
        from ..runtime.io import ids_to_words
        detok = vocab.detokenizer()
        last_sent: Dict[int, int] = {}   # item seq -> words streamed

        def stream_cb(host, slots):
            # ``host`` carries already-fetched numpy out/trow (one combined
            # host copy per chunk in the loop — no extra round trips here)
            live_s = [(r, s[1]) for r, s in enumerate(slots)
                      if s is not None and "stream_q" in s[1]]
            if not live_s:
                return
            out_h = host["out"]
            trow_h = host["trow"]
            for r, item in live_s:
                words = ids_to_words(out_h[r][: int(trow_h[r])], vocab)
                sent = last_sent.get(item["seq"], 0)
                if len(words) > sent:
                    item["stream_q"].put(
                        {"id": item["req"].get("id", item["seq"]),
                         "delta": detok(words[sent:])})
                    last_sent[item["seq"]] = len(words)

        # the worker owns the device: a compile/device error must not
        # strand current waiters or future requests behind a dead thread
        # (the dispatcher/completer pair guards the same way)
        try:
            holder: list = []
            lane_holder["lanes"] = holder
            run_serving(
                QueueSource(reqq, stop), cont, emit, args.max_target_length,
                ordered=False, on_chunk=on_chunk, stream_cb=stream_cb,
                wrap=wrap_mb, key=lambda p: len(p["req"].get("passages", [])),
                lane_holder=holder,
                arrive=(None if cont.get("arrive") is None
                        else lambda p: cont["arrive"](p["req"])))
        except Exception as e:
            print(f"[serve] continuous worker failed: {e!r}",
                  file=sys.stderr)
            fail_items([p for p in live if not p["event"].is_set()], e)
            while True:   # keep answering with errors instead of timeouts
                item = reqq.get()
                if item is stop:
                    return
                fail_items([item], e)

    def completer():
        while True:
            got = doneq.get()
            if got is stop:
                return
            items, out, dk, t_dispatch = got
            try:
                chunk = [p["req"] for p in items]
                seqs = [p["seq"] for p in items]
                resps = responses_for(chunk, out, dk, default_ids=seqs)
                for p, resp in zip(items, resps):
                    p["resp"] = resp
                    p["event"].set()
                note_done(items)
                with stats_lock:
                    stats["requests"] += len(items)
                    stats["batches"] += 1
                    stats["batch_rows"] += len(items)
                    stats["batch_seconds"] += time.monotonic() - t_dispatch
            except Exception as e:   # device failure must not strand waiters
                fail_items(items, e)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):   # keep stderr quiet under load
            pass

        def _send(self, code, data, ctype="application/jsonl"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, b"ok\n", "text/plain")
            elif self.path == "/varz":
                with stats_lock:
                    n, b_ = stats["requests"], stats["batches"]
                    varz = {"requests_served": n, "batches": b_,
                            "errors": stats["errors"],
                            "mean_batch_occupancy":
                                round(stats["batch_rows"] / b_, 2) if b_ else 0,
                            # dispatch -> completion, INCLUDING time queued
                            # behind other in-flight batches: pipeline
                            # residence, not device batch latency (can read
                            # up to pipeline_depth x the device time under
                            # sustained load)
                            "mean_batch_residence_s":
                                round(stats["batch_seconds"] / b_, 4)
                                if b_ else 0,
                            "batch_size": bs, "pool_buckets": buckets,
                            "batch_buckets": bbuckets,
                            "max_wait_ms": args.max_wait_ms,
                            "continuous": cont is not None}
                    if latencies:
                        ls = sorted(latencies)

                        def pct(q):
                            return round(ls[min(len(ls) - 1,
                                                int(q * len(ls)))], 4)
                        varz["request_latency_s"] = {
                            "p50": pct(0.50), "p90": pct(0.90),
                            "p99": pct(0.99), "n": len(ls)}
                    if lane_holder.get("lanes"):
                        # racy-but-safe snapshot (GIL list reads) of each
                        # continuous lane's live occupancy and queue depth
                        # (chunk-loop Lane counts occupied slots; device
                        # DeviceLane counts in-flight uids)
                        varz["lanes"] = {
                            str(ln.key): {
                                "occupied": (sum(s is not None
                                                 for s in ln.slots)
                                             if hasattr(ln, "slots")
                                             else ln.inflight),
                                "queued": len(ln.queue)}
                            for ln in lane_holder["lanes"]}
                self._send(200, (json.dumps(varz) + "\n").encode(),
                           "application/json")
            else:
                self._send(404, b"not found\n", "text/plain")

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0) or 0)
            body = self.rfile.read(length).decode("utf-8")
            try:
                reqs = [json.loads(line) for line in body.splitlines()
                        if line.strip()]
                if not all(isinstance(r, dict) for r in reqs):
                    raise ValueError("each line must be a JSON object")
            except (json.JSONDecodeError, ValueError) as e:
                self._send(400, f"bad request line: {e}\n".encode(),
                           "text/plain")
                return
            if not reqs:
                self._send(400, b"empty body\n", "text/plain")
                return
            if any(r.get("stream") for r in reqs):
                # token streaming: JSONL lines flushed as the row decodes —
                # {"id", "delta"} per chunk, then the authoritative
                # {"id", "answer", "ranking", "done": true}. HTTP/1.0
                # close-delimited body (no Content-Length); one streaming
                # request per POST.
                if cont is None or len(reqs) != 1:
                    self._send(400, b"streaming requests need --continuous "
                               b"serving and exactly one request per POST\n",
                               "text/plain")
                    return
                with arrival_lock:
                    item = {"req": reqs[0], "resp": None,
                            "seq": next(arrival), "t_in": time.monotonic(),
                            "event": threading.Event(),
                            "stream_q": queue.Queue()}
                reqq.put(item)
                self.send_response(200)
                self.send_header("Content-Type", "application/jsonl")
                self.end_headers()
                while True:
                    try:
                        msg = item["stream_q"].get(
                            timeout=args.request_timeout)
                    except queue.Empty:
                        msg = {"id": item["req"].get("id", item["seq"]),
                               "error": "timed out", "done": True}
                    self.wfile.write((json.dumps(msg) + "\n").encode())
                    self.wfile.flush()
                    if msg.get("done"):
                        return
            with arrival_lock:
                pend = [{"req": r, "resp": None, "seq": next(arrival),
                         "t_in": time.monotonic(),
                         "event": threading.Event()} for r in reqs]
            for p in pend:
                reqq.put(p)
            ok = all(p["event"].wait(timeout=args.request_timeout)
                     for p in pend)
            if not ok:
                self._send(503, b"timed out\n", "text/plain")
                return
            out = "".join(json.dumps(p["resp"]) + "\n" for p in pend)
            self._send(200, out.encode("utf-8"))

    host, _, port = args.listen.rpartition(":")
    server = ThreadingHTTPServer((host or "127.0.0.1", int(port)), Handler)
    if cont is not None:
        threads = [threading.Thread(target=continuous_worker, daemon=True)]
    else:
        threads = [threading.Thread(target=dispatcher, daemon=True),
                   threading.Thread(target=completer, daemon=True)]
    for t in threads:
        t.start()
    print(f"[serve] listening on http://{server.server_address[0]}:"
          f"{server.server_address[1]} "
          + (f"(continuous batch {bs}, chunk {args.chunk_steps}, "
             f"refill {cont['refill_size']})" if cont is not None else
             f"(batch {bs}, window {args.max_wait_ms} ms)"),
          file=sys.stderr)
    if server_ready is not None:
        server_ready(server)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        reqq.put(stop)
        for t in threads:
            t.join(timeout=30)
        server.server_close()
