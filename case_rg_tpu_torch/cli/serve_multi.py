"""Multi-model serving: one HTTP front router + N single-model backends
(port of ``case_rg_tpu/cli/serve_multi.py``).

Each ``--backend model=output_path`` starts a full cli/serve.py HTTP stack
(own checkpoint, own predict or continuous programs, every serve flag
available via the shared passthrough args, ``--device`` included) on a
loopback port inside this process; every backend runs on the same card.
The router forwards each request line to the backend named by its
``"model"`` field (default: the first backend) and merges responses back
in input order. Token streaming passes through chunk-by-chunk.
``/healthz`` checks every backend; ``/varz`` returns ``{model:
backend_varz}``.

Several ``--device_loop`` backends may capture CUDA graphs in one process:
``runtime/graphs.CapturedGraph`` captures one at a time, process-wide, and
each kernel library is built and loaded once (``kernels/_build.load``).

Usage:
    python -m case_rg_tpu_torch.cli.serve_multi --listen 0.0.0.0:8080 \\
        --prepared_dir ./dataset/cast/prepared \\
        --backend case=./output/case --backend masque=./output/masque \\
        [-- any cli/serve.py flags applied to every backend, e.g.
         --bf16 --continuous --batch_size 64, or --device cpu]

Request lines are cli/serve.py's JSONL format plus an optional
``"model": "masque"`` route key (stripped before forwarding).
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
from typing import Dict, List


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--listen", type=str, required=True, help="HOST:PORT")
    p.add_argument("--prepared_dir", type=str, required=True)
    p.add_argument("--backend", action="append", required=True,
                   metavar="MODEL=OUTPUT_PATH",
                   help="repeatable; first backend is the default route")
    p.add_argument("--request_timeout", type=float, default=1800.0)
    return p


def main(argv=None, _server_ready=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    passthrough: List[str] = []
    if "--" in argv:
        split = argv.index("--")
        argv, passthrough = argv[:split], argv[split + 1:]
    args = build_parser().parse_args(argv)

    from .serve import main as serve_main

    backends: Dict[str, dict] = {}
    order: List[str] = []
    for spec in args.backend:
        model, _, out = spec.partition("=")
        if not out:
            raise SystemExit(f"--backend needs MODEL=OUTPUT_PATH; got "
                             f"{spec!r}")
        if model in backends:
            raise SystemExit(f"duplicate backend {model!r}")
        backends[model] = {"output_path": out, "ready": threading.Event()}
        order.append(model)
    default_model = order[0]

    def start_backend(model: str, b: dict):
        def on_ready(server):
            b["addr"] = "http://%s:%d" % server.server_address[:2]
            b["server"] = server
            b["ready"].set()

        serve_argv = ["--model", model, "--prepared_dir", args.prepared_dir,
                      "--output_path", b["output_path"],
                      "--listen", "127.0.0.1:0",
                      "--request_timeout", str(args.request_timeout),
                      ] + passthrough
        try:
            serve_main(serve_argv, _server_ready=on_ready)
        except BaseException as e:   # surface startup failures to waiters
            b["error"] = e
            b["ready"].set()

    # start backends SEQUENTIALLY: concurrent first imports of the model
    # modules from two threads can observe partially initialized modules
    # (circular-import edges in the package); each backend binds its port
    # (ready fires) after its model build, so waiting serializes the
    # import/build phase while steady-state serving still overlaps
    for m, b in backends.items():
        threading.Thread(target=start_backend, args=(m, b),
                         daemon=True).start()
        b["ready"].wait()
        if "error" in b:
            raise SystemExit(f"backend {m!r} failed to start: {b['error']}")
        print(f"[serve_multi] backend {m} at {b['addr']} "
              f"({b['output_path']})", file=sys.stderr)

    import urllib.error
    import urllib.request
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    def forward(model: str, body: bytes, timeout: float):
        req = urllib.request.Request(backends[model]["addr"] + "/",
                                     data=body, method="POST")
        return urllib.request.urlopen(req, timeout=timeout)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):
            pass

        def _send(self, code, data, ctype="application/jsonl"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/healthz":
                for m, b in backends.items():
                    try:
                        with urllib.request.urlopen(b["addr"] + "/healthz",
                                                    timeout=30) as r:
                            if r.status != 200:
                                raise OSError(f"status {r.status}")
                    except OSError as e:
                        self._send(503, f"backend {m}: {e}\n".encode(),
                                   "text/plain")
                        return
                self._send(200, b"ok\n", "text/plain")
            elif self.path == "/varz":
                varz = {}
                for m, b in backends.items():
                    try:
                        with urllib.request.urlopen(b["addr"] + "/varz",
                                                    timeout=30) as r:
                            varz[m] = json.loads(r.read().decode())
                    except OSError as e:
                        varz[m] = {"error": str(e)}
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
            routes = []
            for r in reqs:
                m = r.pop("model", default_model)
                if m not in backends:
                    self._send(400, f"unknown model {m!r} (backends: "
                               f"{order})\n".encode(), "text/plain")
                    return
                routes.append(m)

            if any(r.get("stream") for r in reqs):
                # streaming passes through chunk-by-chunk (serve.py already
                # enforces one streaming request per POST)
                if len(reqs) != 1:
                    self._send(400, b"streaming needs exactly one request "
                               b"per POST\n", "text/plain")
                    return
                data = (json.dumps(reqs[0]) + "\n").encode()
                try:
                    with forward(routes[0], data,
                                 args.request_timeout) as up:
                        self.send_response(up.status)
                        self.send_header("Content-Type",
                                         "application/jsonl")
                        self.end_headers()
                        for line in up:
                            self.wfile.write(line)
                            self.wfile.flush()
                except urllib.error.HTTPError as e:
                    self._send(e.code, e.read(), "text/plain")
                return

            # group by backend, preserve input order on merge
            groups: Dict[str, List[int]] = {}
            for i, m in enumerate(routes):
                groups.setdefault(m, []).append(i)
            results: List[dict] = [None] * len(reqs)
            errors: List[str] = []

            def run_group(m: str, idxs: List[int]):
                data = "".join(json.dumps(reqs[i]) + "\n"
                               for i in idxs).encode()
                try:
                    with forward(m, data, args.request_timeout) as up:
                        lines = [json.loads(l) for l in
                                 up.read().decode().splitlines()]
                    for i, resp in zip(idxs, lines):
                        results[i] = resp
                except (OSError, urllib.error.HTTPError) as e:
                    errors.append(f"backend {m}: {e}")
                    for i in idxs:
                        results[i] = {"id": reqs[i].get("id", i),
                                      "error": str(e)}

            gthreads = [threading.Thread(target=run_group, args=(m, idxs))
                        for m, idxs in groups.items()]
            for t in gthreads:
                t.start()
            for t in gthreads:
                t.join(timeout=args.request_timeout)
            out = "".join(json.dumps(r) + "\n"
                          for r in results if r is not None)
            self._send(200, out.encode("utf-8"))

    host, _, port = args.listen.rpartition(":")
    server = ThreadingHTTPServer((host or "127.0.0.1", int(port)), Handler)
    print(f"[serve_multi] routing {order} on http://"
          f"{server.server_address[0]}:{server.server_address[1]} "
          f"(default {default_model})", file=sys.stderr)
    if _server_ready is not None:
        _server_ready(server)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        for b in backends.values():
            srv = b.get("server")
            if srv is not None:
                srv.shutdown()
        server.server_close()


if __name__ == "__main__":
    main()
