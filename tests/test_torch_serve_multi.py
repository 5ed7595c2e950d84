"""The multi-model router (``case_rg_tpu_torch.cli.serve_multi``) on the
CPU, the port of ``tests/test_e2e.py::test_serve_multi``: a CaSE and an
S2SA backend in one process (noisy-bias init checkpoints in the port's
format, no training), every serve flag passed through after ``--``
(``--device cpu`` included). Requests route by their "model" field (the
first backend by default), responses merge in input order and equal each
backend's served alone through ``cli/serve``, streaming passes through,
``/healthz`` answers 200, ``/varz`` has both backends, and an unknown
model gets a 400.

Also here: each kernel library is built and loaded once per process
whatever the number of threads that ask first (``kernels/_build.load``).
The ``cuda`` test (skips without a card) runs two ``--device_loop``
backends behind the router: both capture their graphs in one process and
answer as each does alone.
"""

import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from case_rg_tpu_torch.cli.serve import main as serve_main
from case_rg_tpu_torch.cli.serve_multi import main as multi_main
from case_rg_tpu_torch.config import ModelConfig
from case_rg_tpu_torch.models import (build_model_cfg, create_model,
                                      perturb_affine)
from case_rg_tpu_torch.train.checkpoint import save_checkpoint
from tests.test_torch_export import toy_requests, toy_vocab
from tests.test_torch_kernels import cuda, one_torch_thread  # noqa: F401


def dims(e=16, h=2, n_pass=4, lp=24):
    return ["--embedding_size", str(e), "--hidden_size", str(e),
            "--num_heads", str(h), "--max_target_length", "8", "--query_len",
            "24", "--passage_len", str(lp), "--num_passage", str(n_pass)]


CONTINUOUS = ["--continuous", "--batch_size", "2", "--chunk_steps", "2",
              "--refill", "1"]


def _checkpoints(root, dev, e=16, h=2):
    """A prepared dir and a checkpoint each of CaSE and S2SA (seeded init
    weights with noisy biases and gains, E = H = ``e``, ``h`` heads), in
    the port's format."""
    prep = os.path.join(root, "prep")
    vocab = toy_vocab()
    vocab.save(os.path.join(prep, "vocab.txt"))
    outs = {}
    for seed, name in enumerate(("case", "s2sa")):
        cfg = build_model_cfg(ModelConfig(embedding_size=e, hidden_size=e,
                                          num_heads=h, max_target_length=8,
                                          max_dec_len=8), name, vocab)
        model = create_model(name, cfg, device=dev, seed=seed)
        perturb_affine(model, torch.Generator(device=dev).manual_seed(seed))
        params = {k: v.detach().cpu() for k, v in model.named_parameters()}
        outs[name] = os.path.join(root, name)
        save_checkpoint(outs[name], 0, {"params": params, "ema": params,
                                        "step": 0})
    return prep, outs


def _requests(n_pass=4):
    reqs = toy_requests(6, n_pass, seed=3)
    for i, r in enumerate(reqs):
        if i % 3 == 1:
            r["model"] = "s2sa"
        elif i % 3 == 2:
            r["model"] = "case"       # explicit; the others take the default
    return reqs


def _post(base, lines, timeout=300):
    data = "".join(json.dumps(x) + "\n" for x in lines).encode()
    req = urllib.request.Request(base + "/", data=data, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, [json.loads(x) for x in
                          r.read().decode().splitlines()]


def _alone(prep, out, name, reqs, extra, path):
    """``reqs`` served by ``cli/serve`` alone, offline."""
    src = path + ".in.jsonl"
    with open(src, "w") as f:
        for r in reqs:
            f.write(json.dumps({k: v for k, v in r.items()
                                if k != "model"}) + "\n")
    serve_main(["--model", name, "--prepared_dir", prep, "--output_path",
                out, "--input", src, "--output", path] + extra)
    with open(path) as f:
        return [json.loads(x) for x in f]


def _router(prep, outs, passthrough):
    holder, ready = {}, threading.Event()

    def on_ready(server):
        holder["server"] = server
        ready.set()

    argv = ["--listen", "127.0.0.1:0", "--prepared_dir", prep,
            "--backend", f"case={outs['case']}",
            "--backend", f"s2sa={outs['s2sa']}", "--"] + passthrough
    t = threading.Thread(target=multi_main, args=(argv,),
                         kwargs={"_server_ready": on_ready}, daemon=True)
    t.start()
    assert ready.wait(timeout=300), "router did not come up"
    return holder["server"], t


def _check_router(tmp_path, prep, outs, passthrough, n_pass=4):
    reqs = _requests(n_pass)
    server, thread = _router(prep, outs, passthrough)
    base = "http://%s:%d" % server.server_address[:2]
    try:
        status, lines = _post(base, reqs)
        assert status == 200
        assert [x["id"] for x in lines] == [r["id"] for r in reqs]
        routes = [r.get("model", "case") for r in reqs]
        for name in ("case", "s2sa"):
            idx = [i for i, m in enumerate(routes) if m == name]
            want = _alone(prep, outs[name], name, [reqs[i] for i in idx],
                          passthrough, str(tmp_path / f"{name}.jsonl"))
            assert [lines[i] for i in idx] == want, name
            assert all(("ranking" in lines[i]) == (name == "case")
                       for i in idx)
        assert any(x["answer"] for x in lines)

        # streaming passes through the router chunk by chunk
        stream = dict(reqs[0], id="s0", stream=True)
        status, slines = _post(base, [stream])
        assert status == 200 and slines[-1].get("done") is True
        assert all("delta" in x for x in slines[:-1])
        assert slines[-1]["answer"] == lines[0]["answer"]

        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            assert r.status == 200
        with urllib.request.urlopen(base + "/varz", timeout=60) as r:
            varz = json.loads(r.read().decode())
        assert set(varz) == {"case", "s2sa"}
        assert varz["case"]["continuous"] is True
        assert varz["s2sa"]["requests_served"] == routes.count("s2sa")
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, [dict(reqs[0], model="glks")])
        assert e.value.code == 400
        assert "unknown model 'glks'" in e.value.read().decode()
    finally:
        server.shutdown()
        thread.join(timeout=60)
    assert not thread.is_alive()


def test_router(tmp_path):
    prep, outs = _checkpoints(str(tmp_path), "cpu")
    _check_router(tmp_path, prep, outs, dims() + CONTINUOUS
                  + ["--device", "cpu"])


def test_each_library_is_built_and_loaded_once(monkeypatch):
    """Eight threads asking for one library at once: one build, one load,
    one handle for all of them."""
    from case_rg_tpu_torch.kernels import _build
    builds, loads = [], []

    def slow_build(names):
        builds.append(list(names))
        time.sleep(0.2)
        return {}

    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_lib_path",
                        lambda name: _build.Path("/nonexistent") / name)
    monkeypatch.setattr(_build, "build_all", slow_build)
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: loads.append(path) or object())
    got = []
    start = threading.Barrier(8)

    def ask():
        start.wait()
        got.append(_build.load("decoder_stack"))

    threads = [threading.Thread(target=ask) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert builds == [["decoder_stack"]] and len(loads) == 1
    assert len(got) == 8 and all(g is got[0] for g in got)
    assert _build.load("decoder_stack") is got[0] and len(loads) == 1


@pytest.mark.cuda
def test_two_device_loop_backends_on_the_card(cuda, tmp_path):
    """Two --device_loop backends in one process, each capturing its
    graphs on the card (no --warmup: the first requests capture, while the
    other backend may be serving): answers equal each backend's alone. The
    serving widths' heads (E = 256, 8 heads) and a pool of 6 x 100
    positions, so CaSE's passage stack takes the stack kernel."""
    prep, outs = _checkpoints(str(tmp_path), cuda, e=256, h=8)
    _check_router(tmp_path, prep, outs, dims(256, 8, 6, 100) + CONTINUOUS
                  + ["--bf16", "--device_loop", "2"], n_pass=6)
