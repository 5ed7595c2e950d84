"""Serving CaSE from text through the port's CLI
(``case_rg_tpu_torch.cli.serve``) against the JAX package's
(``case_rg_tpu.cli.serve``).

A module fixture prepares the toy corpus with the JAX package (E=16, H=2,
query 24, passage 24, 4 passages, answer 10, as tests/test_e2e.py does),
writes one JAX checkpoint of init weights (drawn by the port and laid out
as the JAX tree by ``tests/test_torch_bridge.jax_tree_from_port``, so no
JAX init is traced; no training; biases and LayerNorm gains given seeded
noise so the answers are not degenerate)
and runs the JAX CLI once, batched greedy in f32. The port's CLI on the CPU
must write the same JSONL byte for byte (with ``--epoch`` latest and best,
and with ``--ema``). Where two rank scores of one request lie within 1e-5
of each other, the comparison reports it and takes those ranking
positions as a set. Port-only checks against that output: the continuous
chunk loop (with and without pool buckets), the device loop, batch
buckets, the HTTP server (batched and continuous), sampled continuous
serving with per-request seeds at two batch sizes, and the refused flags.

The ``cuda`` test (skips without a card) builds its own vocabulary and a
checkpoint in the port's format, and holds the CLI's batched and
device-loop outputs on the card to ``make_predict_fn`` and
``run_continuous_device`` driven directly. JAX is imported only inside the
CPU fixture, so README's ``cuda`` command can run this file where JAX is
not installed.
"""

import json
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

from case_rg_tpu_torch.cli.serve import main as port_main
from tests.test_torch_export import shared_export_loads  # noqa: F401
from tests.test_torch_kernels import cuda, one_torch_thread  # noqa: F401

WORDS = ("energy motion kinetic potential mechanical object system force heat "
         "whale dolphin orca size ocean mammal salary nurse doctor physician "
         "median pay oregon storage battery spring compressed power grid "
         "turbine solar panel wind water dam generator").split()
SHAPES = ["--embedding_size", "16", "--hidden_size", "16", "--num_heads",
          "2", "--max_target_length", "10", "--query_len", "24",
          "--passage_len", "24", "--num_passage", "4"]
TIE = 1e-5


def _requests(n: int = 10, seed: int = 0):
    """History of 0-2 turns, pools of 0-6 passages (more than the 4
    scored), some ``max_tokens``, one request without an id."""
    rng = np.random.RandomState(seed)

    def sent(lo, hi):
        return " ".join(rng.choice(WORDS, rng.randint(lo, hi + 1)))

    pools = [2, 6, 0, 4, 1, 3, 5, 2, 4, 3]
    reqs = []
    for i in range(n):
        r = {"id": f"r{i}", "query": sent(3, 8) + " ?"}
        if i % 3:
            r["history"] = [sent(3, 8) + " ?" for _ in range(i % 3)]
        r["passages"] = [sent(6, 14) + ". " + sent(6, 14) + "."
                         for _ in range(pools[i % len(pools)])]
        if i % 4 == 1:
            r["max_tokens"] = 2 + i % 5
        reqs.append(r)
    del reqs[-1]["id"]
    return reqs


def _write(path, reqs):
    with open(path, "w") as f:
        for r in reqs:
            f.write(json.dumps(r) + "\n")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The toy corpus prepared, one JAX checkpoint (epoch 0, also the best),
    the requests, the JAX CLI's JSONL, and each request's rank scores."""
    import jax

    from case_rg_tpu.cli.prepare import main as prepare_main
    from case_rg_tpu.cli.serve import main as jax_main
    from case_rg_tpu.config import DataConfig, ModelConfig, TrainConfig
    from case_rg_tpu.data.vocab import Vocabulary
    from case_rg_tpu.models import build_model_cfg, create_model
    from case_rg_tpu.serving.featurize import chunk_to_batch
    from case_rg_tpu.train.checkpoint import save_best, save_checkpoint
    from case_rg_tpu.train.trainer import Trainer, TrainState
    from fixtures import make_dataset

    root = str(tmp_path_factory.mktemp("serve"))
    make_dataset(root, "toy", n_queries=12, n_passages=20)
    prepare_main(["--data_path", root, "--dataset", "toy", "--models",
                  "case", "--query_len", "24", "--passage_len", "24",
                  "--num_passage", "4", "--answer_len", "10"])
    prep = os.path.join(root, "toy", "prepared")
    out = os.path.join(root, "out")
    vocab = Vocabulary.load(os.path.join(prep, "vocab.txt"))
    mcfg = build_model_cfg(ModelConfig(embedding_size=16, hidden_size=16,
                                       num_heads=2, max_target_length=10,
                                       max_dec_len=10), "case", vocab)
    trainer = Trainer(create_model("case", mcfg),
                      TrainConfig(batch_size=4, output_path=out),
                      total_steps=100)
    dcfg = DataConfig(query_len=24, passage_len=24, num_passage=4,
                      answer_len=10)
    reqs = _requests()
    # the init weights drawn by the port (the flax initializers' laws), laid
    # out as the JAX package's tree: no JAX init traced here
    from case_rg_tpu_torch.config import ModelConfig as PortConfig
    from case_rg_tpu_torch.models import create_model as port_create
    from tests.test_torch_bridge import jax_tree_from_port
    init = jax_tree_from_port(port_create("case", PortConfig(**{
        k: getattr(mcfg, k) for k in PortConfig.__dataclass_fields__}),
        device="cpu"))
    state = TrainState(params=init, opt_state=trainer.tx.init(init),
                       ema=init, step=np.int32(0))
    rng = np.random.RandomState(1)

    def noisy(path, x):
        x = np.asarray(x, np.float32)
        name = path[-1].key
        if name in ("bias", "qkv_bias"):
            return x + 0.1 * rng.randn(*x.shape).astype(np.float32)
        if name == "scale":
            return x * (1 + 0.1 * rng.randn(*x.shape).astype(np.float32))
        return x

    params = jax.tree_util.tree_map_with_path(noisy, state.params)
    save_checkpoint(out, 0, jax.device_get(state.replace(params=params,
                                                         ema=params)))
    save_best(out, 0, 1.0)

    req_path = os.path.join(root, "reqs.jsonl")
    _write(req_path, reqs)
    common = ["--model", "case", "--prepared_dir", prep, "--output_path",
              out, "--input", req_path, "--batch_size", "4"] + SHAPES
    jax_out = os.path.join(root, "jax.jsonl")
    jax_main(common + ["--output", jax_out])

    # rank scores of each request (the port's model on the JAX weights,
    # batched as the CLI batches), to find near-ties
    from case_rg_tpu_torch.bridge import load_jax_params
    from case_rg_tpu_torch.runtime.inference import make_predict_fn
    port = port_create("case", PortConfig(**{
        k: getattr(mcfg, k) for k in PortConfig.__dataclass_fields__}),
        device="cpu")
    load_jax_params(port, params)
    rank = make_predict_fn(port, port.cfg, 10, rank_only=True, device="cpu")
    scores = {}
    for i in range(0, len(reqs), 4):
        chunk = reqs[i:i + 4]
        r = rank(chunk_to_batch(chunk, "case", vocab, dcfg, 4))["rank"]
        for j, req in enumerate(chunk):
            scores[req.get("id", i + j)] = r[j].numpy()
    with open(jax_out) as f:
        want = f.read()
    return {"root": root, "common": common, "reqs": reqs, "want": want,
            "scores": scores, "prep": prep, "out": out}


@pytest.fixture(scope="module", autouse=True)
def saved_programs_served(shared_export_loads):
    """An archive that ``cli/export_model`` saves in this module is served
    as the program it saved (``shared_export_loads.remember``): this
    module's tests hold serving to the JAX CLI, and a load of the fixed-trip
    archive takes about 20 s on this CPU. The archive's round trip through
    the file is held in ``tests/test_torch_export.py``
    (``Pipeline.from_export``, ``cli/export_model --check``)."""
    real = torch.export.save

    def save(program, f, *args, **kwargs):
        real(program, f, *args, **kwargs)
        if not args and not kwargs and isinstance(f, (str, os.PathLike)):
            shared_export_loads.remember(program, f)

    torch.export.save = save
    yield
    torch.export.save = real


def _port(served, name, *extra):
    path = os.path.join(served["root"], name + ".jsonl")
    port_main(served["common"] + ["--output", path, "--device", "cpu"]
              + list(extra))
    with open(path) as f:
        return f.read()


def _tie_groups(ranking, scores):
    """The ranking cut into runs of passages whose scores lie within TIE of
    their neighbour's."""
    groups = []
    for j in ranking:
        if groups and abs(scores[groups[-1][-1]] - scores[j]) < TIE:
            groups[-1].append(j)
        else:
            groups.append([j])
    return groups


def _same_responses(got, want, scores):
    """Responses equal, ranking positions of near-tied scores as sets."""
    assert [g.get("id") for g in got] == [w.get("id") for w in want]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w), (g, w)
        assert g.get("answer") == w.get("answer"), (g, w)
        if "ranking" not in w:
            continue
        pos = 0
        for grp in _tie_groups(w["ranking"], scores[w["id"]]):
            if len(grp) > 1:
                print(f"near-tie in {w['id']}: passages {grp} within {TIE}")
            assert sorted(g["ranking"][pos:pos + len(grp)]) == sorted(grp), \
                (g, w)
            pos += len(grp)


def _same_jsonl(got: str, served) -> None:
    """Byte for byte, unless near-tied rank scores reorder a ranking."""
    if got == served["want"]:
        return
    _same_responses([json.loads(x) for x in got.splitlines()],
                    [json.loads(x) for x in served["want"].splitlines()],
                    served["scores"])


@pytest.mark.parametrize("extra", [[], ["--epoch", "best"], ["--ema"]],
                         ids=["latest", "best", "ema"])
def test_serve_equals_the_jax_package(served, extra):
    _same_jsonl(_port(served, "batched", *extra), served)


@pytest.mark.parametrize("extra", [
    ["--continuous"],
    ["--continuous", "--refill", "1", "--chunk_steps", "3"],
    ["--continuous", "--lookahead", "--async_harvest", "--refill", "2",
     "--refill_min", "2"],
    ["--continuous", "--device_loop", "2", "--chunk_steps", "2"],
    ["--continuous", "--device_loop", "3", "--chunk_steps", "2",
     "--lookahead", "--stage_rows", "3", "--warmup"],
    ["--batch_buckets", "2,4"],
    ["--pipeline_depth", "1", "--warmup"],
], ids=["chunk-loop", "refill-1", "lookahead-async", "device-loop",
        "device-loop-lookahead", "batch-buckets", "depth-1"])
def test_port_modes_equal_the_batched_answers(served, extra):
    _same_jsonl(_port(served, "mode", *extra), served)


def test_rank_only_ranks_as_the_full_run(served):
    got = [json.loads(x) for x in _port(served, "rank_only",
                                        "--rank_only").splitlines()]
    want = [json.loads(x) for x in served["want"].splitlines()]
    assert all("answer" not in g for g in got)
    _same_responses(got, [{k: v for k, v in w.items() if k != "answer"}
                          for w in want], served["scores"])


def test_pool_buckets(served):
    """Pool buckets batched, through the chunk loop and through the device
    loop give the same answers; requests routed to the full bucket (the
    padded pool's size) answer as the JAX package's padded serving does."""
    batched = _port(served, "pb", "--pool_buckets", "2")
    assert _port(served, "pb_chunk", "--continuous",
                 "--pool_buckets", "2") == batched
    assert _port(served, "pb_device", "--continuous", "--device_loop", "2",
                 "--chunk_steps", "2", "--pool_buckets", "2",
                 "--lookahead") == batched
    got = [json.loads(x) for x in batched.splitlines()]
    want = [json.loads(x) for x in served["want"].splitlines()]
    full = [i for i, r in enumerate(served["reqs"])
            if len(r["passages"]) > 2]
    assert full
    _same_responses([got[i] for i in full], [want[i] for i in full],
                    served["scores"])


def test_sampled_continuous_per_request_seeds(served):
    """A request with a "seed" samples the same answer whatever the batch
    size and refill width."""
    reqs = [dict(r, seed=100 + i) for i, r in enumerate(served["reqs"])]
    path = os.path.join(served["root"], "seeded.jsonl")
    _write(path, reqs)
    args = ["--input", path, "--continuous", "--decoding", "sample",
            "--top_k", "5", "--temperature", "0.9"]
    a = _port(served, "s4", *args)
    b = _port(served, "s2", *args, "--batch_size", "2", "--refill", "1")
    assert a == b
    assert a != served["want"]      # sampled, not greedy


def _http(served, extra, posts, stream=None, common=None):
    """Run ``--listen`` in a thread, POST each list of requests from its own
    thread, read /healthz and /varz, shut down. ``stream``: one request
    POSTed with "stream": true after the others. ``common``: the CLI's
    arguments (default: the checkpoint's). Returns (responses by id, varz,
    the streamed lines)."""
    holder, ready = {}, threading.Event()

    def on_ready(server):
        holder["server"] = server
        ready.set()

    argv = (served["common"] if common is None else common) + [
        "--device", "cpu", "--listen", "127.0.0.1:0", "--max_wait_ms",
        "50"] + extra
    t = threading.Thread(target=port_main, args=(argv,),
                         kwargs={"_server_ready": on_ready}, daemon=True)
    t.start()
    assert ready.wait(timeout=60), "server did not come up"
    host, port = holder["server"].server_address[:2]
    base = f"http://{host}:{port}"
    with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
        assert r.read() == b"ok\n"
    got = {}

    def post(lines):
        data = "".join(json.dumps(x) + "\n" for x in lines).encode()
        req = urllib.request.Request(base + "/", data=data, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            assert r.status == 200
            for x in r.read().decode().splitlines():
                resp = json.loads(x)
                got[resp["id"]] = resp

    clients = [threading.Thread(target=post, args=(p,)) for p in posts]
    for c in clients:
        c.start()
    for c in clients:
        c.join(timeout=120)
    lines = []
    if stream is not None:
        data = (json.dumps(dict(stream, stream=True)) + "\n").encode()
        req = urllib.request.Request(base + "/", data=data, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            lines = [json.loads(x) for x in r.read().decode().splitlines()]
    with urllib.request.urlopen(base + "/varz", timeout=30) as r:
        varz = json.loads(r.read().decode())
    holder["server"].shutdown()
    t.join(timeout=60)
    assert not t.is_alive()
    return got, varz, lines


@pytest.mark.parametrize("extra", [
    [], ["--continuous", "--device_loop", "2", "--chunk_steps", "2"]],
    ids=["batched", "device-loop"])
def test_http(served, extra):
    reqs = served["reqs"][:-1]          # every one with an id
    got, varz, lines = _http(served, extra, [reqs[i::3] for i in range(3)],
                             stream=reqs[1] if extra else None)
    want = [json.loads(x) for x in served["want"].splitlines()][:-1]
    _same_responses([got[w["id"]] for w in want], want, served["scores"])
    assert varz["errors"] == 0
    assert varz["requests_served"] == len(reqs) + bool(extra)
    assert varz["continuous"] == bool(extra)
    if extra:       # streamed: deltas, then the whole answer, done
        assert lines[-1]["done"] and all("delta" in x for x in lines[:-1])
        _same_responses([{k: v for k, v in lines[-1].items() if k != "done"}],
                        [want[1]], served["scores"])


@pytest.mark.parametrize("extra, message", [
    (["--from_export", "artifact", "--continuous"],
     "--continuous does not apply"),
    (["--from_export", "artifact", "--bf16"], "--bf16 does not apply"),
    (["--pool_shard", "2"], "item 7b"),
    (["--from_export", "artifact", "--bf16_scores"],
     "--bf16_scores does not apply"),
], ids=["from_export-continuous", "from_export-bf16", "pool_shard",
        "bf16_scores"])
def test_refused_flags(served, extra, message):
    """Each refused flag exits with its message. ``--bf16_scores`` is
    refused only with ``--from_export`` (the archive fixes its program);
    on its own it is served (``test_bf16_scores_is_served``)."""
    with pytest.raises(SystemExit, match=message):
        _port(served, "refused", *extra)


def test_bf16_scores_is_served(served):
    """``--bf16_scores`` turns the switch on; on the f32 checkpoint every
    score stays f32 (f32 inputs always get f32 scores), so the JSONL is
    still the JAX CLI's."""
    from case_rg_tpu_torch.ops import attention
    try:
        got = _port(served, "bf16_scores", "--bf16_scores")
        assert attention._BF16_SCORES
    finally:
        attention.set_bf16_scores(False)
    _same_jsonl(got, served)


# ---- serving an exported program ----

# the keys case_rg_tpu/cli/export_model.py writes into its sidecar
SIDECAR_KEYS = {"model", "epoch", "platforms", "batch_size", "dtype",
                "rank_only", "beam_width", "max_target_length", "data",
                "inputs"}


@pytest.fixture(scope="module")
def exported(served):
    """The port's cli/export_model on the CPU from the JAX checkpoint, at
    the JAX CLI's batch size; the requests file and the serving arguments
    of the archive."""
    from case_rg_tpu_torch.cli.export_model import main as export_main
    art = os.path.join(served["root"], "case_b4.pt2")
    common = served["common"]
    report = export_main(["--model", "case", "--prepared_dir", served["prep"],
                          "--output_path", served["out"], "--out", art,
                          "--batch_size", "4", "--device", "cpu"] + SHAPES)
    req = common[common.index("--input") + 1]
    return {"art": art, "report": report,
            "common": ["--prepared_dir", served["prep"], "--from_export",
                       art, "--input", req]}


def test_export_sidecar(served, exported):
    """The sidecar has the JAX CLI's keys, the CPU as its platform, and
    ``chunk_to_batch``'s input shapes and dtypes."""
    from case_rg_tpu_torch.config import DataConfig
    from case_rg_tpu_torch.data.vocab import Vocabulary
    from case_rg_tpu_torch.serving.featurize import chunk_to_batch
    with open(exported["art"] + ".json") as f:
        side = json.load(f)
    assert set(side) == SIDECAR_KEYS and side == exported["report"]["sidecar"]
    assert side["platforms"] == ["cpu"] and side["batch_size"] == 4
    assert side["data"] == {"query_len": 24, "passage_len": 24,
                            "num_passage": 4}
    vocab = Vocabulary.load(os.path.join(served["prep"], "vocab.txt"))
    batch = chunk_to_batch(served["reqs"][:1], "case", vocab, DataConfig(
        query_len=24, passage_len=24, num_passage=4, answer_len=10), 4)
    assert side["inputs"] == {k: {"shape": list(v.shape),
                                  "dtype": str(v.dtype)}
                              for k, v in batch.items()}


def test_from_export_equals_the_jax_package(served, exported):
    """cli/serve --from_export on the CPU writes the JAX CLI's JSONL."""
    path = os.path.join(served["root"], "from_export.jsonl")
    port_main(exported["common"] + ["--output", path, "--device", "cpu"])
    with open(path) as f:
        _same_jsonl(f.read(), served)


def test_from_export_early_exit_equals_the_jax_package(served):
    """The JAX checkpoint exported with ``--early_exit`` (the decode a
    ``while_loop``) and served with cli/serve --from_export on the CPU
    writes the JAX CLI's JSONL; its sidecar has the JAX CLI's keys."""
    from case_rg_tpu_torch.cli.export_model import main as export_main
    art = os.path.join(served["root"], "case_b4_early.pt2")
    report = export_main(["--model", "case", "--prepared_dir",
                          served["prep"], "--output_path", served["out"],
                          "--out", art, "--batch_size", "4", "--early_exit",
                          "--device", "cpu"] + SHAPES)
    assert set(report["sidecar"]) == SIDECAR_KEYS
    common = served["common"]
    path = os.path.join(served["root"], "from_export_early.jsonl")
    port_main(["--prepared_dir", served["prep"], "--from_export", art,
               "--input", common[common.index("--input") + 1], "--output",
               path, "--device", "cpu"])
    with open(path) as f:
        _same_jsonl(f.read(), served)


def test_from_export_over_http(served, exported):
    """The --listen front end serves the archive as the batched one does."""
    reqs = served["reqs"][:-1]
    got, varz, _ = _http(served, [], [reqs[i::3] for i in range(3)],
                         common=exported["common"])
    want = [json.loads(x) for x in served["want"].splitlines()][:-1]
    _same_responses([got[w["id"]] for w in want], want, served["scores"])
    assert varz["errors"] == 0 and varz["requests_served"] == len(reqs)


@pytest.mark.parametrize("case", ["platform", "not_an_archive",
                                  "no_sidecar"])
def test_from_export_refusals(served, exported, tmp_path, case):
    """An archive traced for the card served with --device cpu, a file
    that is not a torch.export archive (a JAX .shlo with a ["cpu"]
    sidecar), and an archive without its sidecar are refused."""
    with open(exported["art"] + ".json") as f:
        side = json.load(f)
    art = str(tmp_path / "case.pt2")
    if case == "platform":
        os.symlink(exported["art"], art)
        side["platforms"] = ["cuda"]
        message = r"exported for platform\(s\) \['cuda'\]"
    elif case == "not_an_archive":
        art = str(tmp_path / "case.shlo")
        with open(art, "wb") as f:
            f.write(b"ML\xefR\x0dStableHLO_v1.0.0\x00")
        message = "case.shlo is not a torch.export archive"
    else:
        os.symlink(exported["art"], art)
        side = None
        message = "cannot read sidecar"
    if side is not None:
        with open(art + ".json", "w") as f:
            json.dump(side, f)
    argv = exported["common"][:]
    argv[argv.index("--from_export") + 1] = art
    with pytest.raises(SystemExit, match=message):
        port_main(argv + ["--output", str(tmp_path / "o.jsonl"),
                          "--device", "cpu"])


@pytest.mark.parametrize("name", ["masque", "glks", "tmemnet"])
def test_serves_the_other_models(served, tmp_path, name):
    """The port's CLI serves the other models from a port checkpoint (random
    weights with noisy biases): its JSONL equals ``make_predict_fn`` on
    ``chunk_to_batch`` of the same requests, detokenized as the CLI does,
    and rankings (masque, tmemnet) order each pool by the rank scores."""
    from case_rg_tpu_torch.config import DataConfig, ModelConfig
    from case_rg_tpu_torch.data.vocab import Vocabulary
    from case_rg_tpu_torch.models import (build_model_cfg, create_model,
                                          perturb_affine)
    from case_rg_tpu_torch.runtime.inference import make_predict_fn
    from case_rg_tpu_torch.runtime.io import ids_to_sentence, remove_duplicate
    from case_rg_tpu_torch.serving.featurize import chunk_to_batch
    from case_rg_tpu_torch.train.checkpoint import save_checkpoint

    vocab = Vocabulary.load(os.path.join(served["prep"], "vocab.txt"))
    cfg = build_model_cfg(ModelConfig(embedding_size=16, hidden_size=16,
                                      num_heads=2, max_target_length=10,
                                      max_dec_len=10), name, vocab)
    model = create_model(name, cfg, device="cpu", seed=3)
    perturb_affine(model, torch.Generator().manual_seed(4))
    params = dict(model.named_parameters())
    out = str(tmp_path / "out")
    save_checkpoint(out, 0, {"params": params, "ema": params, "step": 0})
    common = [x if x != served["out"] else out for x in served["common"]]
    common[common.index("--model") + 1] = name
    path = str(tmp_path / "got.jsonl")
    port_main(common + ["--output", path, "--device", "cpu"])
    with open(path) as f:
        got = [json.loads(x) for x in f]

    dcfg = DataConfig(query_len=24, passage_len=24, num_passage=4,
                      answer_len=10)
    predict = make_predict_fn(model, cfg, 10, device="cpu")
    detok = vocab.detokenizer()
    reqs = served["reqs"]
    assert len(got) == len(reqs)
    for i in range(0, len(reqs), 4):
        chunk = reqs[i:i + 4]
        pred = predict(chunk_to_batch(chunk, name, vocab, dcfg, 4))
        caps = [min(r.get("max_tokens", 10), 10) for r in chunk]
        sents = [ids_to_sentence(row[:c], vocab) for row, c in
                 zip(pred["answer"].numpy(), caps)]
        remove_duplicate(sents)
        for j, (resp, req) in enumerate(zip(got[i:i + 4], chunk)):
            assert resp["id"] == req.get("id", i + j)
            assert resp["answer"] == detok(sents[j])
            assert ("ranking" in resp) == (name != "glks")
            if name != "glks":
                n_real = min(len(req["passages"]), 4)
                scores = pred["rank"][j].numpy()[:max(n_real, 1)]
                assert resp["ranking"] == [int(k) for k in np.argsort(
                    -scores, kind="stable")[:n_real]]
    assert any(r["answer"] for r in got)


def test_serve_needs_a_card_unless_asked(served, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_main(served["common"] + ["--output", os.path.join(
            served["root"], "nocard.jsonl")])


# ---- on the card ----

@pytest.mark.cuda
def test_cli_on_the_card_equals_the_serving_loops(cuda, tmp_path):
    """bf16 on the card: the CLI's batched answers equal ``make_predict_fn``
    on ``chunk_to_batch`` of the same requests, and its device-loop answers
    ``run_continuous_device`` on the same batches, token for token (as the
    CLI detokenizes them)."""
    from case_rg_tpu_torch.config import DataConfig, ModelConfig
    from case_rg_tpu_torch.data.vocab import Vocabulary
    from case_rg_tpu_torch.models import (build_model_cfg, create_model,
                                          perturb_affine)
    from case_rg_tpu_torch.runtime.continuous import (make_device_loop_fns,
                                                      run_continuous_device)
    from case_rg_tpu_torch.runtime.inference import make_predict_fn
    from case_rg_tpu_torch.runtime.io import ids_to_sentence, remove_duplicate
    from case_rg_tpu_torch.serving.featurize import chunk_to_batch
    from case_rg_tpu_torch.train.checkpoint import save_checkpoint

    prep, out = tmp_path / "prepared", str(tmp_path / "out")
    prep.mkdir()
    vocab = Vocabulary.build_from_texts([WORDS + [w + "s" for w in WORDS]])
    vocab.save(str(prep / "vocab.txt"))
    vocab = Vocabulary.load(str(prep / "vocab.txt"))
    n_pass, lq, lp, t = 6, 24, 100, 12
    cfg = build_model_cfg(ModelConfig(embedding_size=256, hidden_size=256,
                                      num_heads=8, max_target_length=t,
                                      max_dec_len=t), "case", vocab)
    f32 = create_model("case", cfg, device=cuda)
    perturb_affine(f32, torch.Generator(device=cuda).manual_seed(1))
    params = dict(f32.named_parameters())
    save_checkpoint(out, 0, {"params": params, "ema": params, "step": 0})
    model = f32.to(torch.bfloat16)
    reqs = _requests(24, seed=3)
    for r in reqs:
        r["passages"] = r["passages"] * 3
    req_path = str(tmp_path / "reqs.jsonl")
    _write(req_path, reqs)
    dcfg = DataConfig(query_len=lq, passage_len=lp, num_passage=n_pass,
                      answer_len=t)
    common = ["--model", "case", "--prepared_dir", str(prep),
              "--output_path", out, "--input", req_path, "--batch_size",
              "8", "--bf16", "--fast_argmax", "pallas",
              "--max_target_length", str(t), "--query_len", str(lq),
              "--passage_len", str(lp), "--num_passage", str(n_pass)]
    detok = vocab.detokenizer()

    def answers(ids_rows, chunk):
        caps = [min(r.get("max_tokens", t), t) for r in chunk]
        sents = [ids_to_sentence(row[:max(c, 1)], vocab)
                 for row, c in zip(ids_rows, caps)]
        remove_duplicate(sents)
        return [detok(s) for s in sents]

    def cli(*extra):
        path = str(tmp_path / "got.jsonl")
        port_main(common + ["--output", path] + list(extra))
        with open(path) as f:
            return [json.loads(x)["answer"] for x in f]

    predict = make_predict_fn(model, cfg, t, early_exit=True,
                              fast_argmax="pallas", device=cuda)
    want = []
    for i in range(0, len(reqs), 8):
        chunk = reqs[i:i + 8]
        ids = predict(chunk_to_batch(chunk, "case", vocab, dcfg, 8))
        want += answers(ids["answer"].cpu().numpy(), chunk)
    assert cli() == want

    fns = make_device_loop_fns(model, t, 2, 2, 8, refill_bound=2,
                               fast_argmax="pallas", device=cuda)
    got = {}
    run_continuous_device(
        iter(reqs), lambda c, k: chunk_to_batch(c, "case", vocab, dcfg, k),
        fns, 8, 2, lambda r, ids, rk: got.__setitem__(id(r), ids), t)
    direct = [answers([got[id(r)]], [r])[0] for r in reqs]
    assert cli("--continuous", "--device_loop", "2", "--chunk_steps", "2",
               "--refill", "2", "--stage_rows", "8") == direct
