"""The serving kernels as custom ops (``case_rg_tpu_torch/kernels/
library.py``) and exported predict programs (``runtime/exported.py``,
``cli/export_model.py``, ``Pipeline.from_export``) on the CPU.

* ``torch.library.opcheck`` on each of the five ops at toy shapes;
* every kernel route forced (bf16 on the CPU, so the passage memory's
  stack takes ``stack_step`` and the query memory's ``single_query_mha``):
  the exported graph calls all five ops, the exported program's outputs
  equal the live predict's (``torch.equal``), and a live predict after the
  export still gives the same answers (the decoder's folded-weight cache
  keeps real tensors);
* the early-exit program (a ``while_loop``) with every route forced: each
  op once in the loop's body, outputs equal to the live early-exit
  predict's;
* ``Pipeline.from_export`` against ``Pipeline.from_checkpoint(early_exit=
  False)``, and its refusals; ``cli/export_model --early_exit --check``.

Each model's exported program against its live predict is
``tests/test_torch_export_models.py``. The ``cuda`` test (skips without a
card) holds an exported CaSE to the live predict on the card.
"""

import json
import os

import numpy as np
import pytest
import torch

from case_rg_tpu_torch.config import DataConfig, ModelConfig
from case_rg_tpu_torch.data.vocab import Vocabulary
from case_rg_tpu_torch.device import batch_to_device
from case_rg_tpu_torch.kernels import (additive_attention, copy_argmax,
                                       decode_attention, decoder_stack,
                                       encoder_attention, library)
from case_rg_tpu_torch.models import (build_model_cfg, create_model,
                                      multimem, perturb_affine)
from case_rg_tpu_torch.ops import attention, bilinear
from case_rg_tpu_torch.runtime.exported import export_predict, graph_ops
from case_rg_tpu_torch.runtime.inference import make_predict_fn
from case_rg_tpu_torch.serving.featurize import chunk_to_batch
from tests.test_torch_kernels import cuda, one_torch_thread  # noqa: F401

@pytest.fixture(scope="module", autouse=True)
def shared_export_loads():
    """``torch.export.load`` once per archive in a module: a load takes
    about 5 ms a graph node on this CPU, and several tests serve the same
    archive. Keyed by the file's path, size and mtime, so an archive
    written anew loads anew; every call gets the one ``ExportedProgram``
    (each consumer takes its own ``.module()``). Yields the patched load,
    whose ``remember(program, path)`` files a program under an archive."""
    real = torch.export.load
    cache = {}

    def key(f):
        st = os.stat(f)
        return os.path.realpath(f), st.st_size, st.st_mtime_ns

    def load(f, *args, **kwargs):
        if args or kwargs or not isinstance(f, (str, os.PathLike)):
            return real(f, *args, **kwargs)
        if key(f) not in cache:
            cache[key(f)] = real(f)
        return cache[key(f)]

    load.remember = lambda program, f: cache.__setitem__(key(f), program)
    torch.export.load = load
    yield load
    torch.export.load = real


WORDS = ("energy motion kinetic potential object system force heat whale "
         "dolphin orca size ocean mammal salary nurse doctor pay").split()


def toy_vocab() -> Vocabulary:
    return Vocabulary.build_from_texts([WORDS])


def toy_requests(n: int, n_pass: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    return [{"id": f"r{i}", "query": " ".join(rng.choice(WORDS, 5)) + " ?",
             "passages": [" ".join(rng.choice(WORDS, 8)) + " ."
                          for _ in range(n_pass - i % 2)]}
            for i in range(n)]


def _op_inputs():
    g = torch.Generator().manual_seed(0)
    r = lambda *s, dt=torch.float32: torch.randn(*s, generator=g).to(dt)
    b, l, e, h, t, nl, f = 2, 5, 8, 2, 4, 2, 16
    keep = torch.rand(b, l, generator=g) > 0.3
    folded = {"ln1g": (nl, e), "ln1b": (nl, e), "wqkv": (nl, e, 3 * e),
              "bqkv": (nl, 3 * e), "wos": (nl, e, e), "bos": (nl, e),
              "ln2g": (nl, e), "ln2b": (nl, e), "aq": (nl, e, h * e),
              "u": (nl, h * e), "wvo": (nl, h * e, e), "bout": (nl, e),
              "ln3g": (nl, e), "ln3b": (nl, e), "w1": (nl, e, f),
              "b1": (nl, f), "w2": (nl, f, e), "b2": (nl, e)}
    cache = r(b, t, 2 * e)
    return {
        "fused_mha": (r(b, 3, e), r(b, l, e), r(b, l, e), keep, h),
        "stack_step": (r(b, e), torch.tensor([1, 3], dtype=torch.int32),
                       r(b, nl, t, 2 * e), r(b, l, e), keep,
                       torch.tensor([[True] * 2 + [False] * 2] * b),
                       [0.3 * r(*folded[k]) for k in
                        decoder_stack.WEIGHT_KEYS], h),
        "single_query_mha": (r(b, 1, e), cache[..., :e], cache[..., e:],
                             keep[:, :1].expand(b, t).contiguous(), h),
        "combine_copy_mass": (r(b, 7), torch.tensor(
            [[5, 6, 5, 7, 5, 6, 9], [3, 3, 3, 4, 8, 8, 1]],
            dtype=torch.int32)),
        "additive_scores": (r(b, 3, e), r(b, l, e), r(e)),
    }


@pytest.mark.parametrize("name", library.OPS)
def test_opcheck(name):
    """Schema (``stack_step`` mutates only ``caches``), fake tensors and
    the AOT-dispatch tests of ``torch.library.opcheck``."""
    op = getattr(torch.ops.case_rg_torch, name).default
    torch.library.opcheck(op, _op_inputs()[name])


def test_ops_are_the_wrappers_on_the_cpu():
    """The wrappers call the ops, whose CPU implementations are the plain
    versions: equal outputs, no launch counted."""
    x = _op_inputs()
    before = [m.LAUNCHES for m in (encoder_attention, decoder_stack,
                                   decode_attention, copy_argmax,
                                   additive_attention)]
    assert torch.equal(encoder_attention.fused_mha(*x["fused_mha"]),
                       encoder_attention.fused_mha_plain(*x["fused_mha"]))
    xs, t, caches, m, mk, hk, folded, h = x["stack_step"]
    fd = dict(zip(decoder_stack.WEIGHT_KEYS, folded))
    c1, c2 = caches.clone(), caches.clone()
    y1, out = decoder_stack.stack_step(xs, t, c1, m, mk, hk, fd, h)
    y2, _ = decoder_stack.stack_step_plain(xs, t, c2, m, mk, hk, fd, h)
    assert out is c1 and torch.equal(y1, y2) and torch.equal(c1, c2)
    assert not torch.equal(c1, caches)
    assert torch.equal(
        decode_attention.single_query_mha(*x["single_query_mha"]),
        decode_attention.single_query_mha_plain(*x["single_query_mha"]))
    assert torch.equal(
        copy_argmax.combine_copy_mass(*x["combine_copy_mass"]),
        copy_argmax.combine_copy_mass_plain(*x["combine_copy_mass"]))
    assert torch.equal(
        additive_attention.additive_scores(*x["additive_scores"]),
        additive_attention.additive_scores_plain(*x["additive_scores"]))
    after = [m.LAUNCHES for m in (encoder_attention, decoder_stack,
                                  decode_attention, copy_argmax,
                                  additive_attention)]
    assert after == before


def _forced_case(dtype):
    """A small CaSE whose passage memory (6 x 90 positions) takes the
    stack kernel's route in bf16 (``_FUSED_MIN_L``), with two batches."""
    vocab = toy_vocab()
    cfg = build_model_cfg(ModelConfig(
        embedding_size=16, hidden_size=16, num_heads=2, enc_layers=1,
        dec_layers=2, max_target_length=4, max_dec_len=4,
        param_dtype=dtype), "case", vocab)
    model = create_model("case", cfg, device="cpu", seed=1)
    perturb_affine(model, torch.Generator().manual_seed(2))
    dcfg = DataConfig(query_len=12, passage_len=90, num_passage=6,
                      answer_len=4)
    batches = [chunk_to_batch(toy_requests(3, 6, seed=s), "case", vocab,
                              dcfg, 3) for s in (0, 1)]
    return cfg, model, batches


@pytest.fixture(scope="module")
def forced():
    """Every route to a kernel's op forced on the CPU, the pallas argmax;
    the program exported; live answers before and after the export. The
    routes are back on auto when the fixture returns."""
    attention.set_fused_attention(True)
    attention.set_single_query_attention(True)
    bilinear.set_additive_kernel(True)
    try:
        cfg, model, batches = _forced_case("bfloat16")
        live = make_predict_fn(model, cfg, 4, fast_argmax="pallas",
                               device="cpu")
        before = [live(b) for b in batches]
        program = export_predict(model, cfg, batches[0], 4,
                                 fast_argmax="pallas", device="cpu")
        after = [live(b) for b in batches]
        with torch.inference_mode():
            exported = [program.module()(batch_to_device(b, "cpu"))
                        for b in batches]
    finally:
        attention.set_fused_attention(None)
        attention.set_single_query_attention(None)
        bilinear.set_additive_kernel(None)
    return {"program": program, "before": before, "after": after,
            "exported": exported}


def test_forced_routes_call_every_op(forced):
    """The graph holds each of the five ops at the predict's launch
    counts: 2 fused_mha a passage encode... (one encoder layer over query
    and pool, and the towers' self-attention), a stack_step and a
    combine_copy_mass a step, 2 single_query_mha a query-stack layer and
    step, 2 additive_scores a step."""
    ops = graph_ops(forced["program"])
    assert set(ops) == set(library.OPS), ops
    assert ops["stack_step"] == 4 and ops["combine_copy_mass"] == 4
    assert ops["single_query_mha"] == 4 * 2 * 2
    assert ops["additive_scores"] == 4 * 2


def test_forced_routes_export_equals_live(forced):
    for got, want in zip(forced["exported"], forced["before"]):
        assert sorted(got) == sorted(want) == ["answer", "rank"]
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_forced_routes_early_exit_export_equals_live():
    """The early-exit program (a ``while_loop`` whose body holds the step
    once: ``stack_step``, which writes the passage stack's cache in place,
    runs on a copy of the carried cache) with every kernel route forced
    in bf16 and the pallas argmax: the graph holds each op once a step,
    and its answers and ranks equal the live early-exit predict's."""
    from tests.test_torch_export_models import _push_eos, _steps_run
    attention.set_fused_attention(True)
    attention.set_single_query_attention(True)
    bilinear.set_additive_kernel(True)
    try:
        cfg, model, batches = _forced_case("bfloat16")
        _push_eos(model, cfg, 4.0)
        live = make_predict_fn(model, cfg, 4, early_exit=True,
                               fast_argmax="pallas", device="cpu")
        want = [live(b) for b in batches]
        program = export_predict(model, cfg, batches[0], 4, early_exit=True,
                                 fast_argmax="pallas", device="cpu")
        with torch.inference_mode():
            got = [program.module()(batch_to_device(b, "cpu"))
                   for b in batches]
    finally:
        attention.set_fused_attention(None)
        attention.set_single_query_attention(None)
        bilinear.set_additive_kernel(None)
    body = program.graph_module.while_loop_body_graph_0
    assert graph_ops(body) == {"stack_step": 1, "combine_copy_mass": 1,
                               "single_query_mha": 2 * 2,
                               "additive_scores": 2}
    assert set(graph_ops(program)) == {"fused_mha"}     # the encode
    for g, w in zip(got, want):
        for k in w:
            assert torch.equal(g[k], w[k]), k
    assert min(_steps_run(w["answer"]) for w in want) < 4


def test_live_predict_after_export_is_unchanged(forced):
    """The export traces with fake tensors; the decoder's folded stack
    weights cached before it stay real, so the live predict after it gives
    the same answers and ranks."""
    for got, want in zip(forced["after"], forced["before"]):
        for k in want:
            assert torch.equal(got[k], want[k]), k


# ---- Pipeline.from_export ----

DIMS = ["--embedding_size", "16", "--hidden_size", "16", "--num_heads", "2",
        "--max_target_length", "3", "--query_len", "12", "--passage_len",
        "16", "--num_passage", "3"]


@pytest.fixture(scope="module")
def pipeline_dir(tmp_path_factory):
    """A prepared dir (vocab.txt), a port checkpoint of a noisy-bias CaSE
    and its export at batch size 2 on the CPU, with both decoder stacks on
    the stack kernel's route: the CLI's fresh model has an empty
    folded-weight cache when ``export_predict`` is called."""
    from case_rg_tpu_torch.cli.export_model import main as export_main
    from case_rg_tpu_torch.train.checkpoint import save_checkpoint
    root = tmp_path_factory.mktemp("pipe")
    prep, out = str(root / "prep"), str(root / "out")
    vocab = toy_vocab()
    vocab.save(os.path.join(prep, "vocab.txt"))
    cfg = build_model_cfg(ModelConfig(embedding_size=16, hidden_size=16,
                                      num_heads=2, max_target_length=3,
                                      max_dec_len=3), "case", vocab)
    model = create_model("case", cfg, device="cpu", seed=5)
    perturb_affine(model, torch.Generator().manual_seed(6))
    params = dict(model.named_parameters())
    save_checkpoint(out, 0, {"params": params, "ema": params, "step": 0})
    art = str(root / "case.pt2")
    multimem.set_fused_stack(True)
    try:
        report = export_main(["--model", "case", "--prepared_dir", prep,
                              "--output_path", out, "--batch_size", "2",
                              "--out", art, "--device", "cpu"] + DIMS)
        yield {"prep": prep, "out": out, "art": art, "report": report}
    finally:
        multimem.set_fused_stack(None)


def test_pipeline_from_export(pipeline_dir):
    """Pipeline.from_export serves the archive (config from the sidecar,
    no checkpoint) and answers as the checkpoint pipeline's fixed-trip
    decode does."""
    from case_rg_tpu_torch.pipeline import Pipeline
    d = pipeline_dir
    pe = Pipeline.from_export(d["art"], prepared_dir=d["prep"], device="cpu")
    assert pe.model == "case" and pe.batch_size == 2
    assert pe.provenance == {"source": "export", "model": "case",
                             "epoch": "0", "dtype": "float32"}
    reqs = toy_requests(5, 3, seed=7) + [dict(toy_requests(1, 2)[0],
                                              max_tokens=1)]
    got = pe.batch(reqs)
    multimem.set_fused_stack(True)      # the route the archive was traced on
    try:
        pc = Pipeline.from_checkpoint(
            "case", output_path=d["out"], prepared_dir=d["prep"],
            batch_size=2, early_exit=False, embedding_size=16,
            hidden_size=16, num_heads=2, max_target_length=3, query_len=12,
            passage_len=16, num_passage=3, device="cpu")
        assert got == pc.batch(reqs)
    finally:
        multimem.set_fused_stack(None)
    assert all("ranking" in r and "answer" in r for r in got)
    assert len(got[-1]["answer"].split()) <= 1


def test_pipeline_from_export_refusals(pipeline_dir, tmp_path):
    """An archive traced for another device type, a missing sidecar, and a
    file that is not a torch.export archive (a JAX .shlo) are refused."""
    from case_rg_tpu_torch.pipeline import Pipeline
    d = pipeline_dir
    with pytest.raises(RuntimeError, match="torch sees none"):
        Pipeline.from_export(d["art"], prepared_dir=d["prep"])
    side = json.load(open(d["art"] + ".json"))
    cuda_art = str(tmp_path / "cuda.pt2")
    os.symlink(d["art"], cuda_art)
    with open(cuda_art + ".json", "w") as f:
        json.dump(dict(side, platforms=["cuda"]), f)
    with pytest.raises(RuntimeError, match="exported for platform"):
        Pipeline.from_export(cuda_art, prepared_dir=d["prep"], device="cpu")
    with pytest.raises(FileNotFoundError, match="sidecar"):
        Pipeline.from_export(str(tmp_path / "none.pt2"),
                             prepared_dir=d["prep"], device="cpu")
    shlo = str(tmp_path / "case.shlo")
    with open(shlo, "wb") as f:
        f.write(b"ML\xefR\x0dStableHLO_v1.0.0\x00")
    with open(shlo + ".json", "w") as f:
        json.dump(dict(side, platforms=["cpu"]), f)
    with pytest.raises(ValueError, match="case.shlo is not a torch.export"):
        Pipeline.from_export(shlo, prepared_dir=d["prep"], device="cpu")


def test_export_cli_report_and_refusals(pipeline_dir, tmp_path,
                                        monkeypatch):
    """The CLI's report and sidecar (both stacks on the stack kernel's
    op, a launch a step each); --early_exit exports a program that
    ``--check`` holds to the live early-exit predict, with the JAX CLI's
    sidecar keys; --rank_only on a model without a rank head, and the
    default device without a card are refused."""
    from case_rg_tpu_torch.cli.export_model import main as export_main
    d = pipeline_dir
    rep = d["report"]
    assert rep["sidecar"]["platforms"] == ["cpu"]
    assert rep["ops"] == {"stack_step": 2 * 3}
    assert rep["bytes"] == os.path.getsize(d["art"])
    base = ["--prepared_dir", d["prep"], "--output_path", d["out"],
            "--out", str(tmp_path / "x.pt2")] + DIMS
    early = str(tmp_path / "early.pt2")
    ee = export_main(["--model", "case", "--early_exit", "--check",
                      "--device", "cpu", "--prepared_dir", d["prep"],
                      "--output_path", d["out"], "--batch_size", "2",
                      "--out", early] + DIMS)
    assert ee["sidecar"] == rep["sidecar"] and os.path.exists(early)
    assert any(n.target is torch.ops.higher_order.while_loop
               for n in torch.export.load(early).graph.nodes)
    with pytest.raises(SystemExit, match="no rank head"):
        export_main(["--model", "s2sa", "--rank_only", "--device", "cpu"]
                    + base)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export_main(["--model", "case"] + base)
    assert not os.path.exists(tmp_path / "x.pt2")


# ---- on the card ----

@pytest.mark.cuda
def test_exported_case_equals_live_on_the_card(cuda, tmp_path):
    """A bf16 CaSE with every kernel on its automatic route, exported on
    the card: the graph holds the ops, and the loaded archive's answers
    and ranks equal the live predict's bit for bit, with the same launches
    of each kernel."""
    from case_rg_tpu_torch.runtime.exported import load_exported
    from case_rg_tpu_torch.runtime.graphs import launch_counts
    vocab = toy_vocab()
    cfg = build_model_cfg(ModelConfig(
        embedding_size=256, hidden_size=256, num_heads=8, enc_layers=1,
        dec_layers=2, max_target_length=6, max_dec_len=6,
        param_dtype="bfloat16"), "case", vocab)
    model = create_model("case", cfg, device=cuda, seed=1)
    perturb_affine(model, torch.Generator(device=cuda).manual_seed(2))
    dcfg = DataConfig(query_len=20, passage_len=100, num_passage=6,
                      answer_len=6)
    batch = chunk_to_batch(toy_requests(4, 6), "case", vocab, dcfg, 4)
    program = export_predict(model, cfg, batch, 6, fast_argmax="pallas",
                             device=cuda)
    assert set(graph_ops(program)) == set(library.OPS)
    path = str(tmp_path / "case.pt2")
    torch.export.save(program, path)
    art = load_exported(path, ["cuda"])
    live = make_predict_fn(model, cfg, 6, fast_argmax="pallas", device=cuda)
    c0 = launch_counts()
    want = live(batch)
    c1 = launch_counts()
    got = art.call(batch)
    c2 = launch_counts()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert {k: c2[k] - c1[k] for k in c2} == {k: c1[k] - c0[k] for k in c1}
    assert all(c1[k] > c0[k] for k in c1)


@pytest.mark.cuda
def test_early_exit_export_equals_live_on_the_card(cuda, tmp_path):
    """A bf16 CaSE with every kernel on its automatic route and the EOS
    pushed so that rows end early, exported with ``early_exit`` on the
    card, saved and loaded: the program's answers and ranks equal the
    live early-exit predict's bit for bit, with the same launches of each
    kernel, fewer steps than the fixed trip's."""
    from case_rg_tpu_torch.runtime.exported import load_exported
    from case_rg_tpu_torch.runtime.graphs import launch_counts
    from tests.test_torch_export_models import _push_eos, _steps_run
    vocab = toy_vocab()
    cfg = build_model_cfg(ModelConfig(
        embedding_size=256, hidden_size=256, num_heads=8, enc_layers=1,
        dec_layers=2, max_target_length=6, max_dec_len=6,
        param_dtype="bfloat16"), "case", vocab)
    model = create_model("case", cfg, device=cuda, seed=1)
    perturb_affine(model, torch.Generator(device=cuda).manual_seed(2))
    _push_eos(model, cfg, 6.0)
    dcfg = DataConfig(query_len=20, passage_len=100, num_passage=6,
                      answer_len=6)
    batch = chunk_to_batch(toy_requests(4, 6), "case", vocab, dcfg, 4)
    program = export_predict(model, cfg, batch, 6, early_exit=True,
                             fast_argmax="pallas", device=cuda)
    path = str(tmp_path / "case_early.pt2")
    torch.export.save(program, path)
    art = load_exported(path, ["cuda"])
    live = make_predict_fn(model, cfg, 6, early_exit=True,
                           fast_argmax="pallas", device=cuda)
    c0 = launch_counts()
    want = live(batch)
    c1 = launch_counts()
    got = art.call(batch)
    c2 = launch_counts()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert {k: c2[k] - c1[k] for k in c2} == {k: c1[k] - c0[k] for k in c1}
    steps = _steps_run(want["answer"].cpu())
    assert c1["stack_step"] - c0["stack_step"] == steps
    assert steps < 6, f"no early exit: {steps} of 6 steps"
