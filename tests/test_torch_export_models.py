"""Each model's exported predict program (``runtime/exported.
export_predict``) against its live predict (``make_predict_fn``) on the
CPU, at toy widths (V from a toy vocabulary, E = H = 16, one layer a
stack, 2 decode steps): greedy for all six models, plus CaSE rank-only and
beam width 2. Outputs equal (``torch.equal``). The export time of each is
printed (the GRU models' scans unroll into the graph, a step at a time).

With ``early_exit=True`` (4 decode steps), the exported ``while_loop``
program against the live early-exit predict for all six models: the
generator is pushed toward EOS (``_push_eos``) so that every row of one
batch ends before the last step and the loop stops early there, and
outputs are equal.
"""

import time

import pytest
import torch

from case_rg_tpu_torch.config import DataConfig, ModelConfig
from case_rg_tpu_torch.device import batch_to_device
from case_rg_tpu_torch.models import (build_model_cfg, create_model,
                                      perturb_affine)
from case_rg_tpu_torch.runtime.exported import export_predict
from case_rg_tpu_torch.runtime.inference import make_predict_fn
from case_rg_tpu_torch.serving.featurize import chunk_to_batch
from tests.test_torch_export import toy_requests, toy_vocab
from tests.test_torch_kernels import one_torch_thread  # noqa: F401

MAX_LEN = 2
CASES = [("case", {}), ("masque", {}), ("s2sa", {}), ("gttp", {}),
         ("glks", {}), ("tmemnet", {}), ("case", {"rank_only": True}),
         ("case", {"beam_width": 2})]


@pytest.mark.parametrize("name, opts", CASES, ids=[
    "case", "masque", "s2sa", "gttp", "glks", "tmemnet", "case-rank_only",
    "case-beam2"])
def test_export_equals_live_predict(name, opts):
    vocab = toy_vocab()
    cfg = build_model_cfg(ModelConfig(
        embedding_size=16, hidden_size=16, num_heads=2, enc_layers=1,
        dec_layers=1, tmemnet_layers=2, max_target_length=MAX_LEN,
        max_dec_len=MAX_LEN, min_window_size=2, num_windows=1), name, vocab)
    model = create_model(name, cfg, device="cpu", seed=3)
    perturb_affine(model, torch.Generator().manual_seed(4))
    dcfg = DataConfig(query_len=6, passage_len=6, num_passage=3,
                      answer_len=MAX_LEN, min_window_size=2, num_windows=1)
    batches = [chunk_to_batch(toy_requests(3, 3, seed=s), name, vocab, dcfg,
                              3) for s in (0, 1)]
    t0 = time.perf_counter()
    program = export_predict(model, cfg, batches[0], MAX_LEN, device="cpu",
                             **opts)
    print(f"{name} {opts}: exported in {time.perf_counter() - t0:.1f} s, "
          f"{len(program.graph.nodes)} nodes")
    live = make_predict_fn(model, cfg, MAX_LEN, device="cpu", **opts)
    module = program.module()
    for batch in batches:
        want = live(batch)
        with torch.inference_mode():
            got = module(batch_to_device(batch, "cpu"))
        assert sorted(got) == sorted(want)
        assert ("rank" in want) == (name in ("case", "masque", "tmemnet"))
        assert ("answer" in want) == ("rank_only" not in opts)
        for k in want:
            assert torch.equal(got[k], want[k]), k


EE_LEN = 4
# how far _push_eos moves the EOS logit: on one of the two batches, every
# row of each model ends after 1-3 of the 4 steps (toy weights of seeds 3
# and 4)
EOS_PUSH = {"case": 4.0, "masque": 3.0, "s2sa": 1.0, "gttp": 2.5,
            "glks": 2.15, "tmemnet": 2.5}


def _push_eos(model, cfg, x):
    """Raise the EOS logit by ``x``: the vocabulary projection's bias at
    EOS, or (CaSE and Masque, whose projection has no bias) the
    generator's hidden bias along the EOS row, with the mix leaning to
    generation."""
    eos = cfg.eos_id
    with torch.no_grad():
        heads = [m for m in model.modules() if isinstance(m, torch.nn.Linear)
                 and m.out_features == cfg.vocab_size and m.bias is not None]
        for m in heads:
            m.bias[eos] += x
        if not heads:
            dec = model.decoder
            w = dec.gen2.weight[eos]
            dec.gen1.bias += x * w / w.norm()
            dec.mix.bias[0] += 3.0


def _steps_run(answer):
    """Steps a greedy loop ran: the last column holding a token, plus 1."""
    cols = (answer != 0).any(0).nonzero()
    return int(cols.max()) + 1 if len(cols) else 0


@pytest.mark.parametrize("name", list(EOS_PUSH))
def test_early_exit_export_equals_live_predict(name):
    vocab = toy_vocab()
    cfg = build_model_cfg(ModelConfig(
        embedding_size=16, hidden_size=16, num_heads=2, enc_layers=1,
        dec_layers=1, tmemnet_layers=2, max_target_length=EE_LEN,
        max_dec_len=EE_LEN, min_window_size=2, num_windows=1), name, vocab)
    model = create_model(name, cfg, device="cpu", seed=3)
    perturb_affine(model, torch.Generator().manual_seed(4))
    _push_eos(model, cfg, EOS_PUSH[name])
    dcfg = DataConfig(query_len=6, passage_len=6, num_passage=3,
                      answer_len=EE_LEN, min_window_size=2, num_windows=1)
    batches = [chunk_to_batch(toy_requests(3, 3, seed=s), name, vocab, dcfg,
                              3) for s in (0, 1)]
    t0 = time.perf_counter()
    program = export_predict(model, cfg, batches[0], EE_LEN, device="cpu",
                             early_exit=True)
    print(f"{name} early_exit: exported in {time.perf_counter() - t0:.1f} "
          f"s, {len(program.graph.nodes)} nodes")
    assert any(n.target is torch.ops.higher_order.while_loop
               for n in program.graph.nodes)
    live = make_predict_fn(model, cfg, EE_LEN, device="cpu", early_exit=True)
    module = program.module()
    steps = []
    for batch in batches:
        want = live(batch)
        with torch.inference_mode():
            got = module(batch_to_device(batch, "cpu"))
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
        steps.append(_steps_run(want["answer"]))
    assert 1 <= min(steps) < EE_LEN, steps
