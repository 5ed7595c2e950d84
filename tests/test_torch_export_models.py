"""Each model's exported predict program (``runtime/exported.
export_predict``) against its live predict (``make_predict_fn``) on the
CPU, at toy widths (V from a toy vocabulary, E = H = 16, one layer a
stack, 2 decode steps): greedy for all six models, plus CaSE rank-only and
beam width 2. Outputs equal (``torch.equal``). The export time of each is
printed (the GRU models' scans unroll into the graph, a step at a time).
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
        dec_layers=1, max_target_length=MAX_LEN, max_dec_len=MAX_LEN,
        min_window_size=2, num_windows=1), name, vocab)
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
