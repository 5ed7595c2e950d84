"""The early-exit export of each of the six models against its live predict
(moved from ``tests/test_torch_export_models.py``, whose docstring
describes it)."""

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
from tests.test_torch_export import toy_requests, toy_vocab  # noqa: F401
from tests.test_torch_export_models import (  # noqa: F401
    EE_LEN, EOS_PUSH, _push_eos, _steps_run)
from tests.test_torch_kernels import one_torch_thread  # noqa: F401


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
