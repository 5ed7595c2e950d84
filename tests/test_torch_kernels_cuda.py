"""The serving kernels on the card (``fused_mha``, ``stack_step``) against their
plain versions (moved from ``tests/test_torch_kernels.py``, whose docstring
describes them); they skip without a card."""

import pytest
import torch

from case_rg_tpu_torch.kernels import decoder_stack as tds
from case_rg_tpu_torch.kernels import encoder_attention as tea
from case_rg_tpu_torch.models import init_weights, perturb_affine
from case_rg_tpu_torch.ops.transformer import Decoder as TDecoder
from tests.test_torch_kernels import (  # noqa: F401
    _bf16_close, _mha_inputs, cuda, one_torch_thread)


@pytest.mark.cuda
@pytest.mark.parametrize("r,lq,lk,e,h", [
    (8, 60, 60, 256, 8), (16, 100, 100, 256, 8), (4, 60, 60, 1280, 8),
    (4, 100, 100, 1280, 8), (5, 13, 17, 128, 8),
])
def test_fused_mha_kernel_matches_plain(cuda, r, lq, lk, e, h):
    q, k, v, keep = _mha_inputs(r, lq, lk, e, seed=lq)
    args = [torch.from_numpy(a).to(cuda) for a in (q, k, v)]
    args = [a.to(torch.bfloat16) for a in args]
    keep_t = torch.from_numpy(keep).to(cuda)
    before = tea.LAUNCHES
    out = tea.fused_mha(*args, keep_t, h)
    torch.cuda.synchronize()
    assert tea.LAUNCHES == before + 1
    ref = tea.fused_mha_plain(*args, keep_t, h)
    _bf16_close(out, ref, ulps=4)
    assert (out[0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("per_row", [False, True])
def test_stack_step_kernel_matches_plain(cuda, per_row):
    b, e, h, nl, lm, t_max = 4, 256, 8, 2, 600, 8
    port = TDecoder(nl, e, h, d_ff=e, device=cuda)
    init_weights(port, torch.Generator(device=cuda).manual_seed(0))
    perturb_affine(port, torch.Generator(device=cuda).manual_seed(2))
    fold = tds.fold_stack_weights(port, nl, h, torch.bfloat16)
    g = torch.Generator(device=cuda).manual_seed(1)
    m = torch.randn(b, lm, e, generator=g, device=cuda).to(torch.bfloat16)
    x = torch.randn(b, e, generator=g, device=cuda).to(torch.bfloat16)
    mem_keep = torch.rand(b, lm, generator=g, device=cuda) > 0.2
    ck = torch.zeros(b, nl, t_max, 2 * e, dtype=torch.bfloat16, device=cuda)
    cp = ck.clone()
    hist = torch.zeros(b, t_max, dtype=torch.bool, device=cuda)
    xk = xp = x
    for t in range(4):
        hist[:, t] = True
        tt = torch.tensor([t, t_max, t, t], device=cuda) if per_row else t
        xk, ck = tds.stack_step(xk, tt, ck, m, mem_keep, hist, fold, h)
        xp, cp = tds.stack_step_plain(xp, tt, cp, m, mem_keep, hist, fold, h)
        torch.cuda.synchronize()
        _bf16_close(xk, xp, ulps=16)
    _bf16_close(ck, cp, ulps=16)
    if per_row:
        assert (ck[1] == 0).all()
