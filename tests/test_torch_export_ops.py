"""The five serving kernels' ``torch.library`` custom ops: ``opcheck`` and the
wrappers calling them on the CPU (moved from ``tests/test_torch_export.py``,
whose docstring describes them)."""

import pytest
import torch

from case_rg_tpu_torch.kernels import (additive_attention, copy_argmax,
                                       decode_attention, decoder_stack,
                                       encoder_attention, library)
from tests.test_torch_export import (  # noqa: F401
    _op_inputs, shared_export_loads)
from tests.test_torch_kernels import one_torch_thread  # noqa: F401


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
