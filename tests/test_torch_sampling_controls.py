"""The sampling controls (temperature, top_k, top_p, and per row) against the
JAX package's (moved from ``tests/test_torch_decoding.py``, whose
docstring describes them)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from case_rg_tpu.decode import loops as jloops
from case_rg_tpu_torch.decode import loops
from tests.test_torch_decoding import _logits  # noqa: F401
from tests.test_torch_kernels import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("temperature", [1.0, 0.7])
@pytest.mark.parametrize("top_k", [0, 1, 7])
@pytest.mark.parametrize("top_p", [1.0, 0.9, 0.4])
def test_sampling_controls_match_jax(temperature, top_k, top_p):
    x = _logits(top_k)
    got = loops.sampling_controls(torch.from_numpy(x), temperature, top_k,
                                  top_p)
    want = jloops.sampling_controls(jnp.asarray(x), temperature, top_k, top_p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampling_controls_rows_match_jax():
    grid = [(t, k, p) for t in (1.0, 0.7, 1.3) for k in (0, 1, 7)
            for p in (1.0, 0.9, 0.4)]
    x = _logits(5, b=len(grid))
    ctl = np.array(grid, np.float32)
    got = loops.sampling_controls_rows(
        torch.from_numpy(x), torch.from_numpy(ctl[:, 0]),
        torch.from_numpy(ctl[:, 1]).long(), torch.from_numpy(ctl[:, 2]))
    want = jloops.sampling_controls_rows(
        jnp.asarray(x), jnp.asarray(ctl[:, 0]),
        jnp.asarray(ctl[:, 1]).astype(jnp.int32), jnp.asarray(ctl[:, 2]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for r, (t, k, p) in enumerate(grid):      # each row is the batch form
        np.testing.assert_array_equal(
            got[r:r + 1].numpy(),
            loops.sampling_controls(torch.from_numpy(x[r:r + 1]), t, int(k),
                                    p).numpy())
