"""TMemNet's continuous serving (the chunk loop and the device loop) against
its one-shot predict (moved from ``tests/test_torch_tmemnet.py``, whose
module fixture and docstring they share)."""

import pytest

from tests import test_torch_baselines as base
from tests.test_torch_kernels import one_torch_thread  # noqa: F401
from tests.test_torch_tmemnet import NAME, models  # noqa: F401


@pytest.mark.parametrize("device_loop", [False, True],
                         ids=["chunk-loop", "device-loop"])
def test_continuous_serving_equals_one_shot(models, device_loop):
    base.test_continuous_serving_equals_one_shot(models, NAME, device_loop)
