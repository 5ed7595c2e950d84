"""The port's continuous, device-loop and bucketed serving modes of
``cli/serve`` against its batched answers (moved from
``tests/test_torch_serve.py``, whose module fixture and docstring they
share)."""

import pytest

from tests.test_torch_export import shared_export_loads  # noqa: F401
from tests.test_torch_kernels import one_torch_thread  # noqa: F401
from tests.test_torch_serve import (  # noqa: F401
    _port, _same_jsonl, saved_programs_served, served)


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
