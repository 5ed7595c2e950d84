"""case_rg_tpu_torch — the PyTorch/CUDA port of ``case_rg_tpu`` for NVIDIA
Hopper (H100).

The package mirrors the JAX package's layout, so each module's counterpart
sits at the same relative path (``ops/attention.py`` here ports
``case_rg_tpu/ops/attention.py``). It imports ``torch`` and numpy only and
keeps its own copies of the host-side pieces it needs. The Pallas kernels
on CaSE's serving and training paths are hand-written CUDA C++ under
``csrc/``, built with ``nvcc`` at first use and bound with ``ctypes``
(``kernels/_build.py``).

Entry points (``models.create_model``, ``runtime.inference.make_predict_fn``,
``train.trainer.Trainer``, ``pipeline.Pipeline.from_checkpoint`` and the
CLIs ``cli.serve`` and ``cli.run``) run on the card by default and raise
when there is none, unless the caller passes ``device="cpu"`` (``--device
cpu``). ``cli.prepare`` and ``cli.evaluate`` touch no device.
"""

__version__ = "0.1.0"
