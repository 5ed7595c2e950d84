"""Hand-written CUDA kernels of the port and their wrappers (counterparts of
``case_rg_tpu/kernels``). Each wrapper launches its kernel on a CUDA tensor
and runs its plain PyTorch version on a CPU tensor; the five serving
wrappers do so through the custom ops of ``library``, imported here so
that importing any kernel module registers them."""

from . import library  # noqa: F401
