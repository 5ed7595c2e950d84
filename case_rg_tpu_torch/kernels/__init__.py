"""Hand-written CUDA kernels of the port and their wrappers (counterparts of
``case_rg_tpu/kernels``). Each wrapper launches its kernel on a CUDA tensor
and runs its plain PyTorch version on a CPU tensor."""
