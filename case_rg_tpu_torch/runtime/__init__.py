"""Serving entry points of the port (counterparts of ``case_rg_tpu/runtime``)."""
