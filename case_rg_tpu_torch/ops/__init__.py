"""Ops of the port (counterparts of ``case_rg_tpu/ops``)."""
