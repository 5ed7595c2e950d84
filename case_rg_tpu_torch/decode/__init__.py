"""Decode loops of the port (counterpart of ``case_rg_tpu/decode``)."""
