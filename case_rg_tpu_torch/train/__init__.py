"""Training (port of ``case_rg_tpu/train``): the train step, its schedule
and the mixed-precision cast."""
