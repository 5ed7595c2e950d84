"""Serving library behind ``cli/serve`` (port of ``case_rg_tpu/serving``).

The CLI entry point (argument surface, checkpoint loading) stays in
``cli/serve.py``; the serving machinery lives here:

* ``featurize``  - request JSON -> fixed-shape batches (same code path as
  the offline pipeline, so serving and evaluation agree)
* ``lanes``      - continuous-decode lane construction + pool routing
* ``http``       - the ``--listen`` HTTP micro-batching front
* ``offline``    - the stdin/file pipelined and continuous loops
"""
