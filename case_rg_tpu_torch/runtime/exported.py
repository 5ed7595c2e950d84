"""Exported serving programs (port of ``case_rg_tpu/runtime/exported.py``).

``cli/export_model.py`` traces the predict program with ``torch.export``
and saves it with ``torch.export.save``: the parameters ride inside the
archive, so calling it needs torch, this package's custom ops and the
archive, and no model code, checkpoint or vocabulary. Inputs and outputs
are the predict program's batch dict and output dict; the
``<artifact>.json`` sidecar documents the input spec and the device the
program was traced on.

* ``export_predict`` traces a model's predict program into an
  ``ExportedProgram`` (``PredictProgram``: ``runtime/inference.
  make_predict_body`` in a module whose ``forward(batch)`` takes a dict of
  tensors).
* ``load_exported`` loads an archive; ``.call(batch)`` runs it.

The graph holds the serving kernels as the custom ops of
``kernels/library.py``, so the program launches them when it runs on the
card. An early-exit program (``export_predict(early_exit=True)``) holds
its decode step once, in the body of a ``while_loop``; the loaded program
runs that loop eagerly, reading its condition on the host each step, and
``runtime/graphs`` never captures it. The graph is not decomposed
(``run_decompositions`` is not called): it runs the operations the eager
predict runs, in its order.
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import Dict, List, Optional

import torch

from ..kernels.library import NAMESPACE
from ..device import batch_to_device, resolve_device
from .inference import make_predict_body, make_predict_fn


class PredictProgram(torch.nn.Module):
    """``model``'s predict program as a module: ``forward(batch)`` takes the
    batch dict of tensors on the model's device and returns the output
    dict. The model's parameters are this module's (under ``model.``)."""

    def __init__(self, model: torch.nn.Module, body):
        super().__init__()
        self.model = model
        self._body = body

    def forward(self, batch: Dict[str, torch.Tensor]):
        return self._body(batch)


def export_predict(model, cfg, batch: dict, max_len: int, *,
                   beam_width: int = 1, early_exit: bool = False,
                   fast_argmax=None, rank_only: bool = False, device="cuda"
                   ) -> torch.export.ExportedProgram:
    """Trace ``model``'s predict program (greedy or beam) at ``batch``'s
    shapes into an ``ExportedProgram``.

    The greedy decode is the fixed-trip loop, each of its ``max_len``
    steps in the graph; with ``early_exit`` it is a ``while_loop`` whose
    body holds the step once and whose condition (some row has not
    emitted EOS) the loaded program reads on the host each step, as the
    live early-exit loop does (``models/multimem._decode_while``,
    ``decode/loops._greedy_while``). Beam search ignores ``early_exit``, as
    the JAX exporter's does.

    A live predict on ``batch`` runs first, so every first-use cache (the
    kernels' builds, the decoder's folded stack weights, the scale
    constants) is filled with real tensors before the trace, whose tensors
    are fake. The trace runs under ``torch.no_grad`` (``torch.
    inference_mode`` cannot wrap it). Counters that count at trace time
    count once more here: ``ops.bilinear.DENSE_SITES`` rises by the
    program's dense additive sites; the kernels' ``LAUNCHES`` count the
    live predict only. Raises ValueError where ``make_predict_fn`` would."""
    opts = dict(beam_width=beam_width, early_exit=early_exit,
                fast_argmax=fast_argmax, rank_only=rank_only)
    make_predict_fn(model, cfg, max_len, device=device, **opts)(batch)
    where = next(model.parameters()).device
    tb = batch_to_device(batch, where)
    program = PredictProgram(model, make_predict_body(model, cfg, max_len,
                                                      **opts))
    with torch.no_grad():
        return torch.export.export(program, (tb,), strict=False)


def graph_ops(program) -> Dict[str, int]:
    """The custom-op calls in the graph of ``program`` (an ExportedProgram,
    or a graph module such as a ``while_loop`` body), by op name."""
    ops: Dict[str, int] = {}
    for node in program.graph.nodes:
        name = getattr(node.target, "name", None)
        if node.op == "call_function" and callable(name) \
                and name().startswith(NAMESPACE + "::"):
            op = name().split("::", 1)[1].split(".", 1)[0]
            ops[op] = ops.get(op, 0) + 1
    return ops


def _is_export_archive(path: str) -> bool:
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as z:
        return any(n.endswith("archive_format") for n in z.namelist())


def read_sidecar(path: str) -> dict:
    """The ``<artifact>.json`` sidecar. Raises FileNotFoundError naming it
    when there is none."""
    side = path + ".json"
    if not os.path.exists(side):
        raise FileNotFoundError(f"no sidecar {side} beside the artifact "
                                f"{path} (cli/export_model writes both)")
    with open(side, encoding="utf-8") as f:
        return json.load(f)


def check_platform(platforms: List[str], device) -> None:
    """Raise RuntimeError unless the artifact was traced for ``device``'s
    type."""
    plats = [p.lower() for p in platforms]
    kind = torch.device(device).type
    if plats and kind not in plats:
        raise RuntimeError(f"artifact was exported for platform(s) {plats}, "
                           f"this process runs on {kind!r}: re-export on the "
                           "target platform")


class ExportedPredict:
    """A loaded artifact. ``call(batch)`` takes numpy arrays or tensors,
    moves them to the program's device and returns its output dict of
    tensors there. ``platforms``: the device types it was traced for."""

    def __init__(self, program: torch.export.ExportedProgram,
                 platforms: List[str]):
        self.platforms = list(platforms)
        self.device = resolve_device(self.platforms[0])
        self._module = program.module()

    def call(self, batch: dict) -> Dict[str, torch.Tensor]:
        batch = batch_to_device(batch, self.device)
        with torch.inference_mode():
            return self._module(batch)


def load_exported(path: str, platforms: Optional[List[str]] = None
                  ) -> ExportedPredict:
    """Load an archive written by ``cli/export_model``. ``platforms``
    (default: the sidecar's) names the device the program was traced on;
    it must be present here. Raises ValueError naming ``path`` if it is not
    a ``torch.export`` archive (a JAX StableHLO ``.shlo`` is not one)."""
    if not os.path.isfile(path) or not _is_export_archive(path):
        raise ValueError(f"{path} is not a torch.export archive (the JAX "
                         "package's StableHLO artifacts cannot be served by "
                         "the port); export one with python -m "
                         "case_rg_tpu_torch.cli.export_model")
    if platforms is None:
        platforms = read_sidecar(path)["platforms"]
    resolve_device(platforms[0])     # no card: raise before a load of seconds
    return ExportedPredict(torch.export.load(path), platforms)
