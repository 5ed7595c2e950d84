"""High-level in-process inference API (port of
``case_rg_tpu/pipeline.py``).

A ``Pipeline`` wraps featurization, the predict program and
detokenization behind one object, so host applications embed the model
without the CLI:

    from case_rg_tpu_torch.pipeline import Pipeline

    p = Pipeline.from_checkpoint("case", output_path="./output/case",
                                 prepared_dir="./dataset/cast/prepared",
                                 epoch="best", batch_size=8, bf16=True)
    out = p(query="what is kinetic energy ?",
            passages=["kinetic energy is the energy of motion ."])
    out["answer"], out.get("ranking")

    # or a whole batch of request dicts (the serving JSONL schema):
    outs = p.batch([{"query": ..., "passages": [...],
                     "history": [...], "max_tokens": 20}, ...])

Requests use the serving schema (``cli/serve.py`` docstring): ``query``,
``passages``, optional ``history`` / ``max_tokens``. Outputs match serving:
``answer`` and best-first ``ranking`` indices. Featurization is the
serving code path (``serving/featurize.chunk_to_batch``), so library,
offline and served results agree. The weights are loaded, cast and moved
to the card once, in ``from_checkpoint``; the card is the default and
``device="cpu"`` runs on the CPU. ``from_export`` serves a
``torch.export`` archive written by ``cli/export_model.py``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np


class Pipeline:
    """Featurize -> predict -> detokenize for one model.

    Build with :meth:`from_checkpoint` or :meth:`from_export`. Calls from
    several threads must be serialized by the caller (or use
    ``cli/serve.py``, whose dispatcher owns all device work).
    """

    def __init__(self, *, model_name, vocab, dcfg, run_predict, batch_size,
                 provenance):
        self._model_name = model_name
        self._vocab = vocab
        self._detok = vocab.detokenizer()
        self._dcfg = dcfg
        self._run_predict = run_predict
        self._batch_size = int(batch_size)
        self.provenance = dict(provenance)   # model/epoch/dtype/source

    # ------------------------------------------------------------------
    @classmethod
    def from_checkpoint(cls, model: str, *, output_path: str,
                        prepared_dir: str, epoch=None, batch_size: int = 8,
                        bf16: bool = False, ema: bool = False,
                        rank_only: bool = False, beam_width: int = 1,
                        decoding: str = "greedy", sample_seed: int = 123456,
                        temperature: float = 1.0, top_k: int = 0,
                        top_p: float = 1.0, early_exit: bool = True,
                        fast_argmax=None,
                        embedding_size: int = 256, hidden_size: int = 256,
                        num_heads: int = 8, max_target_length: int = 40,
                        query_len: int = 60, passage_len: int = 100,
                        num_passage: int = 10, min_window_size: int = 4,
                        num_windows: int = 1,
                        device="cuda") -> "Pipeline":
        """Load a trained checkpoint (the port's ``{epoch}.pt`` or the JAX
        package's ``{epoch}.ckpt``) onto ``device`` and build the predict
        program. Raises without a card unless ``device="cpu"``.

        As the JAX pipeline's serving mesh, each batch splits by rows over
        a replica of the model a device of a comma list ("cuda:0,cuda:1",
        "cpu,cpu"); the first d serve, d = gcd(``batch_size``, the
        devices) (``runtime/replicas.py``). "cuda" is one card.

        ``epoch``: int, ``"best"`` (model/best.json from --dev_eval
        training), ``"avg"`` (run --mode avg), or None for the latest.
        Model/data dims must match training (same flags as cli/serve.py).
        """
        import argparse

        from .cli.serve import load_model
        from .config import DataConfig
        from .data.vocab import Vocabulary
        from .device import resolve_devices
        from .runtime.inference import make_replicated_predict
        from .runtime.replicas import Replicas
        from .train.checkpoint import (best_epoch, checkpoint_exists,
                                       latest_epoch)

        groups = resolve_devices(device, [batch_size])
        vocab = Vocabulary.load(os.path.join(prepared_dir, "vocab.txt"))
        dcfg = DataConfig(query_len=query_len, passage_len=passage_len,
                          num_passage=num_passage,
                          answer_len=max_target_length,
                          min_window_size=min_window_size,
                          num_windows=num_windows)
        if epoch is None:
            epoch = latest_epoch(output_path)
        elif epoch == "best":
            epoch = best_epoch(output_path)
            if epoch is None:
                raise FileNotFoundError(
                    f"epoch='best': no model/best.json under {output_path} "
                    "(train with --dev_eval)")
        elif epoch != "avg":
            epoch = int(epoch)
        if epoch is None or not checkpoint_exists(output_path, epoch):
            raise FileNotFoundError(f"no checkpoint for epoch {epoch!r} "
                                    f"under {output_path}/model")

        # the serving CLI's loader: built, loaded and cast once
        mcfg, net = load_model(argparse.Namespace(
            model=model, output_path=output_path, device=device, bf16=bf16,
            ema=ema, embedding_size=embedding_size, hidden_size=hidden_size,
            num_heads=num_heads, max_target_length=max_target_length,
            beam_width=beam_width, min_window_size=min_window_size,
            num_windows=num_windows), vocab, epoch)
        predict_fn = make_replicated_predict(
            Replicas(net, groups), mcfg, max_target_length,
            beam_width=beam_width, early_exit=early_exit,
            fast_argmax=fast_argmax, decoding=decoding,
            sample_seed=sample_seed, temperature=temperature, top_k=top_k,
            top_p=top_p, rank_only=rank_only)

        def run_predict(batch):
            return predict_fn(batch).get()

        return cls(model_name=model, vocab=vocab, dcfg=dcfg,
                   run_predict=run_predict, batch_size=batch_size,
                   provenance={"source": "checkpoint", "model": model,
                               "epoch": str(epoch),
                               "dtype": "bfloat16" if bf16 else "float32"})

    # ------------------------------------------------------------------
    @classmethod
    def from_export(cls, artifact: str, *, prepared_dir: str,
                    device="cuda") -> "Pipeline":
        """Serve a ``torch.export`` archive written by
        ``cli/export_model.py``: the parameters are inside it, so no model
        code or checkpoint is touched. Model name, batch size, answer length
        and data shapes come from the ``<artifact>.json`` sidecar
        (FileNotFoundError without one); an archive traced for another
        device type than ``device`` is refused (RuntimeError)."""
        from .config import DataConfig
        from .data.vocab import Vocabulary
        from .device import resolve_device
        from .runtime.continuous.base import HostCopy
        from .runtime.exported import (check_platform, load_exported,
                                       read_sidecar)

        sidecar = read_sidecar(artifact)
        check_platform(sidecar.get("platforms", []), resolve_device(device))
        vocab = Vocabulary.load(os.path.join(prepared_dir, "vocab.txt"))
        d = sidecar["data"]
        dcfg = DataConfig(query_len=int(d["query_len"]),
                          passage_len=int(d["passage_len"]),
                          num_passage=int(d["num_passage"]),
                          answer_len=int(sidecar["max_target_length"]))
        art = load_exported(artifact, sidecar["platforms"])

        def run_predict(batch):
            out = art.call(batch)
            keys = list(out)
            return dict(zip(keys, HostCopy([out[k] for k in keys]).get()))

        return cls(model_name=sidecar["model"], vocab=vocab, dcfg=dcfg,
                   run_predict=run_predict,
                   batch_size=int(sidecar["batch_size"]),
                   provenance={"source": "export", "model": sidecar["model"],
                               "epoch": str(sidecar.get("epoch")),
                               "dtype": sidecar.get("dtype", "float32")})

    # ------------------------------------------------------------------
    @property
    def model(self) -> str:
        return self._model_name

    @property
    def batch_size(self) -> int:
        return self._batch_size

    def __call__(self, query: str, passages: Sequence[str], *,
                 history: Sequence[str] = (),
                 max_tokens: Optional[int] = None) -> dict:
        """One request -> ``{"answer": ..., "ranking": [...]}``."""
        req: Dict = {"query": query, "passages": list(passages),
                     "history": list(history)}
        if max_tokens is not None:
            req["max_tokens"] = int(max_tokens)
        return self.batch([req])[0]

    def batch(self, requests: List[dict]) -> List[dict]:
        """Run request dicts (serving JSONL schema) through the model in
        ``batch_size`` chunks; returns one output dict per request, in
        input order."""
        from .runtime.io import ids_to_sentence, remove_duplicate
        from .serving.featurize import chunk_to_batch

        outs: List[dict] = []
        for start in range(0, len(requests), self._batch_size):
            chunk = requests[start:start + self._batch_size]
            batch = chunk_to_batch(chunk, self._model_name, self._vocab,
                                   self._dcfg, self._batch_size)
            out = self._run_predict(batch)
            sents = None
            if "answer" in out:
                ids = np.asarray(out["answer"])
                caps = [min(int(r["max_tokens"]), ids.shape[1])
                        if "max_tokens" in r else ids.shape[1]
                        for r in chunk]
                sents = [ids_to_sentence(row[:max(c, 1)], self._vocab)
                         for row, c in zip(ids, caps)]
                remove_duplicate(sents)
            for i, req in enumerate(chunk):
                resp: Dict = {}
                if sents is not None:
                    resp["answer"] = self._detok(sents[i])
                if "rank" in out:
                    scores = np.asarray(out["rank"][i])
                    n_real = min(len(req.get("passages", [])),
                                 self._dcfg.num_passage)
                    order = np.argsort(-scores[:max(n_real, 1)],
                                       kind="stable")
                    resp["ranking"] = [int(j) for j in order[:n_real]]
                outs.append(resp)
        return outs
