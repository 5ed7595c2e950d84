"""Checkpoints (port of ``case_rg_tpu/train/checkpoint.py``).

The port writes its own format: ``model/{epoch}.pt``, a torch file of
{"params", "ema"} state dicts (port parameter names, CPU tensors), "step"
and "opt_state": the trainer's Adam moments {"mu", "nu"} (state dicts),
"count" (updates applied) and "mini_step" (calls since the last update),
and with gradient accumulation the running mean "acc" (see
``train/trainer.TrainState``). A state without moments (serving's
``{"params", "ema", "step"}``) is written with "opt_state" None. Each file
is written under a temporary name and renamed, so a crash mid-write leaves
no half checkpoint for resume to find. ``latest.json`` and ``best.json``
are the JSON pointers the JAX package writes; salvage checkpoints
(``{epoch}.preempt``, ``{epoch}.mid``) and ``avg`` are written with
``update_latest=False``. In a process group (``runtime/mesh``) only rank 0
writes, and every rank waits at a barrier until it has; every rank reads.

``load_checkpoint`` detects the format from what exists on disk, as the JAX
package does. It also reads the JAX package's ``model/{epoch}.ckpt``: the
flax msgpack of its ``TrainState`` (``params``, ``opt_state``, ``ema``,
``step``), decoded here by ``msgpack_restore``, a small reader of the
msgpack subset that ``flax.serialization.to_bytes`` writes, so neither
``msgpack`` nor ``flax`` is needed. Its ``params`` and ``ema`` trees go
through the weight bridge (``bridge.state_dict_from_jax``), and its optax
state is mapped onto the port's fields (``_jax_opt_state``). An
``{epoch}.orbax`` directory (the JAX package's other backend) is not read.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Optional

import numpy as np
import torch

from ..bridge import state_dict_from_jax
from ..runtime import mesh

# flax's msgpack extension types (flax/serialization.py, _MsgpackExtType)
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


def _field(state, name, default=None):
    if isinstance(state, dict):
        return state.get(name, default)
    return getattr(state, name, default)


def _cpu_state_dict(sd) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in sd.items()}


def _opt_state(state) -> Optional[dict]:
    """The optimiser's part of ``state`` as saved, or None without moments."""
    mu = _field(state, "mu")
    if mu is None:
        return None
    out = {"mu": _cpu_state_dict(mu), "nu": _cpu_state_dict(_field(state, "nu")),
           "count": int(_field(state, "count")),
           "mini_step": int(_field(state, "mini_step", 0))}
    acc = _field(state, "acc")
    if acc is not None:
        out["acc"] = _cpu_state_dict(acc)
    return out


def save_checkpoint(output_path: str, epoch, state: Any,
                    update_latest: bool = True) -> str:
    """Write ``state`` (the trainer's ``TrainState``, or a mapping with
    ``params`` and ``ema`` state dicts, an integer ``step`` and optionally
    the optimiser fields) to ``model/{epoch}.pt``; returns the path.
    ``update_latest=False`` writes a salvage checkpoint without marking the
    epoch complete for resume."""
    d = os.path.join(output_path, "model")
    path = os.path.join(d, f"{epoch}.pt")
    if mesh.process_index() == 0:
        os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        torch.save({"params": _cpu_state_dict(_field(state, "params")),
                    "ema": _cpu_state_dict(_field(state, "ema")),
                    "step": int(_field(state, "step")),
                    "opt_state": _opt_state(state)}, tmp)
        os.replace(tmp, path)
        if update_latest:
            with open(os.path.join(d, "latest.json"), "w") as f:
                json.dump({"epoch": epoch}, f)
    mesh.barrier()
    return path


def latest_epoch(output_path: str) -> Optional[int]:
    p = os.path.join(output_path, "model", "latest.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)["epoch"]


def save_best(output_path: str, epoch: int, dev_total: float) -> None:
    """Record the best-dev-loss epoch (written by ``Trainer.fit`` whenever
    the per-epoch dev loss improves; consumed by ``--epoch best`` at
    serving and ``run --mode test --best_only``)."""
    d = os.path.join(output_path, "model")
    if mesh.process_index() == 0:
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "best.json"), "w") as f:
            json.dump({"epoch": epoch, "dev_total": dev_total}, f)
    mesh.barrier()


def best_epoch(output_path: str) -> Optional[int]:
    rec = best_epoch_record(output_path)
    return None if rec is None else rec[1]


def best_epoch_record(output_path: str) -> Optional[tuple]:
    """(dev_total, epoch) of ``model/best.json``, or None."""
    p = os.path.join(output_path, "model", "best.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        rec = json.load(f)
    return rec["dev_total"], rec["epoch"]


def checkpoint_exists(output_path: str, epoch) -> bool:
    d = os.path.join(output_path, "model")
    return any(os.path.exists(os.path.join(d, f"{epoch}.{ext}"))
               for ext in ("pt", "ckpt")) or \
        os.path.isdir(os.path.join(d, f"{epoch}.orbax"))


def _f32_tree(tree):
    """A param tree with bfloat16 tensor leaves as f32 numpy (the bridge
    reads numpy)."""
    if isinstance(tree, dict):
        return {k: _f32_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return tree


def _port_state_dict(tree) -> dict:
    """A JAX param-shaped tree (params, EMA, an Adam moment, accumulated
    gradients) as a port state dict of f32 CPU tensors."""
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in state_dict_from_jax(_f32_tree(tree)).items()}


def _jax_opt_state(opt) -> Optional[dict]:
    """The JAX package's optax state (``make_optimizer``: ``chain(
    clip_by_global_norm, adam(schedule))``, wrapped in ``MultiSteps`` when
    accumulating; as decoded: tuples become {"0", "1"} maps, empty states
    {}) mapped onto the port's "mu", "nu", "count", "mini_step" and, under
    ``MultiSteps``, "acc". Adam's count, the schedule's count and
    ``MultiSteps``' gradient_step must agree: the port keeps one count."""
    if opt is None or opt == {}:
        return None
    out = {"mini_step": 0}
    counts = []
    if "inner_opt_state" in opt:            # optax.MultiSteps
        out["mini_step"] = int(np.asarray(opt["mini_step"]))
        counts.append(int(np.asarray(opt["gradient_step"])))
        out["acc"] = _port_state_dict(opt["acc_grads"])
        opt = opt["inner_opt_state"]
    try:
        clip, adam = opt["0"], opt["1"]
        moments, schedule = adam["0"], adam["1"]
        if clip not in ({}, None) or set(moments) != {"count", "mu", "nu"} \
                or set(schedule) != {"count"}:
            raise KeyError
    except (KeyError, TypeError):
        raise ValueError(
            "checkpoint: the JAX opt_state is not make_optimizer's "
            "chain(clip_by_global_norm, adam(schedule)) (optionally in "
            f"MultiSteps); keys {sorted(opt) if isinstance(opt, dict) else opt!r}")
    counts += [int(np.asarray(moments["count"])),
               int(np.asarray(schedule["count"]))]
    if len(set(counts)) != 1:
        raise ValueError(f"checkpoint: the JAX optimiser's counts disagree "
                         f"({counts}); the port keeps one count")
    out.update(count=counts[0], mu=_port_state_dict(moments["mu"]),
               nu=_port_state_dict(moments["nu"]))
    return out


def load_checkpoint(output_path: str, epoch) -> dict:
    """{"params", "ema"} (port parameter name -> CPU tensor), "step" and
    "opt_state" (the port's optimiser fields, or None) of epoch ``epoch``,
    from the port's ``{epoch}.pt`` or the JAX package's ``{epoch}.ckpt``,
    whichever exists."""
    d = os.path.join(output_path, "model")
    path = os.path.join(d, f"{epoch}.pt")
    if os.path.exists(path):
        return torch.load(path, map_location="cpu", weights_only=True,
                          mmap=True)
    path = os.path.join(d, f"{epoch}.ckpt")
    if os.path.exists(path):
        with open(path, "rb") as f:
            tree = msgpack_restore(f.read())
        step = tree.get("step")
        return {"params": _port_state_dict(tree["params"]),
                "ema": _port_state_dict(tree["ema"]),
                "step": None if step is None else int(np.asarray(step)),
                "opt_state": _jax_opt_state(tree.get("opt_state"))}
    if os.path.isdir(os.path.join(d, f"{epoch}.orbax")):
        raise SystemExit(f"{path[:-5]}.orbax: orbax checkpoints are not read "
                         "by the port (ROADMAP Queue 1 item 2, orbax "
                         "checkpoint directories); save with the msgpack "
                         "backend")
    raise FileNotFoundError(f"no checkpoint for epoch {epoch!r} under {d}")


# ---- flax msgpack, read without msgpack or flax ----

def _ndarray(payload: bytes):
    """flax's ndarray extension: a msgpack (shape, dtype name, C-order
    bytes). bfloat16, which numpy lacks, comes back as a torch tensor."""
    shape, name, buf = _Reader(payload).read()
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        flat = np.frombuffer(buf, dtype=np.uint16)
        return torch.from_numpy(flat.copy()).view(torch.bfloat16).reshape(
            tuple(shape))
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(tuple(shape))


def _unchunk(tree):
    """Arrays over flax's MAX_CHUNK_SIZE are stored as {"__msgpack_chunked_
    array__": True, "shape": {"0": ...}, "chunks": {"0": flat, ...}}."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


class _Reader:
    """Decoder of one msgpack value: maps, arrays, str, bin, ints,
    floats, nil, bools and flax's extensions 1 (ndarray) and 3 (numpy
    scalar)."""

    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def _take(self, n: int):
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("msgpack: truncated data")
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self._take(struct.calcsize(fmt)))[0]

    def _ext(self, n: int):
        code = self._unpack("b")
        payload = bytes(self._take(n))
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            arr = _ndarray(payload)
            return arr.reshape(()) if isinstance(arr, torch.Tensor) \
                else arr[()]
        raise ValueError(f"msgpack: unknown extension type {code}")

    def read(self):
        b = self._unpack("B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self._take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: "B", 0xC5: "H", 0xC6: "I",        # bin
                 0xD9: "B", 0xDA: "H", 0xDB: "I",        # str
                 0xDC: "H", 0xDD: "I",                   # array
                 0xDE: "H", 0xDF: "I",                   # map
                 0xC7: "B", 0xC8: "H", 0xC9: "I"}        # ext
        if b in sized:
            n = self._unpack(sized[b])
            if b <= 0xC6:
                return bytes(self._take(n))
            if b >= 0xD9 and b <= 0xDB:
                return str(self._take(n), "utf-8")
            if b in (0xDC, 0xDD):
                return [self.read() for _ in range(n)]
            if b in (0xDE, 0xDF):
                return self._map(n)
            return self._ext(n)
        if 0xD4 <= b <= 0xD8:                            # fixext 1..16
            return self._ext(1 << (b - 0xD4))
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
                   0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self._unpack(numbers[b])
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def msgpack_restore(data: bytes):
    """The tree that ``flax.serialization.msgpack_restore`` returns for
    ``data``: dicts, lists, Python scalars, numpy arrays and scalars
    (bfloat16 ones as torch tensors), chunked arrays joined."""
    r = _Reader(data)
    tree = r.read()
    if r.pos != len(r.buf):
        raise ValueError("msgpack: trailing bytes after the value")
    return _unchunk(tree)
