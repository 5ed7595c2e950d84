"""Checkpoints (port of ``case_rg_tpu/train/checkpoint.py``).

The port writes its own format: ``model/{epoch}.pt``, a torch file of
{"params", "ema"} state dicts (port parameter names, CPU tensors),
"step", and "opt_state", which stays None until the port's training loop
saves its optimiser. ``latest.json`` and ``best.json`` are the JSON
pointers the JAX package writes.

``load_checkpoint`` detects the format from what exists on disk, as the JAX
package does. It also reads the JAX package's ``model/{epoch}.ckpt``: the
flax msgpack of its ``TrainState`` (``params``, ``opt_state``, ``ema``,
``step``), decoded here by ``msgpack_restore``, a small reader of the
msgpack subset that ``flax.serialization.to_bytes`` writes, so neither
``msgpack`` nor ``flax`` is needed. Its ``params`` and ``ema`` trees go
through the weight bridge (``bridge.state_dict_from_jax``). An
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

# flax's msgpack extension types (flax/serialization.py, _MsgpackExtType)
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"


def _model_dir(output_path: str) -> str:
    d = os.path.join(output_path, "model")
    os.makedirs(d, exist_ok=True)
    return d


def _field(state, name):
    return state[name] if isinstance(state, dict) else getattr(state, name)


def _cpu_state_dict(sd) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in sd.items()}


def save_checkpoint(output_path: str, epoch, state: Any,
                    update_latest: bool = True) -> str:
    """Write ``state`` (a mapping or an object with ``params`` and ``ema``
    state dicts and an integer ``step``, e.g. the trainer's
    ``TrainState``) to ``model/{epoch}.pt``; returns the path.
    ``update_latest=False`` writes a salvage checkpoint without marking the
    epoch complete for resume."""
    d = _model_dir(output_path)
    path = os.path.join(d, f"{epoch}.pt")
    torch.save({"params": _cpu_state_dict(_field(state, "params")),
                "ema": _cpu_state_dict(_field(state, "ema")),
                "step": int(_field(state, "step")),
                "opt_state": None}, path)
    if update_latest:
        with open(os.path.join(d, "latest.json"), "w") as f:
            json.dump({"epoch": epoch}, f)
    return path


def latest_epoch(output_path: str) -> Optional[int]:
    p = os.path.join(output_path, "model", "latest.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)["epoch"]


def save_best(output_path: str, epoch: int, dev_total: float) -> None:
    """Record the best-dev-loss epoch (consumed by ``--epoch best`` at
    serving)."""
    d = os.path.join(output_path, "model")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "best.json"), "w") as f:
        json.dump({"epoch": epoch, "dev_total": dev_total}, f)


def best_epoch(output_path: str) -> Optional[int]:
    p = os.path.join(output_path, "model", "best.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)["epoch"]


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


def load_checkpoint(output_path: str, epoch) -> dict:
    """{"params", "ema"} (port parameter name -> CPU tensor), "step" and
    "opt_state" (the JAX optimiser tree as decoded, or None) of epoch
    ``epoch``, from the port's ``{epoch}.pt`` or the JAX package's
    ``{epoch}.ckpt``, whichever exists."""
    d = os.path.join(output_path, "model")
    path = os.path.join(d, f"{epoch}.pt")
    if os.path.exists(path):
        return torch.load(path, map_location="cpu", weights_only=True,
                          mmap=True)
    path = os.path.join(d, f"{epoch}.ckpt")
    if os.path.exists(path):
        with open(path, "rb") as f:
            tree = msgpack_restore(f.read())

        def params(name):
            return {k: torch.from_numpy(np.array(v, np.float32))
                    for k, v in state_dict_from_jax(
                        _f32_tree(tree[name])).items()}
        step = tree.get("step")
        return {"params": params("params"), "ema": params("ema"),
                "step": None if step is None else int(np.asarray(step)),
                "opt_state": tree.get("opt_state")}
    if os.path.isdir(os.path.join(d, f"{epoch}.orbax")):
        raise SystemExit(f"{path[:-5]}.orbax: orbax checkpoints are not read "
                         "by the port (ROADMAP: open items); save with the "
                         "msgpack backend")
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
