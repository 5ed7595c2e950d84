"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``. The
build happens at first use, from the sources in the checkout, into
``build/kernels/<name>-<hash>/`` at the repository root (``.gitignore``
lists ``build/``); the hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header builds anew.
``build_all()`` starts one ``nvcc`` per source, all at once. ``load`` builds
and loads each library once per process, under a lock of its own, so the
first calls of several threads (several ``cli/serve_multi`` backends)
wait for one build and share one handle.

Every launcher runs under ``on_input_card``: the C launchers launch on
the calling thread's current device (``allow_smem``'s ``cudaGetDevice``,
the launch itself), so the guard makes that the input's card, whichever
thread calls (``runtime/replicas.py`` runs a replica a thread). Launch
counters rise under ``COUNT_LOCK``, so they stay exact when several
replicas launch at once, and each launch of a serving kernel also goes
into the calling thread's own ``tally``: a CUDA graph's capture reads the
launches its thread recorded, whatever other replicas launch meanwhile.

Nothing here runs when the module is imported: the CPU tests import every
module, and this machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "kernels"
SOURCES = ("encoder_attention", "decoder_stack", "train_attention",
           "copy_argmax", "decode_attention", "additive_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
COUNT_LOCK = threading.Lock()       # every module's launch counters
_TALLY = threading.local()          # the calling thread's launches by name
_LOCKS: Dict[str, threading.Lock] = {}
_LOCKS_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on "
                           "PATH or set CUDA_HOME")
    return str(path)


def _build_dir(name: str) -> Path:
    """Keyed on the source, every header under csrc/ (a source may include
    any of them) and the flags."""
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}"


def _lib_path(name: str) -> Path:
    return _build_dir(name) / f"lib{name}.so"


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source, in parallel.
    Returns each library's compiler log (``-Xptxas -v``: registers, shared
    memory and spills per kernel). Raises if a build fails."""
    nvcc = _nvcc()
    procs = {}
    for name in names:
        lib = _lib_path(name)
        if lib.exists():
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = tempfile.NamedTemporaryFile(dir=lib.parent, suffix=".so",
                                          delete=False).name
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        (lib.parent / "build.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            Path(tmp).unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)   # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: build_log(name) for name in names}


def build_log(name: str) -> str:
    log = _build_dir(name) / "build.log"
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed:
    once per process, whatever the number of threads that ask first."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCKS_LOCK:
        lock = _LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LIBS.get(name)
        if lib is None:
            if not _lib_path(name).exists():
                build_all([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch function."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def on_input_card(fn):
    """``fn(x, ...)`` with ``x``'s card as the current device (entered
    only when another card is current: the exchange costs a few µs a
    launch)."""
    import torch

    @functools.wraps(fn)
    def launch(x, *args, **kw):
        if x.device.index == torch.cuda.current_device():
            return fn(x, *args, **kw)
        with torch.cuda.device(x.device):
            return fn(x, *args, **kw)
    return launch


def tally(name: str) -> None:
    """One launch of ``name`` in the calling thread's tally (its module's
    counter counts it too)."""
    d = _TALLY.__dict__
    d[name] = d.get(name, 0) + 1


def thread_tally() -> Dict[str, int]:
    """The calling thread's launches so far, by kernel name."""
    return dict(_TALLY.__dict__)
