"""Data parallelism over several cards (port of the data axis of
``case_rg_tpu/runtime/mesh.py``).

The JAX package shards each batch over the 'data' axis of a
``('data', 'model')`` mesh and lets XLA insert the gradient all-reduce; with
``--multihost`` each process feeds its own rows. The port runs PyTorch's
own layout for the same thing, one process per card started by
``torchrun`` (the reference's ``torch.distributed.launch``, run.sh:21):

* ``init_distributed`` joins the process group that torchrun's environment
  describes (NCCL with a card a rank, gloo on the CPU or with more ranks
  than cards) and a second, gloo group
  over the same ranks for host-side agreement (``agree``: a flag reduced
  without touching the card);
* ``global_batch`` makes the losses of ``models/base.py`` the loss of the
  global batch: each loss's denominator (token or element count) is summed
  over the ranks before it divides the rank's numerator, so the gradients
  summed over the ranks (``all_reduce_sum``) are the gradient of the global
  batch's loss, as under the JAX package's sharded program, not a mean of
  rank means as DDP would take;
* ``broadcast`` copies rank 0's tensors to every rank (the initial and the
  resumed state), ``check_replicas`` holds the ranks' states equal bit for
  bit.

Without a process group every function is the single-process identity:
``process_index()`` 0, ``process_count()`` 1, no collective.

Not ported yet (ROADMAP Queue 1 item 7b): the 'model' axis, i.e. the pool
axis sharded over cards (``pool_sharding``, ``shard_batch(pool_axis=True)``)
and vocabulary-dimension sharding (``param_sharding_tree``), and the
serving mesh over a host's cards. ``parse_mesh_shape`` refuses a model
axis above 1.
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")
_HOST_GROUP = None          # gloo group over every rank, for host flags
_OWNED = False              # init_distributed made the default group
_DEVICE: Optional[torch.device] = None
_LOSS_GROUP = False         # inside global_batch(): losses are global
MODEL_AXIS_ITEM = "ROADMAP Queue 1 item 7b"


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    return dist.get_world_size() if is_distributed() else 1


def local_device() -> Optional[torch.device]:
    """The card of this rank (``cuda:LOCAL_RANK``) once
    ``init_distributed`` ran on the card, else None."""
    return _DEVICE


def init_distributed(device="cuda", timeout_s: float = 1800.0
                     ) -> torch.device:
    """Join the process group that torchrun's environment describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR/PORT``) and
    return this rank's device. On ``cuda`` with a card a rank (the host's
    ranks, ``LOCAL_WORLD_SIZE``, no more than its cards) the backend is
    NCCL, on ``cuda:LOCAL_RANK``, set as the current device before
    anything touches the card; with more ranks than cards it is gloo,
    which carries CUDA tensors through the host, the ranks sharing the
    cards (LOCAL_RANK modulo the cards). On ``cpu`` it is gloo. Raises
    without torchrun's environment (never a quiet world of one), without a
    card for ``cuda`` and without NCCL for an NCCL group."""
    global _HOST_GROUP, _OWNED, _DEVICE
    missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--multihost: {', '.join(missing)} not set; start every rank "
            "with torchrun (torchrun --nproc_per_node N -m "
            "case_rg_tpu_torch.cli.run --multihost ...)")
    dev = torch.device(device)
    backend = "gloo"
    local = int(os.environ["LOCAL_RANK"])
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--multihost on cuda: torch sees no CUDA "
                               "device; pass --device cpu for a gloo group "
                               "on the CPU")
        n = torch.cuda.device_count()
        ranks_here = int(os.environ.get("LOCAL_WORLD_SIZE",
                                        os.environ["WORLD_SIZE"]))
        if ranks_here <= n:
            if not dist.is_nccl_available():
                raise RuntimeError("--multihost on cuda: this torch has no "
                                   "NCCL")
            backend = "nccl"
        elif local == 0:
            print(f"[mesh] {ranks_here} ranks on {n} card(s): gloo, the "
                  "ranks sharing the cards", flush=True)
        dev = torch.device("cuda", local % n)
        torch.cuda.set_device(dev)
    if is_distributed():
        raise RuntimeError("init_distributed: a process group already exists")
    timeout = datetime.timedelta(seconds=timeout_s)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method="env://", timeout=timeout,
                            **kw)
    _OWNED = True
    _HOST_GROUP = dist.new_group(backend="gloo", timeout=timeout) \
        if backend != "gloo" else dist.group.WORLD
    _DEVICE = dev if dev.type == "cuda" else None
    return dev


def shutdown() -> None:
    """Leave the group that ``init_distributed`` made (a no-op otherwise)."""
    global _HOST_GROUP, _OWNED, _DEVICE
    if _OWNED and is_distributed():
        dist.destroy_process_group()
    _HOST_GROUP, _OWNED, _DEVICE = None, False, None


def parse_mesh_shape(spec: str, world: Optional[int] = None
                     ) -> Tuple[int, int]:
    """``"D"`` or ``"D,M"`` -> (D, M). D must equal the world size (the
    ranks torchrun started, 1 without a group); a model axis M above 1 is
    refused (pool and vocabulary sharding: ROADMAP Queue 1 item 7b)."""
    world = process_count() if world is None else world
    try:
        dims = tuple(int(x) for x in spec.split(",") if x.strip())
    except ValueError:
        raise ValueError(f"--mesh_shape {spec!r}: not 'D' or 'D,M'")
    if not 1 <= len(dims) <= 2 or min(dims) < 1:
        raise ValueError(f"--mesh_shape {spec!r}: not 'D' or 'D,M'")
    d, m = dims[0], (dims[1] if len(dims) == 2 else 1)
    if m > 1:
        raise ValueError(f"--mesh_shape {spec!r}: a 'model' axis above 1 "
                         f"(pool or vocabulary sharding) is not ported yet "
                         f"({MODEL_AXIS_ITEM})")
    if d != world:
        raise ValueError(f"--mesh_shape {spec!r}: the data axis {d} is not "
                         f"the world size {world} (one rank a card, started "
                         f"by torchrun --nproc_per_node)")
    return d, m


# ---- collectives of the data-parallel step ----

@contextlib.contextmanager
def global_batch():
    """Inside the block, the losses of ``models/base.py`` divide by their
    denominators summed over the ranks (``batch_denominator``). Every rank
    must run the same losses in the same order inside it."""
    global _LOSS_GROUP
    saved, _LOSS_GROUP = _LOSS_GROUP, is_distributed()
    try:
        yield
    finally:
        _LOSS_GROUP = saved


def batch_denominator(den: torch.Tensor) -> torch.Tensor:
    """A loss's local denominator, summed over the ranks inside
    ``global_batch`` (one small all-reduce, no host sync); unchanged
    otherwise."""
    if not _LOSS_GROUP:
        return den
    den = den.detach().float().clone()
    dist.all_reduce(den)
    return den


def rank_share(value: float) -> float:
    """A loss's constant term as this rank's share of it inside
    ``global_batch`` (all of it on rank 0, none elsewhere), so that the
    rank losses sum to the global one."""
    return value if not _LOSS_GROUP or process_index() == 0 else 0.0


def all_reduce_sum(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors summed over the ranks: one all-reduce of one flat f32
    buffer (new tensors in the inputs' shapes and dtypes)."""
    if not is_distributed():
        return tensors
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape).to(t.dtype))
        i += t.numel()
    return out


def broadcast(tensors: Iterable[torch.Tensor], src: int = 0) -> None:
    """Copy rank ``src``'s tensors into every rank's, in place (one
    broadcast of a flat buffer a dtype)."""
    if not is_distributed():
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for ts in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in ts])
            dist.broadcast(flat, src)
            i = 0
            for t in ts:
                t.copy_(flat[i:i + t.numel()].view(t.shape))
                i += t.numel()


def agree(flag: bool) -> bool:
    """True on every rank if ``flag`` is set on any (a MAX over the host
    group: no device work, no wait on the card)."""
    if not is_distributed():
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_HOST_GROUP)
    return bool(t.item())


def barrier() -> None:
    """Wait for every rank (over the host group); a no-op without one."""
    if is_distributed():
        dist.barrier(group=_HOST_GROUP)


def checksum(tensors: Iterable[torch.Tensor]) -> int:
    """An integer over the tensors' bits (each as int32 words, summed in
    int64), equal on two ranks whose tensors are equal bit for bit."""
    total = torch.zeros((), dtype=torch.int64)
    for t in tensors:
        b = t.detach().contiguous().reshape(-1)
        w = b.view(torch.int32) if b.element_size() == 4 else \
            b.view(torch.int16)
        total = total + (w.long() * torch.arange(
            1, w.numel() + 1, device=w.device) % 1000003).sum().cpu()
    return int(total)


def check_replicas(tensors: Iterable[torch.Tensor], what: str) -> int:
    """Raise unless every rank's tensors are bit-identical (their
    ``checksum`` gathered over the host group); returns the checksum."""
    mine = checksum(tensors)
    if not is_distributed():
        return mine
    sums = [None] * process_count()
    dist.all_gather_object(sums, mine, group=_HOST_GROUP)
    if len(set(sums)) != 1:
        raise RuntimeError(f"{what}: the ranks' replicas differ (checksums "
                           f"{sums})")
    return mine
