"""The ``data`` axis over ``torch.distributed`` (port of
``sota_imagenet_tpu/parallel/mesh.py``:1-45 and the multi-host init of
``cli.py``:73-74).

The JAX step is one program over a global batch sharded on the mesh's
``data`` axis, so every reduction over the batch axis is global wherever it
stands (mesh.py:1-12). The port runs one process per rank; rank r holds rows
[r*B/N, (r+1)*B/N) of the global batch of B rows, and each reduction over
the batch is made global by hand with the collectives below: the BatchNorm
statistics (``models/norms.py``), the whole-tensor statistics of VarEMA and
EstimatedABN, the sphere head's BatchNorm and AdaCos's batch terms
(``losses/angular.py``), the mixup partner and the accumulation's
microbatches, the gradients and the metrics (``train/steps.py``,
``train/loop.py``), FixMatch's partner rows (``losses/wrappers.py``). So N ranks compute what one process computes on the
global batch.

The collectives are built from ``all_reduce`` and ``broadcast`` only, so one
code path runs on NCCL, on gloo over CPU tensors and on gloo over CUDA
tensors (ranks that share one card, where NCCL refuses the duplicate
device). Without a process group each of them is the identity of one rank.

``STATS`` counts each kind of collective and its bytes; with
``STATS.timed`` set it also sums their host seconds, each collective
between two synchronisations of its device.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Optional

import torch
import torch.distributed as dist
from torch._utils import _unflatten_dense_tensors

from sota_imagenet_tpu_torch.utils.misc import process_count, process_index

# torchrun's environment: the counterpart of JAX_COORDINATOR_ADDRESS (cli.py:73-74 of the JAX package)
LAUNCHER_KEYS = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def distributed() -> bool:
    """Whether a process group is up (even one of one rank: its collectives run)."""
    return dist.is_available() and dist.is_initialized()


def choose_backend(device_type: str, local_world: int, gpus: int) -> str:
    """``nccl`` when each of the ``local_world`` ranks of this host has a GPU
    of its own; ``gloo`` on the CPU, and when ranks share a card (NCCL
    refuses two ranks on one device: "Duplicate GPU detected")."""
    if device_type != "cuda" or gpus < max(int(local_world), 1):
        return "gloo"
    return "nccl"


def init_distributed(device=None) -> Optional[str]:
    """Join the process group that torchrun's environment describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) and
    return its backend; without that environment, None: the run is one rank.
    A group the caller set up already is kept. ``device``: the device the
    caller asked for (None means the card), which decides the backend."""
    if distributed():
        return dist.get_backend()
    if not all(k in os.environ for k in LAUNCHER_KEYS):
        return None
    device_type = torch.device("cuda" if device is None else device).type
    gpus = torch.cuda.device_count() if device_type == "cuda" else 0
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
    backend = choose_backend(device_type, local_world, gpus)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")) % gpus)
    dist.init_process_group(backend, rank=int(os.environ["RANK"]), world_size=int(os.environ["WORLD_SIZE"]))
    return backend


def data_axis(spec: int, world: int) -> int:
    """``mesh.data`` against the ranks: -1 means all of them; any other value
    must equal them (``create_mesh``, mesh.py:42-43 of the JAX package)."""
    if int(spec) in (-1, int(world)):
        return int(world)
    raise ValueError(f"mesh.data={spec} does not match the {world} ranks of this run (use -1 or {world})")


def rank_seed(seed: int) -> int:
    """``seed`` with this rank folded in: rank 0 keeps it, so one process draws as before."""
    return int(seed) + 1_000_003 * process_index()


class CollectiveStats:
    """Calls, bytes and (with ``timed``) host seconds of the collectives, by kind."""

    def __init__(self):
        self.timed = False
        self.reset()

    def reset(self) -> None:
        self.calls: Dict[str, int] = defaultdict(int)
        self.bytes: Dict[str, int] = defaultdict(int)
        self.seconds: Dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def record(self, kind: str, t: torch.Tensor):
        sync = self.timed and t.is_cuda
        if sync:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        yield
        if sync:
            torch.cuda.synchronize(t.device)
        if self.timed:
            self.seconds[kind] += time.perf_counter() - t0
        self.calls[kind] += 1
        self.bytes[kind] += t.numel() * t.element_size()

    def as_dict(self) -> dict:
        return {k: {"calls": self.calls[k], "bytes": self.bytes[k], "seconds": self.seconds.get(k)} for k in self.calls}


STATS = CollectiveStats()


def all_reduce_(t: torch.Tensor, kind: str) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place."""
    if distributed():
        with STATS.record(kind, t):
            dist.all_reduce(t)
    return t


def broadcast_(t: torch.Tensor, src: int, kind: str) -> torch.Tensor:
    """``t`` of rank ``src`` on every rank, in place."""
    if distributed():
        with STATS.record(kind, t):
            dist.broadcast(t, src)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kind):
        ctx.kind = kind
        return all_reduce_(x.clone(), kind)

    @staticmethod
    def backward(ctx, grad):
        # each rank's loss reaches the sum: its cotangent is the sum of theirs (as SyncBatchNorm's backward)
        return all_reduce_(grad.contiguous().clone(), ctx.kind + "_backward"), None


def all_reduce_sum(x: torch.Tensor, kind: str = "stats") -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable: the backward is the
    sum over the ranks of the cotangent."""
    if not distributed():
        return x
    return _AllReduceSum.apply(x.contiguous(), kind)


def gather_rows(x: torch.Tensor, kind: str = "gather") -> torch.Tensor:
    """The ranks' ``x`` (equal shapes) stacked along dim 0 in rank order: an
    all-reduce of a zero-padded global buffer, summed as bytes, so every
    value arrives bit for bit. Not differentiable."""
    if not distributed():
        return x
    buf = x.new_zeros((process_count(), *x.shape))
    buf[process_index()] = x.detach()
    all_reduce_(buf.view(torch.uint8), kind)
    return buf.flatten(0, 1) if x.dim() else buf


def global_rows(x: torch.Tensor, lo: int, hi: int, kind: str = "rows") -> torch.Tensor:
    """Rows [lo, hi) of the global batch whose rank r holds rows [r*b, (r+1)*b)
    as ``x``: an all-reduce of a zero-padded (hi - lo)-row buffer, summed as
    bytes, so only those rows cross ranks and every value arrives bit for bit.
    Not differentiable. One rank: ``x[lo:hi]``."""
    if not distributed():
        return x[lo:hi]
    b, r = x.shape[0], process_index()
    buf = x.new_zeros((hi - lo, *x.shape[1:]))
    s, e = max(lo, r * b), min(hi, (r + 1) * b)
    if s < e:
        buf[s - lo : e - lo] = x[s - r * b : e - r * b].detach()
    all_reduce_(buf.view(torch.uint8), kind)
    return buf


def mirror(x: torch.Tensor, kind: str = "mirror") -> torch.Tensor:
    """The rows of the global batch flipped, at this rank's rows: row i of rank
    r gets global row B-1-(r*b+i), which lives on rank N-1-r (the JAX
    ``images[::-1]``, steps.py:68-69). One rank: ``x.flip(0)``."""
    if not distributed():
        return x.flip(0)
    b, r = x.shape[0], process_index()
    return gather_rows(x, kind).flip(0)[r * b : (r + 1) * b]


def microbatch_rows(x: torch.Tensor, parts: int, kind: str = "microbatch") -> torch.Tensor:
    """This rank's share of each of ``parts`` contiguous chunks of the global
    batch, chunk after chunk: split into ``parts`` equal runs, the result's
    run k is rank r's 1/N of global microbatch k (the JAX step's reshape to
    (parts, B/parts), steps.py:274-277). One rank, or one part: ``x``."""
    world = process_count()
    if not distributed() or world == 1 or parts == 1:
        return x
    g = gather_rows(x, kind)
    if g.shape[0] % (parts * world):
        raise ValueError(f"global batch {g.shape[0]} does not split into {parts} microbatches over {world} ranks")
    return g.view(parts, world, g.shape[0] // (parts * world), *g.shape[1:])[:, process_index()].flatten(0, 1)


def flatten(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The tensors' values in one new 1-d buffer (never a view of one of them)."""
    return torch.cat([t.reshape(-1) for t in tensors])


def unflatten_(tensors: List[torch.Tensor], flat: torch.Tensor) -> None:
    """Copy ``flat`` (as ``flatten`` laid it out) back into the tensors."""
    torch._foreach_copy_(tensors, list(_unflatten_dense_tensors(flat, tensors)))


def average_(tensors: Iterable[Optional[torch.Tensor]], kind: str = "grad") -> None:
    """Replace each tensor by its mean over the ranks: one all-reduce of the
    flattened tensors per dtype (None entries are skipped)."""
    if not distributed():
        return
    world = process_count()
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = defaultdict(list)
    for t in tensors:
        if t is not None:
            by_dtype[t.dtype].append(t)
    for ts in by_dtype.values():
        unflatten_(ts, all_reduce_(flatten(ts), kind).div_(world))


def broadcast_object(obj, src: int = 0):
    """A picklable ``obj`` of rank ``src`` on every rank."""
    if not distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]


def barrier() -> None:
    if distributed():
        dist.barrier()


def global_mean(t: torch.Tensor, dim=None) -> torch.Tensor:
    """``t.mean(dim)`` over the global batch, for a ``dim`` that holds the
    batch axis (None: every axis), differentiable: the ranks' sums over
    ``dim`` summed, over the global count. One rank: ``t.mean(dim)``."""
    if process_count() == 1:
        return t.mean() if dim is None else t.mean(dim)
    local = t.sum() if dim is None else t.sum(dim)
    return all_reduce_sum(local, "stats") / ((t.numel() // max(local.numel(), 1)) * process_count())
