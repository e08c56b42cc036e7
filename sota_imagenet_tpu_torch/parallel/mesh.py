"""The mesh over ``torch.distributed``: the ``data``, ``spatial`` and
``model`` axes (port of ``sota_imagenet_tpu/parallel/mesh.py`` and the
multi-host init of ``cli.py``:73-74).

The JAX step is one program over a global batch on a mesh of shape
(data, spatial, model), so every reduction over the batch axis is global
wherever it stands (mesh.py:1-12). The port runs one process per rank and
lays the ranks out as ``create_mesh`` lays the devices out:
rank = (d * spatial + s) * model + m. Each axis has a process group (and
``data_spatial``, the data x spatial ranks of one model index, has one), and
every collective below takes the axis it reduces over:

* **rows of the batch: ``data``.** Data rank d holds rows [d*B/D, (d+1)*B/D)
  of the global batch of B rows; every spatial and model rank of it holds the
  same rows. The mixup partner and the accumulation's microbatches
  (``mirror``, ``microbatch_rows``), AdaCos's batch terms and the sphere
  head's BatchNorm (``losses/angular.py``), FixMatch's partner rows
  (``losses/wrappers.py``), the loaders' shards and the metrics
  (``train/loop.py``) go over it.
* **BatchNorm statistics: ``data_spatial``** where a rank holds a band of H
  rows of its images (``parallel/spatial.py``), else ``data``
  (``models/norms.py``: ``group_moments``, VarEMA and EstimatedABN through
  ``global_mean``; ``Conv1x1BNStats``'s sums).
* **gradients:** summed over ``data_spatial`` (a spatial rank's gradient is
  its band's share) and divided by the data ranks; a replicated parameter's
  gradient under head TP is summed over the world and divided by the data
  and model ranks, since each model rank computes the same trunk gradient,
  which the card's non-deterministic kernels round apart (``parallel/tp.py``).
* **checkpoint writes, logging, the Profiler: rank 0 of the world.**

With ``spatial = model = 1`` the data axis is the world and every collective
is the one it was before the axes existed. So N data ranks compute what one
process computes on the global batch.

The collectives are built from ``all_reduce`` and ``broadcast`` only, so one
code path runs on NCCL, on gloo over CPU tensors and on gloo over CUDA
tensors (ranks that share one card, where NCCL refuses the duplicate
device). Without a process group each of them is the identity of one rank.

``STATS`` counts each kind of collective and its bytes; with
``STATS.timed`` set it also sums their host seconds, each collective
between two synchronisations of its device. Each collective is a span
``collective.<kind>`` (``utils/trace.py``) at the same boundary.
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

from sota_imagenet_tpu_torch.utils import trace
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


AXES = ("data", "spatial", "model")


class Mesh:
    """The ranks of a run as a (data, spatial, model) grid, rank =
    (d * spatial + s) * model + m (the JAX ``create_mesh`` reshapes its
    devices the same way, mesh.py:24-46), and this rank's process group of
    each axis: ``data``, ``spatial``, ``model``, ``data_spatial`` (the data x
    spatial ranks of one model index, in the order d * spatial + s) and
    ``world``. A group is None where it is the whole world (the default
    group) and absent where the axis has one rank."""

    def __init__(self, data: int, spatial: int, model: int, rank: int = 0):
        self.shape = {"data": data, "spatial": spatial, "model": model, "data_spatial": data * spatial,
                      "world": data * spatial * model}
        m, s, d = rank % model, (rank // model) % spatial, rank // (model * spatial)
        self.index = {"data": d, "spatial": s, "model": m, "data_spatial": d * spatial + s, "world": rank}
        self.groups: Dict[str, object] = {}

    def ranks(self, axis: str) -> List[List[int]]:
        """The world ranks of every group of ``axis``, each in the axis's order."""
        D, S, M = self.shape["data"], self.shape["spatial"], self.shape["model"]
        at = lambda d, s, m: (d * S + s) * M + m  # noqa: E731
        if axis == "data":
            return [[at(d, s, m) for d in range(D)] for s in range(S) for m in range(M)]
        if axis == "spatial":
            return [[at(d, s, m) for s in range(S)] for d in range(D) for m in range(M)]
        if axis == "model":
            return [[at(d, s, m) for m in range(M)] for d in range(D) for s in range(S)]
        if axis == "data_spatial":
            return [[at(d, s, m) for d in range(D) for s in range(S)] for m in range(M)]
        if axis == "world":
            return [list(range(D * S * M))]
        raise KeyError(f"unknown mesh axis {axis!r}; known: {AXES + ('data_spatial', 'world')}")


def create_mesh(data: int = -1, model: int = 1, spatial: int = 1, world: Optional[int] = None) -> Mesh:
    """The mesh of ``world`` ranks (the process group's size by default) and
    this rank's group of every axis (JAX ``create_mesh``, mesh.py:24-46, with
    its errors): ``data=-1`` takes the ranks ``spatial * model`` leaves, and
    the product must equal the world. Every rank must call it, in the same
    order, since each group is made by all of them; it becomes the mesh of
    every collective of the port."""
    n = int(world if world is not None else process_count())
    data, model, spatial = int(data), int(model), int(spatial)
    if data == -1:
        if n % (model * spatial):
            raise ValueError(f"{n} devices not divisible by spatial*model={spatial * model}")
        data = n // (model * spatial)
    if data * spatial * model != n:
        raise ValueError(f"mesh {data}x{spatial}x{model} != {n} devices")
    mesh = Mesh(data, spatial, model, process_index() if world is None else 0)
    if distributed():
        rank = process_index()
        for axis in ("data", "spatial", "model", "data_spatial", "world"):
            for ranks in mesh.ranks(axis):
                if len(ranks) == n:
                    group = None  # the whole world: the default group
                elif len(ranks) > 1:
                    group = dist.new_group(ranks)  # every rank makes every group, in the same order
                else:
                    continue
                if rank in ranks:
                    mesh.groups[axis] = group
    if world is None:
        set_mesh(mesh)
    return mesh


_MESH: Optional[Mesh] = None


def set_mesh(mesh: Optional[Mesh]) -> None:
    """Make ``mesh`` the one every collective uses (None: the world is the data axis)."""
    global _MESH
    _MESH = mesh


_DEFAULT: Dict[tuple, Mesh] = {}


def get_mesh() -> Mesh:
    """The run's mesh; without ``create_mesh`` (or for another world than
    its), the world as the data axis."""
    world, rank = process_count(), process_index()
    if _MESH is not None and _MESH.shape["world"] == world and _MESH.index["world"] == rank:
        return _MESH
    key = (world, rank, distributed())
    if key not in _DEFAULT:
        mesh = Mesh(world, 1, 1, key[1])
        if key[2]:
            mesh.groups = {"data": None, "data_spatial": None, "world": None}
        _DEFAULT.clear()
        _DEFAULT[key] = mesh
    return _DEFAULT[key]


def axis_size(axis: str = "data") -> int:
    return get_mesh().shape[axis]


def axis_index(axis: str = "data") -> int:
    return get_mesh().index[axis]


def data_count() -> int:
    """How many data ranks share the batch (the loaders' and the metrics' process count)."""
    return axis_size("data")


def data_index() -> int:
    """This rank's index on the data axis (which rows of the batch it holds)."""
    return axis_index("data")


def _group(axis: str):
    """(whether ``axis`` has a collective to run, its process group)."""
    mesh = get_mesh()
    if not distributed() or axis not in mesh.groups:
        return False, None
    return True, mesh.groups[axis]


def _global_rank(axis: str, index: int) -> int:
    """The world rank of the ``index``-th rank of this rank's ``axis`` group."""
    mesh = get_mesh()
    for ranks in mesh.ranks(axis):
        if mesh.index["world"] in ranks:
            return ranks[index]
    raise RuntimeError(f"rank {mesh.index['world']} is in no {axis} group")


def data_axis(spec: int, world: int) -> int:
    """``mesh.data`` against the ranks: -1 means all of them; any other value
    must equal them (``create_mesh``, mesh.py:42-43 of the JAX package)."""
    if int(spec) in (-1, int(world)):
        return int(world)
    raise ValueError(f"mesh.data={spec} does not match the {world} ranks of this run (use -1 or {world})")


def rank_seed(seed: int) -> int:
    """``seed`` with this rank's data index folded in: data rank 0 keeps it,
    so one process draws as before, and the spatial and model ranks of one
    data rank draw the same (their trunks must agree)."""
    return int(seed) + 1_000_003 * data_index()


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
        with trace.span(f"collective.{kind}"):
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


def all_reduce_(t: torch.Tensor, kind: str, axis: str = "data", op=None) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``axis`` (or reduce with ``op``), in place."""
    active, group = _group(axis)
    if active:
        with STATS.record(kind, t):
            dist.all_reduce(t, op=dist.ReduceOp.SUM if op is None else op, group=group)
    return t


def broadcast_(t: torch.Tensor, src: int, kind: str, axis: str = "data") -> torch.Tensor:
    """``t`` of the ``src``-th rank of ``axis`` on every rank of it, in place."""
    active, group = _group(axis)
    if active:
        with STATS.record(kind, t):
            dist.broadcast(t, _global_rank(axis, src), group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kind, axis):
        ctx.kind, ctx.axis = kind, axis
        return all_reduce_(x.clone(), kind, axis)

    @staticmethod
    def backward(ctx, grad):
        # each rank's loss reaches the sum: its cotangent is the sum of theirs (as SyncBatchNorm's backward)
        return all_reduce_(grad.contiguous().clone(), ctx.kind + "_backward", ctx.axis), None, None


def all_reduce_sum(x: torch.Tensor, kind: str = "stats", axis: str = "data") -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis``, differentiable: the
    backward is the sum over those ranks of the cotangent."""
    if not _group(axis)[0]:
        return x
    return _AllReduceSum.apply(x.contiguous(), kind, axis)


def gather_rows(x: torch.Tensor, kind: str = "gather", axis: str = "data") -> torch.Tensor:
    """The ranks' ``x`` (equal shapes) stacked along dim 0 in the order of
    ``axis``: an all-reduce of a zero-padded buffer, summed as bytes, so
    every value arrives bit for bit. Not differentiable."""
    if not _group(axis)[0]:
        return x
    buf = x.new_zeros((axis_size(axis), *x.shape))
    buf[axis_index(axis)] = x.detach()
    all_reduce_(buf.view(torch.uint8), kind, axis)
    return buf.flatten(0, 1) if x.dim() else buf


def global_rows(x: torch.Tensor, lo: int, hi: int, kind: str = "rows") -> torch.Tensor:
    """Rows [lo, hi) of the global batch whose data rank r holds rows
    [r*b, (r+1)*b) as ``x``: an all-reduce of a zero-padded (hi - lo)-row
    buffer, summed as bytes, so only those rows cross ranks and every value
    arrives bit for bit. Not differentiable. One data rank: ``x[lo:hi]``."""
    if not _group("data")[0]:
        return x[lo:hi]
    b, r = x.shape[0], data_index()
    buf = x.new_zeros((hi - lo, *x.shape[1:]))
    s, e = max(lo, r * b), min(hi, (r + 1) * b)
    if s < e:
        buf[s - lo : e - lo] = x[s - r * b : e - r * b].detach()
    all_reduce_(buf.view(torch.uint8), kind)
    return buf


def mirror(x: torch.Tensor, kind: str = "mirror") -> torch.Tensor:
    """The rows of the global batch flipped, at this rank's rows: row i of data
    rank r gets global row B-1-(r*b+i), which lives on data rank D-1-r (the
    JAX ``images[::-1]``, steps.py:68-69). One data rank: ``x.flip(0)``."""
    if not _group("data")[0]:
        return x.flip(0)
    b, r = x.shape[0], data_index()
    return gather_rows(x, kind).flip(0)[r * b : (r + 1) * b]


def microbatch_rows(x: torch.Tensor, parts: int, kind: str = "microbatch") -> torch.Tensor:
    """This rank's share of each of ``parts`` contiguous chunks of the global
    batch, chunk after chunk: split into ``parts`` equal runs, the result's
    run k is data rank r's 1/D of global microbatch k (the JAX step's reshape
    to (parts, B/parts), steps.py:274-277). One data rank, or one part: ``x``."""
    world = data_count()
    if not _group("data")[0] or world == 1 or parts == 1:
        return x
    g = gather_rows(x, kind)
    if g.shape[0] % (parts * world):
        raise ValueError(f"global batch {g.shape[0]} does not split into {parts} microbatches over {world} ranks")
    return g.view(parts, world, g.shape[0] // (parts * world), *g.shape[1:])[:, data_index()].flatten(0, 1)


def flatten(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The tensors' values in one new 1-d buffer (never a view of one of them)."""
    return torch.cat([t.reshape(-1) for t in tensors])


def unflatten_(tensors: List[torch.Tensor], flat: torch.Tensor) -> None:
    """Copy ``flat`` (as ``flatten`` laid it out) back into the tensors."""
    torch._foreach_copy_(tensors, list(_unflatten_dense_tensors(flat, tensors)))


def average_(tensors: Iterable[Optional[torch.Tensor]], kind: str = "grad", axis: str = "data",
             count: Optional[int] = None) -> None:
    """Replace each tensor by its sum over the ranks of ``axis`` over ``count``
    (by default the axis's size: the mean): one all-reduce of the flattened
    tensors per dtype (None entries are skipped)."""
    if not _group(axis)[0]:
        return
    count = axis_size(axis) if count is None else count
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = defaultdict(list)
    for t in tensors:
        if t is not None:
            by_dtype[t.dtype].append(t)
    for ts in by_dtype.values():
        unflatten_(ts, all_reduce_(flatten(ts), kind, axis).div_(count))


def broadcast_object(obj, src: int = 0, axis: str = "world"):
    """A picklable ``obj`` of the ``src``-th rank of ``axis`` on every rank of it."""
    active, group = _group(axis) if axis != "world" else (distributed(), None)
    if not active:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, _global_rank(axis, src) if axis != "world" else src, group=group)
    return box[0]


def barrier() -> None:
    if distributed():
        dist.barrier()


def band_of(t) -> Optional[tuple]:
    """The band of H rows a tensor holds under spatial partitioning
    (``parallel/spatial.py``): (the dim of H, each spatial rank's (lo, hi)
    rows of it), or None for a tensor every spatial rank holds whole."""
    return getattr(t, "_sp_band", None) if isinstance(t, torch.Tensor) else None


def with_band(t: torch.Tensor, band: Optional[tuple]) -> torch.Tensor:
    """``t`` marked as holding ``band`` (see ``band_of``; None: whole)."""
    if band is not None:
        t._sp_band = band
    return t


def global_mean(t: torch.Tensor, dim=None) -> torch.Tensor:
    """``t.mean(dim)`` over the global batch, for a ``dim`` that holds the
    batch axis (None: every axis), differentiable: the ranks' sums over
    ``dim`` summed, over the global count. A band of H rows (``band_of``)
    sums over the data x spatial ranks, and ``dim`` must then hold its H.
    One rank of a whole tensor: ``t.mean(dim)``."""
    band = band_of(t)
    if band is None and data_count() == 1:
        return t.mean() if dim is None else t.mean(dim)
    with torch._C.DisableTorchFunction():  # this rank's rows, whatever mode is active
        local = t.sum() if dim is None else t.sum(dim)
        count = t.numel() // max(local.numel(), 1)
    axis = "data"
    if band is not None:
        hdim, bounds = band
        dims = range(t.dim()) if dim is None else [d % t.dim() for d in ((dim,) if isinstance(dim, int) else dim)]
        if hdim not in dims:
            raise NotImplementedError(f"spatial partitioning cannot partition global_mean over dims {dim} of a band")
        count = count // t.shape[hdim] * bounds[-1][1]
        axis = "data_spatial"
    return all_reduce_sum(local, "stats", axis) / (count * data_count())
