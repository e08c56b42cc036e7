"""Spatial partitioning: the image height over the mesh's ``spatial`` axis
(port of ``mesh.spatial``: JAX parallel/mesh.py:52-93, ``image_sharding``
and ``validate_spatial_extent``; cli.py:132-144 and :188-195; steps.py:263-268
and :370-371).

In the JAX package the images are resharded to ``P('data', 'spatial')``
after the augment and the mixup, and GSPMD partitions every op over the
sharded H, halo exchanges included. Here each of the S spatial ranks of a
data rank keeps its band of H rows (``scatter``: rank s holds rows
[s*H//S, (s+1)*H//S), so bands differ by a row at most where S does not
divide H, as at the 7-row deepest map of a 224-px ResNet on two ranks) and
the model runs on bands under ``SpatialMode``:

* a tensor holding a band carries it (``mesh.band_of``: the dim of H and
  every rank's (lo, hi)); ops on it pass the band on, and ops that mix rows
  are partitioned by hand:
  - convolutions (any kernel, stride, dilation and groups), max pooling and
    average pooling: each rank computes the global output rows of its band
    of the output, from the input rows they need; the rows a rank lacks come
    from the ranks that hold them (``_Fetch``), the global edges are padded
    as the unsharded op pads them (zeros; -inf for max pooling), and a stride
    counts from the global row 0;
  - sums, means, norms, extrema, variances and any/all over H: the band's share,
    summed over the spatial ranks (``all_reduce_sum``; the gradient is the
    sum of the ranks' cotangents);
  - strided slices of H take the global row phase; pads pad the global edges;
  - GroupNorm takes its statistics over the spatial ranks;
  - the BatchNorm family sums its statistics over the data x spatial ranks
    (``models/norms.py``);
* an op that mixes every position is computed on the full H, gathered over
  the spatial ranks (``spatial_gather``), exactly as GSPMD would: the
  attention modules over H*W (XCA, UFO, FCA's DCT pooling) and CoordConv's
  coordinates take a gathered input and keep their band of the output
  (``prepare``); a flatten of H into other dims (a flatten head), an
  interpolation and the pools torch cannot pad band by band run on the
  gathered tensor. ``mesh.STATS`` counts each gather;
* any other op that reaches a band raises ``SpatialError``, naming it: no
  op runs on a band as if it were the whole image.

Why a ``TorchFunctionMode``: the ops that mix rows are few and reach torch
through a handful of functions whatever module calls them, so one table
covers every model of the registry, where module hooks would need a rule per
module class; and the mode sees each call above autograd, so a handler
written in torch ops (the halo's collective an autograd function) gets its
gradient from autograd. The modules whose forward computes from the full
H's size (the gather modules above) are the exception, handled by hooks.

Gradients: every spatial rank computes its data rank's loss; each
backpropagates 1/S of it (``train/steps.py``), a collective's backward sums
the ranks' cotangents, and the gradients are summed over the data x spatial
ranks: each rank's share of a band's convolution plus 1/S of the replicated
head's gradient.

Collectives are ``all_reduce`` only (``parallel/mesh.py``): a halo is a
zero-padded buffer of the rows some rank needs from another, summed as
bytes, so every value arrives bit for bit, on gloo ranks that share a card
and on NCCL alike.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from sota_imagenet_tpu_torch.parallel import mesh as par
from sota_imagenet_tpu_torch.parallel.mesh import band_of, with_band

Band = Tuple[int, Tuple[Tuple[int, int], ...]]


class SpatialError(NotImplementedError):
    """An op that spatial partitioning cannot partition reached a band of H rows."""


def validate_spatial_extent(mesh, image_size: int, max_stride: int = 32) -> None:
    """Refuse spatial partitioning that would shard the deepest feature map
    (image_size / max_stride rows) below 2 rows per rank: the JAX guard
    (mesh.py:74-93 there), with its message, so the port refuses the runs
    the JAX package refuses (the port's halos would be exact there)."""
    sp = dict(mesh.shape).get("spatial", 1)
    if sp <= 1:
        return
    deepest = max(int(image_size) // int(max_stride), 1)
    if deepest // sp < 2:
        raise ValueError(
            f"mesh.spatial={sp} leaves {deepest}/{sp} < 2 rows per shard at the deepest "
            f"feature map (image {image_size}, max stride {max_stride}); XLA SPMD "
            f"miscompiles conv gradients below the halo width — use image_size >= "
            f"{2 * sp * max_stride} or a smaller spatial axis"
        )


def split(n: int, parts: int) -> Tuple[Tuple[int, int], ...]:
    """Each of ``parts`` ranks' rows [lo, hi) of ``n`` rows: [i*n//parts, (i+1)*n//parts)."""
    return tuple((i * int(n) // parts, (i + 1) * int(n) // parts) for i in range(parts))


def _canonical(n: int, what: str) -> Tuple[Tuple[int, int], ...]:
    bounds = split(n, par.axis_size("spatial"))
    if any(lo >= hi for lo, hi in bounds):
        raise SpatialError(f"spatial partitioning cannot split the {n} rows of {what} over "
                           f"{par.axis_size('spatial')} ranks")
    return bounds


# --------------------------------------------------------------------------- #
# Moving rows between the spatial ranks
# --------------------------------------------------------------------------- #


def _shared_rows(bounds, needs) -> List[int]:
    """The global rows that some rank needs and another holds, in order."""
    hg, rows = bounds[-1][1], set()
    for (lo, hi), (nlo, nhi) in zip(bounds, needs):
        rows.update(g for g in range(max(nlo, 0), min(nhi, hg)) if not lo <= g < hi)
    return sorted(rows)


def _index(rows: Sequence[int], device) -> torch.Tensor:
    return _cached_index(tuple(rows), str(device))


def _move_rows(dst: torch.Tensor, dst_rows, src: torch.Tensor, src_rows, dim: int, add: bool = False) -> None:
    """dst's rows ``dst_rows`` along ``dim`` set to (or, with ``add``, increased by) src's rows ``src_rows``."""
    if dst_rows:
        rows = src.index_select(dim, _index(src_rows, src.device))
        index = _index(dst_rows, dst.device)
        dst.index_add_(dim, index, rows) if add else dst.index_copy_(dim, index, rows)


@functools.lru_cache(maxsize=4096)
def _cached_index(rows: Tuple[int, ...], device: str) -> torch.Tensor:
    """An index tensor on ``device``, made once per layout (a copy from the host would wait on the stream)."""
    return torch.tensor(rows, dtype=torch.long, device=device)


class _Fetch(torch.autograd.Function):
    """Rows [nlo, nhi) of the global H (clipped to it) on this rank, from its
    band and the ranks that hold the others: a buffer of the rows any rank
    lacks, summed as bytes over the spatial ranks. The backward sends each
    row's cotangent back to its holder (a float sum of the same buffer)."""

    @staticmethod
    def forward(ctx, x, dim, bounds, needs, shared):
        s = par.axis_index("spatial")
        (lo, hi), hg = bounds[s], bounds[-1][1]
        nlo, nhi = max(needs[s][0], 0), min(needs[s][1], hg)
        pos = {g: i for i, g in enumerate(shared)}
        shape = list(x.shape)
        shape[dim] = len(shared)
        buf = x.new_zeros(shape)
        own = [g for g in shared if lo <= g < hi]
        _move_rows(buf, [pos[g] for g in own], x, [g - lo for g in own], dim)
        par.all_reduce_(buf.view(torch.uint8), "halo", "spatial")
        take = [g - lo if lo <= g < hi else hi - lo + pos[g] for g in range(nlo, nhi)]
        ctx.meta = (dim, lo, hi, nlo, nhi, pos, tuple(x.shape), x.is_contiguous(memory_format=torch.channels_last))
        return torch.cat([x, buf], dim).index_select(dim, _index(take, x.device))

    @staticmethod
    def backward(ctx, grad):
        dim, lo, hi, nlo, nhi, pos, xshape, cl = ctx.meta
        gx = grad.new_zeros(xshape)
        mine = [g for g in range(nlo, nhi) if lo <= g < hi]
        _move_rows(gx, [g - lo for g in mine], grad, [g - nlo for g in mine], dim, add=True)
        shape = list(grad.shape)
        shape[dim] = len(pos)
        buf = grad.new_zeros(shape)
        theirs = [g for g in range(nlo, nhi) if not lo <= g < hi]
        _move_rows(buf, [pos[g] for g in theirs], grad, [g - nlo for g in theirs], dim)
        par.all_reduce_(buf, "halo_backward", "spatial")
        own = [g for g in pos if lo <= g < hi]
        _move_rows(gx, [g - lo for g in own], buf, [pos[g] for g in own], dim, add=True)
        return (gx.contiguous(memory_format=torch.channels_last) if cl and gx.dim() == 4 else gx), None, None, None, None


def _rows(x: torch.Tensor, band: Band, needs) -> torch.Tensor:
    """This rank's rows ``needs[s]`` of the band tensor ``x`` (clipped to the
    global H), untagged: a slice of its own band where no rank lacks a row,
    else through ``_Fetch`` (every rank calls it alike)."""
    dim, bounds = band
    s = par.axis_index("spatial")
    (lo, hi), hg = bounds[s], bounds[-1][1]
    if x.shape[dim] != hi - lo:
        raise SpatialError(f"a band of rows [{lo}, {hi}) holds {x.shape[dim]} rows at dim {dim}")
    shared = _shared_rows(bounds, needs)
    nlo, nhi = max(needs[s][0], 0), min(needs[s][1], hg)
    if not shared:
        return x.narrow(dim, nlo - lo, nhi - nlo)
    out = _Fetch.apply(x, dim, bounds, needs, shared)
    return out.contiguous(memory_format=torch.channels_last) if out.dim() == 4 and dim == 2 else out


class _Gather(torch.autograd.Function):
    """The full H on every spatial rank (a zero-padded buffer summed as
    bytes); the backward sums the ranks' cotangents and keeps the band's rows."""

    @staticmethod
    def forward(ctx, x, dim, bounds):
        lo, hi = bounds[par.axis_index("spatial")]
        shape = list(x.shape)
        shape[dim] = bounds[-1][1]
        buf = x.new_zeros(shape)
        buf.narrow(dim, lo, hi - lo).copy_(x)
        par.all_reduce_(buf.view(torch.uint8), "spatial_gather", "spatial")
        ctx.meta = (dim, lo, hi)
        return buf

    @staticmethod
    def backward(ctx, grad):
        dim, lo, hi = ctx.meta
        total = par.all_reduce_(grad.contiguous().clone(), "spatial_gather_backward", "spatial")
        return total.narrow(dim, lo, hi - lo), None, None


def gather(x: torch.Tensor) -> torch.Tensor:
    """The whole tensor a band belongs to (untagged; differentiable)."""
    dim, bounds = band_of(x)
    return _Gather.apply(x, dim, bounds)


def keep_band(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's band of the whole ``x`` along ``dim`` (the canonical split), tagged."""
    bounds = _canonical(x.shape[dim], "a gathered op's output")
    lo, hi = bounds[par.axis_index("spatial")]
    return with_band(x.narrow(dim, lo, hi - lo), (dim, bounds))


def scatter(images: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """This rank's band of H (dim ``dim``) of a batch every spatial rank holds whole."""
    return keep_band(images, dim)


# --------------------------------------------------------------------------- #
# The mode and its handlers
# --------------------------------------------------------------------------- #

_TLS = threading.local()


def _tensors(args, kwargs):
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from (t for t in a if isinstance(t, torch.Tensor))


def _band_in(args, kwargs) -> Optional[Band]:
    for t in _tensors(args, kwargs):
        b = band_of(t)
        if b is not None:
            return b
    return None


def _key(func) -> str:
    if func is F.max_pool2d:
        return "max_pool2d"
    name = getattr(func, "__name__", None)
    if name == "__get__":
        return "attr:" + getattr(getattr(func, "__self__", None), "__name__", "?")
    return name or repr(func)


def _arg(args, kwargs, i: int, name: str, default=None):
    if name in kwargs:
        return kwargs[name]
    return args[i] if len(args) > i else default


def _pair(v) -> Tuple[int, int]:
    return (int(v), int(v)) if isinstance(v, int) else (int(v[0]), int(v[-1]))


def _tag_like(out, band: Band, src_ndim: int):
    """Tag every tensor of ``out`` (a tensor, or a list/tuple of them) with
    ``band``, its dim moved by the leading dims a broadcast added."""
    if isinstance(out, torch.Tensor):
        if out.dim() >= src_ndim:
            with_band(out, (band[0] + out.dim() - src_ndim, band[1]))
        return out
    if isinstance(out, (list, tuple)):
        for o in out:
            _tag_like(o, band, src_ndim)
    return out


def _pointwise(func, args, kwargs):
    """An op that treats every row alike: the bands of its inputs must agree
    (a band of other bounds over the same H is moved to the first's); the
    outputs hold the same band."""
    bands = [(t, band_of(t)) for t in _tensors(args, kwargs) if band_of(t) is not None]
    first_t, band = bands[0]
    for t, b in bands[1:]:
        if b != band and (t.dim() - b[0] != first_t.dim() - band[0] or b[1][-1][1] != band[1][-1][1]):
            raise SpatialError(f"spatial partitioning cannot combine bands {band} and {b} in {_key(func)}")
    if any(b[1] != band[1] for _, b in bands[1:]):
        moved = {id(t): _rows(t, b, band[1]) for t, b in bands[1:] if b[1] != band[1]}
        swap = lambda a: moved.get(id(a), a) if isinstance(a, torch.Tensor) else a  # noqa: E731
        args = tuple(type(a)(swap(t) for t in a) if isinstance(a, (list, tuple)) else swap(a) for a in args)
        kwargs = {k: swap(v) for k, v in kwargs.items()}
    return _tag_like(func(*args, **kwargs), band, first_t.dim())


def _dims(dim, ndim: int) -> List[int]:
    if dim is None or (isinstance(dim, (list, tuple)) and len(dim) == 0):
        return list(range(ndim))
    return sorted({d % ndim for d in ((dim,) if isinstance(dim, int) else dim)})


def _after_reduce(band: Band, dims: List[int], keepdim: bool) -> Band:
    return (band[0] if keepdim else band[0] - sum(d < band[0] for d in dims), band[1])


def _sum_over_h(local: torch.Tensor) -> torch.Tensor:
    return par.all_reduce_sum(local, "spatial_sum", "spatial")


def _reduction(func, args, kwargs):
    """sum, mean, norms, extrema and variances: over dims that hold H, the
    band's share reduced over the spatial ranks; over other dims, a band."""
    key = _key(func)
    x = args[0]
    band = band_of(x)
    if key == "linalg_vector_norm":
        ord_, dim, keepdim, dtype = (_arg(args, kwargs, 1, "ord", 2), _arg(args, kwargs, 2, "dim"),
                                     _arg(args, kwargs, 3, "keepdim", False), kwargs.get("dtype"))
    elif key in ("std", "var", "std_mean", "var_mean"):
        ord_, dim, keepdim, dtype = None, _arg(args, kwargs, 1, "dim"), kwargs.get("keepdim", False), None
        if isinstance(dim, bool):
            raise SpatialError(f"spatial partitioning cannot partition {key} with unbiased={dim}")
    else:
        ord_, dim, keepdim, dtype = (None, _arg(args, kwargs, 1, "dim"), _arg(args, kwargs, 2, "keepdim", False),
                                     kwargs.get("dtype"))
    if key in ("max", "min") and (isinstance(dim, torch.Tensor) or dim is not None):
        if isinstance(dim, torch.Tensor):
            return _pointwise(func, args, kwargs)  # the elementwise max/min of two tensors
        raise SpatialError(f"spatial partitioning cannot partition {key} with indices over dim {dim}")
    dims = _dims(dim, x.dim())
    if band[0] not in dims:
        return with_band(func(*args, **kwargs), _after_reduce(band, dims, keepdim))
    hg = band[1][-1][1]
    n = math.prod(hg if d == band[0] else x.shape[d] for d in dims)
    if key == "sum":
        return _sum_over_h(func(*args, **kwargs))
    if key in ("any", "all"):  # debug_nans' checks: every rank of the image answers alike
        op = torch.distributed.ReduceOp.MAX if key == "any" else torch.distributed.ReduceOp.MIN
        return par.all_reduce_(func(*args, **kwargs).to(torch.int32), "spatial_sum", "spatial", op).bool()
    acc = dtype or torch.promote_types(x.dtype, torch.float32)
    if key == "mean":
        return (_sum_over_h(x.sum(dims, keepdim=keepdim, dtype=acc)) / n).to(dtype or x.dtype)
    if key == "linalg_vector_norm":
        if ord_ != 2:
            raise SpatialError(f"spatial partitioning cannot partition a {ord_}-norm over H")
        return torch.sqrt(_sum_over_h(torch.linalg.vector_norm(x, 2, dims, keepdim, dtype=dtype).square()))
    if key in ("amax", "amin", "max", "min"):
        local = (x.amax if key in ("amax", "max") else x.amin)(dims, keepdim=keepdim).unsqueeze(0)
        s = par.axis_size("spatial")
        every = _Gather.apply(local, 0, tuple((i, i + 1) for i in range(s)))
        return (every.amax if key in ("amax", "max") else every.amin)(0)
    if key in ("std", "var", "std_mean", "var_mean"):
        correction = kwargs.get("correction", 0 if kwargs.get("unbiased") is False else 1)
        xf = x.to(acc)
        mean = _sum_over_h(xf.sum(dims, keepdim=True)) / n
        var = _sum_over_h((xf - mean).square().sum(dims, keepdim=keepdim)) / max(n - correction, 0)
        mean = mean if keepdim else mean.squeeze(dims)
        out = var if key.startswith("var") else torch.sqrt(var)
        out = out.to(x.dtype)
        return (out, mean.to(x.dtype)) if key.endswith("_mean") else out
    raise SpatialError(f"spatial partitioning cannot partition {key} over H")


def _adaptive(func, args, kwargs):
    size = _arg(args, kwargs, 1, "output_size")
    if size in (1, (1, 1), [1, 1]) and band_of(args[0])[0] == 2:
        x = args[0]
        return x.mean((2, 3), keepdim=True) if "avg" in _key(func) else x.amax((2, 3), keepdim=True)
    return _gathered(func, args, kwargs, keeps_h=True)


def _gathered(func, args, kwargs, keeps_h: bool):
    """``func`` on the gathered full H of every band argument; the output
    keeps this rank's band (``keeps_h``: H stays at its dim), or is whole."""
    band = _band_in(args, kwargs)
    full = lambda a: gather(a) if band_of(a) is not None else a  # noqa: E731
    args = tuple(type(a)(full(t) for t in a) if isinstance(a, (list, tuple)) else full(a) for a in args)
    kwargs = {k: full(v) for k, v in kwargs.items()}
    out = func(*args, **kwargs)
    return keep_band(out, band[0]) if keeps_h else out


def _window_rows(x, band: Band, k: int, s: int, pt: int, pb: int, d: int, ceil_mode: bool, what: str):
    """The input rows of this rank's band of a windowed op's output (kernel
    ``k``, stride ``s``, pads ``pt``/``pb``, dilation ``d`` on H): (those rows,
    the pad rows above and below them, the output's bounds)."""
    if band[0] != 2 or x.dim() != 4:
        raise SpatialError(f"spatial partitioning cannot partition {what} of a band at dim {band[0]} of {x.dim()}")
    hg, eff = band[1][-1][1], d * (k - 1) + 1
    if ceil_mode:
        hout = -(-(hg + pt + pb - eff) // s) + 1
        if (hout - 1) * s >= hg + pt:
            hout -= 1
    else:
        hout = (hg + pt + pb - eff) // s + 1
    out_bounds = _canonical(hout, what)
    needs = [(a * s - pt, (b - 1) * s - pt + eff) for a, b in out_bounds]
    nlo, nhi = needs[par.axis_index("spatial")]
    return _rows(x, band, needs), max(0, -nlo), max(0, nhi - hg), out_bounds


def _conv2d(func, args, kwargs):
    x, w = args[0], args[1]
    bias = _arg(args, kwargs, 2, "bias")
    stride, padding = _pair(_arg(args, kwargs, 3, "stride", 1)), _arg(args, kwargs, 4, "padding", 0)
    dilation, groups = _pair(_arg(args, kwargs, 5, "dilation", 1)), _arg(args, kwargs, 6, "groups", 1)
    if band_of(w) is not None or band_of(bias) is not None:
        raise SpatialError("spatial partitioning cannot partition a conv2d whose weight holds a band")
    if padding == "valid":
        padding = 0
    if isinstance(padding, str):
        raise SpatialError(f"spatial partitioning cannot partition conv2d padding={padding!r}")
    ph, pw = _pair(padding)
    xe, top, bot, bounds = _window_rows(x, band_of(x), w.shape[2], stride[0], ph, ph, dilation[0], False, "conv2d")
    if top or bot:
        xe = F.pad(xe, (0, 0, top, bot))
    return with_band(func(xe, w, bias, stride, (0, pw), dilation, groups), (2, bounds))


def _max_pool2d(func, args, kwargs):
    x = args[0]
    k = _pair(_arg(args, kwargs, 1, "kernel_size"))
    stride = _arg(args, kwargs, 2, "stride")
    s = _pair(k if stride is None or stride == [] else stride)
    p, d = _pair(_arg(args, kwargs, 3, "padding", 0)), _pair(_arg(args, kwargs, 4, "dilation", 1))
    ceil_mode, indices = _arg(args, kwargs, 5, "ceil_mode", False), _arg(args, kwargs, 6, "return_indices", False)
    if indices:
        _no(func)
    xe, top, bot, bounds = _window_rows(x, band_of(x), k[0], s[0], p[0], p[0], d[0], ceil_mode, "max_pool2d")
    if top or bot:
        xe = F.pad(xe, (0, 0, top, bot), value=float("-inf"))
    y = F.max_pool2d(xe, k, s, (0, p[1]), d, ceil_mode)
    lo, hi = bounds[par.axis_index("spatial")]
    return with_band(y.narrow(2, 0, hi - lo), (2, bounds))


def _avg_pool2d(func, args, kwargs):
    x = args[0]
    k = _pair(_arg(args, kwargs, 1, "kernel_size"))
    stride = _arg(args, kwargs, 2, "stride")
    s = _pair(k if stride is None or stride == [] else stride)
    p = _pair(_arg(args, kwargs, 3, "padding", 0))
    ceil_mode, include = _arg(args, kwargs, 4, "ceil_mode", False), _arg(args, kwargs, 5, "count_include_pad", True)
    if ceil_mode or not include or _arg(args, kwargs, 6, "divisor_override") is not None:
        return _gathered(func, args, kwargs, keeps_h=True)  # a divisor that counts the global edges
    xe, top, bot, bounds = _window_rows(x, band_of(x), k[0], s[0], p[0], p[0], 1, False, "avg_pool2d")
    if top or bot:
        xe = F.pad(xe, (0, 0, top, bot))
    return with_band(func(xe, k, s, (0, p[1]), False, True), (2, bounds))


def _pad(func, args, kwargs):
    x, pad = args[0], list(_arg(args, kwargs, 1, "pad"))
    mode, value = _arg(args, kwargs, 2, "mode", "constant"), _arg(args, kwargs, 3, "value")
    dim, bounds = band_of(x)
    i = x.dim() - 1 - dim  # the pair of ``pad`` that pads H
    if len(pad) < 2 * (i + 1) or pad[2 * i] == pad[2 * i + 1] == 0:
        return with_band(func(*args, **kwargs), (dim, bounds))
    pt, pb = pad[2 * i], pad[2 * i + 1]
    s, last = par.axis_index("spatial"), par.axis_size("spatial") - 1
    if pt < 0 or pb < 0 or mode == "circular":
        raise SpatialError(f"spatial partitioning cannot partition pad {pad} mode {mode!r} over H")
    if mode != "constant" and x.shape[dim] <= max(pt if s == 0 else 0, pb if s == last else 0):
        raise SpatialError(f"spatial partitioning cannot {mode}-pad {max(pt, pb)} rows of a {x.shape[dim]}-row band")
    pad[2 * i], pad[2 * i + 1] = (pt if s == 0 else 0), (pb if s == last else 0)
    out = F.pad(x, pad, mode, value) if mode == "constant" else F.pad(x, pad, mode)
    new = tuple((0 if r == 0 else lo + pt, hi + pt + (pb if r == last else 0)) for r, (lo, hi) in enumerate(bounds))
    return with_band(out, (dim, new))


def _group_norm(func, args, kwargs):
    x, groups = args[0], _arg(args, kwargs, 1, "num_groups")
    weight, bias, eps = _arg(args, kwargs, 2, "weight"), _arg(args, kwargs, 3, "bias"), _arg(args, kwargs, 4, "eps", 1e-5)
    band = band_of(x)
    b, c = x.shape[:2]
    xg = x.reshape(b, groups, c // groups, *x.shape[2:])
    dims = list(range(2, xg.dim()))
    n = c // groups * band[1][-1][1] * math.prod(x.shape[3:])
    acc = torch.promote_types(x.dtype, torch.float32)
    mean = _sum_over_h(xg.sum(dims, keepdim=True, dtype=acc)) / n
    var = _sum_over_h((xg.to(acc) - mean).square().sum(dims, keepdim=True)) / n
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    view = (1, c) + (1,) * (x.dim() - 2)
    if weight is not None:
        y = y * weight.view(view)
    if bias is not None:
        y = y + bias.view(view)
    return with_band(y.to(x.dtype), band)


def _resolve(shape: Sequence[int], numel: int) -> List[int]:
    shape = [int(v) for v in shape]
    if -1 in shape:
        known = math.prod(v for v in shape if v != -1)
        shape[shape.index(-1)] = numel // max(known, 1)
    return shape


def _reshape(func, args, kwargs):
    """view/reshape: H kept as one dim, or split into (H/f, f) where every
    band splits (a space-to-depth); a merge of H with other dims (a flatten
    head) runs on the gathered H and gives a whole tensor."""
    x = args[0]
    dim, bounds = band_of(x)
    if _key(func) in ("view_as", "reshape_as"):
        shape = list(args[1].shape)
    else:
        raw = args[1:] if len(args) > 1 else (kwargs.get("shape") or kwargs.get("size"),)
        if len(raw) == 1 and isinstance(raw[0], (list, tuple, torch.Size)):
            raw = raw[0]
        if len(raw) == 1 and isinstance(raw[0], torch.dtype):
            raise SpatialError("spatial partitioning cannot partition a dtype view of a band")
        shape = _resolve(raw, x.numel())
    old = list(x.shape)
    pre, h = math.prod(old[:dim]), old[dim]
    acc, j = 1, 0
    while j < len(shape) and acc < pre:
        acc, j = acc * shape[j], j + 1
    while acc == pre and j < len(shape) and shape[j] == 1 and h != 1:
        j += 1
    if acc == pre and j < len(shape):
        if shape[j] == h:
            return with_band(func(*args, **kwargs), (j, bounds))
        rows, k = 1, j
        while k < len(shape) and rows < h:
            rows, k = rows * shape[k], k + 1
        f = h // shape[j] if shape[j] else 0
        if rows == h and k - j >= 2 and f and all(lo % f == 0 and hi % f == 0 for lo, hi in bounds):
            return with_band(func(*args, **kwargs), (j, tuple((lo // f, hi // f) for lo, hi in bounds)))
    return _gathered(func, args, kwargs, keeps_h=False)


def _flatten(func, args, kwargs):
    x = args[0]
    start, end = _arg(args, kwargs, 1, "start_dim", 0) % max(x.dim(), 1), _arg(args, kwargs, 2, "end_dim", -1) % max(x.dim(), 1)
    dim, bounds = band_of(x)
    if start <= dim <= end and end > start:
        return _gathered(func, args, kwargs, keeps_h=False)
    return with_band(func(*args, **kwargs), (dim - (end - start) if dim > end else dim, bounds))


def _permute(func, args, kwargs):
    x = args[0]
    dims = args[1:] if len(args) > 1 else (kwargs["dims"],)
    if len(dims) == 1 and isinstance(dims[0], (list, tuple)):
        dims = dims[0]
    dims = [d % x.dim() for d in dims]
    dim, bounds = band_of(x)
    return with_band(func(*args, **kwargs), (dims.index(dim), bounds))


def _transpose(func, args, kwargs):
    x = args[0]
    a, b = (_arg(args, kwargs, 1, "dim0") % x.dim(), _arg(args, kwargs, 2, "dim1") % x.dim())
    dim, bounds = band_of(x)
    return with_band(func(*args, **kwargs), ({a: b, b: a}.get(dim, dim), bounds))


def _unsqueeze(func, args, kwargs):
    x = args[0]
    d = _arg(args, kwargs, 1, "dim") % (x.dim() + 1)
    dim, bounds = band_of(x)
    return with_band(func(*args, **kwargs), (dim + (d <= dim), bounds))


def _squeeze(func, args, kwargs):
    x = args[0]
    dim, bounds = band_of(x)
    d = _arg(args, kwargs, 1, "dim")
    gone = _dims(d, x.dim()) if d is not None else list(range(x.dim()))
    gone = [g for g in gone if x.shape[g] == 1]
    if dim in gone:
        raise SpatialError("spatial partitioning cannot squeeze a band's H")
    return with_band(func(*args, **kwargs), (dim - sum(g < dim for g in gone), bounds))


def _expand(func, args, kwargs):
    x = args[0]
    out = func(*args, **kwargs)
    dim, bounds = band_of(x)
    new = dim + out.dim() - x.dim()
    if out.shape[new] != x.shape[dim]:
        raise SpatialError(f"spatial partitioning cannot {_key(func)} a band's H")
    return with_band(out, (new, bounds))


def _along(func, args, kwargs):
    """split/chunk/unbind/narrow/select along a dim other than H."""
    x = args[0]
    key = _key(func)
    default = 0
    d = _arg(args, kwargs, 2 if key in ("split", "chunk") else 1, "dim", default)
    dim, bounds = band_of(x)
    if d % x.dim() == dim:
        raise SpatialError(f"spatial partitioning cannot partition {key} along H")
    new = dim - (key in ("unbind", "select") and d % x.dim() < dim)
    return _tag_like(func(*args, **kwargs), (new, bounds), x.dim() - (key in ("unbind", "select")))


def _getitem(func, args, kwargs):
    """Basic indexing that keeps H whole (``:``) or takes every ``step``-th
    row of it from the global row 0 (``::step``, BatchNorm's subsample)."""
    x, idx = args
    dim, bounds = band_of(x)
    idx = idx if isinstance(idx, tuple) else (idx,)
    if any(isinstance(i, (torch.Tensor, list, bool)) for i in idx):
        raise SpatialError("spatial partitioning cannot partition advanced indexing of a band")
    n_real = sum(1 for i in idx if i is not None and i is not Ellipsis)
    expanded: List[Any] = []
    for i in idx:
        expanded += [slice(None)] * (x.dim() - n_real) if i is Ellipsis else [i]
    expanded += [slice(None)] * (x.dim() - sum(1 for i in expanded if i is not None))
    src, new_dim, hpos = 0, 0, None
    for j, i in enumerate(expanded):
        if i is None:
            new_dim += 1
            continue
        if src == dim:
            hpos = j
            break
        new_dim += isinstance(i, slice)
        src += 1
    h = expanded[hpos]
    if not isinstance(h, slice) or h.start not in (None, 0) or h.stop is not None:
        raise SpatialError(f"spatial partitioning cannot index H with {h!r}")
    step = h.step or 1
    expanded[hpos] = slice(None)
    y = x[tuple(expanded)]
    if step == 1:
        return with_band(y, (new_dim, bounds))
    lo = bounds[par.axis_index("spatial")][0]
    sub = y[(slice(None),) * new_dim + (slice((-lo) % step, None, step),)]
    natural = tuple((-(-l // step), -(-h // step)) for l, h in bounds)
    canon = _canonical(natural[-1][1], "a strided slice")
    return with_band(sub if natural == canon else _rows(sub, (new_dim, natural), canon), (new_dim, canon))


def _cat(func, args, kwargs):
    tensors = list(_arg(args, kwargs, 0, "tensors"))
    d = _arg(args, kwargs, 1, "dim", 0)
    bands = {band_of(t) for t in tensors}
    if len(bands) != 1 or None in bands:
        raise SpatialError(f"spatial partitioning cannot {_key(func)} tensors of bands {bands}")
    dim, bounds = bands.pop()
    ndim = tensors[0].dim()
    if _key(func) == "cat":
        if d % ndim == dim:
            raise SpatialError("spatial partitioning cannot concatenate along H")
        return with_band(func(*args, **kwargs), (dim, bounds))
    d = d % (ndim + 1)
    return with_band(func(*args, **kwargs), (dim + (d <= dim), bounds))


def _last_dim_op(func, args, kwargs):
    """linear and matmul with the band's tensor first: fine while H is not the contracted dim."""
    x = args[0]
    dim, bounds = band_of(x)
    if any(band_of(a) is not None for a in args[1:]) or dim == x.dim() - 1:
        raise SpatialError(f"spatial partitioning cannot partition {_key(func)} over H")
    return with_band(func(*args, **kwargs), (dim, bounds))


def _softmax(func, args, kwargs):
    x = args[0]
    d = _arg(args, kwargs, 1, "dim")
    dim, bounds = band_of(x)
    if d is None or d % x.dim() == dim:
        raise SpatialError(f"spatial partitioning cannot partition {_key(func)} over H")
    return with_band(func(*args, **kwargs), (dim, bounds))


def _layer_norm(func, args, kwargs):
    x, shape = args[0], _arg(args, kwargs, 1, "normalized_shape")
    dim, bounds = band_of(x)
    if dim >= x.dim() - len(shape):
        raise SpatialError("spatial partitioning cannot partition layer_norm over H")
    return with_band(func(*args, **kwargs), (dim, bounds))


def _batch_norm(func, args, kwargs):
    if _arg(args, kwargs, 5, "training", False):
        raise SpatialError("spatial partitioning cannot partition F.batch_norm in training (use models/norms.BatchNorm)")
    return _pointwise(func, args, kwargs)


def _no(func, *_):
    raise SpatialError(f"spatial partitioning cannot partition {_key(func)}")


_HANDLERS: Dict[str, Callable] = {
    "conv2d": _conv2d,
    "max_pool2d": _max_pool2d,
    "max_pool2d_with_indices": lambda f, a, k: _no(f),
    "avg_pool2d": _avg_pool2d,
    "adaptive_avg_pool2d": _adaptive,
    "adaptive_max_pool2d": _adaptive,
    "interpolate": lambda f, a, k: _gathered(f, a, k, keeps_h=True),
    "pad": _pad,
    "group_norm": _group_norm,
    "batch_norm": _batch_norm,
    "layer_norm": _layer_norm,
    "linear": _last_dim_op,
    "matmul": _last_dim_op,
    "__matmul__": _last_dim_op,
    "softmax": _softmax,
    "log_softmax": _softmax,
    "view": _reshape,
    "reshape": _reshape,
    "view_as": _reshape,
    "reshape_as": _reshape,
    "flatten": _flatten,
    "permute": _permute,
    "transpose": _transpose,
    "swapaxes": _transpose,
    "unsqueeze": _unsqueeze,
    "squeeze": _squeeze,
    "expand": _expand,
    "expand_as": _expand,
    "split": _along,
    "chunk": _along,
    "unbind": _along,
    "narrow": _along,
    "select": _along,
    "__getitem__": _getitem,
    "cat": _cat,
    "stack": _cat,
    **{k: _reduction for k in ("sum", "mean", "amax", "amin", "max", "min", "std", "var", "std_mean", "var_mean",
                               "linalg_vector_norm", "any", "all")},
}

# ops that treat every element (or every row) alike
_POINTWISE = frozenset("""
add add_ sub sub_ rsub mul mul_ div div_ true_divide neg neg_ abs abs_ pow pow_ sqrt sqrt_ rsqrt rsqrt_ exp exp_
log log_ log1p expm1 sigmoid sigmoid_ tanh tanh_ relu relu_ gelu silu silu_ hardswish hardswish_ hardsigmoid
hardtanh hardtanh_ leaky_relu leaky_relu_ elu elu_ selu softplus mish relu6 softsign logsigmoid threshold prelu
clamp clamp_ clamp_min clamp_min_ clamp_max clamp_max_ clip where square square_ reciprocal sign floor ceil round
trunc erf sin cos maximum minimum fmax fmin lerp lerp_ addcmul addcmul_ addcdiv addcdiv_ eq ne lt le gt ge
logical_not logical_and logical_or bitwise_not isfinite isnan isinf nan_to_num masked_fill masked_fill_ to type
type_as float double half bfloat16 int long bool contiguous clone detach detach_ requires_grad_ zero_ fill_ copy_
zeros_like ones_like empty_like full_like rand_like randn_like dropout dropout_ alpha_dropout feature_alpha_dropout
__add__ __radd__ __iadd__ __sub__ __rsub__ __isub__ __mul__ __rmul__ __imul__ __truediv__ __rtruediv__ __itruediv__
__neg__ __pow__ __rpow__ __and__ __or__ __invert__ __eq__ __ne__ __lt__ __le__ __gt__ __ge__ __abs__
mul_scalar cpu cuda attr:data
""".split())

# reads of a tensor's metadata, and constructors of new unrelated tensors
_META = frozenset("""
size dim ndimension numel element_size is_contiguous stride data_ptr storage_offset untyped_storage __len__
get_device is_floating_point is_complex new_zeros new_ones new_empty new_full new_tensor register_hook retain_grad
__format__ __repr__ __hash__ __reduce_ex__ __deepcopy__ __setstate__ nelement
attr:shape attr:dtype attr:device attr:ndim attr:is_cuda attr:requires_grad attr:grad_fn attr:layout attr:is_leaf
attr:grad attr:names attr:is_sparse attr:is_quantized attr:is_meta attr:_base attr:output_nr attr:_version
attr:itemsize attr:nbytes attr:is_mkldnn attr:is_nested attr:_sp_band attr:__dict__
""".split())


class SpatialMode(TorchFunctionMode):
    """Partitions the ops on bands of H rows (see the module docstring)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _band_in(args, kwargs) is None:
            return func(*args, **kwargs)
        key = _key(func)
        handler = _HANDLERS.get(key)
        if handler is not None:
            return handler(func, args, kwargs)
        if key in _POINTWISE:
            return _pointwise(func, args, kwargs)
        if key in _META:
            return func(*args, **kwargs)
        raise SpatialError(f"spatial partitioning cannot partition {key} (an op that reached a band of H rows)")


@contextlib.contextmanager
def _active():
    _TLS.active = True
    try:
        with SpatialMode():
            yield
    finally:
        _TLS.active = False


def is_active() -> bool:
    """Whether this thread runs inside spatial partitioning (a model's forward on bands of H rows)."""
    return getattr(_TLS, "active", False)


def current() -> Callable[[], Any]:
    """A factory of the context this thread's forward runs in: inside spatial
    partitioning, one that enters it again where it is not active (a remat
    segment's recompute, in the backward); else a null context."""
    was = getattr(_TLS, "active", False)
    return lambda: _active() if was and not getattr(_TLS, "active", False) else contextlib.nullcontext()


# --------------------------------------------------------------------------- #
# Modules that compute over every position of the image
# --------------------------------------------------------------------------- #


def _gather_modules() -> tuple:
    from sota_imagenet_tpu_torch.models.attention import FCA, UFO, XCA
    from sota_imagenet_tpu_torch.models.layers import ScaledStdConv

    return (XCA, UFO, FCA), ScaledStdConv


def _gather_in(module, args):
    if not getattr(_TLS, "active", False) or not args or band_of(args[0]) is None:
        return None
    module.__dict__.setdefault("_sp_bands", []).append(band_of(args[0]))
    return (gather(args[0]), *args[1:])


def _band_out(module, args, out):
    bands = module.__dict__.get("_sp_bands")
    if not bands:
        return None
    dim, bounds = bands.pop()
    lo, hi = bounds[par.axis_index("spatial")]
    return with_band(out.narrow(dim, lo, hi - lo), (dim, bounds))


def prepare(model: torch.nn.Module) -> None:
    """Hook the modules of ``model`` that compute over every position (XCA,
    UFO, FCA, a CoordConv ``ScaledStdConv``): under spatial partitioning each
    runs on its input gathered over the spatial ranks and keeps its band of
    the output. Idempotent; the hooks do nothing outside the mode."""
    attention, conv = _gather_modules()
    for m in model.modules():
        if (isinstance(m, attention) or (isinstance(m, conv) and m.coord_conv)) and not getattr(m, "_sp_hooked", False):
            m.register_forward_pre_hook(_gather_in)
            m.register_forward_hook(_band_out)
            m._sp_hooked = True


def forward(model: torch.nn.Module, images: torch.Tensor) -> torch.Tensor:
    """``model(images)`` (NHWC images, every spatial rank holding them whole):
    with ``mesh.spatial`` > 1 each rank runs the model on its band of H and
    the output (the logits) is every rank's; else the plain call."""
    if par.axis_size("spatial") == 1:
        return model(images)
    prepare(model)
    with _active():
        out = model(scatter(images, 1))
        if band_of(out) is not None:
            raise SpatialError("the model's output holds a band of H rows; spatial partitioning needs whole outputs")
    return out
