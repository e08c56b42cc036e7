"""The elementwise chains of the ECA-NFNet block in one pass each way
(``csrc/nf_fused.cu``; used by ``models/nfnet.py`` on the card).

* ``nf_ws([(weight, gain, scale, eps), ...])`` = each
  ``ScaledStdConv.standardized_weight`` cast to bf16: a conv's weight
  standardised over its fan-in per output channel and scaled by ``gain *
  scale``; a group of convs (a block's) in one launch each way, where op by
  op each conv takes ~27.

* ``nf_act(x, bias, scale)`` = ``scale * silu(x + bias)``: every SiLU site of
  ``NFNet``, with the producing conv's bias folded in (``bias`` None for the
  block's pre-activation, ``scale`` gamma or gamma * beta).
* ``nf_tail(h, bias, shortcut, eca_weight, gain, mask, k)`` = ``shortcut +
  k_b * g[b, c] * (h + bias)``, the block after ``conv3``: ``g`` the ECA gate
  ``sigmoid(conv1d_3(mean_hw(h + bias)))`` (1 where ``eca_weight`` is None),
  ``k_b = k * gain * mask_b`` with ``k = alpha * attn_gain / keep_prob``, and
  exactly ``shortcut`` for a sample ``mask`` dropped (a select: the branch may
  hold inf or NaN).

Both are ``torch.autograd.Function``s with hand-derived backwards. A CUDA
tensor launches the kernels (bf16 channels-last activations, float32 inside,
one rounding at each output; the gradients of the bias, the ECA taps and the
gain summed in float32 in a fixed order) or raises; a CPU tensor takes the
plain versions, ``nf_act_reference`` / ``nf_act_grad_reference`` and
``nf_tail_reference`` / ``nf_tail_grad_reference``, ``nf_ws_reference`` /
``nf_ws_grad_reference``: the same float32 math
(float64 for float64 inputs) in torch ops, what the kernels are held against
on the card and what the CPU tests hold against autograd of the block's op by
op chain. The backward of ``nf_tail``, per sample b and channel c with
``z = h + bias``, ``P = sum_hw dy z``, ``D = sum_hw dy``::

    dg = k_b P,  dl = dg g (1 - g),  dm = conv1d_3^T(dl),  dh = dy k_b g + dm / HW
    d bias = sum_b (k_b g D + dm),   d taps_j = sum_bc dl m[c + j - 1],
    d gain = k sum_b mask_b sum_c g P,   d shortcut = dy

(no division by the gain, which the recipe starts at 0).

``launches`` counts each kernel's launches; ``fused`` and ``fallbacks`` count
the ``NFBlock`` calls on a CUDA tensor in training that took the kernels, and
those that took the op by op chain, by reason (``models/nfnet.py``
``kernel_path``).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from collections import Counter
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from sota_imagenet_tpu_torch.ops import cuda_build

_SOURCES = ("nf_fused.cu",)
VEC = 8  # bf16 channels a thread loads at once (kVec of csrc/nf_fused.cu): C must be a multiple
THREADS = 256  # threads a block (kThreads)
MAX_TAIL_CHANNELS = 6144  # nf_tail_gate_bwd keeps 2 * C floats in 48 KB of shared memory
MAX_WS = 8  # weights an nf_ws launch takes (kMaxWs)
_BLOCKS = 2048  # blocks a launch aims at (about two waves of 8 blocks on each of the H100's 132 SMs)

launches: Counter = Counter()  # kernel name -> launches
fused: Counter = Counter()  # "NFBlock" -> calls on a CUDA tensor in training that took the kernels
fallbacks: Counter = Counter()  # reason -> NFBlock calls on a CUDA tensor in training that took the plain chain

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGTYPES = {
    "nf_act_fwd": [_P, _P, _P, _LL, _I, _I, _I, _I, _F, _P],
    "nf_act_bwd": [_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _F, _P],
    "nf_colsum": [_P, _P, _I, _I, _P],
    "nf_tail_mean": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "nf_tail_fwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    "nf_tail_sums": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "nf_tail_gate_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "nf_tail_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "nf_ws_fwd": [_I, _P, _P, _P, _P],
    "nf_ws_bwd": [_I, _P, _P, _P, _P],
}


@functools.lru_cache(maxsize=None)
def library() -> Dict[str, Callable[..., int]]:
    """Build (at first use) and load the kernel library: kernel name -> its typed launcher."""
    lib = cuda_build.load("nf_fused", _SOURCES)
    fns = {}
    for kernel, argtypes in _ARGTYPES.items():
        fn = getattr(lib, f"{kernel}_launch")
        fn.restype, fn.argtypes = ctypes.c_int, argtypes
        fns[kernel] = fn
    return fns


def _launch(fns: Dict[str, Callable[..., int]], kernel: str, *args) -> None:
    err = fns[kernel](*args)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed with CUDA error {err}")
    launches[kernel] += 1


_CURRENT = contextlib.nullcontext()


def _on(t: torch.Tensor):
    """(a guard onto ``t``'s device, the handle of that device's current
    stream), once a Function call: the launchers launch on the calling
    thread's device, so the guard enters ``t``'s where it is not the current
    one, and is a no-op where it is."""
    index = t.get_device()
    guard = _CURRENT if index == torch.cuda.current_device() else torch.cuda.device(index)
    return guard, torch._C._cuda_getCurrentRawStream(index)


# ------------------------------------------------------------------ tiling ---


def tile_x(vectors: int) -> int:
    """blockDim.x: the 8-channel vectors of a block's channel tile, the
    largest power of two up to 32 that divides ``vectors`` (= C / 8), so
    no tile is ragged."""
    tx = 32
    while vectors % tx:
        tx //= 2
    return tx


def reduce_tile_x(vectors: int, batch: int) -> int:
    """blockDim.x of the reductions over H*W, one block per (sample, tile):
    narrower tiles where ``batch`` samples give too few blocks (a 56x56 map
    of 256 channels at batch 256: 4 vectors, 2,048 blocks)."""
    tx = tile_x(vectors)
    while tx > 4 and batch * (vectors // tx) < _BLOCKS:
        tx //= 2
    return tx


def chunks(rows: int, ty: int, blocks_across: int) -> Tuple[int, int]:
    """(rows a block walks, blocks along the rows): about ``_BLOCKS`` blocks
    with the ``blocks_across`` the other grid dimensions give, a chunk a
    multiple of ``ty`` = blockDim.y."""
    n = max(1, min(-(-rows // ty), -(-_BLOCKS // blocks_across)))
    chunk = -(-rows // n)
    chunk = -(-chunk // ty) * ty
    return chunk, -(-rows // chunk)


# ------------------------------------------------------ the plain versions ---


def _compute_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.promote_types(t.dtype, torch.float32)


def _per_channel(v: Optional[torch.Tensor], dt: torch.dtype):
    return 0.0 if v is None else v.to(dt).view(1, -1, 1, 1)


def nf_act_reference(x: torch.Tensor, bias: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """``scale * silu(x + bias)`` in float32 (float64 for float64 ``x``), in ``x``'s dtype."""
    z = x.to(_compute_dtype(x)) + _per_channel(bias, _compute_dtype(x))
    return (scale * (z * torch.sigmoid(z))).to(x.dtype)


def nf_act_grad_reference(
    dy: torch.Tensor, x: torch.Tensor, bias: Optional[torch.Tensor], scale: float
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dx in ``x``'s dtype, the bias's gradient summed over B, H, W in float32 or None)."""
    dt = _compute_dtype(x)
    z = x.to(dt) + _per_channel(bias, dt)
    s = torch.sigmoid(z)
    dx = dy.to(dt) * scale * (s * (1.0 + z * (1.0 - s)))
    db = None if bias is None else dx.sum(dim=(0, 2, 3)).to(bias.dtype)
    return dx.to(x.dtype), db


def _kept(mask: Optional[torch.Tensor], batch: int, device) -> torch.Tensor:
    return torch.ones(batch, dtype=torch.bool, device=device) if mask is None else mask.reshape(batch)


def _gate(m: torch.Tensor, eca_weight: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(F.conv1d(m[:, None, :], eca_weight.to(m.dtype), padding=1)[:, 0, :])


def nf_tail_reference(
    h: torch.Tensor,
    bias: Optional[torch.Tensor],
    shortcut: torch.Tensor,
    eca_weight: Optional[torch.Tensor],
    gain: Optional[torch.Tensor],
    mask: Optional[torch.Tensor],
    k: float,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(the block's output in ``h``'s dtype, ECA's pooled (B, C) vector or
    None): ``shortcut + k_b g (h + bias)``, exactly ``shortcut`` where
    ``mask`` dropped the sample (whose pooled vector reads 0)."""
    dt = _compute_dtype(h)
    b = h.shape[0]
    kept = _kept(mask, b, h.device)
    z = h.to(dt) + _per_channel(bias, dt)
    kb = torch.tensor(k, dtype=dt, device=h.device) * (1.0 if gain is None else gain.to(dt))
    m = g = None
    if eca_weight is not None:
        m = torch.where(kept[:, None], z.mean(dim=(2, 3)), 0.0)
        g = _gate(m, eca_weight)
    gk = kb * (1.0 if g is None else g)
    branch = shortcut.to(dt) + (gk.view(b, -1, 1, 1) if g is not None else gk) * z
    return torch.where(kept.view(b, 1, 1, 1), branch.to(h.dtype), shortcut), m


def nf_tail_grad_reference(
    dy: torch.Tensor,
    h: torch.Tensor,
    bias: Optional[torch.Tensor],
    m: Optional[torch.Tensor],
    eca_weight: Optional[torch.Tensor],
    gain: Optional[torch.Tensor],
    mask: Optional[torch.Tensor],
    k: float,
):
    """(dh in ``h``'s dtype, d bias, d eca_weight, d gain), the last three in
    their parameters' dtypes or None where absent; ``m`` is
    ``nf_tail_reference``'s pooled vector. The shortcut's gradient is ``dy``."""
    dt = _compute_dtype(h)
    b, c, hh, ww = h.shape
    kept = _kept(mask, b, h.device)[:, None]  # (B, 1)
    z = h.to(dt) + _per_channel(bias, dt)
    dyf = dy.to(dt)
    p, d = (dyf * z).sum(dim=(2, 3)), dyf.sum(dim=(2, 3))  # (B, C)
    k_t = torch.tensor(k, dtype=dt, device=h.device)
    kb = k_t * (1.0 if gain is None else gain.to(dt))
    dw = None
    if eca_weight is not None:
        g = _gate(m.to(dt), eca_weight)
        dl = torch.where(kept, kb * p * (g * (1.0 - g)), 0.0)
        dm = F.conv_transpose1d(dl[:, None, :], eca_weight.to(dt), padding=1)[:, 0, :]
        mp = F.pad(m.to(dt), (1, 1))
        dw = torch.stack([torch.where(kept, dl * mp[:, j : j + c], 0.0).sum() for j in range(3)])
        dw = dw.view_as(eca_weight).to(eca_weight.dtype)
    else:
        g, dm = torch.ones_like(p), torch.zeros_like(p)
    gk = torch.where(kept, kb * g, 0.0)
    dh = dyf * gk[:, :, None, None] + (dm / (hh * ww))[:, :, None, None]
    dh = torch.where(kept[:, :, None, None], dh, 0.0).to(h.dtype)
    db = None if bias is None else torch.where(kept, kb * g * d + dm, 0.0).sum(dim=0).to(bias.dtype)
    dgain = None
    if gain is not None:
        dgain = torch.where(kept[:, 0], k_t * (g * p).sum(dim=1), 0.0).sum().view_as(gain).to(gain.dtype)
    return dh, db, dw, dgain


def _ws_terms(w: torch.Tensor, gain: Optional[torch.Tensor], scale: float, eps: float):
    dt = _compute_dtype(w)
    wf = w.to(dt)
    var, mean = torch.var_mean(wf, dim=(1, 2, 3), keepdim=True, correction=0)
    r = torch.rsqrt(var + eps)
    a = scale if gain is None else (gain.to(dt) * scale).view(-1, 1, 1, 1)
    return (wf - mean) * r, r, a


def nf_ws_reference(w: torch.Tensor, gain: Optional[torch.Tensor], scale: float, eps: float) -> torch.Tensor:
    """``ScaledStdConv.standardized_weight``: ``(w - mean) rsqrt(var + eps) gain scale`` per output
    channel over the fan-in, biased variance, in float32 (float64 for a float64 ``w``)."""
    t, _, a = _ws_terms(w, gain, scale, eps)
    return t * a


def nf_ws_grad_reference(
    dy: torch.Tensor, w: torch.Tensor, gain: Optional[torch.Tensor], scale: float, eps: float
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(d weight in ``w``'s dtype, d gain or None): with ``t`` the standardised
    weight, ``S1 = sum dy``, ``S2 = sum dy t`` over each output channel's n
    values, ``dw = r a (dy - S1 / n - t S2 / n)``, ``d gain = scale S2``."""
    t, r, a = _ws_terms(w, gain, scale, eps)
    g = dy.to(t.dtype)
    m1, m2 = g.mean(dim=(1, 2, 3), keepdim=True), (g * t).mean(dim=(1, 2, 3), keepdim=True)
    dw = (r * a * (g - m1 - t * m2)).to(w.dtype)
    dgain = None if gain is None else (scale * (g * t).sum(dim=(1, 2, 3))).to(gain.dtype).view_as(gain)
    return dw, dgain


# ------------------------------------------------------------- the kernels ---


def _nhwc(t: torch.Tensor, what: str) -> torch.Tensor:
    """``t`` as a 16-byte-aligned channels-last bf16 CUDA tensor (a copy only where it is not one)."""
    if t.dtype != torch.bfloat16 or t.dim() != 4 or t.shape[1] % VEC:
        raise ValueError(f"{what} must be a 4-d bf16 tensor with channels a multiple of {VEC}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    return _rows(t)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """A 4-d bf16 ``t`` as channels-last and 16-byte aligned: a gradient, whose
    dtype and shape autograd holds to the forward's output."""
    t = t.contiguous(memory_format=torch.channels_last)
    return t if t.data_ptr() % 16 == 0 else t.clone(memory_format=torch.channels_last)


def _vector(v: Optional[torch.Tensor], numel: int, what: str) -> Optional[torch.Tensor]:
    """A float32 parameter as a contiguous, 16-byte-aligned tensor of ``numel`` values, or None."""
    if v is None:
        return None
    if v.dtype != torch.float32 or v.numel() != numel:
        raise ValueError(f"{what} must hold {numel} float32 values, got {tuple(v.shape)} {v.dtype}")
    return v if v.is_contiguous() and v.data_ptr() % 16 == 0 else v.detach().clone()


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _colsum(fns, partial: torch.Tensor, stream: int) -> torch.Tensor:
    rows, n = partial.shape
    out = torch.empty(n, dtype=torch.float32, device=partial.device)
    _launch(fns, "nf_colsum", partial.data_ptr(), out.data_ptr(), rows, n, stream)
    return out


def _act_kernel(x: torch.Tensor, bias: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    fns = library()
    b, c, h, w = x.shape
    rows, tx = b * h * w, tile_x(c // VEC)
    chunk, n = chunks(rows, THREADS // tx, c // VEC // tx)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    guard, stream = _on(x)
    with guard:
        _launch(fns, "nf_act_fwd", x.data_ptr(), _ptr(bias), y.data_ptr(), rows, c, tx, chunk, n, scale, stream)
    return y


def _act_grad_kernel(dy: torch.Tensor, x: torch.Tensor, bias: Optional[torch.Tensor], scale: float):
    fns = library()
    b, c, h, w = x.shape
    rows, tx = b * h * w, tile_x(c // VEC)
    chunk, n = chunks(rows, THREADS // tx, c // VEC // tx)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    partial = None if bias is None else torch.empty((n, c), dtype=torch.float32, device=x.device)
    guard, stream = _on(x)
    with guard:
        _launch(fns, "nf_act_bwd", dy.data_ptr(), x.data_ptr(), _ptr(bias), dx.data_ptr(), _ptr(partial), rows, c,
                tx, chunk, n, scale, stream)
        db = None if partial is None else _colsum(fns, partial, stream)
    return dx, db


def _tail_kernel(h, bias, shortcut, eca_weight, gain, mask, k):
    fns = library()
    b, c, hh, ww = h.shape
    hw, vectors = hh * ww, c // VEC
    m = None if eca_weight is None else torch.empty((b, c), dtype=torch.float32, device=h.device)
    out = torch.empty_like(h, memory_format=torch.channels_last)
    tx = tile_x(vectors)
    chunk, n = chunks(hw, THREADS // tx, b * (vectors // tx))
    guard, stream = _on(h)
    with guard:
        if m is not None:
            _launch(fns, "nf_tail_mean", h.data_ptr(), _ptr(bias), _ptr(mask), m.data_ptr(), b, hw, c,
                    reduce_tile_x(vectors, b), stream)
        _launch(fns, "nf_tail_fwd", h.data_ptr(), _ptr(bias), shortcut.data_ptr(), _ptr(m), _ptr(eca_weight),
                _ptr(gain), _ptr(mask), out.data_ptr(), b, hw, c, tx, chunk, n, k, stream)
    return out, m


def _tail_grad_kernel(dy, h, bias, m, eca_weight, gain, mask, k):
    fns = library()
    b, c, hh, ww = h.shape
    hw, vectors = hh * ww, c // VEC
    p, d, gk, ds = torch.empty((4, b, c), dtype=torch.float32, device=h.device)  # P, D, k_b g, dm
    terms = torch.empty((b, c + 4), dtype=torch.float32, device=h.device)
    dh = torch.empty_like(h, memory_format=torch.channels_last)
    tx = tile_x(vectors)
    chunk, n = chunks(hw, THREADS // tx, b * (vectors // tx))
    guard, stream = _on(h)
    with guard:
        _launch(fns, "nf_tail_sums", dy.data_ptr(), h.data_ptr(), _ptr(bias), _ptr(mask), p.data_ptr(), d.data_ptr(),
                b, hw, c, reduce_tile_x(vectors, b), stream)
        _launch(fns, "nf_tail_gate_bwd", p.data_ptr(), d.data_ptr(), _ptr(m), _ptr(eca_weight), _ptr(gain),
                _ptr(mask), gk.data_ptr(), ds.data_ptr(), terms.data_ptr(), b, hw, c, k, stream)
        _launch(fns, "nf_tail_bwd", dy.data_ptr(), gk.data_ptr(), ds.data_ptr(), _ptr(mask), dh.data_ptr(), b, hw, c,
                tx, chunk, n, stream)
        col = _colsum(fns, terms, stream)
    db = None if bias is None else col[:c]
    dw = None if eca_weight is None else col[c : c + 3].view(1, 1, 3)
    dgain = None if gain is None else col[c + 3].view(())
    return dh, db, dw, dgain


def _row_order(t: torch.Tensor) -> Optional[torch.memory_format]:
    """The layout in which each output channel's fan-in is one contiguous row, or None."""
    for fmt in (torch.contiguous_format, torch.channels_last):
        if t.is_contiguous(memory_format=fmt):
            return fmt
    return None


def _ws_kernel(weights: Sequence[torch.Tensor], gains: Sequence[Optional[torch.Tensor]], scales: Sequence[float],
               epss: Sequence[float]):
    """(the bf16 standardised weights, each (O, 2) float32 (mu, r)) of up to
    ``MAX_WS`` row-ordered float32 weights, one launch."""
    fns = library()
    count = len(weights)
    ys = [torch.empty_like(w, dtype=torch.bfloat16) for w in weights]
    rows = [w.shape[0] for w in weights]
    stats = torch.empty((sum(rows), 2), dtype=torch.float32, device=weights[0].device).split(rows)
    ptrs = (_P * (4 * count))(*(p for j in range(count) for p in (
        weights[j].data_ptr(), _ptr(gains[j]), ys[j].data_ptr(), stats[j].data_ptr())))
    dims = (_I * (2 * count))(*(v for w in weights for v in (w.shape[0], w.numel() // w.shape[0])))
    consts = (_F * (2 * count))(*(v for pair in zip(scales, epss) for v in pair))
    guard, stream = _on(weights[0])
    with guard:
        _launch(fns, "nf_ws_fwd", count, ptrs, dims, consts, stream)
    return ys, stats


def _ws_grad_kernel(dys: Sequence[torch.Tensor], weights: Sequence[torch.Tensor],
                    gains: Sequence[Optional[torch.Tensor]], stats: Sequence[torch.Tensor], scales: Sequence[float],
                    orders: Optional[Sequence[torch.memory_format]] = None):
    """(each weight's gradient, each gain's or None): ``dys`` bf16 in any
    layout, copied to the weight's rows (``orders``, each weight's
    ``_row_order`` where the caller holds it) where they are not in them."""
    fns = library()
    count = len(weights)
    orders = orders or [_row_order(w) for w in weights]
    dys = [dy.to(torch.bfloat16).contiguous(memory_format=fmt) for dy, fmt in zip(dys, orders)]
    dws = [torch.empty_like(w) for w in weights]
    dgains = [None if g is None else torch.empty_like(g) for g in gains]
    ptrs = (_P * (6 * count))(*(p for j in range(count) for p in (
        dys[j].data_ptr(), weights[j].data_ptr(), _ptr(gains[j]), stats[j].data_ptr(), dws[j].data_ptr(),
        _ptr(dgains[j]))))
    dims = (_I * (2 * count))(*(v for w in weights for v in (w.shape[0], w.numel() // w.shape[0])))
    consts = (_F * (2 * count))(*(v for s in scales for v in (s, 0.0)))
    guard, stream = _on(weights[0])
    with guard:
        _launch(fns, "nf_ws_bwd", count, ptrs, dims, consts, stream)
    return dws, dgains


# ------------------------------------------------------------- the Functions ---


class _Act(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias, scale):
        ctx.scale = scale
        if x.device.type == "cuda":
            x = _nhwc(x, "x")
            bias = _vector(bias, x.shape[1], "bias")
            ctx.save_for_backward(x, bias)
            return _act_kernel(x, bias, scale)
        ctx.save_for_backward(x, bias)
        return nf_act_reference(x, bias, scale)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, bias = ctx.saved_tensors  # checked in the forward
        if x.device.type == "cuda":
            dx, db = _act_grad_kernel(_rows(dy), x, bias, ctx.scale)
        else:
            dx, db = nf_act_grad_reference(dy, x, bias, ctx.scale)
        return dx, db, None


class _Tail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, bias, shortcut, eca_weight, gain, mask, k):
        ctx.k = k
        if h.device.type == "cuda":
            h, shortcut = _nhwc(h, "h"), _nhwc(shortcut, "shortcut")
            if shortcut.shape != h.shape:
                raise ValueError(f"shortcut {tuple(shortcut.shape)} and h {tuple(h.shape)} differ")
            if h.shape[1] > MAX_TAIL_CHANNELS:
                raise ValueError(f"nf_tail takes at most {MAX_TAIL_CHANNELS} channels, got {h.shape[1]}")
            bias = _vector(bias, h.shape[1], "bias")
            eca_weight, gain = _vector(eca_weight, 3, "eca_weight"), _vector(gain, 1, "gain")
            if mask is not None:
                if mask.dtype != torch.bool or mask.numel() != h.shape[0]:
                    raise ValueError(f"mask must hold {h.shape[0]} bools, got {tuple(mask.shape)} {mask.dtype}")
                mask = mask.reshape(-1).contiguous()
            out, m = _tail_kernel(h, bias, shortcut, eca_weight, gain, mask, k)
        else:
            out, m = nf_tail_reference(h, bias, shortcut, eca_weight, gain, mask, k)
        ctx.save_for_backward(h, bias, m, eca_weight, gain, mask)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        h, bias, m, eca_weight, gain, mask = ctx.saved_tensors  # checked in the forward
        if h.device.type == "cuda":
            dh, db, dw, dgain = _tail_grad_kernel(_rows(dy), h, bias, m, eca_weight, gain, mask, ctx.k)
        else:
            dh, db, dw, dgain = nf_tail_grad_reference(dy, h, bias, m, eca_weight, gain, mask, ctx.k)
        return dh, db, dy, dw, dgain, None, None


class _WS(torch.autograd.Function):
    """A group of weights: ``apply(consts, dtype, w_0, gain_0, w_1, gain_1, ...)``
    with ``consts`` ((scale_0, eps_0), ...), one launch each way on the card."""

    @staticmethod
    def forward(ctx, consts, dtype, *tensors):
        weights, gains = list(tensors[0::2]), list(tensors[1::2])
        ctx.consts = consts
        if weights[0].device.type == "cuda":
            if len(weights) > MAX_WS or dtype != torch.bfloat16:
                raise ValueError(f"nf_ws takes at most {MAX_WS} weights to bf16, got {len(weights)} to {dtype}")
            ctx.orders = []
            for j, w in enumerate(weights):
                if w.dtype != torch.float32 or w.dim() != 4:
                    raise ValueError(f"nf_ws takes 4-d float32 weights, got {tuple(w.shape)} {w.dtype}")
                fmt = _row_order(w)
                if fmt is None:
                    weights[j], fmt = w.contiguous(), torch.contiguous_format
                ctx.orders.append(fmt)
                gains[j] = _vector(gains[j], w.shape[0], "gain")
            ys, stats = _ws_kernel(weights, gains, [c[0] for c in consts], [c[1] for c in consts])
            ctx.save_for_backward(*weights, *gains, *stats)
            return tuple(ys)
        ctx.save_for_backward(*weights, *gains)
        return tuple(nf_ws_reference(w, g, scale, eps).to(dtype) for w, g, (scale, eps) in zip(weights, gains, consts))

    @staticmethod
    @once_differentiable
    def backward(ctx, *dys):
        count, saved = len(dys), ctx.saved_tensors  # checked in the forward
        weights, gains = saved[:count], saved[count : 2 * count]
        if weights[0].device.type == "cuda":
            dws, dgains = _ws_grad_kernel(dys, weights, gains, saved[2 * count :], [c[0] for c in ctx.consts],
                                          ctx.orders)
        else:
            grads = [nf_ws_grad_reference(dy, w, g, scale, eps) for dy, w, g, (scale, eps) in
                     zip(dys, weights, gains, ctx.consts)]
            dws, dgains = [g[0] for g in grads], [g[1] for g in grads]
        return (None, None, *(t for pair in zip(dws, dgains) for t in pair))


def nf_ws(convs: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor], float, float]],
          dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
    """``ScaledStdConv.standardized_weight()`` in ``dtype`` of each ``(weight,
    gain, scale, eps)`` of ``convs`` (module docstring), at most ``MAX_WS`` of
    them, one launch each way on the card: ``weight`` (O, I, kh, kw), ``gain``
    O values or None (1)."""
    consts = tuple((scale, eps) for _, _, scale, eps in convs)
    return _WS.apply(consts, dtype, *(t for w, g, _, _ in convs for t in (w, g)))


def nf_act(x: torch.Tensor, bias: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """``scale * silu(x + bias)`` (module docstring); ``bias`` None adds nothing."""
    return _Act.apply(x, bias, scale)


def nf_tail(
    h: torch.Tensor,
    bias: Optional[torch.Tensor],
    shortcut: torch.Tensor,
    eca_weight: Optional[torch.Tensor],
    gain: Optional[torch.Tensor],
    mask: Optional[torch.Tensor],
    k: float,
) -> torch.Tensor:
    """``shortcut + k * gain * mask_b * g[b, c] * (h + bias)``, exactly
    ``shortcut`` where ``mask`` dropped the sample (module docstring). ``mask``
    is None (every sample kept) or B bools; ``eca_weight`` the (1, 1, 3) ECA
    taps or None (no gate); ``gain`` a one-value parameter or None (1)."""
    return _Tail.apply(h, bias, shortcut, eca_weight, gain, mask, k)
