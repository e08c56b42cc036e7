"""Weight parametrizations (port of ``sota_imagenet_tpu/models/parametrize.py``;
reference callbacks.py:62-123 and the ``weight_standardization`` flag,
reference train.py:66-67).

A forward parametrization computes an effective weight from the stored one
on every forward, with the gradient flowing through the transform, in train
and in eval mode alike (torch's ``nn.utils.parametrize``). ``ParametrizedModel``
wraps a model with one: it computes the effective kernels and runs the
inner model on them through ``torch.func.functional_call``. The stored
parameters stay the raw kernels, under the inner model's own names: the
wrapper's ``named_parameters``, ``state_dict`` and checkpoints are the inner
model's, so the weight-decay mask, AGC's units and ``kernel_parameters``
read the same names with or without it.

Which kernels: the JAX predicates on the params tree (parametrize.py:23-36),
read off the port's weights plan (``utils.weights.conv_kernels``): a conv
kernel is a 4-d ``kernel`` leaf of the JAX model (ECA's (k, 1, 1) kernel,
the Dense head and the norms are not); weight standardisation skips the
depthwise ones (in/groups == 1, OIHW ``weight.shape[1]``); spectral
normalization takes every conv kernel, ScaledStdConv's included.

Stateful spectral normalization keeps a persistent ``u``/``v`` pair per
kernel as buffers of the wrapper, under ``__spectral_norm__.<param name>.u``
and ``.v`` in its state_dict (the JAX state rides in
``batch_stats["__spectral_norm__"]``), so the EMA averages them and the
checkpoint stores them. ``v`` runs over the kernel's fan-in in the port's
(i, h, w) order, where the JAX package's runs (h, w, i).

Numerics as in the JAX package: the standardisation and the spectral
transform compute in float32 whatever the parameter dtype and cast back
(the conv then casts to the activation dtype); the zero-mean transform
stays in the parameter dtype.
"""

from __future__ import annotations

import zlib
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn

SPECTRAL_STATE_KEY = "__spectral_norm__"


def zero_mean_conv_weight(w: torch.Tensor) -> torch.Tensor:
    """Per-output-channel zero mean (ForwardWeightNorm ``use_std=False``)."""
    return w - w.mean(dim=(1, 2, 3), keepdim=True)


def normalize_conv_weight(w: torch.Tensor, gamma: float = 1.0, eps: float = 1e-6) -> torch.Tensor:
    """Scaled weight standardization (ForwardWeightNorm ``use_std=True``): per
    output channel, (w - mean) * rsqrt(var + eps) * gamma / sqrt(fan_in), the
    variance biased, in float32."""
    w32 = w.float()
    var, mean = torch.var_mean(w32, dim=(1, 2, 3), keepdim=True, correction=0)
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    return ((w32 - mean) * torch.rsqrt(var + eps) * (gamma * fan_in**-0.5)).to(w.dtype)


def _normalized(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x).clamp(min=eps)


def power_iteration(mat: torch.Tensor, u: torch.Tensor, v: torch.Tensor, n: int, eps: float = 1e-12):
    """``n`` power iterations on the (out, fan_in) matrix ``mat``, in the JAX
    order: v = normalize(mat^T u), then u = normalize(mat v)."""
    for _ in range(n):
        v = _normalized(mat.T @ u, eps)
        u = _normalized(mat @ v, eps)
    return u, v


def spectral_normalize(w: torch.Tensor, n_iters: int = 5, eps: float = 1e-12) -> torch.Tensor:
    """w / sigma_max, stateless: ``n_iters`` power iterations from u = 1/sqrt(out)."""
    mat = w.reshape(w.shape[0], -1).float()
    u = torch.full((mat.shape[0],), mat.shape[0] ** -0.5, dtype=torch.float32, device=w.device)
    u, v = power_iteration(mat, u, torch.zeros(mat.shape[1], device=w.device), n_iters, eps)
    sigma = v @ (mat.T @ u)
    return (w.float() / sigma.clamp(min=eps)).to(w.dtype)


class KernelTransform:
    """A stateless transform of every selected conv kernel (the port of a
    JAX ``params -> params`` transform): ``select`` names the kernels of a
    model, ``__call__`` maps {name: kernel} to {name: effective kernel}."""

    stateful = False

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor], ungrouped_only: bool):
        self.fn, self.ungrouped_only = fn, ungrouped_only

    def select(self, model: nn.Module) -> List[str]:
        from sota_imagenet_tpu_torch.utils.weights import conv_kernels

        return list(conv_kernels(model, ungrouped=self.ungrouped_only))

    def __call__(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {n: self.fn(w) for n, w in params.items()}


def weight_standardization_fn(gamma: Optional[float] = None) -> KernelTransform:
    """The transform of ForwardWeightNorm and of ``weight_standardization``
    (reference conv_to_ws_conv): zero mean without ``gamma``, scaled WS with
    it; depthwise kernels are left alone."""
    if gamma is None:
        return KernelTransform(zero_mean_conv_weight, ungrouped_only=True)
    return KernelTransform(lambda w: normalize_conv_weight(w, gamma), ungrouped_only=True)


def spectral_norm_fn(n_iters: int = 5) -> KernelTransform:
    return KernelTransform(lambda w: spectral_normalize(w, n_iters), ungrouped_only=False)


class SpectralNormParametrization:
    """torch's ``spectral_norm`` semantics (the reference ForwardSpectralNorm,
    callbacks.py:87-101; parametrize.py:103-169 of the JAX package): a
    persistent ``u``/``v`` pair per conv kernel, ``n_iters`` power iterations
    on each training forward, u and v constants to autograd (sigma = u . W v
    differentiates through W only), eval reusing the stored pair. The
    initial pair: u drawn from a normal seeded by the crc32 of the
    parameter's name, then 15 iterations (JAX seeds threefry with its flax
    path's crc32, which no torch generator reproduces: tests carry the JAX
    state over)."""

    stateful = True

    def __init__(self, n_iters: int = 1, eps: float = 1e-12):
        self.n_iters, self.eps = n_iters, eps

    def select(self, model: nn.Module) -> List[str]:
        from sota_imagenet_tpu_torch.utils.weights import conv_kernels

        return list(conv_kernels(model))

    def init_state(self, name: str, w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        mat = w.detach().reshape(w.shape[0], -1).float().cpu()
        gen = torch.Generator().manual_seed(zlib.crc32(name.encode()) & 0x7FFFFFFF)
        u = _normalized(torch.randn(mat.shape[0], generator=gen), self.eps)
        return power_iteration(mat, u, torch.zeros(mat.shape[1]), 15, self.eps)

    def __call__(self, params: Dict[str, torch.Tensor], state: Dict[str, Tuple[torch.Tensor, torch.Tensor]], update: bool):
        """{name: effective kernel}; with ``update`` the stored pairs first move ``n_iters`` iterations, in place."""
        out = {}
        for name, w in params.items():
            u, v = state[name]
            mat = w.reshape(w.shape[0], -1).float()
            if update:
                with torch.no_grad():
                    nu, nv = power_iteration(mat.detach(), u.float(), v.float(), self.n_iters, self.eps)
                    u.copy_(nu)
                    v.copy_(nv)
            # copies: a later microbatch updates the buffers in place before this one's backward
            uc, vc = u.detach().float().clone(), v.detach().float().clone()
            sigma = uc @ (mat @ vc)
            out[name] = (w.float() / sigma.clamp(min=self.eps)).to(w.dtype)
        return out


def _holder(root: nn.Module, name: str) -> nn.Module:
    """The module at dotted ``name`` under ``root``, made of empty modules where missing."""
    m = root
    for part in name.split("."):
        if part not in m._modules:
            m.add_module(part, nn.Module())
        m = m._modules[part]
    return m


class ParametrizedModel(nn.Module):
    """``model`` with forward parametrizations, active in train and eval
    (parametrize.py:190-246 of the JAX package). Wrapping a
    ParametrizedModel again composes: the new transform applies first, then
    the inner ones, as the nested JAX wrappers apply them. At most one of
    them may keep state."""

    def __init__(self, model: nn.Module, param_fn):
        super().__init__()
        fns = [param_fn]
        if isinstance(model, ParametrizedModel):
            fns += model.fns
            model = model.model
        if sum(fn.stateful for fn in fns) > 1:
            raise ValueError("ParametrizedModel holds at most one stateful parametrization")
        self.model = model
        self.fns = fns
        self.selected = [fn.select(model) for fn in fns]
        self._stateful = next((i for i, fn in enumerate(fns) if fn.stateful), None)
        if self._stateful is not None:
            root = nn.Module()
            for name in self.stateful_names():
                w = self.model.get_parameter(name)
                h = _holder(root, name)
                h.register_buffer("u", torch.zeros(w.shape[0]))
                h.register_buffer("v", torch.zeros(w[0].numel()))
            self.add_module(SPECTRAL_STATE_KEY, root)
            self.reset_state()

    def stateful_names(self) -> List[str]:
        """The parameters whose transform keeps a state (in the model's order)."""
        return [] if self._stateful is None else self.selected[self._stateful]

    def _state(self) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        root = self._modules[SPECTRAL_STATE_KEY]
        return {n: (root.get_buffer(f"{n}.u"), root.get_buffer(f"{n}.v")) for n in self.stateful_names()}

    @torch.no_grad()
    def reset_state(self) -> None:
        """The stateful transform's initial state, from the current weights."""
        if self._stateful is None:
            return
        fn = self.fns[self._stateful]
        for name, (u, v) in self._state().items():
            nu, nv = fn.init_state(name, self.model.get_parameter(name))
            u.copy_(nu)
            v.copy_(nv)

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if hasattr(self.model, "reset_parameters"):
            self.model.reset_parameters(generator)
        self.reset_state()

    def _effective(self, params: Dict[str, torch.Tensor], state, update: bool) -> Dict[str, torch.Tensor]:
        eff: Dict[str, torch.Tensor] = {}
        for i, (fn, names) in enumerate(zip(self.fns, self.selected)):
            sub = {n: eff.get(n, params[n]) for n in names}
            eff.update(fn(sub, state, update) if i == self._stateful else fn(sub))
        return eff

    def effective_parameters(self) -> Dict[str, torch.Tensor]:
        """{name: effective kernel} for every transformed parameter; a training
        forward also moves the stateful transform's state."""
        state = self._state() if self._stateful is not None else {}
        return self._effective(dict(self.model.named_parameters()), state, self.training)

    def functional_state(self, state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The inner model's {name: tensor} for ``torch.func.functional_call``
        from an explicit ``state_dict`` of this wrapper (raw kernels, buffers,
        the spectral state), with the effective kernels computed from it as an
        eval forward does: the stateful transform reads its u/v from the dict
        and moves nothing. A serving program traced through it runs the
        parametrizations inside its graph."""
        key = SPECTRAL_STATE_KEY + "."
        inner = {k: v for k, v in state_dict.items() if not k.startswith(key)}
        state = {n: (state_dict[f"{key}{n}.u"], state_dict[f"{key}{n}.v"]) for n in self.stateful_names()}
        inner.update(self._effective(inner, state, False))
        return inner

    def forward(self, *args, **kwargs):
        return torch.func.functional_call(self.model, self.effective_parameters(), args, kwargs)

    # the inner model's names: the wrapper adds no prefix of its own
    def named_parameters(self, prefix: str = "", recurse: bool = True, remove_duplicate: bool = True):
        return self.model.named_parameters(prefix, recurse, remove_duplicate)

    def named_buffers(self, prefix: str = "", recurse: bool = True, remove_duplicate: bool = True):
        yield from self.model.named_buffers(prefix, recurse, remove_duplicate)
        if self._stateful is not None:
            key = f"{prefix}.{SPECTRAL_STATE_KEY}" if prefix else SPECTRAL_STATE_KEY
            yield from self._modules[SPECTRAL_STATE_KEY].named_buffers(key, recurse, remove_duplicate)

    def state_dict(self, *args, destination=None, prefix: str = "", keep_vars: bool = False):
        out = self.model.state_dict(*args, destination=destination, prefix=prefix, keep_vars=keep_vars)
        if self._stateful is not None:
            self._modules[SPECTRAL_STATE_KEY].state_dict(
                destination=out, prefix=f"{prefix}{SPECTRAL_STATE_KEY}.", keep_vars=keep_vars
            )
        return out

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        key = SPECTRAL_STATE_KEY + "."
        inner = {k: v for k, v in state_dict.items() if not k.startswith(key)}
        spectral = {k[len(key):]: v for k, v in state_dict.items() if k.startswith(key)}
        result = self.model.load_state_dict(inner, strict=strict, assign=assign)
        if self._stateful is not None:
            r = self._modules[SPECTRAL_STATE_KEY].load_state_dict(spectral, strict=strict, assign=assign)
            result.missing_keys.extend(key + k for k in r.missing_keys)
            result.unexpected_keys.extend(key + k for k in r.unexpected_keys)
        elif spectral:
            if strict:
                raise RuntimeError(f"unexpected spectral-norm state in state_dict: {sorted(spectral)[:4]}")
            result.unexpected_keys.extend(key + k for k in spectral)
        return result


@torch.no_grad()
def backward_weight_norm(model: torch.nn.Module) -> None:
    """Backward centered weight normalization, applied to the parameters after
    each optimizer step (reference WeightNorm callback, callbacks.py:104-123):
    each output filter of every kernel with at least 64 elements gets zero
    mean and unit L2 norm, computed in float32 and cast back. A filter is a
    row of the port's (O, ...) kernel, a column of the JAX (..., O) one."""
    from sota_imagenet_tpu_torch.utils.weights import kernel_parameters

    for w in kernel_parameters(model).values():
        if w.dim() < 2 or w.numel() < 64:
            continue
        mat = w.reshape(w.shape[0], -1).float()
        mat = mat - mat.mean(dim=1, keepdim=True)
        mat = mat / torch.linalg.vector_norm(mat, dim=1, keepdim=True).clamp(min=1e-12)
        w.copy_(mat.reshape(w.shape))
