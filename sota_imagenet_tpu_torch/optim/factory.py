"""Optimizer factory: config dict → ``torch.optim`` optimizer (port of
``sota_imagenet_tpu/optim/factory.py``:86-101,217).

The JAX package builds ``optax.chain(add_decayed_weights(wd, mask),
trace(momentum, nesterov), scale_by_learning_rate(lr))``: decayed weights
are added to the gradient, then the momentum trace b = m·b + g, then -lr·b.
That is ``torch.optim.SGD`` with ``dampening=0``; the weight-decay mask
becomes two parameter groups. The learning rate is set on the groups by the
train step from the phase schedule (train/schedule.py), so the optimizer is
built with lr 0 and the config's ``lr`` is ignored, as in the JAX package.

``adamw`` is optax's chain ``scale_by_adam`` -> masked
``add_decayed_weights`` -> ``scale_by_learning_rate`` (factory.py:104-117):
p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p). ``torch.optim.AdamW``
computes p * (1 - lr * wd) - lr * m_hat / (sqrt(v_hat) + eps), the same
value to rounding, with eps outside the square root in both.

``lamb`` is optax's chain ``scale_by_adam`` -> masked ``add_decayed_weights``
-> ``scale_by_trust_ratio`` -> ``scale_by_learning_rate`` (factory.py:120-134):
``Lamb`` below. ``badam`` is the JAX package's alias for AdamW, and for LAMB
with ``lamb`` or ``lamb_mode`` set (factory.py:137-145).

``novograd`` is the JAX package's Novograd (optim/zoo.py:57-121):
``Novograd`` below. The rest of the JAX zoo (factory.py:149-156) is in
``optim/zoo.py``: ``adamp``, ``sgdp``, ``adai``, ``adais``, ``madgrad``,
``adam_layerwise`` and ``rmsprop``; ``lookahead: true`` wraps any of them in
``Lookahead`` (factory.py:159-197). Every optimizer of the JAX package is
ported; an unknown name raises KeyError, as there.

``agc`` is adaptive gradient clipping (factory.py:200-214 of the JAX package),
a gradient transform for the train step's ``grad_transform``.
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

import torch

from sota_imagenet_tpu_torch.optim import zoo
from sota_imagenet_tpu_torch.utils.misc import foreach_sqrt_, sqrt
from sota_imagenet_tpu_torch.utils.weights import unit_dims

_OPTIM_ALIASES = {
    "torch.optim._multi_tensor.SGD": "sgd",
    "torch.optim.SGD": "sgd",
    "SGD": "sgd",
    "torch.optim.AdamW": "adamw",
    "torch.optim._multi_tensor.AdamW": "adamw",
    "AdamW": "adamw",
    "Adam": "adamw",
    "badam.BAdam": "badam",
    "BAdam": "badam",
    "apex.optimizers.FusedNovoGrad": "novograd",
    "src.optimizers.MyNovograd": "novograd",
    "MyNovograd": "novograd",
    "src.optimizers.NovogradApex": "novograd",
    "NovogradApex": "novograd",
    "adamp.AdamP": "adamp",
    "AdamP": "adamp",
    "src.optimizers.AdamLayerwise": "adam_layerwise",
    "AdamLayerwise": "adam_layerwise",
    "src.optimizers.MyAdai": "adai",
    "MyAdai": "adai",
    "src.optimizers.AdaiS": "adais",
    "AdaiS": "adais",
    "src.optimizers.MADGRAD": "madgrad",
    "MADGRAD": "madgrad",
    "RMSprop": "rmsprop",
    "torch.optim.RMSprop": "rmsprop",
    "SGDP": "sgdp",
    # legacy flat-schema names (the fused_* prefix meant apex multi-tensor variants of the same math)
    "fused_sgd": "sgd",
    "fused_adam": "adamw",
    "fused_novograd": "novograd",
}


class Lamb(torch.optim.Optimizer):
    """LAMB in optax's order, on ``torch._foreach_*`` ops (a handful of
    launches per parameter group, not several per parameter). For each
    parameter p with gradient g, at step t:

        m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
        u = m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps) + wd p
        u = u * ||p|| / ||u||   (by 1 where either norm is 0)
        p = p - lr u

    The trust ratio is taken per parameter and applied to every parameter,
    1-d ones included; the group's ``weight_decay`` is optax's masked
    ``add_decayed_weights``, so the parameters that ``wd_mask`` exempts sit
    in a group with 0."""

    def __init__(self, params, lr: float = 0.0, betas=(0.9, 0.999), eps: float = 1e-6, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Lamb.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            states = [self.state[p] for p in params]
            for p, st in zip(params, states):
                if not st:
                    st.update(step=0, exp_avg=torch.zeros_like(p), exp_avg_sq=torch.zeros_like(p))
                st["step"] += 1
            grads = [p.grad for p in params]
            m, v = [st["exp_avg"] for st in states], [st["exp_avg_sq"] for st in states]
            b1, b2 = group["betas"]
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, grads, alpha=1.0 - b1)
            torch._foreach_mul_(v, b2)
            torch._foreach_addcmul_(v, grads, grads, value=1.0 - b2)
            denom = torch._foreach_div(v, [1.0 - b2 ** st["step"] for st in states])
            foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            update = torch._foreach_div(m, [1.0 - b1 ** st["step"] for st in states])
            torch._foreach_div_(update, denom)
            if group["weight_decay"]:
                torch._foreach_add_(update, params, alpha=group["weight_decay"])
            p_norm = torch.stack(torch._foreach_norm(params))
            u_norm = torch.stack(torch._foreach_norm(update))
            ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm), p_norm / u_norm)
            torch._foreach_mul_(update, list(ratio.unbind()))
            torch._foreach_add_(params, update, alpha=-group["lr"])
        return None


class Novograd(torch.optim.Optimizer):
    """Novograd as the JAX package has it (optim/zoo.py:57-121; reference
    NovogradApex, optimizers.py:189-290), with the grad norm it intends. For
    each parameter p with gradient g:

        v = b2 v + (1 - b2) ||g||^2            (v starts at ema_norm_init)
        m = b1 m + (1 - b1) g / (sqrt(v) + eps)
        u = -lr m;  q = p + u
        p = q - lr wd q                         (decoupled decay)
        p = q - lr wd sign(q) max(|q| - wd_eps, 0)   (with ``wd_eps``: |q| <= wd_eps is not decayed)

    ||g||^2 is taken in float32, over the whole tensor (v a float32 scalar,
    as in the JAX transform), or with ``unitwise`` per output unit, in the
    gradient's dtype: over every dim but ``unit_dim[p]`` (the dim that holds
    the JAX kernel's last axis, ``utils.weights.unit_dims``; dim 0, the
    output channels of every conv and Dense weight of the port, where none
    is given), over the whole tensor for a 0-d or 1-d one. The group's
    ``weight_decay`` is 0 for the parameters ``wd_mask`` exempts."""

    def __init__(
        self, params, lr: float = 0.0, betas=(0.95, 0.0), eps: float = 1e-8, weight_decay: float = 0.0,
        ema_norm_init: float = 1e-3, unitwise: bool = False, wd_eps: Optional[float] = None,
        unit_dim: Optional[Mapping[torch.Tensor, int]] = None,
    ):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay))
        self.ema_norm_init, self.unitwise, self.wd_eps = ema_norm_init, unitwise, wd_eps
        self.unit_dim = unit_dim or {}

    def _norm_sq(self, p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        if not self.unitwise:
            return g.float().square().sum()
        return _unitwise_norm(g, self.unit_dim.get(p, 0)).square()

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Novograd.step takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, wd = group["lr"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["ema_grad"] = torch.zeros_like(p)
                    st["ema_norm"] = torch.full((), self.ema_norm_init, dtype=torch.float32, device=p.device)
                g = p.grad
                v = b2 * st["ema_norm"] + (1.0 - b2) * self._norm_sq(p, g)
                m = b1 * st["ema_grad"] + (1.0 - b1) * g / (sqrt(v) + group["eps"])
                st["ema_norm"], st["ema_grad"] = v, m
                upd = -lr * m
                if wd:
                    q = p + upd
                    decayed = q if self.wd_eps is None else q.sign() * (q.abs() - self.wd_eps).clamp(min=0.0)
                    upd = upd - lr * wd * decayed
                p.add_(upd)
        return None


def _param_groups(named, weight_decay: float, wd_mask: Optional[Mapping[str, bool]]) -> list:
    """One group, or two where ``wd_mask`` (name -> apply decay) takes some parameters out of the decay."""
    if wd_mask is None:
        return [{"params": [p for _, p in named], "weight_decay": weight_decay}]
    groups = [
        {"params": [p for n, p in named if wd_mask[n]], "weight_decay": weight_decay},
        {"params": [p for n, p in named if not wd_mask[n]], "weight_decay": 0.0},
    ]
    return [g for g in groups if g["params"]]


def sgd(
    named_params: Iterable[Tuple[str, torch.nn.Parameter]],
    momentum: float = 0.0,
    weight_decay: float = 0.0,
    nesterov: bool = False,
    wd_mask: Optional[Mapping[str, bool]] = None,
    **_: Any,
) -> torch.optim.SGD:
    """SGD with coupled L2 decay (grad += wd·param before momentum). ``wd_mask``
    maps parameter name → apply decay; None decays every parameter (BN and
    biases included), as the JAX package does without ``filter_from_wd``."""
    groups = _param_groups(list(named_params), weight_decay, wd_mask)
    return torch.optim.SGD(groups, lr=0.0, momentum=momentum, dampening=0.0, nesterov=nesterov)


def adamw(
    named_params: Iterable[Tuple[str, torch.nn.Parameter]],
    betas=(0.9, 0.999),
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    wd_mask: Optional[Mapping[str, bool]] = None,
    **_: Any,
) -> torch.optim.AdamW:
    """Adam with decoupled weight decay; ``wd_mask`` as in ``sgd``."""
    groups = _param_groups(list(named_params), weight_decay, wd_mask)
    return torch.optim.AdamW(groups, lr=0.0, betas=tuple(betas), eps=eps)


def lamb(
    named_params: Iterable[Tuple[str, torch.nn.Parameter]],
    betas=(0.9, 0.999),
    eps: float = 1e-6,
    weight_decay: float = 0.0,
    wd_mask: Optional[Mapping[str, bool]] = None,
    **_: Any,
) -> Lamb:
    """LAMB (the reference reaches it through badam.BAdam(lamb=True),
    41.nf_conv-act_lamb.yaml); ``wd_mask`` as in ``sgd``."""
    groups = _param_groups(list(named_params), weight_decay, wd_mask)
    return Lamb(groups, lr=0.0, betas=betas, eps=eps)


def novograd(
    named_params: Iterable[Tuple[str, torch.nn.Parameter]],
    betas=(0.95, 0.0),
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    ema_norm_init: float = 1e-3,
    unitwise: bool = False,
    wd_eps: Optional[float] = None,
    wd_mask: Optional[Mapping[str, bool]] = None,
    unit_dim: Optional[Mapping[str, int]] = None,
    **_: Any,
) -> Novograd:
    """Novograd; ``wd_mask`` as in ``sgd``; ``unit_dim`` (name -> dim) for
    ``unitwise``. Other keys (``init_zero`` of config 8) are accepted and
    unused, as the JAX ``novograd``'s ``**_``."""
    named = list(named_params)
    dims = {p: unit_dim[n] for n, p in named if n in unit_dim} if unit_dim else None
    groups = _param_groups(named, weight_decay, wd_mask)
    return Novograd(groups, betas=betas, eps=eps, ema_norm_init=ema_norm_init, unitwise=unitwise, wd_eps=wd_eps,
                    unit_dim=dims)


def badam(named_params, lamb_mode: bool = False, lamb: bool = False, **kw) -> torch.optim.Optimizer:
    """bonlime's BAdam: AdamW, or LAMB with ``lamb`` or ``lamb_mode`` set."""
    return _BUILDERS["lamb" if (lamb or lamb_mode) else "adamw"](named_params, **kw)


def _zoo_builder(name: str):
    """A builder of ``zoo.ZOO[name]``: the wd mask's groups, and the layout
    (``unit_dim``, ``flax_rank``: name -> value) for those that take it."""
    cls = zoo.ZOO[name]
    layout = name in ("adamp", "sgdp")
    accepted = set(inspect.signature(cls).parameters)

    def build(named_params, wd_mask=None, weight_decay: float = 0.0, unit_dim=None, flax_rank=None, **kw):
        named = list(named_params)
        groups = _param_groups(named, weight_decay, wd_mask)
        if layout:
            kw["unit_dim"] = {p: unit_dim[n] for n, p in named if n in unit_dim} if unit_dim else None
            kw["flax_rank"] = {p: flax_rank[n] for n, p in named if n in flax_rank} if flax_rank else None
        if "betas" in kw:
            kw["betas"] = tuple(kw["betas"])
        # other keys of a config are accepted and unused, as the JAX builders' ``**_``
        return cls(groups, **{k: v for k, v in kw.items() if k in accepted})

    build.__name__ = name
    return build


_BUILDERS = {"sgd": sgd, "adamw": adamw, "lamb": lamb, "badam": badam, "novograd": novograd,
             **{name: _zoo_builder(name) for name in zoo.ZOO}}


def optimizer_name(optim_cfg: Mapping[str, Any]) -> str:
    """The builder a config node names (its ``_target_``, through the aliases); KeyError for an unknown one."""
    target = str(optim_cfg.get("_target_", "sgd"))
    name = _OPTIM_ALIASES.get(target, target if target in _BUILDERS else target.rsplit(".", 1)[-1].lower())
    if name not in _BUILDERS:
        raise KeyError(f"unknown optimizer {target!r}; known: {sorted(_BUILDERS)}")
    return name


def needs_layout(optim_cfg: Mapping[str, Any]) -> bool:
    """Whether the optimizer takes each parameter's units from the weights
    plan: the unitwise ones, and AdamP's and SGDP's projection."""
    return bool(optim_cfg.get("unitwise")) or optimizer_name(optim_cfg) in ("adamp", "sgdp")


def _unitwise_norm(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The L2 norm of each unit of ``x``, broadcastable against it (optim/zoo.py:41-49 of the JAX package): over
    every dim but ``dim`` (``unit_dims``), over the whole tensor for a 0-d or 1-d one."""
    if x.dim() <= 1:
        return torch.linalg.vector_norm(x)
    d = dim % x.dim()
    return torch.linalg.vector_norm(x, dim=[i for i in range(x.dim()) if i != d], keepdim=True)


class AGC:
    """Adaptive gradient clipping (NFNet arXiv:2102.06171; the JAX ``agc``,
    optim/factory.py:200-214): for each unit (``unit_dims``: one per output
    channel of a conv or Dense kernel, the whole tensor for a 1-d parameter,
    ECA's kernel or a temperature), with pn = max(||p||, eps) and gn =
    max(||g||, 1e-6), the gradient becomes g * (clipping * pn / gn) where
    gn > clipping * pn and stays g elsewhere.

    Called by the train step as ``grad_transform(model, params, grads)``
    under no_grad: it scales ``grads`` in place, on their device, reading
    nothing back to the host. The units are found once per model, from the
    weights plan. Parameters that are one unit take their norms in one
    ``_foreach_norm`` each for p and g; the others one norm each, and all
    factors are computed together. With ``record`` set, ``stats`` holds
    device tensors about the last call: the units, how many were clipped,
    and the largest ||g|| / (clipping * pn) after clipping, from norms taken
    anew (at most 1 up to rounding)."""

    def __init__(self, clipping: float = 0.01, eps: float = 1e-3):
        self.clipping, self.eps = clipping, eps
        self.record = False
        self.stats: Optional[Dict[str, torch.Tensor]] = None
        self._model, self._dims = None, {}

    def _factor(self, pn: torch.Tensor, gn: torch.Tensor) -> torch.Tensor:
        max_norm = self.clipping * pn.clamp(min=self.eps)
        gn = gn.clamp(min=1e-6)
        return torch.where(gn > max_norm, max_norm / gn, torch.ones_like(gn))

    def __call__(self, model: torch.nn.Module, params: List[torch.Tensor], grads: List[torch.Tensor]) -> None:
        if model is not self._model:
            dims = unit_dims(model)
            self._model, self._dims = model, {id(p): dims[n] for n, p in model.named_parameters()}
        whole, units = [], []  # (p, g) pairs that are one unit; (p, g, dim) with a norm per unit
        for p, g in zip(params, grads):
            if g is None:
                continue
            d = self._dims[id(p)]
            if p.dim() <= 1 or p.shape[d] == 1:
                whole.append((p, g))
            else:
                units.append((p, g, d))
        factors = []
        if whole:
            ps, gs = [p for p, _ in whole], [g for _, g in whole]
            factors.append(self._factor(torch.stack(torch._foreach_norm(ps)), torch.stack(torch._foreach_norm(gs))))
            torch._foreach_mul_(gs, list(factors[-1].unbind()))
        if units:
            pn = [_unitwise_norm(p, d) for p, _, d in units]
            gn = [_unitwise_norm(g, d) for _, g, d in units]
            factors.append(self._factor(torch.cat([n.reshape(-1) for n in pn]), torch.cat([n.reshape(-1) for n in gn])))
            views = [f.view(n.shape) for f, n in zip(factors[-1].split([n.numel() for n in pn]), pn)]
            torch._foreach_mul_([g for _, g, _ in units], views)
        if self.record and factors:
            self.stats = self._check(whole, units, torch.cat(factors))

    def _check(self, whole, units, factor: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The clipped gradients' norms taken anew, against each unit's bound clipping * max(||p||, eps)."""
        pn = [torch.linalg.vector_norm(p).reshape(1) for p, _ in whole] + [_unitwise_norm(p, d).reshape(-1) for p, _, d in units]
        gn = [torch.linalg.vector_norm(g).reshape(1) for _, g in whole] + [_unitwise_norm(g, d).reshape(-1) for _, g, d in units]
        ratio = torch.cat(gn) / (self.clipping * torch.cat(pn).clamp(min=self.eps))
        return {"units": torch.tensor(ratio.numel()), "clipped": (factor < 1.0).sum(), "max_ratio_after": ratio.max()}


def agc(clipping: float = 0.01, eps: float = 1e-3) -> AGC:
    """The AGC gradient transform (the JAX ``agc(clipping, eps)``)."""
    return AGC(clipping, eps)


def build_optimizer(
    optim_cfg: Dict[str, Any],
    named_params: Iterable[Tuple[str, torch.nn.Parameter]],
    wd_mask: Optional[Mapping[str, bool]] = None,
    unit_dim: Optional[Mapping[str, int]] = None,
    flax_rank: Optional[Mapping[str, int]] = None,
) -> torch.optim.Optimizer:
    """Build from a config node like {_target_: sgd, momentum: 0.9, ...}.
    ``unit_dim`` (``utils.weights.unit_dims``) and ``flax_rank``
    (``utils.weights.flax_ranks``), by parameter name, serve the unitwise
    optimizers and AdamP's and SGDP's projection. ``lookahead: true`` (with
    ``lookahead_k``, default 5, and ``lookahead_alpha``, 0.5) wraps the
    optimizer in ``Lookahead``."""
    cfg = dict(optim_cfg)
    name = optimizer_name(cfg)
    for k in ("_target_", "lr"):
        cfg.pop(k, None)
    use_lookahead = bool(cfg.pop("lookahead", False))
    la_k, la_alpha = int(cfg.pop("lookahead_k", 5)), float(cfg.pop("lookahead_alpha", 0.5))
    if unit_dim is not None:
        cfg["unit_dim"] = unit_dim
    if flax_rank is not None:
        cfg["flax_rank"] = flax_rank
    opt = _BUILDERS[name](named_params, wd_mask=wd_mask, **cfg)
    return zoo.Lookahead(opt, k=la_k, alpha=la_alpha) if use_lookahead else opt
