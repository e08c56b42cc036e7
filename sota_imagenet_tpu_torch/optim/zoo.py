"""The JAX package's optimizer zoo (``sota_imagenet_tpu/optim/zoo.py``:126-585;
reference optimizers.py and the adamp package) and its Lookahead wrapper
(``optim/factory.py``:159-197) as ``torch.optim`` optimizers.

Each mirrors the JAX transform's numerics, the order of its operations and
the dtype of each of its values:

  * the lr is read as float32 (the JAX ``_lr_at``), and the scalars the JAX
    transform derives from it (lr * wd, the bias corrections, MADGRAD's
    lamb) are rounded to float32 as it rounds them; they are computed on
    the host, so no step reads the device;
  * each state tensor has the dtype of its JAX leaf: the per-layer and
    per-weight second moments of AdamLayerwise, Adai and AdaiS are float32
    whatever the parameter's dtype, the others the parameter's. A
    checkpoint keeps them so (``ZooOptimizer.load_state_dict``);
  * a parameter's group carries its weight decay: 0 where ``wd_mask``
    exempts it (factory ``_param_groups``).

The parameter set is the JAX params tree's, one parameter for one leaf
(the weights plan maps each); Adai's and AdaiS' means over all leaves are
one device reduction over the stacked per-leaf values, summed over the
shards under ZeRO-1 (``optim/zero1.py``).

AdamP and SGDP project the step of every parameter whose JAX leaf has more
than one axis (``flax_rank``, from the weights plan) off the radial
direction, per output unit (``unit_dim``: the dim that holds the flax
kernel's last axis): a unit's row is the rest of the tensor, in the port's
order where the JAX package flattens (h, w, i); the norms and dot products
over a row do not depend on that order. Whether a parameter is projected is
a device boolean; ``projected`` holds the last step's, one per such
parameter, for a probe to read when it likes.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from sota_imagenet_tpu_torch.utils.misc import foreach_sqrt_, sqrt


def _f32(x: float) -> float:
    """``x`` rounded to float32, as a host float."""
    return float(np.float32(x))


def _f32_mul(*xs: float) -> float:
    """The float32 product of ``xs``, left to right (a JAX float32 scalar times Python floats)."""
    out = np.float32(xs[0])
    for x in xs[1:]:
        out = np.float32(out * np.float32(x))
    return float(out)


def _bias_correction(beta: float, count: int) -> float:
    """1 - beta ** count in float32, as the JAX transforms take it (count cast to float32)."""
    b = torch.tensor(beta, dtype=torch.float32) ** torch.tensor(float(count), dtype=torch.float32)
    return float(1.0 - b)


def _mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` as XLA takes it: the sum times the float32 reciprocal of the count."""
    return x.sum() * _f32(np.float32(1.0) / np.float32(x.numel()))


def _grad(p: torch.Tensor) -> torch.Tensor:
    """The gradient of ``p``; zeros where it has none, as a JAX gradient of a leaf the loss does not reach."""
    return p.grad if p.grad is not None else torch.zeros_like(p)


class ZooOptimizer(torch.optim.Optimizer):
    """The pieces the zoo shares: the parameters' layout (``unit_dim``,
    ``flax_rank``, keyed by parameter; dim 0 and the tensor's rank where
    none is given), the global step count (each parameter's ``step``; they
    move together), and a ``load_state_dict`` that keeps each state
    tensor's dtype."""

    def __init__(self, params, defaults: dict, unit_dim: Optional[Mapping] = None, flax_rank: Optional[Mapping] = None):
        super().__init__(params, defaults)
        self.unit_dim = dict(unit_dim or {})
        self.flax_rank = dict(flax_rank or {})
        # set by the ZeRO-1 wrapper on the optimizer of one rank's share of the parameters
        # (optim/zero1.CrossShard): a mean over every parameter sums over the shards
        self.cross_shard = None

    def _sum_over_shards(self, total: torch.Tensor, count: int, elements: bool = False):
        """``total`` (a sum over this optimizer's parameters) and ``count`` (of
        its parameters, or of their ``elements``), each over every shard."""
        if self.cross_shard is None:
            return total, count
        return self.cross_shard.sum(total), self.cross_shard.elements if elements else self.cross_shard.params

    def _all_params(self) -> List[torch.Tensor]:
        return [p for g in self.param_groups for p in g["params"]]

    def _count(self) -> int:
        """Steps taken so far (the JAX state's ``count``)."""
        params = self._all_params()
        return self.state[params[0]].get("step", 0) if params else 0

    def _is_matrix(self, p: torch.Tensor) -> bool:
        return self.flax_rank.get(p, p.dim()) > 1

    def load_state_dict(self, state_dict: dict) -> None:
        """``torch.optim.Optimizer.load_state_dict`` casts every floating state
        tensor but ``step`` to its parameter's dtype; the zoo keeps float32
        moments of float64 parameters, so each tensor gets its saved dtype back."""
        dtypes = {
            idx: {k: v.dtype for k, v in st.items() if isinstance(v, torch.Tensor)}
            for idx, st in state_dict["state"].items()
        }
        super().load_state_dict(state_dict)
        params = self._all_params()
        for idx, kinds in dtypes.items():
            st = self.state[params[idx]]
            for k, dtype in kinds.items():
                st[k] = st[k].to(dtype)


def _rows_dims(p: torch.Tensor, dim: int) -> List[int]:
    """The dims of ``p`` a unit's row runs over: all but ``dim``."""
    d = dim % p.dim()
    return [i for i in range(p.dim()) if i != d]


def _project(p: torch.Tensor, g: torch.Tensor, s: torch.Tensor, dim: int, delta: float, eps: float):
    """AdamP's and SGDP's projection of a step ``s`` for a matrix parameter
    ``p`` with gradient ``g`` (zoo.py:536-575 of the JAX package): with the
    cosine of each unit's g and p rows (each over its norm + 1e-8), the
    projection fires where the largest |cos| is below delta / sqrt(fan_in);
    then each row of s loses its component along p's row (over its norm +
    eps). Returns the new step and the device boolean."""
    red = _rows_dims(p, dim)
    fan_in = p.numel() // p.shape[dim]
    pn = torch.linalg.vector_norm(p, dim=red, keepdim=True)
    gn = torch.linalg.vector_norm(g, dim=red, keepdim=True)
    cos = ((g / (gn + 1e-8)) * (p / (pn + 1e-8))).sum(dim=red).abs()
    cond = cos.max() < delta / math.sqrt(fan_in)
    unit = p / (pn + eps)
    proj = s - unit * (s * unit).sum(dim=red, keepdim=True)
    return torch.where(cond, proj, s), cond


class AdamP(ZooOptimizer):
    """AdamP (arXiv:2006.08217; zoo.py:516-585 of the JAX package). For each
    parameter p with gradient g, at step t:

        m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2
        s = (m / bc1) / (sqrt(v / bc2) + eps)
            (nesterov: (b1 m / bc1 + (1 - b1) g / bc1) / (sqrt(v / bc2) + eps))
        s = projected(s), ratio = wd_ratio where the projection fires (matrices only), else 1
        u = -lr s;  p = p + u - lr wd ratio (p + u)

    The moments are ``_foreach`` ops over the group; the projection is a few
    ops per matrix parameter; the decay factor of each parameter is chosen
    on the device, so nothing is read back."""

    def __init__(self, params, lr: float = 0.0, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0,
                 delta: float = 0.1, wd_ratio: float = 0.1, nesterov: bool = False, unit_dim=None, flax_rank=None):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay), unit_dim,
                         flax_rank)
        self.delta, self.wd_ratio, self.nesterov = delta, wd_ratio, nesterov
        self.matrix_params = [p for p in self._all_params() if self._is_matrix(p)]
        self.projected: Optional[torch.Tensor] = None  # the last step's, one per matrix parameter, in that order

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamP.step takes no closure")
        fired = []
        for group in self.param_groups:
            params = group["params"]
            if not params:
                continue
            for p in params:
                st = self.state[p]
                if not st:
                    st.update(step=0, exp_avg=torch.zeros_like(p), exp_avg_sq=torch.zeros_like(p))
                st["step"] += 1
            t = self.state[params[0]]["step"]
            b1, b2 = group["betas"]
            lr, wd = _f32(group["lr"]), group["weight_decay"]
            bc1, bc2 = _bias_correction(b1, t), _bias_correction(b2, t)
            grads = [_grad(p) for p in params]
            m = [self.state[p]["exp_avg"] for p in params]
            v = [self.state[p]["exp_avg_sq"] for p in params]
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, grads, alpha=1.0 - b1)
            torch._foreach_mul_(v, b2)
            torch._foreach_addcmul_(v, grads, grads, value=1.0 - b2)
            denom = torch._foreach_div(v, bc2)
            foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            if self.nesterov:
                steps = torch._foreach_div(torch._foreach_mul(m, b1), bc1)
                torch._foreach_add_(steps, torch._foreach_div(torch._foreach_mul(grads, 1.0 - b1), bc1))
            else:
                steps = torch._foreach_div(m, bc1)
            torch._foreach_div_(steps, denom)
            steps, conds = list(steps), {}
            for i, p in enumerate(params):
                if self._is_matrix(p):
                    steps[i], conds[i] = _project(p, grads[i], steps[i], self.unit_dim.get(p, 0), self.delta,
                                                  group["eps"])
            fired.extend(conds.values())
            updates = torch._foreach_mul(steps, -lr)
            if wd:
                decayed = torch._foreach_add(params, updates)
                lr_wd = _f32_mul(lr, wd)
                if conds:  # lr wd wd_ratio where the projection fired, lr wd elsewhere: one factor a parameter
                    projected = torch.zeros(len(params), dtype=torch.bool, device=params[0].device)
                    projected[list(conds)] = torch.stack(list(conds.values()))
                    factor = torch.where(projected, _f32_mul(lr, wd, self.wd_ratio), lr_wd)
                    torch._foreach_mul_(decayed, list(factor.unbind()))
                else:
                    torch._foreach_mul_(decayed, lr_wd)
                torch._foreach_sub_(updates, decayed)
            torch._foreach_add_(params, updates)
        self.projected = torch.stack(fired) if fired else None
        return None


class SGDP(ZooOptimizer):
    """SGDP (arXiv:2006.08217; zoo.py:453-513 of the JAX package): SGD with
    momentum (b = momentum b + g; the step is b, or g + momentum b with
    nesterov) whose step is projected as AdamP's, then

        p = p - lr wd ratio / (1 - momentum) p - lr step"""

    def __init__(self, params, lr: float = 0.0, momentum: float = 0.9, weight_decay: float = 0.0,
                 nesterov: bool = False, delta: float = 0.1, wd_ratio: float = 0.1, eps: float = 1e-8,
                 unit_dim=None, flax_rank=None):
        super().__init__(params, dict(lr=lr, momentum=momentum, weight_decay=weight_decay), unit_dim, flax_rank)
        self.delta, self.eps, self.nesterov, self.wd_ratio = delta, eps, nesterov, wd_ratio
        self.matrix_params = [p for p in self._all_params() if self._is_matrix(p)]
        self.projected: Optional[torch.Tensor] = None  # the last step's, one per matrix parameter, in that order

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("SGDP.step takes no closure")
        fired = []
        for group in self.param_groups:
            params = group["params"]
            if not params:
                continue
            for p in params:
                st = self.state[p]
                if not st:
                    st.update(step=0, momentum_buffer=torch.zeros_like(p))
                st["step"] += 1
            mom = group["momentum"]
            lr, wd = _f32(group["lr"]), group["weight_decay"]
            grads = [_grad(p) for p in params]
            bufs = [self.state[p]["momentum_buffer"] for p in params]
            torch._foreach_mul_(bufs, mom)
            torch._foreach_add_(bufs, grads)
            steps = list(torch._foreach_add(grads, bufs, alpha=mom)) if self.nesterov else list(bufs)
            conds = {}
            for i, p in enumerate(params):
                if self._is_matrix(p):
                    steps[i], conds[i] = _project(p, grads[i], steps[i], self.unit_dim.get(p, 0), self.delta, self.eps)
            fired.extend(conds.values())
            if wd:
                lr_wd = _f32_mul(lr, wd)
                shrink = [float(np.float32(lr_wd) / np.float32(1.0 - mom))] * len(params)
                if conds:
                    projected = float(np.float32(_f32_mul(lr_wd, self.wd_ratio)) / np.float32(1.0 - mom))
                    chosen = torch.where(torch.stack(list(conds.values())), projected, shrink[0])
                    for i, f in zip(conds, chosen.unbind()):
                        shrink[i] = f
                updates = [p * -f for p, f in zip(params, shrink)]
                torch._foreach_add_(updates, steps, alpha=-lr)
            else:
                updates = torch._foreach_mul(steps, -lr)
            torch._foreach_add_(params, updates)
        self.projected = torch.stack(fired) if fired else None
        return None


class Adai(ZooOptimizer):
    """Adaptive inertia (reference MyAdai; zoo.py:188-268 of the JAX
    package). v is a float32 mean of g^2 per parameter (``per_layer``) or a
    float32 g^2 per weight, starting at ``ema_norm_init``; each step's beta1
    comes from v over the mean of the PREVIOUS step's v over all parameters
    (``ema_norm_init`` at the first step):

        v = b2 v + (1 - b2) mean(g^2)
        beta1 = clip(1 - (v / v_mean) b0, 0, 1 - eps)    (sqrt of the ratio with sqrt_mom)
        m = beta1 m + (1 - beta1) g                       (beta1 m + g with sgd_mom)
        u = -lr m;  p = p + u - f (p + u),  f = lr wd / (1 - beta1) with stable_wd, else lr wd"""

    def __init__(self, params, lr: float = 0.0, betas=(0.1, 0.99), eps: float = 1e-3, weight_decay: float = 0.0,
                 ema_norm_init: float = 1e-3, sgd_mom: bool = False, sqrt_mom: bool = False,
                 stable_wd: bool = False, per_layer: bool = True):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay))
        self.ema_norm_init, self.sgd_mom, self.sqrt_mom = ema_norm_init, sgd_mom, sqrt_mom
        self.stable_wd, self.per_layer = stable_wd, per_layer
        params = self._all_params()
        for p in params:
            shape = () if per_layer else p.shape
            self.state[p].update(step=0, exp_avg=torch.zeros_like(p),
                                 exp_avg_sq=torch.full(shape, ema_norm_init, dtype=torch.float32, device=p.device))

    def _beta1(self, v: torch.Tensor, v_mean: torch.Tensor, b0: float, eps: float) -> torch.Tensor:
        ratio = v / v_mean
        if self.sqrt_mom:
            ratio = sqrt(ratio)
        return (1.0 - ratio * b0).clamp(0.0, 1.0 - eps)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adai.step takes no closure")
        params = self._all_params()
        if not params:
            return None
        old = [self.state[p]["exp_avg_sq"] for p in params]
        if self._count() == 0:
            v_mean = torch.full((), self.ema_norm_init, dtype=torch.float32, device=params[0].device)
        else:
            total, n = self._sum_over_shards(torch.stack(old if self.per_layer else [_mean(v) for v in old]).sum(), len(old))
            v_mean = total / n
        for group in self.param_groups:
            b0, b2 = group["betas"]
            lr, wd, eps = _f32(group["lr"]), group["weight_decay"], group["eps"]
            for p in group["params"]:
                st, g = self.state[p], _grad(p)
                g2 = g.float().square()
                v = b2 * st["exp_avg_sq"] + (1.0 - b2) * (_mean(g2) if self.per_layer else g2)
                beta1 = self._beta1(v, v_mean, b0, eps)
                m = beta1 * st["exp_avg"] + (g if self.sgd_mom else (1.0 - beta1) * g)
                upd = -lr * m
                if wd:
                    lr_wd = _f32_mul(lr, wd)
                    factor = lr_wd / (1.0 - beta1) if self.stable_wd else lr_wd
                    upd = upd - factor * (p + upd)
                p.add_(upd)
                st.update(step=st["step"] + 1, exp_avg=m, exp_avg_sq=v)
        return None


class AdaiS(ZooOptimizer):
    """AdaiS/AdaiW (reference optimizers.py:522-641; zoo.py:271-341 of the
    JAX package). v is a float32 g^2 per weight; its bias-corrected mean over
    every weight of every parameter is taken AFTER this step's update; beta1
    and its running product are per weight, and the decoupled decay comes
    before the step:

        v = b2 v + (1 - b2) g^2;  bc2 = 1 - b2^t;  v_hat = v / bc2
        beta1 = clip(1 - (v_hat / mean(v_hat)) b0, 0, 1 - eps);  prod = prod beta1
        m = beta1 m + (1 - beta1) g
        p = p (1 - lr wd) - lr m / (1 - prod)"""

    def __init__(self, params, lr: float = 0.0, betas=(0.1, 0.99), eps: float = 1e-3, weight_decay: float = 0.0,
                 ema_norm_init: float = 1e-3):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay))
        for p in self._all_params():
            self.state[p].update(step=0, exp_avg=torch.zeros_like(p), beta1_prod=torch.ones_like(p),
                                 exp_avg_sq=torch.full(p.shape, ema_norm_init, dtype=torch.float32, device=p.device))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdaiS.step takes no closure")
        params = self._all_params()
        if not params:
            return None
        t = self._count() + 1
        b2_of = {id(p): g["betas"][1] for g in self.param_groups for p in g["params"]}
        new_v = {}
        for p in params:
            b2 = b2_of[id(p)]
            new_v[p] = b2 * self.state[p]["exp_avg_sq"] + (1.0 - b2) * _grad(p).float().square()
        # the JAX transform takes one bc2, from the betas it was built with (every group's here)
        bc2 = _bias_correction(self.param_groups[0]["betas"][1], t)
        total, n = self._sum_over_shards(torch.stack([(v / bc2).sum() for v in new_v.values()]).sum(),
                                         sum(v.numel() for v in new_v.values()), elements=True)
        v_hat_mean = total / n
        for group in self.param_groups:
            b0 = group["betas"][0]
            lr, wd, eps = _f32(group["lr"]), group["weight_decay"], group["eps"]
            keep = float(np.float32(1.0) - np.float32(_f32_mul(lr, wd)))  # 1 - lr wd, in float32
            for p in group["params"]:
                st, g = self.state[p], _grad(p)
                v_hat = new_v[p] / bc2
                beta1 = (1.0 - (v_hat / v_hat_mean) * b0).clamp(0.0, 1.0 - eps)
                prod = st["beta1_prod"] * beta1
                m = beta1 * st["exp_avg"] + (1.0 - beta1) * g
                p.copy_(p * keep - lr * (m / (1.0 - prod)))
                st.update(step=t, exp_avg=m, exp_avg_sq=new_v[p], beta1_prod=prod)
        return None


class MADGRAD(ZooOptimizer):
    """MADGRAD (reference optimizers.py:650-770; zoo.py:344-395 of the JAX
    package), with the reference's decoupled decay. ``x0`` is a copy of the
    weights when the optimizer is built (the JAX ``tx.init``, before any
    callback's ``on_begin``). At step k (from 0), with lr' = lr + eps and
    lamb = lr' sqrt(k + 1), in float32:

        S = S + lamb g^2;  s = s + lamb g
        z = x0 - s / (cbrt(S) + eps)
        p = ((1 - ck) p + ck z) (1 - wd),  ck = 1 - momentum"""

    def __init__(self, params, lr: float = 0.0, momentum: float = 0.9, weight_decay: float = 0.0, eps: float = 1e-6):
        super().__init__(params, dict(lr=lr, momentum=momentum, weight_decay=weight_decay, eps=eps))
        for p in self._all_params():
            self.state[p].update(step=0, grad_sum_sq=torch.zeros_like(p), s=torch.zeros_like(p),
                                 x0=p.detach().clone())

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("MADGRAD.step takes no closure")
        k = self._count()
        for group in self.param_groups:
            eps, wd = group["eps"], group["weight_decay"]
            ck = 1.0 - group["momentum"]
            lr = _f32(np.float32(group["lr"]) + np.float32(eps))
            lamb = _f32(np.float32(lr) * np.sqrt(np.float32(k) + np.float32(1.0)))
            for p in group["params"]:
                st, g = self.state[p], _grad(p)
                gss = st["grad_sum_sq"] + lamb * g.float().square()
                s = st["s"] + lamb * g
                z = st["x0"] - s / (gss.pow(1.0 / 3.0) + eps)
                p.copy_(((1.0 - ck) * p + ck * z) * (1.0 - wd))
                st.update(step=k + 1, grad_sum_sq=gss, s=s)
        return None


class AdamLayerwise(ZooOptimizer):
    """Adam with a layer-wise second moment (reference optimizers.py:293-397;
    zoo.py:126-185 of the JAX package): v is a float32 mean of g^2 per
    parameter, starting at ``ema_norm_init``:

        v = b2 v + (1 - b2) mean(g^2)
        m = b1 m + (1 - b1) g / (sqrt(v) + eps)
        u = -lr m   (times max(rms(p), 1e-3) with weight_adapt)
        p = p + u - f (p + u),  f = lr wd / (sqrt(v) + eps) with stable_wd, else lr wd"""

    def __init__(self, params, lr: float = 0.0, betas=(0.95, 0.0), eps: float = 1e-6, weight_decay: float = 0.0,
                 ema_norm_init: float = 1e-3, weight_adapt: bool = False, stable_wd: bool = False):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay))
        self.weight_adapt, self.stable_wd = weight_adapt, stable_wd
        for p in self._all_params():
            self.state[p].update(step=0, exp_avg=torch.zeros_like(p),
                                 exp_avg_sq=torch.full((), ema_norm_init, dtype=torch.float32, device=p.device))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamLayerwise.step takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, wd, eps = _f32(group["lr"]), group["weight_decay"], group["eps"]
            for p in group["params"]:
                st, g = self.state[p], _grad(p)
                v = b2 * st["exp_avg_sq"] + (1.0 - b2) * _mean(g.float().square())
                denom = sqrt(v) + eps
                m = b1 * st["exp_avg"] + (1.0 - b1) * g / denom
                step = m * sqrt(_mean(p.float().square())).clamp(min=1e-3) if self.weight_adapt else m
                upd = -lr * step
                if wd:
                    lr_wd = _f32_mul(lr, wd)
                    factor = lr_wd / denom if self.stable_wd else lr_wd
                    upd = upd - factor * (p + upd)
                p.add_(upd)
                st.update(step=st["step"] + 1, exp_avg=m, exp_avg_sq=v)
        return None


class RMSprop(ZooOptimizer):
    """``torch.optim.RMSprop``'s semantics as the JAX package has them
    (zoo.py:398-450; the legacy effnetb0_tf.yaml): L2 decay added to the
    gradient, eps outside the square root:

        g = g + wd p;  S = alpha S + (1 - alpha) g^2
        avg = sqrt(S) + eps   (centered: sqrt(max(S - a^2, 0)) + eps, a = alpha a + (1 - alpha) g)
        b = momentum b + g / avg;  p = p - lr b     (without momentum: p = p - lr g / avg)"""

    def __init__(self, params, lr: float = 0.0, alpha: float = 0.99, eps: float = 1e-8, momentum: float = 0.0,
                 centered: bool = False, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, alpha=alpha, eps=eps, momentum=momentum, centered=centered,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("RMSprop.step takes no closure")
        for group in self.param_groups:
            alpha, eps, mom, wd = group["alpha"], group["eps"], group["momentum"], group["weight_decay"]
            lr = _f32(group["lr"])
            for p in group["params"]:
                st, g = self.state[p], _grad(p)
                if not st:
                    st.update(step=0, square_avg=torch.zeros_like(p))
                    if group["centered"]:
                        st["grad_avg"] = torch.zeros_like(p)
                    if mom:
                        st["momentum_buffer"] = torch.zeros_like(p)
                if wd:
                    g = g + wd * p
                sq = alpha * st["square_avg"] + (1.0 - alpha) * g**2
                if group["centered"]:
                    st["grad_avg"] = alpha * st["grad_avg"] + (1.0 - alpha) * g
                    avg = sqrt((sq - st["grad_avg"] ** 2).clamp(min=0.0)) + eps
                else:
                    avg = sqrt(sq) + eps
                if mom:
                    st["momentum_buffer"] = mom * st["momentum_buffer"] + g / avg
                    p.add_(-lr * st["momentum_buffer"])
                else:
                    p.add_(-lr * g / avg)
                st.update(step=st["step"] + 1, square_avg=sq)
        return None


class Lookahead(torch.optim.Optimizer):
    """Lookahead (arXiv:1907.08610; factory.py:159-197 of the JAX package)
    around any optimizer: the inner ("fast") one steps as usual; every
    ``k``-th step the slow weights move ``alpha`` of the way to the fast
    ones and the fast ones take their value:

        slow = slow + alpha (p - slow);  p = slow

    The slow copy is taken when the wrapper is built (the JAX ``tx.init``),
    and with the step count it sits in this optimizer's state; the inner
    optimizer's state rides in the state dict under ``inner``. The wrapper
    shares the inner optimizer's parameter groups, so an lr set on them is
    the inner one's."""

    def __init__(self, inner: torch.optim.Optimizer, k: int = 5, alpha: float = 0.5):
        self.inner, self.k, self.alpha = inner, int(k), float(alpha)
        super().__init__(inner.param_groups, dict(inner.defaults))
        self.param_groups = inner.param_groups
        for p in self._params():
            self.state[p].update(step=0, slow=p.detach().clone())

    def _params(self) -> List[torch.Tensor]:
        return [p for g in self.param_groups for p in g["params"]]

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Lookahead.step takes no closure")
        self.inner.step()
        params = self._params()
        count = self.state[params[0]]["step"] + 1 if params else 0
        for p in params:
            self.state[p]["step"] = count
        if params and count % self.k == 0:
            slow = [self.state[p]["slow"] for p in params]
            torch._foreach_add_(slow, torch._foreach_sub(params, slow), alpha=self.alpha)
            torch._foreach_copy_(params, slow)
        return None

    def state_dict(self) -> dict:
        sd = super().state_dict()
        sd["inner"] = self.inner.state_dict()
        return sd

    def load_state_dict(self, state_dict: dict) -> None:
        state_dict = dict(state_dict)
        self.inner.load_state_dict(state_dict.pop("inner"))
        super().load_state_dict(state_dict)
        self.param_groups = self.inner.param_groups


ZOO: Dict[str, type] = {"adamp": AdamP, "sgdp": SGDP, "adai": Adai, "adais": AdaiS, "madgrad": MADGRAD,
                        "adam_layerwise": AdamLayerwise, "rmsprop": RMSprop}
