"""Head tensor parallelism: the classifier's classes over the mesh's
``model`` axis (port of ``mesh.model``: JAX parallel/mesh.py:140-211,
``tp_sharding`` and ``apply_head_tp``; config.py:224-232, ``tp_params``;
cli.py:291-296).

Which leaves are sharded is the JAX rule (``shard_axes``): a leaf whose
flax path has a component (or an underscore token of one, with an optional
numeric suffix) equal to one of the patterns (``fc``, ``head``,
``classifier`` by default, or ``mesh.tp_params``) is sharded on its last
flax axis when that axis divides by ``model``; any other leaf stays
replicated. The paths are the weights plan's (``utils/weights.py``), never
torch attribute names, so ResNet's ``fconv1``/``fconv3`` do not match ``fc``.
The JAX last axis is dim 0 of a torch ``Linear`` weight (C, in), of its bias
(C,) and of a conv's OIHW weight; the sphere heads keep flax's (E, C).

``apply_head_tp`` keeps on each model rank its 1/M of every sharded leaf,
so the parameters, their EMA copy and the optimizer state (built over
them) are sharded. Every model rank of a data rank holds the same rows and
the same trunk:

* a ``Linear`` or a sphere head whose class dim is sharded computes its
  class shard of the output; a differentiable all-gather over the model
  ranks then gives every rank the whole output (its backward is the rank's
  slice of the cotangent), so every criterion, the sphere heads' state and
  the metrics run unchanged. Its input takes the Megatron "f" operator: the
  identity forward, and a sum over the model ranks of the cotangent in the
  backward, so the trunk's gradients are the same on every model rank;
* any other module with a sharded leaf (a conv named ``head``, a norm)
  gathers the leaf whole for its forward (the backward keeps the rank's
  slice of the gradient): the storage is sharded, the compute replicated;
* the reductions of the step over a shard's classes (grad_norm, the
  gradient transform, SAM's perturbation, the optimizer's norms, the
  post-step transform) take the other shards' share: ``reductions`` marks
  each shard (and its gradient and state) and a ``TorchFunctionMode`` sums
  a reduction over a marked dim over the model ranks. An op that mixes a
  shard's classes in another way raises, naming it.

A checkpoint holds the whole leaves (``full_state_dict`` gathers them at
save, ``shard_state_dict`` slices them at load), so a run with head TP
resumes a run without it, and the other way round, as orbax's global arrays
do. ZeRO-1 deals whole parameters over the data ranks of each model index
(``optim/zero1.py``), so the two compose.
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple

import torch
from torch.overrides import TorchFunctionMode

from sota_imagenet_tpu_torch.parallel import mesh as par

DEFAULT_PATTERNS = ("fc", "head", "classifier")


def matches(path: str, patterns: Optional[Sequence[str]] = None) -> bool:
    """Whether a '/'-joined flax path names a pattern as a component, or an
    underscore token of one with an optional numeric suffix (the JAX rule,
    mesh.py:166-181): ``fc``, ``fc1``, ``head_fc2``; not ``fconv3``."""
    pats = tuple(p.lower() for p in (patterns or DEFAULT_PATTERNS))
    for key in path.split("/"):
        for tok in re.split(r"[^0-9a-z]+", key.lower()):
            if any(tok == p or (tok.startswith(p) and tok[len(p):].isdigit()) for p in pats):
                return True
    return False


def shard_axes(leaves: Mapping[str, Tuple[int, ...]], model: int,
               patterns: Optional[Sequence[str]] = None) -> Dict[str, Optional[int]]:
    """For each flax leaf (path -> shape): the flax axis sharded over
    ``model`` ranks (its last), or None where it stays replicated (the JAX
    ``tp_sharding``)."""
    out: Dict[str, Optional[int]] = {}
    for path, shape in leaves.items():
        ok = model > 1 and len(shape) > 0 and shape[-1] % model == 0 and matches(path, patterns)
        out[path] = len(shape) - 1 if ok else None
    return out


def _gather_dim(x: torch.Tensor, dim: int, kind: str) -> torch.Tensor:
    """Every model rank's ``x`` (equal shapes) concatenated along ``dim`` in
    rank order (``mesh.gather_rows``, bit for bit). Not differentiable."""
    return par.gather_rows(x.movedim(dim, 0).contiguous(), kind, "model").movedim(0, dim)


class _GatherClasses(torch.autograd.Function):
    """The whole output from each model rank's class shard; the backward
    keeps this rank's slice of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.size = dim, x.shape[dim]
        return _gather_dim(x.contiguous(), dim, "tp_gather")

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, par.axis_index("model") * ctx.size, ctx.size), None


class _CopyToShards(torch.autograd.Function):
    """Megatron's "f": the identity forward; the backward sums the model
    ranks' cotangents (each saw only its classes)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return par.all_reduce_(grad.contiguous().clone(), "tp_input_backward", "model")


def _linear_like():
    from torch import nn

    from sota_imagenet_tpu_torch.losses.angular import SphereLinearLayer
    from sota_imagenet_tpu_torch.models.layers import Linear

    # module class -> the torch dim of its weight that holds the classes of its output's last dim
    return {Linear: 0, nn.Linear: 0, SphereLinearLayer: 1}


def _column_in(module, args):
    return (_CopyToShards.apply(args[0]), *args[1:])


def _column_out(module, args, out):
    return _GatherClasses.apply(out, out.dim() - 1)


def _gather_params_in(module, args):
    for name, dim in module.__dict__["_tp_shards"].items():
        module._parameters[name] = _GatherClasses.apply(module.__dict__["_tp_params"][name], dim)


def _gather_params_out(module, args, out):
    for name in module.__dict__["_tp_shards"]:
        module._parameters[name] = module.__dict__["_tp_params"][name]


def flax_leaves(model: torch.nn.Module) -> Dict[str, Tuple[Tuple[int, ...], str, int]]:
    """For each parameter of ``model`` (not 0-d), by name: its flax path's
    leaf shape (the flax last axis last), the path, and the torch dim that
    holds that last axis (the weights plan's converters)."""
    from sota_imagenet_tpu_torch.utils.weights import _LAST_AXIS, _plan

    plan = _plan(model)
    out = {}
    for name, p in model.named_parameters():
        if p.dim():
            d = _LAST_AXIS[plan[name][2]] % p.dim()
            out[name] = ((*[s for i, s in enumerate(p.shape) if i != d], p.shape[d]), plan[name][1], d)
    return out


def tp_spec(model: torch.nn.Module, model_ranks: int, patterns: Optional[Sequence[str]] = None) -> Dict[str, int]:
    """{parameter name: the torch dim sharded} of ``model`` over ``model_ranks`` ranks."""
    leaves = flax_leaves(model)
    axes = shard_axes({path: shape for shape, path, _ in leaves.values()}, model_ranks, patterns)
    return {name: d for name, (_, path, d) in leaves.items() if axes[path] is not None}


def apply_head_tp(model: torch.nn.Module, patterns: Optional[Sequence[str]] = None) -> Dict[str, int]:
    """Shard ``model``'s matched leaves over the model ranks, in place (before
    its optimizer and EMA are built): each keeps rank m's 1/M along the torch
    dim of the flax last axis. Returns {parameter name: that dim}, also kept
    as ``model._tp`` (with the whole size) for the checkpoint and the
    reductions."""
    from sota_imagenet_tpu_torch.models.parametrize import ParametrizedModel

    n, m = par.axis_size("model"), par.axis_index("model")
    root = model.model if isinstance(model, ParametrizedModel) else model
    named = dict(model.named_parameters())
    spec = tp_spec(model, n, patterns)
    if isinstance(model, ParametrizedModel) and set(spec) & {n for names in model.selected for n in names}:
        raise NotImplementedError(f"head TP cannot shard a leaf that a forward parametrization transforms: "
                                  f"{sorted(set(spec) & {n for names in model.selected for n in names})}")
    owners: Dict[torch.nn.Module, Dict[str, int]] = {}
    for name, d in spec.items():
        mod_name, _, attr = name.rpartition(".")
        owners.setdefault(root.get_submodule(mod_name), {})[attr] = d
    linear = _linear_like()
    for mod, attrs in owners.items():
        for attr, d in attrs.items():
            p = mod._parameters[attr]
            size = p.shape[d] // n
            shard = torch.nn.Parameter(p.detach().narrow(d, m * size, size).clone(), requires_grad=p.requires_grad)
            shard._tp_dim = d
            mod._parameters[attr] = shard
        column = linear.get(type(mod))
        own = {a for a, p in mod._parameters.items() if p is not None}
        if column is not None and attrs.get("weight") == column and set(attrs) == own and attrs.get("bias", 0) == 0:
            mod.register_forward_pre_hook(_column_in)
            mod.register_forward_hook(_column_out)
        else:
            mod.__dict__["_tp_shards"] = dict(attrs)
            mod.__dict__["_tp_params"] = {a: mod._parameters[a] for a in attrs}
            mod.register_forward_pre_hook(_gather_params_in)
            mod.register_forward_hook(_gather_params_out)
    model._tp = {name: (d, named[name].shape[d]) for name, d in spec.items()}
    return spec


def sharded(model: torch.nn.Module) -> Dict[str, Tuple[int, int]]:
    """{parameter name: (sharded dim, whole size)} of a model under head TP (empty otherwise)."""
    return getattr(model, "_tp", None) or {}


def full_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every shard gathered whole (every model rank must call it)."""
    sd = model.state_dict()
    for name, (d, _) in sharded(model).items():
        sd[name] = _gather_dim(sd[name].contiguous(), d, "tp_checkpoint")
    return sd


def shard_state_dict(model: torch.nn.Module, sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A state dict of whole leaves cut to this model rank's shards."""
    spec = sharded(model)
    if not spec:
        return sd
    n, m = par.axis_size("model"), par.axis_index("model")
    out = dict(sd)
    for name, (d, full) in spec.items():
        if name in out and out[name].shape[d] == full:
            out[name] = out[name].narrow(d, m * (full // n), full // n).clone()
    return out


def _param_names(model: torch.nn.Module, opt) -> list:
    names = {id(p): n for n, p in model.named_parameters()}
    return [names.get(id(p)) for g in opt.param_groups for p in g["params"]]


def full_optimizer_state(model: torch.nn.Module, opt, sd: dict) -> dict:
    """An optimizer state dict (``opt.state_dict()``) with each shard's state
    tensors gathered whole."""
    spec = sharded(model)
    if not spec:
        return sd
    names = _param_names(model, opt)

    def fix(state):
        out = {}
        for i, st in state.items():
            d = spec.get(names[i])
            out[i] = {k: _gather_dim(v.contiguous(), d[0], "tp_checkpoint")
                      if d and isinstance(v, torch.Tensor) and v.dim() > d[0] and v.shape[d[0]] * par.axis_size("model") == d[1]
                      else v for k, v in st.items()} if d else st
        return out

    sd = dict(sd, state=fix(sd["state"]))
    if isinstance(sd.get("inner"), dict):
        sd["inner"] = dict(sd["inner"], state=fix(sd["inner"]["state"]))
    return sd


def shard_optimizer_state(model: torch.nn.Module, opt, sd: dict) -> dict:
    """A whole optimizer state dict cut to this model rank's shards."""
    spec = sharded(model)
    if not spec:
        return sd
    names = _param_names(model, opt)
    n, m = par.axis_size("model"), par.axis_index("model")

    def fix(state):
        out = {}
        for i, st in state.items():
            d = spec.get(names[i]) if i < len(names) else None
            out[i] = {k: v.narrow(d[0], m * (d[1] // n), d[1] // n).clone()
                      if d and isinstance(v, torch.Tensor) and v.dim() > d[0] and v.shape[d[0]] == d[1] else v
                      for k, v in st.items()} if d else st
        return out

    sd = dict(sd, state=fix(sd["state"]))
    if isinstance(sd.get("inner"), dict):
        sd["inner"] = dict(sd["inner"], state=fix(sd["inner"]["state"]))
    return sd


# --------------------------------------------------------------------------- #
# Reductions over a shard's classes
# --------------------------------------------------------------------------- #


def _dim_of(t) -> Optional[int]:
    return getattr(t, "_tp_dim", None) if isinstance(t, torch.Tensor) else None


def _tensors(args, kwargs) -> Iterable[torch.Tensor]:
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from (t for t in a if isinstance(t, torch.Tensor))


def _reduce_dims(dim, ndim: int):
    if dim is None or (isinstance(dim, (list, tuple)) and len(dim) == 0):
        return list(range(ndim))
    return sorted({d % ndim for d in ((dim,) if isinstance(dim, int) else dim)})


def _over_shards(local: torch.Tensor, op=None) -> torch.Tensor:
    return par.all_reduce_(local.clone(), "tp_reduce", "model", op)


def _foreach_norm(func, args, kwargs):
    tensors, ord_ = list(args[0]), (args[1] if len(args) > 1 else kwargs.get("ord", 2))
    norms = list(func(*args, **kwargs))
    marked = [i for i, t in enumerate(tensors) if _dim_of(t) is not None]
    if marked:
        if ord_ != 2:
            raise NotImplementedError(f"head TP cannot reduce a {ord_}-norm over a shard's classes")
        total = _over_shards(torch.stack([norms[i].square() for i in marked])).sqrt()
        for j, i in enumerate(marked):
            norms[i] = total[j].to(norms[i].dtype)
    return norms


def _reduction(func, args, kwargs):
    key = getattr(func, "__name__", "")
    x = args[0]
    d = _dim_of(x)
    if key in ("linalg_vector_norm", "norm"):
        ord_ = args[1] if len(args) > 1 else kwargs.get("ord", kwargs.get("p", 2))
        dim = args[2] if len(args) > 2 else kwargs.get("dim")
        keepdim = args[3] if len(args) > 3 else kwargs.get("keepdim", False)
    elif key in ("all", "any"):
        ord_, dim, keepdim = None, (args[1] if len(args) > 1 else kwargs.get("dim")), kwargs.get("keepdim", False)
    else:
        ord_, dim = None, (args[1] if len(args) > 1 else kwargs.get("dim"))
        keepdim = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
    dims = _reduce_dims(dim, x.dim())
    out = func(*args, **kwargs)
    if d not in dims:
        out._tp_dim = d if keepdim else d - sum(i < d for i in dims)
        return out
    if key in ("linalg_vector_norm", "norm"):
        if ord_ in (2, 2.0, None, "fro"):
            return _over_shards(out.square()).sqrt()
        if ord_ == float("inf"):
            return _over_shards(out, torch.distributed.ReduceOp.MAX)
        raise NotImplementedError(f"head TP cannot reduce a {ord_}-norm over a shard's classes")
    if key in ("sum", "dot", "vdot"):
        return _over_shards(out)
    if key == "mean":
        return _over_shards(out) / par.axis_size("model")
    if key in ("amax", "max"):
        return _over_shards(out, torch.distributed.ReduceOp.MAX)
    if key in ("amin", "min"):
        return _over_shards(out, torch.distributed.ReduceOp.MIN)
    if key in ("all", "any"):
        op = torch.distributed.ReduceOp.MIN if key == "all" else torch.distributed.ReduceOp.MAX
        return _over_shards(out.to(torch.int32), op).bool()
    raise NotImplementedError(f"head TP cannot reduce {key} over a shard's classes")


_REDUCTIONS = {"_foreach_norm": _foreach_norm, **{k: _reduction for k in (
    "linalg_vector_norm", "norm", "sum", "mean", "amax", "amin", "max", "min", "dot", "vdot", "all", "any")}}
# same-shaped ops that would mix a shard's classes with one another
_MIXING = frozenset("""softmax log_softmax cumsum cumprod sort argsort flip roll topk kthvalue median std var
std_mean var_mean matmul mm bmm einsum __matmul__ outer ger svd qr cholesky linalg_svd linalg_qr
""".split())


class _ShardReductions(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        marked = [t for t in _tensors(args, kwargs) if _dim_of(t) is not None]
        if not marked:
            return func(*args, **kwargs)
        key = getattr(func, "__name__", "")
        if key in _REDUCTIONS and (key != "max" and key != "min" or not any(isinstance(a, torch.Tensor) for a in args[1:])):
            return _REDUCTIONS[key](func, args, kwargs)
        if key in _MIXING or key in ("view", "reshape", "flatten", "__getitem__", "index_select", "gather", "cat",
                                     "stack", "narrow", "split", "chunk", "unbind", "t", "transpose", "permute"):
            raise NotImplementedError(f"head TP cannot run {key} on a shard of the classes")
        out = func(*args, **kwargs)
        _propagate(out, args, marked[0])
        return out


def _propagate(out, args, first) -> None:
    """Mark the outputs of an op on shards as shards: a tensor of a marked
    input's shape, or each of a list paired with a list argument."""
    if isinstance(out, torch.Tensor):
        if out.shape == first.shape and _dim_of(out) is None:
            out._tp_dim = _dim_of(first)
        return
    if isinstance(out, (list, tuple)):
        pair = next((a for a in args if isinstance(a, (list, tuple)) and len(a) == len(out)), None)
        for i, o in enumerate(out):
            src = pair[i] if pair is not None else None
            if isinstance(o, torch.Tensor) and _dim_of(src) is not None and o.shape == src.shape and _dim_of(o) is None:
                o._tp_dim = _dim_of(src)


def reductions(model: torch.nn.Module, optimizer=None):
    """The context of the step's reductions over parameters, gradients and
    optimizer state: under head TP it marks every shard's gradient (and the
    optimizer's state of it) and sums each reduction over a marked dim over
    the model ranks; without it, a null context."""
    spec = sharded(model)
    if not spec:
        return contextlib.nullcontext()
    params = dict(model.named_parameters())
    for name, (d, _) in spec.items():
        p = params[name]
        for t in (p, p.grad):
            if t is not None:
                t._tp_dim = d
        for opt in _optimizers(optimizer):
            for v in opt.state.get(p, {}).values():
                if isinstance(v, torch.Tensor) and v.shape == p.shape:
                    v._tp_dim = d
    return _ShardReductions()


def _optimizers(opt):
    while opt is not None:
        yield opt
        opt = getattr(opt, "inner", None) or getattr(opt, "optimizer", None)
