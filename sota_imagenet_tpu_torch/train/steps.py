"""Train and eval steps (port of ``sota_imagenet_tpu/train/steps.py``:
cutmix_mixup :40-107, init_state :115-140, build_train_step :185-352,
build_eval_step :355-406, its masked branch included).

One train step: CutmixMixup on the whole batch -> the batch split into
``accumulate_steps`` microbatches, each forward (activation dtype) -> loss
(f32, plus the auxiliary loss of the parameters where one is given; a
stateful criterion's state advanced once per microbatch, chained through
them) -> backward, gradients summed then divided -> the gradient transform where
one is given (AGC), in place on the device -> grad_norm (global L2 norm of
the averaged gradients after the transform, before weight decay, as the JAX
step reports it) -> one optimizer step with the
schedule's lr for this step -> the post-step transform of the parameters
where one is given -> one EMA update of params and buffers -> metrics over
all the logits. Everything stays on the device: the
lr is a host float computed from the host step count, the random draws are
device tensors, and the metrics are device tensors the Runner reduces once
per epoch, so no step reads the device.

Randomness: one ``torch.Generator`` on the device (``TrainState.generator``)
serves mixup, dropout and drop-path. Each step seeds it from the run's seed
and the step number before drawing, so a resumed run continues the stream.
threefry and Philox cannot agree, so each random transform is a ``draw``
function on a generator and an ``apply`` function on tensors: tests feed the
JAX package's draws to ``apply``.

SAM (``sam``) runs a second forward and backward through the same
microbatch loop at the perturbed weights p + epsilon (``SamPerturbation``),
and the update applies that pass's gradients to the saved, unperturbed
weights. The second pass moves the buffers too (BN statistics, VarEMA,
the spectral u/v) and the criterion's state with ``bn_from_perturbed``
(the default, as the reference); without it, it starts from the step's
buffers and criterion state and the step keeps the clean pass's. Loss and
logits are the clean pass's; grad_norm is the perturbed point's gradients'
after the transform (JAX steps.py:339). The eval steps read the
criterion's state and leave it as it is.

Data parallelism (``parallel/mesh.py``): with a process group of N ranks,
each step computes what the JAX step computes on the global batch, of which
this rank holds rows [r*B/N, (r+1)*B/N). The mixup draws are every rank's
(the generator is seeded from the run's seed and the step alone) and the
partner of global row i is global row B-1-i (``mirror``); dropout and
drop-path then draw from a stream of the rank's own (rank 0's is the one
process's). With accumulation each rank takes its 1/N of each of the JAX
step's microbatches, contiguous runs of the global batch
(``microbatch_rows``). The gradients and the metrics are averaged over the
ranks after each pass (once after the last microbatch; after each of SAM's
two passes, so the perturbation reads the global gradient), before the
gradient transform, grad_norm and the optimizer read them.

Rematerialization (``remat``, JAX steps.py:158-182 and :218-222): each
top-level unit of the model's trunk (``remat_segments``: every residual
block, CModel layer, stem conv and norm; not the head) runs under a
``torch.utils.checkpoint`` of its own (non-reentrant), so the backward
recomputes one unit just before that unit's backward, and only one unit's
activations are live again at a time, as XLA schedules the JAX recompute;
the criterion, its state and the aux loss run outside. ``'full'`` keeps
nothing of a unit for the backward and runs it again there; ``'convs'``
keeps the outputs of the convolutions and matrix products (a
selective-checkpoint policy, the JAX ``conv_general_dilated`` /
``dot_general`` predicate) and runs everything else again. A hand-written
kernel called through ctypes (``conv1x1_stats``) is no dispatcher op, so it
runs again under both, as a ``pallas_call`` does in the JAX step. The
recompute sees what the forward saw and leaves what the forward left
(``_Replay``, per unit): the unit's buffers (BatchNorm's running
statistics, VarEMA's) and the state of the bound dropout generator are put
back to their values before its forward while it runs, then to their
values after it; a parametrized model's transformed weights are swapped in
again, and its spectral u/v, outside the units, move once. Under N ranks
the recomputed BatchNorm statistics issue their all-reduces again
(``mesh.STATS`` counts them).

Spatial partitioning (``mesh.spatial`` = S > 1, ``parallel/spatial.py``):
after the mixup each rank keeps its band of H rows of the images and the
model runs on bands; a spatial rank backpropagates 1/S of its data rank's
loss, and the gradients are summed over the data x spatial ranks and
divided by the data ranks. Head TP (``mesh.model`` > 1,
``parallel/tp.py``): the head's class shards gather their logits, and the
reductions of the gradient transform, grad_norm, SAM's perturbation, the
optimizer and the post-step transform over a shard's classes take the other
shards' share.

A skipping optimizer (``optim/skip_nonfinite.ApplyIfFinite``, the
counterpart of ``optax.apply_if_finite``) counts the updates it applied:
the update reads the schedule at that count, as the JAX optimizer reads
its own count, while the ``lr`` metric stays ``lr_schedule(step)``. A
skipped update still moves the buffers, the criterion's state, the EMA
and the post-step transform, as the JAX step does.

The train step marks its phases with spans (``utils/trace.py``; nothing
while tracing is off): ``step.mixup``, ``step.forward`` and
``step.backward`` for each microbatch (and SAM pass), ``step.grad_sync``
(the average over the microbatches and the ranks, with the batch's
metrics), ``step.optimizer`` (gradient transform, norm, update, post-step
transform) and ``step.ema``.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts, set_checkpoint_early_stop,
)

from sota_imagenet_tpu_torch.losses.base import StatefulLoss, call_criterion
from sota_imagenet_tpu_torch.models.layers import bind_generator
from sota_imagenet_tpu_torch.models.parametrize import ParametrizedModel
from sota_imagenet_tpu_torch.optim.factory import _unitwise_norm
from sota_imagenet_tpu_torch.parallel import mesh as par
from sota_imagenet_tpu_torch.parallel import spatial, tp
from sota_imagenet_tpu_torch.train.metrics import accuracy_topk, classification_metrics
from sota_imagenet_tpu_torch.train.state import TrainState
from sota_imagenet_tpu_torch.utils import trace
from sota_imagenet_tpu_torch.utils.weights import flax_ranks, unit_dims

Batch = Dict[str, torch.Tensor]
MixupDraws = Dict[str, torch.Tensor]


# --------------------------------------------------------------------------- #
# Batch transforms (device-side)
# --------------------------------------------------------------------------- #


def resolve_choice_prob(cutmix_alpha: float, mixup_alpha: float, choice_prob: float) -> Optional[float]:
    """P(cutmix | applied) once a zero alpha has disabled its transform: Beta(0, 0)
    samples NaN, so a disabled branch is excluded statically, not by the 50/50
    draw. None: both are disabled, the batch passes unchanged."""
    if cutmix_alpha <= 0 and mixup_alpha <= 0:
        return None
    if mixup_alpha <= 0:
        return 1.0
    if cutmix_alpha <= 0:
        return 0.0
    return float(choice_prob)


def _beta(generator: Optional[torch.Generator], alpha: float, device) -> torch.Tensor:
    """One Beta(alpha, alpha) sample on ``device`` as a ratio of two float64 Gamma draws."""
    g = torch._standard_gamma(torch.full((2,), alpha, dtype=torch.float64, device=device), generator=generator)
    return (g[0] / (g[0] + g[1])).float()


def draw_cutmix_mixup(
    generator: Optional[torch.Generator],
    height: int,
    width: int,
    device,
    cutmix_alpha: float = 1.0,
    mixup_alpha: float = 0.2,
    prob: float = 1.0,
    choice_prob: float = 0.5,
) -> MixupDraws:
    """The random values of one ``cutmix_mixup`` call, as 0-dim tensors on
    ``device``: ``apply`` and ``use_cutmix`` (bool), ``lam_m`` and ``lam_c``
    (float32; 1.0 for a disabled transform), the box centre ``cy``, ``cx``
    (int64 in [0, height) and [0, width))."""
    one = torch.ones((), device=device)
    u = torch.rand((2,), generator=generator, device=device)
    choice = resolve_choice_prob(float(cutmix_alpha), float(mixup_alpha), float(choice_prob))
    return {
        "apply": u[0] < float(prob),
        "use_cutmix": u[1] < (0.0 if choice is None else choice),
        "lam_m": _beta(generator, float(mixup_alpha), device) if mixup_alpha > 0 else one,
        "lam_c": _beta(generator, float(cutmix_alpha), device) if cutmix_alpha > 0 else one,
        "cy": torch.randint(0, height, (), generator=generator, device=device),
        "cx": torch.randint(0, width, (), generator=generator, device=device),
    }


def apply_cutmix_mixup(
    images: torch.Tensor,
    labels: torch.Tensor,
    draws: MixupDraws,
    cutmix_alpha: float = 1.0,
    mixup_alpha: float = 0.2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cutmix OR mixup on a batch of NHWC images and soft labels, from drawn
    values (steps.py:40-107 of the JAX package). The partner of sample i is
    sample B-1-i. Mixup blends with ``lam_m``; cutmix pastes the partner's
    box of area ``1 - lam_c`` around (cy, cx), clipped to the image, and
    mixes the labels by the clipped box's exact area. Both are computed and
    ``use_cutmix`` chooses; ``apply`` then chooses between that and the
    untouched batch (apply-then-choose, as the JAX package). The blend runs
    in float32 (float64 for float64 images) and is cast back. Over ranks the
    batch is this rank's rows of the global one, and the partner comes from
    the rank that holds it (``parallel.mesh.mirror``)."""
    if resolve_choice_prob(float(cutmix_alpha), float(mixup_alpha), 0.5) is None:
        return images, labels
    _, h, w, _ = images.shape
    dev = images.device
    x = images.to(torch.promote_types(images.dtype, torch.float32))
    perm_x, perm_labels = par.mirror(images, "mixup").to(x.dtype), par.mirror(labels, "mixup")

    lam_m = draws["lam_m"]
    mix_img = lam_m * x + (1.0 - lam_m) * perm_x
    mix_lab = lam_m * labels + (1.0 - lam_m) * perm_labels

    ratio = torch.sqrt(1.0 - draws["lam_c"])
    cut_h, cut_w = (ratio * h).to(torch.int64), (ratio * w).to(torch.int64)
    cy, cx = draws["cy"], draws["cx"]
    y0, y1 = (cy - cut_h // 2).clamp(0, h), (cy + cut_h // 2).clamp(0, h)
    x0, x1 = (cx - cut_w // 2).clamp(0, w), (cx + cut_w // 2).clamp(0, w)
    yy = torch.arange(h, device=dev).view(1, h, 1, 1)
    xx = torch.arange(w, device=dev).view(1, 1, w, 1)
    in_box = (yy >= y0) & (yy < y1) & (xx >= x0) & (xx < x1)
    cut_img = torch.where(in_box, perm_x, x)
    lam_adj = 1.0 - ((y1 - y0) * (x1 - x0)).to(torch.float32) / (h * w)  # exact area after clipping
    cut_lab = lam_adj * labels + (1.0 - lam_adj) * perm_labels

    out_img = torch.where(draws["use_cutmix"], cut_img, mix_img)
    out_lab = torch.where(draws["use_cutmix"], cut_lab, mix_lab)
    return (
        torch.where(draws["apply"], out_img, x).to(images.dtype),
        torch.where(draws["apply"], out_lab, labels),
    )


def cutmix_mixup(
    generator: Optional[torch.Generator],
    images: torch.Tensor,
    labels: torch.Tensor,
    cutmix_alpha: float = 1.0,
    mixup_alpha: float = 0.2,
    prob: float = 1.0,
    choice_prob: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Randomly apply cutmix OR mixup to a batch (reference CutmixMixup;
    ``choice_prob`` = P(cutmix | applied): 1.0 gives the standalone Cutmix,
    0.0 the standalone Mixup). Labels must be soft/one-hot."""
    _, h, w, _ = images.shape
    draws = draw_cutmix_mixup(generator, h, w, images.device, cutmix_alpha, mixup_alpha, prob, choice_prob)
    return apply_cutmix_mixup(images, labels, draws, cutmix_alpha, mixup_alpha)


# --------------------------------------------------------------------------- #
# State init
# --------------------------------------------------------------------------- #


def init_state(
    model: torch.nn.Module,
    optimizer_factory: Callable[[torch.nn.Module], torch.optim.Optimizer],
    *,
    device: torch.device,
    seed: int = 0,
    ema_decay: float = 0.0,
    criterion: Optional[Callable] = None,
    tp_params=None,
) -> TrainState:
    """Initialize the model's parameters from ``seed`` (on the host, so the
    weights do not depend on the device), move it to ``device`` in
    channels_last memory, keep this rank's class shards of the head under
    ``mesh.model`` > 1 (``parallel/tp.apply_head_tp`` with the patterns
    ``tp_params``), and build its optimizer, its EMA copy, the
    step's random generator on the device (bound to the model's dropout and
    drop-path modules) and, for a stateful ``criterion``, its initial state
    on the device."""
    if hasattr(model, "reset_parameters"):
        model.reset_parameters(torch.Generator().manual_seed(int(seed)))
    model.to(device=device, memory_format=torch.channels_last)
    if par.axis_size("model") > 1:
        tp.apply_head_tp(model, tp_params)
    ema = copy.deepcopy(model).requires_grad_(False) if ema_decay else None
    generator = torch.Generator(device=device)
    bind_generator(model, generator)
    loss_state = criterion.init_state(device) if isinstance(criterion, StatefulLoss) else None
    return TrainState(
        step=0, model=model, optimizer=optimizer_factory(model), ema=ema, generator=generator, seed=int(seed),
        loss_state=loss_state,
    )


def step_seed(seed: int, step: int) -> int:
    """The generator's seed for one train step: a function of the run's seed
    and the step only, so a run resumed at ``step`` draws what the
    uninterrupted run would have drawn."""
    return (int(seed) * 1_000_003 + int(step)) % (2**63)


# --------------------------------------------------------------------------- #
# Train / eval steps
# --------------------------------------------------------------------------- #


def _restore(dst, src) -> None:
    """Copy ``src`` into ``dst``, tensor by tensor (multi-tensor copies, no host read)."""
    if dst:
        torch._foreach_copy_(dst, src)


def _snapshot(tensors):
    """Copies of ``tensors``."""
    out = [torch.empty_like(t) for t in tensors]
    _restore(out, tensors)
    return out


class SamPerturbation:
    """The SAM perturbation epsilon of each parameter (steps.py:257-289 of the
    JAX package; reference callbacks.py:279-419), from the parameters p and
    the clean pass's gradients g:

      * ``asam`` (layer-wise): rho * max(||p||, 1e-3) / max(||g||, 1e-5) * g;
      * ``asam_unitwise``: the same with a norm per output unit (the weights
        plan's ``unit_dims``; a 0-d or 1-d parameter is one unit);
      * ``sam_original``: with w = max(|p|, eta) for a matrix (a JAX leaf of
        more than one axis, ``flax_rank``) and 1 otherwise, scale = rho /
        max(||g w||, 2e-5) over all parameters, and epsilon = max(p^2, eta) g
        scale for a matrix, g scale otherwise.

    Called with the model, its parameters and their gradients, it adds
    epsilon to the parameters in place. The layout is read off the weights
    plan once per model."""

    def __init__(self, kind: str = "asam", rho: float = 0.05, eta: float = 0.01):
        if kind not in ("asam", "asam_unitwise", "sam_original"):
            raise ValueError(f"unknown SAM kind {kind!r}")
        self.kind, self.rho, self.eta = kind, rho, eta
        self._model, self._dims, self._ranks = None, {}, {}

    def _layout(self, model: torch.nn.Module) -> None:
        if model is not self._model:
            dims, ranks = unit_dims(model), flax_ranks(model)
            named = list(model.named_parameters())
            self._model = model
            self._dims = {id(p): dims[n] for n, p in named}
            self._ranks = {id(p): ranks[n] for n, p in named}

    def epsilon(self, model: torch.nn.Module, params, grads) -> list:
        eps_n, eps_w = 1e-5, 1e-3
        if self.kind == "asam":
            pn = torch.stack(torch._foreach_norm(params)).clamp(min=eps_w)
            gn = torch.stack(torch._foreach_norm(grads)).clamp(min=eps_n)
            return list(torch._foreach_mul(grads, list((self.rho * pn / gn).unbind())))
        self._layout(model)
        if self.kind == "asam_unitwise":
            return [
                self.rho * _unitwise_norm(p, self._dims[id(p)]).clamp(min=eps_w)
                / _unitwise_norm(g, self._dims[id(p)]).clamp(min=eps_n) * g
                for p, g in zip(params, grads)
            ]
        matrix = [self._ranks[id(p)] > 1 for p in params]
        weighted = [g * p.abs().clamp(min=self.eta) if m else g for p, g, m in zip(params, grads, matrix)]
        scale = self.rho / torch.linalg.vector_norm(torch.stack(torch._foreach_norm(weighted))).clamp(min=2e-5)
        return [(p.square().clamp(min=self.eta) * g if m else g) * scale for p, g, m in zip(params, grads, matrix)]

    def __call__(self, model: torch.nn.Module, params, grads) -> None:
        torch._foreach_add_(params, self.epsilon(model, params, grads))


_aten = torch.ops.aten
# the JAX 'convs' predicate's primitives (steps.py:176-180): every convolution, and every matrix product
# (dot_general), which reach the dispatcher as these ops (matmul, einsum and linear lower to them)
SAVED_BY_CONVS = frozenset((
    _aten.convolution.default, _aten.mm.default, _aten.addmm.default, _aten.bmm.default, _aten.baddbmm.default,
    _aten.mv.default, _aten.addmv.default, _aten.dot.default, _aten.vdot.default,
))


def _save_convs(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in SAVED_BY_CONVS else CheckpointPolicy.PREFER_RECOMPUTE


def remat_policy(remat: Any) -> Optional[Callable]:
    """``run.remat`` -> the selective-checkpoint policy (JAX steps.py:158-182):
    None for ``True``/``'full'`` (nothing of the closure is kept), the
    ``SAVED_BY_CONVS`` policy for ``'convs'``; any other value raises."""
    if remat in (True, "full"):
        return None
    if remat == "convs":
        return _save_convs
    raise ValueError(f"run.remat must be false | true | 'full' | 'convs', got {remat!r}")


class _Replay:
    """The contexts of one checkpointed segment (``checkpoint``'s
    ``context_fn``): the forward records the buffers of ``model`` (the
    segment's module) and the generator's state before it runs; the
    recompute runs with those, then puts back what the forward left, so one
    step moves them once, as the JAX step whose batch_stats come from the
    primal pass. ``policy`` (a selective-checkpoint policy, or None) adds its
    caching contexts inside."""

    def __init__(self, model: torch.nn.Module, generator: Optional[torch.Generator], policy: Optional[Callable]):
        self.buffers = list(model.buffers())
        self.generator, self.policy = generator, policy
        self.before, self.gen_before = None, None

    def _state(self):
        return _snapshot(self.buffers), (self.generator.get_state() if self.generator is not None else None)

    def _put(self, buffers, gen_state) -> None:
        _restore(self.buffers, buffers)
        if self.generator is not None:
            self.generator.set_state(gen_state)

    @contextlib.contextmanager
    def _forward(self, inner):
        self.before, self.gen_before = self._state()
        with inner:
            yield

    @contextlib.contextmanager
    def _recompute(self, inner):
        after, gen_after = self._state()
        self._put(self.before, self.gen_before)
        try:
            with inner:
                yield
        finally:
            self._put(after, gen_after)

    def __call__(self):
        inner = (create_selective_checkpoint_contexts(self.policy) if self.policy is not None
                 else (contextlib.nullcontext(), contextlib.nullcontext()))
        return self._forward(inner[0]), self._recompute(inner[1])


def _units(module: torch.nn.Module):
    """The top-level units of a model's trunk, in order: its children, with
    the containers (``nn.Sequential``, ``nn.ModuleList``, a CModel's layer
    lists) opened up."""
    for child in module.children():
        if isinstance(child, (torch.nn.Sequential, torch.nn.ModuleList)):
            yield from _units(child)
        else:
            yield child


def remat_segments(model: torch.nn.Module) -> list:
    """The modules ``run.remat`` checkpoints one by one: every top-level unit
    with state (each residual block, CModel layer, stem conv and norm) but the
    last one with parameters, the head."""
    root = model.model if isinstance(model, ParametrizedModel) else model
    has = lambda u, what: next(iter(getattr(u, what)()), None) is not None  # noqa: E731
    units = [u for u in _units(root) if has(u, "parameters") or has(u, "buffers")]
    with_params = [u for u in units if has(u, "parameters")]
    head = with_params[-1] if len(with_params) > 1 else None
    return [u for u in units if u is not head]


@contextlib.contextmanager
def checkpointed_segments(model: torch.nn.Module, generator: Optional[torch.Generator], policy: Optional[Callable]):
    """Within the context each of ``remat_segments(model)`` runs under its own
    non-reentrant checkpoint, so the backward recomputes one segment just
    before that segment's own backward and only one segment's activations
    are live again at a time (XLA schedules the JAX step's recompute so).
    The recompute runs with the parameters the forward saw (a parametrized
    model's transformed weights are swapped in only during its forward), with
    the segment's buffers and the generator as the forward found them
    (``_Replay``), and inside the spatial partitioning the forward ran in."""
    from torch.nn.utils.stateless import _reparametrize_module

    def wrap(seg):
        run = type(seg).forward

        def forward(*args, **kwargs):
            seen = dict(seg.named_parameters(remove_duplicate=False))
            within = spatial.current()

            def segment(*a, **k):
                now = dict(seg.named_parameters(remove_duplicate=False))
                swap = any(now[n] is not t for n, t in seen.items())
                with within(), (_reparametrize_module(seg, seen) if swap else contextlib.nullcontext()):
                    return run(seg, *a, **k)

            # the whole unit runs again, as XLA's recompute of the JAX closure: no early stop once its saved
            # tensors are back (a stem conv saves only its input and weight, and would never run again)
            with set_checkpoint_early_stop(False):
                return checkpoint(segment, *args, use_reentrant=False, context_fn=_Replay(seg, generator, policy),
                                  **kwargs)

        return forward

    segs = remat_segments(model)
    for seg in segs:
        seg.forward = wrap(seg)
    try:
        yield segs
    finally:
        for seg in segs:
            del seg.forward


def build_train_step(
    criterion: Callable,
    lr_schedule: Callable[[int], float] = lambda step: 0.1,
    *,
    accumulate_steps: int = 1,
    ema_decay: float = 0.0,
    mixup_fn: Optional[Callable] = None,  # fn(generator, images, labels) -> (images, labels)
    aux_loss: Optional[Callable] = None,  # aux_loss(model) -> f32 scalar, e.g. the ortho loss
    sam: Optional[Dict[str, Any]] = None,  # {kind: 'asam'|'asam_unitwise'|'sam_original', rho, eta, bn_from_perturbed}
    grad_transform: Optional[Callable] = None,  # fn(model, params, grads), in place before the update (AGC)
    post_step_transform: Optional[Callable] = None,  # fn(model), in place after the update (WeightNorm)
    remat: Any = False,
    input_dtype: torch.dtype = torch.bfloat16,
) -> Callable[[TrainState, Batch], Tuple[TrainState, Dict[str, Any]]]:
    policy = remat_policy(remat) if remat else None
    accumulate_steps = max(int(accumulate_steps or 1), 1)
    perturb = SamPerturbation(sam.get("kind", "asam"), sam.get("rho", 0.05), sam.get("eta", 0.01)) if sam else None
    bn_from_perturbed = bool(sam.get("bn_from_perturbed", True)) if sam else True

    def forward_loss(model, images, labels, loss_state, generator):
        """The closure JAX differentiates (steps.py:202-216): forward (each
        remat segment under its checkpoint), criterion, aux loss."""
        with checkpointed_segments(model, generator, policy) if remat else contextlib.nullcontext():
            logits = spatial.forward(model, images.to(input_dtype))
        loss, loss_state = call_criterion(criterion, logits, labels, loss_state)
        if aux_loss is not None:
            # once per microbatch, as inside the JAX scan; float32 whatever an autocast around the step says
            with torch.autocast(images.device.type, enabled=False), tp.reductions(model):
                loss = loss + aux_loss(model)
        return loss, logits, loss_state

    def batch_grads(model, opt, images, labels, loss_state, generator):
        """The metrics of the batch (its mean loss among them) and the mean
        gradients, into the parameters' ``.grad``, both averaged over the
        ranks, and the criterion's state after it: the same microbatch loop
        for the clean and the SAM pass, so accumulation bounds the second
        forward's memory too. The loader's batch is split, not several batches
        gathered; BN buffers and the criterion's state chain through the
        microbatches and the dropout stream runs on through them."""
        opt.zero_grad(set_to_none=True)
        mb = images.shape[0] // accumulate_steps
        loss_sum, all_logits = 0.0, []
        # every spatial rank computes its data rank's loss: each backpropagates 1/S of it, so that the sum of the
        # ranks' gradients is the data rank's (a band's convolutions give their share, the head its 1/S)
        bands = par.axis_size("spatial")
        for im, lb in zip(images.split(mb), labels.split(mb)):
            with trace.span("step.forward"):
                mb_loss, mb_logits, loss_state = forward_loss(model, im, lb, loss_state, generator)
            with trace.span("step.backward"):
                (mb_loss if bands == 1 else mb_loss / bands).backward()  # sums into .grad
            loss_sum = loss_sum + mb_loss.detach()
            all_logits.append(mb_logits.detach())
        params = [p for group in opt.param_groups for p in group["params"]]
        grads = [p.grad for p in params]
        # the gradients' average over the microbatches and over the ranks, with the batch's metrics
        with trace.span("step.grad_sync"):
            if accumulate_steps > 1:
                torch._foreach_div_(grads, float(accumulate_steps))
            loss = loss_sum / accumulate_steps
            metrics = classification_metrics(torch.cat(all_logits), labels, loss)
            stats = [loss, metrics["Acc@1"], metrics["Acc@5"]]
            heads = par.axis_size("model")
            if bands == heads == 1:
                # one all-reduce per dtype; the loss in its own dtype, then rounded as one process rounds it
                par.average_([*grads, *stats], "grad")
            else:
                # the bands' shares summed and the data ranks averaged; a replicated parameter's copies on the
                # model ranks averaged too (the same gradient, which the card's non-deterministic kernels round
                # apart), so every rank applies the same bits; the metrics are the data ranks'
                shards = {id(p) for n, p in model.named_parameters() if n in tp.sharded(model)}
                par.average_([g for p, g in zip(params, grads) if id(p) not in shards], "grad", axis="world",
                             count=par.data_count() * heads)
                par.average_([g for p, g in zip(params, grads) if id(p) in shards], "grad", axis="data_spatial",
                             count=par.data_count())
                par.average_(stats, "grad")
        metrics["loss"] = loss.to(torch.float32)
        return metrics, params, grads, loss_state

    def train_step(state: TrainState, batch: Batch):
        model, opt = state.model, state.optimizer
        model.train()
        if state.generator is not None:
            state.generator.manual_seed(step_seed(state.seed, state.step))
        images, labels = batch["image"], batch["label"]
        if mixup_fn is not None:
            # on the whole batch, before the split: the partner of sample i is B-1-i of the whole batch
            with torch.no_grad(), trace.span("step.mixup"):
                images, labels = mixup_fn(state.generator, images, labels)
        if state.generator is not None and par.data_index() > 0:
            # dropout and drop-path draw from this rank's own stream; the mixup draws above are every rank's
            state.generator.manual_seed(step_seed(par.rank_seed(state.seed), state.step))
        images = par.microbatch_rows(images, accumulate_steps)
        labels = par.microbatch_rows(labels, accumulate_steps)
        mb = images.shape[0] // accumulate_steps
        images, labels = images[: mb * accumulate_steps], labels[: mb * accumulate_steps]
        keep_buffers = perturb is not None and not bn_from_perturbed
        # the second pass starts from the step's buffers (the JAX state.batch_stats)
        before = _snapshot(list(model.buffers())) if keep_buffers else None
        metrics, params, grads, loss_state = batch_grads(model, opt, images, labels, state.loss_state, state.generator)
        if perturb is not None:
            # the second gradient, at p + epsilon (JAX steps.py:314-327); the update then applies to the
            # saved p, copied back, since p + eps - eps need not be p in floating point
            with torch.no_grad():
                saved = _snapshot(params)
                with tp.reductions(model, opt):
                    perturb(model, params, grads)
                if keep_buffers:
                    after = _snapshot(list(model.buffers()))  # the clean pass's, which the step keeps
                    _restore(list(model.buffers()), before)
            second_state = loss_state if bn_from_perturbed else state.loss_state
            _, params, grads, second_state = batch_grads(model, opt, images, labels, second_state, state.generator)
            if bn_from_perturbed:
                loss_state = second_state
            with torch.no_grad():
                _restore(params, saved)
                if keep_buffers:
                    _restore(list(model.buffers()), after)
        # a head-TP shard's reductions over its classes take the other shards' share (parallel/tp.py)
        with tp.reductions(model, opt), trace.span("step.optimizer"):
            if grad_transform is not None:
                # before grad_norm and before the optimizer adds the weight decay, as the JAX step and optax order them
                with torch.no_grad():
                    grad_transform(model, params, grads)
            grad_norm = torch.nn.utils.get_total_norm(grads)
            lr = lr_schedule(state.step)
            # the schedule at the optimizer's own count of applied updates, where it keeps one (a skipping
            # optimizer: JAX's tx reads its inner count, which a skipped update does not advance)
            update_lr = lr_schedule(opt.update_count) if hasattr(opt, "update_count") else lr
            for group in opt.param_groups:
                group["lr"] = update_lr
            opt.step()
            if post_step_transform is not None:
                with torch.no_grad():
                    post_step_transform(model)
        if par.axis_size("model") > 1:
            # every model rank takes the same statistics of the same rows, which the card's kernels (cuDNN's
            # algorithms are chosen per process) round apart: the buffers averaged, the same on every rank
            with torch.no_grad():
                par.average_([b for b in model.buffers() if b.is_floating_point()], "buffers", axis="model")
        if ema_decay:
            with torch.no_grad(), trace.span("step.ema"):
                ema_t = list(state.ema.state_dict().values())
                new_t = list(model.state_dict().values())
                # e * decay + p * (1 - decay), over params and BN buffers
                # (the reference ModelEma averages the full state_dict)
                torch._foreach_mul_(ema_t, ema_decay)
                torch._foreach_add_(ema_t, new_t, alpha=1.0 - ema_decay)
        metrics["grad_norm"] = grad_norm
        metrics["lr"] = lr
        state.step += 1
        state.loss_state = loss_state
        return state, metrics

    return train_step


def build_eval_step(
    criterion: Callable, *, input_dtype: torch.dtype = torch.bfloat16, use_ema: bool = False
) -> Callable[[TrainState, Batch], Dict[str, torch.Tensor]]:
    def eval_step(state: TrainState, batch: Batch):
        model = state.ema if (use_ema and state.ema is not None) else state.model
        model.eval()
        with torch.no_grad():
            logits = spatial.forward(model, batch["image"].to(input_dtype))
            labels = batch["label"]
            if "mask" not in batch:
                loss, _ = call_criterion(criterion, logits, labels, state.loss_state)
                return classification_metrics(logits, labels, loss)
            # padded (rectangular or tail) val batch: padded samples are masked
            # out; metrics are exact masked means, and "_weight" carries the
            # real sample count so Runner.evaluate can weight the batches
            mask = batch["mask"].to(torch.float32)
            n_real = mask.sum()  # true sample count (0 for an all-padding batch)
            n = torch.clamp(n_real, min=1.0)  # division floor only
            m = {
                "Acc@1": (accuracy_topk(logits, labels, 1, mean=False) * mask).sum() / n,
                "Acc@5": (accuracy_topk(logits, labels, 5, mean=False) * mask).sum() / n,
            }
            if hasattr(criterion, "reduction"):
                per_sample_criterion = copy.copy(criterion)
                per_sample_criterion.reduction = "none"
                per_sample, _ = call_criterion(per_sample_criterion, logits, labels, state.loss_state)
                if per_sample.dim() > 1:  # e.g. a (B, C) elementwise loss
                    per_sample = per_sample.mean(dim=tuple(range(1, per_sample.dim())))
                m["loss"] = (per_sample.to(torch.float32) * mask).sum() / n
            else:  # criteria without a per-sample form: the loss over the full batch, pads included
                loss, _ = call_criterion(criterion, logits, labels, state.loss_state)
                m["loss"] = loss.to(torch.float32)
            # weight by the true count, so an all-padding batch contributes 0,
            # not a phantom sample of accuracy 0
            m["_weight"] = n_real
            return m

    return eval_step
