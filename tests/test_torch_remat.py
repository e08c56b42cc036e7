"""``run.remat`` in the port's train step (``train/steps.py``: ``remat_policy``,
``_Replay``) against the JAX package's (steps.py:158-182, :218-222) and
against the port's own step without it.

* For each of off, ``'full'`` and ``'convs'`` the port's step equals the JAX
  step under the same policy: a ResNet-18 at 32 px (JAX tests/test_remat.py:32),
  float64, SGD; loss, grad_norm, the new parameters (through which the
  gradients pass: lr 0.1, momentum starts at 0) and BN buffers within
  ``TRAJ_TOL`` (1e-7 relative) of tests/test_torch_train_step.py: the JAX
  float64 step keeps float32 scalars of its own (measured without remat:
  grad_norm 6e-9 and every parameter's update 3e-8 off the port's, the same
  under each policy).
* Remat against no remat in the port, bit for bit: the new buffers, the
  gradients and the criterion's state, on a depth-cut bresnet with drop-path
  (the recompute's masks must be the forward's: the bound generator), and on a
  CModel trunk under the spectral norm (u/v advance once) with BatchNorm,
  VarEMA and AdaCos's state, with two microbatches.
* The convolutions the step executes (a TorchDispatchMode): ``'convs'``
  equals off, ``'full'`` is off + 20 (the forward's 20 convs run again; JAX
  tests/test_remat.py:98-121).
* The activation bytes kept from the forward for the backward (the tensors
  autograd packs, read through ``saved_tensors_hooks``, and the outputs the
  selective policy caches): ``'full'`` at most 2% of off (JAX
  tests/test_remat.py:65-95); ``'convs'`` exactly the forward's convolution
  and matmul outputs, under half of off (45.3% measured: the plain PyTorch
  step keeps little more than those and the ReLU outputs, where XLA's
  residuals, which JAX's 40% bound measures, hold more).
* ``conv1x1_stats``: calls of its plain version per step under each policy
  equal the ``pallas_call`` equations of the JAX step's jaxpr (interpret
  mode): 1 per fused conv without remat, 2 under both policies (a
  ``pallas_call`` is neither a convolution nor a dot, so it runs again).
* An unknown value raises ValueError naming ``run.remat``.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from torch.utils._python_dispatch import TorchDispatchMode

from sota_imagenet_tpu.losses import CrossEntropyLoss as JCrossEntropyLoss
from sota_imagenet_tpu.models.resnet import Bottleneck as JBottleneck
from sota_imagenet_tpu.models.resnet import ResNet as JResNet
from sota_imagenet_tpu.models.resnet import resnet18 as jresnet18
from sota_imagenet_tpu.ops import pallas_conv_stats as jcs
from sota_imagenet_tpu.optim import build_optimizer as jax_build_optimizer
from sota_imagenet_tpu.train import steps as jsteps
from sota_imagenet_tpu_torch.config import instantiate
from sota_imagenet_tpu_torch.losses import CrossEntropyLoss
from sota_imagenet_tpu_torch.models.parametrize import ParametrizedModel, SpectralNormParametrization
from sota_imagenet_tpu_torch.models.resnet import Bottleneck, ResNet, bresnet50, resnet18
from sota_imagenet_tpu_torch.ops import conv_stats
from sota_imagenet_tpu_torch.optim import build_optimizer
from sota_imagenet_tpu_torch.train import steps
from sota_imagenet_tpu_torch.utils.weights import flax_to_torch

from test_torch_train_step import TRAJ_TOL

SIZE, BATCH, CLASSES, LR = 32, 4, 10, 0.1
SGD = {"_target_": "sgd", "momentum": 0.9, "weight_decay": 1e-4}
POLICIES = [False, "full", "convs"]
# a trunk with BatchNorm, VarEMA and the sphere head's BatchNorm, under the spectral norm, trained with AdaCos
TRUNK = yaml.safe_load("""
- [-1, 1, conv3x3, [3, 8]]
- [-1, 1, BatchNorm2d, 8]
- [-1, 1, VarEMA, [], {use: true}]
- [-1, 1, conv3x3, [8, 8]]
- [-1, 1, ABN, 8]
- [-1, 1, "pt.modules.FastGlobalAvgPool2d", [], {flatten: True}]
- [-1, 1, SphereMLPLayer, [8, 10], {hidden_size: 16}]
""")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0, size=SIZE, batch=BATCH):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, size, size, 3)), np.eye(CLASSES)[rng.integers(0, CLASSES, batch)]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


@functools.lru_cache(maxsize=None)
def _jax_init():
    model = jresnet18(num_classes=CLASSES)
    v = jax.jit(lambda k: model.init(k, jnp.zeros((2, SIZE, SIZE, 3)), train=False))(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, v["params"]), jax.tree_util.tree_map(np.asarray, v["batch_stats"])


def _jax_step(remat):
    images, labels = _batch()
    params0, stats0 = _jax_init()
    with jax.enable_x64(True):
        f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)
        model = jresnet18(num_classes=CLASSES)
        sched = lambda s: jnp.asarray(LR, jnp.float64)
        tx = jax_build_optimizer(SGD, sched)
        params, stats = f64(params0), f64(stats0)
        state = jsteps.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                                  opt_state=tx.init(params))
        step = jax.jit(jsteps.build_train_step(model, JCrossEntropyLoss(smoothing=0.1), tx, sched, remat=remat,
                                               input_dtype=jnp.float64))
        state, m = step(state, {"image": jnp.asarray(images), "label": jnp.asarray(labels)}, jax.random.PRNGKey(1))
        host = lambda t: jax.tree_util.tree_map(np.asarray, t)
        return {k: float(v) for k, v in m.items()}, flax_to_torch(host(state.params), host(state.batch_stats),
                                                                   layers=(2, 2, 2, 2), bottleneck=False)


def _port_state(model, dtype=torch.float64, criterion=None):
    state = steps.init_state(model, lambda m: build_optimizer(SGD, m.named_parameters()), device="cpu",
                             criterion=criterion)
    state.model.to(dtype)
    if state.loss_state is not None:
        state.loss_state = {k: v.to(dtype) for k, v in state.loss_state.items()}
    return state


@pytest.mark.parametrize("remat", POLICIES, ids=["off", "full", "convs"])
def test_port_step_equals_the_jax_step_under_each_policy(remat):
    want_m, want = _jax_step(remat)
    params0, stats0 = _jax_init()
    state = _port_state(resnet18(num_classes=CLASSES))
    state.model.load_state_dict({k: v.double() for k, v in flax_to_torch(params0, stats0, layers=(2, 2, 2, 2),
                                                                         bottleneck=False).items()})
    images, labels = _batch()
    step = steps.build_train_step(CrossEntropyLoss(smoothing=0.1), lambda s: LR, remat=remat, input_dtype=torch.float64)
    state, m = step(state, {"image": torch.from_numpy(images), "label": torch.from_numpy(labels)})
    for k in ("loss", "grad_norm"):
        assert _rel(float(m[k]), want_m[k]) < TRAJ_TOL["loss"], (k, float(m[k]), want_m[k])
    got = state.model.state_dict()
    for kind, keys in (("params", [k for k in want if "running" not in k]), ("buffers", [k for k in want if "running" in k])):
        err = _rel(np.concatenate([got[k].numpy().ravel() for k in keys]), np.concatenate([want[k].numpy().ravel() for k in keys]))
        assert err < TRAJ_TOL["loss"], (kind, err)


def _bresnet():
    return bresnet50(layers=(1, 1, 1, 1), num_classes=CLASSES, drop_connect_rate=0.3, drop_rate=0.2)


def _trunk():
    return ParametrizedModel(instantiate({"_target_": "CModel", "layer_config": copy.deepcopy(TRUNK)}),
                             SpectralNormParametrization(1))


def _port_run(make, remat, criterion, accumulate_steps=1, n_steps=2):
    """Two steps; per step the gradients, and at the end the buffers, parameters and criterion state."""
    torch.manual_seed(0)
    model = make()
    if hasattr(model, "reset_parameters"):
        model.reset_parameters(torch.Generator().manual_seed(3))
    state = _port_state(model, torch.float32, criterion)
    step = steps.build_train_step(criterion, lambda s: LR, remat=remat, accumulate_steps=accumulate_steps,
                                  input_dtype=torch.float32)
    grads = []
    for i in range(n_steps):
        images, labels = _batch(i, batch=8)
        state, _ = step(state, {"image": torch.from_numpy(images).float(), "label": torch.from_numpy(labels).float()})
        grads.append([p.grad.clone() for p in state.model.parameters()])
    return {"grads": grads, "state": {k: v.clone() for k, v in state.model.state_dict().items()},
            "loss_state": state.loss_state}


@pytest.mark.parametrize("remat", ["full", "convs"])
@pytest.mark.parametrize("case", ["bresnet_drop_path", "spectral_trunk_varema_adacos"])
def test_remat_leaves_buffers_state_and_gradients_as_one_pass(case, remat):
    if case == "bresnet_drop_path":
        make, crit, accum = _bresnet, lambda: CrossEntropyLoss(smoothing=0.1), 1
    else:
        make, crit, accum = _trunk, lambda: instantiate({"_target_": "adacos", "margin": 0.0, "max_s": 20}), 2
    base, rem = _port_run(make, False, crit(), accum), _port_run(make, remat, crit(), accum)
    for i, (gb, gr) in enumerate(zip(base["grads"], rem["grads"])):
        for a, b in zip(gb, gr):
            assert torch.equal(a, b), f"step {i}: a gradient differs under remat={remat}"
    for k, v in base["state"].items():
        assert torch.equal(v, rem["state"][k]), f"{k} differs under remat={remat}"
    if base["loss_state"] is not None:
        for k, v in base["loss_state"].items():
            assert torch.equal(v, rem["loss_state"][k]), k
        assert float(base["loss_state"]["running_B"]) != 1000.0
    if case == "spectral_trunk_varema_adacos":
        moved = [k for k in base["state"] if k.endswith((".u", "std_ema"))]
        assert moved and all(not torch.equal(base["state"][k], _trunk().state_dict()[k]) for k in moved[:1])


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls[func] = self.calls.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def test_convs_policy_never_recomputes_a_convolution():
    counts = {}
    for remat in POLICIES:
        torch.manual_seed(0)
        state = _port_state(resnet18(num_classes=CLASSES), torch.float32)
        images, labels = _batch()
        step = steps.build_train_step(CrossEntropyLoss(smoothing=0.1), lambda s: LR, remat=remat,
                                      input_dtype=torch.float32)
        with _CountOps() as mode:
            step(state, {"image": torch.from_numpy(images).float(), "label": torch.from_numpy(labels).float()})
        counts[remat] = sum(mode.calls.get(op, 0) for op in (torch.ops.aten.convolution.default,
                                                             torch.ops.aten.convolution_backward.default))
    assert counts["convs"] == counts[False], counts
    assert counts["full"] == counts[False] + 20, counts  # resnet18's 20 forward convs run again


class _ConvOutputs(TorchDispatchMode):
    """Bytes of the outputs of the ops the 'convs' policy saves."""

    def __init__(self):
        super().__init__()
        self.bytes = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in steps.SAVED_BY_CONVS:
            self.bytes[out.untyped_storage().data_ptr()] = out.untyped_storage().nbytes()
        return out


def _saved_bytes(remat, monkeypatch) -> tuple:
    """Bytes of activations the forward keeps for the backward (what autograd
    packs outside a checkpoint, plus what the selective policy caches), and
    the bytes of the forward's convolution and matmul outputs."""
    torch.manual_seed(0)
    model = resnet18(num_classes=CLASSES).train()
    images, labels = (torch.from_numpy(a).float() for a in _batch(batch=8))
    own = {t.untyped_storage().data_ptr() for t in (*model.parameters(), *model.buffers(), images)}
    caches = []
    real = steps.create_selective_checkpoint_contexts

    def keep(policy):
        fwd, rec = real(policy)
        caches.append(fwd.storage)
        return fwd, rec

    monkeypatch.setattr(steps, "create_selective_checkpoint_contexts", keep)
    kept = {}

    def pack(t):
        if t.untyped_storage().data_ptr() not in own:
            kept[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t

    crit = CrossEntropyLoss(smoothing=0.1)
    closure = lambda x: crit(model(x), labels)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), _ConvOutputs() as convs:
        if remat:
            loss = torch.utils.checkpoint.checkpoint(closure, images, use_reentrant=False,
                                                     context_fn=steps._Replay(model, None, steps.remat_policy(remat)))
        else:
            loss = closure(images)
    for storage in caches:
        for by_index in storage.values():
            for entry in by_index.values():
                val = getattr(entry, "val", None)
                if isinstance(val, torch.Tensor) and val.untyped_storage().data_ptr() not in own:
                    kept[val.untyped_storage().data_ptr()] = val.untyped_storage().nbytes()
    loss.backward()
    return sum(kept.values()), sum(convs.bytes.values())


def test_remat_shrinks_the_saved_activations(monkeypatch):
    (off, conv_out), (full, _), (convs, _) = (_saved_bytes(r, monkeypatch) for r in POLICIES)
    assert full <= 0.02 * off, (off, convs, full)
    # 'convs' keeps the convolution and matmul outputs and nothing else: 45% of what the plain step keeps,
    # which is already little more than them and the ReLU outputs (XLA's residuals, JAX's 40% bound, held more)
    assert convs == conv_out and 0 < convs < 0.5 * off, (off, convs, full, conv_out)


def _count_pallas(jaxpr) -> int:
    n = 0
    for eqn in jaxpr.eqns:
        n += eqn.primitive.name == "pallas_call"
        for sub in jax.core.jaxprs_in_params(eqn.params):
            n += _count_pallas(sub)
    return n


@functools.lru_cache(maxsize=None)
def _jax_pallas_calls() -> dict:
    """The pallas_call equations of the JAX step's value-and-grad jaxpr under each policy (traced, not run)."""
    model = JResNet(block=JBottleneck, layers=(1, 1, 1, 1), num_classes=CLASSES, fused_stats=True)
    x = jnp.zeros((2, SIZE, SIZE, 3))
    v = jax.jit(lambda k: model.init(k, x, train=False))(jax.random.PRNGKey(0))
    labels = jax.nn.one_hot(jnp.zeros((2,), jnp.int32), CLASSES)

    def loss_fn(p):
        logits, _ = model.apply({"params": p, "batch_stats": v["batch_stats"]}, x, train=True, mutable=["batch_stats"])
        return jnp.mean(jnp.sum(-labels * jax.nn.log_softmax(logits), -1))

    out = {}
    for remat in POLICIES:
        fn = jax.checkpoint(loss_fn, policy=jsteps.remat_policy(remat)) if remat else loss_fn
        out[remat] = _count_pallas(jax.make_jaxpr(jax.value_and_grad(fn))(v["params"]).jaxpr)
    return out


@pytest.mark.parametrize("remat", POLICIES, ids=["off", "full", "convs"])
def test_conv1x1_stats_runs_as_often_as_the_jax_steps_pallas_calls(remat, monkeypatch):
    monkeypatch.setattr(jcs, "conv1x1_stats_nhwc", functools.partial(jcs.conv1x1_stats_nhwc, interpret=True))
    want = _jax_pallas_calls()[remat]
    calls = []
    real = conv_stats.conv1x1_stats_reference
    monkeypatch.setattr(conv_stats, "conv1x1_stats_reference", lambda *a: calls.append(1) or real(*a))
    torch.manual_seed(0)
    state = _port_state(ResNet(block=Bottleneck, layers=(1, 1, 1, 1), num_classes=CLASSES, fused_stats=True),
                        torch.float32)
    images, labels = _batch(batch=2)
    step = steps.build_train_step(CrossEntropyLoss(), lambda s: LR, remat=remat, input_dtype=torch.float32)
    step(state, {"image": torch.from_numpy(images).float(), "label": torch.from_numpy(labels).float()})
    fused = sum(1 for m in state.model.modules() if type(m).__name__ == "Conv1x1BNStats")
    assert len(calls) == want == fused * (1 if not remat else 2), (len(calls), want, fused)


@pytest.mark.parametrize("value", ["blocks", "convs_only", 2])
def test_unknown_remat_value_raises(value):
    with pytest.raises(ValueError, match="run.remat"):
        steps.remat_policy(value)
    with pytest.raises(ValueError, match="run.remat"):
        steps.build_train_step(CrossEntropyLoss(), remat=value)


def test_each_block_is_recomputed_just_before_its_own_backward():
    """The segments are per unit (``steps.remat_segments``): in the backward,
    block k runs again after block k+1's backward and before its own, once."""
    torch.manual_seed(0)
    state = _port_state(resnet18(num_classes=CLASSES), torch.float32)
    blocks = [s for s in steps.remat_segments(state.model) if type(s).__name__ == "BasicBlock"]
    assert len(blocks) == 8 and type(steps.remat_segments(state.model)[0]).__name__ == "Conv"
    events = []
    for k, block in enumerate(blocks):
        block.conv1.register_forward_pre_hook(
            lambda m, a, k=k: events.append(("recompute", k)) if torch._C._current_graph_task_id() != -1 else None)
        block.register_full_backward_hook(lambda m, gi, go, k=k: events.append(("backward", k)))
    images, labels = _batch()
    step = steps.build_train_step(CrossEntropyLoss(smoothing=0.1), lambda s: LR, remat="full", input_dtype=torch.float32)
    step(state, {"image": torch.from_numpy(images).float(), "label": torch.from_numpy(labels).float()})
    for k in range(len(blocks)):
        assert events.count(("recompute", k)) == 1 and events.count(("backward", k)) == 1, events
        assert events.index(("recompute", k)) < events.index(("backward", k))
        if k + 1 < len(blocks):
            assert events.index(("recompute", k)) > events.index(("backward", k + 1)), events

