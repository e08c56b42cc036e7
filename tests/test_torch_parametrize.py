"""The forward weight parametrizations of the port against the JAX package's
(models/parametrize.py): the transforms, the set of kernels each one takes,
``ParametrizedModel``, the spectral state's life (init, train, eval,
accumulation, EMA, checkpoint), and the CLI with each of them.

Transforms, on random kernels (depthwise and grouped ones included): the
zero-mean, standardisation and stateless spectral transforms within 1e-6
of the largest value (float32, both packages compute these in float32).

Names: the parameters each transform takes, against the JAX predicates on
the flax paths (mapped by the weights plan), on the full bresnet50, config
6's and config 29's full-width CModels (shapes only, no compile).

ParametrizedModel: a small CModel with a 3x3 conv, a ConvActBlock
(ScaledStdConv), BlurPool, a PreInvertedResidual (its depthwise 3x3 is not
standardised) and a Linear head, in float64 but for the transforms (float32
in both packages): output within 1e-6 of the largest value and every
parameter gradient within 1e-5 of its largest value, in train and eval
mode, for scaled WS, zero mean and spectral normalization.

Spectral state, float32, u and v within 1e-5 of their largest element: the
initial pair from the JAX draw through the port's 15 iterations; the pair
after a train forward; unchanged by an eval forward; after one train step
with ``accumulate_steps=2`` (one iteration per microbatch, as the JAX scan
threads it) and its EMA 0.5, against the JAX step; a checkpoint round
trip restores it exactly.

CLI: configs/tiny_synthetic.yaml with ``weight_standardization=true``, and
with each forward-norm callback: the run trains, the checkpoint holds the
raw kernels under the unwrapped model's names (and the spectral pairs), and
its eval reproduces the run's final val metrics exactly."""

import copy
import glob
import math
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sota_imagenet_tpu import config as JC
from sota_imagenet_tpu.losses import CrossEntropyLoss as JCrossEntropyLoss
from sota_imagenet_tpu.models import parametrize as JP
from sota_imagenet_tpu.models.cmodel import CModel as JCModel
from sota_imagenet_tpu.models.resnet import bresnet50 as jbresnet50
from sota_imagenet_tpu.optim import build_optimizer as jax_build_optimizer
from sota_imagenet_tpu.train import steps as jsteps
from sota_imagenet_tpu_torch import cli
from sota_imagenet_tpu_torch import config as TC
from sota_imagenet_tpu_torch.losses import CrossEntropyLoss
from sota_imagenet_tpu_torch.models import parametrize as TP
from sota_imagenet_tpu_torch.models.cmodel import CModel
from sota_imagenet_tpu_torch.models.resnet import bresnet50
from sota_imagenet_tpu_torch.optim import build_optimizer
from sota_imagenet_tpu_torch.train import steps
from sota_imagenet_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from sota_imagenet_tpu_torch.train.loop import Runner
from sota_imagenet_tpu_torch.utils.weights import _plan, flax_to_torch_model, kernel_parameters

FN_TOL = 1e-6
NET_TOL = {"output": 1e-6, "grad": 1e-5}
STATE_TOL = 1e-5
CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")


def _close(got, want, what, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max(), err_msg=what)


def _oihw(hwio: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(hwio.transpose(3, 2, 0, 1)))


# --------------------------------------------------------------------------- #
# The transforms
# --------------------------------------------------------------------------- #

KERNELS = {"3x3": (3, 3, 16, 24), "1x1": (1, 1, 32, 8), "depthwise": (3, 3, 1, 16), "stem": (7, 7, 3, 64)}


@pytest.mark.parametrize("shape", sorted(KERNELS))
def test_kernel_transforms_match_jax(shape):
    w = np.random.default_rng(0).standard_normal(KERNELS[shape]).astype(np.float32) * 0.3 + 0.05
    t = _oihw(w)
    cases = {
        "zero_mean": (JP.zero_mean_conv_weight, TP.zero_mean_conv_weight),
        "ws_1.72": (lambda a: JP.normalize_conv_weight(a, 1.72), lambda a: TP.normalize_conv_weight(a, 1.72)),
        "ws_1.0": (JP.normalize_conv_weight, TP.normalize_conv_weight),
        "spectral_5": (JP.spectral_normalize, TP.spectral_normalize),
        "spectral_2": (lambda a: JP.spectral_normalize(a, 2), lambda a: TP.spectral_normalize(a, 2)),
    }
    for name, (jfn, tfn) in cases.items():
        want = np.asarray(jfn(jnp.asarray(w))).transpose(3, 2, 0, 1)
        got = tfn(t)
        assert got.dtype == torch.float32
        _close(got.numpy(), want, f"{name} of {shape}", FN_TOL)
    ws = TP.normalize_conv_weight(t, 1.72).double().reshape(t.shape[0], -1)
    np.testing.assert_allclose(ws.mean(dim=1).numpy(), 0.0, atol=1e-6)
    np.testing.assert_allclose(ws.std(dim=1, correction=0).numpy(), 1.72 / ws.shape[1] ** 0.5, rtol=1e-4)


# --------------------------------------------------------------------------- #
# Which kernels each transform takes
# --------------------------------------------------------------------------- #


def _jax_names(variables_shapes, predicate, model) -> set:
    """The port names of the JAX leaves ``predicate`` selects (through the weights plan)."""
    by_path = {src: dst for dst, (coll, src, _) in _plan(model).items() if coll == "params"}
    flat, _ = jax.tree_util.tree_flatten_with_path(variables_shapes["params"])
    return {by_path[JP._path_name(p)] for p, leaf in flat if predicate(p, leaf)}


def _config_model(name):
    path = os.path.join(CONFIGS, "exp", name)
    jmodel = JC.instantiate(JC.load(path, strict_env=False).model)
    return jmodel, cli.build_model(TC.load(path, strict_env=False))


MODELS = {
    "bresnet50": lambda: (jbresnet50(), bresnet50()),
    "config_6": lambda: _config_model("6.bnet_no_dim_red.yaml"),
    "config_29": lambda: _config_model("29.nf_conv-act_spectral-norm.yaml"),
}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_parametrized_names_are_the_jax_sets(model):
    jmodel, tmodel = MODELS[model]()
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    ws = TP.weight_standardization_fn(1.72).select(tmodel)
    spectral = TP.SpectralNormParametrization().select(tmodel)
    assert set(ws) == _jax_names(shapes, JP._is_ungrouped_conv_kernel, tmodel)
    assert set(spectral) == _jax_names(shapes, JP._is_conv_kernel, tmodel)
    assert ws and set(ws) <= set(spectral) and set(spectral) <= set(kernel_parameters(tmodel))
    assert TP.spectral_norm_fn().select(tmodel) == spectral
    if model == "bresnet50":  # every conv is ungrouped; ECA's kernel and the head are not convs
        assert len(ws) == len(spectral) == 53  # the stem, 16 x 3 in the blocks, 4 downsamples
        assert not any(n.startswith("fc.") or ".attn." in n for n in spectral)
    if model == "config_6":  # the PreInvertedResiduals' depthwise 3x3s
        assert len(spectral) - len(ws) == 11


# --------------------------------------------------------------------------- #
# ParametrizedModel
# --------------------------------------------------------------------------- #

SMALL = yaml.safe_load("""
- [-1, 1, conv3x3, [3, 8], {stride: 2}]
- [-1, 1, ConvActBlock, [8, 16], {activation: silu}]
- [-1, 1, "pt.modules.BlurPool", 16]
- [-1, 1, PreInvertedResidual, [16, 16, 32], {norm_act: silu}]
- [-1, 1, "pt.modules.FastGlobalAvgPool2d", [], {flatten: True}]
- [-1, 1, "nn.Linear", [16, 10]]
""")
FNS = {
    "ws_1.72": (lambda: JP.weight_standardization_fn(1.72), lambda: TP.weight_standardization_fn(1.72)),
    "zero_mean": (lambda: JP.weight_standardization_fn(None), lambda: TP.weight_standardization_fn(None)),
    "spectral": (lambda: JP.SpectralNormParametrization(1), lambda: TP.SpectralNormParametrization(1)),
}
X_SHAPE = (4, 16, 16, 3)


def _small(dtype, seed=0):
    """The JAX SMALL model's variables (dtype), from its init."""
    jmodel = JCModel(layer_config=SMALL)
    variables = jax.jit(lambda k: jmodel.init(k, jnp.zeros(X_SHAPE), train=False))(jax.random.PRNGKey(seed))
    return jmodel, jax.tree_util.tree_map(lambda a: np.asarray(a, dtype), variables)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("fn", sorted(FNS))
def test_parametrized_model_forward_and_gradients_match_jax(fn, train):
    jfn, tfn = FNS[fn]
    rng = np.random.default_rng(1)
    x = rng.standard_normal(X_SHAPE)
    cot = rng.standard_normal((X_SHAPE[0], 10))
    with jax.enable_x64(True):
        jmodel, variables = _small(np.float64)
        jp = JP.ParametrizedModel(jmodel, jfn())
        if getattr(jfn(), "stateful", False):
            variables = dict(variables)
            variables["batch_stats"] = {**variables["batch_stats"],
                                        JP.SPECTRAL_STATE_KEY: jfn().init_state(variables["params"])}
        stats = variables["batch_stats"]

        @jax.jit
        def fwd_bwd(p, xj):
            def f(p):
                v = {"params": p, "batch_stats": stats}
                if train:
                    return jp.apply(v, xj, train=True, mutable=["batch_stats"])
                return jp.apply(v, xj, train=False), {}

            out, vjp, upd = jax.vjp(f, p, has_aux=True)
            return out, vjp(jnp.asarray(cot))[0], upd

        want, want_gp, updated = jax.tree_util.tree_map(np.asarray, fwd_bwd(variables["params"], jnp.asarray(x)))
    inner = CModel(layer_config=SMALL).double()
    model = TP.ParametrizedModel(inner, tfn())
    model.load_state_dict(flax_to_torch_model(model, variables["params"], stats))
    out = model.train(train)(torch.from_numpy(x))
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out.detach().numpy(), want, "output", NET_TOL["output"])
    want_grads = flax_to_torch_model(inner, want_gp, {k: v for k, v in stats.items() if k != JP.SPECTRAL_STATE_KEY})
    for name, p in model.named_parameters():
        _close(p.grad.numpy(), want_grads[name].numpy(), f"gradient of {name}", NET_TOL["grad"])
    if train:
        new = flax_to_torch_model(model, variables["params"], updated["batch_stats"])
        for k, b in model.state_dict().items():
            if "running_" in k or TP.SPECTRAL_STATE_KEY in k:
                _close(b.numpy(), new[k].numpy(), f"state {k}", STATE_TOL)


def test_wrapper_keeps_the_inner_names_and_transforms_only_its_selection():
    inner = CModel(layer_config=SMALL)
    model = TP.ParametrizedModel(inner, TP.weight_standardization_fn(1.72))
    assert list(model.state_dict()) == list(inner.state_dict())
    assert [n for n, _ in model.named_parameters()] == [n for n, _ in inner.named_parameters()]
    eff = model.effective_parameters()
    assert set(eff) == {"layers.0.0.weight", "layers.1.0.conv.weight", "layers.3.0.conv1.weight",
                        "layers.3.0.conv3.weight"}  # not the depthwise conv2, ECA-free, not the head
    spectral = TP.ParametrizedModel(inner, TP.SpectralNormParametrization())
    extra = set(spectral.state_dict()) - set(inner.state_dict())
    assert extra == {f"{TP.SPECTRAL_STATE_KEY}.{n}.{k}" for n in spectral.stateful_names() for k in "uv"}
    assert {n for n, _ in spectral.named_buffers()} >= extra
    # composing: the outer transform runs first, as nested JAX wrappers apply them
    both = TP.ParametrizedModel(spectral, TP.weight_standardization_fn(None))
    assert both.model is inner and len(both.fns) == 2 and both.stateful_names() == spectral.stateful_names()
    with pytest.raises(ValueError, match="stateful"):
        TP.ParametrizedModel(spectral, TP.SpectralNormParametrization())


# --------------------------------------------------------------------------- #
# The spectral state
# --------------------------------------------------------------------------- #


def test_spectral_initial_state_is_the_jax_power_iteration():
    """The port's 15 iterations from the JAX draw give the JAX initial pair;
    the port's own draw is seeded by the crc32 of the parameter's name."""
    jmodel, variables = _small(np.float32)
    jstate = JP.SpectralNormParametrization(1).init_state(variables["params"])
    inner = CModel(layer_config=SMALL)
    model = TP.ParametrizedModel(inner, TP.SpectralNormParametrization(1))
    sd = flax_to_torch_model(model, variables["params"], {**variables["batch_stats"], JP.SPECTRAL_STATE_KEY: jstate})
    by_path = {dst: src for dst, (coll, src, _) in _plan(inner).items()}
    assert len(jstate) == len(model.stateful_names()) == 5  # the depthwise 3x3 too
    for name in model.stateful_names():
        path = by_path[name]
        w = sd[name]
        u0 = jax.random.normal(jax.random.PRNGKey(zlib.crc32(path.encode()) & 0x7FFFFFFF), (w.shape[0],), jnp.float32)
        u0 = torch.from_numpy(np.array(u0 / jnp.maximum(jnp.linalg.norm(u0), 1e-12)))
        u, v = TP.power_iteration(w.reshape(w.shape[0], -1), u0, torch.zeros(w[0].numel()), 15)
        key = f"{TP.SPECTRAL_STATE_KEY}.{name}"
        _close(u.numpy(), sd[key + ".u"].numpy(), f"u of {name}", STATE_TOL)
        _close(v.numpy(), sd[key + ".v"].numpy(), f"v of {name}", STATE_TOL)
    # the port's own initial pair: unit vectors, seeded by the name
    model.load_state_dict(sd)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    model.reset_state()
    again = model.state_dict()
    for name in model.stateful_names():
        u = again[f"{TP.SPECTRAL_STATE_KEY}.{name}.u"]
        assert abs(float(u.norm()) - 1.0) < 1e-5 and not torch.equal(u, state[f"{TP.SPECTRAL_STATE_KEY}.{name}.u"])
    model.reset_state()
    assert all(torch.equal(a, b) for a, b in zip(again.values(), model.state_dict().values()))


def test_spectral_state_moves_in_training_and_stays_in_eval():
    model = TP.ParametrizedModel(CModel(layer_config=SMALL), TP.SpectralNormParametrization(2))
    x = torch.randn(X_SHAPE)
    before = copy.deepcopy(model.state_dict())
    with torch.no_grad():
        model.eval()(x)
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    model.train()(x)
    moved = [k for k, v in model.state_dict().items() if not torch.equal(before[k], v)]
    assert {k for k in moved if TP.SPECTRAL_STATE_KEY in k} == {k for k in before if TP.SPECTRAL_STATE_KEY in k}
    # two iterations from the stored pair
    for name in model.stateful_names():
        key = f"{TP.SPECTRAL_STATE_KEY}.{name}"
        w = model.model.get_parameter(name).detach()
        u, v = TP.power_iteration(w.reshape(w.shape[0], -1), before[key + ".u"], before[key + ".v"], 2)
        torch.testing.assert_close(model.state_dict()[key + ".u"], u)
        torch.testing.assert_close(model.state_dict()[key + ".v"], v)


@pytest.fixture(scope="module")
def spectral_step():
    """One JAX train step (float32) with ForwardSpectralNorm, accumulate_steps 2, EMA 0.5."""
    rng = np.random.default_rng(3)
    images = rng.standard_normal((8, *X_SHAPE[1:])).astype(np.float32)
    labels = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 8)]
    jmodel, variables = _small(np.float32)
    param_fn = JP.SpectralNormParametrization(1)
    jp = JP.ParametrizedModel(jmodel, param_fn)
    params = variables["params"]
    stats = {**variables["batch_stats"], JP.SPECTRAL_STATE_KEY: param_fn.init_state(params)}
    optim = {"_target_": "sgd", "momentum": 0.9}
    tx = jax_build_optimizer(optim, lambda count: 0.05)
    state = jsteps.TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
                              opt_state=tx.init(params), ema_params=params, ema_batch_stats=stats)
    step = jax.jit(jsteps.build_train_step(jp, JCrossEntropyLoss(), tx, lambda c: 0.05, accumulate_steps=2,
                                           ema_decay=0.5, input_dtype=jnp.float32))
    new, m = step(state, {"image": jnp.asarray(images), "label": jnp.asarray(labels)}, jax.random.PRNGKey(0))
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"images": images, "labels": labels, "params": host(params), "stats": host(stats), "optim": optim,
            "loss": float(m["loss"]), "final": (host(new.params), host(new.batch_stats)),
            "ema": (host(new.ema_params), host(new.ema_batch_stats))}


def _port_step(run, accumulate_steps=2):
    model = TP.ParametrizedModel(CModel(layer_config=SMALL), TP.SpectralNormParametrization(1))
    state = steps.init_state(model, lambda m: build_optimizer(run["optim"], m.named_parameters()), device="cpu",
                             ema_decay=0.5)
    init = flax_to_torch_model(model, run["params"], run["stats"])
    model.load_state_dict(init)
    state.ema.load_state_dict(init)
    step = steps.build_train_step(CrossEntropyLoss(), lambda i: 0.05, accumulate_steps=accumulate_steps, ema_decay=0.5,
                                  input_dtype=torch.float32)
    state, m = step(state, {"image": torch.from_numpy(run["images"]), "label": torch.from_numpy(run["labels"])})
    return state, m, init


def test_spectral_state_through_an_accumulated_step_and_its_ema_matches_jax(spectral_step):
    state, m, init = _port_step(spectral_step)
    np.testing.assert_allclose(float(m["loss"]), spectral_step["loss"], rtol=1e-5)
    want = flax_to_torch_model(state.model, *spectral_step["final"])
    want_ema = flax_to_torch_model(state.model, *spectral_step["ema"])
    got, got_ema = state.model.state_dict(), state.ema.state_dict()
    keys = [k for k in got if TP.SPECTRAL_STATE_KEY in k]
    assert len(keys) == 10
    for k in keys:
        _close(got[k].numpy(), want[k].numpy(), f"{k} after the step", STATE_TOL)
        _close(got_ema[k].numpy(), want_ema[k].numpy(), f"{k} of the EMA", STATE_TOL)
        assert not torch.equal(got[k], init[k])
    # one power iteration per microbatch: two from the initial pair, on the unchanged weights
    for name in state.model.stateful_names():
        key = f"{TP.SPECTRAL_STATE_KEY}.{name}"
        w = init[name]
        u, v = TP.power_iteration(w.reshape(w.shape[0], -1), init[key + ".u"], init[key + ".v"], 2)
        _close(got[key + ".u"].numpy(), u.numpy(), f"two iterations of {key}.u", STATE_TOL)
        _close(got[key + ".v"].numpy(), v.numpy(), f"two iterations of {key}.v", STATE_TOL)
    for k in ("layers.0.0.weight", "layers.5.0.weight"):
        _close(got[k].numpy(), want[k].numpy(), f"{k} after the step", 1e-4)


def test_spectral_state_checkpoint_round_trip(spectral_step, tmp_path):
    state, _, _ = _port_step(spectral_step)
    path = save_checkpoint(str(tmp_path), state, epoch=3, include_optimizer=True)
    fresh, _, _ = _port_step(spectral_step, accumulate_steps=1)
    fresh, epoch = load_checkpoint(path, fresh)
    assert epoch == 3
    for a, b in ((state.model, fresh.model), (state.ema, fresh.ema)):
        sd_a, sd_b = a.state_dict(), b.state_dict()
        assert list(sd_a) == list(sd_b) and all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a)
    disk = torch.load(path, weights_only=True)["state"]["model"]
    assert any(TP.SPECTRAL_STATE_KEY in k for k in disk)
    # the raw kernels are on disk, not the normalized ones
    assert torch.equal(disk["layers.0.0.weight"], state.model.model.get_parameter("layers.0.0.weight").detach())


# --------------------------------------------------------------------------- #
# The CLI
# --------------------------------------------------------------------------- #

TINY = os.path.join(CONFIGS, "tiny_synthetic.yaml")
DRIVES = {
    "weight_standardization": ["weight_standardization=true", "init_gamma=1.0"],
    "forward_weight_norm": ["run.extra_callbacks=[{_target_: ForwardWeightNorm, gamma: 1.72, use_std: true}]"],
    "forward_spectral_norm": ["run.extra_callbacks=[{_target_: ForwardSpectralNorm}]"],
}


@pytest.mark.parametrize("drive", sorted(DRIVES))
def test_cli_trains_with_the_parametrization_and_its_eval_reproduces_the_run(drive, tmp_path):
    runs = []

    class Probe(cli.Callback):
        def on_begin(self):
            runs.append(self.runner.state.model)

    val = cli.main(["-c", TINY, *DRIVES[drive], f"log.dir={tmp_path / 'train'}"], device="cpu", callbacks=[Probe()])
    assert all(math.isfinite(v) for v in val.values())
    (model,) = runs
    assert isinstance(model, TP.ParametrizedModel)
    (ckpt,) = glob.glob(os.path.join(tmp_path, "train", "*_tiny_synthetic", "*", "model_last.ckpt"))
    disk = torch.load(ckpt, weights_only=True)["state"]["model"]
    inner_keys = set(CModel(layer_config=TC.to_dict(TC.load(TINY, strict_env=False).model)["layer_config"]).state_dict())
    spectral = {k for k in disk if k.startswith(TP.SPECTRAL_STATE_KEY)}
    assert set(disk) - spectral == inner_keys and bool(spectral) == (drive == "forward_spectral_norm")
    again = cli.main(["-c", TINY, *DRIVES[drive], f"log.dir={tmp_path / 'eval'}", "run.evaluate=true",
                      f"run.resume={ckpt}"], device="cpu")
    assert again == val


def test_runner_wraps_once_and_steps_take_no_parametrization():
    from sota_imagenet_tpu_torch.train.callbacks import ForwardWeightNorm

    inner = CModel(layer_config=SMALL)
    runner = Runner(inner, CrossEntropyLoss(), lambda m: build_optimizer({"_target_": "sgd"}, m.named_parameters()),
                    lr_phases=[{"ep": (0, 1), "lr": (0.1, 0.1), "mode": "linear"}],
                    callbacks=[ForwardWeightNorm(gamma=1.0, use_std=True)], device="cpu")
    runner.init_state()
    runner.init_state()
    assert isinstance(runner.state.model, TP.ParametrizedModel) and runner.state.model.model is inner
    with pytest.raises(ValueError, match="gamma"):
        ForwardWeightNorm(use_std=True)


def test_bf16_run_standardises_in_float32_and_convolves_in_bfloat16():
    """Under run.bf16 the transform reads the float32 parameters and computes
    in float32; each conv then casts its effective weight to the activation
    dtype, so no conv falls back to float32 (the JAX transform casts back to
    the parameter's dtype, parametrize.py:58-60)."""
    from sota_imagenet_tpu_torch.models.layers import Conv

    model = TP.ParametrizedModel(bresnet50(layers=(1, 1, 1, 1), num_classes=10), TP.weight_standardization_fn(1.72))
    seen = []
    for m in model.modules():
        if isinstance(m, Conv):
            m.register_forward_hook(lambda mod, inp, out: seen.append((inp[0].dtype, out.dtype)))
    eff = model.effective_parameters()
    assert all(w.dtype == torch.float32 for w in eff.values())
    with torch.no_grad():
        out = model.eval()(torch.randn(2, 32, 32, 3).to(torch.bfloat16))
    assert out.dtype == torch.float32 and seen and set(seen) == {(torch.bfloat16, torch.bfloat16)}
