"""The port's serving artifact (``sota_imagenet_tpu_torch/utils/export.py``
and ``cli export``) against the JAX package's (``sota_imagenet_tpu/utils/
export.py``, tests/test_export.py, tests/test_cli_tools.py).

The JAX ``tiny()`` CModel of tests/test_export.py at 16 px, its weights
from the JAX init (BatchNorm statistics drawn from a numpy seed) carried
over by ``flax_to_torch_model``, uint8 images from a numpy seed: the port's
artifact, traced and served on the CPU in float32, gives the JAX
``make_serve_fn``'s logits within 1e-5, for a fixed batch, a symbolic batch
served at 1, 3 and 5, and wrapped in the spectral norm (with its u/v state)
or in weight standardisation. int8: the JAX ``_save_tree``/``_load_tree``
dequantized weights, in the port's layout, equal the port's bit for bit in
float32 (float32 and bfloat16 trees, a model with ECA's kernel), and the
JAX int8 artifact and the port's serve the same logits within 1e-5. With
tracing on, a served request is a span ``serve.request`` holding
``serve.h2d`` and ``serve.program``."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sota_imagenet_tpu import config as JC
from sota_imagenet_tpu.models import parametrize as JP
from sota_imagenet_tpu.models.cmodel import CModel as JCModel
from sota_imagenet_tpu.utils import export as JE
from sota_imagenet_tpu_torch import cli
from sota_imagenet_tpu_torch import config as TC
from sota_imagenet_tpu_torch.models import parametrize as TP
from sota_imagenet_tpu_torch.models.cmodel import CModel
from sota_imagenet_tpu_torch.utils import export as TE
from sota_imagenet_tpu_torch.utils import trace
from sota_imagenet_tpu_torch.utils.weights import flax_to_torch_model

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
TOL = 1e-5
SIZE = 16

# tests/test_export.py's tiny()
TINY = [
    {"module": "conv3x3", "args": [3, 8], "kwargs": {"stride": 2}},
    {"module": "BatchNorm2d", "args": [8]},
    {"module": "ReLU"},
    {"module": "FastGlobalAvgPool2d", "kwargs": {"flatten": True}},
    {"module": "Linear", "args": [8, 10]},
]
# a NormFreeBlock with ECA: ScaledStdConv kernels (with gains) and ECA's (k, 1, 1) kernel
WITH_ECA = [
    [-1, 1, "conv3x3", [3, 8], {"stride": 2}],
    [-1, 1, "NormFreeBlock", [8, 8], {"attention_type": "eca"}],
    [-1, 1, "BatchNorm2d", [8]],
    [-1, 1, "FastGlobalAvgPool2d", [], {"flatten": True}],
    [-1, 1, "Linear", [8, 10]],
]
WRAPS = {
    "spectral": (lambda: JP.SpectralNormParametrization(), lambda: TP.SpectralNormParametrization()),
    "ws": (lambda: JP.weight_standardization_fn(1.72), lambda: TP.weight_standardization_fn(1.72)),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(batch, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (batch, SIZE, SIZE, 3), np.uint8)


def _models(layers=TINY, wrap=None, seed=0):
    """The JAX model and its variables (BatchNorm statistics drawn from a
    numpy seed, so the normalization is not the identity), and the port's
    model holding the same weights."""
    jmodel, model = JCModel(layer_config=layers), CModel(layer_config=layers)
    if wrap is not None:
        jmodel, model = JP.ParametrizedModel(jmodel, WRAPS[wrap][0]()), TP.ParametrizedModel(model, WRAPS[wrap][1]())
    keys = {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(seed + 1)}
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(keys, jnp.zeros((2, SIZE, SIZE, 3)), train=False))
    rng = np.random.default_rng(seed)

    def draw(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "mean":
            return rng.normal(0, 0.5, a.shape).astype(a.dtype)
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(a.dtype)
        return a

    variables = dict(variables)
    if "batch_stats" in variables:
        stats = dict(variables["batch_stats"])
        spectral = stats.pop(JP.SPECTRAL_STATE_KEY, None)
        stats = jax.tree_util.tree_map_with_path(draw, stats)
        if spectral is not None:
            stats[JP.SPECTRAL_STATE_KEY] = spectral
        variables["batch_stats"] = stats
    model.load_state_dict(flax_to_torch_model(model, variables["params"], variables.get("batch_stats")))
    return jmodel, variables, model.eval()


def _jax_logits(jmodel, variables, images):
    return np.asarray(JE.make_serve_fn(jmodel, jnp.float32)(variables, jnp.asarray(images)))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("case", ["fixed", "symbolic", "spectral", "ws"])
def test_artifact_serves_the_jax_logits(tmp_path, case):
    wrap = case if case in WRAPS else None
    jmodel, variables, model = _models(wrap=wrap)
    batch = 4 if case == "fixed" else None
    out = TE.export_inference(model, str(tmp_path / "art"), image_size=SIZE, batch_size=batch,
                              input_dtype=torch.float32)
    serve, meta = TE.load_exported(out, device="cpu")
    assert meta["image_size"] == SIZE and meta["batch_size"] == batch and meta["input_dtype"] == "float32"
    assert meta["traced_on"] == "cpu" and set(meta["platforms"]) == {"cpu", "cuda"}
    sizes = (4,) if batch else (1, 3, 5)
    for n in sizes:
        images = _images(n, seed=n)
        got = serve(images)
        assert got.dtype == torch.float32 and tuple(got.shape) == (n, 10)
        _close(got, _jax_logits(jmodel, variables, images))
    # a request is a span holding its copy to the device and the program's call; its unit counts the requests
    trace.enable()
    try:
        serve(_images(sizes[0]))
    finally:
        trace.disable()
    spans = trace.take()
    (request,) = [s for s in spans if s.name == "serve.request"]
    inner = sorted((s.name, s.unit) for s in spans if s.parent == request.id)
    assert request.unit == len(sizes) and inner == [("serve.h2d", len(sizes)), ("serve.program", len(sizes))]
    program = torch.export.load(os.path.join(out, "model.pt2"))
    assert TE.custom_ops(program) == []
    if wrap:  # the raw kernels are stored; the parametrization runs inside the program
        stored = TE.load_params(os.path.join(out, "params.npz"))
        assert torch.equal(stored["layers.0.0.weight"], model.state_dict()["layers.0.0.weight"])
        assert any(TP.SPECTRAL_STATE_KEY in k for k in stored) == (wrap == "spectral")


def test_program_holds_no_weights(tmp_path):
    """The weights come in as inputs: the .pt2 of a model whose weights are
    ~0.4 MB stays a graph, and the int8 artifact is smaller in all."""
    from sota_imagenet_tpu_torch.models import resnet18

    model = resnet18(num_classes=10).eval()
    fp = TE.export_inference(model, str(tmp_path / "fp"), image_size=32, input_dtype=torch.float32)
    q8 = TE.export_inference(model, str(tmp_path / "q8"), image_size=32, input_dtype=torch.float32, quantize="int8")

    def size(d, name=None):
        return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d) if name in (None, f))

    weights = sum(t.numel() * t.element_size() for t in model.state_dict().values())
    assert size(fp, "params.npz") > weights and size(fp, "model.pt2") < weights / 20
    assert size(q8, "params.npz") < 0.35 * size(fp, "params.npz")
    assert size(q8) < 0.35 * size(fp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layers", ["tiny", "eca"])
def test_int8_dequantized_weights_equal_the_jax_ones_bit_for_bit(tmp_path, layers, dtype):
    jmodel, variables, model = _models(WITH_ECA if layers == "eca" else TINY)
    if dtype == "bfloat16":
        variables = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16) if a.dtype == np.float32 else a, variables)
        model = model.to(torch.bfloat16)
    JE._save_tree(str(tmp_path / "jax.npz"), variables, quantize="int8")
    jax_tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), JE._load_tree(str(tmp_path / "jax.npz")))
    want = flax_to_torch_model(model, jax_tree["params"], jax_tree.get("batch_stats"))
    channel_dims = TE.quantizable(model)
    TE.save_params(str(tmp_path / "port.npz"), model.state_dict(), quantize="int8", channel_dims=channel_dims)
    got = TE.load_params(str(tmp_path / "port.npz"))
    assert list(got) == list(model.state_dict())
    for name, t in got.items():
        assert t.dtype == model.state_dict()[name].dtype, name
        assert torch.equal(t.float(), want[name].float()), name
    z = np.load(str(tmp_path / "port.npz"))
    quant = json.loads(str(z["__quant__"]))
    jz = np.load(str(tmp_path / "jax.npz"))
    assert len(quant) == len(json.loads(str(jz["__quant__"]))) == len(channel_dims)
    assert set(quant.values()) == {dtype}
    if dtype == "bfloat16":  # the rest of a bf16 tree goes through the uint16 view
        assert json.loads(str(z["__views__"])) and all(v == "bfloat16" for v in json.loads(str(z["__views__"])).values())
    if layers == "eca":
        eca = [n for n, d in channel_dims.items() if model.state_dict()[n].dim() == 3]
        assert len(eca) == 1 and z[f"a{list(got).index(eca[0])}_s"].size == 1  # one output unit: one scale


def test_int8_artifact_serves_the_jax_int8_artifact_logits(tmp_path):
    jmodel, variables, model = _models(WITH_ECA)
    jout = JE.export_inference(jmodel, variables, str(tmp_path / "jax"), image_size=SIZE, batch_size=4,
                               input_dtype=jnp.float32, platforms=("cpu",), quantize="int8")
    out = TE.export_inference(model, str(tmp_path / "port"), image_size=SIZE, batch_size=4,
                              input_dtype=torch.float32, quantize="int8")
    jserve, _ = JE.load_exported(jout)
    serve, meta = TE.load_exported(out, device="cpu")
    assert meta["quantize"] == "int8"
    images = _images(4)
    want = np.asarray(jserve(jnp.asarray(images)))
    _close(serve(images), want)
    assert np.abs(want - _jax_logits(jmodel, variables, images)).max() > 0  # int8 moved the logits


def test_unknown_quantize_raises_before_anything_is_written(tmp_path):
    _, _, model = _models()
    out = tmp_path / "half"
    with pytest.raises(ValueError, match="quantize"):
        TE.export_inference(model, str(out), image_size=SIZE, batch_size=2, input_dtype=torch.float32,
                            quantize="int4")
    assert not out.exists()


def test_int8_raises_when_nothing_qualifies(tmp_path):
    path = tmp_path / "never_written.npz"
    with pytest.raises(ValueError, match="no float 'kernel'"):
        TE.save_params(str(path), {"bias": torch.zeros(4)}, quantize="int8", channel_dims={})
    with pytest.raises(ValueError, match="no float 'kernel'"):
        JE._save_tree(str(path), {"params": {"bias": np.zeros(4, np.float32)}}, quantize="int8")
    # a model without a kernel: only its norm's scale and bias
    norm_only = CModel(layer_config=[{"module": "BatchNorm2d", "args": [3]}])
    assert TE.quantizable(norm_only) == {}
    assert not path.exists()


@pytest.mark.parametrize("config", ["tpu_soak.yaml", "tiny_synthetic.yaml", "exp/1.r50_baseline.yaml",
                                    "exp/bresnet50.yaml"])
def test_resolve_final_image_size_matches_jax(config):
    path = os.path.join(CONFIGS, config)
    want = JE.resolve_final_image_size(JC.load(path, strict_env=False))
    assert TE.resolve_final_image_size(TC.load(path, strict_env=False)) == want
    if config == "tpu_soak.yaml":  # the FINAL stage's size, not the first's
        assert want == 224


def test_export_cli_end_to_end_serves_the_ema_weights(tmp_path):
    """``cli export --ema --device cpu``: config -> the trainer's model ->
    checkpoint -> artifact; its logits are the EMA model's eval forward, not
    the raw weights' (tests/test_cli_tools.py::test_export_cli_end_to_end)."""
    from sota_imagenet_tpu_torch.train import steps as steps_lib
    from sota_imagenet_tpu_torch.train.checkpoint import save_checkpoint

    config = os.path.join(CONFIGS, "tiny_synthetic.yaml")
    overrides = ["run.ema_decay=0.9"]
    cfg = TC.load(config, overrides=overrides, strict_env=False)
    model = cli.build_model(cfg)
    state = steps_lib.init_state(model, cli.optimizer_factory(cfg, model), device=torch.device("cpu"), seed=3,
                                 ema_decay=0.9, criterion=TC.instantiate(cfg.criterion))
    with torch.no_grad():  # an EMA apart from the weights, BatchNorm statistics apart from init
        gen = torch.Generator().manual_seed(0)
        for t in state.ema.state_dict().values():
            if t.is_floating_point():
                t.add_(0.1 * torch.randn(t.shape, generator=gen))
    ckpt = save_checkpoint(str(tmp_path), state, epoch=1)
    out = tmp_path / "artifact"
    cli.export_main(["-c", config, "--ckpt", ckpt, "--out", str(out), "--ema", "--batch", "4", "--device", "cpu",
                     *overrides])
    serve, meta = TE.load_exported(str(out), device="cpu")
    assert meta["image_size"] == 32 and meta["input_dtype"] == "float32"  # tiny_synthetic: run.bf16 false
    images = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (4, 32, 32, 3), np.uint8))
    logits = serve(images)
    assert tuple(logits.shape) == (4, 1000)
    x = (images.float() - 127.5) / 51.0
    with torch.no_grad():
        ema = state.ema.eval()(x)
        raw = state.model.eval()(x)
    _close(logits, ema.numpy())
    assert (logits - raw).abs().max() > 1e-2


def test_export_cli_wraps_the_parametrizations_and_reads_the_divisor_head(tmp_path):
    """The exporter builds the model as the trainer does: weight
    standardisation and a callback's spectral norm wrap it (the checkpoint
    holds the raw kernels and the u/v state), and ``loader.classes_divisor``
    narrows the head (the JAX exporter builds ``instantiate(cfg.model)``)."""
    from sota_imagenet_tpu_torch.train import steps as steps_lib
    from sota_imagenet_tpu_torch.train.checkpoint import save_checkpoint

    config = os.path.join(CONFIGS, "tiny_synthetic.yaml")
    overrides = ["model={_target_: resnet18}", "weight_standardization=true", "+loader.classes_divisor=4",
                 "run.extra_callbacks=[{_target_: ForwardSpectralNorm}]"]
    cfg = TC.load(config, overrides=overrides, strict_env=False)
    model = cli.parametrized_model(cfg, cli.build_model(cfg))
    assert isinstance(model, TP.ParametrizedModel) and len(model.fns) == 2 and model.stateful_names()
    state = steps_lib.init_state(model, cli.optimizer_factory(cfg, model), device=torch.device("cpu"), seed=1)
    ckpt = save_checkpoint(str(tmp_path), state, epoch=1)
    out = tmp_path / "artifact"
    cli.export_main(["-c", config, "--ckpt", ckpt, "--out", str(out), "--device", "cpu", *overrides])
    serve, meta = TE.load_exported(str(out), device="cpu")
    assert meta["batch_size"] is None
    images = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (3, 32, 32, 3), np.uint8))
    with torch.no_grad():
        want = state.model.eval()((images.float() - 127.5) / 51.0)
    assert tuple(want.shape) == (3, 250)
    _close(serve(images), want.numpy())


def test_jax_exporter_cannot_restore_a_classes_divisor_head(tmp_path):
    """The question for the JAX side (ROADMAP Queue 3): the JAX exporter
    builds ``instantiate(cfg.model)`` (JAX cli.py:369) and ignores
    ``loader.classes_divisor``, which JAX ``main`` applies (cli.py:157-169),
    so it cannot restore the narrower head its own trainer wrote. The
    port's exporter builds the model as its trainer does (the test above)."""
    from sota_imagenet_tpu.cli import export_main as jax_export_main
    from sota_imagenet_tpu.optim import build_optimizer
    from sota_imagenet_tpu.train import steps as jsteps
    from sota_imagenet_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint

    config = tmp_path / "divisor.yaml"  # the schema's defaults fill the rest
    config.write_text(
        "model: {_target_: resnet18}\n"
        "loader: {image_size: 32, batch_size: 8, backend: synthetic, classes_divisor: 4}\n"
        "optim: {_target_: sgd, momentum: 0.9}\n"
        "criterion: {_target_: cross_entropy}\n"
        "run: {bf16: false, stages: [{start: 0, end: 1, lr: [0.1, 0]}]}\n"
    )
    cfg = JC.load(str(config), strict_env=False)
    model = JC.instantiate({**dict(cfg.model), "num_classes": 250})  # the head JAX main builds
    state = jsteps.init_state(model, build_optimizer(dict(cfg.optim), 0.1), (2, 32, 32, 3), jax.random.PRNGKey(0),
                              input_dtype=jnp.float32, criterion=JC.instantiate(cfg.criterion))
    ckpt = jax_save_checkpoint(str(tmp_path / "ckpt"), state, epoch=1, block=True)
    with pytest.raises(Exception, match=r"\(512, 1000\).*\(512, 250\)"):
        jax_export_main(["-c", str(config), "--ckpt", ckpt, "--out", str(tmp_path / "out")])
