"""Typed YAML config system (hydra-equivalent, zero external deps beyond pyyaml).

The port's own copy of ``sota_imagenet_tpu/config.py``: the same schema,
composition, interpolation and overrides, so every YAML under ``configs/``
composes to the same tree in both packages (tests/test_torch_config.py). The
schema keeps every key of the shared configs; options this port does not
run yet are rejected where they are used (cli.py), not here.

Replicates the reference's config surface (reference arg_parser.py:13-160,
configs/base.yaml): a strict dataclass schema, base + experiment-overlay
composition (``defaults: [/base@_here_]``), ``${env:VAR}`` / ``${a.b.c}`` /
``${now:%fmt}`` interpolation, and dotted CLI overrides (``run.ema_decay=0.999``,
``+new.key=1``). Components are instantiated from ``_target_`` dicts through the
registry (see registry.py) instead of hydra.utils.call (reference train.py:64).

Differences from the reference, on purpose:
  * no ``world_size``/``local_rank`` env plumbing;
  * ``run.bf16`` replaces ``run.fp16`` (bfloat16 compute; no GradScaler);
  * strict-by-default: unknown keys in schema'd sections raise, like hydra's
    structured configs did.
"""

from __future__ import annotations

import copy
import dataclasses
import datetime
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import yaml

from sota_imagenet_tpu_torch import registry


class _YamlLoader(yaml.SafeLoader):
    """SafeLoader + YAML-1.2-style float resolution: plain pyyaml parses
    ``1e-4`` / ``3e-5`` (no dot) as *strings*, which silently breaks numeric
    hyperparameters like weight_decay."""


_YamlLoader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(
        r"""^(?:
         [-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
        |\.[0-9][0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
        re.X,
    ),
    list("-+0123456789."),
)


def yaml_load(stream) -> Any:
    return yaml.load(stream, Loader=_YamlLoader)

# --------------------------------------------------------------------------- #
# Schema (mirrors reference arg_parser.py:13-156)
# --------------------------------------------------------------------------- #


@dataclass
class LoaderConfig:
    """Common parameters for train/val pipelines (reference arg_parser.py:13-26)."""

    image_size: int = 224
    batch_size: int = 256  # GLOBAL batch size (sharded over the data mesh axis)
    workers: int = 6  # host decode workers
    num_classes: int = 1000
    root_data_dir: str = "${env:IMAGENET_DIR}"
    use_tfrecords: bool = False
    # decode-free pre-decoded uint8 records (data/packed.py): host cost per
    # image drops to one memcpy, demonstrating the >=95% input-utilization
    # north star on decode-starved hosts. Requires <root>/{split}_packed
    # built by create_packed_records at this image_size.
    use_packed: bool = False
    # HBM-resident dataset cache (TPU addition, data/device_cache.py): fill
    # the split (or its per-chip dp shard on a pod) into device memory once
    # per stage, then feed every step with a shard-local gather + device
    # augment — zero steady-state host->device image traffic. Train samples
    # with per-shard permutations; val keeps EXACT masked coverage. Pairs
    # naturally with use_packed (cache stores final uint8 crops either way).
    device_cache: bool = False
    # device_cache fill granularity: host batches are buffered to ~this many
    # MB, then written into the preallocated HBM buffer (transient host RSS
    # ~= one chunk instead of 2-3x the process shard). 0 = single monolithic
    # transfer (fine at a few hundred MB).
    fill_chunk_mb: int = 256
    # TPU additions: explicit backend + host prefetch depth
    backend: str = "auto"  # auto | folder | tfrecord | packed | synthetic
    prefetch: int = 2
    # legacy flat-schema `classes_divisor` (e.g. exp22-26 "train on 100
    # classes instead"): labels are integer-divided by this, shrinking the
    # label space to ceil(num_classes / divisor) for fast experiments
    classes_divisor: int = 1


@dataclass
class TrainLoaderConfig(LoaderConfig):
    """Train-pipeline augmentations (reference arg_parser.py:29-52)."""

    min_area: float = 0.08
    blur_prob: float = 0.0
    gray_prob: float = 0.0
    color_twist_prob: float = 0.0
    contrast_range: Tuple[float, float] = (0.7, 1.3)
    brightness_range: Tuple[float, float] = (0.7, 1.3)
    random_interpolation: bool = False
    # base train resize filter: triangular | cubic (legacy flat-schema
    # `resize_method: cubic`, _old_configs exp80/exp81); random_interpolation
    # flips to the OTHER filter with p=0.5 per image
    interpolation: str = "triangular"
    re_prob: float = 0.0
    re_count: int = 3
    # device-resample split (TPU addition; the DALI-GPU-resize analog):
    # host = DCT-scaled decode only, triangular/cubic resample on the MXU
    # (ops/resample.py). Cuts host cost per image ~3x (PERF.md) at the price
    # of a 4x larger (but still uint8) host->device transfer.
    device_resample: bool = False


@dataclass
class ValLoaderConfig(LoaderConfig):
    """Validation pipeline (reference arg_parser.py:55-62).

    50_000 must be divisible by the global batch size, otherwise sharded
    accuracy differs from single-chip accuracy (reference arg_parser.py:59-61).
    """

    batch_size: int = 250
    full_crop: bool = False
    # aspect-bucketed rectangular validation (closes the reference TODO,
    # dali_dataloader.py:5): 3 static crop shapes + masked exact metrics
    rectangular: bool = False
    # reference semantics: val image_size follows the train stage size
    # (dali_dataloader.py:228). Set False to pin an explicit val size (legacy
    # flat-schema `val_sz`, e.g. BResNet50_encoder validates at 288).
    follow_train_size: bool = True


@dataclass
class DataStage:
    """One progressive-training stage (reference arg_parser.py:65-72)."""

    start: int = 0
    end: int = 90
    lr: Optional[Tuple[float, float]] = None
    lr_mode: str = "linear"  # linear | cos | poly
    extra_args: Optional[Dict[str, Any]] = None
    # optional epoch span of the lr phase when it extends beyond this stage
    # (legacy configs change image size mid-phase, e.g. resnet34_best.yaml:
    # one cos phase over [0,200] with data changes at 60/120/180). The phase
    # evaluates over lr_ep; the stage boundaries only control loader rebuilds.
    lr_ep: Optional[Tuple[int, int]] = None


@dataclass
class RunnerConfig:
    """Training-run options (reference arg_parser.py:75-99)."""

    stages: List[Any] = field(default_factory=lambda: [dict(start=0, end=90, lr=[0.1, 0])])
    resume: Optional[str] = None
    # find the newest checkpoint under log.dir for this exp_name and resume
    # from it (preemption-friendly; no reference analog — recovery there was
    # re-launching by hand with run.resume, SURVEY.md §5.3)
    auto_resume: bool = False
    load_start_epoch: bool = True
    start_epoch: int = 0
    accumulate_steps: int = 1
    ema_decay: float = 0.0
    bf16: bool = True  # bfloat16 activations/compute (reference fp16, arg_parser.py:90)
    # BatchNorm statistics view: 'global' (sync-BN, the TPU-idiomatic default),
    # 'local' (per-data-shard stats — the reference's DDP per-GPU BN,
    # train.py:114; removes every BN all-reduce from the pod step), or an int
    # group count (ghost BN). See models/norms.py module docstring.
    bn_stats: Any = "global"
    # Activation rematerialization (torch.utils.checkpoint over the loss
    # closure, as jax.checkpoint in the JAX package): false (keep all
    # residuals), 'full'/true (recompute everything in backward, ~1 extra
    # forward of FLOPs), or 'convs' (save conv/matmul outputs, recompute the
    # bandwidth-bound tail). No reference analog. See train/steps.remat_policy.
    remat: Any = False
    # Skip optimizer updates whose gradients contain NaN/Inf, up to N
    # consecutive skips before giving up (optax.apply_if_finite). 0 = off.
    # The bf16 analog of the reference's AMP grad-scaler step skip
    # (reference callbacks.py:308-309: "scaler.step will skip
    # optimizer.step if grads contain inf/nan"): one transient bad step
    # must not permanently NaN the params, while SUSTAINED divergence
    # still surfaces (after N consecutive skips the update goes through).
    skip_nonfinite: int = 0
    extra_callbacks: List[Any] = field(default_factory=list)
    evaluate: bool = False


@dataclass
class LoggerConfig:
    """Logging options (reference arg_parser.py:102-111)."""

    exp_name: str = "test_run"
    dir: str = "logs"
    print_model: bool = False
    histogram: bool = False
    save_optim: bool = False
    tensorboard: bool = True


@dataclass
class MeshConfig:
    """TPU device-mesh spec (no reference analog; replaces DDP/NCCL wiring,
    reference train.py:58-61,114)."""

    # axis sizes; -1 means "all remaining devices". Data parallelism is the
    # reference's only strategy (SURVEY.md §2.4); the model axis exists for
    # optimizer-state/head sharding experiments.
    data: int = -1
    model: int = 1
    # spatial partitioning (SP): shard the image H dimension of model compute
    # over this many devices — the CNN analog of sequence parallelism; conv
    # halo exchanges are inserted by XLA GSPMD (parallel/mesh.image_sharding).
    # Lets one sample's activations exceed a single chip's HBM (large-image
    # stages); no reference analog (DDP cannot split a sample across GPUs).
    spatial: int = 1
    # ZeRO-1: shard optimizer state (momenta/moments) over the data axis —
    # ~n_data-fold less optimizer memory per chip, identical numerics
    # (parallel/mesh.zero1_opt_sharding; beyond the reference's pure DDP)
    zero1: bool = False
    # head tensor parallelism (model > 1): params whose path matches one of
    # these substrings get their last (class) dim sharded over 'model' —
    # vocab-parallel logits/loss for huge metric-learning heads
    # (parallel/mesh.tp_sharding). None = ["fc", "head", "classifier"].
    tp_params: Optional[List[str]] = None


@dataclass
class StrictConfig:
    """Root schema (reference arg_parser.py:121-156)."""

    loader: TrainLoaderConfig = field(default_factory=TrainLoaderConfig)
    val_loader: ValLoaderConfig = field(default_factory=ValLoaderConfig)
    model: Dict[str, Any] = field(default_factory=lambda: dict(_target_="resnet18"))
    weight_standardization: bool = False
    # legacy flat-schema `sigmoid_trick` (exp66-81): initialize the classifier
    # bias to -log(C-1) so initial sigmoid probabilities are ~1/C (the
    # RetinaNet focal prior, arXiv:1708.02002 §4.1) — used with the
    # sigmoid/kld/focal criteria
    sigmoid_trick: bool = False
    filter_from_wd: Optional[List[str]] = None
    bn_momentum: float = 0.1
    init_gamma: Optional[float] = 1.72  # for swish (reference arg_parser.py:133)
    optim: Dict[str, Any] = field(default_factory=lambda: dict(_target_="sgd", lr=0, weight_decay=1e-4))
    criterion: Dict[str, Any] = field(default_factory=lambda: dict(_target_="cross_entropy"))
    run: RunnerConfig = field(default_factory=RunnerConfig)
    log: LoggerConfig = field(default_factory=LoggerConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    debug: bool = False
    # NaN checking for debugging (the JAX package's jax_debug_nans): the first
    # NaN of a forward, a backward or the new weights raises (utils/debug_nans.py)
    debug_nans: bool = False
    random_seed: Optional[int] = 42


_FREEFORM_KEYS = {"model", "optim", "criterion"}  # instantiation dicts — not schema-checked

# --------------------------------------------------------------------------- #
# Node type
# --------------------------------------------------------------------------- #


class ConfigNode(dict):
    """dict with attribute access; the in-memory config tree."""

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __deepcopy__(self, memo):
        return ConfigNode({k: copy.deepcopy(v, memo) for k, v in self.items()})


def _wrap(obj: Any) -> Any:
    if isinstance(obj, dict):
        return ConfigNode({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return [_wrap(v) for v in obj]
    return obj


def to_dict(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: to_dict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_dict(v) for v in obj]
    return obj


def to_yaml(cfg: Any) -> str:
    return yaml.safe_dump(to_dict(cfg), sort_keys=False, default_flow_style=None)


# --------------------------------------------------------------------------- #
# Merge / schema
# --------------------------------------------------------------------------- #


def _schema_defaults(cls) -> ConfigNode:
    out = ConfigNode()
    for f in dataclasses.fields(cls):
        if dataclasses.is_dataclass(f.type) if isinstance(f.type, type) else False:
            out[f.name] = _schema_defaults(f.type)
            continue
        if f.default is not dataclasses.MISSING:
            out[f.name] = _wrap(copy.deepcopy(f.default))
        elif f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
            v = f.default_factory()  # type: ignore[misc]
            out[f.name] = _schema_defaults(type(v)) if dataclasses.is_dataclass(v) else _wrap(v)
        else:
            out[f.name] = None
    return out


def _check_schema(cls, node: dict, path: str) -> None:
    known = {f.name for f in dataclasses.fields(cls)}
    sub = {f.name: f for f in dataclasses.fields(cls)}
    for k, v in node.items():
        if k not in known:
            raise KeyError(f"unknown config key {path}{k!r} (schema {cls.__name__})")
        f = sub[k]
        default = (
            f.default_factory() if f.default_factory is not dataclasses.MISSING else f.default  # type: ignore[misc]
        )
        if dataclasses.is_dataclass(default) and isinstance(v, dict) and k not in _FREEFORM_KEYS:
            _check_schema(type(default), v, f"{path}{k}.")


def merge(base: dict, overlay: dict) -> ConfigNode:
    """Deep merge: overlay wins; dicts merge recursively, lists replace."""
    out = ConfigNode({k: copy.deepcopy(v) for k, v in base.items()})
    for k, v in overlay.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = _wrap(copy.deepcopy(v))
    return out


# --------------------------------------------------------------------------- #
# Interpolation:  ${env:VAR}  ${now:%fmt}  ${a.b.c}
# --------------------------------------------------------------------------- #

_INTERP_RE = re.compile(r"\$\{([^{}]+)\}")


def _lookup(root: dict, dotted: str) -> Any:
    node: Any = root
    for part in dotted.split("."):
        if isinstance(node, dict) and part in node:
            node = node[part]
        else:
            raise KeyError(f"interpolation ${{{dotted}}} not found")
    return node


def _resolve_str(s: str, root: dict, now: datetime.datetime) -> Any:
    full = _INTERP_RE.fullmatch(s.strip())

    def one(expr: str) -> Any:
        if expr.startswith("env:"):
            name = expr[4:]
            if name not in os.environ:
                raise KeyError(f"environment variable {name!r} required by config is not set")
            return os.environ[name]
        if expr.startswith("now:"):
            return now.strftime(expr[4:])
        val = _lookup(root, expr)
        if isinstance(val, str) and _INTERP_RE.search(val):
            return _resolve_str(val, root, now)
        return val

    if full:  # whole-string interpolation preserves type
        return one(full.group(1))
    return _INTERP_RE.sub(lambda m: str(one(m.group(1))), s)


def resolve(cfg: ConfigNode, *, _root: Optional[dict] = None, strict_env: bool = True) -> ConfigNode:
    root = _root if _root is not None else cfg
    now = datetime.datetime.now()

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            return ConfigNode({k: walk(v) for k, v in node.items()})
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, str) and _INTERP_RE.search(node):
            try:
                return walk(_resolve_str(node, root, now))
            except KeyError:
                if strict_env:
                    raise
                return node
        return node

    return walk(cfg)


# --------------------------------------------------------------------------- #
# Loading / overrides
# --------------------------------------------------------------------------- #


def _load_yaml(path: str) -> dict:
    with open(path) as f:
        data = yaml_load(f) or {}
    if not isinstance(data, dict):
        raise ValueError(f"{path}: top level must be a mapping")
    return data


def _compose(path: str, seen: Optional[set] = None) -> dict:
    """Load a YAML file, recursively composing its ``defaults:`` list
    (each entry like ``/base``, ``base``, or hydra-style ``/base@_here_``)."""
    seen = seen or set()
    ap = os.path.abspath(path)
    if ap in seen:
        raise ValueError(f"circular defaults composition at {path}")
    seen.add(ap)
    data = _load_yaml(path)
    defaults = data.pop("defaults", [])
    base: dict = {}
    for entry in defaults:
        if isinstance(entry, dict):  # hydra group syntax — not supported, skip overrides-only entries
            continue
        name = str(entry).split("@")[0].strip().lstrip("/")
        if name in ("strict_config", "_self_"):
            continue
        fname = name + ("" if name.endswith((".yaml", ".yml")) else ".yaml")
        # search the file's directory, then ancestors (experiment files live
        # in configs/exp/, legacy ports two levels down in configs/old_exp/*/)
        d = os.path.dirname(ap)
        cand = os.path.join(d, fname)
        for _ in range(3):
            if os.path.exists(cand):
                break
            d = os.path.dirname(d)
            cand = os.path.join(d, fname)
        if not os.path.exists(cand):
            raise FileNotFoundError(f"defaults entry {entry!r} of {path}: no file {cand}")
        base = dict(merge(base, _compose(cand, seen)))
    return dict(merge(base, data))


def _parse_override_value(s: str) -> Any:
    try:
        return yaml_load(s)
    except yaml.YAMLError:
        return s


def apply_overrides(cfg: ConfigNode, overrides: List[str]) -> ConfigNode:
    """Dotted-key overrides: ``a.b=v`` sets (key must exist unless prefixed +)."""
    cfg = copy.deepcopy(cfg)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must be key=value")
        key, _, raw = ov.partition("=")
        additive = key.startswith("+")
        key = key.lstrip("+")
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], dict):
                if additive:
                    node[p] = ConfigNode()
                else:
                    raise KeyError(f"override {ov!r}: no such key {p!r} (use +{key}= to add)")
            node = node[p]
        leaf = parts[-1]
        if not additive and leaf not in node:
            raise KeyError(f"override {ov!r}: no such key {leaf!r} (use +{key}= to add)")
        node[leaf] = _wrap(_parse_override_value(raw))
    return cfg


def load(
    path: Optional[str] = None,
    overrides: Optional[List[str]] = None,
    *,
    strict_env: bool = True,
    validate: bool = True,
) -> ConfigNode:
    """Schema defaults ← composed YAML ← CLI overrides, then interpolate."""
    cfg = _schema_defaults(StrictConfig)
    if path is not None:
        user = _compose(path)
        if validate:
            _check_schema(StrictConfig, user, "")
        cfg = merge(cfg, user)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return resolve(cfg, strict_env=strict_env)


def parse_stages(stages: List[Any]) -> List[DataStage]:
    """Dict stages → DataStage (reference train.py:116-117)."""
    out = []
    for s in stages:
        d = dict(s) if isinstance(s, dict) else dataclasses.asdict(s)
        if d.get("lr") is not None:
            d["lr"] = tuple(float(x) for x in d["lr"])
        if d.get("lr_ep") is not None:
            d["lr_ep"] = tuple(int(x) for x in d["lr_ep"])
        out.append(DataStage(**d))
    end = 0
    for st in out:  # contiguity (reference dali_dataloader.py:206-211)
        if st.start != end:
            raise ValueError(f"data stages must be contiguous: stage starts at {st.start}, previous ended at {end}")
        if st.end <= st.start:
            raise ValueError(f"data stage end {st.end} <= start {st.start}")
        end = st.end
    return out


# --------------------------------------------------------------------------- #
# Instantiation
# --------------------------------------------------------------------------- #


def instantiate(node: Any, *args: Any, **extra_kwargs: Any) -> Any:
    """Build the object described by a ``_target_`` dict (hydra.utils.call
    equivalent, reference train.py:64,81,92,143). Nested ``_target_`` dicts are
    instantiated recursively unless marked ``_recursive_: false``."""
    if not isinstance(node, dict) or "_target_" not in node:
        raise ValueError(f"instantiate() needs a dict with _target_, got {type(node).__name__}")
    node = to_dict(node)
    target = node.pop("_target_")
    recursive = node.pop("_recursive_", True)
    if recursive:
        node = {k: _maybe_instantiate(v) for k, v in node.items()}
    node.update(extra_kwargs)
    fn = registry.resolve(target)
    return fn(*args, **node)


def _maybe_instantiate(v: Any) -> Any:
    if isinstance(v, dict) and "_target_" in v:
        return instantiate(v)
    if isinstance(v, list):
        return [_maybe_instantiate(x) for x in v]
    return v


if __name__ == "__main__":  # config round-trip check (reference arg_parser.py test_app)
    import sys

    _path = sys.argv[1] if len(sys.argv) > 1 else None
    print(to_yaml(load(_path, overrides=sys.argv[2:], strict_env=False)))
