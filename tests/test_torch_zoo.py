"""The port's optimizer zoo (``optim/zoo.py``) against the JAX package's
transforms (optim/zoo.py:126-585, the Lookahead wrapper factory.py:159-197),
in float64: four steps on a small tree named like a ResNet's (a conv
kernel, a norm's scale and bias, a 0-d parameter, ECA's kernel, a
classifier; the tree of test_torch_novograd.py) from the same initial
values and gradients, with the lrs of a warmup; every parameter within
1e-9 of its largest value after every step. Both sides build through
their factories, so the configs' arguments, the aliases, the wd mask and
``lookahead`` go the same way.

The JAX transforms read the lr as float32 and round lr * wd to float32;
the port mirrors that, and the lrs here are powers of 2. AdamLayerwise,
Adai, AdaiS and MADGRAD take float32 sums of squared gradients: the
gradients are multiples of 2^-4 in [-2, 2], so those sums are exact in any
order. AdamP's and SGDP's cases give the conv kernel gradients orthogonal
to its rows, so the projection fires there and not on the others; the
set each step projects is held against a numpy oracle of the JAX rule on
the flax layout, and on full-width ResNet-50 and the 24.nf_conv-act trunk
the port's projected set and one step's weights are held against the JAX
transform on the flax tree of the same weights.

A checkpoint after step 2, loaded into a fresh optimizer that then runs
steps 3 and 4, ends where the unbroken run ends, bit for bit, and every
state tensor keeps its dtype (the float32 second moments of a float64
parameter included)."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sota_imagenet_tpu.optim import factory as jax_factory
from sota_imagenet_tpu.utils.misc import filter_from_weight_decay as jax_filter_wd
from sota_imagenet_tpu_torch.optim import build_optimizer, zoo
from sota_imagenet_tpu_torch.utils.misc import filter_from_weight_decay

TOL = 1e-9
# port name -> (flax path, flax shape, flax -> port layout)
TREE = {
    "layer1.0.conv1.weight": (("layer1_0", "Conv_0", "Conv_0", "kernel"), (3, 3, 4, 8), (3, 2, 0, 1)),
    "layer1.0.bn1.weight": (("layer1_0", "_NormAct_0", "BatchNorm_0", "BatchNorm_0", "scale"), (8,), None),
    "layer1.0.bn1.bias": (("layer1_0", "_NormAct_0", "BatchNorm_0", "BatchNorm_0", "bias"), (8,), None),
    "layer1.0.gain": (("layer1_0", "gain"), (), None),
    "layer1.0.attn.weight": (("layer1_0", "ECA_0", "kernel"), (3, 1, 1), (2, 1, 0)),
    "fc.weight": (("fc", "kernel"), (8, 5), (1, 0)),
    "fc.bias": (("fc", "bias"), (5,), None),
}
UNIT_DIMS = {name: (0 if perm is not None else -1) for name, (_, _, perm) in TREE.items()}
FLAX_RANKS = {name: len(shape) for name, (_, shape, _) in TREE.items()}
LRS = (2**-7, 2**-6, 2**-5, 2**-5)
ORTHOGONAL = ("layer1.0.conv1.weight",)  # AdamP's and SGDP's cases: these gradients are orthogonal to the rows
# case -> (config node, filter_from_wd or None, gradients orthogonal where the projection should fire)
CASES = {
    "adamp_config_51": ({"_target_": "adamp", "weight_decay": 1e-2}, None, True),
    "adamp_config_12": ({"_target_": "adamp", "weight_decay": 1e-3, "eps": 1e-8}, None, True),
    "adamp_config_13": ({"_target_": "AdamP", "weight_decay": 3e-4, "eps": 1e-3}, None, True),
    "adamp_config_52": ({"_target_": "adamp.AdamP", "weight_decay": 1e-3, "eps": 1e-5}, None, True),
    "adamp_nesterov_wd_mask": ({"_target_": "adamp", "weight_decay": 0.25, "nesterov": True}, [], True),
    "adamp_random_grads": ({"_target_": "adamp", "weight_decay": 0.25}, None, False),
    "sgdp": ({"_target_": "SGDP", "weight_decay": 0.25}, None, True),
    "sgdp_nesterov_wd_mask": ({"_target_": "sgdp", "weight_decay": 0.25, "nesterov": True, "momentum": 0.5}, [],
                              True),
    "adai_config_55": ({"_target_": "adai", "betas": [0.1, 0.99], "weight_decay": 3e-5, "sgd_mom": True,
                        "stable_wd": True}, None, False),
    "adai_defaults": ({"_target_": "src.optimizers.MyAdai"}, None, False),
    "adai_per_weight_sqrt_mom_wd_mask": ({"_target_": "MyAdai", "per_layer": False, "sqrt_mom": True,
                                          "weight_decay": 0.25}, [], False),
    "adais_config_50": ({"_target_": "adais", "betas": [0.1, 0.99], "weight_decay": 1e-3}, None, False),
    "adais_exact_sum_wd_mask": ({"_target_": "src.optimizers.AdaiS", "betas": [0.1, 0.0], "weight_decay": 0.25}, [],
                                False),
    "madgrad_config_54": ({"_target_": "madgrad"}, None, False),
    "madgrad_wd_mask": ({"_target_": "src.optimizers.MADGRAD", "weight_decay": 0.125, "momentum": 0.5}, [], False),
    "adam_layerwise_config_49": ({"_target_": "adam_layerwise", "weight_decay": 2e-2, "betas": [0.9, 0.995]}, None,
                                 False),
    "adam_layerwise_adapt_stable_wd_mask": ({"_target_": "AdamLayerwise", "weight_decay": 0.25, "weight_adapt": True,
                                             "stable_wd": True}, [], False),
    "rmsprop_momentum": ({"_target_": "rmsprop", "momentum": 0.9}, None, False),
    "rmsprop_centered_wd": ({"_target_": "torch.optim.RMSprop", "centered": True, "weight_decay": 0.25}, None, False),
    "rmsprop_plain_wd_mask": ({"_target_": "RMSprop", "weight_decay": 0.25}, [], False),
    "lookahead_sgd_k2": ({"_target_": "sgd", "momentum": 0.9, "lookahead": True, "lookahead_k": 2}, None, False),
    "lookahead_adamp": ({"_target_": "adamp", "weight_decay": 1e-2, "lookahead": True, "lookahead_k": 3,
                         "lookahead_alpha": 0.25}, None, True),
}
# AdaiS takes one float32 sum of v / bc2 over every weight of every leaf (zoo.py:307-309), in an order that
# XLA chooses and differs from torch's; with b2 = 0.99 no gradient makes those sums exact, and the float32
# rounding of that one mean moves the weights by up to 3e-7 of their largest (b2 = 0 makes them exact: its
# case holds 1e-9)
CASE_TOL = {"adais_config_50": 1e-6}
# state entries the JAX transforms keep in float32 whatever the parameter's dtype
FLOAT32_STATE = {"Adai": {"exp_avg_sq"}, "AdaiS": {"exp_avg_sq"}, "AdamLayerwise": {"exp_avg_sq"}}


def _nested(values):
    tree = {}
    for name, (path, _, _) in TREE.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = values[name]
    return tree


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _port(name, a: np.ndarray) -> torch.Tensor:
    perm = TREE[name][2]
    return torch.from_numpy(np.array(a.transpose(perm) if perm is not None else a))


def _rows(a: np.ndarray) -> np.ndarray:
    """A flax leaf as the JAX projection views it: (out, fan_in)."""
    return a.reshape(-1, a.shape[-1]).T


def _orthogonal_to_rows(g: np.ndarray, p: np.ndarray) -> np.ndarray:
    """``g`` with each output unit's component along ``p``'s removed (flax layout)."""
    gv, pv = _rows(g), _rows(p)
    gv = gv - pv * (gv * pv).sum(1, keepdims=True) / (pv * pv).sum(1, keepdims=True)
    return gv.T.reshape(g.shape)


def _fires(p: np.ndarray, g: np.ndarray, delta: float = 0.1) -> bool:
    """The JAX rule (zoo.py:548-551, 567-570) on a flax leaf: max |cos(g row, p row)| < delta / sqrt(fan_in)."""
    pv, gv = _rows(p), _rows(g)
    cos = np.abs(((gv / (np.linalg.norm(gv, axis=1, keepdims=True) + 1e-8))
                  * (pv / (np.linalg.norm(pv, axis=1, keepdims=True) + 1e-8))).sum(1))
    return bool(cos.max() < delta / np.sqrt(pv.shape[1]))


def _data():
    rng = np.random.default_rng(0)
    init = {n: rng.standard_normal(shape) * 0.03 for n, (_, shape, _) in TREE.items()}
    grads = [{n: np.round(rng.uniform(-2, 2, shape) * 16) / 16 for n, (_, shape, _) in TREE.items()} for _ in LRS]
    return init, grads


def _jax_run(cfg, wd_filter, init, grads, orthogonal):
    """The JAX transform's weights after each step, and (AdamP, SGDP) the leaves each step projects."""
    with jax.enable_x64(True):
        params = _nested({k: jnp.asarray(v) for k, v in init.items()})
        mask = jax_filter_wd(params, wd_filter) if wd_filter is not None else None
        tx = jax_factory.build_optimizer(dict(cfg), lambda count: jnp.asarray(LRS)[count % len(LRS)], wd_mask=mask)
        opt_state = tx.init(params)
        want, fired = [], []
        for g in grads:
            now = {n: np.asarray(_leaf(params, TREE[n][0])) for n in TREE}
            if orthogonal:
                g = {n: _orthogonal_to_rows(v, now[n]) if n in ORTHOGONAL else v for n, v in g.items()}
            fired.append({n for n in TREE if FLAX_RANKS[n] > 1 and _fires(now[n], g[n])})
            updates, opt_state = tx.update(_nested({k: jnp.asarray(v) for k, v in g.items()}), opt_state, params)
            params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
            want.append(({n: np.asarray(_leaf(params, TREE[n][0])) for n in TREE}, g))
    return want, fired


def _port_optimizer(cfg, named, wd_filter):
    tmask = filter_from_weight_decay(named, wd_filter) if wd_filter is not None else None
    return build_optimizer(cfg, named, wd_mask=tmask, unit_dim=UNIT_DIMS, flax_rank=FLAX_RANKS)


def _step(opt, named, g, lr):
    for n, p in named:
        p.grad = _port(n, g[n])
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()


def _projected(opt, named):
    inner = getattr(opt, "inner", opt)
    if not hasattr(inner, "projected"):
        return None
    names = {id(p): n for n, p in named}
    return {names[id(p)] for p, f in zip(inner.matrix_params, inner.projected.tolist()) if f}


@pytest.mark.parametrize("case", sorted(CASES))
def test_zoo_matches_jax_in_float64(case):
    cfg, wd_filter, orthogonal = CASES[case]
    init, grads = _data()
    want, fired = _jax_run(cfg, wd_filter, init, grads, orthogonal)
    named = [(n, torch.nn.Parameter(_port(n, v))) for n, v in init.items()]
    opt = _port_optimizer(cfg, named, wd_filter)
    for step, (lr, (w_step, g)) in enumerate(zip(LRS, want)):
        _step(opt, named, g, lr)
        for n, p in named:
            w = _port(n, w_step[n]).numpy()
            np.testing.assert_allclose(p.detach().numpy(), w, rtol=0, atol=CASE_TOL.get(case, TOL) * np.abs(w).max(),
                                       err_msg=f"{case}: {n} after step {step}")
        projected = _projected(opt, named)
        if projected is not None:
            assert projected == fired[step], (case, step)
    moved = {n: float(np.abs(p.detach().numpy() - _port(n, init[n]).numpy()).max()) for n, p in named}
    assert all(v > 0 for v in moved.values()), moved
    if orthogonal:
        # the orthogonal gradients fire every step; the classifier's random ones never do
        assert all(set(ORTHOGONAL) <= f and "fc.weight" not in f for f in fired), fired
    if wd_filter is not None:
        groups = getattr(opt, "inner", opt).param_groups
        assert [len(g["params"]) for g in groups] == [3, 4]  # kernels decayed; 1-d and 0-d not


@pytest.mark.parametrize("case", ["adamp_config_51", "sgdp", "adai_config_55", "adais_config_50",
                                  "madgrad_config_54", "adam_layerwise_config_49", "rmsprop_momentum",
                                  "lookahead_sgd_k2", "lookahead_adamp"])
def test_zoo_checkpoint_round_trip_keeps_dtypes_and_continues(case):
    cfg, wd_filter, orthogonal = CASES[case]
    init, grads = _data()
    want, _ = _jax_run(cfg, wd_filter, init, grads, orthogonal)  # the gradients each step sees
    runs = []
    for broken in (False, True):
        named = [(n, torch.nn.Parameter(_port(n, v))) for n, v in init.items()]
        opt = _port_optimizer(cfg, named, wd_filter)
        for step, (lr, (_, g)) in enumerate(zip(LRS, want)):
            if broken and step == 2:
                buf = io.BytesIO()
                torch.save({"model": {n: p.detach().clone() for n, p in named}, "optim": opt.state_dict()}, buf)
                buf.seek(0)
                disk = torch.load(buf, weights_only=True)
                named = [(n, torch.nn.Parameter(disk["model"][n])) for n, _ in named]
                opt = _port_optimizer(cfg, named, wd_filter)
                opt.load_state_dict(disk["optim"])
                inner = getattr(opt, "inner", opt)
                for p in (p for g_ in inner.param_groups for p in g_["params"]):
                    for k, v in inner.state[p].items():
                        if isinstance(v, torch.Tensor):
                            f32 = k in FLOAT32_STATE.get(type(inner).__name__, ())
                            assert v.dtype == (torch.float32 if f32 else torch.float64), (case, k, v.dtype)
            _step(opt, named, g, lr)
        runs.append({n: p.detach().clone() for n, p in named})
    for n in runs[0]:
        assert torch.equal(runs[0][n], runs[1][n]), (case, n)


def _unflatten(leaves):
    """'/'-joined flax paths -> the nested params tree."""
    tree = {}
    for path, v in leaves.items():
        node = tree
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return tree


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, p))
        else:
            out[p] = v
    return out


@pytest.mark.parametrize("model_name", ["resnet50", "24.nf_conv-act"])
@pytest.mark.parametrize("opt_name", ["adamp", "sgdp"])
def test_projected_set_matches_jax_on_full_models(model_name, opt_name):
    """One float64 step of AdamP / SGDP on the full-width model's weights:
    every other matrix's gradient is orthogonal to its rows (projected), the
    others random (not); the port's projected set is the JAX rule's on the
    flax leaves, and the weights after the step are the JAX transform's."""
    from sota_imagenet_tpu_torch import cli
    from sota_imagenet_tpu_torch import config as TC
    from sota_imagenet_tpu_torch.models import resnet50
    from sota_imagenet_tpu_torch.utils.weights import _plan, flax_params, flax_ranks, unit_dims

    torch.manual_seed(0)
    if model_name == "resnet50":
        model = resnet50()
    else:
        model = cli.build_model(TC.load("configs/exp/24.nf_conv-act.yaml", strict_env=False))
    model = model.double()
    plan = _plan(model)
    path_of = {n: plan[n][1] for n, _ in model.named_parameters()}
    leaves = {k: v.detach().numpy() for k, v in flax_params(model).items()}
    rng = np.random.default_rng(1)
    grads, want_fired = {}, set()
    matrices = [k for k, v in leaves.items() if v.ndim > 1]
    for i, (k, v) in enumerate(leaves.items()):
        g = rng.standard_normal(v.shape)
        if v.ndim > 1 and i % 2 == 0:
            g = _orthogonal_to_rows(g, v)
        grads[k] = g
        if v.ndim > 1 and _fires(v, g):
            want_fired.add(k)
    assert 0 < len(want_fired) < len(matrices)
    cfg = {"_target_": opt_name, "weight_decay": 1e-2}
    with jax.enable_x64(True):
        jtree = jax.tree_util.tree_map(jnp.asarray, _unflatten(leaves))
        gtree = jax.tree_util.tree_map(jnp.asarray, _unflatten(grads))
        tx = jax_factory.build_optimizer(dict(cfg), lambda count: jnp.asarray(2.0**-5, jnp.float32))
        updates, _ = jax.jit(tx.update)(gtree, tx.init(jtree), jtree)  # one compile, not one per op and shape
        after = {k: np.asarray(v) for k, v in _flatten(jax.tree_util.tree_map(lambda p, u: p + u, jtree, updates)).items()}
    named = list(model.named_parameters())
    opt = build_optimizer(cfg, named, unit_dim=unit_dims(model), flax_rank=flax_ranks(model))
    for n, p in named:
        # the flax-layout gradient back to the port's layout, through the inverse of the plan's converter
        p.grad = plan[n][2](grads[path_of[n]])
    for g in opt.param_groups:
        g["lr"] = 2.0**-5
    opt.step()
    names = {id(p): path_of[n] for n, p in named}
    got = {names[id(p)] for p, f in zip(opt.matrix_params, opt.projected.tolist()) if f}
    assert got == want_fired
    for path, v in flax_params(model).items():
        w = after[path]
        np.testing.assert_allclose(v.detach().numpy(), w, rtol=0, atol=TOL * max(np.abs(w).max(), 1e-3), err_msg=path)


def test_unknown_optimizer_raises_key_error():
    with pytest.raises(KeyError, match="unknown optimizer"):
        build_optimizer({"_target_": "no_such_optimizer"}, [])


def test_madgrad_and_lookahead_copy_the_weights_when_built():
    """MADGRAD's x0 and Lookahead's slow copy are the weights as the optimizer
    is built (the JAX ``tx.init``), not as they are at the first step."""
    p = torch.nn.Parameter(torch.ones(3, dtype=torch.float64))
    mad = build_optimizer({"_target_": "madgrad"}, [("w", p)])
    la = build_optimizer({"_target_": "sgd", "lookahead": True}, [("w", p)])
    with torch.no_grad():
        p.mul_(2.0)
    assert torch.equal(mad.state[p]["x0"], torch.ones(3, dtype=torch.float64))
    assert torch.equal(la.state[p]["slow"], torch.ones(3, dtype=torch.float64))
    assert isinstance(la, zoo.Lookahead) and la.param_groups is la.inner.param_groups
