"""The port's AdamW (and its ``badam`` alias) against optax, in float64.

Three steps on a small tree named like an NFNet's (a conv kernel, its gain
and bias, a scalar skipinit_gain, a classifier) with ``filter_from_wd:
[gain]``, from the same initial values and the same gradients (drawn from a
numpy seed), lr following a warmup: parameters within 1e-9. The mask is held
to the JAX package's on the flax names: gains and the other 1-d leaves are
not decayed, the rest is."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sota_imagenet_tpu.optim import build_optimizer as jax_build_optimizer
from sota_imagenet_tpu.utils.misc import filter_from_weight_decay as jax_filter_wd
from sota_imagenet_tpu_torch.optim import build_optimizer
from sota_imagenet_tpu_torch.utils.misc import filter_from_weight_decay

# port name -> (flax path, shape)
TREE = {
    "stage0_block0.conv1.weight": (("stage0_block0", "conv1", "kernel"), (3, 3, 4, 8)),
    "stage0_block0.conv1.gain": (("stage0_block0", "conv1", "gain"), (8,)),
    "stage0_block0.conv1.bias": (("stage0_block0", "conv1", "bias"), (8,)),
    "stage0_block0.skipinit_gain": (("stage0_block0", "skipinit_gain"), ()),
    "stage0_block0.attn.weight": (("stage0_block0", "ECA_0", "kernel"), (3, 1, 1)),
    "fc.weight": (("fc", "kernel"), (8, 5)),
    "fc.bias": (("fc", "bias"), (5,)),
}
LRS = (0.0, 0.005, 0.01)
OPTIMS = {
    "adamw": {"_target_": "adamw", "weight_decay": 1e-3, "eps": 1e-6},
    "badam": {"_target_": "badam", "weight_decay": 2e-2, "betas": [0.8, 0.95]},
    "adamw_no_decay": {"_target_": "torch.optim.AdamW"},
}


def _nested(values):
    tree = {}
    for name, (path, _) in TREE.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = values[name]
    return tree


def _values(seed):
    rng = np.random.default_rng(seed)
    return {name: rng.standard_normal(shape) for name, (_, shape) in TREE.items()}


def test_weight_decay_mask_matches_jax_on_the_nfnet_names():
    init = _values(0)
    jmask = jax_filter_wd(_nested({k: jnp.asarray(v) for k, v in init.items()}), ["gain"])
    mask = filter_from_weight_decay([(k, torch.from_numpy(np.asarray(v))) for k, v in init.items()], ["gain"])
    want = _nested({k: mask[k] for k in TREE})
    assert jax.tree_util.tree_map(bool, jmask) == want
    # gain and skipinit_gain (and the other 1-d leaves) take no decay, the kernels do
    assert mask == {
        "stage0_block0.conv1.weight": True, "stage0_block0.conv1.gain": False, "stage0_block0.conv1.bias": False,
        "stage0_block0.skipinit_gain": False, "stage0_block0.attn.weight": True, "fc.weight": True, "fc.bias": False,
    }
    # the name rule alone, on a leaf the ndim rule would decay
    two_d = [("head.gain_matrix", torch.zeros(2, 2)), ("head.weight", torch.zeros(2, 2))]
    assert filter_from_weight_decay(two_d, ["gain"]) == {"head.gain_matrix": False, "head.weight": True}
    assert not jax_filter_wd({"head": {"gain_matrix": jnp.zeros((2, 2))}}, ["gain"])["head"]["gain_matrix"]


@pytest.mark.parametrize("name", sorted(OPTIMS))
def test_three_steps_match_optax_in_float64(name):
    cfg = OPTIMS[name]
    init, grads = _values(0), [_values(s) for s in (1, 2, 3)]
    with jax.enable_x64(True):
        params = _nested({k: jnp.asarray(v, jnp.float64) for k, v in init.items()})
        tx = jax_build_optimizer(dict(cfg), lambda count: jnp.asarray(LRS)[count], wd_mask=jax_filter_wd(params, ["gain"]))
        opt_state = tx.init(params)
        for g in grads:
            updates, opt_state = tx.update(_nested({k: jnp.asarray(v, jnp.float64) for k, v in g.items()}), opt_state, params)
            params = optax.apply_updates(params, updates)
        want = jax.tree_util.tree_map(np.asarray, params)
    tparams = [(k, torch.nn.Parameter(torch.from_numpy(v.copy()))) for k, v in init.items()]
    opt = build_optimizer(dict(cfg), tparams, wd_mask=filter_from_weight_decay(tparams, ["gain"]))
    assert isinstance(opt, torch.optim.AdamW)
    assert len(opt.param_groups) == 2 and opt.param_groups[1]["weight_decay"] == 0.0
    for lr, g in zip(LRS, grads):
        for k, p in tparams:
            p.grad = torch.from_numpy(np.asarray(g[k]).copy())
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
    want_flat = {k: _leaf(want, path) for k, (path, _) in TREE.items()}
    for k, p in tparams:
        np.testing.assert_allclose(p.detach().numpy(), want_flat[k], rtol=1e-9, atol=1e-9, err_msg=k)
        assert np.abs(p.detach().numpy() - init[k]).max() > 1e-3  # the steps moved it


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def test_unported_optimizers_name_the_roadmap():
    """Every optimizer of the JAX package is ported now (optim/zoo.py): the names this test once held
    to the ROADMAP build, and a name the JAX factory does not know raises KeyError, as there."""
    for cfg, cls in (({"_target_": "adamp"}, "AdamP"), ({"_target_": "madgrad"}, "MADGRAD"),
                     ({"_target_": "adais"}, "AdaiS"), ({"_target_": "adamw", "lookahead": True}, "Lookahead")):
        assert type(build_optimizer(cfg, [("w", torch.nn.Parameter(torch.zeros(2, 2)))])).__name__ == cls
    with pytest.raises(KeyError, match="unknown optimizer"):
        build_optimizer({"_target_": "no_such_optimizer"}, [("w", torch.nn.Parameter(torch.zeros(2, 2)))])


LAMB_OPTIMS = {
    "lamb": {"_target_": "lamb", "weight_decay": 5e-3, "eps": 1e-6},
    "badam_lamb": {"_target_": "badam", "lamb": True, "weight_decay": 5e-3, "eps": 1e-6, "betas": [0.8, 0.95]},
    "badam_lamb_mode": {"_target_": "badam.BAdam", "lamb_mode": True, "weight_decay": 1e-2},
}
LAMB_LRS = (0.0, 0.005, 0.01, 0.003, 0.001)
ZERO_INIT = ("stage0_block0.conv1.bias", "fc.bias")  # a parameter norm of 0: trust ratio 1
NO_GRAD = "stage0_block0.skipinit_gain"  # zero gradients and no decay: update norm 0, trust ratio 1


@pytest.mark.parametrize("name", sorted(LAMB_OPTIMS))
def test_lamb_matches_optax_in_float64(name):
    """Five steps of LAMB (optax's chain: scale_by_adam -> masked
    add_decayed_weights -> scale_by_trust_ratio -> -lr) with the gain mask,
    two zero-initialised parameters and one whose gradient is always zero:
    parameters within 1e-9."""
    cfg = LAMB_OPTIMS[name]
    init = _values(0)
    for k in ZERO_INIT:
        init[k] = np.zeros_like(init[k])
    grads = [_values(s) for s in range(1, len(LAMB_LRS) + 1)]
    for g in grads:
        g[NO_GRAD] = np.zeros_like(g[NO_GRAD])
    with jax.enable_x64(True):
        params = _nested({k: jnp.asarray(v, jnp.float64) for k, v in init.items()})
        tx = jax_build_optimizer(dict(cfg), lambda count: jnp.asarray(LAMB_LRS)[count], wd_mask=jax_filter_wd(params, ["gain"]))
        opt_state = tx.init(params)
        for g in grads:
            updates, opt_state = tx.update(_nested({k: jnp.asarray(v, jnp.float64) for k, v in g.items()}), opt_state, params)
            params = optax.apply_updates(params, updates)
        want = jax.tree_util.tree_map(np.asarray, params)
    tparams = [(k, torch.nn.Parameter(torch.from_numpy(v.copy()))) for k, v in init.items()]
    opt = build_optimizer(dict(cfg), tparams, wd_mask=filter_from_weight_decay(tparams, ["gain"]))
    assert type(opt).__name__ == "Lamb" and [g["weight_decay"] for g in opt.param_groups] == [cfg["weight_decay"], 0.0]
    for lr, g in zip(LAMB_LRS, grads):
        for k, p in tparams:
            p.grad = torch.from_numpy(np.asarray(g[k]).copy())
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
    for k, p in tparams:
        np.testing.assert_allclose(p.detach().numpy(), _leaf(want, TREE[k][0]), rtol=1e-9, atol=1e-9, err_msg=k)
        moved = np.abs(p.detach().numpy() - init[k]).max()
        assert (moved == 0.0) if k == NO_GRAD else (moved > 1e-4), k
    assert all(s["step"] == len(LAMB_LRS) for s in opt.state.values())
