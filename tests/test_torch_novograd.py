"""The port's Novograd against the JAX package's (optim/zoo.py:57-121), in
float64: four steps on a small tree named like a ResNet's (a conv kernel,
a norm's scale and bias, a 0-d parameter, ECA's kernel, a classifier) from
the same initial values and gradients, with the lr of a warmup; every
parameter within 1e-9 of its largest value after every step. The JAX
transform reads its lr as float32 and rounds lr * wd to float32, so the
lrs are powers of 2 and the large decay of the dead-zone case (0.25) is
exact in float32 too; the configs' small decays move the weights by less
than that rounding's 1e-9.

Cases: the JAX defaults (betas 0.95/0, no decay), config 8's (betas
0.9/0.99, wd 2e-3, ``init_zero`` accepted and unused), config 46's dead-zone
decay ``wd_eps`` 0.01 (the initial values are small, so some sit in the dead
zone), config 48's ``unitwise`` (a norm per output unit, the units from the
weights plan's ``unit_dims`` layout: OIHW and (out, in) dim 0, ECA's kernel
and the 1-d and 0-d ones whole), the wd mask ``filter_from_wd: []`` (no
decay on 1-d and 0-d parameters) and the apex alias.

The JAX transform takes the non-unitwise grad norm in float32 even for a
float64 gradient (``g.astype(float32)``) and the port does the same; the
gradients here are multiples of 2^-4 in [-2, 2], so that float32 sum of
their squares is exact in any order and the two packages' float32 norms
agree to the bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sota_imagenet_tpu.optim import zoo
from sota_imagenet_tpu.utils.misc import filter_from_weight_decay as jax_filter_wd
from sota_imagenet_tpu_torch.optim import build_optimizer
from sota_imagenet_tpu_torch.optim.factory import Novograd
from sota_imagenet_tpu_torch.utils.misc import filter_from_weight_decay

TOL = 1e-9
# port name -> (flax path, flax shape, HWIO/Dense -> port layout)
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
LRS = (2**-7, 2**-6, 2**-5, 2**-5)  # and the decays below: exact in float32, as the JAX transform takes lr * wd
CASES = {
    "jax_defaults": ({"_target_": "novograd"}, None),
    "config_8": ({"_target_": "novograd", "weight_decay": 0.002, "init_zero": True, "betas": [0.9, 0.99]}, None),
    "config_46_wd_eps": ({"_target_": "novograd", "weight_decay": 0.25, "betas": [0.9, 0.99], "wd_eps": 0.01}, None),
    "config_48_unitwise": ({"_target_": "novograd", "weight_decay": 0.0002, "betas": [0.9, 0.99], "unitwise": True},
                           None),
    "wd_mask": ({"_target_": "apex.optimizers.FusedNovoGrad", "weight_decay": 0.1, "betas": [0.8, 0.9]}, []),
}


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


@pytest.mark.parametrize("case", sorted(CASES))
def test_novograd_matches_jax_in_float64(case):
    cfg, wd_filter = CASES[case]
    rng = np.random.default_rng(0)
    init = {n: rng.standard_normal(shape) * 0.03 for n, (_, shape, _) in TREE.items()}
    grads = [{n: np.round(rng.uniform(-2, 2, shape) * 16) / 16 for n, (_, shape, _) in TREE.items()} for _ in LRS]
    with jax.enable_x64(True):
        params = _nested({k: jnp.asarray(v) for k, v in init.items()})
        mask = jax_filter_wd(params, wd_filter) if wd_filter is not None else None
        kw = {k: v for k, v in cfg.items() if k != "_target_"}
        tx = zoo.novograd(lambda count: jnp.asarray(LRS)[count], wd_mask=mask, **kw)
        opt_state = tx.init(params)
        want = []
        for g in grads:
            updates, opt_state = tx.update(_nested({k: jnp.asarray(v) for k, v in g.items()}), opt_state, params)
            params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
            want.append({n: np.asarray(_leaf(params, TREE[n][0])) for n in TREE})
    named = [(n, torch.nn.Parameter(_port(n, v))) for n, v in init.items()]
    tmask = filter_from_weight_decay(named, wd_filter) if wd_filter is not None else None
    opt = build_optimizer(cfg, named, wd_mask=tmask, unit_dim=UNIT_DIMS)
    assert isinstance(opt, Novograd)
    for step, (lr, g) in enumerate(zip(LRS, grads)):
        for n, p in named:
            p.grad = _port(n, g[n])
        for group in opt.param_groups:
            group["lr"] = float(np.float32(lr))  # the JAX transform reads its lr as float32 (zoo.py:29-32)
        opt.step()
        for n, p in named:
            w = _port(n, want[step][n]).numpy()
            np.testing.assert_allclose(p.detach().numpy(), w, rtol=0, atol=TOL * np.abs(w).max(),
                                       err_msg=f"{case}: {n} after step {step}")
    moved = {n: float(np.abs(p.detach().numpy() - _port(n, init[n]).numpy()).max()) for n, p in named}
    assert all(v > 0 for v in moved.values()), moved
    if wd_filter is not None:
        assert [len(g["params"]) for g in opt.param_groups] == [3, 4]  # kernels decayed; 1-d and 0-d not


def test_novograd_state_starts_at_ema_norm_init():
    p = torch.nn.Parameter(torch.ones(3, dtype=torch.float64))
    opt = build_optimizer({"_target_": "MyNovograd", "betas": [0.9, 0.5]}, [("w", p)])
    p.grad = torch.full((3,), 2.0, dtype=torch.float64)
    opt.param_groups[0]["lr"] = 0.1
    opt.step()
    st = opt.state[p]
    assert st["ema_norm"].dtype == torch.float32
    torch.testing.assert_close(st["ema_norm"], torch.tensor(0.5 * 1e-3 + 0.5 * 12.0))
    m = 0.1 * 2.0 / (float(st["ema_norm"]) ** 0.5 + 1e-8)
    torch.testing.assert_close(p.detach(), torch.full((3,), 1.0 - 0.1 * m, dtype=torch.float64))
