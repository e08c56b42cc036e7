"""AdaCos's loss state through the port's train step, against the JAX
package's ``build_train_step`` (``TrainState.loss_state``, steps.py:276-316),
on ``configs/exp/adacos_sphere.yaml``'s CModel cut to widths 8 and 16
(ConvActBlock 3 -> 8, then a repeat of two 8 -> 16, each stride 2: the
second copy receives 16 channels) before its pool and SphereLinearLayer, with the
recipe's AdaCos (margin 0, max_s 20) and SGD (momentum 0.9, wd 3e-5):

  * three float32 steps from the same weights and one-hot batches, with
    ``accumulate_steps`` 1 and 2 (the state advanced once per microbatch,
    chained), and with SAM (asam, rho 0.05, accumulation 2) where
    ``bn_from_perturbed`` is true (the second pass advances the state
    again) and false (the second pass starts from the step's state and the
    step keeps the clean pass's): each step's loss, grad_norm and the three
    state scalars, and the weights after the last step;
  * a checkpoint round trip: a run resumed from the checkpoint of its second
    step takes the same third step as the uninterrupted run, state included,
    bit for bit; a checkpoint without the state loads with ``init_state()``;
  * the eval steps (plain and masked) read the state, leave it as it is,
    and score as the JAX eval step does with the same state.

SiLU stands in for the recipe's swish_hard (hard-swish's kinks at -3 and 3:
tests/test_torch_nf_train_step.py). The step is float32 in both packages
(the JAX ScaledStdConv standardises in float32 and the head's cosines are
float32 whatever the weights): loss and the state rtol 1e-5, grad_norm rtol
1e-4, the weights within relative L2 1e-4 of the JAX step's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sota_imagenet_tpu.losses import AdaCos as JAdaCos
from sota_imagenet_tpu.models.cmodel import CModel as JCModel
from sota_imagenet_tpu.optim import build_optimizer as jax_build_optimizer
from sota_imagenet_tpu.train import steps as jsteps
from sota_imagenet_tpu_torch.losses import AdaCos
from sota_imagenet_tpu_torch.models.cmodel import CModel
from sota_imagenet_tpu_torch.optim import build_optimizer
from sota_imagenet_tpu_torch.train import steps
from sota_imagenet_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from sota_imagenet_tpu_torch.utils.weights import flax_to_torch_model

N_STEPS, BATCH, SIZE, CLASSES = 3, 8, 16, 10
LAYERS = yaml.safe_load("""
- [-1, 1, ConvActBlock, [3, 8], {stride: 2}]
- [-1, 2, ConvActBlock, [8, 16], {stride: 2}]
- [-1, 1, "pt.modules.FastGlobalAvgPool2d", [], {flatten: True}]
- [-1, 1, SphereLinearLayer, [16, 10]]
""")
EXTRA = {"ConvActBlock": {"activation": "silu"}}
OPTIM = {"_target_": "sgd", "momentum": 0.9, "weight_decay": 3e-5}
ADACOS = {"margin": 0.0, "max_s": 20}
LR = 0.5
TOL = {"loss": 1e-5, "grad_norm": 1e-4, "state": 1e-5, "weights": 1e-4}
CASES = {
    "plain": {},
    "accumulate_2": {"accumulate_steps": 2},
    "sam_bn_from_perturbed": {"accumulate_steps": 2, "sam": {"kind": "asam", "rho": 0.05, "bn_from_perturbed": True}},
    "sam_bn_from_clean": {"accumulate_steps": 2, "sam": {"kind": "asam", "rho": 0.05, "bn_from_perturbed": False}},
}


def _batches():
    rng = np.random.default_rng(0)
    images = rng.standard_normal((N_STEPS, BATCH, SIZE, SIZE, 3)).astype(np.float32)
    labels = np.eye(CLASSES, dtype=np.float32)[rng.integers(0, CLASSES, (N_STEPS, BATCH))]
    return images, labels


@pytest.fixture(scope="module")
def jax_init():
    jmodel = JCModel(layer_config=LAYERS, extra_kwargs=EXTRA)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, SIZE, SIZE, 3)), train=False)
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def _jax_run(params0, opts):
    jmodel = JCModel(layer_config=LAYERS, extra_kwargs=EXTRA)
    sched = lambda s: jnp.asarray(LR, jnp.float32)
    tx = jax_build_optimizer(OPTIM, sched)
    crit = JAdaCos(**ADACOS)
    state = jsteps.TrainState(step=jnp.zeros((), jnp.int32), params=params0, batch_stats={},
                              opt_state=tx.init(params0), loss_state=crit.init_state())
    step = jax.jit(jsteps.build_train_step(jmodel, crit, tx, sched, input_dtype=jnp.float32, **opts))
    images, labels = _batches()
    per_step = []
    for i in range(N_STEPS):
        state, m = step(state, {"image": jnp.asarray(images[i]), "label": jnp.asarray(labels[i])},
                        jax.random.PRNGKey(1))
        per_step.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                         **{k: float(v) for k, v in state.loss_state.items()}})
    return jmodel, crit, state, per_step


def _port_state(params0):
    model = CModel(layer_config=LAYERS, extra_kwargs=EXTRA)
    crit = AdaCos(**ADACOS)
    state = steps.init_state(model, lambda m: build_optimizer(OPTIM, m.named_parameters()), device="cpu",
                             criterion=crit)
    model.load_state_dict(flax_to_torch_model(model, params0))
    return state, crit


def _port_step(crit, opts):
    return steps.build_train_step(crit, lambda i: LR, input_dtype=torch.float32, **opts)


def _batch(i):
    images, labels = _batches()
    return {"image": torch.from_numpy(images[i]), "label": torch.from_numpy(labels[i])}


def _scalars(state):
    return {k: float(v) for k, v in state.loss_state.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_adacos_state_through_train_steps_matches_jax(jax_init, case):
    opts = CASES[case]
    _, _, jstate, want = _jax_run(jax_init, opts)
    state, crit = _port_state(jax_init)
    assert _scalars(state) == {"running_B": 1000.0, "running_cos": float(np.float32(0.7)), "prev_s": 20.0}
    step = _port_step(crit, opts)
    for i in range(N_STEPS):
        state, m = step(state, _batch(i))
        got = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), **_scalars(state)}
        for k, v in got.items():
            tol = TOL.get(k, TOL["state"])
            np.testing.assert_allclose(v, want[i][k], rtol=tol, err_msg=f"step {i} {k}")
        assert all(t.dtype == torch.float32 and not t.requires_grad for t in state.loss_state.values())
    final = flax_to_torch_model(state.model, jax.tree_util.tree_map(np.asarray, jstate.params))
    for k, v in state.model.state_dict().items():
        err = float((v - final[k]).norm() / final[k].norm().clamp(min=1e-30))
        assert err < TOL["weights"], (k, err)
    # the state moved: B from its 1000, and the scale from its cap
    assert want[-1]["running_B"] != 1000.0 and want[-1]["prev_s"] != 20.0


class _Counting(AdaCos):
    """AdaCos that counts its calls."""

    calls = 0

    def __call__(self, *args):
        self.calls += 1
        return super().__call__(*args)


def test_sam_advances_the_state_twice_only_with_bn_from_perturbed(jax_init):
    ends = {}
    for case in ("accumulate_2", "sam_bn_from_perturbed", "sam_bn_from_clean"):
        state, _ = _port_state(jax_init)
        crit = _Counting(**ADACOS)
        state, _ = _port_step(crit, CASES[case])(state, _batch(0))
        ends[case] = (crit.calls, _scalars(state))
    # one call per microbatch and pass; the state is the clean pass's without bn_from_perturbed
    assert [ends[c][0] for c in ("accumulate_2", "sam_bn_from_perturbed", "sam_bn_from_clean")] == [2, 4, 4]
    assert ends["sam_bn_from_clean"][1] == ends["accumulate_2"][1]
    assert ends["sam_bn_from_perturbed"][1] != ends["accumulate_2"][1]


def test_checkpoint_round_trip_resumes_the_state_bit_for_bit(jax_init, tmp_path):
    opts = CASES["accumulate_2"]
    state, crit = _port_state(jax_init)
    step = _port_step(crit, opts)
    for i in range(2):
        state, _ = step(state, _batch(i))
    path = save_checkpoint(str(tmp_path), state, epoch=1)
    state, _ = step(state, _batch(2))
    resumed, crit2 = _port_state(jax_init)
    resumed, epoch = load_checkpoint(path, resumed)
    assert epoch == 1 and resumed.step == 2
    resumed, _ = _port_step(crit2, opts)(resumed, _batch(2))
    for k, v in state.loss_state.items():
        assert torch.equal(v, resumed.loss_state[k]), k
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, resumed.model.state_dict()[k]), k
    # a checkpoint written without the state (before it existed) loads with the criterion's initial state
    payload = torch.load(path, weights_only=True)
    del payload["state"]["loss_state"]
    old = os.path.join(tmp_path, "old.ckpt")
    torch.save(payload, old)
    fresh, crit3 = _port_state(jax_init)
    fresh, _ = load_checkpoint(old, fresh)
    assert _scalars(fresh) == {k: float(v) for k, v in crit3.init_state().items()}


def test_eval_reads_the_state_and_leaves_it_as_jax_does(jax_init):
    opts = CASES["plain"]
    jmodel, jcrit, jstate, _ = _jax_run(jax_init, opts)
    state, crit = _port_state(jax_init)
    step = _port_step(crit, opts)
    for i in range(N_STEPS):
        state, _ = step(state, _batch(i))
    before = {k: v.clone() for k, v in state.loss_state.items()}
    images, labels = _batches()
    mask = np.array([1, 1, 0, 1, 1, 1, 0, 0], np.float32)
    for masked in (False, True):
        batch = {"image": images[0], "label": labels[0], **({"mask": mask} if masked else {})}
        want = jsteps.build_eval_step(jmodel, jcrit, input_dtype=jnp.float32)(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        got = steps.build_eval_step(crit, input_dtype=torch.float32)(
            state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4, err_msg=f"masked={masked} {k}")
        for k, v in state.loss_state.items():
            assert torch.equal(v, before[k]), k
