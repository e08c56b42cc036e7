"""The port's criterion and metrics (sota_imagenet_tpu_torch.losses.smooth,
train.metrics) against the JAX package's on the same numpy inputs, float32
on the CPU. Tolerance rtol 1e-6 on the loss (log-softmax sums in another
order); the top-k metrics are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sota_imagenet_tpu.losses import CrossEntropyLoss as JCrossEntropyLoss
from sota_imagenet_tpu.train.metrics import accuracy_topk as jax_accuracy_topk
from sota_imagenet_tpu_torch.losses import CrossEntropyLoss, call_criterion
from sota_imagenet_tpu_torch.train.metrics import accuracy_topk

CE_CASES = {
    "plain": dict(),
    "smooth0.1": dict(smoothing=0.1),
    "temp0.5": dict(smoothing=0.1, temperature=0.5),
    "normalize": dict(normalize=True, temperature=0.1),
    "sum": dict(smoothing=0.1, reduction="sum"),
    "none": dict(smoothing=0.1, reduction="none"),
}
TARGETS = ("class_ids", "one_hot", "soft")


def _inputs(target_kind, b=16, c=10):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((b, c)) * 3).astype(np.float32)
    ids = rng.integers(0, c, b)
    if target_kind == "class_ids":
        return logits, ids
    if target_kind == "one_hot":
        return logits, np.eye(c, dtype=np.float32)[ids]
    soft = rng.random((b, c)).astype(np.float32)
    return logits, soft / soft.sum(-1, keepdims=True)


@pytest.mark.parametrize("target_kind", TARGETS)
@pytest.mark.parametrize("case", sorted(CE_CASES))
def test_cross_entropy_matches_jax(case, target_kind):
    logits, target = _inputs(target_kind)
    kw = CE_CASES[case]
    want = np.asarray(JCrossEntropyLoss(**kw)(jnp.asarray(logits), jnp.asarray(target)))
    got, state = call_criterion(CrossEntropyLoss(**kw), torch.from_numpy(logits), torch.from_numpy(target))
    assert state is None and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_cross_entropy_of_bf16_logits_runs_in_float32():
    logits, target = _inputs("one_hot")
    got = CrossEntropyLoss(smoothing=0.1)(torch.from_numpy(logits).to(torch.bfloat16), torch.from_numpy(target))
    assert got.dtype == torch.float32
    with pytest.raises(ValueError, match="reduction"):
        CrossEntropyLoss(reduction="max")(torch.from_numpy(logits), torch.from_numpy(target))


@pytest.mark.parametrize("k", [1, 5, 20])
@pytest.mark.parametrize("target_kind", TARGETS)
def test_accuracy_topk_matches_jax(k, target_kind):
    logits, target = _inputs(target_kind)
    for mean in (True, False):
        want = np.asarray(jax_accuracy_topk(jnp.asarray(logits), jnp.asarray(target), k, mean=mean))
        got = accuracy_topk(torch.from_numpy(logits), torch.from_numpy(target), k, mean=mean).numpy()
        np.testing.assert_array_equal(got, want)
