"""The port's moments op (sota_imagenet_tpu_torch.ops.moments) against the
JAX package's Pallas moments (interpret mode, as tests/test_pallas_norm.py
runs it off the TPU), on the CPU, from the same numpy inputs. The port's CPU
path is the kernel's plain version.

Tolerances: mean and var within rtol 1e-5 / atol 1e-6 (both sum x and x^2 in
f32, in other orders, over a few hundred rows of values of size ~1-3); the
VJP within rtol 1e-5 / atol 1e-7 (the same elementwise expression), and
within one bf16 ulp (rtol 2^-7) for a bf16 input, whose gradient is rounded
to bf16 after an f32 expression whose last bits may differ."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sota_imagenet_tpu.ops.pallas_norm import moments as jmoments
from sota_imagenet_tpu_torch.ops.moments import moments, moments_reference

CASES = {"4x5x7x64_f32": ((4, 5, 7, 64), "float32"), "3x9x5x128_bf16_ragged": ((3, 9, 5, 128), "bfloat16")}


def _input(shape, dtype, seed):
    x = (np.random.default_rng(seed).standard_normal(shape) * 2 + 1).astype(np.float32)
    return jnp.asarray(x).astype(getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("case", sorted(CASES))
def test_moments_match_jax(case):
    shape, dtype = CASES[case]
    jx, tx = _input(shape, dtype, seed=0)
    jmean, jvar = jmoments(jx, True)
    mean, var = moments(tx)
    assert mean.dtype == var.dtype == torch.float32 and tuple(mean.shape) == (shape[-1],)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(jvar), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_moments_vjp_matches_jax(case):
    shape, dtype = CASES[case]
    jx, tx = _input(shape, dtype, seed=1)

    def jloss(x):
        m, v = jmoments(x, True)
        return jnp.sum(m * 2.0 + v * 3.0)

    jgrad = jax.grad(jloss)(jx)
    tx.requires_grad_(True)
    m, v = moments(tx)
    (m * 2.0 + v * 3.0).sum().backward()
    assert tx.grad.dtype == tx.dtype
    np.testing.assert_allclose(
        tx.grad.float().numpy(), np.asarray(jgrad.astype(jnp.float32)), rtol=1e-5 if dtype == "float32" else 2.0**-7,
        atol=1e-7,
    )


def test_one_moment_unused_gets_no_gradient():
    x = torch.randn(6, 5, 16, requires_grad=True)
    mean, _ = moments(x)
    mean.sum().backward()
    torch.testing.assert_close(x.grad, torch.full_like(x, 1.0 / 30))


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    x = torch.randn(3, 9, 5, 128)
    before = moments.launches
    got = moments(x)
    assert moments.launches == before
    for a, b in zip(got, moments_reference(x)):
        assert torch.equal(a, b)


@pytest.mark.parametrize(
    "x,match",
    [
        (lambda: torch.zeros(4, 8, 16).transpose(0, 1), "contiguous"),
        (lambda: torch.zeros(4, 16, dtype=torch.float64), "bfloat16 or float32"),
        (lambda: torch.zeros(4, 0), "C > 0"),
    ],
    ids=["not_contiguous", "float64", "no_channels"],
)
def test_contract_is_checked_on_every_device(x, match):
    with pytest.raises(ValueError, match=match):
        moments(x())


def test_other_devices_raise():
    with pytest.raises(ValueError, match="cuda or cpu"):
        moments(torch.zeros(4, 16, device="meta"))
