"""The moments CUDA kernel against float64 moments of the same input, on the
card (marked ``cuda``; skipped without a GPU).

Tolerances: mean within rtol 1e-5 plus an atol of 1e-5 of the channel's root
mean square; var within rtol 1e-5 plus an atol of 1e-5 of the channel's mean
square (var = E[x^2] - mean^2 cancels down to that scale). The backward equals
the plain version's exactly in form, (dmean + 2 dvar (x - mean)) / N, so it is
held within rtol 1e-5 of the plain version's autograd.

This file imports no JAX, so it runs on a machine without it; the repo's
conftest imports JAX, so there run it as

    python -m pytest --noconftest -m cuda tests/test_torch_moments_cuda.py -q
"""

import pytest
import torch

from sota_imagenet_tpu_torch.ops.moments import moments, moments_reference

CASES = [((256, 56, 56, 64), torch.bfloat16), ((3, 9, 5, 128), torch.bfloat16), ((3, 9, 5, 128), torch.float32),
         ((7, 33), torch.float32), ((1000, 2048), torch.bfloat16), ((5, 3), torch.float32)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode; chip_smoke.py runs this check on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", CASES, ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v)[6:])
def test_kernel_matches_float64_moments_on_card(cuda_device, shape, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = (torch.randn(shape, generator=gen, device=cuda_device) * 2 + 1).to(dtype)
    before = moments.launches
    mean, var = moments(x)
    assert moments.launches == before + 1
    x64 = x.double().reshape(-1, shape[-1])
    mean64, sq64 = x64.mean(0), (x64 * x64).mean(0)
    var64 = (x64 - mean64).square().mean(0)
    torch.cuda.synchronize()
    assert mean.dtype == var.dtype == torch.float32
    assert bool(((mean.double() - mean64).abs() <= 1e-5 * mean64.abs() + 1e-5 * sq64.sqrt()).all())
    assert bool(((var.double() - var64).abs() <= 1e-5 * var64 + 1e-5 * sq64).all())


@pytest.mark.cuda
def test_backward_matches_plain_autograd_on_card(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn((3, 6, 6, 128), generator=gen, device=cuda_device)
    grads = []
    for fn in (moments, moments_reference):
        xl = x.clone().requires_grad_(True)
        m, v = fn(xl)
        (m * 2.0 + v * 3.0).sum().backward()
        grads.append(xl.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-7)
