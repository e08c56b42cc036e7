"""The conv1x1 + BN-stats CUDA kernels (sm90: TMA + wgmma; mma_sync: the
general path) against their plain PyTorch version, on the card (marked
``cuda``; skipped without a GPU).

Tolerances: y equals the plain version's y except where the two f32 sums,
taken in other orders, straddle a bf16 rounding boundary: there one bf16 ulp,
plus the f32 summation-order bound 2K * 2^-24 * (|x| @ |w|^T) where y is near
0, on at most max(1e-3, K * 2^-20) of the elements. The sums are within
rtol 1e-5 of float64 sums of the kernel's own y (relative to sum |y| for the
plain sum, which may cancel). The backward equals autograd through the plain
version within rtol 1e-2 of the largest gradient (the fold is rounded to bf16
before the products).

This file imports no JAX, so it runs on a machine without it; the repo's
conftest imports JAX, so there run it as

    python -m pytest --noconftest -m cuda tests/test_torch_conv_stats_cuda.py -q
"""

import math

import pytest
import torch

from sota_imagenet_tpu_torch.ops.conv_stats import (
    choose_path,
    conv1x1_stats,
    conv1x1_stats_nhwc,
    conv1x1_stats_reference,
)

# r50 shapes bound by operations (12544x512x2048) and by bytes (50176x1024x256,
# 802816x256x64 at N = 64), ragged M at N and K multiples of 8 (sm90), and K
# or N not a multiple of 8 (mma_sync)
SHAPES = [
    (12544, 512, 2048), (50176, 1024, 256), (1000, 40, 72), (257, 24, 3), (100, 13, 130),
    (802816, 256, 64), (1000, 64, 72), (12545, 512, 2048),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode; chip_smoke.py runs this check on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _assert_y_close(x, w, y, y_ref):
    yk, yr = y.float(), y_ref.float()
    diff = (yk - yr).abs()
    _, exp = torch.frexp(torch.maximum(yk.abs(), yr.abs()))
    bound = torch.ldexp(torch.ones_like(yk), exp - 8) + (x.float().abs() @ w.float().abs().t()) * (2.0 * x.shape[1] * 2.0**-24)
    assert int((diff > bound).sum()) == 0
    assert float((diff > 0).float().mean()) <= max(1e-3, x.shape[1] * 2.0**-20)


def _assert_sums(y, s1, s2):
    y64 = y.double()
    assert float(((s1.double() - y64.sum(0)).abs() / y64.abs().sum(0).clamp_min(1e-30)).max()) <= 1e-5
    sq = (y64 * y64).sum(0)
    assert float(((s2.double() - sq).abs() / sq.clamp_min(1e-30)).max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_version_on_card(cuda_device, shape):
    m, k, n = shape
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.rand((m, k), generator=gen, device=cuda_device).to(torch.bfloat16)
    w = (torch.randn((n, k), generator=gen, device=cuda_device) * math.sqrt(2.0 / n)).to(torch.bfloat16)
    path = "mma_sync" if k % 8 or n % 8 else "sm90"
    assert choose_path(k, n, x.data_ptr(), w.data_ptr()) == path
    before, before_path = conv1x1_stats.launches, conv1x1_stats.launches_by_path[path]
    y, s1, s2 = conv1x1_stats(x, w)
    assert conv1x1_stats.launches == before + 1 and conv1x1_stats.launches_by_path[path] == before_path + 1
    y_ref, _, _ = conv1x1_stats_reference(x, w)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (m, n)
    _assert_y_close(x, w, y, y_ref)
    _assert_sums(y, s1, s2)


@pytest.mark.cuda
def test_unaligned_operand_takes_elementwise_loads(cuda_device):
    """An operand that does not start on 16 bytes takes the mma_sync kernel
    and its element-wise load path; the result is the same."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    base = torch.rand((300 * 64 + 1,), generator=gen, device=cuda_device).to(torch.bfloat16)
    x = base[1:].view(300, 64)  # 2-byte offset
    w = torch.randn((96, 64), generator=gen, device=cuda_device).to(torch.bfloat16)
    before = conv1x1_stats.launches_by_path["mma_sync"]
    y, s1, s2 = conv1x1_stats(x, w)
    assert conv1x1_stats.launches_by_path["mma_sync"] == before + 1
    y_ref, _, _ = conv1x1_stats_reference(x, w)
    torch.cuda.synchronize()
    _assert_y_close(x, w, y, y_ref)
    _assert_sums(y, s1, s2)


@pytest.mark.cuda
def test_nhwc_stride2_on_card(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.rand((4, 32, 14, 14), generator=gen, device=cuda_device).contiguous(memory_format=torch.channels_last)
    w = torch.randn((64, 32, 1, 1), generator=gen, device=cuda_device) * 0.1
    y, s1, s2 = conv1x1_stats_nhwc(x, w, stride=2)
    assert tuple(y.shape) == (4, 64, 7, 7) and y.is_contiguous(memory_format=torch.channels_last)
    x2d = x[:, :, ::2, ::2].permute(0, 2, 3, 1).reshape(-1, 32)
    y_ref, _, _ = conv1x1_stats_reference(x2d, w.view(64, 32))
    torch.cuda.synchronize()
    y2d = y.permute(0, 2, 3, 1).reshape(-1, 64)
    _assert_y_close(x2d.to(torch.bfloat16), w.view(64, 32).to(torch.bfloat16), y2d, y_ref)
    _assert_sums(y2d, s1, s2)


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_matches_plain_autograd_on_card(cuda_device, x_dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    m, k, n = 4096, 256, 512
    x = torch.randn((m, k), generator=gen, device=cuda_device).to(x_dtype)
    w = torch.randn((n, k), generator=gen, device=cuda_device) * 0.1
    grads = []
    for fn in (conv1x1_stats, conv1x1_stats_reference):
        xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        y, s1, s2 = fn(xl, wl)
        mean = s1 / m
        var = s2 / m - mean**2
        (y.float().mul(0.01).sum() + mean.mul(0.5).sum() + var.mul(0.25).sum()).backward()
        grads.append((xl.grad, wl.grad))
    for got, want in zip(*grads):
        assert got.dtype == want.dtype
        assert float((got.float() - want.float()).abs().max()) <= 1e-2 * float(want.float().abs().max())


@pytest.mark.cuda
def test_unused_sums_get_no_gradient_on_card(cuda_device):
    x = torch.randn((256, 64), device=cuda_device, requires_grad=True)
    w = torch.randn((128, 64), device=cuda_device, requires_grad=True)
    y, _, _ = conv1x1_stats(x, w)
    y.float().sum().backward()
    torch.cuda.synchronize()
    assert torch.isfinite(x.grad).all() and torch.isfinite(w.grad).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(802816, 64, 256), (50176, 1024, 512), (1000, 40, 72)], ids=lambda s: "x".join(map(str, s)))
def test_sm90_is_bitwise_deterministic_on_card(cuda_device, shape):
    """The same inputs give the same y and sums, bit for bit: every sum runs
    in a fixed order, with no atomics."""
    m, k, n = shape
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn((m, k), generator=gen, device=cuda_device).to(torch.bfloat16)
    w = torch.randn((n, k), generator=gen, device=cuda_device).to(torch.bfloat16)
    first = conv1x1_stats(x, w)
    second = conv1x1_stats(x, w)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_launches_by_path_counts_each_kernel_on_card(cuda_device):
    """launches counts every launch, launches_by_path the kernel it took."""
    before, by_path = conv1x1_stats.launches, dict(conv1x1_stats.launches_by_path)
    x = torch.randn((512, 64), device=cuda_device)
    conv1x1_stats(x, torch.randn((128, 64), device=cuda_device))  # sm90
    conv1x1_stats(x, torch.randn((64, 64), device=cuda_device))  # sm90
    conv1x1_stats(x, torch.randn((100, 64), device=cuda_device))  # N % 8 != 0: mma_sync
    conv1x1_stats(torch.empty((0, 64), device=cuda_device), torch.randn((64, 64), device=cuda_device))  # nothing to launch
    torch.cuda.synchronize()
    assert conv1x1_stats.launches == before + 3
    assert conv1x1_stats.launches_by_path == {"sm90": by_path["sm90"] + 2, "mma_sync": by_path["mma_sync"] + 1}
