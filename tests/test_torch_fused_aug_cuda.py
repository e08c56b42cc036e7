"""The fused-augment CUDA kernel against its plain PyTorch version, on the
card (marked ``cuda``; skipped without a GPU). Bit-exact: the kernel rounds
every operation as the plain version does.

This file imports no JAX, so it runs on a machine without it; the repo's
conftest imports JAX, so there run it as

    python -m pytest --noconftest -m cuda tests/test_torch_fused_aug_cuda.py -q
"""

import pytest
import torch

from sota_imagenet_tpu_torch.ops.fused_aug import draw_augment_scalars, fused_augment, fused_augment_reference

STAGES = {
    "off": dict(color_twist_prob=0.0, gray_prob=0.0, re_prob=0.0, re_count=3),
    "on_re1": dict(color_twist_prob=0.4, gray_prob=0.2, re_prob=0.3, re_count=1),
    "on_re3": dict(color_twist_prob=0.4, gray_prob=0.2, re_prob=0.3, re_count=3),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode; chip_smoke.py runs this check on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 224, 224), (3, 37, 53)], ids=["256x224x224", "3x37x53"])
@pytest.mark.parametrize("stages", sorted(STAGES))
def test_kernel_matches_plain_version_on_card(cuda_device, shape, stages):
    b, h, w = shape
    kw = STAGES[stages]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    imgs = torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8, device=cuda_device, generator=gen)
    scalars = draw_augment_scalars(gen, b, device=cuda_device, **kw)
    for dt in (torch.bfloat16, torch.float32):
        before = fused_augment.launches
        got = fused_augment(imgs, scalars, out_dtype=dt, **kw)
        assert fused_augment.launches == before + 1
        want = fused_augment_reference(imgs, scalars, out_dtype=dt, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
