"""``run.remat``'s peak device memory on the card (marked ``cuda``; skipped
without a GPU): a bf16 ResNet-50 step at batch 32 and 224 px peaks below the
plain step's ``max_memory_allocated`` under 'full' and under 'convs', since
each unit of the trunk is recomputed on its own just before its backward
(``train/steps.checkpointed_segments``). tests/test_torch_remat.py holds
the numbers and the order of the recompute on the CPU.

This file imports no JAX, so it runs on a machine without it; the repo's
conftest imports JAX, so there run it as

    python -m pytest --noconftest -m cuda tests/test_torch_remat_cuda.py -q
"""

import pytest
import torch

from sota_imagenet_tpu_torch.losses import CrossEntropyLoss
from sota_imagenet_tpu_torch.models.resnet import resnet50
from sota_imagenet_tpu_torch.optim import build_optimizer
from sota_imagenet_tpu_torch.train import steps

SGD = {"_target_": "sgd", "momentum": 0.9, "weight_decay": 1e-4}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: peak device memory is the card's (chip_smoke.py's trainers S and C-remat)")
    return torch.device("cuda")


def _peak(remat, device) -> int:
    torch.manual_seed(0)
    state = steps.init_state(resnet50(), lambda m: build_optimizer(SGD, m.named_parameters()), device=device)
    step = steps.build_train_step(CrossEntropyLoss(smoothing=0.1), lambda s: 0.1, remat=remat)
    batch = {"image": torch.randn(32, 224, 224, 3, device=device), "label": torch.eye(1000, device=device)[:32]}
    step(state, batch)  # cuDNN's workspaces and the optimizer state exist before the measured step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(state, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del state, step, batch
    torch.cuda.empty_cache()
    return peak


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["full", "convs"])
def test_remat_peaks_below_the_plain_step_on_the_card(cuda_device, remat):
    plain, under = _peak(False, cuda_device), _peak(remat, cuda_device)
    assert under < plain, (remat, under, plain)
