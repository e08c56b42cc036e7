"""Operations and bytes from shapes, and the least time the card could take.

Each input byte is counted as read once and each output byte as written
once. Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
(state a share beside the card's own ``power.limit``).
"""

from __future__ import annotations

from port_bench.harness import PEAK_BF16_FLOPS, PEAK_HBM_BYTES_S


def fused_aug_bytes(batch: int, height: int, width: int, out_bytes: int = 2) -> int:
    """The train augment kernel: a uint8 RGB batch read once, the
    normalised batch written once in the output type (bf16: 2 bytes)."""
    return batch * height * width * 3 * (1 + out_bytes)


def bound_seconds(flops: float = 0.0, nbytes: float = 0.0, peak_flops: float = PEAK_BF16_FLOPS,
                  peak_bytes_s: float = PEAK_HBM_BYTES_S) -> float:
    """The larger of the compute and the memory bound."""
    return max(flops / peak_flops, nbytes / peak_bytes_s)


def mfu_percent(flops_per_item: float, items_per_s: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    return 100.0 * flops_per_item * items_per_s / peak_flops
