"""Shared constants (import-cycle-free leaf module).

Normalization values from the reference (dali_dataloader.py:27-29) —
deliberately NOT ImageNet stats: mean 0.5*255, std 0.2*255 normalizes
uint8 pixels to roughly [-2.5, 2.5].
"""

DATA_MEAN = 0.5 * 255.0
DATA_STD = 0.2 * 255.0
