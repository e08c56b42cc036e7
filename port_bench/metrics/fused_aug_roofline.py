"""The train augment kernel's least time (its uint8 batch read once, its
bf16 batch written once, at the card's peak bandwidth) over its mean
traced device time, in %."""

from port_bench import rooflines


def read(s):
    times = s.get("fused_aug_s") or []
    if not times:
        return None
    nbytes = rooflines.fused_aug_bytes(s["batch"], s["image_size"], s["image_size"])
    return 100.0 * rooflines.bound_seconds(nbytes=nbytes) / (sum(times) / len(times))
