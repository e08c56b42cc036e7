"""Model FLOPs of the traced window's serving over the card's bf16 peak,
in %: the reference model's forward FLOPs per image times the images
classified a second."""

from port_bench import rooflines


def read(s):
    if not s.get("img_per_s") or not s.get("fwd_flops"):
        return None
    return rooflines.mfu_percent(s["fwd_flops"], s["img_per_s"])
