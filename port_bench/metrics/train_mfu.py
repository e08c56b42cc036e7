"""Model FLOPs of the traced window's training over the card's bf16 peak,
in %: three times the reference model's forward FLOPs per image (no
recompute counted) times the images trained a second."""

from port_bench import rooflines


def read(s):
    if not s.get("img_per_s") or not s.get("fwd_flops"):
        return None
    return rooflines.mfu_percent(3.0 * s["fwd_flops"], s["img_per_s"])
