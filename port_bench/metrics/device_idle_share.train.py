"""Share of the traced window in which no kernel, copy or fill ran on the
device (one minus the union of their intervals over the window), in %."""


def read(s):
    if not s.get("window_s") or s.get("busy_s") is None:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
