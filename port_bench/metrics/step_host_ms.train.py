"""Median host ms of the train loop's step (``fit.step``: the launches of
the forward, backward, optimizer and EMA) over the traced steps, from the
program's spans (``port_bench/spans.py``). Beside the device's ms a step it
says how far the step is from being bound by its launches."""

import statistics


def read(s):
    steps = (s.get("span_host_s") or {}).get("fit.step")
    if not steps:
        return None
    return 1e3 * statistics.median(steps)
