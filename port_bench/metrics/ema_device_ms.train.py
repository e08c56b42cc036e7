"""Device ms per train step of the kernels launched inside the step's EMA
span (``step.ema``), by the launches' correlation ids, from the steps
traced with the host's ops and the spans mirrored into the trace
(``port_bench/spans.py``)."""


def read(s):
    host = s.get("host") or {}
    if host.get("ema_s") is None or not host.get("steps"):
        return None
    return 1e3 * host["ema_s"] / host["steps"]
