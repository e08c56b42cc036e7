"""Device-idle ms per traced step charged to the train loop's wait for its
batch (``fit.wait_batch``) or to a feed's span (``feed.*``): the idle time
the input path leaves on the device, from the program's spans joined to the
device-only trace (``port_bench/spans.py``)."""


def read(s):
    idle, host = s.get("span_idle_s"), s.get("span_host_s") or {}
    if idle is None or "fit.wait_batch" not in host or not s.get("steps"):
        return None
    return 1e3 * sum(v for k, v in idle.items() if k == "fit.wait_batch" or k.startswith("feed.")) / s["steps"]
