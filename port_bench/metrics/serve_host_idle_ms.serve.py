"""Device-idle ms per traced request charged to the server's own spans
(``serve.*``: the request's copy to the device and the program's call),
the server's host work between requests, from the program's spans joined
to the device-only trace (``port_bench/spans.py``); the client's share is
charged to ``outside``."""


def read(s):
    idle, host = s.get("span_idle_s"), s.get("span_host_s") or {}
    if idle is None or "serve.request" not in host or not s.get("steps"):
        return None
    return 1e3 * sum(v for k, v in idle.items() if k.startswith("serve.")) / s["steps"]
