"""Device ms per train step of the kernels launched inside torch's
``Optimizer.step`` scope (read from the steps traced with the host's ops)."""


def read(s):
    host = s.get("host") or {}
    if host.get("optimizer_s") is None or not host.get("steps"):
        return None
    return 1e3 * host["optimizer_s"] / host["steps"]
