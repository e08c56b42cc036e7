"""Device ms per train step outside the conv and GEMM kernels: norms,
elementwise work, the optimizer, the EMA, copies."""


def read(s):
    if not s.get("groups_s") or not s.get("steps"):
        return None
    return 1e3 * (s["device_s"] - s["groups_s"].get("conv/matmul", 0.0)) / s["steps"]
