"""What every cell shares: the spec files, the caches, the weights made from
the seed, the device's description, the profiler's trace reduced to a
summary, the per-layer readers and the result line.

Imports nothing of the code under test at module level, and never JAX.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import re
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent  # the checkout
BENCH = Path(__file__).resolve().parent
CACHE = ROOT / ".port_bench_cache"  # fixed: only the first run of a checkout builds or exports
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
FORBIDDEN = ("jax", "jaxlib", "flax", "sota_imagenet_tpu")

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12


def cache_env() -> None:
    """Fixed cache directories inside the checkout, set before torch loads."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_jit")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def process_start_time() -> float:
    """Wall-clock time at which this process started (Linux), else now."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / ticks)
    except (OSError, ValueError, IndexError):
        return time.time()


def check_name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"bad name {name!r}")
    return name


def benchmark_spec() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_spec(workload: str) -> dict:
    spec = benchmark_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    return {"cell": cells[workload], "spec": spec}


def load_json(kind: str, name: str) -> dict:
    with open(BENCH / kind / f"{check_name(name)}.json") as f:
        return json.load(f)


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN)


def sub_seed(seed: int, k: int) -> int:
    """A 63-bit seed derived from the run's seed and a stream number."""
    return (int(seed) * 1_000_003 + 7919 * int(k)) % (2 ** 63)


def device_info(torch, device, count: int) -> dict:
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(count)) if device.type == "cuda" else 0
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind, "count": count,
            "memory_peak_bytes": int(peak)}


# ---------------------------------------------------------------- weights ---


def make_weights(torch, named_shapes: Dict[str, tuple], seed: int, device, arch: str) -> Dict[str, object]:
    """Every leaf of a state dict from one normal draw on ``device``: conv
    kernels He-normal (standardised NFNet kernels plain normal), linear
    kernels 1/sqrt(fan_in), norm and conv gains about 1, biases and running
    means about 0, running variances about 1, the NFNet skip gains about 0.5
    (so every branch is live from the first step), float32."""
    total = sum(math.prod(s) for s in named_shapes.values())
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in named_shapes.items():
        n = math.prod(shape)
        x = flat[at: at + n].view(shape)
        at += n
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "running_mean":
            x = 0.1 * x
        elif leaf == "running_var":
            x = 1.0 + 0.25 * x.abs()
        elif leaf == "skipinit_gain":
            x = 0.5 + 0.1 * x
        elif leaf == "gain":
            x = 1.0 + 0.1 * x
        elif leaf == "bias":
            x = torch.zeros_like(x) if name.startswith("fc.") else 0.1 * x
        elif len(shape) == 4:
            fan_in = shape[1] * shape[2] * shape[3]
            x = x if arch == "eca_nfnet_l0" else x * math.sqrt(2.0 / fan_in)
        elif len(shape) == 3:
            x = x / math.sqrt(shape[-1])
        elif len(shape) == 2:
            x = x / math.sqrt(shape[1])
        else:
            x = 1.0 + 0.1 * x
        out[name] = x.contiguous()
    return out


# --------------------------------------------------------------- the trace ---

# kernel-name fragments -> the layer a device kernel belongs to (first match wins)
KERNEL_GROUPS = (
    ("fused_aug", ("fused_aug",)),
    ("conv1x1_stats", ("conv1x1_stats",)),
    ("moments", ("moments_kernel",)),
    ("gather", ("vectorized_gather", "scatter_gather", "indexselect", "index_select")),
    ("nccl", ("nccl",)),
    ("memcpy", ("memcpy", "memset")),
    ("conv/matmul", ("conv", "gemm", "sm90", "xmma", "cutlass", "wgrad", "dgrad", "fprop", "cudnn")),
    ("batchnorm", ("batch_norm", "batchnorm", "bn_")),
    ("optimizer/EMA", ("multi_tensor", "foreach")),
    ("pool", ("pool",)),
    ("reduce", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "copy_kernel")),
)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_group(name: str) -> str:
    low = name.lower()
    return next((g for g, frags in KERNEL_GROUPS if any(f in low for f in frags)), "other")


def union_seconds(intervals: List[tuple]) -> tuple:
    """(seconds covered by the union of (start, end) intervals in us, the merged intervals)."""
    merged: List[list] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged) / 1e6, merged


def summarize_trace(path: str, steps: int) -> dict:
    """The profiler's Chrome trace reduced to what the per-layer readers
    read: the traced window (from the first device operation to the end of
    the last), the device's busy time in it as the union of its kernels,
    copies and fills (work overlapped on two streams counts once), the
    device time by kernel group and
    by kernel, the ``fused_aug`` launches, and, where the trace holds the
    host's ops, the device time of kernels launched inside
    ``Optimizer.step`` scopes and the longest idle gaps, each with the
    host op that ran through it."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation", "python_function")]
    busy_s, merged = union_seconds([(e["ts"], e["ts"] + e.get("dur", 0)) for e in dev])
    spanned = dev or events
    wall_s = (max(e["ts"] + e.get("dur", 0) for e in spanned) - min(e["ts"] for e in spanned)) / 1e6 if spanned else 0.0
    groups: Dict[str, float] = {}
    kernels: Dict[str, float] = {}
    for e in dev:
        g = kernel_group(e.get("name", ""))
        groups[g] = groups.get(g, 0.0) + e.get("dur", 0) / 1e6
        kernels[e.get("name", "")] = kernels.get(e.get("name", ""), 0.0) + e.get("dur", 0) / 1e6
    out = {
        "window_s": wall_s,
        "busy_s": min(busy_s, wall_s),
        "steps": steps,
        "device_s": sum(e.get("dur", 0) for e in dev) / 1e6,
        "groups_s": groups,
        "top_kernels": sorted(([k[:90], v] for k, v in kernels.items()), key=lambda kv: -kv[1])[:12],
        "fused_aug_s": [e.get("dur", 0) / 1e6 for e in dev if "fused_aug" in e.get("name", "").lower()],
    }
    if not host:
        return out
    # kernels whose launch the host made inside an optimizer step's scope
    scopes = [(e["ts"], e["ts"] + e["dur"], e.get("tid")) for e in host if e.get("name", "").startswith("Optimizer.step#")]
    corr = set()
    for e in events:
        if e.get("cat") == "cuda_runtime":
            for s, t, tid in scopes:
                if tid == e.get("tid") and s <= e["ts"] <= t:
                    corr.add(e.get("args", {}).get("correlation"))
                    break
    out["optimizer_s"] = sum(e.get("dur", 0) for e in dev if e.get("args", {}).get("correlation") in corr) / 1e6
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e.get("dur", 0) for e in events)
    edges = [[t0, t0]] + merged + [[t1, t1]]
    gaps = [(e0, s1) for (_, e0), (s1, _) in zip(edges, edges[1:]) if s1 > e0]
    gaps.sort(key=lambda g: g[0] - g[1])
    tagged = []
    for s, t in gaps[:10]:
        mid = 0.5 * (s + t)
        inside = [e for e in host if e["ts"] <= mid <= e["ts"] + e.get("dur", 0)]
        name = min(inside, key=lambda e: e.get("dur", 0))["name"][:80] if inside else "no host op"
        tagged.append([name, (t - s) / 1e6])
    out["idle_gaps"] = tagged
    return out


def profile(torch, run: Callable[[Callable[[], None], int], None], trace_path: str, host_ops: bool, skip: int,
            active: int) -> dict:
    """Trace ``active`` units of work (steps or requests) after ``skip``
    untraced ones: ``run(tick, skip + active)`` does the work and calls
    ``tick`` after each unit. The device's activity only unless
    ``host_ops`` (the profiler's host recording slows a host that launches
    much). Returns the trace's summary."""
    from torch.profiler import ProfilerActivity, profile as _profile, schedule

    acts = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
    if host_ops or not acts:
        acts = [ProfilerActivity.CPU] + acts
    skip = max(int(skip), 1)
    done = []
    with _profile(activities=acts, record_shapes=False, with_stack=False,
                  schedule=schedule(wait=skip - 1, warmup=1, active=active, repeat=1),
                  on_trace_ready=lambda p: (p.export_chrome_trace(trace_path), done.append(1))) as prof:
        run(prof.step, skip + active)
    if not done:
        raise RuntimeError("the profiler's window did not close")
    try:
        return summarize_trace(trace_path, active)
    finally:
        os.unlink(trace_path)


def breakdown(summary: dict) -> Optional[dict]:
    if not summary.get("groups_s"):
        return None
    ops = sorted(summary["groups_s"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": summary.get("host", {}).get("idle_gaps", [])[:10]}


# ---------------------------------------------------------------- readers ---


def metric_reader(name: str) -> Callable[[dict], Optional[float]]:
    path = BENCH / "metrics" / f"{check_name(name)}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(spec: dict, workload: str, kind: str) -> List[dict]:
    """The cell's end-to-end or per-layer metrics as BENCHMARK.json lists them."""
    out = []
    e2e_here = {m["name"] for m in spec["end_to_end"] if "workloads" not in m or workload in m["workloads"]}
    for m in spec[kind]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e_here:
            out.append(m)
    return out


def emit(result: dict, checks: List[dict]) -> None:
    """The compared numbers on stderr as the last lines, and the result line
    last on stdout, with the checks under their own key, last."""
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} limit {c['limit']!r} ({'ok' if c['ok'] else 'FAIL'})", file=sys.stderr)
    result = dict(result)
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def check(name: str, value: float, limit: float) -> dict:
    ok = value is not None and math.isfinite(value) and value <= limit
    return {"name": name, "value": value, "limit": limit, "ok": bool(ok)}
