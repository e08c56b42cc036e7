"""The port's spans (``sota_imagenet_tpu_torch/utils/trace.py``) joined to
the profiler's trace of the device: what the host was doing while the
device idled, named by the program's own layers.

The spans are stamped with ``time.time_ns()`` and a Chrome trace places its
events on the same epoch clock (``ts`` in microseconds after
``baseTimeNanoseconds``), so a trace that recorded the device alone, and
did not slow the host, can be joined to them. ``join`` takes the device's
busy intervals merged as ``harness.summarize_trace`` merges them (so the
idle time is that summary's ``window_s - busy_s``), cuts each idle interval
at the span boundaries of the thread that ran the loop, and charges each
piece to the innermost span open over it, or to ``outside`` (for serving,
the client). It also keeps each span name's host durations in the window
and counts its units (steps or requests). In a trace that also recorded
the host, with the spans mirrored into it, ``scope_device_s`` sums the
device time of the kernels launched inside a span (``step.ema``), by the
launches' correlation ids, as ``optimizer_s`` is read.

``profile`` is ``harness.profile`` with the spans on over the traced units
and the join added to the summary; with a program that has no span
recorder it is ``harness.profile`` itself. ``SPAN_METRICS`` are the
per-layer metrics that read the join (``metrics/<name>.py``).

    python3 -m port_bench.spans --workload <cell> --seed <n> --seconds <s>

runs the cell's ``--trace 1`` run with its traced windows taken through
``profile`` and the cell's ``SPAN_METRICS`` added to its result line, and
prints each traced window's join to standard error (a ``spans`` line).
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import threading
from typing import Dict, List, Optional

from port_bench import harness

OUTSIDE = "outside"  # idle time under no span of the loop's thread

_METRIC = {"unit": "ms", "better": "lower", "source": "program_span"}
SPAN_METRICS = [
    dict(_METRIC, name="input_idle_ms.train", layer="feed and device cache", moves="train_img_per_s",
         workloads=["r50.cache", "nfnet_l0.feed"]),
    dict(_METRIC, name="step_host_ms.train", layer="train step", moves="train_img_per_s",
         workloads=["r50.cache", "nfnet_l0.feed"]),
    dict(_METRIC, name="serve_host_idle_ms.serve", layer="serving", moves="serve_img_per_s", workloads=["r50.serve"]),
    dict(_METRIC, name="ema_device_ms.train", layer="optimizer", moves="train_img_per_s",
         workloads=["nfnet_l0.feed"]),
]

_harness_profile = harness.profile


def recorder():
    """The program's span recorder, or None where the program has none."""
    try:
        from sota_imagenet_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def innermost(spans: List[tuple]) -> List[tuple]:
    """``[(t0, t1, name)]``: the time covered by ``spans`` ((start, end, id,
    name) of one thread, nested) cut at every span boundary, each piece
    under the innermost span open over it."""
    events = []
    for start, end, sid, name in spans:
        events.append((start, 1, sid, name))  # at one instant: ends first, outer spans open first
        events.append((end, 0, -sid, name))  # and inner ones close first
    events.sort()
    out, stack, at = [], [], None
    for t, opens, key, name in events:
        if stack and t > at:
            out.append((at, t, stack[-1][1]))
        at = t
        if opens:
            stack.append((key, name))
        else:
            stack.remove((-key, name))
    return out


def charge(gaps: List[tuple], pieces: List[tuple]) -> Dict[str, float]:
    """The length of the ``gaps`` ((t0, t1), sorted) under each piece's name
    (``innermost``'s pieces, sorted), the rest under ``OUTSIDE``."""
    out: Dict[str, float] = {}
    j = 0
    for g0, g1 in gaps:
        while j < len(pieces) and pieces[j][1] <= g0:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < g1:
            a, b = max(g0, pieces[k][0]), min(g1, pieces[k][1])
            if b > a:
                out[pieces[k][2]] = out.get(pieces[k][2], 0.0) + (b - a)
            k += 1
    total = sum(g1 - g0 for g0, g1 in gaps)
    out[OUTSIDE] = max(total - sum(out.values()), 0.0)
    return out


def scope_device_s(events: List[dict], name: str) -> Optional[float]:
    """Device seconds of the kernels launched inside the ``name`` scopes of
    a trace that recorded the host (None where it holds no such scope)."""
    scopes = [(e["ts"], e["ts"] + e.get("dur", 0), e.get("tid")) for e in events
              if e.get("cat") == "user_annotation" and e.get("name") == name]
    if not scopes:
        return None
    corr = set()
    for e in events:
        if e.get("cat") == "cuda_runtime":
            if any(tid == e.get("tid") and s <= e["ts"] <= t for s, t, tid in scopes):
                corr.add(e.get("args", {}).get("correlation"))
    return sum(e.get("dur", 0) for e in events
               if e.get("cat") in harness.DEVICE_CATS and e.get("args", {}).get("correlation") in corr) / 1e6


def join(doc: dict, spans: list, thread: int) -> dict:
    """The summary keys of a trace (``doc``, the Chrome trace's JSON) joined
    to the spans recorded over it: ``span_idle_s`` (device-idle seconds in
    the window by innermost span of ``thread``, and ``OUTSIDE``),
    ``span_host_s`` (the host seconds of each span that overlaps the
    window, by name), ``span_units`` (distinct units by name) and, where the
    trace holds ``step.ema`` scopes, ``ema_s``."""
    base_ns = int(doc.get("baseTimeNanoseconds", 0))
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    dev = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events if e.get("cat") in harness.DEVICE_CATS]
    if not dev:
        return {}
    _, merged = harness.union_seconds(dev)
    w0, w1 = merged[0][0], merged[-1][1]
    gaps = [(e0, s1) for (_, e0), (s1, _) in zip(merged, merged[1:]) if s1 > e0]
    on_trace = [((s.start_ns - base_ns) / 1e3, (s.end_ns - base_ns) / 1e3, s) for s in spans]
    mine = [(t0, t1, s.id, s.name) for t0, t1, s in on_trace if s.thread == thread]
    idle = charge(gaps, innermost(mine))
    host: Dict[str, List[float]] = {}
    units: Dict[str, set] = {}
    for t0, t1, s in on_trace:
        if t1 > w0 and t0 < w1:
            host.setdefault(s.name, []).append((t1 - t0) / 1e6)
            units.setdefault(s.name, set()).add(s.unit)
    out = {"span_idle_s": {k: v / 1e6 for k, v in sorted(idle.items(), key=lambda kv: -kv[1])},
           "span_host_s": host, "span_units": {k: len(v - {None}) for k, v in units.items()}}
    ema = scope_device_s(events, "step.ema")
    if ema is not None:
        out["ema_s"] = ema
    return out


def profile(torch, run, trace_path: str, host_ops: bool, skip: int, active: int) -> dict:
    """``harness.profile`` with the program's spans on (mirrored into the
    trace where it records the host) and the join in the summary."""
    rec = recorder()
    if rec is None:
        return _harness_profile(torch, run, trace_path, host_ops, skip, active)
    kept = {}

    def traced(tick, n):
        run(tick, n)
        # the profiler wrote its trace at the window's last tick, inside run
        if os.path.exists(trace_path):
            with open(trace_path) as f:
                kept["doc"] = json.load(f)

    previous = rec.enable(mirror=host_ops)
    rec.take()
    try:
        summary = _harness_profile(torch, traced, trace_path, host_ops, skip, active)
        spans = rec.take()
    finally:
        rec.restore(previous)
    joined = join(kept["doc"], spans, threading.get_native_id()) if "doc" in kept else {}
    summary.update(joined)
    if joined:
        report = {k: summary.get(k) for k in ("steps", "window_s", "busy_s", "span_idle_s", "ema_s", "span_units")}
        report["host_ops"] = host_ops
        report["span_host_ms_median"] = {k: 1e3 * statistics.median(v) for k, v in joined["span_host_s"].items()}
        print("spans " + json.dumps(report), file=sys.stderr)
    return summary


def main(argv=None) -> int:
    from port_bench import run

    harness.profile = profile
    listed = harness.cell_metrics

    def cell_metrics(spec, workload, kind):
        extra = [m for m in SPAN_METRICS if workload in m["workloads"]] if kind == "per_layer" else []
        return listed(spec, workload, kind) + extra

    harness.cell_metrics = cell_metrics
    return run.main([*(argv if argv is not None else sys.argv[1:]), "--trace", "1"])


if __name__ == "__main__":
    sys.exit(main())
