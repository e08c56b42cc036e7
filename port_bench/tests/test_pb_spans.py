"""The join of the program's spans to the device trace (``port_bench/spans.py``)
on synthetic traces and spans, the readers that read it, and, on the card,
the clock the join rests on.

    python -m pytest -m cuda port_bench/tests/test_pb_spans.py -q -s
"""

import collections
import json
import time

import pytest

from port_bench import harness, spans
from port_bench.tests.test_pb_yardstick import _trace

# the fields of the program's span records (utils/trace.Span), all the join reads
Span = collections.namedtuple("Span", "id name start_ns end_ns parent unit thread")
BASE_NS = 1_790_000_000_000_000_000
THREAD = 11


def _span(sid, name, t0_us, t1_us, parent=None, unit=0, thread=THREAD, base_ns=BASE_NS):
    return Span(sid, name, base_ns + int(t0_us * 1e3), base_ns + int(t1_us * 1e3), parent, unit, thread)


def _doc(kernels, extra=()):
    """A device-only trace: kernels as (start_us, dur_us), on the trace's own base."""
    ev = [{"ph": "X", "cat": "kernel", "name": f"k{i}", "ts": s, "dur": d, "args": {"correlation": i}}
          for i, (s, d) in enumerate(kernels)]
    return {"baseTimeNanoseconds": BASE_NS, "traceEvents": ev + list(extra)}


def test_a_gap_under_the_program_call_is_charged_to_it():
    doc = _doc([(0, 10), (30, 10)])  # idle 10-30
    sp = [_span(1, "serve.request", 0, 40, unit=5), _span(2, "serve.program", 5, 35, parent=1, unit=5)]
    j = spans.join(doc, sp, THREAD)
    assert j["span_idle_s"]["serve.program"] == pytest.approx(20e-6)
    assert j["span_idle_s"][spans.OUTSIDE] == 0.0
    assert j["span_units"] == {"serve.request": 1, "serve.program": 1}


def test_a_gap_across_two_spans_is_split_between_them():
    doc = _doc([(0, 10), (50, 10)])  # idle 10-50
    sp = [_span(1, "fit.step", 0, 60), _span(2, "step.backward", 0, 22, parent=1),
          _span(3, "step.optimizer", 22, 45, parent=1)]
    idle = spans.join(doc, sp, THREAD)["span_idle_s"]
    assert idle["step.backward"] == pytest.approx(12e-6)
    assert idle["step.optimizer"] == pytest.approx(23e-6)
    assert idle["fit.step"] == pytest.approx(5e-6)  # 45-50: in the step, in no phase of it
    assert sum(idle.values()) == pytest.approx(40e-6)


def test_a_gap_under_no_span_is_outside_and_other_threads_are_not_charged():
    doc = _doc([(0, 10), (40, 10), (100, 10)])  # idle 10-40 and 50-100
    sp = [_span(1, "serve.request", 0, 45), _span(2, "feed.pin", 0, 200, thread=THREAD + 1)]
    idle = spans.join(doc, sp, THREAD)["span_idle_s"]
    assert idle["serve.request"] == pytest.approx(30e-6)
    assert idle[spans.OUTSIDE] == pytest.approx(50e-6)
    assert "feed.pin" not in idle


def test_the_yardstick_fixtures_summary_is_unchanged_key_by_key(tmp_path):
    path = _trace(tmp_path, [("gemm_a", 0, 100, 1), ("memcpy_h2d", 50, 100, 2), ("gemm_b", 190, 10, 3)],
                  host=[("aten::copy_", 0, 200)])
    before = harness.summarize_trace(path, steps=1)
    with open(path) as f:
        doc = json.load(f)
    added = spans.join(doc, [_span(1, "fit.step", 0, 200, base_ns=0)], THREAD)  # the fixture has no base time
    assert not set(added) & set(before)
    after = dict(harness.summarize_trace(path, steps=1), **added)
    for key, value in before.items():
        assert after[key] == value, key
    # every idle microsecond of the summary is charged once
    assert sum(added["span_idle_s"].values()) == pytest.approx(before["window_s"] - before["busy_s"])
    assert added["span_idle_s"]["fit.step"] == pytest.approx(40e-6)


def test_kernels_launched_inside_the_ema_span_are_its_device_time():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "step.ema", "ts": 100, "dur": 50, "tid": 1},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 110, "dur": 2, "tid": 1,
           "args": {"correlation": 7}},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 160, "dur": 2, "tid": 1,
           "args": {"correlation": 8}},
          {"ph": "X", "cat": "kernel", "name": "multi_tensor_apply_kernel", "ts": 200, "dur": 30,
           "args": {"correlation": 7}},
          {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 240, "dur": 40, "args": {"correlation": 8}}]
    assert spans.scope_device_s(ev, "step.ema") == pytest.approx(30e-6)
    assert spans.scope_device_s(ev, "step.optimizer") is None


READERS = ["input_idle_ms.train", "step_host_ms.train", "serve_host_idle_ms.serve", "ema_device_ms.train"]


@pytest.mark.parametrize("name", READERS)
def test_each_reader_gives_none_without_its_spans(name):
    # a traced summary of a program without spans: the device keys, none of the join's
    s = {"steps": 4, "window_s": 1.0, "busy_s": 0.9, "host": {"steps": 3, "optimizer_s": 0.001}}
    assert harness.metric_reader(name)(s) is None


def test_the_readers_read_the_join():
    s = {"steps": 2, "span_idle_s": {"fit.wait_batch": 0.002, "feed.gather": 0.001, "fit.step": 0.004,
                                    "serve.h2d": 0.0, spans.OUTSIDE: 0.001},
         "span_host_s": {"fit.wait_batch": [0.001, 0.001], "fit.step": [0.010, 0.030, 0.020],
                         "serve.request": [0.02]},
         "host": {"steps": 3, "ema_s": 0.0006}}
    read = {n: harness.metric_reader(n)(s) for n in READERS}
    assert read["input_idle_ms.train"] == pytest.approx(1.5)
    assert read["step_host_ms.train"] == pytest.approx(20.0)
    assert read["serve_host_idle_ms.serve"] == 0.0  # spans present, no idle under them: 0, not None
    assert read["ema_device_ms.train"] == pytest.approx(0.2)


def test_the_span_metrics_are_named_as_the_benchmark_names_them():
    spec = harness.benchmark_spec()
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {e["name"]: e for e in spec["end_to_end"]}
    layers = {m["layer"] for m in spec["per_layer"]} | {"serving"}
    for m in spans.SPAN_METRICS:
        assert harness.NAME.match(m["name"]) and m["layer"] in layers
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").exists()


def test_profile_turns_the_spans_on_for_its_window_and_restores_them(tmp_path):
    import torch

    trace = pytest.importorskip("sota_imagenet_tpu_torch.utils.trace")
    seen = []

    def run(tick, n):
        for i in range(n):
            with trace.span("fit.step", i):
                seen.append(trace.state())
                torch.ones(4).sum()
            tick()

    before = trace.state()
    s = spans.profile(torch, run, str(tmp_path / "t.json"), False, 1, 2)
    assert trace.state() == before and seen and all(on for on, _ in seen)
    assert s["steps"] == 2 and not (tmp_path / "t.json").exists()


@pytest.mark.cuda
def test_a_span_around_a_kernel_holds_its_device_interval(tmp_path):
    """On the card: a span around one matmul and a synchronise holds the
    matmul's kernels in a device-only trace, within 100 us."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sota_imagenet_tpu_torch.utils import trace

    x = torch.randn(4096, 4096, device="cuda")
    (x @ x).sum().item()
    previous = trace.enable()
    trace.take()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(5):
            with trace.span("check", i):
                x @ x
                torch.cuda.synchronize()
            time.sleep(0.002)  # the device idle between the spans
    trace.restore(previous)
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    with open(tmp_path / "t.json") as f:
        doc = json.load(f)
    base_us = doc["baseTimeNanoseconds"] / 1e3
    kernels = sorted((e["ts"] + base_us, e["ts"] + e["dur"] + base_us) for e in doc["traceEvents"]
                     if e.get("cat") == "kernel")
    checks = sorted((s.start_ns / 1e3, s.end_ns / 1e3) for s in trace.take() if s.name == "check")
    assert len(checks) == 5 and len(kernels) >= 5
    for k0, k1 in kernels:
        s0, s1 = min(checks, key=lambda c: abs(0.5 * (c[0] + c[1]) - 0.5 * (k0 + k1)))
        print(f"kernel of {k1 - k0:.1f} us: starts {k0 - s0:.1f} us after its span, ends {s1 - k1:.1f} us before it")
        assert s0 - 100 <= k0 and k1 <= s1 + 100
    assert all(any(s0 - 100 <= k0 and k1 <= s1 + 100 for k0, k1 in kernels) for s0, s1 in checks)
