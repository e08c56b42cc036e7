"""The port's spans (``utils/trace.py``) on the CPU.

* Off (the default), ``span`` is one shared null context: a tiny
  ``Runner.fit`` records nothing and never enters ``record_function``.
* On, every step has ``fit.wait_batch`` and ``fit.step``; inside the step
  are ``step.forward`` and ``step.backward`` (one of each a microbatch),
  ``step.grad_sync``, ``step.optimizer`` and, with an EMA, ``step.ema``;
  each span names its enclosing span and the step's unit. The feeds' spans
  sit under ``fit.wait_batch``, and ``DeviceFeed``'s producer's on its own
  thread.
* The ring holds ``CAPACITY`` records, the newest.
* Mirrored, each span is a ``user_annotation`` of a CPU profiler's trace at
  the same epoch time (``ts`` + ``baseTimeNanoseconds`` / 1000), within 2 ms.
* The ``Profiler`` callback's trace shows the spans of its window and leaves
  the state it found.
* The Runner's ``input_wait_share`` is its ``data_time_s`` over
  ``epoch_time_s``, and the ``Timer`` logs it.
"""

import collections
import copy
import glob
import json
import logging
import os
import threading

import pytest
import torch

from sota_imagenet_tpu_torch.config import parse_stages
from sota_imagenet_tpu_torch.data.device_cache import DeviceCacheFeed
from sota_imagenet_tpu_torch.data.pipeline import DeviceFeed, SyntheticLoader
from sota_imagenet_tpu_torch.losses import CrossEntropyLoss
from sota_imagenet_tpu_torch.models.cmodel import CModel
from sota_imagenet_tpu_torch.ops.augment import build_val_augment
from sota_imagenet_tpu_torch.optim import build_optimizer
from sota_imagenet_tpu_torch.train import callbacks
from sota_imagenet_tpu_torch.train.loop import Runner
from sota_imagenet_tpu_torch.train.schedule import phases_from_stages
from sota_imagenet_tpu_torch.utils import trace
from sota_imagenet_tpu_torch.utils.logging import get_logger

LAYERS = [
    {"module": "conv3x3", "args": [3, 8], "kwargs": {"stride": 2}},
    {"module": "BatchNorm2d", "args": [8]},
    {"module": "ReLU"},
    {"module": "FastGlobalAvgPool2d", "kwargs": {"flatten": True}},
    {"module": "Linear", "args": [8, 10]},
]
STEPS = 3


@pytest.fixture(autouse=True)
def _clean_spans():
    """Every test starts and ends with tracing off and an empty ring."""
    trace.restore((False, False))
    trace.take()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    trace.restore((False, False))
    trace.take()


def _runner(cbs=(), accumulate_steps=1, ema_decay=0.0):
    runner = Runner(CModel(layer_config=copy.deepcopy(LAYERS)), CrossEntropyLoss(),
                    lambda m: build_optimizer({"_target_": "sgd", "momentum": 0.9}, m.named_parameters()),
                    lr_phases=phases_from_stages(parse_stages([dict(start=0, end=2, lr=[0.1, 0.1])])),
                    input_dtype=torch.float32, device="cpu", callbacks=list(cbs),
                    accumulate_steps=accumulate_steps, ema_decay=ema_decay)
    runner.init_state(seed=0)
    return runner


def _feed(cached=False, length=STEPS):
    host = SyntheticLoader(batch_size=4, image_size=16, num_classes=10, length=length)
    aug = build_val_augment(num_classes=10, out_dtype=torch.float32)
    if cached:
        return DeviceCacheFeed(host, aug, device="cpu", fill_chunk_mb=0.01)
    return DeviceFeed(host, aug, device="cpu", prefetch=1)


def _raise(*a, **k):
    raise AssertionError("record_function entered while tracing is off")


def test_off_records_nothing_and_never_enters_record_function(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    assert trace.span("a") is trace.span("b", 7)  # one shared null context, nothing allocated
    _runner(ema_decay=0.9).fit(_feed(), epochs=1)
    assert trace.take() == []


def test_off_span_calls_nothing_of_torch(monkeypatch):
    class NoTorch:
        def __getattr__(self, name):
            raise AssertionError(f"torch.{name} called while tracing is off")

    monkeypatch.setattr(trace, "torch", NoTorch())
    with trace.span("fit.step", 3):
        pass
    assert trace.take() == []


def _by_id(spans):
    return {s.id: s for s in spans}


@pytest.mark.parametrize("accumulate_steps,ema_decay", [(1, 0.0), (2, 0.9)])
def test_every_step_has_its_spans_under_the_right_parents(accumulate_steps, ema_decay):
    runner = _runner(accumulate_steps=accumulate_steps, ema_decay=ema_decay)
    trace.enable()
    runner.fit(_feed(), epochs=1)
    trace.disable()
    spans = trace.take()
    ids = _by_id(spans)
    main = threading.get_native_id()
    steps = [s for s in spans if s.name == "fit.step"]
    assert [s.unit for s in steps] == list(range(STEPS))
    assert sorted(s.unit for s in spans if s.name == "fit.wait_batch") == list(range(STEPS))
    assert sorted(s.unit for s in spans if s.name == "fit.callbacks") == list(range(STEPS))
    (end,) = [s for s in spans if s.name == "fit.epoch_end"]
    assert end.parent is None and end.start_ns >= max(s.end_ns for s in steps)
    for step in steps:
        assert step.parent is None and step.thread == main
        inside = collections.Counter(s.name for s in spans if s.parent == step.id)
        want = {"step.forward": accumulate_steps, "step.backward": accumulate_steps, "step.grad_sync": 1,
                "step.optimizer": 1}
        if ema_decay:
            want["step.ema"] = 1
        assert inside == want
        for s in spans:
            if s.parent == step.id:
                assert s.unit == step.unit and step.start_ns <= s.start_ns <= s.end_ns <= step.end_ns
    # the consumer's side of the feed runs inside the loop's wait, on the loop's thread
    for name in ("feed.queue_wait", "feed.h2d", "feed.augment"):
        mine = [s for s in spans if s.name == name]
        assert mine and all(ids[s.parent].name == "fit.wait_batch" and s.thread == main for s in mine), name


def test_device_feeds_producer_spans_carry_its_own_thread():
    trace.enable()
    _runner().fit(_feed(), epochs=1)
    trace.disable()
    spans = trace.take()
    main = threading.get_native_id()
    host = [s for s in spans if s.name == "feed.host_batch"]
    assert len(host) == STEPS + 1  # the last one finds the loader's end
    assert len({s.thread for s in host}) == 1 and host[0].thread != main
    assert all(s.parent is None and s.unit is None for s in host)


def test_the_cache_feeds_spans():
    feed = _feed(cached=True, length=2)
    trace.enable()
    _runner().fit(feed, epochs=1, steps_per_epoch=2)
    trace.disable()
    spans = trace.take()
    ids = _by_id(spans)
    (fill,) = [s for s in spans if s.name == "feed.cache_fill"]
    assert fill.parent is None and (fill.end_ns - fill.start_ns) / 1e9 >= feed.fill_s
    for name in ("feed.gather", "feed.augment"):
        mine = [s for s in spans if s.name == name]
        assert len(mine) == 2 and all(ids[s.parent].name == "fit.wait_batch" for s in mine)
        assert sorted(s.unit for s in mine) == [0, 1]


def test_the_ring_keeps_its_capacity():
    trace.enable()
    for i in range(trace.CAPACITY + 5):
        with trace.span("x", i):
            pass
    trace.disable()
    spans = trace.take()
    assert len(spans) == trace.CAPACITY
    assert [s.unit for s in spans[:2]] == [5, 6] and spans[-1].unit == trace.CAPACITY + 4
    assert trace.take() == []


def test_mirrored_spans_sit_on_the_profilers_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    path = str(tmp_path / "t.json")
    x = torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trace.enable(mirror=True)
        for i in range(4):
            with trace.span("outer", i):
                for _ in range(3):
                    with trace.span("inner"):
                        x = torch.tanh(x @ x)
        trace.disable()
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base_us = doc["baseTimeNanoseconds"] / 1e3
    annotated = sorted((e["name"], e["ts"] + base_us, e["ts"] + e["dur"] + base_us)
                       for e in doc["traceEvents"] if e.get("cat") == "user_annotation")
    spans = sorted((s.name, s.start_ns / 1e3, s.end_ns / 1e3) for s in trace.take())
    assert len(annotated) == len(spans) == 16
    for (name, t0, t1), (sname, s0, s1) in zip(annotated, spans):
        assert name == sname
        assert abs(t0 - s0) < 2e3 and abs(t1 - s1) < 2e3, (name, t0 - s0, t1 - s1)


def test_the_profiler_callbacks_trace_shows_the_spans_and_restores_the_state(tmp_path):
    prof = callbacks.Profiler(log_dir=str(tmp_path), start_step=0, num_steps=2)
    runner = _runner([prof])
    runner.fit(_feed(length=4), epochs=1)
    assert trace.state() == (False, False)
    (path,) = glob.glob(os.path.join(tmp_path, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"fit.step", "fit.wait_batch", "step.forward", "step.backward", "step.optimizer"} <= names
    # tracing was on before the window: it stays on, unmirrored, after it
    trace.enable()
    prof2 = callbacks.Profiler(log_dir=str(tmp_path / "b"), start_step=0, num_steps=1)
    _runner([prof2]).fit(_feed(), epochs=1)
    assert trace.state() == (True, False)


def test_the_timer_logs_the_input_wait():
    lines = []
    sink = logging.Handler()
    sink.emit = lambda record: lines.append(record.getMessage())
    logger = get_logger()
    logger.addHandler(sink)
    try:
        train, _ = _runner([callbacks.Timer()]).fit(_feed(), epochs=1)
    finally:
        logger.removeHandler(sink)
    wait = train["input_wait_share"]
    assert 0.0 <= wait == train["data_time_s"] / train["epoch_time_s"] <= 1.0
    assert "input_utilization" not in train
    assert any(f"input wait {wait * 100:.1f}%" in line for line in lines), lines
