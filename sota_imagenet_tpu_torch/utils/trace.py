"""Spans: named host intervals at the port's layer boundaries, on the
profiler's clock.

``span(name, unit)`` marks what the host is doing: the train loop's wait for
a batch and its step, the step's forward, backward, gradient average,
optimizer and EMA, the feeds' gather, copy and augment, a collective, a
served request. While tracing is off (the default) it returns one shared
null context after a single flag check: nothing of torch is called and
nothing is allocated. While it is on, each span leaves a record

    Span(id, name, start_ns, end_ns, parent, unit, thread)

in an in-memory ring of ``CAPACITY`` records (the oldest dropped first).
The times are ``time.time_ns()``: the profiler's Chrome trace puts its
events on the same epoch clock (``ts`` in microseconds plus the trace's
``baseTimeNanoseconds``), so spans join a trace that recorded the device
alone. ``parent`` is the id of the enclosing open span of the same thread,
``unit`` the train step or served request the span belongs to (inherited
from the parent when not given), ``thread`` the OS thread id, as the
trace's ``tid``.

``enable(mirror=True)`` also enters ``torch.profiler.record_function(name)``
for each span, so that a profiler recording the host shows the spans
(``train/callbacks.Profiler`` does this over its window). The caller that
needs spans turns them on and off and takes them: there is no environment
variable, config key or file for it.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import List, NamedTuple, Optional, Tuple

import torch

CAPACITY = 1 << 15  # ~3 MB of records; a train step makes 9 (r50.cache) to 16 (nfnet_l0.feed)


class Span(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    unit: Optional[int]
    thread: int


_on = False
_mirror = False
_NULL = contextlib.nullcontext()
_ring: "collections.deque[Span]" = collections.deque(maxlen=CAPACITY)
_ids = itertools.count()
_local = threading.local()


class _Open:
    """A span being recorded; appended to the ring when it closes."""

    __slots__ = ("name", "unit", "id", "parent", "start", "stack", "thread", "mirrored")

    def __init__(self, name: str, unit: Optional[int]):
        self.name, self.unit = name, unit

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:  # this thread's first span: its stack, and its id once (a system call)
            stack = _local.stack = []
            _local.thread = threading.get_native_id()
        self.thread = _local.thread
        outer = stack[-1] if stack else None
        self.parent = outer.id if outer is not None else None
        if self.unit is None and outer is not None:
            self.unit = outer.unit
        self.id = next(_ids)
        self.stack = stack
        stack.append(self)
        self.mirrored = torch.profiler.record_function(self.name) if _mirror else None
        if self.mirrored is not None:
            self.mirrored.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.mirrored is not None:
            self.mirrored.__exit__(*exc)
        self.stack.pop()
        _ring.append(Span(self.id, self.name, self.start, end, self.parent, self.unit, self.thread))
        return False


def span(name: str, unit: Optional[int] = None):
    """A context manager that records the host interval it encloses as
    ``name`` while tracing is on, and does nothing otherwise."""
    if not _on:
        return _NULL
    return _Open(name, unit)


def state() -> Tuple[bool, bool]:
    """(on, mirror), for ``restore``."""
    return _on, _mirror


def restore(previous: Tuple[bool, bool]) -> None:
    global _on, _mirror
    _on, _mirror = previous


def enable(mirror: bool = False) -> Tuple[bool, bool]:
    """Turn tracing on (``mirror``: each span also a ``record_function``);
    returns the state before, for ``restore``."""
    previous = state()
    restore((True, bool(mirror)))
    return previous


def disable() -> Tuple[bool, bool]:
    """Turn tracing off; returns the state before, for ``restore``. Spans
    still open are recorded when they close."""
    previous = state()
    restore((False, False))
    return previous


def take() -> List[Span]:
    """The recorded spans, oldest first (by their closing), and an empty ring."""
    out = []
    while True:
        try:
            out.append(_ring.popleft())
        except IndexError:
            return out
