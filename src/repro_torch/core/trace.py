"""Spans and counters at the port's layer boundaries, kept in memory.

    from repro_torch.core import trace
    trace.enable()
    ...                          # train steps, op calls, a search
    records = trace.take()       # {"spans": [SpanRecord, ...],
                                 #  "counters": {name: n}}; both cleared
    trace.disable()

Recording is off until :func:`enable` is called; this API is the only
switch.  While it is off, :func:`span` returns one shared object that
reads no clock and :func:`count` returns at once, so the spans can stay
on the hot paths (an op call, a train step).

A span's record is ``(name, parent, thread, start_ns, end_ns)`` on
``time.perf_counter_ns()``; ``parent`` is the name of the innermost span
open on the same thread when it was entered (None at the top), so spans
nest per thread: the tuner compiles on a thread pool.  While a
``torch.profiler`` is recording, an enabled span also enters
``record_function(name)``, so it appears among the profiler's host events
on the device trace's clock.

Span names, and the counter ``registry.lookup.<provenance>``, are the
contract with whoever reads them: ``train.step``, ``train.host_read``
(``train/trainer.py``); ``train.forward``, ``train.backward``,
``train.update`` (``dist/step.py``); ``op.matmul``,
``op.flash_attention``, ``op.conv2d`` (``kernels/*/ops.py``);
``registry.lookup`` (``core/registry.py``); ``build.load``
(``kernels/build.py``); ``kernel.launch`` (each build's ``_launch``);
``tune.inputs`` (``core/evaluators.py``); ``tune.compile``,
``tune.measure`` (``core/engine.py``).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch


class SpanRecord(NamedTuple):
    name: str
    parent: Optional[str]
    thread: int
    start_ns: int
    end_ns: int


_on = False
_lock = threading.Lock()
_spans: List[SpanRecord] = []
_counters: Dict[str, int] = {}
#: per thread: ``stack``, the names of the spans open on that thread
_open = threading.local()


class _Off:
    """What :func:`span` returns while recording is off."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


_OFF = _Off()


class Span:
    """One interval on ``perf_counter_ns``; recorded if recording was on
    when it was entered.  ``seconds`` is its length once it has exited."""

    __slots__ = ("name", "start_ns", "end_ns", "_stack", "_annotation")

    def __init__(self, name: str):
        self.name = name
        self.start_ns = self.end_ns = 0
        self._stack: Optional[List[str]] = None
        self._annotation: Any = None

    def __enter__(self) -> "Span":
        if _on:
            stack = getattr(_open, "stack", None)
            if stack is None:
                stack = _open.stack = []
            stack.append(self.name)
            self._stack = stack
            if torch.autograd._profiler_enabled():
                self._annotation = torch.autograd.profiler.record_function(
                    self.name)
                self._annotation.__enter__()
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.end_ns = time.perf_counter_ns()
        if self._annotation is not None:
            self._annotation.__exit__(exc_type, exc, tb)
            self._annotation = None
        stack = self._stack
        if stack is not None:
            self._stack = None
            stack.pop()
            record = SpanRecord(self.name, stack[-1] if stack else None,
                                threading.get_ident(), self.start_ns,
                                self.end_ns)
            with _lock:
                _spans.append(record)
        return None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def span(name: str):
    """A context manager that records ``name``'s interval while recording
    is on, and a shared no-op object while it is off."""
    if not _on:
        return _OFF
    return Span(name)


def timed(name: str) -> Span:
    """A span that reads the clock whether recording is on or not, for a
    caller that keeps its own total of the same interval."""
    return Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording is on."""
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def take() -> Dict[str, Any]:
    """The spans closed and the counters counted since the last take, in
    the order they closed; clears both."""
    global _spans, _counters
    with _lock:
        spans, _spans = _spans, []
        counters, _counters = _counters, {}
    return {"spans": spans, "counters": counters}
