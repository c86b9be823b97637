"""The port's spans and counters (``repro_torch.core.trace``) in a
``--trace 1`` run.

Recording is on in the cell's set-up, and in two more runs of its
segment after the traced one and the per-layer measurements: one alone,
whose spans the readers take (a profiler lengthens the host's spans by
microseconds an operation), and on a card one under a profiler of its
own, whose kernels are given to the spans that launched them.  The
window and the segment that ``harness.traced`` reads run with recording
off, so what every other metric reads is what it reads without this
module.

The records reach the readers through ``Readings``: each span's seconds
in ``spans[name]`` (a list, in the order the spans closed), each counter
in ``counters[name]``, set-up's under ``setup/<name>``; and the device
seconds of the kernels launched under each span name in
``trace["device_s_by_span"]`` (card runs only).
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Optional

import torch

#: the prefix of set-up's span and counter names in ``harness.Run``
SETUP = "setup/"


def recorder():
    """The port's trace module, or None where it does not import."""
    try:
        from repro_torch.core import trace
    except ImportError:
        return None
    return trace


def keep(run, records: Dict, prefix: str = "") -> None:
    """``records`` (``trace.take()``'s) into ``run.spans`` and
    ``run.counters``, each name behind ``prefix``."""
    for s in records["spans"]:
        run.spans.setdefault(prefix + s.name, []).append(
            (s.end_ns - s.start_ns) * 1e-9)
    for name, n in records["counters"].items():
        run.counters[prefix + name] = run.counters.get(prefix + name, 0) + n


def device_by_span(events, names: Iterable[str]) -> Dict[str, float]:
    """Device seconds of the kernels launched under each span of
    ``names``.  A device event counts under every span name whose host
    interval holds the start of the runtime call (``cu*``) with the same
    correlation id, on any thread: autograd issues the backward's kernels
    from a thread of its own while the caller waits inside its span.  A
    device event that bears a span's name (the profiler's annotation of
    that span on the device) is no kernel and is left out."""
    names = set(names)
    cuda = torch.autograd.DeviceType.CUDA
    host = [e for e in events if e.device_type != cuda]
    spans = [(e.time_range.start, e.time_range.end, e.name) for e in host
             if e.name in names]
    runtime = {e.id: e.time_range.start for e in host
               if e.name.startswith("cu")}
    out = dict.fromkeys(sorted(names), 0.0)
    for e in events:
        if e.device_type != cuda or e.name in names or e.id not in runtime:
            continue
        t = runtime[e.id]
        seconds = (e.time_range.end - e.time_range.start) / 1e6
        for name in {n for a, b, n in spans if a <= t <= b}:
            out[name] += seconds
    return out


def _recorded(run, trace, fn) -> Dict:
    """``fn()`` with recording on; its records."""
    run.sync()
    trace.take()
    trace.enable()
    try:
        fn()
        run.sync()
    finally:
        trace.disable()
    return trace.take()


def recorded_segment(run, cell, trace) -> Optional[Dict[str, float]]:
    """``cell.segment()`` twice more with recording on.  The first run's
    records go into ``run``: the host's spans, which a profiler would
    lengthen.  On a card the second runs under a profiler of its own and
    gives the device seconds under each span name the first recorded
    (None elsewhere); both run the same segment, so a reader may divide
    the one's seconds by the other's count of steps."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    records = _recorded(run, trace, cell.segment)
    keep(run, records)
    run.log(f"recorded segment s {time.perf_counter() - t0:.3f}: "
            f"{len(records['spans'])} spans, counters {records['counters']}")
    if run.device.type != "cuda":
        return None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _recorded(run, trace, cell.segment)
    return device_by_span(list(prof.events()),
                          {s.name for s in records["spans"]})
