"""Arithmetic that more than one per-layer reader shares."""


def idle_pct(r):
    """100 x (1 - busy / span) of the traced segment; None without a
    device trace."""
    busy, window = r.trace.get("busy_s"), r.trace.get("window_s")
    if busy is None or not window:
        return None
    return 100.0 * (1.0 - busy / window)


def roofline_pct(r, driver: str):
    """The traced calls' summed bound over all device time in the span,
    for a cell run by ``driver``; None elsewhere or without device time."""
    bound, device = r.counters.get("segment_bound_s"), r.trace.get("device_s")
    if r.driver != driver or not bound or not device:
        return None
    return 100.0 * bound / device


def device_ms_per_step(r, span: str):
    """Device ms a step of the kernels launched under ``span`` in the
    recorded segment (``gpubench/spans.py``); None without a device trace,
    a recorded step or a kernel under it."""
    steps = len(r.spans.get("train.step", ()))
    seconds = r.trace.get("device_s_by_span", {}).get(span)
    if not steps or not seconds:
        return None
    return seconds * 1e3 / steps
