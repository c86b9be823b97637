"""adamw_ms: CUDA-event milliseconds of one AdamW ``update_`` over the
cell's whole state, the median of the calls made after the window."""

import statistics


def read(r):
    ms = r.spans.get("adamw_ms")
    return statistics.median(ms) if ms else None
