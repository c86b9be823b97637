"""op_host_us: the host clock around each op call (lookup, build lookup
and enqueue), the mean over the calls timed after the window in bursts
between synchronisations, in microseconds."""

import statistics


def read(r):
    s = r.spans.get("op_call_s")
    return statistics.fmean(s) * 1e6 if s else None
