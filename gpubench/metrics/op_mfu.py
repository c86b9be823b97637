"""op_mfu: the useful operations of the traced calls over the traced
span's seconds at the card's bf16 peak, in %."""

from gpubench import roofline


def read(r):
    flops, window = r.counters.get("segment_flops"), r.trace.get("window_s")
    if not flops or not window or "busy_s" not in r.trace:
        return None
    return 100.0 * flops / (window * roofline.PEAK_BF16_FLOPS)
