"""train_mfu: the model operations of the window's steps over the
window's seconds at the card's bf16 peak, in %."""

from gpubench import roofline


def read(r):
    steps, seconds = r.window.get("steps"), r.window.get("seconds")
    flops = r.counters.get("step_flops")
    if not steps or not seconds or flops is None:
        return None
    return 100.0 * flops * steps / (seconds * roofline.PEAK_BF16_FLOPS)
