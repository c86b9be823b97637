"""flash_roofline: the summed least times of the traced flash-attention
calls (``roofline.bound_s``, causal operations 4 D H S(S+1)/2) over the
device time of every operation in the traced span, in %."""

from gpubench.metrics_common import roofline_pct


def read(r):
    return roofline_pct(r, "flash_layers")
