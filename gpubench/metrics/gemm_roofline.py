"""gemm_roofline: the summed least times of the traced GEMM calls
(``roofline.bound_s``) over the device time of every operation in the
traced span, whatever its name, in %."""

from gpubench.metrics_common import roofline_pct


def read(r):
    return roofline_pct(r, "gemm_layers")
