"""idle_pct.train: the share of the traced steps' span in which no
operation ran on the device (union of the profiler's device intervals),
in %."""

from gpubench.metrics_common import idle_pct as read  # noqa: F401
