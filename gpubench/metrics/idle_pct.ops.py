"""idle_pct.ops: the share of the traced calls' span in which no operation
ran on the device (union of the profiler's device intervals), in %."""

from gpubench.metrics_common import idle_pct as read  # noqa: F401
