"""train_issue_ms: host milliseconds the trainer takes to issue a step,
the median over the recorded segment's steps of ``train.step`` less its
``train.host_read`` (one a step, the wait for the device's metrics)."""

import statistics


def read(r):
    steps = r.spans.get("train.step")
    reads = r.spans.get("train.host_read")
    if not steps or not reads or len(steps) != len(reads):
        return None
    return statistics.median((s - h) * 1e3 for s, h in zip(steps, reads))
