"""train_bwd_ms: device milliseconds a step of the kernels launched under
the port's ``train.backward`` span (``torch.autograd.grad``; autograd's
own thread included), in the segment run again with recording on
(``gpubench/spans.py``)."""

from gpubench.metrics_common import device_ms_per_step


def read(r):
    return device_ms_per_step(r, "train.backward")
