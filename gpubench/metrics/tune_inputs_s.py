"""tune_inputs_s: host seconds set-up's search spends drawing operands and
the reference (the port's ``tune.inputs`` spans, summed)."""

from gpubench.spans import SETUP


def read(r):
    found = r.spans.get(SETUP + "tune.inputs")
    return sum(found) if found else None
