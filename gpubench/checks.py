"""The comparisons that decide ``correct``: each reduces what the timed
path produced and what the reference computed to one number, which the
run prints beside the limit in the cell's file.  A number above its limit,
or not finite, makes the run not correct."""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Optional

import torch


def loss_gap(program: Iterable[float], reference: Iterable[float]) -> float:
    """The worst step's |program loss - reference loss| / |reference|."""
    return max(abs(a - b) / abs(b) for a, b in zip(program, reference,
                                                   strict=True))


def leaf_gap(program: Dict[str, float], reference: Dict[str, float],
             leaves: Optional[Iterable[str]] = None) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the reference's norm of that leaf or of the median leaf, whichever
    is larger (some leaves' norms are all but zero)."""
    keys = list(reference if leaves is None else leaves)
    if set(program) != set(reference):
        return math.inf
    floor = statistics.median(reference.values())
    return max(abs(program[k] - reference[k]) / max(reference[k], floor)
               for k in keys)


def moving_leaves(grad: Dict[str, float], share: float = 1e-3):
    """The leaves whose reference gradient is at least ``share`` of the
    median leaf's: the others move under AdamW by round-off alone."""
    floor = share * statistics.median(grad.values())
    return [k for k, g in grad.items() if g >= floor]


def row_error(out: torch.Tensor, ref: torch.Tensor,
              rows_per_block: int = 4096) -> float:
    """max over rows of max |out - ref| / rms(ref row), rows being the
    last dim's vectors; computed a block of rows at a time in float32."""
    o, r = out.reshape(-1, out.shape[-1]), ref.reshape(-1, ref.shape[-1])
    worst = 0.0
    for i in range(0, o.shape[0], rows_per_block):
        ob, rb = o[i:i + rows_per_block].float(), r[i:i + rows_per_block].float()
        rms = rb.square().mean(-1).sqrt().clamp(min=1e-30)
        err = (ob - rb).abs().amax(-1) / rms
        if not torch.isfinite(err).all():
            return math.inf
        worst = max(worst, float(err.max()))
    return worst


def judge(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number compared finite and within its limit."""
    return set(values) == set(limits) and all(
        math.isfinite(v) and v <= limits[k] for k, v in values.items())
