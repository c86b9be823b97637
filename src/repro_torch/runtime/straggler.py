"""Straggler detection & mitigation hooks.

At multi-pod scale the slowest participant sets the step time.  This
monitor keeps a rolling step-time window, flags outlier steps/hosts
(robust z-score over the median absolute deviation) and drives the
mitigation policy: log -> warn -> act (checkpoint-and-evict in a real
deployment; here the action is a callback so tests can observe it).

A copy of the JAX package's monitor (pure Python).
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Callable, Deque, Dict, List, Optional


@dataclasses.dataclass
class StragglerConfig:
    window: int = 50
    #: robust z-score above which a step is an outlier
    z_threshold: float = 4.0
    #: consecutive outliers before the mitigation callback fires
    patience: int = 3
    warmup_steps: int = 10


class StragglerMonitor:
    def __init__(self, cfg: StragglerConfig = StragglerConfig(),
                 on_straggler: Optional[Callable[[Dict], None]] = None):
        self.cfg = cfg
        self.on_straggler = on_straggler
        self._times: Deque[float] = collections.deque(maxlen=cfg.window)
        self._consecutive = 0
        self._events: List[Dict] = []
        self._t0: Optional[float] = None
        self._step = 0

    # -- timing interface -------------------------------------------------------
    def step_start(self) -> None:
        self._t0 = time.perf_counter()

    def step_end(self) -> Optional[Dict]:
        assert self._t0 is not None, "step_start() not called"
        dt = time.perf_counter() - self._t0
        self._t0 = None
        return self.observe(dt)

    def observe(self, step_time: float) -> Optional[Dict]:
        """Feed one step time; returns an event dict if flagged."""
        self._step += 1
        event = None
        if (len(self._times) >= self.cfg.warmup_steps
                and self._step > self.cfg.warmup_steps):
            med = _median(self._times)
            mad = _median([abs(t - med) for t in self._times]) or 1e-9
            z = 0.6745 * (step_time - med) / mad
            if z > self.cfg.z_threshold:
                self._consecutive += 1
                event = {"step": self._step, "time": step_time,
                         "median": med, "z": z,
                         "consecutive": self._consecutive,
                         "mitigate": self._consecutive >= self.cfg.patience}
                self._events.append(event)
                if event["mitigate"] and self.on_straggler:
                    self.on_straggler(event)
                    self._consecutive = 0
            else:
                self._consecutive = 0
        self._times.append(step_time)
        return event

    @property
    def events(self) -> List[Dict]:
        return list(self._events)

    def stats(self) -> Dict[str, float]:
        if not self._times:
            return {"median": math.nan, "p90": math.nan}
        ts = sorted(self._times)
        return {"median": _median(ts),
                "p90": ts[min(len(ts) - 1, int(0.9 * len(ts)))],
                "n": float(len(ts))}


def _median(xs) -> float:
    s = sorted(xs)
    n = len(s)
    if not n:
        return math.nan
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])
