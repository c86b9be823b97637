"""Tuning integration: the generic one-shot API and batch sessions.

``tune_kernel``/``TuningSession`` as in the JAX package; the distributed
and sharding tuners wait for their port (ROADMAP.md, Queue 1).
"""

from .api import TuningSession, tune_kernel, warm_start_seeds

__all__ = ["TuningSession", "tune_kernel", "warm_start_seeds"]
