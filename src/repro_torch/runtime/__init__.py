"""Runtime: the straggler monitor.

The JAX package's ``elastic.py`` (``plan_mesh``, ``make_elastic_mesh``,
``validate_batch``) builds a device mesh and comes with the DTensor slice
(ROADMAP.md, Queue 1).
"""

from .straggler import StragglerConfig, StragglerMonitor

__all__ = ["StragglerConfig", "StragglerMonitor"]
