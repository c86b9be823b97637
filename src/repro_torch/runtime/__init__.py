from .elastic import (ElasticDecision, make_elastic_mesh, plan_mesh,
                      validate_batch)
from .straggler import StragglerConfig, StragglerMonitor

__all__ = ["ElasticDecision", "make_elastic_mesh", "plan_mesh",
           "validate_batch", "StragglerConfig", "StragglerMonitor"]
