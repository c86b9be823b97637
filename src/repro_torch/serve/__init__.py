"""The serve path: the continuous-batching engine, shape buckets, and
background retunes with atomic config hot-swap."""

from .engine import (BucketedServeEngine, DEFAULT_BUCKETS, Request,
                     ServeEngine, buckets_from_env, modeled_arrival_trace,
                     resolve_kernel_configs, resolve_kernel_resolutions,
                     trace_evaluator_factory)
from .online import (BackgroundTuner, ConfigSlot, JobStatus, OnlineTuneConfig,
                     TuneJob, submit_for_resolutions)

__all__ = ["BucketedServeEngine", "DEFAULT_BUCKETS", "Request", "ServeEngine",
           "buckets_from_env", "modeled_arrival_trace",
           "resolve_kernel_configs", "resolve_kernel_resolutions",
           "trace_evaluator_factory",
           "BackgroundTuner", "ConfigSlot", "JobStatus", "OnlineTuneConfig",
           "TuneJob", "submit_for_resolutions"]
