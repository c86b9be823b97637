"""Serve-path tuning: background retunes and atomic config hot-swap.

Only the online tuner is ported here; the serve engine waits for the LM
stack (ROADMAP.md, Queue 1).
"""

from .online import (BackgroundTuner, ConfigSlot, JobStatus, OnlineTuneConfig,
                     TuneJob, submit_for_resolutions)

__all__ = ["BackgroundTuner", "ConfigSlot", "JobStatus", "OnlineTuneConfig",
           "TuneJob", "submit_for_resolutions"]
