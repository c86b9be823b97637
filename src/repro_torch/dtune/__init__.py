"""Distributed tuning plane: sharded multi-worker search + fleet merge.

CLTune-scale spaces (the paper's GEMM case study exceeds 200k
configurations) outgrow one evaluation process, and a fleet of serving
replicas should not each re-tune the same shapes alone.  This package
splits one search across N workers and folds the results back into the
single shared :class:`~repro_torch.core.cache.TuningCache`:

* :func:`shard_space` / :class:`Shard` — strided exact partitioning for
  exhaustive search, or an islands model (per-worker strategy + seed);
* :class:`TuningWorker` / :func:`run_workers` — one shard through the
  standard ``Tuner`` → ``EvaluationEngine`` stack, thread or process
  (spawn) driver, a failing config contained as a trial;
* :class:`DistributedTuner` — the coordinator: shard, fan out, merge
  private caches (best-finite-time-per-key), publish via merge-on-disk
  save so concurrent fleets converge on one ``tuned_configs.json``.
"""

from .coordinator import (DistributedOutcome, DistributedTuner, ENV_DRIVER,
                          ENV_MODE, ENV_WORKERS)
from .partition import ISLAND_STRATEGIES, Shard, shard_space
from .worker import TuningWorker, WorkerResult, WorkerSpec, run_workers

__all__ = [
    "DistributedOutcome", "DistributedTuner",
    "ENV_DRIVER", "ENV_MODE", "ENV_WORKERS",
    "ISLAND_STRATEGIES", "Shard", "shard_space",
    "TuningWorker", "WorkerResult", "WorkerSpec", "run_workers",
]
