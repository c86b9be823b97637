"""Online serve-path autotuning: background retune + atomic config hot-swap.

CLTune's scenario 3 (optimal parameters change with input shapes) used to
end at serve start: ``resolve_kernel_configs`` ran once with the TRANSFER
policy, so a borrowed nearest-shape config was the *permanent* config for
that serving geometry even though a real search could find a strictly
better one.  Dynamic autotuners (Kernel Tuning Toolkit, arXiv:1910.08498)
close that gap by tuning *concurrently with production execution* and
swapping winners in.  This module is that loop:

* :class:`ConfigSlot` — a generation-counted, atomically-swappable holder
  for the engine's live ``kernel_configs``.  The serve loop reads one
  immutable snapshot per step, so an in-flight step can never observe a
  torn update (half old, half new).
* :class:`BackgroundTuner` — a worker thread that turns every non-exact
  resolution (provenance ``transfer``/``predicted``/``heuristic``, see
  :class:`repro_torch.core.registry.Resolution`) into a real tuning job
  driving the existing :class:`~repro_torch.core.engine.EvaluationEngine`,
  warm-started from ``cache.nearest`` seeds.  Winners are recorded into the
  :class:`~repro_torch.core.cache.TuningCache`; the cache's changed-entry
  notification then hot-swaps them into every subscribed engine — and the
  next engine for the same geometry starts with an exact hit.

Serving never blocks on tuning: jobs are queued and run on a daemon
worker, failed or aborted searches (the engine's failure taxonomy) leave
the original config in place, and the swap itself is one reference
assignment under a lock.

On the card a retune measures on the card that is serving.  A wall-clock
``evaluator_factory`` takes the per-card measurement lock of
:class:`~repro_torch.core.evaluators.WallClockEvaluator` for each
measurement, so it never times its kernels against another evaluator's
(a tuning fleet's, or a second retune's); the serving loop's own calls go
on meanwhile, unlocked.  A job resolves its profile to the tuner's own
:class:`~repro_torch.core.profiles.DeviceProfile` when the names match,
so a profile read from the card at run time keeps its limits.

The serve engine itself is not ported yet (ROADMAP.md, Queue 1); this
module needs only :mod:`repro_torch.core` and is driven directly.
"""

from __future__ import annotations

import dataclasses
import enum
import logging
import queue
import threading
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

from ..core.cache import TuningCache, default_cache, normalize_objective
from ..core.failures import EvaluationError
from ..core.profiles import DeviceProfile, get_profile, resolve_profile
from ..core.registry import Resolution, TunableKernel, resolve

log = logging.getLogger("repro_torch.serve.online")


class ConfigSlot:
    """Atomic, generation-counted holder of a ``{kernel: config}`` map.

    Readers call :meth:`read` once per step and get ``(snapshot, gen)``;
    the snapshot is a fresh shallow copy whose config dicts are never
    mutated in place, so a step that started before a swap keeps a fully
    consistent view.  Writers replace one kernel's config (or the whole
    map) under the lock and bump the generation — a reader comparing
    generations across steps detects exactly when an upgrade landed.
    """

    def __init__(self, configs: Optional[Mapping[str, Dict[str, Any]]] = None):
        self._lock = threading.Lock()
        self._configs: Dict[str, Dict[str, Any]] = {
            name: dict(cfg) for name, cfg in (configs or {}).items()}
        self._generation = 0

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    def read(self) -> Tuple[Dict[str, Dict[str, Any]], int]:
        """One consistent snapshot plus the generation that produced it."""
        with self._lock:
            return ({name: dict(cfg) for name, cfg in self._configs.items()},
                    self._generation)

    def swap(self, kernel: str, config: Mapping[str, Any]) -> int:
        """Atomically replace one kernel's config; returns the new generation.

        A no-op swap (identical config) does not bump the generation, so
        readers never see phantom upgrades.
        """
        new = dict(config)
        with self._lock:
            if self._configs.get(kernel) == new:
                return self._generation
            self._configs[kernel] = new
            self._generation += 1
            return self._generation

    def replace(self, configs: Mapping[str, Dict[str, Any]]) -> int:
        """Atomically replace the whole map; returns the new generation."""
        with self._lock:
            self._configs = {name: dict(cfg)
                             for name, cfg in configs.items()}
            self._generation += 1
            return self._generation


class JobStatus(enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    DONE = "done"          # search finished; winner recorded to the cache
    FAILED = "failed"      # search failed/aborted; original config stands


@dataclasses.dataclass
class TuneJob:
    """One queued background retune for a (kernel, shape, profile,
    objective)."""

    kernel: str
    shape: Dict[str, Any]
    profile: str
    #: provenance of the config being served meanwhile (transfer/heuristic)
    provenance: str
    #: canonical objective spec; None ≡ the default (``median_time``)
    objective: Optional[str] = None
    status: JobStatus = JobStatus.PENDING
    #: winning config, once DONE
    config: Optional[Dict[str, Any]] = None
    best_time: Optional[float] = None
    evaluations: int = 0
    error: Optional[str] = None
    #: the resolved declaration (kept so unregistered kernels tune too)
    tunable: Optional[TunableKernel] = dataclasses.field(
        default=None, repr=False)

    @property
    def key(self) -> Tuple[str, str, str, Optional[str]]:
        k = self.tunable if self.tunable is not None else resolve(self.kernel)
        return (self.kernel, k.key_for(self.shape), self.profile,
                self.objective)


@dataclasses.dataclass
class OnlineTuneConfig:
    """Knobs for :class:`BackgroundTuner` (what one background job runs)."""

    #: search strategy; None = the kernel's declared default
    strategy: Optional[str] = None
    #: evaluation budget per job; None = the kernel's declared default
    #: (serve-side jobs usually want a small explicit budget)
    budget: Optional[int] = None
    #: (kernel, shape, profile) -> Evaluator; None = per-kernel default
    evaluator_factory: Optional[Callable[..., Any]] = None
    #: EngineConfig / kwargs dict for the EvaluationEngine
    engine: Optional[Any] = None
    #: tuning objective for background searches (spec string or
    #: :class:`~repro_torch.core.metrics.Objective`); None = the default
    #: ``median_time``.  SLO-driven serving passes ``"p99_time"`` here —
    #: winners then land under objective-scoped cache keys and never
    #: shadow median-tuned entries.
    objective: Optional[Any] = None
    #: warm-start neighbour pool handed to tune_kernel (cache.nearest)
    warm_start: "bool | int" = True
    #: persistent compile-artifact store shared with the rest of the fleet
    #: (ArtifactStore instance, root directory path, or None = the
    #: REPRO_ARTIFACT_CACHE-gated process default).  With a warm store a
    #: retune skips every compile a dtune worker or earlier retune already
    #: paid for, dropping retune-to-swap latency to measure-only.
    artifact_store: Optional[Any] = None
    #: predictor for background searches — anything
    #: :func:`repro_torch.core.predict.resolve_predictor` accepts (None = the
    #: ``REPRO_PREDICTOR`` env default, normally off).  A kind string like
    #: ``"learned"`` is resolved *once per kernel* against the shared
    #: cache and reused by every subsequent job, so all retunes rank with
    #: one model trained from the fleet's merged history.
    predictor: Optional[Any] = None
    #: the device the tuner's profile defaults to: None = the card (as
    #: ``tune_kernel``); "cpu" models an H100 without one
    device: Optional[str] = None
    seed: int = 0
    #: refuse new jobs beyond this many queued-but-unstarted ones
    max_pending: int = 8


class BackgroundTuner:
    """Single-worker background tuning queue feeding a shared cache.

    ``submit`` is non-blocking and deduplicates by (kernel, shape-key,
    profile): a serving engine may resolve the same geometry every restart
    but only one search ever runs for it.  The worker drives the ordinary
    ``tune_kernel`` path — the same
    :class:`~repro_torch.core.engine.EvaluationEngine`,
    warm-started from ``cache.nearest`` — and records the winner with
    :meth:`TuningCache.record`, which fires the cache's changed-entry
    notification (the hot-swap trigger).  Failed or aborted searches record
    nothing, so the config being served stays untouched.  ``profile``
    defaults to that of ``config.device`` (the card's own, read at run
    time).
    """

    def __init__(self, cache: Optional[TuningCache] = None,
                 config: Optional[OnlineTuneConfig] = None,
                 profile: Optional[DeviceProfile] = None):
        self.cache = cache if cache is not None else default_cache()
        self.config = config or OnlineTuneConfig()
        self.profile = resolve_profile(profile, self.config.device)
        self.jobs: Dict[Tuple[str, str, str, Optional[str]], TuneJob] = {}
        self._queue: "queue.Queue[Optional[TuneJob]]" = queue.Queue()
        self._lock = threading.Lock()
        self._idle = threading.Condition(self._lock)
        self._outstanding = 0
        self._closed = False
        self._worker: Optional[threading.Thread] = None
        # per-kernel resolved predictors: a "learned" kind trains from the
        # shared cache once, then every job for that kernel reuses it
        self._predictors: Dict[str, Any] = {}

    # -- public API ------------------------------------------------------------
    def submit(self, kernel: "TunableKernel | str",
               shape: Mapping[str, Any], *,
               profile: Optional[DeviceProfile] = None,
               provenance: str = "transfer") -> Optional[TuneJob]:
        """Enqueue a retune; returns the (possibly pre-existing) job, or
        None when the tuner is closed / the pending queue is full."""
        prof = (profile or self.profile).name
        k = resolve(kernel)
        job = TuneJob(kernel=k.name, shape=dict(shape), profile=prof,
                      provenance=provenance,
                      objective=normalize_objective(self.config.objective),
                      tunable=k)
        key = job.key
        with self._lock:
            if self._closed:
                return None
            existing = self.jobs.get(key)
            if existing is not None:
                if existing.status is not JobStatus.FAILED:
                    return existing
                # a FAILED job must not pin its geometry forever (transient
                # failures, fixed declarations): the next submit retries.
                # Retry volume stays bounded — one attempt per submit call,
                # and engines submit once per construction.
                log.info("online: retrying previously failed retune %s "
                         "(%s)", key, existing.error)
            pending = sum(1 for j in self.jobs.values()
                          if j.status is JobStatus.PENDING)
            if pending >= self.config.max_pending:
                log.warning("online: dropping retune for %s (queue full, "
                            "%d pending)", key, pending)
                return None
            self.jobs[key] = job
            self._outstanding += 1
            self._ensure_worker_locked()
        self._queue.put(job)
        log.info("online: queued background retune %s shape=%s "
                 "(serving a %s config meanwhile)",
                 job.kernel, job.shape, provenance)
        return job

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted job reached a terminal status."""
        with self._idle:
            return self._idle.wait_for(lambda: self._outstanding == 0,
                                       timeout=timeout)

    def close(self, wait: bool = True,
              timeout: Optional[float] = None) -> None:
        """Stop accepting jobs; optionally wait for the queue to drain."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            worker = self._worker
        if worker is not None:
            self._queue.put(None)
            if wait:
                worker.join(timeout)

    def __enter__(self) -> "BackgroundTuner":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- worker ---------------------------------------------------------------
    def _ensure_worker_locked(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._worker_loop, name="online-tuner", daemon=True)
            self._worker.start()

    def _worker_loop(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                return
            try:
                self._run_job(job)
            except Exception as e:  # noqa: BLE001 — the worker must survive
                job.status = JobStatus.FAILED
                job.error = f"{type(e).__name__}: {e}"
                log.exception("online: retune %s crashed", job.kernel)
            finally:
                with self._idle:
                    self._outstanding -= 1
                    if self._outstanding == 0:
                        self._idle.notify_all()

    def _predictor_for(self, k, profile: DeviceProfile):
        """Resolve the configured predictor once per kernel and memoize it,
        so every background job shares one model trained from the cache."""
        if self.config.predictor is None:
            return None
        if k.name not in self._predictors:
            from ..core.predict import resolve_predictor
            try:
                self._predictors[k.name] = resolve_predictor(
                    self.config.predictor, k, profile=profile,
                    cache=self.cache, objective=self.config.objective,
                    extended=bool(k.defaults.get("extended_space", False)))
            except Exception:  # noqa: BLE001 — prediction is advisory
                log.warning("online: predictor resolution failed for %s; "
                            "tuning without one", k.name, exc_info=True)
                self._predictors[k.name] = None
        return self._predictors[k.name]

    def _run_job(self, job: TuneJob) -> None:
        from ..tune.api import tune_kernel    # late: tune layers above serve
        job.status = JobStatus.RUNNING
        cfg = self.config
        k = job.tunable if job.tunable is not None else resolve(job.kernel)
        # the tuner's own profile when the names match: a profile read from
        # the card keeps its limits (PROFILES holds datasheet entries only)
        profile = (self.profile if job.profile == self.profile.name
                   else get_profile(job.profile))
        kwargs: Dict[str, Any] = dict(
            strategy=cfg.strategy, budget=cfg.budget, seed=cfg.seed,
            engine=cfg.engine,
            warm_start=cfg.warm_start, artifact_store=cfg.artifact_store,
            objective=cfg.objective,
            predictor=self._predictor_for(k, profile))
        if cfg.evaluator_factory is not None:
            kwargs["evaluator"] = cfg.evaluator_factory(k, job.shape, profile)
        try:
            # record=False: the tuner itself decides what reaches the cache
            # — an aborted partial search must NOT hot-swap a half-searched
            # config over the one being served
            outcome = tune_kernel(k, job.shape, profile=profile,
                                  cache=self.cache, record=False, **kwargs)
        except (EvaluationError, ValueError) as e:
            job.status = JobStatus.FAILED
            job.error = f"{type(e).__name__}: {e}"
            log.warning("online: retune %s %s failed (%s); serving config "
                        "stays", job.kernel, job.shape, job.error)
            return
        aborted = outcome.result.extra.get("aborted")
        if outcome.best_config is None or aborted:
            job.status = JobStatus.FAILED
            job.error = (f"aborted: {aborted.get('reason')}" if aborted
                         else "no feasible configuration found")
            log.warning("online: retune %s %s found no winner (%s); serving "
                        "config stays", job.kernel, job.shape, job.error)
            return
        job.config = dict(outcome.best_config)
        job.best_time = outcome.best_time
        job.evaluations = outcome.result.evaluations
        # record -> cache notification -> every subscribed engine hot-swaps;
        # the outcome's objective (not cfg's raw value) keys the entry, so
        # the cache field always matches what the search actually optimized
        self.cache.record(k.name, k.key_for(job.shape), job.profile,
                          job.config, outcome.best_time,
                          outcome.result.strategy,
                          outcome.result.evaluations, shape=job.shape,
                          objective=outcome.objective)
        # merge-on-disk: other replicas retuning into the same file keep
        # their winners (best time per key) — and any better entry found
        # on disk merges back in, firing the same hot-swap subscribers
        self.cache.save(merge_on_disk=True)
        job.status = JobStatus.DONE
        log.info("online: retune %s %s done: %s (%.3g s, %d evals)",
                 job.kernel, job.shape, job.config, outcome.best_time,
                 job.evaluations)


def submit_for_resolutions(tuner: BackgroundTuner,
                           resolutions: Mapping[str, Resolution]
                           ) -> Dict[str, TuneJob]:
    """Queue a retune for every non-exact resolution; returns the jobs."""
    jobs: Dict[str, TuneJob] = {}
    for name, res in resolutions.items():
        if res.exact or res.provenance == "tuned":
            continue
        job = tuner.submit(res.kernel, res.shape, provenance=res.provenance)
        if job is not None:
            jobs[name] = job
    return jobs
