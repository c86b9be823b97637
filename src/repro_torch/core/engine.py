"""Parallel evaluation engine: batch, overlap, deduplicate, prune.

CLTune evaluates one configuration at a time: compile, run, repeat — so
wall-clock cost, not strategy quality, bounds the search-space sizes the
paper can explore.  This engine decouples the two halves of an evaluation:

* **compilation** (``Evaluator.prepare``) is embarrassingly parallel and
  runs on a worker pool, overlapped across a whole batch of candidates;
* **measurement** (``Evaluator.measure``) stays strictly serialized, so
  timing samples never contend with each other or with compilation of
  *other* candidates' artifacts only — never the measured one.

Candidates arrive in batches through the strategies' ask/tell drivers
(:mod:`repro_torch.core.strategies`): generation-based strategies (PSO,
evolutionary, random, full) yield whole populations per ask, while
inherently sequential walks (simulated annealing, greedy descent) run
through a thread-bridged fallback one config per ask — optionally with
*speculative* neighbour prefetch, which warms the compile pool with the
configurations the walk is most likely to ask next.

Three further throughput levers:

* a per-run **memo** keyed on the canonical config key answers repeat
  configurations without recompiling or remeasuring (populations revisit
  their global best constantly);
* the **persistent artifact store** (:mod:`repro_torch.core.artifacts`): when
  the evaluator has one attached, ``prepare`` answers from disk across
  runs/processes; the engine tracks the provenance of every
  :class:`~repro_torch.core.artifacts.CompiledArtifact` it receives and
  reports store hits as ``EngineStats.artifact_hits`` (with
  ``compiles_avoided = memo_hits + artifact_hits`` derived);
* **early-stop pruning** hands the measurement phase a threshold of
  ``prune_factor × incumbent``; once a candidate's running median exceeds
  it, the remaining repeats are aborted (the candidate already lost).
  The incumbent itself can never be pruned: anything at least as fast
  keeps its running median below the threshold.

**Failure isolation** (CLTune §III: failing configurations are tolerated):
any per-config exception — compile error, lowering error, runtime OOM,
timeout, verification mismatch — is caught at the future boundary and
converted into an ``inf``-time trial carrying a structured
:class:`~repro_torch.core.failures.FailureRecord`; the search continues.  A
:class:`~repro_torch.core.failures.RetryPolicy` re-attempts transient failures,
and a ``max_failures`` circuit-breaker aborts the run gracefully (keeping
every measurement already taken) once the space looks systematically
broken.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import trace
from .artifacts import CompiledArtifact
from .evaluators import Evaluator, KernelSpec, Measurement
from .failures import (CircuitBreakerTripped, CompileError, FailureRecord,
                       RetryPolicy, summarize_failures)
from .metrics import Objective, default_objective
from .space import Config, SearchSpace
from .strategies import SearchResult, Strategy, Trial, accepts_kwarg

log = logging.getLogger("repro_torch.engine")


def _default_workers() -> int:
    """Compile-pool width that leaves headroom for the measurement thread.

    Wall-clock timing samples run while the pool compiles *other*
    candidates; on small CI runners that contention would distort
    medians, so the default reserves two cores for measurement and never
    exceeds four compile threads (2-core runner -> 1, i.e. fully serial).
    """
    return max(1, min(4, (os.cpu_count() or 2) - 2))


@dataclasses.dataclass
class EngineConfig:
    """Knobs for one EvaluationEngine run."""

    #: compile-pool width; 1 disables the pool (fully serial compiles);
    #: None = auto (min(4, cores - 2), clamped to >= 1)
    workers: Optional[int] = None
    #: use the strategies' native batched drivers; False forces the
    #: sequential fallback for every strategy (debug / equivalence runs)
    batching: bool = True
    #: early-stop threshold factor k (prune once running median exceeds
    #: k × incumbent); None disables pruning
    prune_factor: Optional[float] = None
    #: for batch-of-1 strategies, pre-compile up to this many neighbours
    #: of the asked config while its measurement runs; 0 disables
    speculate: int = 0
    #: retry policy for failed evaluations: a RetryPolicy, an int
    #: (max_retries shorthand), a kwargs dict, or None (no retries)
    retry: "RetryPolicy | int | Dict[str, Any] | None" = None
    #: circuit-breaker: abort the search once this many *distinct* configs
    #: have failed (None = never abort; failures stay isolated trials).
    #: Size it relative to the budget — it exists to catch spaces that are
    #: systematically broken (bad spec, wrong shapes), not hostile ones.
    max_failures: Optional[int] = None
    #: cooperative cancellation: any object with ``is_set() -> bool``
    #: (threading/multiprocessing Event).  Checked between batches; when
    #: set, the run stops gracefully and returns the partial result
    #: (``extra["aborted"]["stopped"] = True``) — the distributed
    #: coordinator uses this to reel in workers early.
    stop_event: Optional[Any] = None
    #: what the search minimizes: an :class:`~repro_torch.core.metrics.Objective`,
    #: a spec string (``"p99_time"``, ``"0.7*median_time+0.3*p99_time"``)
    #: or None for the session default (the ``REPRO_OBJECTIVE`` env spec
    #: when set, else ``median_time`` — the legacy scalar path,
    #: trial-identical to pre-objective behavior)
    objective: "Objective | str | None" = None
    #: optional :class:`~repro_torch.core.predict.Predictor` instance.
    #: When set, every strategy ``ask()`` batch is ranked predictor-first
    #: (best predicted config compiles/measures first), and — with
    #: ``predict_prune`` — predicted-infeasible configs are answered
    #: ``inf`` without compiling.  None (the default) leaves every search
    #: trial-identical to the predictor-less engine.
    predictor: Optional[Any] = None
    #: prune predicted-infeasible configs before compile.  None defers to
    #: the REPRO_PREDICT_PRUNE env knob (strict bool, default off) when a
    #: predictor is set, else off
    predict_prune: Optional[bool] = None
    #: pruning guard: the top ``predict_survivors`` fraction of each
    #: ranked batch (at least one config) is never pruned, whatever the
    #: infeasibility head claims
    predict_survivors: float = 0.5
    #: prune a config when the predictor's feasibility probability falls
    #: below this threshold
    predict_threshold: float = 0.5
    #: optional *proven*-infeasibility checker (``config -> [violations]``,
    #: e.g. :func:`repro_torch.analyze.proven_checker`): configs with a
    #: non-empty violation list are answered ``inf`` without compiling.
    #: Unlike ``predict_prune`` this is a static proof (declared shared
    #: memory and threads against the device limits), so there is no
    #: survivor-fraction hedge — a proof needs none.  None (default)
    #: leaves every search trial-identical to the checker-less engine.
    proven_checker: Optional[Callable[[Config], List[str]]] = None

    def __post_init__(self):
        if self.workers is None:
            self.workers = _default_workers()
        if self.workers < 1:
            raise ValueError("workers must be >= 1")
        if self.prune_factor is not None and self.prune_factor < 1.0:
            raise ValueError("prune_factor must be >= 1 (or None)")
        self.retry = RetryPolicy.normalize(self.retry)
        if self.max_failures is not None and self.max_failures < 1:
            raise ValueError("max_failures must be >= 1 (or None)")
        # None defers to the session default (REPRO_OBJECTIVE env spec when
        # set, else median_time) at construction time
        self.objective = (default_objective() if self.objective is None
                          else Objective.coerce(self.objective))
        if self.predict_prune is None and self.predictor is not None:
            # pruning is meaningless without a predictor, so the env knob
            # is only consulted once one is attached — a later
            # dataclasses.replace(engine, predictor=...) re-runs this and
            # picks the knob up; until then None stays (falsy = off)
            from .predict import predict_prune_default
            self.predict_prune = predict_prune_default()
        if not (0.0 < self.predict_survivors <= 1.0):
            raise ValueError("predict_survivors must be in (0, 1]")
        if not (0.0 <= self.predict_threshold <= 1.0):
            raise ValueError("predict_threshold must be in [0, 1]")
        if self.proven_checker is not None \
                and not callable(self.proven_checker):
            raise TypeError("proven_checker must be callable "
                            "(config -> list of violations) or None")


@dataclasses.dataclass
class EngineStats:
    """Observability record for one engine run (serialized into results)."""

    evaluations: int = 0            # configs told back to the strategy
    unique_configs: int = 0         # distinct configs actually evaluated
    memo_hits: int = 0              # evaluations answered from the memo
    compile_calls: int = 0          # prepare() calls (incl. speculative)
    artifact_hits: int = 0          # prepares answered by the persistent
                                    # artifact store (provenance "store")
    speculative_compiles: int = 0
    speculative_hits: int = 0       # speculated artifacts later consumed
    pruned: int = 0                 # measurements aborted by early stop
    predicted_pruned: int = 0       # configs answered inf by the predictor's
                                    # infeasibility head, never compiled
    proven_pruned: int = 0          # configs answered inf by a static
                                    # resource *proof* (repro_torch.analyze),
                                    # never compiled; no survivor guard
    predictor_rank_used: int = 0    # ask() batches reordered by the predictor
    compile_failures: int = 0       # distinct configs failed in prepare
    measure_failures: int = 0       # distinct configs failed in measure
    retries: int = 0                # extra evaluation attempts made
    aborted: bool = False           # circuit-breaker stopped the search
    batches: int = 0
    max_batch: int = 0
    compile_total_s: float = 0.0    # sum of per-config compile durations
                                    # (the ``tune.compile`` spans' clock)
    compile_wait_s: float = 0.0     # wall time the serial loop blocked on
                                    # compile futures
    measure_total_s: float = 0.0    # the ``tune.measure`` spans' clock
    wall_s: float = 0.0

    @property
    def compile_overlap_ratio(self) -> float:
        """Fraction of total compile seconds hidden behind other work.

        0.0 = fully serial (every compile second was waited for);
        approaching 1.0 = compilation fully overlapped with measurement
        and other compiles.
        """
        if self.compile_total_s <= 0:
            return 0.0
        hidden = max(0.0, self.compile_total_s - self.compile_wait_s)
        return hidden / self.compile_total_s

    @property
    def compiles_avoided(self) -> int:
        """Evaluations that skipped compilation entirely: answered by the
        per-run memo or by the persistent artifact store."""
        return self.memo_hits + self.artifact_hits

    def as_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["compiles_avoided"] = self.compiles_avoided
        d["compile_overlap_ratio"] = round(self.compile_overlap_ratio, 4)
        for k in ("compile_total_s", "compile_wait_s", "measure_total_s",
                  "wall_s"):
            d[k] = round(d[k], 6)
        return d


class EvaluationEngine:
    """Batched, overlapped, memoised, pruning evaluation of one kernel.

    Usage (what ``Tuner.tune`` does internally)::

        engine = EvaluationEngine(evaluator, spec, space, EngineConfig())
        result = engine.run(make_strategy("pso"), budget=200, seed=0)
        result.extra["engine"]          # EngineStats dict
        result.extra.get("failures")    # failure summary, when any occurred
        engine.measurements             # config_key -> Measurement
        engine.failures                 # config_key -> FailureRecord
    """

    def __init__(self, evaluator: Evaluator, spec: KernelSpec,
                 space: SearchSpace,
                 config: Optional[EngineConfig] = None):
        self.evaluator = evaluator
        self.spec = spec
        self.space = space
        self.config = config or EngineConfig()
        #: per-run memo: canonical config key -> Measurement
        self.measurements: Dict[Tuple, Measurement] = {}
        #: canonical config key -> FailureRecord for every failed config
        self.failures: Dict[Tuple, FailureRecord] = {}
        self.stats = EngineStats()
        self._incumbent = math.inf
        #: (config, time) in tell order — the source for partial results
        self._history: List[Tuple[Config, float]] = []

    # -- internals -----------------------------------------------------------
    def _timed_prepare(self, config: Config) -> Tuple[Any, float]:
        with trace.timed("tune.compile") as clock:
            prepared = self.evaluator.prepare(self.spec, config)
        return prepared, clock.seconds

    def _submit(self, pool: Optional[ThreadPoolExecutor],
                config: Config) -> "Future":
        self.stats.compile_calls += 1
        if pool is None:
            # inline compile blocks the serial loop: all of it is wait time
            fut: Future = Future()
            try:
                result = self._timed_prepare(config)
                self.stats.compile_wait_s += result[1]
                fut.set_result(result)
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)
            return fut
        return pool.submit(self._timed_prepare, config)

    def _speculate(self, pool: Optional[ThreadPoolExecutor],
                   config: Config,
                   in_flight: Dict[Tuple, Future],
                   speculative: set) -> None:
        """Warm the pool with likely-next configs (neighbours of ``config``)."""
        budget = self.config.speculate
        if budget <= 0 or pool is None:
            return
        for nbr in self.space.neighbours(config):
            if budget <= 0:
                break
            key = self.space.config_key(nbr)
            if key in self.measurements or key in in_flight:
                continue
            in_flight[key] = self._submit(pool, nbr)
            speculative.add(key)
            self.stats.speculative_compiles += 1
            budget -= 1

    # -- failure-isolated evaluation of one config ---------------------------
    def _evaluate_config(self, config: Config, key: Tuple,
                         fut: "Future",
                         ) -> Tuple[Measurement, Optional[FailureRecord]]:
        """prepare + measure one config; exceptions become FailureRecords.

        This is the fault boundary: whatever an evaluator raises — typed
        :class:`~repro_torch.core.failures.EvaluationError`\\ s from the built-ins,
        bare exceptions from user evaluators, exceptions re-raised from the
        compile pool's future — ends here as an ``inf`` Measurement plus a
        structured FailureRecord, never as a crashed search.  The retry
        policy re-attempts failures it classifies as transient; retries
        recompile inline (the pooled artifact is gone).
        """
        cfg = self.config
        attempts = 0
        prepared = None
        have_artifact = False
        while True:
            attempts += 1
            stage = "prepare"
            try:
                if not have_artifact:
                    if fut is not None:
                        t_wait0 = time.perf_counter()
                        try:
                            prepared, compile_s = fut.result()
                        finally:
                            self.stats.compile_wait_s += (time.perf_counter()
                                                          - t_wait0)
                            fut = None  # a retry must recompile, not re-read
                    else:   # retry: the pooled compile already failed us
                        self.stats.compile_calls += 1
                        prepared, compile_s = self._timed_prepare(config)
                    self.stats.compile_total_s += compile_s
                    if isinstance(prepared, Measurement) and not prepared.ok:
                        # legacy evaluators signal compile failure by
                        # returning a failed Measurement instead of raising
                        raise CompileError(prepared.error
                                           or "prepare() reported failure")
                    if (isinstance(prepared, CompiledArtifact)
                            and prepared.from_store):
                        self.stats.artifact_hits += 1
                    have_artifact = True
                stage = "measure"
                threshold = None
                # measure-level pruning compares a *running median* of
                # samples against the threshold — that statistic only
                # matches the default (median_time) objective.  Tail
                # objectives need the full sample vector, so pruning is
                # disabled for them (the incumbent is in objective units,
                # not median seconds).
                if (cfg.prune_factor is not None
                        and cfg.objective.is_default
                        and math.isfinite(self._incumbent)):
                    threshold = cfg.prune_factor * self._incumbent
                clock = trace.timed("tune.measure")
                try:
                    with clock:
                        m = self.evaluator.measure(
                            self.spec, config, prepared,
                            prune_threshold_s=threshold)
                finally:
                    self.stats.measure_total_s += clock.seconds
                if not m.ok:
                    # legacy not-ok Measurement: a failure trial, not a
                    # crash.  Coerce the objective to inf — a not-ok
                    # result with a finite time must never win the search
                    # or reach the tuned-config cache.
                    if math.isfinite(m.time_s):
                        m = dataclasses.replace(m, time_s=math.inf)
                    return m, FailureRecord(
                        stage="measure", error_type="FailedMeasurement",
                        message=(m.error or "measurement reported not-ok"),
                        config_key=key, attempts=attempts)
                return m, None
            except Exception as e:  # noqa: BLE001 — the fault boundary
                if self.config.retry.should_retry(e, attempts):
                    self.stats.retries += 1
                    if stage == "prepare":
                        have_artifact = False   # recompile on the retry
                    # measure-stage retries reuse the valid artifact: the
                    # compile succeeded, only the timing run misbehaved
                    continue
                record = FailureRecord.from_exception(
                    e, stage=stage, config_key=key, attempts=attempts)
                return (Measurement(time_s=math.inf, ok=False,
                                    error=str(e)[:500]), record)

    def _record_failure(self, key: Tuple, record: FailureRecord) -> None:
        self.failures[key] = record
        if record.stage == "measure":
            self.stats.measure_failures += 1
        else:
            self.stats.compile_failures += 1
        limit = self.config.max_failures
        if limit is not None and len(self.failures) >= limit:
            raise CircuitBreakerTripped(len(self.failures),
                                        self.stats.evaluations, limit)

    def _partial_result(self, strategy: Strategy,
                        aborted: Dict[str, Any]) -> SearchResult:
        """Synthesize a SearchResult from the evaluations already told.

        The driver may be mid-generation (or, for the thread-bridged
        sequential fallback, mid-``run``) when the breaker trips or a
        stop is requested, so the engine's own tell-order history — not
        the driver — is the source of truth for an aborted search.
        """
        trials = [Trial(config=c, time=t, index=i)
                  for i, (c, t) in enumerate(self._history)]
        best = None
        for t in trials:
            if t.ok and (best is None or t.time < best.time):
                best = t
        return SearchResult(strategy.name, trials, best, len(trials),
                            extra={"aborted": aborted})

    def _score(self, m: Measurement) -> float:
        """Scalarize one measurement under the configured objective.

        The default objective reads the legacy scalar directly — trials
        stay byte-identical to pre-objective behavior (``time_s`` *is*
        the median).  Non-default objectives scalarize the structured
        metrics; failed or metrics-free measurements score ``inf``.
        """
        obj = self.config.objective
        if obj.is_default:
            return m.time_s
        if not m.ok:
            return math.inf
        return obj.scalarize(m.as_metrics())

    def _proven_gate(self, batch: List[Config]
                     ) -> Tuple[List[Config],
                                List[Tuple[Config, float]]]:
        """Answer provably-infeasible configs ``inf`` without compiling.

        Driven by ``EngineConfig.proven_checker`` (a static resource
        proof, e.g. a declared shared-memory footprint vs the device
        budget — see :mod:`repro_torch.analyze`).  Unlike :meth:`_predictor_gate` there is
        no survivor-fraction guard and no threshold: a proof needs no
        hedge, and because the analytical/compile path scores the same
        configs ``inf`` anyway, pruning them cannot change the winner —
        it only skips their compiles.  Memo-hit configs pass through
        (answering from the memo is already compile-free), and a
        checker that raises proves nothing: the config passes.
        """
        checker = self.config.proven_checker
        if checker is None or not batch:
            return batch, []
        survivors: List[Config] = []
        pruned: List[Tuple[Config, float]] = []
        for config in batch:
            key = self.space.config_key(config)
            if key not in self.measurements:
                try:
                    violations = checker(config)
                except Exception:  # noqa: BLE001 — a proof must not break
                    log.debug("proven_checker raised; config passes",
                              exc_info=True)
                    violations = []
                if violations:
                    self.stats.proven_pruned += 1
                    self.stats.evaluations += 1
                    pruned.append((config, math.inf))
                    self._history.append((dict(config), math.inf))
                    continue
            survivors.append(config)
        return survivors, pruned

    def _predictor_gate(self, batch: List[Config]
                        ) -> Tuple[List[Config],
                                   List[Tuple[Config, float]]]:
        """Rank an ask() batch predictor-first, optionally pruning.

        Returns ``(survivors, pruned_results)``: survivors in predicted-
        best-first order, and pruned configs as ready ``(config, inf)``
        tell entries that never reach the compile pool.  The guard keeps
        the top ``predict_survivors`` fraction (>= 1 config) and every
        memo-hit config unconditionally, so pruning can only ever drop
        low-ranked fresh configs.  A predictor failure is logged and the
        batch passes through untouched — prediction must never break a
        search.
        """
        cfg = self.config
        pred = cfg.predictor
        if pred is None or not batch:
            return batch, []
        shape = dict(self.spec.meta or {})
        profile = getattr(self.evaluator, "profile", None)
        try:
            scores = list(pred.rank(list(batch), shape, profile))
            if len(scores) != len(batch):
                raise ValueError(f"predictor returned {len(scores)} scores "
                                 f"for {len(batch)} configs")
        except Exception:  # noqa: BLE001 — predictors are advisory only
            log.debug("predictor rank failed; batch passes through",
                      exc_info=True)
            return batch, []
        order = sorted(range(len(batch)), key=lambda i: (scores[i], i))
        ranked = [batch[i] for i in order]
        self.stats.predictor_rank_used += 1
        if not cfg.predict_prune or len(ranked) <= 1:
            return ranked, []
        keep = max(1, math.ceil(cfg.predict_survivors * len(ranked)))
        survivors: List[Config] = []
        pruned: List[Tuple[Config, float]] = []
        for pos, config in enumerate(ranked):
            key = self.space.config_key(config)
            if pos < keep or key in self.measurements:
                survivors.append(config)
                continue
            try:
                p = float(pred.feasible(config, shape, profile))
            except Exception:  # noqa: BLE001
                p = 1.0
            if p < cfg.predict_threshold:
                self.stats.predicted_pruned += 1
                self.stats.evaluations += 1
                pruned.append((config, math.inf))
                self._history.append((dict(config), math.inf))
            else:
                survivors.append(config)
        return survivors, pruned

    def _attach_failures(self, result: SearchResult) -> None:
        """Give every failed trial its FailureRecord (by config identity)."""
        if not self.failures:
            return
        for trial in result.trials:
            if trial.failure is None and not trial.ok:
                trial.failure = self.failures.get(
                    self.space.config_key(trial.config))

    def _attach_metrics(self, result: SearchResult) -> None:
        """Give every trial its structured Metrics (by config identity),
        mirroring :meth:`_attach_failures` — strategies' tell streams stay
        scalar; the full vectors ride on the result."""
        for trial in result.trials:
            if trial.metrics is None:
                m = self.measurements.get(
                    self.space.config_key(trial.config))
                if m is not None:
                    trial.metrics = m.as_metrics()

    # -- the run loop --------------------------------------------------------
    def run(self, strategy: Strategy, budget: Optional[int],
            seed: int = 0,
            seeds: Optional[List[Config]] = None) -> SearchResult:
        """Run one search.  ``seeds`` are warm-start candidates (transferred
        nearest-shape winners, heuristics) handed to the strategy's driver;
        infeasible seeds are dropped there, and a seedless call is
        byte-identical to the pre-warm-start behaviour."""
        cfg = self.config
        t_run0 = time.perf_counter()
        kwargs: Dict[str, Any] = {"seed": seed}
        if cfg.batching:
            # user strategies may override asktell with the pre-warm-start
            # signature; their searches simply run cold
            if seeds and accepts_kwarg(strategy.asktell, "seeds"):
                kwargs["seeds"] = seeds
            driver = strategy.asktell(self.space, budget, **kwargs)
        else:   # force the sequential fallback regardless of strategy type
            if seeds:
                kwargs["seeds"] = seeds     # base asktell always takes them
            driver = Strategy.asktell(strategy, self.space, budget, **kwargs)
        pool = (ThreadPoolExecutor(max_workers=cfg.workers,
                                   thread_name_prefix="engine-compile")
                if cfg.workers > 1 else None)
        in_flight: Dict[Tuple, Future] = {}
        speculative: set = set()
        # per-run state: the memo, failure map and stats are documented as
        # one run's record (readable after run() returns); a second run on
        # the same engine starts clean — carried-over failures would trip
        # the circuit breaker on the first fresh failure
        self.measurements = {}
        self.failures = {}
        self.stats = EngineStats()
        self._incumbent = math.inf
        self._history = []
        aborted: Optional[Dict[str, Any]] = None
        try:
            while aborted is None:
                if cfg.stop_event is not None and cfg.stop_event.is_set():
                    # cooperative cancellation: finish with what we have
                    self.stats.aborted = True
                    aborted = {"reason": "stop requested",
                               "failures": len(self.failures),
                               "stopped": True}
                    break
                batch = driver.ask()
                if not batch:
                    break
                self.stats.batches += 1
                self.stats.max_batch = max(self.stats.max_batch, len(batch))
                # 0. proven-infeasible first (static resource proof, no
                #    hedge), then predictor ranking/pruning on the rest
                batch, proven_pruned = self._proven_gate(batch)
                batch, pre_pruned = self._predictor_gate(batch)
                pre_pruned = proven_pruned + pre_pruned
                keys = [self.space.config_key(c) for c in batch]
                # 1. launch compiles for every fresh config in the batch
                for config, key in zip(batch, keys):
                    if key in self.measurements or key in in_flight:
                        continue
                    in_flight[key] = self._submit(pool, config)
                # 2. speculative prefetch for sequential (batch-of-1) walks
                if len(batch) == 1 and keys[0] not in self.measurements:
                    self._speculate(pool, batch[0], in_flight, speculative)
                # 3. serialized measurement, memo-first, in batch order
                results = list(pre_pruned)
                for config, key in zip(batch, keys):
                    failure = None
                    if key in self.measurements:
                        m = self.measurements[key]
                        self.stats.memo_hits += 1
                    else:
                        if key in speculative:
                            speculative.discard(key)
                            self.stats.speculative_hits += 1
                        m, failure = self._evaluate_config(
                            config, key, in_flight.pop(key))
                        self.measurements[key] = m
                        self.stats.unique_configs += 1
                        if m.pruned:
                            self.stats.pruned += 1
                    self.stats.evaluations += 1
                    score = self._score(m)
                    if m.ok and score < self._incumbent:
                        self._incumbent = score
                    results.append((config, score))
                    self._history.append((dict(config), float(score)))
                    if failure is not None:
                        try:
                            self._record_failure(key, failure)
                        except CircuitBreakerTripped as t:
                            aborted = {"reason": str(t),
                                       "failures": len(self.failures),
                                       "max_failures": t.limit}
                            self.stats.aborted = True
                            break
                # a partial tell (breaker mid-batch) is fine: every driver
                # accepts fewer results than it asked for
                if results:
                    driver.tell(results)
            if aborted is None:
                result = driver.result()
            else:
                result = self._partial_result(strategy, aborted)
        finally:
            driver.close()
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)
        self.stats.wall_s = time.perf_counter() - t_run0
        self._attach_failures(result)
        self._attach_metrics(result)
        result.objective = self.config.objective.spec
        result.extra["engine"] = self.stats.as_dict()
        if self.failures:
            result.extra["failures"] = summarize_failures(
                list(self.failures.values()))
        return result
