"""One-shot tuning API on top of the tunable-kernel registry.

Replaces the per-kernel ``tune_matmul`` / ``tune_conv2d`` /
``tune_flash_attention`` entry points with two generic ones:

    # tune one kernel for one shape (CLTune's Tune(), shape-keyed)
    outcome = tune_kernel("gemm", {"M": 2048, "N": 2048, "K": 2048},
                          strategy="annealing", budget=100)

    # batch-tune every registered kernel for a device profile into ONE cache
    session = TuningSession(profile=device_profile())
    outcomes = session.run()

``TuningSession`` is the device bring-up story: point it at a profile,
let it sweep each kernel's declared ``default_shapes`` (or an explicit
work-list built with ``add``), and ship the single resulting
``tuned_configs.json`` with the binary.

Where no profile is given, it is the profile of the device the evaluator
measures on (the current CUDA device by default).
``tune_kernel_distributed`` shards one search over a fleet of workers
(:mod:`repro_torch.dtune`).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Optional, Sequence

from ..core.artifacts import ArtifactStore
from ..core.cache import TuningCache, default_cache
from ..core.engine import EngineConfig
from ..core.evaluators import Evaluator
from ..core.profiles import DeviceProfile, resolve_profile
from ..core.registry import REGISTRY, KernelRegistry, Shape, TunableKernel, resolve
from ..core.tuner import Tuner, TuningOutcome

log = logging.getLogger("repro_torch.tune")


def warm_start_seeds(k: TunableKernel, shape: Shape, *,
                     profile: Optional[DeviceProfile] = None,
                     cache: Optional[TuningCache] = None,
                     k_nearest: int = 3,
                     objective: "str | Any | None" = None
                     ) -> List[Dict[str, Any]]:
    """Warm-start candidates for tuning ``k`` at ``shape``: the configs of
    the ``k_nearest`` closest tuned shapes in the cache (nearest first),
    then the declared heuristic.  Feasibility filtering happens in the
    strategy layer — a block size tuned for another shape may not divide
    this one.  Only same-``objective`` winners transfer (a p99 search is
    never seeded from median winners' keys and vice versa)."""
    profile = resolve_profile(profile)
    cache = cache if cache is not None else default_cache()
    seeds = [dict(e.config)
             for e in cache.nearest(k.name, dict(shape), profile.name,
                                    k=k_nearest, objective=objective)]
    try:
        seeds.append(dict(k.heuristic(dict(shape))))
    except Exception as e:  # noqa: BLE001 — a broken heuristic is no seed
        log.debug("warm start: heuristic for %s failed (%s)", k.name, e)
    return seeds


def tune_kernel(kernel: "TunableKernel | str", shape: Shape, *,
                strategy: Optional[str] = None,
                budget: Optional[int] = None,
                evaluator: Optional[Evaluator] = None,
                profile: Optional[DeviceProfile] = None,
                cache: Optional[TuningCache] = None,
                artifact_store: "ArtifactStore | str | None" = None,
                record: bool = True,
                seed: int = 0,
                extended_space: Optional[bool] = None,
                engine: "EngineConfig | Dict[str, Any] | None" = None,
                warm_start: "bool | int | None" = None,
                seeds: Optional[List[Dict[str, Any]]] = None,
                objective: "str | Any | None" = None,
                predictor: Any = None,
                analyze: Optional[bool] = None,
                **strategy_kwargs) -> TuningOutcome:
    """Tune one registered kernel for one concrete shape.

    Strategy and budget default to the kernel's declared ``defaults`` and
    fall back to annealing with the Tuner's clamped 1/32-of-space budget.
    With ``record=True`` the winner lands in the tuned-config cache under
    the kernel's ``shape_key`` — together with the structured ``shape``
    dict that makes it transferable — where
    :func:`repro_torch.core.registry.lookup` (and hence every public op) finds
    it.  ``engine`` configures the parallel evaluation engine (worker-pool
    width, early-stop pruning, speculative prefetch); the resulting
    :attr:`~repro_torch.core.tuner.TuningOutcome.engine_stats` records what the
    engine saved.

    ``warm_start`` seeds the search from the nearest tuned shapes already
    in the cache plus the declared heuristic (int = how many neighbours;
    True = 3; False/0 = search cold; default on).  Explicit ``seeds``
    configs are evaluated before any warm-start candidates.

    ``artifact_store`` attaches the persistent compile-artifact cache
    (:mod:`repro_torch.core.artifacts`): an :class:`ArtifactStore`, a root
    directory path, or None = the ``REPRO_ARTIFACT_CACHE``-gated process
    default.  A second identical search against a warm store performs no
    fresh compiles — every prepare is a store hit
    (``engine_stats["artifact_hits"]``).

    ``objective`` selects what the search minimizes (an
    :class:`~repro_torch.core.metrics.Objective` or spec string such as
    ``"p99_time"``; None = the default ``median_time``).  The winner is
    recorded under an objective-scoped cache key, and warm-start seeds
    only transfer from same-objective entries.

    ``predictor`` ranks the search predictor-first (and can prune
    predicted-infeasible configs before they are built): anything
    :func:`repro_torch.core.predict.resolve_predictor` accepts — None (=
    the ``REPRO_PREDICTOR`` env default, normally off), a kind string
    (``"heuristic"|"costmodel"|"transfer"|"learned"``), a
    ``{"kind", "payload"}`` dict, or a ready instance.

    ``analyze`` runs the :mod:`repro_torch.analyze` pre-search pass
    (space audit stats on ``outcome.analysis`` + proven-infeasible
    pruning in the engine, ``EngineStats.proven_pruned``); None defers to
    the ``REPRO_ANALYZE`` env knob (default off — analyzer-off searches
    stay trial-identical to earlier releases).
    """
    k = resolve(kernel)
    shape = dict(shape)
    profile = resolve_profile(profile, getattr(evaluator, "device", None))
    strategy = strategy or k.defaults.get("strategy", "annealing")
    if budget is None:
        budget = k.defaults.get("budget")
    if extended_space is None:
        # kernels whose declared budget assumes the paper-scale space opt in
        extended_space = bool(k.defaults.get("extended_space", False))
    # NB: `is` checks — `warm_start=1` means k=1, but `1 in (None, True)`
    # would be True under ==
    k_nearest = 3 if (warm_start is None or warm_start is True) \
        else int(warm_start)
    all_seeds = list(seeds or [])
    if k_nearest > 0:
        all_seeds += warm_start_seeds(k, shape, profile=profile, cache=cache,
                                      k_nearest=k_nearest,
                                      objective=objective)
    tuner = Tuner.from_tunable(k, shape, evaluator=evaluator, profile=profile,
                               cache=cache, artifact_store=artifact_store,
                               extended_space=extended_space)
    return tuner.tune(strategy=strategy, budget=budget, seed=seed,
                      record_to_cache=record, shape_key=k.key_for(shape),
                      engine=engine, seeds=all_seeds or None,
                      objective=objective, predictor=predictor,
                      analyze=analyze, **strategy_kwargs)


def tune_kernel_distributed(kernel: "TunableKernel | str", shape: Shape, *,
                            n_workers: Optional[int] = None,
                            mode: Optional[str] = None,
                            driver: Optional[str] = None,
                            profile: Optional[DeviceProfile] = None,
                            evaluator: Any = None,
                            cache: Optional[TuningCache] = None,
                            artifact_store: "ArtifactStore | str | None"
                            = None,
                            budget: Optional[int] = None,
                            engine: "EngineConfig | Dict[str, Any] | None"
                            = None,
                            device: Optional[str] = None,
                            extended_space: Optional[bool] = None,
                            warm_start: "bool | int" = True,
                            seed: int = 0,
                            record: bool = True,
                            objective: "str | Any | None" = None,
                            predictor: Any = None,
                            timeout_s: Optional[float] = None):
    """Tune one kernel for one shape across a worker fleet.

    The distributed counterpart of :func:`tune_kernel`: the search space
    is sharded over ``n_workers`` (default ``$REPRO_DTUNE_WORKERS`` or 4)
    in ``mode`` ``"strided"`` (exact partition, exhaustive — default) or
    ``"islands"`` (per-worker annealing/PSO/evolutionary/random with
    warm-start seeds), run on the ``"thread"`` or ``"process"`` (spawn)
    driver, and the per-worker results are folded into the shared cache
    under the best-finite-time-per-key merge rule.  ``budget`` is *per
    worker*.  ``device`` is where the workers run (None = the evaluator's,
    the card by default; ``"cpu"`` for the plain versions); ``profile``
    defaults to that device's.  Returns a
    :class:`repro_torch.dtune.DistributedOutcome`.

    Note ``evaluator`` here is a *spec* (``make_evaluator`` name or
    ``{"name": ..., **kwargs}`` dict, or a live instance for the thread
    driver) so it can cross process boundaries.
    """
    from ..dtune import DistributedTuner      # lazy: dtune sits above us
    tuner = DistributedTuner(
        kernel, shape, n_workers=n_workers, mode=mode, driver=driver,
        profile=profile, evaluator=evaluator, cache=cache,
        artifact_store=artifact_store, budget=budget,
        engine=engine, device=device, extended_space=extended_space,
        warm_start=warm_start, seed=seed, record=record,
        objective=objective, predictor=predictor)
    return tuner.run(timeout_s=timeout_s)


@dataclasses.dataclass
class _WorkItem:
    kernel: TunableKernel
    shape: Dict[str, Any]
    overrides: Dict[str, Any]

    @property
    def key(self) -> str:
        return f"{self.kernel.name}:{self.kernel.key_for(self.shape)}"


class TuningSession:
    """Batch-tune many (kernel, shape) pairs into one shared cache.

    The multi-kernel analogue of a CLTune run: queue work with :meth:`add`
    (or let :meth:`run` default to every registered kernel's declared
    ``default_shapes``), then one :meth:`run` call searches each space and
    writes a single cache file the runtime consults afterwards.
    """

    def __init__(self, profile: Optional[DeviceProfile] = None, *,
                 cache: Optional[TuningCache] = None,
                 artifact_store: "ArtifactStore | str | None" = None,
                 strategy: Optional[str] = None,
                 budget: Optional[int] = None,
                 seed: int = 0,
                 extended_space: Optional[bool] = None,
                 registry: KernelRegistry = REGISTRY,
                 evaluator_factory=None,
                 engine: "EngineConfig | Dict[str, Any] | None" = None,
                 objective: "str | Any | None" = None,
                 predictor: Any = None):
        self.profile = resolve_profile(profile)
        self.cache = cache if cache is not None else default_cache()
        #: shared compile-artifact store for every queued item (None = the
        #: env-gated default; resolved per item inside tune_kernel)
        self.artifact_store = artifact_store
        self.strategy = strategy
        self.budget = budget
        self.seed = seed
        self.extended_space = extended_space
        self.registry = registry
        #: (kernel, shape, profile) -> Evaluator; None = per-kernel default
        self.evaluator_factory = evaluator_factory
        #: engine configuration shared by every queued item
        self.engine = engine
        #: objective every queued item tunes under (None = median_time)
        self.objective = objective
        #: predictor shared by every queued item (see tune_kernel; per-item
        #: ``predictor=`` overrides win)
        self.predictor = predictor
        self._items: List[_WorkItem] = []
        self.outcomes: Dict[str, TuningOutcome] = {}

    # -- work-list construction ------------------------------------------------
    def add(self, kernel: "TunableKernel | str",
            shape: Optional[Shape] = None, **overrides) -> "TuningSession":
        """Queue one kernel; without ``shape``, its declared default shapes."""
        k = resolve(kernel, self.registry)
        shapes = [dict(shape)] if shape is not None \
            else [dict(s) for s in k.default_shapes]
        if not shapes:
            raise ValueError(f"kernel {k.name!r} declares no default_shapes; "
                             "pass an explicit shape")
        for s in shapes:
            self._items.append(_WorkItem(k, s, dict(overrides)))
        return self

    def add_all(self, names: Optional[Sequence[str]] = None) -> "TuningSession":
        """Queue every registered kernel that declares default shapes."""
        for name in (names or self.registry.names()):
            k = self.registry.get(name)
            if not k.default_shapes:
                log.info("session: skipping %r (no default_shapes)", name)
                continue
            self.add(k)
        return self

    # -- execution ---------------------------------------------------------------
    def run(self, save: bool = True) -> Dict[str, TuningOutcome]:
        """Tune every queued item (queueing all registered kernels if the
        work-list is empty), record winners, write the cache once."""
        if not self._items:
            self.add_all()
        if not self._items:
            raise ValueError("nothing to tune: no queued items and no "
                             "registered kernel declares default_shapes")
        for item in self._items:
            k, shape = item.kernel, item.shape
            kw: Dict[str, Any] = dict(
                strategy=self.strategy, budget=self.budget, seed=self.seed,
                extended_space=self.extended_space,
                engine=self.engine, objective=self.objective,
                predictor=self.predictor)
            kw.update(item.overrides)
            if "evaluator" not in kw and self.evaluator_factory is not None:
                kw["evaluator"] = self.evaluator_factory(k, shape, self.profile)
            kw.setdefault("artifact_store", self.artifact_store)
            outcome = tune_kernel(k, shape, profile=self.profile,
                                  cache=self.cache, record=False, **kw)
            self.outcomes[item.key] = outcome
            best = outcome.result.best
            if best is not None:
                self.cache.record(k.name, k.key_for(shape), self.profile.name,
                                  best.config, best.time,
                                  outcome.result.strategy,
                                  outcome.result.evaluations, shape=shape,
                                  objective=outcome.objective)
            log.info("session: %s -> %s", item.key,
                     "no feasible config" if best is None
                     else f"{best.time * 1e6:.1f} us {best.config}")
        if save:
            # merge-on-disk: a concurrent session/replica saving the same
            # file keeps its entries too (best time per key), instead of
            # this whole-dict write erasing them
            self.cache.save(merge_on_disk=True)
        return dict(self.outcomes)

    def report(self) -> str:
        lines = [f"== tuning session: {len(self.outcomes)} kernel-shapes, "
                 f"profile={self.profile.name}, cache={self.cache.path} =="]
        for key, outcome in self.outcomes.items():
            best = outcome.result.best
            desc = ("no feasible config" if best is None
                    else f"{best.time * 1e6:9.2f} us  {best.config}")
            failed = outcome.failure_summary["failed_trials"]
            if failed:
                desc += f"  [{failed} failed trial(s)]"
            if outcome.result.extra.get("aborted"):
                desc += "  [ABORTED]"
            lines.append(f"  {key}: {desc}")
        stats = self.engine_stats()
        if stats["evaluations"]:
            lines.append(
                f"  engine totals: {stats['compile_calls']} compiles / "
                f"{stats['evaluations']} evaluations, "
                f"{stats['memo_hits']} memo hits, {stats['pruned']} pruned, "
                f"{stats['compile_failures']}+{stats['measure_failures']} "
                f"compile+measure failures")
        return "\n".join(lines)

    def engine_stats(self) -> Dict[str, int]:
        """Aggregate engine counters across every tuned item."""
        totals = {"evaluations": 0, "unique_configs": 0, "memo_hits": 0,
                  "artifact_hits": 0, "compile_calls": 0, "pruned": 0,
                  "predicted_pruned": 0, "compile_failures": 0,
                  "measure_failures": 0, "retries": 0}
        for outcome in self.outcomes.values():
            s = outcome.engine_stats or {}
            for key in totals:
                totals[key] += int(s.get(key, 0))
        return totals

    def failure_summary(self) -> Dict[str, int]:
        """Per-session failure counts, keyed by work item."""
        return {key: outcome.failure_summary["failed_trials"]
                for key, outcome in self.outcomes.items()
                if outcome.failure_summary["failed_trials"]}
