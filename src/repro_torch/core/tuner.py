"""The Tuner facade — CLTune's user API, adapted to PyTorch.

The OpenCL original (paper Fig. 1):

    cltune::Tuner tuner(0, 1);
    tuner.AddKernel("copy.cl", "copy", {2048}, {64});
    tuner.AddParameter("WPT", {1, 2, 4});
    tuner.DivGlobalSize({"WPT"});
    tuner.AddArgumentInput(in_vector);
    tuner.AddArgumentOutput(out_vector);
    tuner.Tune();

This port:

    tuner = Tuner(evaluator=WallClockEvaluator())
    tuner.add_kernel(build=lambda cfg: make_copy(cfg), make_args=...)
    tuner.add_parameter("WPT", [1, 2, 4])
    tuner.add_constraint(lambda wpt: 2048 % wpt == 0, ["WPT"])
    tuner.set_reference(ref_copy)
    outcome = tuner.tune(strategy="full")

Kernels declared through the registry (``@tunable``) skip the fluent
construction entirely: ``Tuner.from_tunable(kernel, shape)`` builds the
same object from the declaration (and the fluent methods remain usable on
it as a compatibility layer).

``DivGlobalSize``/``MulLocalSize`` disappear: the grid and the thread
geometry are derived from the block shape inside ``build``, so that
bookkeeping lives with the kernel, not the tuner.  Device-limit
auto-constraints (paper III-A) are imposed from the DeviceProfile when a
kernel declares its shared-memory footprint function; with ``analyze=``
the declared footprint and threads per block also *prove* configs
infeasible before they are built (:mod:`repro_torch.analyze`).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, Optional, Sequence

from .artifacts import ArtifactStore, resolve_store
from .cache import TuningCache, default_cache
from .engine import EngineConfig, EvaluationEngine
from .evaluators import (AnalyticalEvaluator, Evaluator, KernelSpec,
                         Measurement, WallClockEvaluator)
from .profiles import DeviceProfile, resolve_profile
from .registry import Shape, TunableKernel, resolve
from .space import Config, Parameter, SearchSpace
from .strategies import SearchResult, Strategy, make_strategy

log = logging.getLogger("repro_torch.tuner")


@dataclasses.dataclass
class TuningOutcome:
    """Search result plus measurement metadata and reporting helpers."""

    kernel: str
    result: SearchResult
    measurements: Dict[tuple, Measurement]
    evaluator: str
    profile: str
    #: the evaluation budget actually used (None = exhaustive full search)
    budget: Optional[int] = None
    #: EvaluationEngine observability record (None on engine-less paths)
    engine_stats: Optional[Dict[str, Any]] = None
    #: canonical spec of the objective the search minimized
    objective: Optional[str] = None
    #: name of the predictor that ranked/pruned the search (None = off)
    predictor: Optional[str] = None
    #: pre-search static-analysis stats (:mod:`repro_torch.analyze`;
    #: None = off)
    analysis: Optional[Dict[str, Any]] = None

    @property
    def best_config(self) -> Optional[Config]:
        return self.result.best_config

    @property
    def best_time(self) -> float:
        return self.result.best_time

    @property
    def failed_fraction(self) -> float:
        n = len(self.result.trials)
        if not n:
            return 0.0
        return sum(1 for t in self.result.trials if not t.ok) / n

    @property
    def failure_summary(self) -> Dict[str, Any]:
        """Aggregated failure counts by stage/exception type (see
        :meth:`repro_torch.core.strategies.SearchResult.failure_summary`)."""
        return self.result.failure_summary()

    def report(self, top_k: int = 5) -> str:
        budget = "exhaustive" if self.budget is None else str(self.budget)
        lines = [f"== tuning report: {self.kernel} "
                 f"(strategy={self.result.strategy}, "
                 f"evaluator={self.evaluator}, profile={self.profile}) ==",
                 f"evaluated {self.result.evaluations} configurations "
                 f"(budget={budget}), "
                 f"{self.failed_fraction:.0%} failed/infeasible"]
        ok = sorted((t for t in self.result.trials if t.ok),
                    key=lambda t: t.time)
        for i, t in enumerate(ok[:top_k]):
            lines.append(f"  #{i + 1}: {t.time * 1e6:9.2f} us  {t.config}")
        if not ok:
            lines.append("  (no feasible configuration found)")
        summary = self.failure_summary
        if summary["failed_trials"]:
            stages = ", ".join(f"{n} {stage}" for stage, n
                               in sorted(summary["by_stage"].items()))
            types = ", ".join(f"{n}x {t}" for t, n
                              in sorted(summary["by_type"].items()))
            lines.append(f"failures: {summary['failed_trials']} trial(s) "
                         f"[{stages or 'unattributed'}]"
                         + (f" ({types})" if types else ""))
        aborted = self.result.extra.get("aborted")
        if aborted:
            lines.append(f"ABORTED: {aborted.get('reason')}")
        if self.engine_stats:
            s = self.engine_stats
            lines.append(
                f"engine: {s.get('compile_calls', 0)} compiles for "
                f"{s.get('evaluations', 0)} evaluations "
                f"({s.get('memo_hits', 0)} memo hits, "
                f"{s.get('artifact_hits', 0)} store hits, "
                f"{s.get('pruned', 0)} pruned, "
                f"{s.get('compile_failures', 0)}+"
                f"{s.get('measure_failures', 0)} compile+measure failures, "
                f"overlap={s.get('compile_overlap_ratio', 0.0):.0%})")
            if self.predictor:
                lines.append(
                    f"predictor: {self.predictor} "
                    f"(ranked {s.get('predictor_rank_used', 0)} batches, "
                    f"pruned {s.get('predicted_pruned', 0)} predicted-"
                    f"infeasible configs before compile)")
            if self.analysis:
                a = self.analysis
                fc = a.get("findings", {})
                lines.append(
                    f"analysis: {a.get('feasible', '?')}/"
                    f"{a.get('examined', '?')} examined configs feasible "
                    f"({a.get('confidence', '?')}), "
                    f"{a.get('dead_values', 0)} dead value(s), findings "
                    f"{fc.get('error', 0)}e/{fc.get('warning', 0)}w/"
                    f"{fc.get('info', 0)}i, proven checker "
                    f"{'on' if a.get('proven_checker') else 'off'} "
                    f"({s.get('proven_pruned', 0)} proven-infeasible "
                    f"pruned)")
        return "\n".join(lines)


class Tuner:
    """Generic auto-tuner: declare a kernel + parameters, search, report."""

    def __init__(self, evaluator: Optional[Evaluator] = None,
                 profile: Optional[DeviceProfile] = None,
                 cache: Optional[TuningCache] = None,
                 artifact_store: "ArtifactStore | str | None" = None):
        self.evaluator = evaluator or WallClockEvaluator()
        # default: the profile of the device the evaluator measures on
        self.profile = resolve_profile(
            profile, getattr(self.evaluator, "device", None))
        self.space = SearchSpace()
        self._spec: Optional[KernelSpec] = None
        self._cache = cache
        self._reference: Optional[Callable] = None
        self._smem_footprint: Optional[Callable[[Config], int]] = None
        self._block_threads: Optional[Callable[[Config], int]] = None
        self._smem_constraint_added = False
        #: the declaration a tuner was built from (None = fluent tuner)
        self._tunable: Optional[TunableKernel] = None
        self._extended_space = False
        # attach the persistent compile-artifact store (an instance, a root
        # directory, or None = the REPRO_ARTIFACT_CACHE-gated process
        # default) — without clobbering a store the evaluator already has
        store = resolve_store(artifact_store)
        if store is not None and self.evaluator.artifact_store is None:
            self.evaluator.artifact_store = store
        self.artifact_store = self.evaluator.artifact_store

    # -- declarative construction ---------------------------------------------
    @classmethod
    def from_tunable(cls, kernel: "TunableKernel | str", shape: Shape, *,
                     evaluator: Optional[Evaluator] = None,
                     profile: Optional[DeviceProfile] = None,
                     cache: Optional[TuningCache] = None,
                     artifact_store: "ArtifactStore | str | None" = None,
                     extended_space: bool = False) -> "Tuner":
        """Build a ready-to-run Tuner from a :class:`TunableKernel` spec.

        This is the registry-era replacement for the per-kernel
        ``make_tuner`` boilerplate: the declaration carries the space,
        constraints, heuristics, models and reference, so instantiating a
        tuner for a concrete shape is one call.  The fluent
        ``add_parameter``/``add_constraint`` methods still work on the
        result (CLTune-style compatibility layer).

        As in the JAX package, a kernel that declares an analytical model
        is searched under the :class:`AnalyticalEvaluator` unless an
        evaluator is given: a search on the card passes an explicit
        :class:`WallClockEvaluator`.
        """
        k = resolve(kernel)
        shape = dict(shape)
        profile = resolve_profile(profile, getattr(evaluator, "device", None))
        if evaluator is None:
            evaluator = (AnalyticalEvaluator(profile=profile)
                         if k.analytical_model is not None
                         else WallClockEvaluator())
        tuner = cls(evaluator=evaluator, profile=profile, cache=cache,
                    artifact_store=artifact_store)
        tuner.space = k.make_space(shape, extended=extended_space)
        if k.reference is not None:
            tuner.set_reference(k.reference(shape))
        tuner.add_kernel(
            lambda cfg: k.build(shape, cfg),
            name=k.name,
            make_args=((lambda rng: k.make_args(shape, rng))
                       if k.make_args is not None else None),
            analytical_model=((lambda cfg, prof:
                               k.analytical_model(shape, cfg, prof))
                              if k.analytical_model is not None else None),
            smem_footprint=((lambda cfg: k.smem_footprint(shape, cfg))
                            if k.smem_footprint is not None else None),
            block_threads=((lambda cfg: k.block_threads(shape, cfg))
                           if k.block_threads is not None else None),
            cost=((lambda cfg: k.cost(shape, cfg))
                  if k.cost is not None else None),
            sources=((k.cost,) if k.cost is not None else ()) + k.sources,
            meta=dict(shape))
        tuner._shape = shape
        tuner._tunable = k
        tuner._extended_space = bool(extended_space)
        return tuner

    # -- CLTune-style declaration ---------------------------------------------
    def add_kernel(self, build: Callable[[Config], Callable],
                   name: str = "kernel",
                   make_args: Optional[Callable] = None,
                   analytical_model: Optional[Callable] = None,
                   smem_footprint: Optional[Callable[[Config], int]] = None,
                   block_threads: Optional[Callable[[Config], int]] = None,
                   cost: Optional[Callable] = None,
                   sources: Sequence[Any] = (),
                   meta: Optional[Dict[str, Any]] = None) -> "Tuner":
        """Register the (single) kernel under tuning.

        ``smem_footprint(config) -> bytes`` triggers the automatic
        device-limit constraint: configurations whose shared memory exceeds
        what one block may claim on the profile are infeasible before any
        evaluation — CLTune auto-constraining on OpenCL local-memory size.
        ``block_threads(config) -> threads`` feeds the analyzer's proof
        against the profile's threads per block (``analyze=``), and
        ``cost(config) -> KernelCost`` the cost-model evaluator.
        ``sources`` are the functions and device source files the cost and
        the build are made of; with ``cost`` they key the cost model's
        stored prices (:func:`~repro_torch.core.evaluators.source_digest`).
        """
        if self._spec is not None:
            raise ValueError("a kernel is already registered; "
                             "use one Tuner per kernel")
        self._spec = KernelSpec(
            name=name, build=build, make_args=make_args,
            analytical_model=analytical_model, cost=cost,
            sources=tuple(sources), reference=self._reference,
            meta=meta or {})
        self._smem_footprint = smem_footprint
        self._block_threads = block_threads
        self._smem_constraint_added = False
        return self

    def add_parameter(self, name: str, values: Sequence[Any]) -> "Tuner":
        self.space.add_parameter(Parameter(name=name, values=tuple(values)))
        return self

    def add_constraint(self, fn: Callable[..., bool],
                       names: Sequence[str], label: str = "") -> "Tuner":
        self.space.add_constraint(fn, names, label=label)
        return self

    def set_reference(self, reference: Callable) -> "Tuner":
        self._reference = reference
        if self._spec is not None:
            self._spec = dataclasses.replace(self._spec, reference=reference)
        return self

    # -- device auto-constraints ------------------------------------------------
    def _install_device_constraints(self) -> None:
        if self._smem_footprint is None or self._smem_constraint_added:
            return
        names = self.space.names
        foot = self._smem_footprint
        limit = self.profile.smem_per_block_optin

        def _fits(*values) -> bool:
            cfg = dict(zip(names, values))
            try:
                return foot(cfg) <= limit
            except Exception:  # noqa: BLE001 — malformed config = infeasible
                return False

        self.space.add_constraint(_fits, names, label="device:smem")
        self._smem_constraint_added = True

    # -- pre-search static analysis ----------------------------------------------
    def _run_analysis(self) -> Dict[str, Any]:
        """Audit the (device-constrained) space before searching it.

        Returns the stats dict attached to the outcome.  Under
        ``REPRO_ANALYZE_STRICT`` an error-severity finding raises instead
        of burning the search budget on a provably-broken space.
        """
        from ..analyze import audit_space, space_findings, strict_default
        name = self._spec.name if self._spec is not None else "kernel"
        report = audit_space(self.space)
        findings = space_findings(report, kernel=name,
                                  shape=getattr(self, "_shape", None))
        errors = [f for f in findings if f.severity == "error"]
        if errors and strict_default():
            raise ValueError(
                f"pre-search analysis found {len(errors)} error "
                f"finding(s) for {name!r} (REPRO_ANALYZE_STRICT): "
                + "; ".join(f.detail for f in errors[:3]))
        for f in findings:
            log.log(logging.WARNING if f.severity != "info"
                    else logging.INFO, "analysis: %s", f)
        stats = report.stats()
        stats["findings"] = {
            s: sum(1 for f in findings if f.severity == s)
            for s in ("error", "warning", "info")}
        return stats

    def _proven_checker(self) -> Optional[Callable]:
        """Static proven-infeasibility checker for the engine, built from
        the declared shared-memory and thread models (None when neither
        is declared)."""
        from ..analyze.resource import limit_violations
        foot, threads = self._smem_footprint, self._block_threads
        if foot is None and threads is None:
            return None
        profile = self.profile

        def check(config: Config) -> list:
            try:
                smem = int(foot(dict(config))) if foot is not None else None
                n = int(threads(dict(config))) if threads is not None \
                    else None
            except Exception:  # noqa: BLE001 — a broken model proves nothing
                return []
            return limit_violations(smem, n, profile)

        return check

    # -- search ------------------------------------------------------------------
    def tune(self, strategy: str | Strategy = "full",
             budget: Optional[int] = None, seed: int = 0,
             record_to_cache: bool = False,
             shape_key: str = "",
             engine: "EngineConfig | Dict[str, Any] | None" = None,
             seeds: Optional[Sequence[Config]] = None,
             objective: "str | Any | None" = None,
             predictor: Any = None,
             analyze: Optional[bool] = None,
             **strategy_kwargs) -> TuningOutcome:
        """Search the space; all evaluation flows through the
        :class:`~repro_torch.core.engine.EvaluationEngine` (``engine`` takes an
        :class:`EngineConfig` or a kwargs dict for one; default engine =
        batched drivers + compile pool, no pruning/speculation).

        ``seeds`` warm-start the search: the strategy evaluates these
        configs first (infeasible ones are silently dropped), so a
        transferred nearest-shape winner cuts evaluations-to-target.

        ``objective`` selects what the search minimizes — an
        :class:`~repro_torch.core.metrics.Objective`, a spec string
        (``"p99_time"``) or None for the engine config's objective
        (default ``median_time``).  The resolved objective rides on the
        outcome and is recorded with any cached winner, keyed so winners
        under different objectives never compare.

        ``predictor`` is anything
        :func:`repro_torch.core.predict.resolve_predictor` accepts (None =
        the ``REPRO_PREDICTOR`` env default, a kind string like
        ``"learned"``, a ``{"kind", "payload"}`` dict, or an instance);
        when resolved, the engine ranks every ask() batch predictor-first
        and may prune predicted-infeasible configs before compile.

        ``analyze`` runs the :mod:`repro_torch.analyze` pre-search pass:
        the (device-constrained) space is audited, the stats ride on
        ``outcome.analysis``, and the engine gets a proven-infeasibility
        checker so configs over the device's shared memory or threads per
        block are answered without being built
        (``EngineStats.proven_pruned``).  None defers to the
        ``REPRO_ANALYZE`` env knob (strict bool, default off) —
        analyzer-off searches are trial-identical to earlier releases."""
        if self._spec is None:
            raise ValueError("no kernel registered; call add_kernel first")
        if self.space.num_dimensions == 0:
            raise ValueError("no parameters registered; call add_parameter")
        self._install_device_constraints()
        if analyze is None:
            from ..analyze import analyze_default
            analyze = analyze_default()
        analysis = self._run_analysis() if analyze else None

        strat = (strategy if isinstance(strategy, Strategy)
                 else make_strategy(strategy, **strategy_kwargs))
        if strat.name == "full":
            # None = exhaustive; an explicit budget still caps enumeration
            budget = max(1, budget) if budget is not None else None
        else:
            card = self.space.cardinality()
            if budget is None:
                # paper's 1/32nd rule, clamped: tiny spaces are swept whole
                # instead of degenerating to a single sample.
                budget = card if card <= 32 else max(1, card // 32)
            budget = max(1, min(budget, card))  # never exceed the space

        if not isinstance(engine, EngineConfig):
            engine = EngineConfig(**(engine or {}))
        if objective is not None:
            engine = dataclasses.replace(engine, objective=objective)
        if analyze and engine.proven_checker is None:
            checker = self._proven_checker()
            if checker is not None:
                engine = dataclasses.replace(engine, proven_checker=checker)
                analysis["proven_checker"] = True
        if engine.predictor is None:
            # resolve the predictor= argument (or the REPRO_PREDICTOR env
            # default) — needs the kernel declaration for spaces/heuristics,
            # so fluent tuners only accept ready Predictor instances
            k = self._tunable
            if k is not None:
                from .predict import resolve_predictor
                engine = dataclasses.replace(
                    engine, predictor=resolve_predictor(
                        predictor, k, profile=self.profile,
                        cache=self._cache, objective=engine.objective,
                        store=self.evaluator.artifact_store,
                        extended=self._extended_space))
            elif predictor is not None and not isinstance(predictor,
                                                          (str, dict)):
                engine = dataclasses.replace(engine, predictor=predictor)
        eng = EvaluationEngine(self.evaluator, self._spec, self.space,
                               config=engine)
        result = eng.run(strat, budget, seed=seed,
                         seeds=[dict(s) for s in seeds] if seeds else None)
        for record in eng.failures.values():
            log.debug("config failed: %s", record)
        if result.extra.get("aborted"):
            log.warning("tuning aborted: %s",
                        result.extra["aborted"].get("reason"))

        resolved_objective = engine.objective
        outcome = TuningOutcome(
            kernel=self._spec.name, result=result,
            measurements=dict(eng.measurements),
            evaluator=self.evaluator.name, profile=self.profile.name,
            budget=budget, engine_stats=result.extra.get("engine"),
            objective=resolved_objective.spec,
            predictor=(getattr(engine.predictor, "name", None)
                       if engine.predictor is not None else None),
            analysis=analysis)
        if record_to_cache and result.best is not None:
            cache = self._cache if self._cache is not None else default_cache()
            # from_tunable stashes the problem shape in the spec's meta; a
            # fluent tuner has no structured shape and records without one
            # (exact-key lookups work, nearest-shape transfer skips it)
            shape = getattr(self, "_shape", None) or self._spec.meta or None
            cache.record(self._spec.name, shape_key or "default",
                         self.profile.name, result.best.config,
                         result.best.time, result.strategy,
                         result.evaluations, shape=shape,
                         failures=len(eng.failures),
                         objective=resolved_objective)
            cache.save()
        return outcome
