"""Search strategies: full, random, simulated annealing, PSO (+ extensions).

The four strategies of the paper (section III-B/C/D) with its exact update
equations, plus a pluggable registry so "evolutionary search, gradient
methods, stochastic optimisation or dynamic programming can be evaluated as
part of future work" (paper, end of III-B).  We add one beyond-paper strategy
(greedy coordinate descent) used by the sharding tuner.

Objective convention: *lower is better* (execution time in seconds), exactly
like the paper's annealing-energy analogy.  Infeasible / failed measurements
return ``math.inf`` and are recorded but never become the incumbent.
"""

from __future__ import annotations

import dataclasses
import inspect
import itertools
import logging
import math
import queue
import random
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .failures import FailureRecord, summarize_failures
from .space import Config, SearchSpace

log = logging.getLogger("repro_torch.strategies")

#: scalar objective function over one config — lower is better.  Renamed
#: from ``Objective``: the *typed* objective identity (median/p99/weighted
#: specs) now lives in :class:`repro_torch.core.metrics.Objective`; strategies
#: only ever see the already-scalarized callable.
ObjectiveFn = Callable[[Config], float]


def accepts_kwarg(fn: Callable, kwarg: str) -> bool:
    """Whether ``fn`` can take ``kwarg`` — shared signature introspection
    for optional-capability probes (seeds support, extended spaces, ...)."""
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):    # builtins / C callables
        return False
    return kwarg in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())


def usable_seeds(space: SearchSpace, seeds: Optional[Sequence[Config]],
                 limit: Optional[int] = None) -> List[Config]:
    """Sanitize warm-start seed configs for one search.

    Seeds come from *other* shapes' tuned winners and declared heuristics,
    so each is projected onto this space's parameters (a seed missing a
    parameter, or carrying a value outside the parameter's list, is
    dropped), checked for feasibility, and deduplicated; ``limit`` caps
    how many survive (a seed list must never exhaust the search budget).
    """
    out: List[Config] = []
    seen = set()
    for seed in seeds or ():
        try:
            cfg = {p.name: seed[p.name] for p in space.parameters}
            space.to_indices(cfg)           # value outside the list raises
            key = space.config_key(cfg)
            feasible = space.is_feasible(cfg)
        except (KeyError, ValueError):
            continue
        if not feasible or key in seen:
            continue
        seen.add(key)
        out.append(cfg)
        if limit is not None and len(out) >= limit:
            break
    return out


def project_feasible(space: SearchSpace, config: Config,
                     scan_limit: int = 4096) -> Optional[Config]:
    """Project an arbitrary config onto the nearest feasible space point.

    Two stages, mirroring what :func:`usable_seeds` checks but *repairing*
    instead of dropping: each parameter value is first snapped to its
    nearest in-list value (missing parameter -> first value; numeric ->
    closest by absolute distance; categorical -> first value); if the
    snapped point still violates a constraint, the feasible space is
    scanned (up to ``scan_limit`` points) for the config at minimum
    index-distance from the snapped one.  Returns ``None`` only when no
    feasible point exists within the scan horizon.
    """
    snapped: Config = {}
    for p in space.parameters:
        v = config.get(p.name, p.values[0])
        try:
            p.index_of(v)
        except ValueError:
            numeric = (isinstance(v, (int, float)) and not isinstance(v, bool))
            in_list = [x for x in p.values
                       if isinstance(x, (int, float))
                       and not isinstance(x, bool)]
            v = (min(in_list, key=lambda x: (abs(x - v), x))
                 if numeric and in_list else p.values[0])
        snapped[p.name] = v
    try:
        if space.is_feasible(snapped):
            return snapped
    except KeyError:
        return None
    want = space.to_indices(snapped)
    best: Optional[Config] = None
    best_d = math.inf
    for cfg in itertools.islice(iter(space), scan_limit):
        d = sum(abs(i - j) for i, j in zip(space.to_indices(cfg), want))
        if d < best_d:
            best, best_d = cfg, d
            if d == 0:
                break
    return best


def _sample_avoiding(space: SearchSpace, rng: random.Random, count: int,
                     exclude: Sequence[Config]) -> List[Config]:
    """``sample_unique`` that skips already-seeded configs.

    With no exclusions this is exactly ``sample_unique(rng, count)`` — the
    seedless trial sequence is unchanged.
    """
    if count <= 0:
        return []
    if not exclude:
        return space.sample_unique(rng, count)
    banned = {space.config_key(c) for c in exclude}
    drawn = space.sample_unique(rng, count + len(banned))
    fresh = [c for c in drawn if space.config_key(c) not in banned]
    return fresh[:count]


@dataclasses.dataclass
class Trial:
    """One evaluated configuration."""

    config: Config
    time: float                 # objective score (inf = failed/infeasible);
                                # seconds under time-based objectives
    index: int                  # evaluation order, 0-based
    #: populated (by the evaluation engine) when this trial is a failed
    #: configuration: the structured why — stage, exception type, message
    failure: Optional[FailureRecord] = None
    #: populated (by the evaluation engine) with the structured
    #: :class:`~repro_torch.core.metrics.Metrics` behind this trial — the full
    #: per-repeat sample vector the scalar ``time`` collapsed
    metrics: Optional[Any] = None

    @property
    def ok(self) -> bool:
        return math.isfinite(self.time)


@dataclasses.dataclass
class SearchResult:
    strategy: str
    trials: List[Trial]
    best: Optional[Trial]
    evaluations: int
    #: per-strategy extras (e.g. PSO per-particle traces)
    extra: Dict[str, object] = dataclasses.field(default_factory=dict)
    #: canonical spec of the objective that ranked these trials (set by
    #: the evaluation engine; None from bare ``Strategy.run`` calls,
    #: which are always scalar and therefore default-objective)
    objective: Optional[str] = None

    @property
    def best_time(self) -> float:
        return self.best.time if self.best else math.inf

    @property
    def best_config(self) -> Optional[Config]:
        return self.best.config if self.best else None

    def progress_trace(self) -> List[float]:
        """Best-so-far time after each evaluation (paper Fig. 4 traces)."""
        out, best = [], math.inf
        for t in self.trials:
            best = min(best, t.time)
            out.append(best)
        return out

    def failures(self) -> List[Trial]:
        """The failed/infeasible trials (inf time), in evaluation order."""
        return [t for t in self.trials if not t.ok]

    def failure_summary(self) -> Dict[str, Any]:
        """Aggregate counts by stage/exception type of this run's failures."""
        records = [t.failure for t in self.trials if t.failure is not None]
        summary = summarize_failures(records)
        summary["failed_trials"] = sum(1 for t in self.trials if not t.ok)
        return summary


class _Recorder:
    """Shared bookkeeping: measurement cache, trial log, incumbent.

    Re-visiting an already-measured configuration does NOT re-measure it
    (CLTune's compiled-kernel cache) but DOES consume search budget — a
    stochastic walk that keeps revisiting known points must still
    terminate.  ``unique_evaluations`` reports how many distinct configs
    were actually measured.
    """

    def __init__(self, space: SearchSpace, objective: ObjectiveFn):
        self._space = space
        self._objective = objective
        self._seen: Dict[Tuple, float] = {}
        self.trials: List[Trial] = []
        self.best: Optional[Trial] = None

    def evaluate(self, config: Config) -> float:
        key = self._space.config_key(config)
        if key in self._seen:
            t = self._seen[key]          # cached measurement
        else:
            t = float(self._objective(config))
            self._seen[key] = t
        trial = Trial(config=dict(config), time=t, index=len(self.trials))
        self.trials.append(trial)
        if math.isfinite(t) and (self.best is None or t < self.best.time):
            self.best = trial
        return t

    @property
    def evaluations(self) -> int:
        return len(self.trials)

    @property
    def unique_evaluations(self) -> int:
        return len(self._seen)


class Strategy:
    """Base class; subclasses implement ``run``.

    ``run``/``asktell`` accept optional warm-start ``seeds``: sanitized
    initial candidates (transferred nearest-shape winners, heuristics)
    evaluated before — or, for population strategies, as part of — the
    strategy's own exploration.  Seeds consume search budget like any
    other evaluation.

    ``asktell`` is the batch interface consumed by
    :class:`repro_torch.core.engine.EvaluationEngine`: generation-based
    strategies override it with native batched drivers, everything else
    inherits a sequential fallback that wraps ``run`` unchanged
    (forwarding ``seeds`` when the strategy's ``run`` accepts them).
    """

    name = "base"

    def run(self, space: SearchSpace, objective: ObjectiveFn,
            budget: int, seed: int = 0,
            seeds: Optional[Sequence[Config]] = None) -> SearchResult:
        raise NotImplementedError

    def asktell(self, space: SearchSpace, budget: Optional[int],
                seed: int = 0,
                seeds: Optional[Sequence[Config]] = None) -> "AskTellDriver":
        return SequentialAskTell(self, space, budget, seed=seed, seeds=seeds)


class FullSearch(Strategy):
    """Exhaustive enumeration of every feasible configuration.

    Warm-start seeds are meaningless here (every feasible config is
    visited anyway) and are ignored.

    ``offset``/``stride`` slice the enumeration for sharded distributed
    search: worker *i* of *n* runs ``FullSearch(offset=i, stride=n)`` and
    the *n* shards partition the feasible space exactly (every config
    visited once, by exactly one worker).
    """

    name = "full"

    def __init__(self, offset: int = 0, stride: int = 1):
        if stride < 1:
            raise ValueError("stride must be >= 1")
        if not 0 <= offset < stride:
            raise ValueError(f"offset must be in [0, stride); got "
                             f"offset={offset} stride={stride}")
        self.offset = offset
        self.stride = stride

    def _configs(self, space: SearchSpace):
        return itertools.islice(iter(space), self.offset, None, self.stride)

    def run(self, space, objective, budget=None, seed=0,
            seeds=None) -> SearchResult:
        rec = _Recorder(space, objective)
        for i, cfg in enumerate(self._configs(space)):
            if budget is not None and i >= budget:
                break
            rec.evaluate(cfg)
        return SearchResult(self.name, rec.trials, rec.best, rec.evaluations)

    def asktell(self, space, budget, seed=0, seeds=None) -> "AskTellDriver":
        return _FullSearchAskTell(self, space, budget)


class RandomSearch(Strategy):
    """Uniform sampling of a configurable fraction of the space.

    Warm-start seeds are evaluated first and count toward the budget; the
    random sample fills the remainder (seeds excluded from re-draws).
    """

    name = "random"

    def run(self, space, objective, budget, seed=0,
            seeds=None) -> SearchResult:
        rng = random.Random(seed)
        rec = _Recorder(space, objective)
        seeds = usable_seeds(space, seeds, limit=budget)
        for cfg in seeds:
            rec.evaluate(cfg)
        samples = _sample_avoiding(space, rng, budget - len(seeds), seeds)
        for cfg in samples:
            rec.evaluate(cfg)
        extra: Dict[str, object] = {}
        if rec.evaluations < budget:
            # the feasible space is smaller than the budget: surface the
            # shortfall instead of silently under-spending
            extra["sample_shortfall"] = budget - rec.evaluations
        return SearchResult(self.name, rec.trials, rec.best, rec.evaluations,
                            extra=extra)

    def asktell(self, space, budget, seed=0, seeds=None) -> "AskTellDriver":
        return _RandomSearchAskTell(self, space, budget, seed=seed,
                                    seeds=seeds)


class SimulatedAnnealing(Strategy):
    """Paper section III-C, acceptance probability taken verbatim:

        P(t, t', T) = 1                      if t' < t
                      exp(-(t' - t) / T)     otherwise

    with T the annealing temperature and t, t' the execution times of the
    current and neighbour configuration.  As in CLTune the walk starts from a
    random feasible configuration and runs until ``budget`` configurations
    have been explored.  ``temperature`` is expressed in the objective's
    units scaled by the first measurement, so T={2,4,6} behaves like the
    paper's settings regardless of kernel magnitude; ``cooling`` optionally
    anneals T linearly to ~0 over the run ("probability decreases over time
    as the temperature decreases").
    """

    name = "annealing"

    def __init__(self, temperature: float = 4.0, cooling: bool = True,
                 neighbour_mode: str = "any_value",
                 restart_on_dead_end: bool = True):
        self.temperature = float(temperature)
        self.cooling = cooling
        self.neighbour_mode = neighbour_mode
        self.restart_on_dead_end = restart_on_dead_end

    def run(self, space, objective, budget, seed=0,
            seeds=None) -> SearchResult:
        rng = random.Random(seed)
        rec = _Recorder(space, objective)
        # Warm start: evaluate every seed, then walk from the best of them
        # (transferred nearest-shape winners put the walk straight into a
        # good basin).  Without seeds the walk starts at a random sample,
        # exactly as before.
        current, t_cur = None, math.inf
        for cfg in usable_seeds(space, seeds, limit=budget):
            t = rec.evaluate(cfg)
            if current is None or t < t_cur:
                current, t_cur = cfg, t
        if current is None:
            current = space.sample(rng)
            t_cur = rec.evaluate(current)
        # Temperature scale: the first *finite* measurement, refreshed on
        # dead-end restarts.  Seeding it from an inf (failed) first eval —
        # or keeping a stale basin's scale after a restart — mis-sizes
        # every subsequent acceptance probability.
        scale = next((t.time for t in rec.trials
                      if math.isfinite(t.time) and t.time > 0), None)
        accepted_worse = 0
        while rec.evaluations < budget:
            nbr = space.random_neighbour(current, rng, mode=self.neighbour_mode)
            if nbr is None:
                if not self.restart_on_dead_end:
                    break
                current = space.sample(rng)
                t_cur = rec.evaluate(current)
                if math.isfinite(t_cur) and t_cur > 0:
                    scale = t_cur           # recalibrate to the new basin
                continue
            t_nbr = rec.evaluate(nbr)
            if scale is None and math.isfinite(t_nbr) and t_nbr > 0:
                scale = t_nbr               # first finite measurement seen
            # temperature in units of the scale measurement; linear cooling
            frac_done = rec.evaluations / max(budget, 1)
            T = self.temperature * (1.0 - frac_done if self.cooling else 1.0)
            T = max(T, 1e-9)
            if t_nbr < t_cur:
                p = 1.0                                     # always accept better
            elif not math.isfinite(t_nbr):
                p = 0.0                                     # never move into a wall
            else:
                p = math.exp(-((t_nbr - t_cur) / (scale or 1.0)) / T)
            if rng.random() < p:
                if t_nbr >= t_cur:
                    accepted_worse += 1
                current, t_cur = nbr, t_nbr
        return SearchResult(self.name, rec.trials, rec.best, rec.evaluations,
                            extra={"accepted_worse": accepted_worse,
                                   "temperature": self.temperature})


class ParticleSwarm(Strategy):
    """Paper section III-D: modified *discrete* accelerated PSO.

    Velocity-free, per-dimension d update:

        x[i,d] <- eps_d      with probability alpha   (random value)
                  p[i,d]     with probability beta    (particle best)
                  g[d]       with probability gamma   (global best)
                  x[i,d]     otherwise                (stay)

    with alpha + beta + gamma <= 1.  Paper experiments use alpha=0.4, beta=0,
    gamma=0.4, swarm sizes S in {3, 6}.
    """

    name = "pso"

    def __init__(self, swarm_size: int = 3, alpha: float = 0.4,
                 beta: float = 0.0, gamma: float = 0.4,
                 max_repair_tries: int = 32):
        if alpha + beta + gamma > 1.0 + 1e-9:
            raise ValueError("require alpha + beta + gamma <= 1")
        self.swarm_size = swarm_size
        self.alpha, self.beta, self.gamma = alpha, beta, gamma
        self.max_repair_tries = max_repair_tries

    def _move(self, space: SearchSpace, rng: random.Random,
              x: Config, p_best: Config, g_best: Config) -> Config:
        """One per-dimension stochastic move; rejection-repair to feasibility."""
        params = space.parameters
        for _ in range(self.max_repair_tries):
            new: Config = {}
            for param in params:
                r = rng.random()
                if r < self.alpha:
                    new[param.name] = rng.choice(param.values)      # eps_d
                elif r < self.alpha + self.beta:
                    new[param.name] = p_best[param.name]            # local best
                elif r < self.alpha + self.beta + self.gamma:
                    new[param.name] = g_best[param.name]            # global best
                else:
                    new[param.name] = x[param.name]                 # stay
            if space.is_feasible(new):
                return new
        return space.sample(rng)    # repair failed: rerandomise the particle

    def run(self, space, objective, budget, seed=0,
            seeds=None) -> SearchResult:
        rng = random.Random(seed)
        rec = _Recorder(space, objective)
        n = self.swarm_size
        # Warm start: the first particles spawn at the seed configs, the
        # rest randomly — the swarm explores around transferred winners.
        planted = usable_seeds(space, seeds, limit=n)
        xs = planted + [space.sample(rng) for _ in range(n - len(planted))]
        ts = [rec.evaluate(x) for x in xs]
        p_best = list(xs)
        p_time = list(ts)
        g_i = min(range(n), key=lambda i: p_time[i])
        g_best, g_time = dict(p_best[g_i]), p_time[g_i]
        particle_traces: List[List[float]] = [[t] for t in ts]
        while rec.evaluations < budget:
            for i in range(n):
                if rec.evaluations >= budget:
                    break
                xs[i] = self._move(space, rng, xs[i], p_best[i], g_best)
                ts[i] = rec.evaluate(xs[i])
                particle_traces[i].append(ts[i])
                if ts[i] < p_time[i]:
                    p_best[i], p_time[i] = dict(xs[i]), ts[i]
                if ts[i] < g_time:
                    g_best, g_time = dict(xs[i]), ts[i]
        return SearchResult(self.name, rec.trials, rec.best, rec.evaluations,
                            extra={"particle_traces": particle_traces,
                                   "swarm_size": n})

    def asktell(self, space, budget, seed=0, seeds=None) -> "AskTellDriver":
        return _ParticleSwarmAskTell(self, space, budget, seed=seed,
                                     seeds=seeds)


class GreedyCoordinateDescent(Strategy):
    """Beyond-paper: cycle through parameters, greedily taking the best value
    of each while holding the others fixed; restart from a random point when
    a full cycle yields no improvement.  Cheap and surprisingly strong on the
    near-separable sharding spaces; included as a pluggable-strategy demo.
    """

    name = "greedy"

    def run(self, space, objective, budget, seed=0,
            seeds=None) -> SearchResult:
        rng = random.Random(seed)
        rec = _Recorder(space, objective)
        # Warm start: descend from the best seed instead of a random point
        current, t_cur = None, math.inf
        for cfg in usable_seeds(space, seeds, limit=budget):
            t = rec.evaluate(cfg)
            if current is None or t < t_cur:
                current, t_cur = cfg, t
        if current is None:
            current = space.sample(rng)
            t_cur = rec.evaluate(current)
        while rec.evaluations < budget:
            improved = False
            for param in space.parameters:
                if rec.evaluations >= budget:
                    break
                for v in param.values:
                    if v == current[param.name]:
                        continue
                    cand = dict(current)
                    cand[param.name] = v
                    if not space.is_feasible(cand):
                        continue
                    t = rec.evaluate(cand)
                    if t < t_cur:
                        current, t_cur = cand, t
                        improved = True
                    if rec.evaluations >= budget:
                        break
            if not improved:
                current = space.sample(rng)      # random restart
                t_cur = rec.evaluate(current)
        return SearchResult(self.name, rec.trials, rec.best, rec.evaluations)


class Evolutionary(Strategy):
    """Genetic algorithm — the paper's named future-work strategy (§III-B).

    Tournament selection, uniform crossover per dimension, per-dimension
    mutation to a random value; elitism keeps the incumbent.  Infeasible
    offspring are repaired by re-sampling.
    """

    name = "evolutionary"

    def __init__(self, population: int = 8, mutation_rate: float = 0.15,
                 tournament: int = 3, max_repair_tries: int = 32):
        self.population = population
        self.mutation_rate = mutation_rate
        self.tournament = tournament
        self.max_repair_tries = max_repair_tries

    def _offspring(self, space: SearchSpace, rng: random.Random,
                   a: Config, b: Config) -> Config:
        for _ in range(self.max_repair_tries):
            child: Config = {}
            for p in space.parameters:
                v = a[p.name] if rng.random() < 0.5 else b[p.name]
                if rng.random() < self.mutation_rate:
                    v = rng.choice(p.values)
                child[p.name] = v
            if space.is_feasible(child):
                return child
        return space.sample(rng)

    def run(self, space, objective, budget, seed=0,
            seeds=None) -> SearchResult:
        rng = random.Random(seed)
        rec = _Recorder(space, objective)
        # Warm start: seeds join generation 0 (elitism then carries the
        # best transferred config forward until something beats it)
        planted = usable_seeds(space, seeds, limit=self.population)
        pop = planted + [space.sample(rng)
                         for _ in range(self.population - len(planted))]
        fit = [rec.evaluate(x) for x in pop]

        def tourney() -> Config:
            idx = min(rng.sample(range(len(pop)),
                                 min(self.tournament, len(pop))),
                      key=lambda i: fit[i])
            return pop[idx]

        while rec.evaluations < budget:
            elite_i = min(range(len(pop)), key=lambda i: fit[i])
            new_pop = [pop[elite_i]]
            new_fit = [fit[elite_i]]
            while len(new_pop) < self.population \
                    and rec.evaluations < budget:
                child = self._offspring(space, rng, tourney(), tourney())
                new_pop.append(child)
                new_fit.append(rec.evaluate(child))
            pop, fit = new_pop, new_fit
        return SearchResult(self.name, rec.trials, rec.best,
                            rec.evaluations,
                            extra={"population": self.population})

    def asktell(self, space, budget, seed=0, seeds=None) -> "AskTellDriver":
        return _EvolutionaryAskTell(self, space, budget, seed=seed,
                                    seeds=seeds)


# ---------------------------------------------------------------------------
# Batch ask/tell drivers — the EvaluationEngine's view of a strategy
# ---------------------------------------------------------------------------

class AskTellDriver:
    """Inverted-control interface over one search run.

    The evaluation engine pulls *batches* of candidate configurations with
    ``ask()`` (an empty batch means the search finished), evaluates them
    however it likes — parallel compilation, memoisation, early-stop
    pruning — and reports objective values back with ``tell()``.
    ``result()`` is valid once ``ask()`` has returned an empty batch.

    Generation-based strategies (full, random, PSO, evolutionary) provide
    native drivers whose batches are whole populations; every other
    strategy inherits :class:`SequentialAskTell`, which runs the
    strategy's own ``run`` loop unchanged and surfaces its objective
    calls one configuration at a time.
    """

    strategy: Strategy

    def ask(self) -> List[Config]:
        raise NotImplementedError

    def tell(self, results: List[Tuple[Config, float]]) -> None:
        raise NotImplementedError

    def result(self) -> SearchResult:
        raise NotImplementedError

    def close(self) -> None:
        """Release resources (idempotent; safe after an aborted search)."""


class SequentialAskTell(AskTellDriver):
    """Bridge ``strategy.run`` into ask/tell via a worker thread.

    The compatibility path: any Strategy subclass — including
    user-registered ones that only implement ``run`` — works with the
    engine, one configuration per batch, with trial-for-trial identical
    results to a direct ``run()`` call (the strategy's own code runs,
    its objective calls are simply answered from the engine).
    """

    def __init__(self, strategy: Strategy, space: SearchSpace,
                 budget: Optional[int], seed: int = 0,
                 seeds: Optional[Sequence[Config]] = None):
        self.strategy = strategy
        self._requests: "queue.Queue[Optional[Config]]" = queue.Queue(1)
        self._responses: "queue.Queue[float]" = queue.Queue(1)
        self._result: Optional[SearchResult] = None
        self._error: Optional[BaseException] = None
        self._finished = False
        self._awaiting_tell = False
        self._aborted = False
        run_kwargs: Dict[str, Any] = {"seed": seed}
        if seeds:
            # inject warm-start seeds into strategies whose run() takes
            # them (annealing, greedy, any compliant user strategy); a
            # legacy run() signature just searches cold
            if accepts_kwarg(strategy.run, "seeds"):
                run_kwargs["seeds"] = [dict(c) for c in seeds]
            else:
                log.debug("strategy %r ignores warm-start seeds",
                          strategy.name)

        def _objective(config: Config) -> float:
            self._requests.put(dict(config))
            return self._responses.get()

        def _run() -> None:
            try:
                self._result = strategy.run(space, _objective, budget,
                                            **run_kwargs)
            except BaseException as e:  # noqa: BLE001 — surfaced on next ask
                self._error = e
            finally:
                self._requests.put(None)        # sentinel: run() returned

        self._thread = threading.Thread(
            target=_run, name=f"asktell-{strategy.name}", daemon=True)
        self._thread.start()

    def ask(self) -> List[Config]:
        if self._finished:
            return []
        if self._awaiting_tell:
            raise RuntimeError("ask() called with a tell() still pending")
        config = self._requests.get()
        if config is None:
            self._finished = True
            self._thread.join()
            if self._error is not None:
                raise self._error
            return []
        self._awaiting_tell = True
        return [config]

    def tell(self, results: List[Tuple[Config, float]]) -> None:
        if not self._awaiting_tell:
            raise RuntimeError("tell() without a pending ask()")
        (_, time_s), = results
        self._awaiting_tell = False
        self._responses.put(float(time_s))

    def result(self) -> SearchResult:
        if self._aborted:
            raise RuntimeError(
                "result() unavailable: the driver was closed before the "
                "search finished, so the strategy's own result would be a "
                "drained partial run; the caller aborting the search is "
                "responsible for assembling a partial result (the "
                "EvaluationEngine synthesizes one from its tell history)")
        if not self._finished or self._result is None:
            raise RuntimeError("result() before the search finished")
        return self._result

    def close(self) -> None:
        # Unblock an abandoned strategy thread (engine aborted mid-search):
        # answer every outstanding objective call with inf until run()
        # returns, then join the worker thread.  Bounded because every
        # strategy is budget-bounded.
        if not self._finished:
            self._aborted = True
        while not self._finished:
            if self._awaiting_tell:
                self._awaiting_tell = False
                self._responses.put(math.inf)
            nxt = self._requests.get()
            if nxt is None:
                self._finished = True
            else:
                self._awaiting_tell = True
        self._thread.join()


class _BatchRecorder:
    """Trial log + incumbent for native batched drivers."""

    def __init__(self):
        self.trials: List[Trial] = []
        self.best: Optional[Trial] = None

    def add(self, config: Config, time_s: float) -> None:
        trial = Trial(config=dict(config), time=float(time_s),
                      index=len(self.trials))
        self.trials.append(trial)
        if trial.ok and (self.best is None or trial.time < self.best.time):
            self.best = trial

    @property
    def evaluations(self) -> int:
        return len(self.trials)


class _FullSearchAskTell(AskTellDriver):
    """Exhaustive enumeration in engine-sized chunks."""

    def __init__(self, strategy: FullSearch, space: SearchSpace,
                 budget: Optional[int], chunk: int = 64):
        self.strategy = strategy
        self._iter = strategy._configs(space)
        self._budget = math.inf if budget is None else budget
        self._chunk = chunk
        self._rec = _BatchRecorder()
        self._asked = 0

    def ask(self) -> List[Config]:
        limit = int(min(self._chunk, self._budget - self._asked))
        batch: List[Config] = []
        while len(batch) < limit:
            try:
                batch.append(next(self._iter))
            except StopIteration:
                break
        self._asked += len(batch)
        return batch

    def tell(self, results: List[Tuple[Config, float]]) -> None:
        for cfg, t in results:
            self._rec.add(cfg, t)

    def result(self) -> SearchResult:
        return SearchResult(self.strategy.name, self._rec.trials,
                            self._rec.best, self._rec.evaluations)


def _require_budget(strategy: Strategy, budget: Optional[int]) -> int:
    """Only full search supports budget=None (exhaustive enumeration)."""
    if budget is None:
        raise ValueError(f"strategy {strategy.name!r} requires a finite "
                         "budget (budget=None is full-search only)")
    return budget


class _RandomSearchAskTell(AskTellDriver):
    """The whole random sample is one batch — maximally overlappable.

    Warm-start seeds lead the batch; random draws fill the remainder.
    """

    def __init__(self, strategy: RandomSearch, space: SearchSpace,
                 budget: int, seed: int = 0,
                 seeds: Optional[Sequence[Config]] = None):
        budget = _require_budget(strategy, budget)
        self.strategy = strategy
        rng = random.Random(seed)
        planted = usable_seeds(space, seeds, limit=budget)
        self._pending: List[Config] = planted + _sample_avoiding(
            space, rng, budget - len(planted), planted)
        self._shortfall = budget - len(self._pending)
        self._rec = _BatchRecorder()

    def ask(self) -> List[Config]:
        batch, self._pending = self._pending, []
        return batch

    def tell(self, results: List[Tuple[Config, float]]) -> None:
        for cfg, t in results:
            self._rec.add(cfg, t)

    def result(self) -> SearchResult:
        extra: Dict[str, object] = {}
        if self._shortfall > 0:
            extra["sample_shortfall"] = self._shortfall
        return SearchResult(self.strategy.name, self._rec.trials,
                            self._rec.best, self._rec.evaluations,
                            extra=extra)


class _ParticleSwarmAskTell(AskTellDriver):
    """Generation-synchronous PSO: each batch is the whole swarm.

    Within a generation every particle moves against the generation-start
    global best (classic synchronous PSO), whereas ``ParticleSwarm.run``
    refreshes the global best particle-by-particle; the two trajectories
    coincide whenever no particle improves the incumbent mid-round.
    """

    def __init__(self, strategy: ParticleSwarm, space: SearchSpace,
                 budget: int, seed: int = 0,
                 seeds: Optional[Sequence[Config]] = None):
        self.strategy = strategy
        self.space = space
        self.rng = random.Random(seed)
        self._budget = _require_budget(strategy, budget)
        self._rec = _BatchRecorder()
        n = strategy.swarm_size
        planted = usable_seeds(space, seeds, limit=n)
        self.xs = planted + [space.sample(self.rng)
                             for _ in range(n - len(planted))]
        self.p_best = [dict(x) for x in self.xs]
        self.p_time = [math.inf] * n
        self.g_best: Optional[Config] = None
        self.g_time = math.inf
        self.traces: List[List[float]] = [[] for _ in range(n)]
        self._moved_once = False
        self._asked_idx: List[int] = []

    def ask(self) -> List[Config]:
        remaining = self._budget - self._rec.evaluations
        if remaining <= 0:
            return []
        if self._moved_once:
            g = self.g_best if self.g_best is not None else self.xs[0]
            for i in range(len(self.xs)):
                self.xs[i] = self.strategy._move(
                    self.space, self.rng, self.xs[i], self.p_best[i], g)
        self._moved_once = True
        self._asked_idx = list(range(int(min(remaining, len(self.xs)))))
        return [dict(self.xs[i]) for i in self._asked_idx]

    def tell(self, results: List[Tuple[Config, float]]) -> None:
        for i, (cfg, t) in zip(self._asked_idx, results):
            t = float(t)
            self._rec.add(cfg, t)
            self.traces[i].append(t)
            if t < self.p_time[i]:
                self.p_best[i], self.p_time[i] = dict(cfg), t
            if t < self.g_time:
                self.g_best, self.g_time = dict(cfg), t

    def result(self) -> SearchResult:
        return SearchResult(self.strategy.name, self._rec.trials,
                            self._rec.best, self._rec.evaluations,
                            extra={"particle_traces": self.traces,
                                   "swarm_size": self.strategy.swarm_size,
                                   "synchronous": True})


class _EvolutionaryAskTell(AskTellDriver):
    """Generation-batched GA: ask yields the next population's offspring."""

    def __init__(self, strategy: Evolutionary, space: SearchSpace,
                 budget: int, seed: int = 0,
                 seeds: Optional[Sequence[Config]] = None):
        self.strategy = strategy
        self.space = space
        self.rng = random.Random(seed)
        self._budget = _require_budget(strategy, budget)
        self._rec = _BatchRecorder()
        self.pop: List[Config] = []
        self.fit: List[float] = []
        planted = usable_seeds(space, seeds, limit=strategy.population)
        self._initial = planted + [
            space.sample(self.rng)
            for _ in range(strategy.population - len(planted))]
        self._elite: Optional[Tuple[Config, float]] = None
        self._asked: List[Config] = []

    def _tourney(self) -> Config:
        idx = min(self.rng.sample(range(len(self.pop)),
                                  min(self.strategy.tournament,
                                      len(self.pop))),
                  key=lambda i: self.fit[i])
        return self.pop[idx]

    def ask(self) -> List[Config]:
        remaining = self._budget - self._rec.evaluations
        if remaining <= 0:
            return []
        if self._initial is not None:
            batch, self._initial = self._initial, None
        else:
            elite_i = min(range(len(self.pop)), key=lambda i: self.fit[i])
            self._elite = (self.pop[elite_i], self.fit[elite_i])
            batch = [self.strategy._offspring(self.space, self.rng,
                                              self._tourney(),
                                              self._tourney())
                     for _ in range(self.strategy.population - 1)]
        self._asked = batch[: int(min(remaining, len(batch)))]
        return [dict(c) for c in self._asked]

    def tell(self, results: List[Tuple[Config, float]]) -> None:
        told = [(dict(cfg), float(t)) for cfg, t in results]
        for cfg, t in told:
            self._rec.add(cfg, t)
        if self._elite is None:              # initial population
            self.pop = [c for c, _ in told]
            self.fit = [t for _, t in told]
        else:
            elite, elite_fit = self._elite
            self.pop = [elite] + [c for c, _ in told]
            self.fit = [elite_fit] + [t for _, t in told]

    def result(self) -> SearchResult:
        return SearchResult(self.strategy.name, self._rec.trials,
                            self._rec.best, self._rec.evaluations,
                            extra={"population": self.strategy.population,
                                   "synchronous": True})


# ---------------------------------------------------------------------------
# Registry ("other search methods are easily pluggable into CLTune")
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[..., Strategy]] = {
    "full": FullSearch,
    "random": RandomSearch,
    "annealing": SimulatedAnnealing,
    "pso": ParticleSwarm,
    "greedy": GreedyCoordinateDescent,
    "evolutionary": Evolutionary,
}


def register_strategy(name: str, factory: Callable[..., Strategy]) -> None:
    if name in _REGISTRY:
        raise ValueError(f"strategy {name!r} already registered")
    _REGISTRY[name] = factory


def make_strategy(name: str, **kwargs) -> Strategy:
    try:
        factory = _REGISTRY[name]
    except KeyError as e:
        raise KeyError(f"unknown strategy {name!r}; known: {sorted(_REGISTRY)}") from e
    return factory(**kwargs)


def available_strategies() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
