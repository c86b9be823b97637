"""The port's evaluation engine (``repro_torch.core.engine``): a twin of
tests/test_engine.py — the dedup memo, ask/tell equivalence, early-stop
pruning, retries and the engine's plumbing through ``tune_kernel`` — on
the CPU, with the analytical evaluator on a modeled H100.

The last section runs the same spaces, objectives and strategies through
the JAX package's engine and the port's in one process, and holds the
port's trial sequences and engine statistics to the JAX package's.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref_core  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro_torch.core import (EngineConfig, ParticleSwarm,  # noqa: E402
                              SearchSpace, SimulatedAnnealing, Strategy,
                              make_strategy, median_prune_loop)


def make_space(n_params=4, n_values=4, pkg=port_core):
    sp = pkg.SearchSpace()
    for i in range(n_params):
        sp.add_parameter(name=f"p{i}", values=tuple(range(n_values)))
    return sp


def quadratic(cfg):
    return 1.0 + sum((v - 2) ** 2 for v in cfg.values())


def _table_evaluator(pkg):
    """The table evaluator on ``pkg``'s Evaluator and Measurement."""

    class TableEvaluator(pkg.Evaluator):
        """Deterministic objective with wallclock-style prune semantics.

        ``measure`` draws ``samples`` identical timing samples through
        :func:`median_prune_loop`, so the engine's prune threshold behaves
        exactly as it does for the real WallClockEvaluator — without
        timers.
        """

        name = "table"

        def __init__(self, fn, samples=5):
            self.fn = fn
            self.samples = samples
            self.prepare_calls = 0
            self.measure_calls = 0

        def prepare(self, spec, config):
            self.prepare_calls += 1
            return "artifact"

        def measure(self, spec, config, prepared=None,
                    prune_threshold_s=None):
            assert prepared == "artifact", \
                "engine must hand back prepare()'s artifact"
            self.measure_calls += 1
            t = float(self.fn(config))
            if not math.isfinite(t):
                return pkg.Measurement(time_s=math.inf, ok=False)
            seq, pruned = pkg.median_prune_loop(
                lambda: t, self.samples, prune_threshold_s=prune_threshold_s)
            m = pkg.Measurement(time_s=float(np.median(seq)), ok=True,
                                detail={"samples": len(seq)})
            if pruned:
                m.detail["pruned"] = True
            return m

    return TableEvaluator


TableEvaluator = _table_evaluator(port_core)


def run_engine(strategy, budget, *, fn=quadratic, space=None, seed=0,
               pkg=port_core, **engine_kwargs):
    space = space or make_space(pkg=pkg)
    ev = _table_evaluator(pkg)(fn)
    spec = pkg.KernelSpec(name="stub", build=lambda c: (lambda: None))
    eng = pkg.EvaluationEngine(ev, spec, space,
                               pkg.EngineConfig(**engine_kwargs))
    res = eng.run(strategy, budget, seed=seed)
    return res, eng, ev


# -- dedup memo ---------------------------------------------------------------

def test_dedup_memo_counts_and_reuses():
    # gamma=1 collapses the swarm onto its global best: heavy revisiting
    strat = ParticleSwarm(swarm_size=3, alpha=0.0, beta=0.0, gamma=1.0)
    res, eng, ev = run_engine(strat, 30)
    s = res.extra["engine"]
    assert s["memo_hits"] > 0
    assert s["evaluations"] == s["memo_hits"] + s["unique_configs"]
    # every unique config measured exactly once, none recompiled
    assert ev.measure_calls == s["unique_configs"]
    assert ev.prepare_calls == s["compile_calls"]
    assert s["compile_calls"] == s["unique_configs"]
    assert len(eng.measurements) == s["unique_configs"]


def test_memo_returns_identical_measurement():
    strat = ParticleSwarm(swarm_size=2, alpha=0.0, beta=0.0, gamma=1.0)
    res, eng, _ = run_engine(strat, 20)
    # every trial's time must match the memoised measurement for its config
    for trial in res.trials:
        key = tuple(trial.config[n] for n in ("p0", "p1", "p2", "p3"))
        assert eng.measurements[key].time_s == trial.time


# -- ask/tell equivalence -----------------------------------------------------

@pytest.mark.parametrize("strategy_factory", [
    lambda: SimulatedAnnealing(),
    lambda: ParticleSwarm(swarm_size=3),
])
def test_sequential_fallback_identical_to_direct_run(strategy_factory):
    """Engine + sequential driver == strategy.run, trial for trial."""
    sp = make_space()
    direct = strategy_factory().run(sp, quadratic, 40, seed=7)
    res, _, _ = run_engine(strategy_factory(), 40, seed=7, batching=False)
    assert [t.time for t in res.trials] == [t.time for t in direct.trials]
    assert [t.config for t in res.trials] == [t.config for t in direct.trials]
    assert res.best_config == direct.best_config


@pytest.mark.parametrize("name,kwargs", [
    ("pso", {"swarm_size": 3}),
    ("evolutionary", {"population": 6}),
])
def test_batched_drivers_deterministic_and_budgeted(name, kwargs):
    r1, _, _ = run_engine(make_strategy(name, **kwargs), 40, seed=3)
    r2, _, _ = run_engine(make_strategy(name, **kwargs), 40, seed=3)
    assert [t.time for t in r1.trials] == [t.time for t in r2.trials]
    assert r1.best_config == r2.best_config
    assert r1.evaluations <= 40
    assert r1.best is not None


def test_batched_pso_matches_sequential_quality():
    """Synchronous (batched) PSO must find the same optimum as the
    sequential walk on an easy seeded space within the same budget."""
    direct = ParticleSwarm(swarm_size=3).run(make_space(), quadratic, 60,
                                             seed=0)
    res, _, _ = run_engine(ParticleSwarm(swarm_size=3), 60, seed=0)
    assert res.best_time == direct.best_time == 1.0


def test_full_search_through_engine_is_exhaustive():
    sp = make_space(n_params=3, n_values=3)
    res, _, ev = run_engine(make_strategy("full"), None, space=sp)
    assert res.evaluations == sp.size()
    assert ev.measure_calls == sp.size()
    assert res.best_time == 1.0


# -- early-stop pruning -------------------------------------------------------

def test_median_prune_loop_semantics():
    samples, pruned = median_prune_loop(lambda: 1.0, 5)
    assert len(samples) == 5 and not pruned
    # above threshold: aborts before completing all repeats
    samples, pruned = median_prune_loop(lambda: 2.0, 5, prune_threshold_s=1.0)
    assert pruned and len(samples) < 5
    # at/below threshold: runs to completion
    samples, pruned = median_prune_loop(lambda: 0.5, 5, prune_threshold_s=1.0)
    assert len(samples) == 5 and not pruned


def test_pruning_never_prunes_incumbent():
    times = {0: 5.0, 1: 3.0, 2: 8.0, 3: 1.0, 4: 9.0}
    sp = SearchSpace().add_parameter(name="T", values=tuple(times))
    res, eng, _ = run_engine(
        make_strategy("full"), None, fn=lambda c: times[c["T"]], space=sp,
        prune_factor=1.5, workers=1)
    by_key = {k[0]: m for k, m in eng.measurements.items()}
    # first config: no incumbent yet -> cannot be pruned
    assert not by_key[0].pruned
    # improving configs (new incumbents) are never pruned
    assert not by_key[1].pruned and not by_key[3].pruned
    # configs beyond k x incumbent are aborted early
    assert by_key[2].pruned and by_key[4].pruned
    assert res.extra["engine"]["pruned"] == 2
    # pruning never corrupts the search outcome
    assert res.best_config == {"T": 3} and res.best_time == 1.0
    assert not eng.measurements[(3,)].pruned


def test_pruned_measurement_never_becomes_best():
    # adversarial: prune threshold k=1 (tightest legal) on a noisy-ish table
    times = {i: 1.0 + 0.5 * i for i in range(8)}
    sp = SearchSpace().add_parameter(name="T", values=tuple(times))
    res, eng, _ = run_engine(
        make_strategy("full"), None, fn=lambda c: times[c["T"]], space=sp,
        prune_factor=1.0, workers=1)
    best_key = (res.best_config["T"],)
    assert not eng.measurements[best_key].pruned


# -- acceptance-mirror: 200-config PSO through the engine --------------------

def test_pso_200_fewer_compiles_than_evaluations():
    res, _, ev = run_engine(make_strategy("pso", swarm_size=6), 200,
                            prune_factor=2.0)
    s = res.extra["engine"]
    assert s["evaluations"] == 200
    assert s["compile_calls"] < s["evaluations"]
    assert s["compile_calls"] == ev.prepare_calls
    assert s["memo_hits"] == 200 - s["unique_configs"]


# -- speculation --------------------------------------------------------------

def test_speculative_prefetch_counts_and_preserves_results():
    direct = SimulatedAnnealing().run(make_space(), quadratic, 30, seed=5)
    res, _, ev = run_engine(SimulatedAnnealing(), 30, seed=5,
                            speculate=3, workers=4)
    # speculation warms compiles but never changes the search trajectory
    assert [t.time for t in res.trials] == [t.time for t in direct.trials]
    s = res.extra["engine"]
    assert s["speculative_compiles"] > 0
    assert s["speculative_hits"] <= s["speculative_compiles"]
    # compile_calls includes speculation; measures only actual evaluations
    assert ev.measure_calls == s["unique_configs"]


# -- failure handling ---------------------------------------------------------

def test_infeasible_configs_never_become_incumbent():
    def fn(cfg):
        return math.inf if cfg["p0"] == 2 else quadratic(cfg)
    res, _, _ = run_engine(make_strategy("full"), None, fn=fn)
    assert res.best_config["p0"] != 2
    assert math.isfinite(res.best_time)


def test_custom_registered_strategy_works_via_fallback():
    class TwoStep(Strategy):
        name = "twostep"

        def run(self, space, objective, budget, seed=0):
            from repro_torch.core.strategies import _Recorder
            rec = _Recorder(space, objective)
            import random as _random
            rng = _random.Random(seed)
            for _ in range(budget):
                rec.evaluate(space.sample(rng))
            from repro_torch.core import SearchResult
            return SearchResult(self.name, rec.trials, rec.best,
                                rec.evaluations)

    res, _, _ = run_engine(TwoStep(), 10)
    assert res.evaluations == 10 and res.best is not None


# -- API plumbing -------------------------------------------------------------

def test_tune_kernel_exposes_engine_stats(tmp_path):
    from repro_torch.core import H100_SXM, TuningCache
    from repro_torch.tune import tune_kernel
    out = tune_kernel("gemm", {"M": 512, "N": 512, "K": 512},
                      strategy="pso", budget=30, record=False,
                      profile=H100_SXM,
                      cache=TuningCache(str(tmp_path / "c.json")),
                      engine={"workers": 2}, swarm_size=3)
    s = out.engine_stats
    assert s is not None
    assert s["evaluations"] == out.result.evaluations
    assert s["compile_calls"] <= s["evaluations"]
    assert "engine:" in out.report()


def test_engine_config_validation():
    with pytest.raises(ValueError):
        EngineConfig(workers=0)
    with pytest.raises(ValueError):
        EngineConfig(prune_factor=0.5)
    assert EngineConfig().workers >= 1      # None = auto-sized pool


def test_batched_drivers_reject_none_budget():
    # budget=None (exhaustive) is a full-search concept; the other native
    # drivers must fail fast rather than crash mid-search or loop forever
    for name in ("random", "pso", "evolutionary"):
        with pytest.raises(ValueError):
            make_strategy(name).asktell(make_space(), None)


# -- parity with the JAX package -------------------------------------------------

def _priced_table(seed):
    """A seeded table of times over the 4 x 4 x 4 x 4 space, with one
    infeasible value of p3."""
    rng = np.random.default_rng(seed)
    times = rng.uniform(1.0, 10.0, size=(4, 4, 4, 4))

    def fn(cfg):
        if cfg["p3"] == 1:
            return math.inf
        return float(times[cfg["p0"], cfg["p1"], cfg["p2"], cfg["p3"]])

    return fn


#: (strategy factory, budget, seed, engine kwargs): each case runs through
#: both engines; the prune cases measure one config at a time, so the
#: incumbent each threshold sees is fixed
ENGINE_CASES = {
    "pso-revisits": (lambda pkg: pkg.ParticleSwarm(
        swarm_size=3, alpha=0.0, beta=0.0, gamma=1.0), 30, 0, {}),
    "annealing-sequential": (lambda pkg: pkg.SimulatedAnnealing(), 40, 7,
                             {"batching": False}),
    "annealing-batched": (lambda pkg: pkg.SimulatedAnnealing(), 40, 7, {}),
    "pso-batched": (lambda pkg: pkg.make_strategy("pso", swarm_size=3),
                    40, 3, {}),
    "evolutionary": (lambda pkg: pkg.make_strategy(
        "evolutionary", population=6), 40, 3, {}),
    "random": (lambda pkg: pkg.make_strategy("random"), 25, 11, {}),
    "full-pruned": (lambda pkg: pkg.make_strategy("full"), None, 0,
                    {"prune_factor": 1.5, "workers": 1}),
    "pso-200-pruned": (lambda pkg: pkg.make_strategy("pso", swarm_size=6),
                       200, 0, {"prune_factor": 2.0, "workers": 1}),
    "annealing-speculate": (lambda pkg: pkg.SimulatedAnnealing(), 30, 5,
                            {"speculate": 3, "workers": 4}),
}

#: EngineStats fields that do not depend on timing
COUNTED = ("evaluations", "unique_configs", "memo_hits", "compile_calls",
           "artifact_hits", "speculative_compiles", "speculative_hits",
           "pruned", "predicted_pruned", "proven_pruned",
           "predictor_rank_used", "compile_failures", "measure_failures",
           "retries", "aborted", "batches", "max_batch")


def _engine_digest(pkg, case, table_seed):
    factory, budget, seed, kwargs = ENGINE_CASES[case]
    res, eng, ev = run_engine(factory(pkg), budget, seed=seed, pkg=pkg,
                              fn=_priced_table(table_seed), **kwargs)
    stats = res.extra["engine"]
    # speculative compiles race the search on the pool: compare only what
    # speculation must leave unchanged
    racing = (("compile_calls", "speculative_compiles", "speculative_hits")
              if kwargs.get("speculate") else ())
    return {
        "trials": [(dict(t.config), t.time) for t in res.trials],
        "best": (res.best_config, res.best_time),
        "evaluations": res.evaluations,
        "stats": {k: stats[k] for k in COUNTED if k not in racing},
        "measurements": {k: (m.time_s, m.ok, m.pruned)
                         for k, m in eng.measurements.items()},
        "calls": (None if racing else ev.prepare_calls, ev.measure_calls),
    }


@pytest.mark.parametrize("table_seed", [0, 1])
@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_matches_the_jax_package(case, table_seed):
    """The same strategy over the same seeded table: the port's engine
    makes the JAX package's trials, memo, prunes and counts."""
    port = _engine_digest(port_core, case, table_seed)
    ref = _engine_digest(ref_core, case, table_seed)
    assert port == ref
    assert port["trials"] and math.isfinite(port["best"][1])


def test_engine_stats_fields_match_the_jax_package():
    import dataclasses
    assert ([f.name for f in dataclasses.fields(port_core.EngineStats)]
            == [f.name for f in dataclasses.fields(ref_core.EngineStats)])
