"""The port's failure-isolating evaluation (``repro_torch.core.failures``
and the engine's fault boundary): a twin of tests/test_failures.py, on the
CPU — failed configs become trials, not crashes; the retry policy; the
max_failures circuit breaker; the typed-error contract of the built-in
evaluators (the wall-clock one timing the plain versions with
``device="cpu"``, the analytical one on a modeled H100); and the cache,
annealing, ask/tell and sampling regressions the JAX package's test holds.

The last section runs the same failing evaluators through the JAX
package's engine and the port's in one process, and holds the port's
failure records, summaries, retries and circuit-breaker aborts to the JAX
package's.
"""

import builtins
import json
import math
import random
import threading

import pytest

torch = pytest.importorskip("torch")

import repro.core as ref_core  # noqa: E402
from repro.core import failures as ref_failures  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro_torch.core import failures as port_failures  # noqa: E402

from repro_torch.core import (H100_SXM, AnalyticalEvaluator,  # noqa: E402
                              CacheEntry, CompileError, EngineConfig,
                              EvaluationEngine, Evaluator, FailureRecord,
                              KernelSpec, MeasureError, Measurement,
                              RandomSearch, RetryPolicy, SearchSpace,
                              SequentialAskTell, SimulatedAnnealing,
                              TransientError, Tuner, TuningCache,
                              VerificationFailure, WallClockEvaluator,
                              make_strategy)


def make_space(n_params=3, n_values=4):
    sp = SearchSpace()
    for i in range(n_params):
        sp.add_parameter(name=f"p{i}", values=tuple(range(n_values)))
    return sp


SPEC = KernelSpec(name="stub", build=lambda c: (lambda: None))


class HostileEvaluator(Evaluator):
    """prepare raises for p0==1, measure raises for p1==2; rest succeed."""

    name = "hostile"

    def __init__(self):
        self.prepare_calls = 0
        self.measure_calls = 0

    def prepare(self, spec, config):
        self.prepare_calls += 1
        if config["p0"] == 1:
            raise CompileError(f"p0=1 never compiles: {config}")
        return "artifact"

    def measure(self, spec, config, prepared=None, prune_threshold_s=None):
        self.measure_calls += 1
        if config["p1"] == 2:
            raise MeasureError(f"p1=2 crashes at run time: {config}")
        return Measurement(time_s=1.0 + sum(config.values()), ok=True)


def run_engine(strategy, budget, evaluator=None, space=None, seed=0,
               **engine_kwargs):
    space = space or make_space()
    ev = evaluator or HostileEvaluator()
    eng = EvaluationEngine(ev, SPEC, space, EngineConfig(**engine_kwargs))
    res = eng.run(strategy, budget, seed=seed)
    return res, eng, ev


# -- the fault boundary -------------------------------------------------------

def test_prepare_raising_evaluator_survives_full_sweep():
    sp = make_space()
    res, eng, _ = run_engine(make_strategy("full"), None, space=sp)
    s = res.extra["engine"]
    # the full budget completes despite ~44% of configs raising
    assert s["evaluations"] == sp.size() == 64
    assert s["compile_failures"] == 16          # p0==1: 1 * 4 * 4
    assert s["measure_failures"] == 12          # p1==2 minus p0==1 overlap
    # every failed trial is an inf trial with a populated FailureRecord
    failed = res.failures()
    assert len(failed) == 28
    for t in failed:
        assert t.time == math.inf
        assert isinstance(t.failure, FailureRecord)
        assert t.failure.stage in ("prepare", "measure")
        assert t.failure.message
        assert t.failure.config_key == sp.config_key(t.config)
    # the winner comes from the surviving configs
    assert res.best_config["p0"] != 1 and res.best_config["p1"] != 2
    assert math.isfinite(res.best_time)


def test_failure_stages_attributed_correctly():
    res, eng, _ = run_engine(make_strategy("full"), None)
    stages = {key: rec.stage for key, rec in eng.failures.items()}
    for key, stage in stages.items():
        if key[0] == 1:                         # p0==1 -> prepare
            assert stage == "prepare"
        else:                                   # p1==2 -> measure
            assert stage == "measure"
    summary = res.failure_summary()
    assert summary["by_stage"] == {"prepare": 16, "measure": 12}
    assert summary["by_type"] == {"CompileError": 16, "MeasureError": 12}


def test_bare_exceptions_from_user_evaluators_are_isolated():
    class Rude(Evaluator):
        name = "rude"

        def prepare(self, spec, config):
            if config["p0"] == 0:
                raise ValueError("bare exception, no taxonomy")
            return None

        def measure(self, spec, config, prepared=None,
                    prune_threshold_s=None):
            if config["p1"] == 0:
                raise ZeroDivisionError("oops")
            return Measurement(time_s=2.0, ok=True)

    res, eng, _ = run_engine(make_strategy("full"), None, evaluator=Rude())
    assert res.extra["engine"]["evaluations"] == 64
    by_type = res.failure_summary()["by_type"]
    assert by_type["ValueError"] == 16
    assert by_type["ZeroDivisionError"] == 12
    # bare prepare exceptions still attribute to the prepare stage
    assert eng.failures[(0, 3, 3)].stage == "prepare"
    assert eng.failures[(3, 0, 3)].stage == "measure"


def test_failed_configs_are_memoised_not_reevaluated():
    # gamma=1 PSO collapses onto its best and revisits constantly; failures
    # must be answered from the memo without recompiling
    from repro_torch.core import ParticleSwarm
    strat = ParticleSwarm(swarm_size=3, alpha=0.3, beta=0.0, gamma=0.5)
    res, eng, ev = run_engine(strat, 60, seed=1)
    s = res.extra["engine"]
    assert s["evaluations"] == 60
    assert s["memo_hits"] + s["unique_configs"] == 60
    assert ev.prepare_calls == s["compile_calls"] == s["unique_configs"]
    # one FailureRecord per failed unique config, however often revisited
    assert len(eng.failures) == s["compile_failures"] + s["measure_failures"]


def test_sequential_fallback_survives_failures():
    # annealing runs through the thread-bridged driver; a raising evaluator
    # must not kill the bridge thread or the search.  (The strategy's own
    # recorder answers revisits, so engine evaluations <= trials.)
    res, _, _ = run_engine(SimulatedAnnealing(), 40, seed=3)
    assert len(res.trials) == 40
    assert res.extra["engine"]["compile_failures"] > 0
    assert math.isfinite(res.best_time)


def test_legacy_failed_measurement_becomes_failure_record():
    class Legacy(Evaluator):
        name = "legacy"

        def measure(self, spec, config, prepared=None,
                    prune_threshold_s=None):
            if config["p0"] == 2:
                return Measurement(time_s=math.inf, ok=False,
                                   error="legacy not-ok measurement")
            return Measurement(time_s=1.0, ok=True)

    res, eng, _ = run_engine(make_strategy("full"), None, evaluator=Legacy())
    assert res.extra["engine"]["measure_failures"] == 16
    rec = eng.failures[(2, 0, 0)]
    assert rec.error_type == "FailedMeasurement"
    assert rec.message == "legacy not-ok measurement"


def test_legacy_not_ok_with_finite_time_never_wins():
    # a not-ok Measurement carrying a (bogus) finite time must be coerced
    # to inf: it can never become the incumbent or look like an ok trial
    class Misleading(Evaluator):
        name = "mis"

        def measure(self, spec, config, prepared=None,
                    prune_threshold_s=None):
            if config["p0"] == 0:
                return Measurement(time_s=0.0, ok=False, error="skipped")
            return Measurement(time_s=2.0, ok=True)

    res, eng, _ = run_engine(make_strategy("full"), None,
                             evaluator=Misleading())
    assert res.best_time == 2.0
    assert res.best_config["p0"] != 0
    failed = res.failures()
    assert len(failed) == 16
    assert all(t.time == math.inf and t.failure is not None for t in failed)


def test_engine_rerun_starts_with_clean_failure_state():
    res1, eng, _ = run_engine(make_strategy("full"), None, max_failures=40)
    assert len(eng.failures) == 28 and not res1.extra["engine"]["aborted"]
    # second run on the same engine: carried-over failures must not trip
    # the breaker early or inflate the new run's stats
    res2 = eng.run(make_strategy("full"), None, seed=1)
    s2 = res2.extra["engine"]
    assert s2["evaluations"] == 64 and not s2["aborted"]
    assert len(eng.failures) == 28              # this run's failures only


def test_generic_transient_error_keeps_observed_stage():
    # TransientError's class-level stage is the generic "evaluate"; a
    # failure raised from measure() must still count as a measure failure
    class FlakyMeasure(Evaluator):
        name = "fm"

        def prepare(self, spec, config):
            return "artifact"

        def measure(self, spec, config, prepared=None,
                    prune_threshold_s=None):
            raise TransientError("device busy")

    res, eng, _ = run_engine(make_strategy("random"), 3,
                             evaluator=FlakyMeasure(), workers=1)
    s = res.extra["engine"]
    assert s["measure_failures"] == 3 and s["compile_failures"] == 0
    assert all(r.stage == "measure" for r in eng.failures.values())


# -- retry policy -------------------------------------------------------------

def test_retry_transient_then_succeed():
    class OnceFlaky(Evaluator):
        name = "once"

        def __init__(self):
            self.seen = set()

        def prepare(self, spec, config):
            key = tuple(config.values())
            if key not in self.seen:
                self.seen.add(key)
                raise TransientError("first attempt always flaky")
            return "artifact"

        def measure(self, spec, config, prepared=None,
                    prune_threshold_s=None):
            return Measurement(time_s=1.0, ok=True)

    res, eng, _ = run_engine(make_strategy("random"), 10,
                             evaluator=OnceFlaky(), retry=1)
    s = res.extra["engine"]
    assert s["retries"] == 10
    assert not eng.failures and s["compile_failures"] == 0
    assert all(t.ok for t in res.trials)


def test_retry_exhaustion_records_attempts():
    class AlwaysFlaky(Evaluator):
        name = "flaky"

        def prepare(self, spec, config):
            raise TransientError("never succeeds")

        def measure(self, spec, config, prepared=None,
                    prune_threshold_s=None):
            return Measurement(time_s=1.0, ok=True)

    res, eng, _ = run_engine(make_strategy("random"), 4,
                             evaluator=AlwaysFlaky(), retry=2)
    assert len(eng.failures) == 4
    for rec in eng.failures.values():
        assert rec.attempts == 3                # 1 original + 2 retries
    assert res.extra["engine"]["retries"] == 8


def test_measure_retry_reuses_compiled_artifact():
    # a transient measure failure must not pay a recompile on retry: the
    # artifact is valid, only the timing run misbehaved
    class FlakyTiming(Evaluator):
        name = "ft"

        def __init__(self):
            self.prepare_calls = 0
            self.measured = set()

        def prepare(self, spec, config):
            self.prepare_calls += 1
            return "artifact"

        def measure(self, spec, config, prepared=None,
                    prune_threshold_s=None):
            assert prepared == "artifact"
            key = tuple(config.values())
            if key not in self.measured:
                self.measured.add(key)
                raise TransientError("timing run hit contention")
            return Measurement(time_s=1.0, ok=True)

    res, eng, ev = run_engine(make_strategy("random"), 5,
                              evaluator=FlakyTiming(), retry=1, workers=1)
    s = res.extra["engine"]
    assert s["retries"] == 5 and not eng.failures
    assert ev.prepare_calls == 5                # one compile per config
    assert s["compile_calls"] == 5


def test_retry_skips_systematic_failures_by_default():
    ev = HostileEvaluator()
    res, eng, _ = run_engine(make_strategy("full"), None, evaluator=ev,
                             retry=3)
    # CompileError/MeasureError are not transient: no retry burned on them
    assert res.extra["engine"]["retries"] == 0
    for rec in eng.failures.values():
        assert rec.attempts == 1


def test_retry_all_failures_when_transient_only_off():
    class FirstAttemptFails(Evaluator):
        """Non-transient error on every config's first attempt only."""

        name = "f"

        def __init__(self):
            self.seen = set()

        def prepare(self, spec, config):
            key = tuple(config.values())
            if key not in self.seen:
                self.seen.add(key)
                raise CompileError("flaky host, not a transient error type")
            return None

        def measure(self, spec, config, prepared=None,
                    prune_threshold_s=None):
            return Measurement(time_s=1.0, ok=True)

    res, eng, _ = run_engine(
        make_strategy("random"), 6, evaluator=FirstAttemptFails(),
        retry={"max_retries": 1, "transient_only": False}, workers=1)
    assert not eng.failures
    assert res.extra["engine"]["retries"] == 6


def test_retry_policy_normalization_and_validation():
    assert EngineConfig(retry=None).retry == RetryPolicy()
    assert EngineConfig(retry=2).retry.max_retries == 2
    assert EngineConfig(retry=RetryPolicy(max_retries=1)).retry.max_retries == 1
    assert not EngineConfig(
        retry={"max_retries": 1}).retry.should_retry(ValueError(), 1)
    with pytest.raises(ValueError):
        RetryPolicy(max_retries=-1)
    with pytest.raises(ValueError):
        EngineConfig(max_failures=0)


# -- circuit breaker ----------------------------------------------------------

def test_circuit_breaker_aborts_gracefully_keeping_trials():
    class Broken(Evaluator):
        name = "broken"

        def prepare(self, spec, config):
            raise CompileError("the whole space is broken")

        def measure(self, spec, config, prepared=None,
                    prune_threshold_s=None):
            return Measurement(time_s=1.0, ok=True)

    res, eng, _ = run_engine(make_strategy("full"), None,
                             evaluator=Broken(), max_failures=5, workers=1)
    s = res.extra["engine"]
    assert s["aborted"] is True
    assert len(eng.failures) == 5
    # the partial result keeps every trial measured before the trip
    assert len(res.trials) == 5
    assert res.evaluations == 5
    assert "aborted" in res.extra
    assert res.extra["aborted"]["max_failures"] == 5
    assert "systematically broken" in res.extra["aborted"]["reason"]
    # failed trials still carry their records in the partial result
    assert all(t.failure is not None for t in res.trials)


def test_circuit_breaker_preserves_finite_measurements():
    # 50% broken space, breaker sized to trip mid-way: the partial result
    # must keep the finite measurements and report a best.  (p0 odd fails,
    # so full-search iteration measures the p0=0 block before tripping.)
    def fail_half(config):
        return config["p0"] % 2 == 1

    class Half(Evaluator):
        name = "half"

        def prepare(self, spec, config):
            if fail_half(config):
                raise CompileError("half the space is broken")
            return None

        def measure(self, spec, config, prepared=None,
                    prune_threshold_s=None):
            return Measurement(time_s=1.0 + sum(config.values()), ok=True)

    res, eng, _ = run_engine(make_strategy("full"), None, evaluator=Half(),
                             max_failures=10, workers=1)
    assert res.extra["engine"]["aborted"]
    assert res.best is not None and math.isfinite(res.best_time)
    kept = [t for t in res.trials if t.ok]
    assert kept and all(not fail_half(t.config) for t in kept)


def test_circuit_breaker_sequential_strategy_aborts():
    class Broken(Evaluator):
        name = "broken"

        def prepare(self, spec, config):
            raise CompileError("nope")

        def measure(self, spec, config, prepared=None,
                    prune_threshold_s=None):
            return Measurement(time_s=1.0, ok=True)

    res, eng, _ = run_engine(SimulatedAnnealing(), 30, evaluator=Broken(),
                             max_failures=4)
    assert res.extra["engine"]["aborted"]
    assert len(res.trials) == 4
    assert res.strategy == "annealing"


def test_breaker_disabled_by_default_tolerates_any_failure_count():
    class Broken(Evaluator):
        name = "broken"

        def prepare(self, spec, config):
            raise CompileError("nope")

        def measure(self, spec, config, prepared=None,
                    prune_threshold_s=None):
            return Measurement(time_s=1.0, ok=True)

    sp = make_space(n_params=2)                 # 16 configs, all broken
    res, _, _ = run_engine(make_strategy("full"), None, evaluator=Broken(),
                           space=sp)
    assert res.extra["engine"]["evaluations"] == 16
    assert res.best is None
    assert not res.extra["engine"]["aborted"]


# -- typed errors from the built-in evaluators --------------------------------

def _broken_build(cfg):
    raise ValueError("this kernel cannot be built")


def test_wallclock_prepare_raises_compile_error():
    spec = KernelSpec(name="b", build=_broken_build,
                      make_args=lambda rng: (1.0,))
    with pytest.raises(CompileError):
        WallClockEvaluator(device="cpu").prepare(spec, {})
    # the internal one-call path folds it back into a failed Measurement
    m = WallClockEvaluator(device="cpu")._evaluate(spec, {})
    assert not m.ok and m.time_s == math.inf and "ValueError" in m.error


def test_wallclock_verification_raises_verification_failure():
    import numpy as np

    spec = KernelSpec(
        name="v", build=lambda cfg: (lambda x: x + 1.0),
        make_args=lambda rng: (np.float32(1.0),),
        reference=lambda x: x)                  # reference disagrees
    ev = WallClockEvaluator(repeats=1, device="cpu")
    prepared = ev.prepare(spec, {})
    with pytest.raises(VerificationFailure):
        ev.measure(spec, {}, prepared)
    m = ev._evaluate(spec, {})
    assert not m.ok and "verification failed" in m.error


def test_analytical_infeasible_raises_typed_error():
    from repro_torch.core import InfeasibleConfigError

    spec = KernelSpec(name="k", build=lambda c: (lambda: None),
                      analytical_model=lambda c, p: math.inf)
    with pytest.raises(InfeasibleConfigError):
        AnalyticalEvaluator(profile=H100_SXM).measure(spec, {})
    m = AnalyticalEvaluator(profile=H100_SXM)._evaluate(spec, {})
    assert not m.ok and m.time_s == math.inf


# -- acceptance mirror: hostile tune never poisons the cache ------------------

def test_hostile_tune_completes_and_cache_stays_clean(tmp_path):
    """~30% of configs raise in prepare; the tune completes its budget,
    every failure carries a FailureRecord, EngineStats reports the split,
    and no inf entry reaches the TuningCache."""
    def build(cfg):
        if cfg["TILE"] in (3, 6, 9):            # 3 of 10 values -> 30%
            raise ValueError(f"unbuildable TILE={cfg['TILE']}")
        return lambda x: x * cfg["TILE"]

    cache = TuningCache(str(tmp_path / "cache.json"))
    t = Tuner(evaluator=WallClockEvaluator(repeats=1, verify_outputs=False,
                                         device="cpu"),
              cache=cache)
    t.add_kernel(build, name="hostile",
                 make_args=lambda rng: (1.0,))
    t.add_parameter("TILE", list(range(10)))
    out = t.tune(strategy="full", record_to_cache=True, shape_key="s")
    s = out.engine_stats
    assert s["evaluations"] == 10
    assert s["compile_failures"] == 3
    failed = out.result.failures()
    assert len(failed) == 3
    assert all(t_.failure is not None and t_.failure.stage == "prepare"
               for t_ in failed)
    assert out.best_config["TILE"] not in (3, 6, 9)
    # report surfaces the failure summary
    assert "failures: 3 trial(s)" in out.report()
    # the cache holds exactly the finite winner, strict-JSON clean
    entry = cache.get("hostile", "s", out.profile)
    assert entry is not None and math.isfinite(entry.time_s)
    raw = json.loads(open(cache.path).read())
    assert all(math.isfinite(v["time_s"]) for v in raw.values())


# -- TuningCache thread-safety ------------------------------------------------

def test_cache_concurrent_reads_and_writes(tmp_path):
    cache = TuningCache(str(tmp_path / "c.json"))
    errors = []

    def writer(i):
        try:
            for j in range(50):
                cache.record(f"k{i}", f"s{j % 5}", "p", {"v": j},
                             1.0 / (j + 1), "full", j)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    def reader():
        try:
            for _ in range(100):
                len(cache)
                cache.entries()
                cache.get("k0", "s0", "p")
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = ([threading.Thread(target=writer, args=(i,)) for i in range(4)]
               + [threading.Thread(target=reader) for _ in range(4)])
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors
    assert len(cache) == 4 * 5                  # 4 kernels x 5 shape keys
    cache.save()
    assert json.load(open(cache.path))


# -- strict JSON --------------------------------------------------------------

def test_cache_record_refuses_non_finite_times(tmp_path):
    cache = TuningCache(str(tmp_path / "c.json"))
    assert not cache.record("k", "s", "p", {"a": 1}, math.inf, "full", 1)
    assert not cache.record("k", "s", "p", {"a": 1}, math.nan, "full", 1)
    assert not cache.put("k", "s", "p", CacheEntry(
        config={}, time_s=math.inf, strategy="full", evaluations=1,
        timestamp=0.0))
    assert len(cache) == 0
    assert cache.record("k", "s", "p", {"a": 1}, 1e-3, "full", 1)


def test_cache_load_drops_legacy_infinity_entries(tmp_path):
    # a cache file written before the strict-JSON change may contain
    # Infinity; loading must drop those entries (json.load accepts them)
    # so the next save() cannot crash on legacy poison
    path = tmp_path / "legacy.json"
    path.write_text('{"k|s|p": {"config": {}, "time_s": Infinity, '
                    '"strategy": "full", "evaluations": 1, "timestamp": 0}, '
                    '"k2|s|p": {"config": {"a": 1}, "time_s": 0.001, '
                    '"strategy": "full", "evaluations": 1, "timestamp": 0}}')
    cache = TuningCache(str(path)).load()
    assert len(cache) == 1
    assert cache.get("k", "s", "p") is None
    assert cache.get("k2", "s", "p").time_s == 0.001
    cache.record("k3", "s", "p", {"b": 2}, 2e-3, "full", 1)
    cache.save()                                # must not raise
    assert len(json.load(open(path))) == 2


def test_cache_save_is_strict_json(tmp_path):
    cache = TuningCache(str(tmp_path / "c.json"))
    cache.record("k", "s", "p", {"a": 1}, 1e-3, "full", 1)
    cache.save()
    # strict parsers must accept the file
    assert json.loads(open(cache.path).read(),
                      parse_constant=lambda c: pytest.fail(
                          f"non-strict constant {c} in cache JSON"))
    # defense in depth: hand-injected inf makes save raise, not emit
    cache._data["bad"] = {"time_s": math.inf}
    with pytest.raises(ValueError):
        cache.save()


# -- SA temperature scale -----------------------------------------------------

def test_annealing_scale_from_first_finite_measurement():
    """First eval inf + objective magnitudes ~1e3: a stale scale of 1.0
    would make every worse-move acceptance probability exp(-1000/T) ~ 0."""
    sp = make_space(n_params=2, n_values=8)
    state = {"first": True}

    def objective(cfg):
        if state["first"]:
            state["first"] = False
            return math.inf
        return 1000.0 * (1.0 + sum(v % 3 for v in cfg.values()))

    r = SimulatedAnnealing(temperature=4.0, cooling=False).run(
        sp, objective, budget=80, seed=0)
    # with the scale recomputed from the first finite measurement the walk
    # accepts worse moves at these magnitudes; the stale scale never did
    assert r.extra["accepted_worse"] > 0


def test_annealing_first_eval_inf_still_finds_optimum():
    sp = make_space()
    state = {"first": True}

    def objective(cfg):
        if state["first"]:
            state["first"] = False
            return math.inf
        return 1.0 + sum((v - 2) ** 2 for v in cfg.values())

    r = SimulatedAnnealing().run(sp, objective, budget=60, seed=2)
    assert math.isfinite(r.best_time)


# -- SequentialAskTell.close --------------------------------------------------

def test_sequential_asktell_close_joins_thread_after_abort():
    driver = SequentialAskTell(SimulatedAnnealing(), make_space(), 20, seed=0)
    batch = driver.ask()
    assert len(batch) == 1
    driver.tell([(batch[0], 1.0)])
    driver.ask()                                # leave a tell pending
    driver.close()                              # abandon mid-search
    assert not driver._thread.is_alive()
    with pytest.raises(RuntimeError, match="closed before the search"):
        driver.result()
    driver.close()                              # idempotent


def test_sequential_asktell_normal_completion_still_returns_result():
    driver = SequentialAskTell(make_strategy("greedy"), make_space(), 5,
                               seed=0)
    while True:
        batch = driver.ask()
        if not batch:
            break
        driver.tell([(batch[0], 1.0 + sum(batch[0].values()))])
    res = driver.result()                       # finished naturally: fine
    assert res.evaluations == 5
    driver.close()
    assert not driver._thread.is_alive()
    assert driver.result().evaluations == 5     # close after finish: no abort


# -- sample_unique shortfall --------------------------------------------------

def test_sample_unique_enumeration_fallback_finds_full_space():
    # p0 == p1: 16 feasible of 256; rejection may stall, the fallback must
    # still deliver every feasible config when asked for exactly that many
    sp = SearchSpace()
    sp.add_parameter(name="p0", values=tuple(range(16)))
    sp.add_parameter(name="p1", values=tuple(range(16)))
    sp.add_constraint(lambda a, b: a == b, ["p0", "p1"])
    out = sp.sample_unique(random.Random(0), 16)
    assert len(out) == 16
    assert len({tuple(sorted(c.items())) for c in out}) == 16


def test_sample_unique_true_shortfall_reports_in_random_search():
    # only ONE feasible config exists; a 5-eval random search must return
    # it and surface the 4-config shortfall instead of silently shrinking
    sp = SearchSpace()
    sp.add_parameter(name="p0", values=tuple(range(8)))
    sp.add_parameter(name="p1", values=tuple(range(8)))
    sp.add_constraint(lambda a, b: a + b == 14, ["p0", "p1"])
    assert sp.size() == 1
    r = RandomSearch().run(sp, lambda c: 1.0, budget=5, seed=0)
    assert r.evaluations == 1
    assert r.extra["sample_shortfall"] == 4
    # same contract through the engine's batched driver
    class One(Evaluator):
        name = "one"

        def measure(self, spec, config, prepared=None,
                    prune_threshold_s=None):
            return Measurement(time_s=1.0, ok=True)

    eng = EvaluationEngine(One(), SPEC, sp, EngineConfig(workers=1))
    res = eng.run(make_strategy("random"), 5, seed=0)
    assert res.extra["sample_shortfall"] == 4


# -- parity with the JAX package -------------------------------------------------

def _failing_evaluators(pkg):
    """The evaluators above, on ``pkg``'s Evaluator, Measurement and error
    types: name -> a factory of a fresh evaluator."""
    ok = lambda t: pkg.Measurement(time_s=t, ok=True)  # noqa: E731

    class Base(pkg.Evaluator):
        name = "parity"

        def prepare(self, spec, config):
            return "artifact"

        def measure(self, spec, config, prepared=None,
                    prune_threshold_s=None):
            return ok(1.0 + sum(config.values()))

    class Hostile(Base):
        def prepare(self, spec, config):
            if config["p0"] == 1:
                raise pkg.CompileError(f"p0=1 never compiles: {config}")
            return "artifact"

        def measure(self, spec, config, prepared=None,
                    prune_threshold_s=None):
            if config["p1"] == 2:
                raise pkg.MeasureError(f"p1=2 crashes at run time: {config}")
            return ok(1.0 + sum(config.values()))

    class Rude(Base):
        def prepare(self, spec, config):
            if config["p0"] == 0:
                raise ValueError("bare exception, no taxonomy")
            return None

        def measure(self, spec, config, prepared=None,
                    prune_threshold_s=None):
            if config["p1"] == 0:
                raise ZeroDivisionError("oops")
            return ok(2.0)

    class Legacy(Base):
        def measure(self, spec, config, prepared=None,
                    prune_threshold_s=None):
            if config["p0"] == 2:
                return pkg.Measurement(time_s=math.inf, ok=False,
                                       error="legacy not-ok measurement")
            if config["p0"] == 0:
                return pkg.Measurement(time_s=0.0, ok=False, error="skipped")
            return ok(1.0 + config["p1"])

    class Flaky(Base):
        """First attempt of each config fails in ``stage`` with ``error``."""

        def __init__(self, stage, error):
            self.stage, self.error, self.seen = stage, error, set()

        def _first(self, config, stage):
            key = tuple(config.values())
            if stage == self.stage and key not in self.seen:
                self.seen.add(key)
                raise self.error(f"first {stage} attempt fails")

        def prepare(self, spec, config):
            self._first(config, "prepare")
            return "artifact"

        def measure(self, spec, config, prepared=None,
                    prune_threshold_s=None):
            self._first(config, "measure")
            return ok(1.0 + sum(config.values()))

    class Always(Base):
        def __init__(self, error, stage="prepare"):
            self.error, self.stage = error, stage

        def prepare(self, spec, config):
            if self.stage == "prepare":
                raise self.error("never succeeds")
            return "artifact"

        def measure(self, spec, config, prepared=None,
                    prune_threshold_s=None):
            raise self.error("device busy")

    class Half(Base):
        def prepare(self, spec, config):
            if config["p0"] % 2:
                raise pkg.CompileError("half the space is broken")
            return None

    return {
        "hostile": Hostile, "rude": Rude, "legacy": Legacy, "half": Half,
        "once-flaky": lambda: Flaky("prepare", pkg.TransientError),
        "flaky-timing": lambda: Flaky("measure", pkg.TransientError),
        "first-compile-fails": lambda: Flaky("prepare", pkg.CompileError),
        "always-flaky": lambda: Always(pkg.TransientError),
        "broken": lambda: Always(pkg.CompileError),
        "busy-measure": lambda: Always(pkg.TransientError, "measure"),
    }


#: (evaluator, strategy factory, budget, seed, engine kwargs)
FAILURE_CASES = {
    "hostile-full": ("hostile", lambda pkg: pkg.make_strategy("full"),
                     None, 0, {}),
    "hostile-full-retry": ("hostile", lambda pkg: pkg.make_strategy("full"),
                           None, 0, {"retry": 3}),
    "hostile-pso": ("hostile", lambda pkg: pkg.ParticleSwarm(
        swarm_size=3, alpha=0.3, beta=0.0, gamma=0.5), 60, 1, {}),
    "hostile-annealing": ("hostile", lambda pkg: pkg.SimulatedAnnealing(),
                          40, 3, {}),
    "rude-full": ("rude", lambda pkg: pkg.make_strategy("full"), None, 0,
                  {}),
    "legacy-full": ("legacy", lambda pkg: pkg.make_strategy("full"), None,
                    0, {}),
    "once-flaky-retry": ("once-flaky", lambda pkg: pkg.make_strategy(
        "random"), 10, 0, {"retry": 1}),
    "always-flaky-retry": ("always-flaky", lambda pkg: pkg.make_strategy(
        "random"), 4, 0, {"retry": 2}),
    "flaky-timing-retry": ("flaky-timing", lambda pkg: pkg.make_strategy(
        "random"), 5, 0, {"retry": 1, "workers": 1}),
    "retry-every-failure": ("first-compile-fails",
                            lambda pkg: pkg.make_strategy("random"), 6, 0,
                            {"retry": {"max_retries": 1,
                                       "transient_only": False},
                             "workers": 1}),
    "transient-measure": ("busy-measure", lambda pkg: pkg.make_strategy(
        "random"), 3, 0, {"workers": 1}),
    "breaker-full": ("broken", lambda pkg: pkg.make_strategy("full"), None,
                     0, {"max_failures": 5, "workers": 1}),
    "breaker-half": ("half", lambda pkg: pkg.make_strategy("full"), None, 0,
                     {"max_failures": 10, "workers": 1}),
    "breaker-annealing": ("broken", lambda pkg: pkg.SimulatedAnnealing(),
                          30, 0, {"max_failures": 4}),
    "broken-no-breaker": ("broken", lambda pkg: pkg.make_strategy("full"),
                          None, 0, {}),
}


def _failure_digest(pkg, case):
    ev_name, strategy, budget, seed, kwargs = FAILURE_CASES[case]
    sp = pkg.SearchSpace()
    for i in range(3):
        sp.add_parameter(name=f"p{i}", values=tuple(range(4)))
    spec = pkg.KernelSpec(name="stub", build=lambda c: (lambda: None))
    ev = _failing_evaluators(pkg)[ev_name]()
    eng = pkg.EvaluationEngine(ev, spec, sp, pkg.EngineConfig(**kwargs))
    res = eng.run(strategy(pkg), budget, seed=seed)
    stats = res.extra["engine"]
    return {
        "trials": [(dict(t.config), t.time, t.ok,
                    t.failure.to_json() if t.failure else None)
                   for t in res.trials],
        "best": (res.best_config, res.best_time),
        "summary": res.failure_summary(),
        "aborted": res.extra.get("aborted"),
        "failures": {k: r.to_json() for k, r in eng.failures.items()},
        "stats": {k: stats[k] for k in (
            "evaluations", "unique_configs", "memo_hits", "compile_calls",
            "compile_failures", "measure_failures", "retries", "aborted")},
    }


@pytest.mark.parametrize("case", sorted(FAILURE_CASES))
def test_failures_match_the_jax_package(case):
    """The same failing evaluator and search: the port records the JAX
    package's failures (stage, type, message, attempts), summaries,
    retries and aborts, trial for trial."""
    port = _failure_digest(port_core, case)
    assert port == _failure_digest(ref_core, case)
    assert port["summary"]["total"] > 0 or port["stats"]["retries"] > 0


def _raise(exc):
    try:
        raise exc
    except BaseException as e:  # noqa: BLE001 — the record of any error
        return e


#: exceptions by name, each made in either package
ERRORS = ("CompileError", "MeasureError", "VerificationFailure",
          "InfeasibleConfigError", "EvaluationTimeout", "TransientError",
          "EvaluationError", "ValueError")


def _error(mod, name):
    cls = getattr(mod, name, None) or getattr(builtins, name)
    return cls(f"{name} at p0=3")


@pytest.mark.parametrize("stage", ["prepare", "measure", "evaluate"])
def test_failure_records_and_retries_match_the_jax_package(stage):
    """Each error type classifies into the same record, summary and retry
    decision in both packages."""
    def digest(mod):
        records = [mod.FailureRecord.from_exception(
            _raise(_error(mod, name)), stage=stage, config_key=(3, 0, 1),
            attempts=a) for a, name in enumerate(ERRORS, start=1)]
        policies = [mod.RetryPolicy.normalize(v) for v in
                    (None, 2, {"max_retries": 1, "transient_only": False})]
        return ([r.to_json() for r in records], [str(r) for r in records],
                mod.summarize_failures(records),
                [[p.should_retry(_error(mod, name), a) for name in ERRORS
                  for a in (1, 2, 3)] for p in policies])

    port = digest(port_failures)
    assert port == digest(ref_failures)
    assert {r["stage"] for r in port[0]} >= {stage}
