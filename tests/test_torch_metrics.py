"""The port's structured metrics and typed objectives
(``repro_torch.core.metrics``): a twin of tests/test_metrics_objectives.py,
on the CPU — Metrics statistics, the Objective spec grammar and identity,
engine scalarization, objective-scoped cache keys, trial identity of the
default objective, and no internal path re-triggering the deprecated
``evaluate()`` — with the analytical evaluator on a modeled H100.

The last section computes the same statistics, objectives, objective-scoped
cache files and objective-driven searches with the JAX package and the
port in one process, and holds the port's to the JAX package's.
"""

import dataclasses
import json
import math
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref_core  # noqa: E402
import repro.core.cache as ref_cache  # noqa: E402
import repro.tune as ref_tune  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
import repro_torch.core.cache as port_cache  # noqa: E402
import repro_torch.tune as port_tune  # noqa: E402

from repro_torch.core import (H100_SXM, AnalyticalEvaluator,  # noqa: E402
                              ArrivalTraceEvaluator, CacheEntry,
                              EngineConfig, InfeasibleConfigError, Metrics,
                              Objective, SearchSpace, TuningCache, tunable)
from repro_torch.core.cache import normalize_objective  # noqa: E402
from repro_torch.core.evaluators import KernelSpec  # noqa: E402
from repro_torch.core.metrics import (DEFAULT_OBJECTIVE,  # noqa: E402
                                      default_objective)
from repro_torch.tune import tune_kernel  # noqa: E402


@pytest.fixture
def cache(tmp_path):
    return TuningCache(str(tmp_path / "tuned.json"))


def _kernel(name, times):
    """Toy kernel whose analytical model returns times[X] per config."""

    def space(shape):
        sp = SearchSpace()
        sp.add_parameter(name="X", values=sorted(times))
        return sp

    @tunable(name=name, space=space, heuristic=lambda s: {"X": min(times)},
             analytical_model=lambda s, cfg, p: times[cfg["X"]],
             register=False)
    def build(shape, config):
        return lambda: config["X"]

    return build


# -- Metrics ------------------------------------------------------------------

def test_metrics_statistics():
    m = Metrics(samples=(3.0, 1.0, 2.0, 4.0, 5.0))
    assert m.median == 3.0 and m.mean == 3.0
    assert m.best == 1.0 and m.worst == 5.0
    assert m.p99 == pytest.approx(4.96)
    assert m.percentile(0) == 1.0


def test_metrics_requires_samples():
    with pytest.raises(ValueError):
        Metrics(samples=())


def test_metrics_throughput_both_directions():
    m = Metrics(samples=(2.0,), work=8.0)
    assert m.throughput == 4.0
    assert m.inverse_throughput == 0.25
    unknown = Metrics(samples=(2.0,))
    assert unknown.throughput == 0.0
    assert unknown.inverse_throughput == math.inf


def test_metrics_to_json_round_trips_samples():
    m = Metrics(samples=(1e-3, 2e-3), compile_s=0.5, work=64.0)
    d = json.loads(json.dumps(m.to_json()))
    assert d["samples"] == [1e-3, 2e-3]
    assert d["compile_s"] == 0.5 and d["work"] == 64.0
    assert Metrics.from_samples(d["samples"]).median == m.median


# -- Objective ----------------------------------------------------------------

def test_objective_presets_scalarize():
    m = Metrics(samples=tuple(float(i) for i in range(1, 101)))
    assert Objective.parse("median_time").scalarize(m) == m.median
    assert Objective.parse("p99_time").scalarize(m) == m.p99
    assert Objective.parse("min_time").scalarize(m) == 1.0


def test_objective_weighted_terms_and_canonical_spec():
    a = Objective.parse("0.7*median_time+0.3*p99_time")
    b = Objective.parse("0.3*p99_time + 0.7*median_time")   # reordered
    assert a == b and hash(a) == hash(b)
    assert a.spec == b.spec
    m = Metrics(samples=(1.0, 2.0, 3.0))
    assert a.scalarize(m) == pytest.approx(0.7 * m.median + 0.3 * m.p99)
    # duplicate terms merge their weights
    c = Objective.parse("0.5*p99_time+0.5*p99_time")
    assert c == "p99_time"


def test_objective_identity_against_strings():
    assert Objective.parse("median_time") == "median_time"
    assert Objective.parse("median_time").is_default
    assert not Objective.parse("p99_time").is_default
    assert str(Objective.parse("throughput")) == "throughput"


def test_objective_rejects_bad_specs():
    for bad in ("", "warp_speed", "0*median_time", "-1*p99_time",
                "x*median_time", "median_time++p99_time"):
        with pytest.raises(ValueError):
            Objective.parse(bad)
    with pytest.raises(TypeError):
        Objective.coerce(42)


def test_objective_coerce_none_is_default():
    assert Objective.coerce(None) is DEFAULT_OBJECTIVE
    assert Objective.coerce("p99_time") == Objective.parse("p99_time")


def test_objective_scalarize_none_metrics_is_inf():
    assert Objective.parse("p99_time").scalarize(None) == math.inf


def test_default_objective_env_override(monkeypatch):
    assert default_objective() is DEFAULT_OBJECTIVE
    monkeypatch.setenv("REPRO_OBJECTIVE", "p99_time")
    assert default_objective() == "p99_time"
    # EngineConfig's None objective picks up the session default
    assert EngineConfig().objective == "p99_time"
    monkeypatch.delenv("REPRO_OBJECTIVE")
    assert EngineConfig().objective.is_default


# -- evaluators attach metrics ------------------------------------------------

def test_analytical_evaluator_attaches_sample_vector():
    spec = KernelSpec(name="k", build=lambda c: (lambda: None),
                      analytical_model=lambda c, p: 1e-3)
    ev = AnalyticalEvaluator(profile=H100_SXM, noise_sigma=0.1, seed=7, repeats=5)
    m = ev.measure(spec, {"x": 1})
    assert m.metrics is not None and len(m.metrics.samples) == 5
    # the scalar contract is intact: time_s is the FIRST draw, which is
    # byte-identical to the old single-noise-sample behavior
    legacy = AnalyticalEvaluator(profile=H100_SXM, noise_sigma=0.1, seed=7, repeats=1)
    assert m.time_s == legacy.measure(spec, {"x": 1}).time_s


def test_measurement_as_metrics_falls_back_to_scalar():
    from repro_torch.core import Measurement
    m = Measurement(time_s=2e-3, ok=True)
    assert m.as_metrics().samples == (2e-3,)
    assert Measurement(time_s=math.inf, ok=False).as_metrics() is None


def test_arrival_trace_evaluator_deterministic_and_infeasible():
    trace = [{"N": 256}, {"N": 128}, {"N": 64}]
    model = lambda s, cfg, p: s["N"] * 1e-6 / cfg["X"]       # noqa: E731
    spec = KernelSpec(name="t", build=lambda c: (lambda: None))
    ev1 = ArrivalTraceEvaluator(model, trace, H100_SXM, seed=3)
    ev2 = ArrivalTraceEvaluator(model, trace, H100_SXM, seed=3)
    m1, m2 = ev1.measure(spec, {"X": 2}), ev2.measure(spec, {"X": 2})
    assert m1.time_s == m2.time_s
    assert len(m1.metrics.samples) == len(trace)
    # infeasible at the BUCKET geometry (trace[0]) rejects the config
    bad = lambda s, cfg, p: math.inf if s["N"] == 256 else 1e-3  # noqa: E731
    with pytest.raises(InfeasibleConfigError):
        ArrivalTraceEvaluator(bad, trace, H100_SXM).measure(spec, {"X": 2})
    # ...but a ragged arrival the tiles can't cover is served padded up
    # to the bucket bound: its sample is the full-geometry cost
    ragged = lambda s, cfg, p: math.inf if s["N"] == 64 else s["N"] * 1e-6  # noqa: E731
    mp = ArrivalTraceEvaluator(ragged, trace, H100_SXM,
                               noise_sigma=0.0).measure(
        spec, {"X": 2})
    assert mp.metrics.samples == (256e-6, 128e-6, 256e-6)
    assert mp.detail["padded_arrivals"] == 1.0
    with pytest.raises(ValueError):
        ArrivalTraceEvaluator(model, [], H100_SXM)


# -- objective drives the search ----------------------------------------------

def _tail_evaluator():
    """Config A: best median, terrible tail.  Config B: the opposite."""

    class Ev(AnalyticalEvaluator):
        def measure(self, spec, config, artifact=None, **kw):
            if config["X"] == 1:        # A: median 1ms, p99 ~100ms
                samples = (1e-3,) * 99 + (100e-3,) * 21
            else:                       # B: median 2ms, p99 2ms
                samples = (2e-3,) * 120
            from repro_torch.core import Measurement
            return Measurement(time_s=samples[0], ok=True,
                               metrics=Metrics(samples=samples))

    return Ev(profile=H100_SXM, noise_sigma=0.0)


def test_p99_objective_changes_the_winner(cache):
    k = _kernel("obj_tail", {1: 1e-3, 2: 2e-3})
    med = tune_kernel(k, {"N": 64}, profile=H100_SXM, strategy="full", cache=cache,
                      record=False, evaluator=_tail_evaluator())
    p99 = tune_kernel(k, {"N": 64}, profile=H100_SXM, strategy="full", cache=cache,
                      record=False, evaluator=_tail_evaluator(),
                      objective="p99_time")
    assert med.best_config == {"X": 1}          # wins on median
    assert p99.best_config == {"X": 2}          # wins at the tail
    assert med.objective == "median_time"
    assert p99.objective == "p99_time"
    assert p99.result.objective == "p99_time"


def test_p99_objective_deterministic_under_fixed_seed(cache):
    k = _kernel("obj_det", {1: 1e-3, 2: 2e-3, 4: 4e-3})
    outs = [tune_kernel(k, {"N": 64}, profile=H100_SXM, strategy="random", budget=3, seed=11,
                        cache=cache, record=False, objective="p99_time",
                        evaluator=AnalyticalEvaluator(
                            profile=H100_SXM, noise_sigma=0.05, seed=11))
            for _ in range(2)]
    assert outs[0].best_config == outs[1].best_config
    assert outs[0].best_time == outs[1].best_time
    t0 = [(t.config, t.time) for t in outs[0].result.trials]
    t1 = [(t.config, t.time) for t in outs[1].result.trials]
    assert t0 == t1


def test_default_objective_trials_identical_to_unspecified(cache):
    """objective=None and objective='median_time' are the SAME search —
    trial-for-trial — and both read the legacy scalar directly."""
    k = _kernel("obj_ident", {1: 1e-3, 2: 2e-3, 4: 4e-3})
    ev = lambda: AnalyticalEvaluator(  # noqa: E731
        profile=H100_SXM, noise_sigma=0.05, seed=5)
    base = tune_kernel(k, {"N": 64}, profile=H100_SXM, strategy="annealing", budget=6, seed=5,
                       cache=cache, record=False, evaluator=ev())
    expl = tune_kernel(k, {"N": 64}, profile=H100_SXM, strategy="annealing", budget=6, seed=5,
                       cache=cache, record=False, evaluator=ev(),
                       objective="median_time")
    assert [(t.config, t.time) for t in base.result.trials] \
        == [(t.config, t.time) for t in expl.result.trials]
    assert base.objective == expl.objective == "median_time"
    # trials carry the structured metrics alongside the scalar
    assert all(t.metrics is not None for t in base.result.trials
               if math.isfinite(t.time))


# -- objective-scoped cache ---------------------------------------------------

def test_cache_keys_segregate_objectives(cache):
    cache.record("k", "s", "p", {"X": 1}, 1e-3, "full", 4)
    cache.record("k", "s", "p", {"X": 2}, 2e-3, "full", 4,
                 objective="p99_time")
    assert len(cache) == 2
    assert cache.get("k", "s", "p").config == {"X": 1}
    assert cache.get("k", "s", "p", objective="p99_time").config == {"X": 2}
    # default spellings collapse onto the legacy 3-field key
    assert cache.get("k", "s", "p", objective="median_time").config \
        == {"X": 1}
    p99_keys = [key for key in cache.entries() if "obj=p99_time" in key]
    assert len(p99_keys) == 1


def test_cache_refuses_cross_objective_overwrite(cache, caplog):
    import logging
    cache.record("k", "s", "p", {"X": 1}, 1e-3, "full", 4)
    entry = CacheEntry(config={"X": 9}, time_s=1e-9, strategy="full",
                       evaluations=1, timestamp=0.0, objective="p99_time")
    with caplog.at_level(logging.WARNING, logger="repro.cache"):
        # same explicit key, different objective field: refused even though
        # the time is strictly better — the numbers are incomparable
        assert cache.put("k", "s", "p", entry) is True   # distinct key: ok
    assert cache.get("k", "s", "p").config == {"X": 1}   # default untouched


def test_cache_merge_keeps_objectives_apart(cache, tmp_path):
    other = TuningCache(str(tmp_path / "other.json"))
    other.record("k", "s", "p", {"X": 7}, 1e-9, "full", 4,
                 objective="p99_time")
    other.save()
    cache.record("k", "s", "p", {"X": 1}, 1e-3, "full", 4)
    changed = cache.merge(other.path)
    # the p99 winner arrives as a NEW objective-scoped entry; the default
    # entry survives despite the "better" incomparable time
    assert len(changed) == 1
    assert cache.get("k", "s", "p").config == {"X": 1}
    assert cache.get("k", "s", "p", objective="p99_time").config == {"X": 7}


def test_cache_nearest_is_objective_pure(cache):
    cache.record("k", "s1", "p", {"X": 1}, 1e-3, "full", 4,
                 shape={"N": 128})
    cache.record("k", "s2", "p", {"X": 2}, 1e-3, "full", 4,
                 shape={"N": 256}, objective="p99_time")
    near_default = cache.nearest("k", {"N": 200}, "p")
    near_p99 = cache.nearest("k", {"N": 200}, "p", objective="p99_time")
    assert [e.config for e in near_default] == [{"X": 1}]
    assert [e.config for e in near_p99] == [{"X": 2}]


def test_legacy_cache_entries_byte_stable(cache, tmp_path):
    """A pre-objective cache file round-trips byte-identically: loading and
    saving adds no objective fields and rewrites no keys."""
    legacy = {
        "gemm|M512 N512 K512|tpu-v5e": {
            "config": {"BLOCK_M": 128}, "time_s": 1e-3,
            "strategy": "full", "evaluations": 4, "timestamp": 1.0,
            "shape": {"M": 512, "N": 512, "K": 512}},
    }
    path = tmp_path / "legacy.json"
    path.write_text(json.dumps(legacy, indent=2, sort_keys=True))
    c = TuningCache(str(path)).load()
    entry = c.get("gemm", "M512 N512 K512", "tpu-v5e")
    assert entry is not None and entry.objective is None
    c.save()
    saved = json.loads(path.read_text())
    assert saved == legacy


def test_normalize_objective_collapses_default():
    assert normalize_objective(None) is None
    assert normalize_objective("median_time") is None
    assert normalize_objective("1*median_time") is None
    assert normalize_objective("p99_time") == "p99_time"
    assert normalize_objective(Objective.parse("p99_time")) == "p99_time"


def test_tuned_outcome_records_objective_in_cache(cache):
    k = _kernel("obj_rec", {1: 1e-3, 2: 2e-3})
    out = tune_kernel(k, {"N": 64}, profile=H100_SXM, strategy="full", cache=cache,
                      objective="p99_time",
                      evaluator=AnalyticalEvaluator(profile=H100_SXM,
                                                    noise_sigma=0.0))
    assert out.objective == "p99_time"
    entry = cache.get(k.name, k.key_for({"N": 64}), H100_SXM.name,
                      objective="p99_time")
    assert entry is not None
    assert entry.objective == "p99_time"
    assert entry.config == out.best_config
    # the default-objective view of the same geometry is empty
    assert cache.get(k.name, k.key_for({"N": 64}), H100_SXM.name) is None


# -- deprecation purge --------------------------------------------------------

def test_no_internal_path_triggers_evaluate_deprecation(cache, monkeypatch):
    """Tier-1 guard: a full tune (engine, strategies, tuner, cache record)
    raises if anything still routes through the deprecated one-call
    Evaluator.evaluate() shim."""
    from repro_torch.core import evaluators as mod
    monkeypatch.setattr(mod, "_EVALUATE_DEPRECATION_EMITTED", False)
    k = _kernel("obj_nodep", {1: 1e-3, 2: 2e-3})
    with warnings.catch_warnings():
        warnings.filterwarnings("error", category=DeprecationWarning)
        out = tune_kernel(k, {"N": 64}, profile=H100_SXM, strategy="annealing", budget=6,
                          cache=cache, objective="p99_time",
                          evaluator=AnalyticalEvaluator(profile=H100_SXM,
                                                    noise_sigma=0.0))
        assert out.best_config is not None


# -- parity with the JAX package -------------------------------------------------

#: the JAX package's profile under the H100's name, so cache keys match
REF_H100 = dataclasses.replace(ref_core.TPU_V5E, name=H100_SXM.name)
#: per package: (core, tune, analytical evaluator, profile)
PKGS = {"port": (port_core, port_tune, port_core.AnalyticalEvaluator,
                 H100_SXM),
        "jax": (ref_core, ref_tune, ref_core.TPUAnalyticalEvaluator,
                REF_H100)}

STATS = ("median", "mean", "p50", "p95", "p99", "best", "worst", "std",
         "throughput", "inverse_throughput")


def _metrics_digest(pkg, samples, work):
    m = pkg.Metrics.from_samples(samples, compile_s=0.25, work=work)
    return ({name: getattr(m, name) for name in STATS},
            [m.percentile(q) for q in (0, 1, 10, 33.3, 50, 90, 99, 100)],
            m.to_json())


@pytest.mark.parametrize("n", [1, 2, 5, 100, 121])
def test_metrics_statistics_match_the_jax_package(n):
    rng = np.random.default_rng(n)
    samples = tuple(float(x) for x in rng.lognormal(-7.0, 0.5, size=n))
    work = float(rng.integers(1, 1 << 20))
    for w in (work, 0.0):
        assert (_metrics_digest(port_core, samples, w)
                == _metrics_digest(ref_core, samples, w))


SPECS = ("median_time", "p99_time", "min_time", "mean_time", "p95_time",
         "throughput", "1*median_time", "0.7*median_time+0.3*p99_time",
         "0.3*p99_time + 0.7*median_time", "0.5*p99_time+0.5*p99_time",
         "2*mean_time+1*min_time")
BAD_SPECS = ("", "warp_speed", "0*median_time", "-1*p99_time",
             "x*median_time", "median_time++p99_time")


def _objective_digest(pkg, cache_mod):
    rng = np.random.default_rng(16)
    m = pkg.Metrics(samples=tuple(float(x) for x in
                                  rng.uniform(1e-3, 5e-3, size=40)),
                    work=1e6)
    rows = []
    for spec in SPECS:
        try:
            o = pkg.Objective.parse(spec)
        except ValueError:
            rows.append((spec, "rejected"))
            continue
        rows.append((spec, o.spec, str(o), o.is_default, o.scalarize(m),
                     o.scalarize(None), cache_mod.normalize_objective(spec)))
    bad = []
    for spec in BAD_SPECS:
        try:
            pkg.Objective.parse(spec)
            bad.append(False)
        except ValueError:
            bad.append(True)
    return rows, bad


def test_objectives_match_the_jax_package():
    port = _objective_digest(port_core, port_cache)
    assert port == _objective_digest(ref_core, ref_cache)
    assert all(port[1])


def _cache_digest(pkg, tmp_path):
    """Objective-scoped records, a merge and a nearest lookup; the file
    as saved (without timestamps) and what each read returns."""
    c = pkg.TuningCache(str(tmp_path / "tuned.json"))
    c.record("k", "s", "p", {"X": 1}, 1e-3, "full", 4, shape={"N": 128})
    c.record("k", "s", "p", {"X": 2}, 2e-3, "full", 4, shape={"N": 128},
             objective="p99_time")
    c.record("k", "s", "p", {"X": 3}, 9e-4, "full", 4,
             objective="median_time")
    c.record("k", "s2", "p", {"X": 4}, 1e-3, "full", 4, shape={"N": 256},
             objective="0.7*median_time+0.3*p99_time")
    other = pkg.TuningCache(str(tmp_path / "other.json"))
    other.record("k", "s", "p", {"X": 7}, 1e-9, "full", 4,
                 objective="p99_time")
    other.record("k", "s3", "p", {"X": 8}, 5e-4, "full", 4,
                 shape={"N": 512})
    other.save()
    changed = sorted(c.merge(other.path))
    c.save()
    with open(c.path) as f:
        saved = {k: {f: v for f, v in e.items() if f != "timestamp"}
                 for k, e in json.load(f).items()}
    reads = [(e.config, e.time_s, e.objective) if e else None for e in (
        c.get("k", "s", "p"), c.get("k", "s", "p", objective="p99_time"),
        c.get("k", "s", "p", objective="1*median_time"),
        c.get("k", "s2", "p",
              objective="0.3*p99_time+0.7*median_time"))]
    near = [[e.config for e in c.nearest("k", {"N": 200}, "p",
                                         objective=o)]
            for o in (None, "p99_time", "0.7*median_time+0.3*p99_time")]
    return saved, changed, reads, near


def test_objective_scoped_cache_keys_match_the_jax_package(tmp_path):
    port = _cache_digest(port_core, tmp_path / "port")
    assert port == _cache_digest(ref_core, tmp_path / "jax")
    assert any("obj=p99_time" in key for key in port[0])


def _toy(pkg, name, times):
    def space(shape):
        sp = pkg.SearchSpace()
        sp.add_parameter(name="X", values=sorted(times))
        return sp

    @pkg.tunable(name=name, space=space, heuristic=lambda s: {"X": 1},
                 analytical_model=lambda s, cfg, p: times[cfg["X"]],
                 register=False)
    def build(shape, config):
        return lambda: config["X"]

    return build


TIMES = {1: 1e-3, 2: 1.1e-3, 4: 1.3e-3, 8: 4e-3, 16: 1.05e-3}


@pytest.mark.parametrize("objective", [None, "median_time", "p99_time",
                                       "0.7*median_time+0.3*p99_time",
                                       "min_time"])
@pytest.mark.parametrize("strategy,budget", [("full", None),
                                             ("annealing", 6),
                                             ("random", 4)])
def test_objective_searches_match_the_jax_package(tmp_path, objective,
                                                  strategy, budget):
    """The same noisy analytical search under each objective: the same
    trials, sample vectors, winner and recorded cache entry."""
    def digest(key):
        core, tune, Analytical, profile = PKGS[key]
        cache = core.TuningCache(str(tmp_path / f"{key}.json"))
        kernel = _toy(core, "obj_parity", TIMES)
        out = tune.tune_kernel(
            kernel, {"N": 64}, profile=profile,
            strategy=strategy, budget=budget, seed=5, cache=cache,
            objective=objective, warm_start=False,
            evaluator=Analytical(profile=profile, noise_sigma=0.2, seed=5))
        entry = cache.get("obj_parity", kernel.key_for({"N": 64}),
                          profile.name, objective=objective)
        return ([(t.config, t.time, t.metrics.samples if t.metrics else None)
                 for t in out.result.trials],
                out.best_config, out.best_time, str(out.objective),
                (entry.config, entry.time_s, entry.objective)
                if entry else None)

    port = digest("port")
    assert port == digest("jax")
    assert port[4] is not None and port[0]
