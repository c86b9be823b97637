"""The port's shape transfer (``repro_torch.core.registry``/``cache``):
a twin of tests/test_transfer.py, on the CPU — escaped cache keys,
nearest-shape lookup, the TRANSFER policy, warm-started search and the
lookup() failure contract — on a modeled H100 (the port resolves no
profile without a card, so each lookup names ``H100_SXM``).

The last section records the same seeded entries into the JAX package's
cache and the port's in one process, and holds the port's key escaping,
shape distances, nearest-shape picks, TRANSFER lookups, seed filtering and
warm-started trials to the JAX package's.
"""

import dataclasses
import json
import logging
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref_core  # noqa: E402
import repro.core.cache as ref_cache  # noqa: E402
import repro.tune as ref_tune  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
import repro_torch.core.cache as port_cache  # noqa: E402
import repro_torch.tune as port_tune  # noqa: E402

from repro_torch.core import (H100_SXM, AutotunePolicy,  # noqa: E402
                              CacheEntry, SearchSpace, TuningCache, lookup,
                              make_strategy, shape_distance, split_key,
                              transfer_config, tunable, usable_seeds,
                              WallClockEvaluator)
from repro_torch.core.cache import _key  # noqa: E402
from repro_torch.tune import tune_kernel, warm_start_seeds  # noqa: E402


# -- fixtures ----------------------------------------------------------------

def _toy_kernel(name="ttoy", values=(1, 2, 4, 8)):
    """time = 1/X over X values constrained to divide shape["N"]."""

    def space(shape):
        sp = SearchSpace()
        sp.add_parameter(name="X", values=values)
        sp.add_constraint(lambda x: shape["N"] % x == 0, ("X",), "N % X")
        return sp

    @tunable(name=name, space=space, heuristic=lambda s: {"X": 1},
             analytical_model=lambda s, cfg, prof: 1.0 / cfg["X"],
             register=False)
    def build(shape, config):
        return lambda: config["X"]

    return build


@pytest.fixture
def cache(tmp_path):
    return TuningCache(str(tmp_path / "cache.json"))


def _grid_space():
    sp = SearchSpace()
    sp.add_parameter(name="A", values=(1, 2, 3))
    sp.add_parameter(name="B", values=(10, 20))
    return sp


# -- cache key integrity -----------------------------------------------------

def test_cache_key_separator_cannot_collide():
    assert _key("k", "a|b", "p") != _key("k|a", "b", "p")
    assert _key("k", "a\\|b", "p") != _key("k", "a|b", "\\p")


def test_split_key_round_trips_escaped_fields():
    for fields in (("gemm", "M512_N512", "h100_sxm"),
                   ("sharding_cell", "dense|train|mp", "h100_sxm"),
                   ("k", "we\\ird|sh\\\\ape||", "p|")):
        assert split_key(_key(*fields)) == list(fields)


def test_cache_pipe_shape_keys_are_isolated(cache):
    cache.record("sharding_cell", "a|b|mp", "p", {"F": 1}, 1.0, "full", 1)
    cache.record("sharding_cell", "a", "b|mp|p", {"F": 2}, 1.0, "full", 1)
    assert cache.get("sharding_cell", "a|b|mp", "p").config == {"F": 1}
    assert cache.get("sharding_cell", "a", "b|mp|p").config == {"F": 2}
    assert len(cache) == 2


def test_default_shape_key_collision_regression():
    k = _toy_kernel()
    assert k.key_for({"X": 12}) != k.key_for({"X1": 2})
    assert k.key_for({"a": "1_b=2"}) != k.key_for({"a": "1", "b": 2})
    # canonical order preserved
    assert k.key_for({"b": 2, "a": 1}) == k.key_for({"a": 1, "b": 2})


def test_legacy_pipe_keys_migrated_on_load(tmp_path):
    path = tmp_path / "legacy.json"
    entry = {"config": {"F": "x"}, "time_s": 2.0, "strategy": "greedy",
             "evaluations": 4, "timestamp": 0.0}
    path.write_text(json.dumps(
        {"sharding_cell|dense|train|mp|h100_sxm": entry,
         "gemm|M512|h100_sxm": dict(entry, config={"B": 128})}))
    cache = TuningCache(str(path)).load()
    # the 5-field legacy key parses as kernel=first, profile=last
    assert cache.get("sharding_cell", "dense|train|mp",
                     "h100_sxm").config == {"F": "x"}
    # 3-field keys are byte-identical in both formats
    assert cache.get("gemm", "M512", "h100_sxm").config == {"B": 128}
    # migration survives a save/load round trip
    cache.save()
    reloaded = TuningCache(str(path)).load()
    assert reloaded.get("sharding_cell", "dense|train|mp",
                        "h100_sxm") is not None


def test_legacy_entry_without_shape_round_trips(tmp_path):
    path = tmp_path / "v1.json"
    path.write_text(json.dumps({"k|s|p": {
        "config": {"X": 4}, "time_s": 1.0, "strategy": "full",
        "evaluations": 4, "timestamp": 0.0}}))
    cache = TuningCache(str(path)).load()
    entry = cache.get("k", "s", "p")
    assert entry is not None and entry.shape is None
    cache.save()
    raw = json.loads(path.read_text())
    assert "shape" not in raw["k|s|p"]          # legacy entries stay stable
    assert TuningCache(str(path)).load().get("k", "s", "p").config == {"X": 4}


def test_cache_entry_from_json_requires_mandatory_fields():
    with pytest.raises(KeyError):
        CacheEntry.from_json({"config": {}})


# -- shape distance + nearest ------------------------------------------------

def test_shape_distance_log_space_and_symmetry():
    a, b, c = {"M": 512}, {"M": 1024}, {"M": 2048}
    assert shape_distance(a, b) == pytest.approx(shape_distance(b, c))
    assert shape_distance(a, c) > shape_distance(a, b)
    assert shape_distance(a, a) == 0.0
    assert shape_distance(a, b) == pytest.approx(shape_distance(b, a))


def test_shape_distance_non_numeric_dims_must_match():
    base = {"M": 1024, "dtype": "float32"}
    assert math.isinf(shape_distance(base, {"M": 1024, "dtype": "bf16"}))
    assert shape_distance(base, {"M": 1024, "dtype": "float32"}) == 0.0
    # bools are categorical, not numeric
    assert math.isinf(shape_distance({"M": 1, "causal": True},
                                     {"M": 1, "causal": False}))
    # ...including when the other side stored the flag as an int
    assert math.isinf(shape_distance({"M": 1024, "causal": 1},
                                     {"M": 1024, "causal": False}))
    assert math.isinf(shape_distance({"M": 1024}, {"Sq": 1024}))


def test_nearest_orders_by_distance_and_skips_unusable(cache):
    for n, cfg in ((512, {"X": 1}), (1024, {"X": 2}), (4096, {"X": 8})):
        cache.record("k", f"N{n}", "p", cfg, 1.0, "full", 1,
                     shape={"N": n})
    # a legacy entry without shape cannot participate
    cache.record("k", "legacy", "p", {"X": 4}, 1.0, "full", 1)
    # other kernels / profiles are invisible
    cache.record("other", "N1100", "p", {"X": 9}, 1.0, "full", 1,
                 shape={"N": 1100})
    cache.record("k", "N1100", "q", {"X": 9}, 1.0, "full", 1,
                 shape={"N": 1100})
    near = cache.nearest("k", {"N": 1200}, "p", k=2)
    assert [e.shape["N"] for e in near] == [1024, 512]
    assert [e.shape["N"] for e in cache.nearest("k", {"N": 1200}, "p", k=9)] \
        == [1024, 512, 4096]
    assert cache.nearest("k", {"N": 1200}, "p", k=0) == []


# -- TRANSFER policy ---------------------------------------------------------

def test_transfer_policy_returns_nearest_feasible_without_search(cache):
    k = _toy_kernel()
    cache.record(k.name, k.key_for({"N": 16}), "h100_sxm", {"X": 8},
                 1e-3, "full", 4, shape={"N": 16})
    cfg = lookup(k, {"N": 32}, cache=cache, profile=H100_SXM, policy="transfer")
    assert cfg == {"X": 8}                     # transferred, not heuristic
    assert len(cache) == 1                     # and no search was recorded


def test_transfer_policy_rejects_infeasible_then_heuristic(cache):
    k = _toy_kernel()
    cache.record(k.name, k.key_for({"N": 16}), "h100_sxm", {"X": 8},
                 1e-3, "full", 4, shape={"N": 16})
    # 8 does not divide 12: the transferred config must be rejected
    cfg = lookup(k, {"N": 12}, cache=cache, profile=H100_SXM, policy="transfer")
    assert cfg == {"X": 1}
    # but a feasible farther neighbour wins over the heuristic
    cache.record(k.name, k.key_for({"N": 48}), "h100_sxm", {"X": 4},
                 2e-3, "full", 4, shape={"N": 48})
    assert lookup(k, {"N": 12}, cache=cache, profile=H100_SXM, policy="transfer") == {"X": 4}


def test_transfer_policy_exact_hit_wins(cache):
    k = _toy_kernel()
    cache.record(k.name, k.key_for({"N": 16}), "h100_sxm", {"X": 2},
                 1e-3, "full", 4, shape={"N": 16})
    assert lookup(k, {"N": 16}, cache=cache, profile=H100_SXM,
                  policy=AutotunePolicy.TRANSFER) == {"X": 2}


def test_transfer_disabled_via_knob(cache):
    k = _toy_kernel()
    cache.record(k.name, k.key_for({"N": 16}), "h100_sxm", {"X": 8},
                 1e-3, "full", 4, shape={"N": 16})
    cfg = lookup(k, {"N": 32}, cache=cache, profile=H100_SXM, policy="transfer",
                 transfer=False)
    assert cfg == {"X": 1}                     # heuristic: transfer off


def test_transfer_k1_does_not_widen_to_default_pool(cache):
    k = _toy_kernel()
    # nearest (N=16) is infeasible for N=12; the farther N=48 would work
    cache.record(k.name, k.key_for({"N": 16}), "h100_sxm", {"X": 8},
                 1e-3, "full", 4, shape={"N": 16})
    cache.record(k.name, k.key_for({"N": 48}), "h100_sxm", {"X": 4},
                 2e-3, "full", 4, shape={"N": 48})
    # transfer=1 restricts the pool to the single nearest entry — it must
    # NOT be silently widened to the default 3 (1 == True pitfall)
    assert lookup(k, {"N": 12}, cache=cache, profile=H100_SXM, policy="transfer",
                  transfer=1) == {"X": 1}
    assert lookup(k, {"N": 12}, cache=cache, profile=H100_SXM, policy="transfer",
                  transfer=2) == {"X": 4}


def test_transfer_rejects_out_of_space_values(cache):
    k = _toy_kernel(values=(1, 2, 4, 8))
    # an entry whose config value is not in this kernel's value list
    # (e.g. tuned on an extended space) must not leak through TRANSFER
    cache.record(k.name, "ext", "h100_sxm", {"X": 16}, 1e-3, "full", 4,
                 shape={"N": 16})
    assert lookup(k, {"N": 32}, cache=cache, profile=H100_SXM, policy="transfer") == {"X": 1}


def test_lookup_migrates_legacy_default_shape_key(cache):
    k = _toy_kernel()
    legacy = k.legacy_key_for({"N": 16})
    assert legacy == "N16" and k.key_for({"N": 16}) == "N=16"
    cache.record(k.name, legacy, "h100_sxm", {"X": 8}, 1e-3, "full", 4)
    # the pre-v2 entry resolves and is re-keyed under the new format
    assert lookup(k, {"N": 16}, cache=cache, profile=H100_SXM, policy="off") == {"X": 8}
    assert cache.get(k.name, k.key_for({"N": 16}), "h100_sxm") is not None


def test_transfer_config_helper_reports_source(cache):
    k = _toy_kernel()
    cache.record(k.name, k.key_for({"N": 16}), "h100_sxm", {"X": 8},
                 1e-3, "full", 4, shape={"N": 16})
    moved = transfer_config(k, {"N": 32}, cache=cache, profile=H100_SXM)
    assert moved is not None
    cfg, src = moved
    assert cfg == {"X": 8} and src.shape == {"N": 16}
    assert transfer_config(k, {"N": 7}, cache=cache, profile=H100_SXM) is None


def test_policy_coerce_accepts_transfer():
    assert AutotunePolicy.coerce("transfer") is AutotunePolicy.TRANSFER


# -- lookup failure contract -------------------------------------------------

def test_lookup_reraises_programming_errors(cache):
    @tunable(name="tbroken",
             space=lambda s: (_ for _ in ()).throw(TypeError("user bug")),
             heuristic=lambda s: {"X": 1}, register=False)
    def broken(shape, config):
        return lambda: 0

    with pytest.raises(TypeError, match="user bug"):
        # no analytical model: the kernel's default is the wall-clock
        # evaluator, which needs its device named here
        lookup(broken, {"N": 8}, cache=cache, profile=H100_SXM,
               policy="on_miss", evaluator=WallClockEvaluator(device="cpu"))


def test_lookup_empty_space_still_falls_back_to_heuristic(cache):
    k = _toy_kernel(values=(2, 4, 8))          # nothing divides 7
    cfg = lookup(k, {"N": 7}, cache=cache, profile=H100_SXM, policy="on_miss",
                 strategy="annealing", budget=4)
    assert cfg == {"X": 1}
    assert len(cache) == 0


def test_off_policy_logs_infeasible_heuristic(cache, caplog):
    @tunable(name="tbadheur",
             space=lambda s: _grid_space().add_constraint(
                 lambda a: a != 1, ("A",), "no A=1"),
             heuristic=lambda s: {"A": 1, "B": 10}, register=False)
    def badheur(shape, config):
        return lambda: 0

    with caplog.at_level(logging.WARNING, logger="repro.registry"):
        cfg = lookup(badheur, {"N": 8}, cache=cache, profile=H100_SXM, policy="off")
    # the violation is logged AND the config is projected to the nearest
    # feasible point (A=2 is one value-step from the declared A=1) — an
    # out-of-space config is never served
    assert cfg == {"A": 2, "B": 10}
    assert any("violates its own space constraints" in r.message
               for r in caplog.records)
    assert any("projected to nearest feasible" in r.message
               for r in caplog.records)


# -- warm-started search -----------------------------------------------------

def test_usable_seeds_filters_and_projects():
    sp = _grid_space()
    sp.add_constraint(lambda a, b: a * b != 60, ("A", "B"), "no 60")
    seeds = usable_seeds(sp, [
        {"A": 2, "B": 10, "EXTRA": 1},         # projected: extra key dropped
        {"A": 3, "B": 20},                     # infeasible (60)
        {"A": 2, "B": 10},                     # duplicate
        {"A": 9, "B": 10},                     # value outside the list
        {"B": 20},                             # missing parameter
        {"A": 1, "B": 20},
    ])
    assert seeds == [{"A": 2, "B": 10}, {"A": 1, "B": 20}]
    assert usable_seeds(sp, seeds, limit=1) == [{"A": 2, "B": 10}]
    assert usable_seeds(sp, None) == []


@pytest.mark.parametrize("strategy,kwargs", [
    ("annealing", {}), ("greedy", {}), ("random", {}),
    ("pso", {"swarm_size": 3}), ("evolutionary", {"population": 4}),
])
def test_strategies_evaluate_seeds_first_and_deterministically(
        strategy, kwargs):
    sp = _grid_space()
    objective = lambda cfg: cfg["A"] * cfg["B"]  # noqa: E731
    seeds = [{"A": 3, "B": 20}, {"A": 1, "B": 10}]
    runs = [make_strategy(strategy, **kwargs).run(
                sp, objective, budget=6, seed=7, seeds=seeds)
            for _ in range(2)]
    first, second = runs
    # deterministic per (seed, seeds)
    assert [t.config for t in first.trials] == \
        [t.config for t in second.trials]
    # the seed configs lead the trial log, in order
    assert [t.config for t in first.trials[:2]] == seeds
    assert first.best.time == 10               # the good seed is found
    assert first.evaluations <= 6              # seeds consume budget


def test_seedless_run_unchanged_by_warm_start_support():
    sp = _grid_space()
    objective = lambda cfg: cfg["A"] * cfg["B"]  # noqa: E731
    for strategy in ("annealing", "random", "greedy"):
        a = make_strategy(strategy).run(sp, objective, budget=5, seed=3)
        b = make_strategy(strategy).run(sp, objective, budget=5, seed=3,
                                        seeds=[])
        assert [t.config for t in a.trials] == [t.config for t in b.trials]


def test_asktell_drivers_accept_seeds():
    sp = _grid_space()
    seeds = [{"A": 1, "B": 10}]
    for strategy, kwargs in (("random", {}), ("pso", {"swarm_size": 2}),
                             ("evolutionary", {"population": 3}),
                             ("annealing", {}), ("greedy", {})):
        driver = make_strategy(strategy, **kwargs).asktell(
            sp, 4, seed=0, seeds=seeds)
        batch = driver.ask()
        assert batch[0] == seeds[0], strategy
        driver.close()


def test_engine_unbatched_path_still_seeds():
    from repro_torch.core import (EngineConfig, EvaluationEngine, KernelSpec,
                            AnalyticalEvaluator)
    sp = _grid_space()
    spec = KernelSpec(name="seedprobe", build=lambda cfg: (lambda: 0),
                      analytical_model=lambda cfg, prof:
                          cfg["A"] * cfg["B"] * 1e-6)
    engine = EvaluationEngine(AnalyticalEvaluator(profile=H100_SXM,
                                                  noise_sigma=0.0), spec,
                              sp, EngineConfig(batching=False, workers=1))
    res = engine.run(make_strategy("pso", swarm_size=2), budget=4, seed=0,
                     seeds=[{"A": 1, "B": 10}])
    # batching=False routes through the base SequentialAskTell bridge into
    # ParticleSwarm.run, which must still plant the seed as particle 0
    assert res.trials[0].config == {"A": 1, "B": 10}


def test_tune_kernel_warm_start_transfers_nearest(cache):
    k = _toy_kernel()
    cache.record(k.name, k.key_for({"N": 16}), "h100_sxm", {"X": 8},
                 1e-3, "full", 4, shape={"N": 16})
    out = tune_kernel(k, {"N": 32}, strategy="annealing", budget=4,
                      cache=cache, profile=H100_SXM, record=False, warm_start=3)
    # trial 0 is the transferred config, trial 1 the declared heuristic
    assert out.result.trials[0].config == {"X": 8}
    assert out.result.trials[1].config == {"X": 1}
    assert out.best_config == {"X": 8}
    # warm_start=False searches cold (no seeded prefix guarantee)
    cold = tune_kernel(k, {"N": 32}, strategy="annealing", budget=4,
                       cache=cache, profile=H100_SXM, record=False, warm_start=False, seed=5)
    assert cold.result.evaluations <= 4


def test_warm_start_seeds_helper(cache):
    k = _toy_kernel()
    cache.record(k.name, k.key_for({"N": 16}), "h100_sxm", {"X": 8},
                 1e-3, "full", 4, shape={"N": 16})
    seeds = warm_start_seeds(k, {"N": 32}, cache=cache, profile=H100_SXM)
    assert seeds == [{"X": 8}, {"X": 1}]       # nearest first, heuristic last


def test_tune_records_shape_for_future_transfer(cache):
    k = _toy_kernel()
    tune_kernel(k, {"N": 8}, strategy="full", cache=cache, profile=H100_SXM, record=True)
    entry = cache.get(k.name, k.key_for({"N": 8}), "h100_sxm")
    assert entry is not None and entry.shape == {"N": 8}
    # and the recorded entry immediately powers transfer for a new shape
    assert lookup(k, {"N": 24}, cache=cache, profile=H100_SXM, policy="transfer") == {"X": 8}


# -- parity with the JAX package -------------------------------------------------

#: the JAX package's profile under the H100's name, so cache keys match
REF_H100 = dataclasses.replace(ref_core.TPU_V5E, name=H100_SXM.name)
#: per package: (core, cache module, tune, profile)
PKGS = {"port": (port_core, port_cache, port_tune, H100_SXM),
        "jax": (ref_core, ref_cache, ref_tune, REF_H100)}


def _both(fn):
    """fn(core, cache module, tune, profile) in each package."""
    return fn(*PKGS["port"]), fn(*PKGS["jax"])


def test_cache_keys_match_the_jax_package():
    fields = [("gemm", "M512_N512", "h100_sxm"),
              ("sharding_cell", "dense|train|mp", "h100_sxm"),
              ("k", "we\\ird|sh\\\\ape||", "p|"), ("k", "", ""),
              ("k", "s", "p", "obj=p99_time")]

    def digest(core, cache_mod, tune, profile):
        keys = [cache_mod._key(*f[:3], *(["p99_time"] if len(f) > 3
                                         else [])) for f in fields]
        return keys, [cache_mod.split_key(k) for k in keys]

    port, ref = _both(digest)
    assert port == ref
    assert len(set(port[0])) == len(fields)


def _shapes(seed, n):
    rng = np.random.default_rng(seed)
    dims = 2 ** rng.integers(6, 14, size=(n, 3))
    kinds = rng.integers(0, 5, size=n)
    out = []
    for (m, nn, k), kind in zip(dims.tolist(), kinds.tolist()):
        shape = {"M": m, "N": nn, "K": k}
        if kind in (1, 2):
            shape["dtype"] = ("bfloat16", "float32")[kind - 1]
        elif kind in (3, 4):
            shape["causal"] = kind == 3
        out.append(shape)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shape_distances_match_the_jax_package(seed):
    shapes = _shapes(seed, 12)

    def digest(core, cache_mod, tune, profile):
        return [core.shape_distance(a, b) for a in shapes for b in shapes]

    port, ref = _both(digest)
    assert port == ref
    assert any(math.isinf(d) for d in port) and any(
        0 < d < math.inf for d in port)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nearest_picks_match_the_jax_package(tmp_path, seed):
    """Seeded winners over GEMM-like shapes (some bfloat16, some causal,
    some on another kernel or profile, one without a shape): the same
    nearest entries, in the same order, for every query and k."""
    rng = np.random.default_rng(seed)
    recorded = _shapes(seed, 16)
    configs = [{"X": int(x)} for x in 2 ** rng.integers(0, 4, size=16)]
    queries = _shapes(seed + 100, 6)

    def digest(core, cache_mod, tune, profile):
        c = core.TuningCache(str(tmp_path / f"{profile.name}-{id(core)}"))
        for i, (shape, cfg) in enumerate(zip(recorded, configs)):
            kernel = "other" if i % 7 == 6 else "k"
            prof = "q" if i % 5 == 4 else "p"
            c.record(kernel, f"s{i}", prof, cfg, 1e-3 * (i + 1), "full", 1,
                     shape=shape)
        c.record("k", "legacy", "p", {"X": 4}, 1.0, "full", 1)
        return [[(e.shape, e.config, e.time_s)
                 for e in c.nearest("k", q, "p", k=k)]
                for q in queries + recorded[:3] for k in (0, 1, 3, 20)]

    port, ref = _both(digest)
    assert port == ref
    assert any(port)


def _toy_in(core, name="ttoy_parity", values=(1, 2, 4, 8)):
    def space(shape):
        sp = core.SearchSpace()
        sp.add_parameter(name="X", values=values)
        sp.add_constraint(lambda x: shape["N"] % x == 0, ("X",), "N % X")
        return sp

    @core.tunable(name=name, space=space, heuristic=lambda s: {"X": 1},
                  analytical_model=lambda s, cfg, prof: 1.0 / cfg["X"],
                  register=False)
    def build(shape, config):
        return lambda: config["X"]

    return build


@pytest.mark.parametrize("seed", [0, 1])
def test_transfer_lookups_match_the_jax_package(tmp_path, seed):
    """Seeded tuned shapes, then lookups under each transfer setting at
    shapes that the transferred configs do and do not divide: the same
    configs, provenance, source shapes and warm-start seeds."""
    rng = np.random.default_rng(seed)
    tuned = [int(n) for n in rng.choice([8, 12, 16, 24, 48, 64, 96], 4,
                                        replace=False)]
    configs = [{"X": int(x)} for x in rng.choice([1, 2, 4, 8, 16], 4)]
    queries = [6, 7, 12, 20, 32, 40, 128]

    def digest(core, cache_mod, tune, profile):
        k = _toy_in(core)
        c = core.TuningCache(str(tmp_path / f"{id(core)}.json"))
        for n, cfg in zip(tuned, configs):
            c.record(k.name, k.key_for({"N": n}), profile.name, cfg,
                     1e-3 * n, "full", 4, shape={"N": n})
        rows = []
        for q in queries:
            shape = {"N": q}
            for transfer in (True, 1, 2, False):
                rows.append(core.lookup(k, shape, cache=c, profile=profile,
                                        policy="transfer",
                                        transfer=transfer))
            res = core.lookup_resolved(k, shape, cache=c, profile=profile,
                                       policy="transfer")
            rows.append((res.config, res.provenance, res.source_shape))
            moved = core.transfer_config(k, shape, cache=c, profile=profile)
            rows.append(None if moved is None
                        else (moved[0], moved[1].shape))
            rows.append(tune.warm_start_seeds(k, shape, cache=c,
                                              profile=profile))
        return rows, len(c)

    port, ref = _both(digest)
    assert port == ref
    assert any(r == "transfer" for row in port[0] if isinstance(row, tuple)
               for r in row)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_usable_seeds_and_seeded_strategies_match_the_jax_package(seed):
    rng = np.random.default_rng(seed)
    candidates = []
    for _ in range(10):
        cfg = {"A": int(rng.integers(0, 5)), "B": int(rng.choice([10, 20,
                                                                  30]))}
        if rng.random() < 0.2:
            cfg["EXTRA"] = 1
        if rng.random() < 0.1:
            del cfg["B"]
        candidates.append(cfg)

    def digest(core, cache_mod, tune, profile):
        sp = core.SearchSpace()
        sp.add_parameter(name="A", values=(1, 2, 3))
        sp.add_parameter(name="B", values=(10, 20))
        sp.add_constraint(lambda a, b: a * b != 60, ("A", "B"), "no 60")
        seeds = core.usable_seeds(sp, candidates)
        runs = [[t.config for t in core.make_strategy(name, **kw).run(
                    sp, lambda c: c["A"] * c["B"], budget=6, seed=seed,
                    seeds=seeds).trials]
                for name, kw in (("annealing", {}), ("greedy", {}),
                                 ("random", {}), ("pso", {"swarm_size": 3}),
                                 ("evolutionary", {"population": 4}))]
        return seeds, core.usable_seeds(sp, candidates, limit=1), runs

    port, ref = _both(digest)
    assert port == ref


@pytest.mark.parametrize("strategy,warm", [("annealing", 3), ("greedy", 2),
                                           ("random", True),
                                           ("annealing", False)])
def test_warm_started_tunes_match_the_jax_package(tmp_path, strategy, warm):
    def digest(core, cache_mod, tune, profile):
        k = _toy_in(core)
        c = core.TuningCache(str(tmp_path / f"{id(core)}.json"))
        for n, x in ((16, 8), (48, 4), (12, 2)):
            c.record(k.name, k.key_for({"N": n}), profile.name, {"X": x},
                     1e-3, "full", 4, shape={"N": n})
        out = tune.tune_kernel(
            k, {"N": 32}, strategy=strategy, budget=4, seed=5, cache=c,
            profile=profile, record=True, warm_start=warm)
        entry = c.get(k.name, k.key_for({"N": 32}), profile.name)
        return ([(t.config, t.time) for t in out.result.trials],
                out.best_config, (entry.config, entry.shape))

    port, ref = _both(digest)
    assert port == ref
