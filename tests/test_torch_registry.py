"""The tunable-kernel registry and its lookup policies, held against the
JAX package's: each test feeds both packages the same declarations (a
toy kernel whose analytical time is 1/X) and asserts that both give the
same outcomes, the twin of ``tests/test_core_registry.py``.  Each side
tunes under its own device profile (the JAX package's ``tpu_v5e``, the
port's ``h100_sxm``: the port has no TPU profile by design); the toy
model does not read it.
"""

import os
import types

import pytest

pytest.importorskip("torch")


def _package(name):
    """The parts of one package these tests use, under one set of names."""
    if name == "jax":
        import repro.core as core
        import repro.kernels  # noqa: F401 — registers the built-in kernels
        from repro.core.cache import _ENV_VAR
        profile = core.TPU_V5E
    else:
        import repro_torch.core as core
        import repro_torch.kernels  # noqa: F401
        from repro_torch.core.cache import _ENV_VAR
        profile = core.H100_SXM
    return types.SimpleNamespace(core=core, env_var=_ENV_VAR,
                                 profile=profile, name=name)


PACKAGES = ("jax", "port")


def _toy_kernel(pk, name="toy", registry=None, values=(1, 2, 4, 8)):
    """``tests/test_core_registry.py``'s toy kernel, declared in ``pk``."""
    core = pk.core

    def space(shape):
        sp = core.SearchSpace()
        sp.add_parameter(name="X", values=values)
        sp.add_constraint(lambda x: shape["N"] % x == 0, ("X",), "N % X")
        return sp

    @core.tunable(name=name, space=space,
                  heuristic=lambda s: {"X": 1},
                  analytical_model=lambda s, cfg, prof: 1.0 / cfg["X"],
                  registry=registry, register=registry is not None)
    def build(shape, config):
        return lambda: config["X"]

    return build


def _same(scenario, tmp_path):
    """``scenario(pk, directory)`` in both packages; their outcomes, which
    must be equal."""
    out = {}
    for name in PACKAGES:
        d = tmp_path / name
        d.mkdir()
        out[name] = scenario(_package(name), d)
    assert out["jax"] == out["port"], out
    return out["port"]


def _cache(pk, d):
    return pk.core.TuningCache(str(d / "cache.json"))


def test_tunable_decorator_returns_a_registered_kernel(tmp_path):
    def scenario(pk, d):
        reg = pk.core.KernelRegistry()
        k = _toy_kernel(pk, registry=reg)
        return {"kernel": isinstance(k, pk.core.TunableKernel),
                "registered": reg.get("toy") is k, "in": "toy" in reg,
                "len": len(reg), "builds": k({"N": 8}, {"X": 4})()}
    assert _same(scenario, tmp_path) == {"kernel": True, "registered": True,
                                         "in": True, "len": 1, "builds": 4}


def test_duplicate_registration_is_refused_unless_replaced(tmp_path):
    def scenario(pk, d):
        reg = pk.core.KernelRegistry()
        first = _toy_kernel(pk, registry=reg)
        with pytest.raises(ValueError, match="already registered") as err:
            _toy_kernel(pk, registry=reg)
        again = _toy_kernel(pk, registry=None)
        reg.register(again, replace=True)
        return {"message": str(err.value), "replaced": reg.get("toy") is again,
                "first_gone": reg.get("toy") is not first, "len": len(reg)}
    out = _same(scenario, tmp_path)
    assert out["replaced"] and out["first_gone"] and out["len"] == 1


def test_unknown_kernel_and_resolve(tmp_path):
    def scenario(pk, d):
        reg = pk.core.KernelRegistry()
        k = _toy_kernel(pk, registry=reg)
        with pytest.raises(KeyError, match="toy") as err:
            reg.get("nope")
        return {"message": str(err.value),
                "by_object": pk.core.resolve(k) is k,
                "by_name": pk.core.resolve("toy", reg) is k,
                "key": k.key_for({"b": 2, "a": 1}),
                "canonical": k.key_for({"b": 2, "a": 1}) == k.key_for(
                    {"a": 1, "b": 2})}
    out = _same(scenario, tmp_path)
    assert out["by_object"] and out["by_name"] and out["canonical"]


@pytest.mark.parametrize("policy", ["off", "OFF"])
def test_policy_off_answers_with_the_heuristic_on_a_miss(tmp_path, policy):
    def scenario(pk, d):
        k = _toy_kernel(pk, registry=pk.core.KernelRegistry())
        cache = _cache(pk, d)
        pol = policy if policy == "off" else pk.core.AutotunePolicy.OFF
        cfg = pk.core.lookup(k, {"N": 8}, cache=cache, policy=pol,
                             profile=pk.profile)
        return {"config": cfg, "cached": len(cache)}
    assert _same(scenario, tmp_path) == {"config": {"X": 1}, "cached": 0}


def test_policy_off_returns_a_cache_hit(tmp_path):
    """The reference test records under ``tpu_v5e``; each side records
    under its own profile here."""
    def scenario(pk, d):
        k = _toy_kernel(pk, registry=pk.core.KernelRegistry())
        cache = _cache(pk, d)
        cache.record(k.name, k.key_for({"N": 8}), pk.profile.name, {"X": 8},
                     1e-3, "full", 4)
        return pk.core.lookup(k, {"N": 8}, cache=cache, profile=pk.profile,
                              policy=pk.core.AutotunePolicy.OFF)
    assert _same(scenario, tmp_path) == {"X": 8}


def test_policy_on_miss_tunes_once_then_hits(tmp_path):
    def scenario(pk, d):
        k = _toy_kernel(pk, registry=pk.core.KernelRegistry())
        cache = _cache(pk, d)
        cfg = pk.core.lookup(k, {"N": 8}, cache=cache, policy="on_miss",
                             strategy="full", profile=pk.profile)
        n = len(cache)
        again = pk.core.lookup(k, {"N": 8}, cache=cache, policy="off",
                               profile=pk.profile)
        entry = cache.get(k.name, k.key_for({"N": 8}), pk.profile.name)
        return {"tuned": cfg, "cached": n, "again": again,
                "recorded": entry.config}
    assert _same(scenario, tmp_path) == {"tuned": {"X": 8}, "cached": 1,
                                         "again": {"X": 8},
                                         "recorded": {"X": 8}}


def test_policy_always_retunes_over_a_stale_entry(tmp_path):
    def scenario(pk, d):
        k = _toy_kernel(pk, registry=pk.core.KernelRegistry())
        cache = _cache(pk, d)
        cache.record(k.name, k.key_for({"N": 8}), pk.profile.name, {"X": 1},
                     999.0, "full", 1)
        return pk.core.lookup(k, {"N": 8}, cache=cache, policy="always",
                              strategy="full", profile=pk.profile)
    assert _same(scenario, tmp_path) == {"X": 8}


def test_on_miss_falls_back_to_the_heuristic_for_an_infeasible_shape(
        tmp_path):
    """No X of (2, 4, 8) divides N = 7: the heuristic, not a crash."""
    def scenario(pk, d):
        k = _toy_kernel(pk, registry=pk.core.KernelRegistry(),
                        values=(2, 4, 8))
        cache = _cache(pk, d)
        cfg = pk.core.lookup(k, {"N": 7}, cache=cache, policy="on_miss",
                             strategy="annealing", budget=4,
                             profile=pk.profile)
        return {"config": cfg, "cached": len(cache)}
    assert _same(scenario, tmp_path) == {"config": {"X": 1}, "cached": 0}


def test_an_unknown_policy_is_refused(tmp_path):
    def scenario(pk, d):
        with pytest.raises(ValueError,
                           match="unknown autotune policy") as err:
            pk.core.AutotunePolicy.coerce("sometimes")
        return {"message": str(err.value),
                "policies": sorted(p.name for p in pk.core.AutotunePolicy)}
    _same(scenario, tmp_path)


def test_shape_keyed_entries_are_distinct(tmp_path):
    def scenario(pk, d):
        k = _toy_kernel(pk, registry=pk.core.KernelRegistry())
        cache = _cache(pk, d)
        for n in (8, 6):
            pk.core.lookup(k, {"N": n}, cache=cache, policy="on_miss",
                           strategy="full", profile=pk.profile)
        return {"cached": len(cache),
                "six": pk.core.lookup(k, {"N": 6}, cache=cache,
                                      policy="off", profile=pk.profile)}
    assert _same(scenario, tmp_path) == {"cached": 2, "six": {"X": 2}}


def test_tuner_from_a_tunable_and_its_budget_rule(tmp_path):
    def scenario(pk, d):
        k = _toy_kernel(pk, registry=pk.core.KernelRegistry())
        tuner = pk.core.Tuner.from_tunable

        def new():
            return tuner(k, {"N": 8}, profile=pk.profile)
        full = new().tune(strategy="full")
        capped = new()
        capped.add_constraint(lambda x: x <= 4, ("X",), "cap")
        rnd = new().tune(strategy="random")
        clamped = new().tune(strategy="random", budget=10_000)
        two = new().tune(strategy="full", budget=2)
        return {"best": full.best_config, "kernel": full.kernel,
                "capped": capped.tune(strategy="full").best_config,
                "random_budget": rnd.budget,
                "reported": "budget=4" in rnd.report(),
                "clamped": clamped.budget, "full_budget": full.budget,
                "exhaustive": "budget=exhaustive" in full.report(),
                "two": (two.result.evaluations <= 2, two.budget)}
    assert _same(scenario, tmp_path) == {
        "best": {"X": 8}, "kernel": "toy", "capped": {"X": 4},
        "random_budget": 4, "reported": True, "clamped": 4,
        "full_budget": None, "exhaustive": True, "two": (True, 2)}


def test_builtin_kernels_are_registered(tmp_path):
    def scenario(pk, d):
        out = {}
        for name in ("gemm", "conv2d", "flash_attention"):
            k = pk.core.REGISTRY.get(name)
            out[name] = (name in pk.core.REGISTRY,
                         k.analytical_model is not None,
                         k.make_args is not None)
        return out
    assert _same(scenario, tmp_path) == {
        n: (True, True, True) for n in ("gemm", "conv2d", "flash_attention")}


def test_cache_env_override_and_clear(tmp_path, monkeypatch):
    def scenario(pk, d):
        target = str(d / "override" / "db.json")
        monkeypatch.setenv(pk.env_var, target)
        c = pk.core.default_cache()
        at = c.path == target
        c.record("k", "s", "p", {"a": 1}, 1.0, "full", 1)
        c.save()
        loaded = len(pk.core.TuningCache(target).load())
        c.clear(delete_file=True)
        gone = len(c) == 0 and not os.path.exists(target)
        monkeypatch.delenv(pk.env_var)
        return {"at": at, "loaded": loaded, "gone": gone,
                "default": pk.core.default_cache().path != target,
                "var": pk.env_var}
    assert _same(scenario, tmp_path) == {
        "at": True, "loaded": 1, "gone": True, "default": True,
        "var": "REPRO_TUNE_CACHE"}
