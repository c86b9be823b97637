"""One-shot ``tune_kernel`` and the multi-kernel ``TuningSession`` over
the registry, held against the JAX package's: each test runs the same
requests through both packages and asserts the same outcomes, the twin
of ``tests/test_tune_api.py``.  Each side searches under its own device
profile and analytical model (the JAX package's TPU profiles, the port's
``h100_sxm``; the port has no TPU profile by design), so the winners
differ and the outcomes compared are what the API promises: what is
searched, recorded, keyed and written.
"""

import dataclasses
import types

import pytest

pytest.importorskip("torch")

GEMM_SHAPE = {"M": 512, "N": 512, "K": 512}
CONV_SHAPE = {"H": 256, "W": 256, "Fh": 3, "Fw": 3}
FLASH_SHAPE = {"Sq": 512, "Sk": 512, "D": 64, "causal": True}


def _package(name):
    """The parts of one package these tests use, under one set of names;
    ``profiles`` are two profiles of distinct names."""
    if name == "jax":
        import repro.core as core
        import repro.tune as tune
        from repro.core.cache import _ENV_VAR
        from repro.kernels.conv2d.ops import CONV2D
        from repro.kernels.matmul import lookup_config
        from repro.kernels.matmul.ops import GEMM
        profiles = (core.TPU_V5E, core.TPU_V3)
    else:
        import repro_torch.core as core
        import repro_torch.tune as tune
        from repro_torch.core.cache import _ENV_VAR
        from repro_torch.kernels.conv2d.ops import CONV2D
        from repro_torch.kernels.matmul import lookup_config
        from repro_torch.kernels.matmul.ops import GEMM
        profiles = (core.H100_SXM,
                    dataclasses.replace(core.H100_SXM, name="h100_sxm_b"))
    return types.SimpleNamespace(core=core, tune=tune, env_var=_ENV_VAR,
                                 GEMM=GEMM, CONV2D=CONV2D,
                                 lookup_config=lookup_config,
                                 profile=profiles[0], profiles=profiles)


def _same(scenario, tmp_path):
    out = {}
    for name in ("jax", "port"):
        d = tmp_path / name
        d.mkdir()
        out[name] = scenario(_package(name), d)
    assert out["jax"] == out["port"], out
    return out["port"]


def _cache(pk, d):
    return pk.core.TuningCache(str(d / "tuned.json"))


def test_tune_kernel_one_shot_records_its_winner(tmp_path):
    def scenario(pk, d):
        cache = _cache(pk, d)
        out = pk.tune.tune_kernel("gemm", GEMM_SHAPE, strategy="random",
                                  budget=12, cache=cache, seed=0,
                                  profile=pk.profile)
        entry = cache.get("gemm", pk.GEMM.key_for(GEMM_SHAPE),
                          pk.profile.name)
        return {"kernel": out.kernel, "best": out.best_config is not None,
                "within_budget": out.result.evaluations <= 12,
                "recorded": entry is not None
                and entry.config == out.best_config}
    assert _same(scenario, tmp_path) == {"kernel": "gemm", "best": True,
                                         "within_budget": True,
                                         "recorded": True}


def test_tune_kernel_takes_the_object_and_its_declared_defaults(tmp_path):
    def scenario(pk, d):
        out = pk.tune.tune_kernel(pk.GEMM, GEMM_SHAPE, cache=_cache(pk, d),
                                  record=False, budget=8,
                                  profile=pk.profile)
        return {"strategy": out.result.strategy, "budget": out.budget}
    assert _same(scenario, tmp_path) == {"strategy": "annealing",
                                         "budget": 8}


def test_conv2d_searches_its_declared_extended_space(tmp_path):
    def scenario(pk, d):
        out = pk.tune.tune_kernel(pk.CONV2D, CONV_SHAPE, strategy="random",
                                  budget=4, record=False,
                                  cache=_cache(pk, d), profile=pk.profile)
        return all("PAD_W" in t.config for t in out.result.trials)
    assert _same(scenario, tmp_path) is True


def test_a_tuned_config_feeds_the_public_op(tmp_path, monkeypatch):
    def scenario(pk, d):
        cache = _cache(pk, d)
        monkeypatch.setenv(pk.env_var, cache.path)
        pk.tune.tune_kernel("gemm", GEMM_SHAPE, strategy="random", budget=8,
                            cache=cache, profile=pk.profile)
        cache.save()
        cfg = pk.lookup_config(512, 512, 512, profile=pk.profile)
        entry = cache.get("gemm", pk.GEMM.key_for(GEMM_SHAPE),
                          pk.profile.name)
        monkeypatch.delenv(pk.env_var)
        return cfg == entry.config
    assert _same(scenario, tmp_path) is True


def test_a_session_tunes_three_kernels_into_one_cache(tmp_path):
    def scenario(pk, d):
        cache = _cache(pk, d)
        session = pk.tune.TuningSession(pk.profile, cache=cache,
                                        strategy="random", budget=6, seed=1)
        session.add(pk.GEMM, GEMM_SHAPE)
        session.add(pk.CONV2D, CONV_SHAPE)
        session.add("flash_attention", FLASH_SHAPE)
        outcomes = session.run()
        report = session.report()
        return {"outcomes": len(outcomes),
                "kernels": sorted({k.split("|")[0] for k in cache.entries()}),
                "reloaded": len(pk.core.TuningCache(cache.path).load()),
                "reported": all(n in report for n in (
                    "gemm", "conv2d", "flash_attention"))}
    assert _same(scenario, tmp_path) == {
        "outcomes": 3, "kernels": ["conv2d", "flash_attention", "gemm"],
        "reloaded": 3, "reported": True}


def test_a_session_defaults_to_the_declared_default_shapes(tmp_path):
    def scenario(pk, d):
        session = pk.tune.TuningSession(pk.profile, cache=_cache(pk, d),
                                        strategy="random", budget=4)
        session.add("gemm")
        outcomes = session.run(save=False)
        return (f"gemm:{pk.GEMM.key_for(pk.GEMM.default_shapes[0])}"
                in outcomes, len(outcomes))
    assert _same(scenario, tmp_path) == (True, 1)


def test_sessions_under_two_profiles_key_their_entries_apart(tmp_path):
    """The reference test tunes under ``tpu_v3`` and ``tpu_v5e``; the
    port under ``h100_sxm`` and a renamed copy of it."""
    def scenario(pk, d):
        cache = _cache(pk, d)
        for profile in pk.profiles:
            s = pk.tune.TuningSession(profile=profile, cache=cache,
                                      strategy="random", budget=4)
            s.add(pk.GEMM, GEMM_SHAPE)
            s.run(save=False)
        got = {k.split("|")[2] for k in cache.entries()}
        return got == {p.name for p in pk.profiles}
    assert _same(scenario, tmp_path) is True


def test_a_session_refuses_a_kernel_without_default_shapes(tmp_path):
    def scenario(pk, d):
        import importlib
        importlib.import_module(pk.tune.__name__ + ".sharding_autotune")
        session = pk.tune.TuningSession(pk.profile, cache=_cache(pk, d))
        with pytest.raises(ValueError) as err:
            session.add("sharding_cell")
        return "default_shapes" in str(err.value)
    assert _same(scenario, tmp_path) is True


def test_the_legacy_wrappers_delegate(tmp_path, monkeypatch):
    def scenario(pk, d):
        monkeypatch.setenv(pk.env_var, _cache(pk, d).path)
        out = pk.tune.tune_matmul(256, 256, 256, strategy="random",
                                  budget=4, record=False,
                                  profile=pk.profile)
        monkeypatch.delenv(pk.env_var)
        return {"kernel": out.kernel, "budget": out.budget}
    assert _same(scenario, tmp_path) == {"kernel": "gemm", "budget": 4}
