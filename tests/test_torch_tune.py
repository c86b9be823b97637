"""The slice as a whole on the CPU: tune -> record -> lookup -> run, and
search parity with the JAX package's tuner."""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as ref_core  # noqa: E402
from repro.kernels.matmul import matmul as ref_matmul  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro_torch.core import (H100_SXM, AnalyticalEvaluator,  # noqa: E402
                              TuningCache, WallClockEvaluator,
                              lookup_resolved)
from repro_torch.kernels.matmul import GEMM, matmul  # noqa: E402
from repro_torch.tune import tune_kernel  # noqa: E402

SHAPE = {"M": 256, "N": 256, "K": 256}


def test_tune_record_lookup_run_on_cpu(tmp_path, monkeypatch):
    path = str(tmp_path / "tuned.json")
    monkeypatch.setenv("REPRO_TUNE_CACHE", path)
    # the JAX package's GEMM tests' tolerance: the float32 default of
    # 1e-5 is broken by summation order alone at K = 256 (5e-5 observed)
    evaluator = WallClockEvaluator(device="cpu", repeats=2,
                                   atol=2e-4, rtol=2e-4)
    outcome = tune_kernel(GEMM, SHAPE, strategy="full", evaluator=evaluator,
                          profile=H100_SXM, cache=TuningCache(path))
    assert outcome.evaluator == "wallclock"
    assert outcome.failure_summary["failed_trials"] == 0
    best = outcome.result.best
    assert best is not None and math.isfinite(best.time)
    verified = [m.verified for m in outcome.measurements.values()]
    assert verified and all(verified)

    res = lookup_resolved(GEMM, SHAPE, profile=H100_SXM,
                          cache=TuningCache(path))
    assert res.provenance == "exact"
    assert res.config == best.config
    assert res.profile == "h100_sxm"

    rng = np.random.default_rng(1)
    a = rng.normal(size=(256, 256)).astype(np.float32)
    b = rng.normal(size=(256, 256)).astype(np.float32)
    got = matmul(torch.from_numpy(a), torch.from_numpy(b))   # config=None
    want = ref_matmul(jnp.asarray(a), jnp.asarray(b), config=res.config,
                      interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def _declare(mod_core):
    """One toy kernel, declared identically in either package."""
    def space(shape):
        sp = mod_core.SearchSpace()
        sp.add_parameter(name="BM", values=(16, 32, 64, 128))
        sp.add_parameter(name="BK", values=(8, 16, 32, 64))
        sp.add_parameter(name="ORDER", values=("mn", "nm"))
        sp.add_parameter(name="INPLACE", values=(False, True))
        sp.add_constraint(lambda bm, bk: bm * bk <= 4096, ("BM", "BK"),
                          "tile budget")
        return sp

    def model(shape, cfg, profile):
        if cfg["BM"] == 128 and cfg["INPLACE"]:
            return math.inf
        return (shape["M"] / cfg["BM"]) * 1e-6 + (64 / cfg["BK"]) * 2e-6 \
            + (1e-6 if cfg["ORDER"] == "nm" else 0.0)

    kernel = mod_core.tunable(
        name="toy_gemm", space=space,
        heuristic=lambda s: {"BM": 32, "BK": 16, "ORDER": "mn",
                             "INPLACE": False},
        analytical_model=model, register=False,
        registry=mod_core.KernelRegistry())(lambda shape, cfg: None)
    return kernel


@pytest.mark.parametrize("strategy,budget", [
    ("annealing", 20), ("pso", 18), ("random", 15), ("full", None)])
def test_tuners_agree_under_the_analytical_evaluator(tmp_path, strategy,
                                                     budget):
    shape = {"M": 1024}
    ref_profile = dataclasses.replace(ref_core.TPU_V5E, name="h100_sxm")
    ref_k, port_k = _declare(ref_core), _declare(port_core)
    ref_cache = ref_core.TuningCache(str(tmp_path / "ref.json"))
    port_cache = TuningCache(str(tmp_path / "port.json"))
    ref_t = ref_core.Tuner.from_tunable(
        ref_k, shape, profile=ref_profile, cache=ref_cache,
        evaluator=ref_core.TPUAnalyticalEvaluator(profile=ref_profile))
    port_t = port_core.Tuner.from_tunable(
        port_k, shape, profile=H100_SXM, cache=port_cache,
        evaluator=AnalyticalEvaluator(profile=H100_SXM))
    kw = dict(strategy=strategy, budget=budget, seed=0,
              record_to_cache=True, shape_key="M=1024")
    r, p = ref_t.tune(**kw), port_t.tune(**kw)
    assert [(t.config, t.time) for t in p.result.trials] == \
        [(t.config, t.time) for t in r.result.trials]
    assert p.best_config == r.best_config
    assert p.best_time == r.best_time
    assert list(port_cache.entries()) == list(ref_cache.entries())


def test_gemm_defaults_to_the_analytical_evaluator_as_in_jax():
    t = port_core.Tuner.from_tunable(GEMM, SHAPE, profile=H100_SXM)
    assert isinstance(t.evaluator, AnalyticalEvaluator)
    assert t.evaluator.profile is H100_SXM


def test_predictor_and_analyzer_calls_tune_as_in_jax(tmp_path, monkeypatch):
    """The calls that raised before the predictor and the analyzer were
    ported now tune, and on a kernel declared in both packages they give
    the JAX package's trials."""
    from repro.tune import tune_kernel as ref_tune
    monkeypatch.delenv("REPRO_PREDICTOR", raising=False)
    monkeypatch.delenv("REPRO_ANALYZE", raising=False)
    kw = dict(strategy="random", budget=2, profile=H100_SXM,
              cache=TuningCache(str(tmp_path / "c.json")))
    learned = tune_kernel(GEMM, SHAPE, predictor="learned", **kw)
    assert learned.predictor == "learned:gemm"
    analyzed = tune_kernel(GEMM, SHAPE, analyze=True, **kw)
    assert analyzed.analysis["proven_checker"] is True
    monkeypatch.setenv("REPRO_ANALYZE", "1")
    assert tune_kernel(GEMM, SHAPE, **kw).analysis is not None
    monkeypatch.delenv("REPRO_ANALYZE")
    monkeypatch.setenv("REPRO_PREDICTOR", "heuristic")
    res = lookup_resolved(GEMM, {"M": 512, "N": 256, "K": 256},
                          profile=H100_SXM, policy="transfer",
                          cache=TuningCache(str(tmp_path / "empty.json")))
    assert res.provenance == "predicted" and res.predictor == "heuristic:gemm"
    monkeypatch.delenv("REPRO_PREDICTOR")
    assert port_core.EngineConfig(predictor=object()).predict_prune is False

    ref_profile = dataclasses.replace(ref_core.TPU_V5E, name="h100_sxm")
    ref_k, port_k = _declare(ref_core), _declare(port_core)
    for extra in ({"predictor": "heuristic"}, {"predictor": "costmodel"},
                  {"analyze": True}):
        args = dict(strategy="annealing", budget=12, seed=0, record=False,
                    warm_start=False, **extra)
        r = ref_tune(ref_k, {"M": 1024}, profile=ref_profile,
                     cache=ref_core.TuningCache(str(tmp_path / "r.json")),
                     **args)
        p = tune_kernel(port_k, {"M": 1024}, profile=H100_SXM,
                        cache=TuningCache(str(tmp_path / "p.json")), **args)
        assert [(t.config, t.time) for t in p.result.trials] == \
            [(t.config, t.time) for t in r.result.trials]
        assert (p.predictor, p.analysis) == (r.predictor, r.analysis)
