"""The port's prediction layer (``core/predict.py``) against the JAX
package's, in one process, on a synthetic kernel declared once in each
package with the same space and analytical model.

The heuristic, cost-model and transfer predictors, the training-set
fingerprint and a predictor-first search must agree exactly.  The learned
predictor's device features are each package's own (the Hopper limits
here, the TPU's there), so its fit differs by construction; see
:data:`LEARNED_RTOL`.
"""

import dataclasses
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref_core  # noqa: E402
from repro.core import predict as ref_predict  # noqa: E402
from repro.tune import tune_kernel as ref_tune  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro_torch.core import (H100_SXM, PREDICTOR_KINDS,  # noqa: E402
                              ArtifactStore, EngineConfig, TuningCache,
                              lookup_resolved)
from repro_torch.core import predict as port_predict  # noqa: E402
from repro_torch.kernels.matmul import GEMM  # noqa: E402
from repro_torch.tune import tune_kernel  # noqa: E402

#: the JAX package's profile under the H100's name, so cache keys agree
REF_H100 = dataclasses.replace(ref_core.TPU_V5E, name="h100_sxm")
SHAPE = {"M": 2048}

#: The learned predictors' log-time fits differ only through the four
#: profile columns, which are constant over the training rows and so lie
#: on the intercept's direction.  Ridge (lambda = 1e-3) splits the shared
#: coefficient over the intercept and those columns in proportion to their
#: squared values (sum ~ 3.8e3 here, ~ 4.0e3 there): the shared direction's
#: penalty is ~ lambda / 3.8e3 ~ 3e-7 of it in either package, so the
#: predicted times differ by ~ 1e-6 relative at most (7e-8 measured).
#: 1e-5 leaves a margin of ten over that bound.
LEARNED_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _clear_predictor_env(monkeypatch):
    monkeypatch.delenv("REPRO_PREDICTOR", raising=False)
    monkeypatch.delenv("REPRO_PREDICT_PRUNE", raising=False)


def _declare(core):
    """One synthetic kernel, declared identically in either package: a
    cliff of analytically infeasible configs (BM=128 with BK=32) that a
    cost-model predictor learns to prune."""
    def space(shape):
        sp = core.SearchSpace()
        sp.add_parameter(name="BM", values=(16, 32, 64, 128))
        sp.add_parameter(name="BK", values=(8, 16, 32, 64))
        sp.add_parameter(name="ORDER", values=("mn", "nm"))
        sp.add_constraint(lambda bm, bk: bm * bk <= 4096, ("BM", "BK"),
                          "tile budget")
        return sp

    def model(shape, cfg, profile):
        if cfg["BM"] == 128 and cfg["BK"] == 32:
            return math.inf
        return ((shape["M"] / cfg["BM"]) * 1e-6 + (64 / cfg["BK"]) * 2e-6
                + (1e-6 if cfg["ORDER"] == "nm" else 0.0))

    return core.tunable(
        name="toy", space=space,
        heuristic=lambda s: {"BM": 32, "BK": 16, "ORDER": "mn"},
        analytical_model=model, register=False,
        registry=core.KernelRegistry())(lambda shape, cfg: None)


def _pair():
    return _declare(ref_core), _declare(port_core)


def _trials(outcome):
    return [(t.config, t.time) for t in outcome.result.trials]


def _searches(tmp_path, ref_k, port_k, **kw):
    ref = ref_tune(ref_k, SHAPE, profile=REF_H100, record=False,
                   warm_start=False,
                   cache=ref_core.TuningCache(str(tmp_path / "ref.json")),
                   **kw)
    port = tune_kernel(port_k, SHAPE, profile=H100_SXM, record=False,
                       warm_start=False,
                       cache=TuningCache(str(tmp_path / "port.json")), **kw)
    return ref, port


@pytest.mark.parametrize("strategy,budget", [
    ("full", None), ("annealing", 16), ("random", 12), ("pso", 14)])
def test_predictor_first_search_equals_the_jax_package(tmp_path, strategy,
                                                       budget):
    ref_k, port_k = _pair()
    ref, port = _searches(tmp_path, ref_k, port_k, strategy=strategy,
                          budget=budget, seed=0, predictor="costmodel",
                          engine={"predict_prune": True})
    assert _trials(port) == _trials(ref)
    assert port.best_config == ref.best_config
    assert port.best_time == ref.best_time
    for key in ("predicted_pruned", "predictor_rank_used", "evaluations"):
        assert port.engine_stats[key] == ref.engine_stats[key], key
    assert port.predictor == ref.predictor == "costmodel:toy"
    if strategy == "full":
        assert port.engine_stats["predicted_pruned"] > 0


def test_env_knobs_select_the_predictor_as_in_jax(tmp_path, monkeypatch):
    ref_k, port_k = _pair()
    monkeypatch.setenv("REPRO_PREDICTOR", "costmodel")
    monkeypatch.setenv("REPRO_PREDICT_PRUNE", "1")
    ref, port = _searches(tmp_path, ref_k, port_k, strategy="full", seed=0)
    assert port.predictor == ref.predictor == "costmodel:toy"
    assert port.engine_stats["predicted_pruned"] == \
        ref.engine_stats["predicted_pruned"] > 0
    assert _trials(port) == _trials(ref)
    assert EngineConfig(
        predictor=port_predict.HeuristicPredictor(port_k)).predict_prune
    assert port_predict.default_predictor_kind() == "costmodel"
    monkeypatch.setenv("REPRO_PREDICT_PRUNE", "maybe")
    with pytest.raises(TypeError):
        port_predict.predict_prune_default()


def test_heuristic_and_transfer_predictors_agree(tmp_path):
    ref_k, port_k = _pair()
    configs = port_k.make_space(SHAPE).enumerate()
    ref_cache = ref_core.TuningCache(str(tmp_path / "ref.json"))
    port_cache = TuningCache(str(tmp_path / "port.json"))
    rng = np.random.default_rng(0)
    for m in (512, 1024, 8192):
        cfg = configs[int(rng.integers(len(configs)))]
        t = float(rng.uniform(1e-5, 1e-4))
        for cache in (ref_cache, port_cache):
            cache.record("toy", f"M={m}", "h100_sxm", cfg, t, "full", 4,
                         shape={"M": m})
    pairs = [(ref_predict.HeuristicPredictor(ref_k),
              port_predict.HeuristicPredictor(port_k)),
             (ref_predict.TransferPredictor(ref_k, ref_cache),
              port_predict.TransferPredictor(port_k, port_cache))]
    for ref, port in pairs:
        for shape in (SHAPE, {"M": 700}):
            assert port.rank(configs, shape, H100_SXM) == \
                ref.rank(configs, shape, REF_H100)
            assert port.suggest(shape, H100_SXM, k=3) == \
                ref.suggest(shape, REF_H100, k=3)
            assert [port.feasible(c, shape, H100_SXM) for c in configs] == \
                [ref.feasible(c, shape, REF_H100) for c in configs]
    # the transfer predictor falls back on its own profile's entries
    port = port_predict.TransferPredictor(port_k, port_cache,
                                          profile=H100_SXM)
    assert port.suggest(SHAPE, None, k=3) == \
        pairs[1][0].suggest(SHAPE, REF_H100, k=3)


def test_a_jax_written_cache_trains_the_same_rows(tmp_path):
    """The carried state: a cache file the JAX package wrote gives the
    port's train_from_cache the same rows and training fingerprint."""
    ref_k, port_k = _pair()
    path = str(tmp_path / "shared.json")
    for m in (1024, 4096):
        ref_tune(ref_k, {"M": m}, strategy="annealing", budget=8, seed=0,
                 profile=REF_H100, cache=ref_core.TuningCache(path),
                 record=True, warm_start=False)
    ref_rows = ref_core.TuningCache(path).trial_dataset("toy",
                                                        profile="h100_sxm")
    port_rows = TuningCache(path).trial_dataset("toy", profile="h100_sxm")
    assert port_rows == ref_rows and len(port_rows) == 2
    assert port_predict.training_fingerprint(port_rows) == \
        ref_predict.training_fingerprint(ref_rows)
    ref_m = ref_predict.train_from_cache(ref_k, ref_core.TuningCache(path),
                                         profile=REF_H100)
    port_m = port_predict.train_from_cache(port_k, TuningCache(path),
                                           profile=H100_SXM)
    assert port_m.training_fingerprint == ref_m.training_fingerprint
    assert port_m.to_payload()["n_measured"] == 2
    configs = port_k.make_space(SHAPE).enumerate()
    assert np.argsort(port_m.rank(configs, SHAPE, None), kind="stable") \
        .tolist() == np.argsort(ref_m.rank(configs, SHAPE, None),
                                kind="stable").tolist()


def _learned(pred_mod, kernel, profile, rows):
    model = pred_mod.LearnedPredictor(kernel, profile=profile)
    model.pretrain([{"M": 1024}, {"M": 4096}], limit=64)
    model.finetune(rows)
    return model


def test_learned_predictor_ranks_equal_times_within_tolerance():
    ref_k, port_k = _pair()
    rng = np.random.default_rng(0)
    configs = port_k.make_space(SHAPE).enumerate()
    picks = rng.choice(len(configs), 6, replace=False)
    rows = [{"shape": SHAPE, "config": configs[int(i)],
             "time_s": float(rng.uniform(1e-5, 1e-4))} for i in picks]
    ref = _learned(ref_predict, ref_k, REF_H100, rows)
    port = _learned(port_predict, port_k, H100_SXM, rows)
    assert port.training_fingerprint == ref.training_fingerprint
    for shape in (SHAPE, {"M": 300}):
        r = np.asarray(ref.rank(configs, shape, None))
        p = np.asarray(port.rank(configs, shape, None))
        assert np.argsort(p, kind="stable").tolist() == \
            np.argsort(r, kind="stable").tolist()
        np.testing.assert_allclose(p, r, rtol=LEARNED_RTOL, atol=0)
        np.testing.assert_allclose(
            [port.feasible(c, shape, None) for c in configs],
            [ref.feasible(c, shape, None) for c in configs],
            rtol=0, atol=LEARNED_RTOL)
        assert port.suggest(shape, None, 3) == ref.suggest(shape, None, 3)


def test_learned_predictor_finetunes_on_an_engines_trials(tmp_path):
    """A search's trials (failed ones included) train the model; the
    cache alone holds one winner per shape."""
    ref_k, port_k = _pair()
    _, outcome = _searches(tmp_path, ref_k, port_k, strategy="full", seed=0)
    trials = outcome.result.trials
    assert any(not t.ok for t in trials)          # the cliff's configs
    port = port_predict.LearnedPredictor(port_k, profile=H100_SXM)
    assert port.finetune(trials, shape=SHAPE) == len(trials)
    ref = ref_predict.LearnedPredictor(ref_k, profile=REF_H100)
    ref.finetune([{"shape": SHAPE, "config": t.config, "time_s": t.time}
                  for t in trials])
    assert port.training_fingerprint == ref.training_fingerprint
    configs = [t.config for t in trials]
    assert np.argsort(port.rank(configs, SHAPE, None), kind="stable") \
        .tolist() == np.argsort(ref.rank(configs, SHAPE, None),
                                kind="stable").tolist()
    # the failed trials taught the linear infeasibility head something
    p_ok = [port.feasible(t.config, SHAPE, None) for t in trials]
    assert np.mean([p for p, t in zip(p_ok, trials) if not t.ok]) < \
        np.mean([p for p, t in zip(p_ok, trials) if t.ok])
    with pytest.raises(ValueError, match="shape="):
        port.finetune(trials)


def test_predicted_lookup_equals_the_jax_package(tmp_path):
    ref_k, port_k = _pair()
    kw = dict(policy="transfer", predictor="costmodel")
    ref = ref_core.lookup_resolved(
        ref_k, SHAPE, profile=REF_H100,
        cache=ref_core.TuningCache(str(tmp_path / "r.json")), **kw)
    port = lookup_resolved(port_k, SHAPE, profile=H100_SXM,
                           cache=TuningCache(str(tmp_path / "p.json")), **kw)
    assert port.provenance == ref.provenance == "predicted"
    assert port.config == ref.config
    assert port.predictor == ref.predictor == "costmodel:toy"
    # predictor off: the heuristic, as in the JAX package
    off = lookup_resolved(port_k, SHAPE, profile=H100_SXM, policy="transfer",
                          cache=TuningCache(str(tmp_path / "p.json")))
    assert off.provenance == "heuristic" and off.predictor is None


def test_learned_predictor_persists_in_the_store(tmp_path):
    _, port_k = _pair()
    cache = TuningCache(str(tmp_path / "c.json"))
    tune_kernel(port_k, SHAPE, strategy="full", profile=H100_SXM,
                cache=cache, record=True, warm_start=False)
    store = ArtifactStore(str(tmp_path / "store"))
    first = port_predict.train_from_cache(port_k, cache, profile=H100_SXM,
                                          store=store)
    assert any(f.startswith("predictor__")
               for f in os.listdir(store.root))
    again = port_predict.train_from_cache(port_k, cache, profile=H100_SXM,
                                          store=store)
    assert store.stats.hits == 1
    assert again.to_payload()["theta"] == first.to_payload()["theta"]
    payload = {"kind": "learned", "payload": first.to_payload()}
    shipped = port_predict.resolve_predictor(payload, port_k,
                                             profile=H100_SXM)
    configs = port_k.make_space(SHAPE).enumerate()
    assert shipped.rank(configs, SHAPE, None) == \
        first.rank(configs, SHAPE, None)


@pytest.mark.parametrize("kind", PREDICTOR_KINDS)
def test_gemm_tunes_with_every_predictor_kind(tmp_path, kind):
    shape = {"M": 256, "N": 256, "K": 256}
    cache = TuningCache(str(tmp_path / "c.json"))
    tune_kernel(GEMM, {"M": 512, "N": 256, "K": 256}, strategy="random",
                budget=6, profile=H100_SXM, cache=cache)
    out = tune_kernel(GEMM, shape, strategy="annealing", budget=8,
                      profile=H100_SXM, cache=cache, predictor=kind,
                      engine={"predict_prune": True})
    assert out.best_config is not None and math.isfinite(out.best_time)
    if kind == "off":
        assert out.predictor is None
        assert out.engine_stats["predictor_rank_used"] == 0
    else:
        assert out.predictor == f"{kind}:gemm"
        assert out.engine_stats["predictor_rank_used"] > 0
        assert f"predictor: {kind}:gemm" in out.report()
