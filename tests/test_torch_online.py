"""The port's online retuning (``repro_torch.serve.online``): a twin of the
tests of tests/test_online.py that need no serve engine or model, on the
CPU: ConfigSlot atomicity, cache change notification, provenance-reporting
lookup and the BackgroundTuner's jobs, each as the JAX package's test
checks it, with the port's analytical evaluator on a modeled H100
(``device="cpu"``).

Added beside the twins: a job keeps the tuner's own profile, so a profile
read from the card at run time reaches the evaluator with its limits; and
``submit_for_resolutions`` queues exactly the non-exact resolutions.

The last section drives the JAX package's slot, cache notifications,
lookups and background tuner beside the port's in one process, and holds
the port's slot generations and job transitions to the JAX package's.
"""

import dataclasses
import logging
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref_core  # noqa: E402
import repro.serve.online as ref_online  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
import repro_torch.serve.online as port_online  # noqa: E402

from repro_torch.core import (H100_SXM, AnalyticalEvaluator,  # noqa: E402
                              SearchSpace, TuningCache, lookup_resolved,
                              tunable)
from repro_torch.serve import (BackgroundTuner, ConfigSlot,  # noqa: E402
                               JobStatus, OnlineTuneConfig,
                               submit_for_resolutions)


# -- fixtures ----------------------------------------------------------------

def _toy_kernel(name="onl", values=(1, 2, 4, 8), fail=False):
    """time = 1/X over X values constrained to divide shape["N"]."""

    def space(shape):
        sp = SearchSpace()
        sp.add_parameter(name="X", values=values)
        sp.add_constraint(lambda x: shape["N"] % x == 0, ("X",), "N % X")
        return sp

    def model(shape, cfg, prof):
        if fail:
            raise RuntimeError("model exploded")
        return 1.0 / cfg["X"]

    @tunable(name=name, space=space, heuristic=lambda s: {"X": 1},
             analytical_model=model, register=False)
    def build(shape, config):
        return lambda: config["X"]

    return build


@pytest.fixture
def cache(tmp_path):
    return TuningCache(str(tmp_path / "cache.json"))


def _tuner_cfg(**kw):
    kw.setdefault("strategy", "full")
    kw.setdefault("evaluator_factory",
                  lambda k, s, p: AnalyticalEvaluator(profile=p,
                                                      noise_sigma=0.0))
    kw.setdefault("device", "cpu")
    return OnlineTuneConfig(**kw)


# -- ConfigSlot --------------------------------------------------------------

def test_config_slot_swap_bumps_generation():
    slot = ConfigSlot({"gemm": {"BM": 8}})
    configs, gen = slot.read()
    assert configs == {"gemm": {"BM": 8}} and gen == 0
    assert slot.swap("gemm", {"BM": 16}) == 1
    assert slot.read() == ({"gemm": {"BM": 16}}, 1)


def test_config_slot_noop_swap_keeps_generation():
    slot = ConfigSlot({"gemm": {"BM": 8}})
    assert slot.swap("gemm", {"BM": 8}) == 0
    assert slot.generation == 0


def test_config_slot_snapshot_is_isolated():
    slot = ConfigSlot({"gemm": {"BM": 8}})
    snap, _ = slot.read()
    snap["gemm"]["BM"] = 999            # mutating a snapshot is harmless
    snap["new"] = {}
    assert slot.read()[0] == {"gemm": {"BM": 8}}
    src = {"BM": 4}
    slot.swap("gemm", src)
    src["BM"] = 123                     # later mutation of the source too
    assert slot.read()[0] == {"gemm": {"BM": 4}}


def test_config_slot_replace_whole_map():
    slot = ConfigSlot({"a": {"X": 1}})
    gen = slot.replace({"b": {"Y": 2}})
    assert slot.read() == ({"b": {"Y": 2}}, gen)


def test_config_slot_concurrent_swaps_never_tear():
    """Readers must only ever see complete {k1, k2} states from one writer."""
    slot = ConfigSlot({"k1": {"v": 0}, "k2": {"v": 0}})
    stop = threading.Event()
    torn = []

    def writer():
        i = 0
        while not stop.is_set():
            i += 1
            slot.replace({"k1": {"v": i}, "k2": {"v": i}})

    t = threading.Thread(target=writer)
    t.start()
    try:
        for _ in range(2000):
            snap, _ = slot.read()
            if snap["k1"]["v"] != snap["k2"]["v"]:
                torn.append(snap)
    finally:
        stop.set()
        t.join()
    assert not torn


# -- cache change notification ----------------------------------------------

def test_cache_subscriber_fires_on_record(cache):
    seen = []
    cache.subscribe(lambda key, entry: seen.append((key, entry.config)))
    assert cache.record("k", "s", "p", {"X": 2}, 0.5, "full", 4)
    assert len(seen) == 1 and seen[0][1] == {"X": 2}
    assert cache.unsubscribe(lambda: None) is False


def test_cache_subscriber_not_fired_on_refused_put(cache):
    seen = []
    cache.record("k", "s", "p", {"X": 2}, 0.5, "full", 4)
    cache.subscribe(lambda key, entry: seen.append(key))
    # worse time under only_if_better: refused, no notification
    assert not cache.record("k", "s", "p", {"X": 1}, 0.9, "full", 4)
    assert not cache.record("k", "s", "p", {"X": 1}, float("inf"), "full", 4)
    assert seen == []


def test_cache_subscriber_exception_is_swallowed(cache, caplog):
    def bad(key, entry):
        raise RuntimeError("boom")

    seen = []
    cache.subscribe(bad)
    cache.subscribe(lambda key, entry: seen.append(key))
    with caplog.at_level(logging.ERROR, logger="repro_torch.cache"):
        assert cache.record("k", "s", "p", {"X": 2}, 0.5, "full", 4)
    assert len(seen) == 1               # later subscribers still ran
    assert any("subscriber" in r.message for r in caplog.records)


def test_cache_unsubscribe_stops_notifications(cache):
    seen = []
    fn = lambda key, entry: seen.append(key)        # noqa: E731
    cache.subscribe(fn)
    cache.record("k", "s1", "p", {"X": 2}, 0.5, "full", 4)
    assert cache.unsubscribe(fn) is True
    cache.record("k", "s2", "p", {"X": 2}, 0.5, "full", 4)
    assert len(seen) == 1


# -- lookup provenance -------------------------------------------------------

def test_lookup_resolved_provenance_chain(cache):
    k = _toy_kernel()
    # empty cache, TRANSFER: heuristic
    res = lookup_resolved(k, {"N": 1024}, cache=cache, policy="transfer",
                          profile=H100_SXM)
    assert res.provenance == "heuristic" and not res.exact
    assert res.config == {"X": 1}
    # nearby tuned shape: transfer, with the source shape reported
    cache.record(k.name, k.key_for({"N": 512}), H100_SXM.name, {"X": 4},
                 0.25, "full", 4, shape={"N": 512})
    res = lookup_resolved(k, {"N": 1024}, cache=cache, policy="transfer",
                          profile=H100_SXM)
    assert res.provenance == "transfer" and res.config == {"X": 4}
    assert res.source_shape == {"N": 512}
    # exact entry wins
    cache.record(k.name, k.key_for({"N": 1024}), H100_SXM.name, {"X": 8},
                 0.125, "full", 4, shape={"N": 1024})
    res = lookup_resolved(k, {"N": 1024}, cache=cache, policy="transfer",
                          profile=H100_SXM)
    assert res.provenance == "exact" and res.exact
    assert res.config == {"X": 8}


def test_lookup_resolved_tuned_provenance(cache):
    k = _toy_kernel()
    res = lookup_resolved(
        k, {"N": 64}, cache=cache, policy="on_miss", strategy="full",
        profile=H100_SXM,
        evaluator=AnalyticalEvaluator(profile=H100_SXM, noise_sigma=0.0))
    assert res.provenance == "tuned"
    assert res.config == {"X": 8}


# -- BackgroundTuner ---------------------------------------------------------

def test_background_tuner_records_winner_and_notifies(cache):
    k = _toy_kernel()
    slot = ConfigSlot({k.name: {"X": 1}})
    cache.subscribe(lambda key, entry: slot.swap(k.name, entry.config))
    tuner = BackgroundTuner(cache=cache, config=_tuner_cfg())
    try:
        job = tuner.submit(k, {"N": 1024}, provenance="heuristic")
        assert job is not None
        assert tuner.wait(timeout=30)
        assert job.status is JobStatus.DONE
        assert job.config == {"X": 8}
        entry = cache.get(k.name, k.key_for({"N": 1024}), H100_SXM.name)
        assert entry is not None and entry.config == {"X": 8}
        assert entry.shape == {"N": 1024}       # transferable to neighbours
        assert slot.read() == ({k.name: {"X": 8}}, 1)
    finally:
        tuner.close()


def test_background_tuner_deduplicates_jobs(cache):
    k = _toy_kernel()
    tuner = BackgroundTuner(cache=cache, config=_tuner_cfg())
    try:
        j1 = tuner.submit(k, {"N": 1024})
        j2 = tuner.submit(k, {"N": 1024})
        assert j1 is j2
        assert tuner.wait(timeout=30)
        assert len(tuner.jobs) == 1
    finally:
        tuner.close()


def test_background_tuner_failed_search_leaves_cache_untouched(cache):
    k = _toy_kernel(name="onl_fail", fail=True)
    tuner = BackgroundTuner(cache=cache, config=_tuner_cfg())
    try:
        job = tuner.submit(k, {"N": 1024})
        assert tuner.wait(timeout=30)
        assert job.status is JobStatus.FAILED
        assert job.config is None
        assert len(cache) == 0          # nothing recorded, nothing to swap
    finally:
        tuner.close()


def test_background_tuner_aborted_search_not_recorded(cache):
    """A circuit-breaker abort may carry a partial best — it must still NOT
    reach the cache / hot-swap path."""
    k = _toy_kernel(name="onl_abort", fail=True)
    tuner = BackgroundTuner(
        cache=cache, config=_tuner_cfg(engine={"max_failures": 2}))
    try:
        job = tuner.submit(k, {"N": 1024})
        assert tuner.wait(timeout=30)
        assert job.status is JobStatus.FAILED
        assert "aborted" in (job.error or "") or "feasible" in (job.error or "")
        assert len(cache) == 0
    finally:
        tuner.close()


def test_background_tuner_closed_refuses_jobs(cache):
    tuner = BackgroundTuner(cache=cache, config=_tuner_cfg())
    tuner.close()
    assert tuner.submit(_toy_kernel(), {"N": 64}) is None


def test_background_tuner_max_pending(cache):
    tuner = BackgroundTuner(cache=cache,
                            config=_tuner_cfg(max_pending=0))
    try:
        assert tuner.submit(_toy_kernel(), {"N": 64}) is None
    finally:
        tuner.close()


def test_background_tuner_failed_job_can_be_resubmitted(cache):
    """A FAILED job must not pin its geometry forever: the next submit
    retries (a transient failure or a fixed declaration gets its search)."""
    k_bad = _toy_kernel(name="onl_retry", fail=True)
    k_good = _toy_kernel(name="onl_retry", fail=False)
    tuner = BackgroundTuner(cache=cache, config=_tuner_cfg())
    try:
        j1 = tuner.submit(k_bad, {"N": 1024})
        assert tuner.wait(timeout=30)
        assert j1.status is JobStatus.FAILED
        j2 = tuner.submit(k_good, {"N": 1024})
        assert j2 is not j1
        assert tuner.wait(timeout=30)
        assert j2.status is JobStatus.DONE and j2.config == {"X": 8}
        # DONE jobs still dedup
        assert tuner.submit(k_good, {"N": 1024}) is j2
    finally:
        tuner.close()


# -- the port's own ------------------------------------------------------------

def test_background_job_keeps_the_runtime_profile(cache):
    """A profile read from the card has no entry in PROFILES: a job for it
    measures against the tuner's own profile, limits and all."""
    card = dataclasses.replace(H100_SXM, name="runtime_card",
                               hbm_bytes=85_017_493_504)
    seen = []

    def factory(k, shape, profile):
        seen.append(profile)
        return AnalyticalEvaluator(profile=profile, noise_sigma=0.0)

    k = _toy_kernel(name="onl_card")
    tuner = BackgroundTuner(cache=cache, profile=card,
                            config=_tuner_cfg(evaluator_factory=factory))
    try:
        job = tuner.submit(k, {"N": 1024})
        assert tuner.wait(timeout=30)
        assert job.status is JobStatus.DONE and job.profile == "runtime_card"
        assert seen == [card]
        assert cache.get(k.name, k.key_for({"N": 1024}),
                         "runtime_card").config == {"X": 8}
    finally:
        tuner.close()


def test_background_tuner_defaults_to_the_devices_profile(cache):
    assert BackgroundTuner(cache=cache,
                           config=OnlineTuneConfig(device="cpu")
                           ).profile is H100_SXM


def test_submit_for_resolutions_queues_non_exact_ones(cache):
    from repro_torch.kernels.matmul import GEMM, heuristic_config
    tuned = {"M": 512, "N": 512, "K": 512, "dtype": "float32"}
    cache.record(GEMM.name, GEMM.key_for(tuned), H100_SXM.name,
                 heuristic_config(512, 512, 512), 1e-4, "full", 4,
                 shape=tuned)
    resolutions = {
        "exact": lookup_resolved(GEMM, tuned, cache=cache,
                                 policy="transfer", profile=H100_SXM),
        "transfer": lookup_resolved(GEMM, dict(tuned, M=1024), cache=cache,
                                    policy="transfer", profile=H100_SXM)}
    assert resolutions["exact"].exact
    assert resolutions["transfer"].provenance == "transfer"
    tuner = BackgroundTuner(cache=cache, config=_tuner_cfg())
    try:
        jobs = submit_for_resolutions(tuner, resolutions)
        assert sorted(jobs) == ["transfer"]
        assert jobs["transfer"].provenance == "transfer"
        assert tuner.wait(timeout=60)
        assert jobs["transfer"].status is JobStatus.DONE
        assert lookup_resolved(GEMM, dict(tuned, M=1024), cache=cache,
                               policy="transfer", profile=H100_SXM).exact
    finally:
        tuner.close()


# -- parity with the JAX package -------------------------------------------------

#: the JAX package's background job looks its profile up by name, so the
#: port's modeled H100 takes a name the JAX package knows: cache keys match
PORT_H100 = dataclasses.replace(H100_SXM, name=ref_core.TPU_V5E.name)
#: per package: (core, online, analytical evaluator, profile, where the
#: search runs)
PKGS = {"port": (port_core, port_online, port_core.AnalyticalEvaluator,
                 PORT_H100, {"device": "cpu"}),
        "jax": (ref_core, ref_online, ref_core.TPUAnalyticalEvaluator,
                ref_core.TPU_V5E, {"interpret": True})}


def _toy_in(core, name="onl_parity", values=(1, 2, 4, 8), fail=False):
    def space(shape):
        sp = core.SearchSpace()
        sp.add_parameter(name="X", values=values)
        sp.add_constraint(lambda x: shape["N"] % x == 0, ("X",), "N % X")
        return sp

    def model(shape, cfg, prof):
        if fail:
            raise RuntimeError("model exploded")
        return 1.0 / cfg["X"] + 1e-3 * (cfg["X"] == 8)

    @core.tunable(name=name, space=space, heuristic=lambda s: {"X": 1},
                  analytical_model=model, register=False)
    def build(shape, config):
        return lambda: config["X"]

    return build


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_config_slot_transitions_match_the_jax_package(seed):
    """A seeded run of swaps (some no-ops) and whole-map replacements: the
    same snapshot and generation after every step."""
    rng = np.random.default_rng(seed)
    ops = [(int(rng.integers(0, 3)), f"k{int(rng.integers(0, 3))}",
            {"X": int(rng.integers(0, 3))}) for _ in range(40)]

    def digest(online):
        slot = online.ConfigSlot({"k0": {"X": 0}})
        seen = []
        for op, name, cfg in ops:
            if op == 2:
                slot.replace({name: cfg, "k0": {"X": 0}})
            else:
                slot.swap(name, cfg)
            seen.append(slot.read())
        snap, _ = slot.read()
        snap["k0"]["X"] = 99                 # a snapshot is the reader's
        seen.append(slot.read())
        return seen

    port = digest(port_online)
    assert port == digest(ref_online)
    assert port[-1][1] > 0


def test_cache_notifications_match_the_jax_package(tmp_path):
    """Records, refused puts, merges and an unsubscribe: the same change
    notifications in both packages."""
    def digest(core):
        c = core.TuningCache(str(tmp_path / f"{id(core)}.json"))
        seen = []

        def listener(key, entry):
            seen.append((key, entry.config, entry.time_s))

        c.subscribe(listener)
        c.record("k", "s", "p", {"X": 1}, 1.0, "full", 4)
        c.record("k", "s", "p", {"X": 2}, 2.0, "full", 4)     # refused
        c.record("k", "s", "p", {"X": 3}, 0.5, "full", 4)
        c.record("k", "s2", "p", {"X": 4}, 0.5, "full", 4,
                 objective="p99_time")
        other = core.TuningCache(str(tmp_path / f"o{id(core)}.json"))
        other.record("k", "s", "p", {"X": 5}, 0.25, "full", 4)
        other.record("k", "s", "p", {"X": 6}, 9.0, "full", 4)
        other.record("k", "s3", "p", {"X": 7}, 1.0, "full", 4)
        changed = sorted(c.merge(other))
        c.unsubscribe(listener)
        c.record("k", "s4", "p", {"X": 8}, 0.1, "full", 4)
        return seen, changed

    port = digest(port_core)
    assert port == digest(ref_core)
    assert len(port[0]) == 5


def _tuner_for(key, cache, **kw):
    core, online, Analytical, profile, where = PKGS[key]
    kw.setdefault("strategy", "full")
    kw.setdefault("evaluator_factory",
                  lambda k, s, p: Analytical(profile=p, noise_sigma=0.0))
    return online.BackgroundTuner(
        cache=cache, profile=profile,
        config=online.OnlineTuneConfig(**where, **kw))


@pytest.mark.parametrize("strategy,budget", [("full", None),
                                             ("annealing", 3),
                                             ("random", 2)])
def test_background_jobs_match_the_jax_package(tmp_path, strategy, budget):
    """Good, failing, aborted, duplicate and resubmitted jobs beside a
    slot fed by the cache: the same job transitions, winners, cache and
    slot generations in both packages."""
    def digest(key):
        core, online = PKGS[key][:2]
        profile = PKGS[key][3]
        cache = core.TuningCache(str(tmp_path / f"{key}.json"))
        slot = online.ConfigSlot({"onl_parity": {"X": 1}})
        cache.subscribe(lambda k, e: slot.swap(core.split_key(k)[0],
                                               e.config))
        good = _toy_in(core)
        bad = _toy_in(core, name="onl_parity_bad", fail=True)
        tuner = _tuner_for(key, cache, strategy=strategy, budget=budget,
                           engine={"max_failures": 2})
        rows = []
        try:
            for kernel, shape, prov in ((good, {"N": 1024}, "heuristic"),
                                        (good, {"N": 1024}, "transfer"),
                                        (bad, {"N": 64}, "transfer"),
                                        (good, {"N": 12}, "transfer")):
                job = tuner.submit(kernel, shape, provenance=prov)
                rows.append(job.status.value if job else None)
            assert tuner.wait(timeout=60)
            retry = tuner.submit(good, {"N": 64}, provenance="transfer")
            again = tuner.submit(bad, {"N": 64}, provenance="transfer")
            assert tuner.wait(timeout=60)
            rows.append(again is not retry)
            for job in tuner.jobs.values():
                rows.append((job.kernel, job.shape, job.profile,
                             job.provenance, job.objective,
                             job.status.value, job.config, job.best_time,
                             job.evaluations, job.error is None))
        finally:
            tuner.close()
        rows.append(tuner.submit(good, {"N": 2048}))
        rows.append(sorted((k, e.config, e.time_s, e.shape)
                           for k, e in cache.entries().items()))
        rows.append(slot.read())
        return rows

    port = digest("port")
    assert port == digest("jax")
    assert port[-1][1] >= 1                  # a winner swapped in


def test_resolutions_and_their_jobs_match_the_jax_package(tmp_path,
                                                          monkeypatch):
    """Heuristic, transfer, exact and tuned resolutions: the same
    provenance, and the same ones queued by submit_for_resolutions (which
    resolves a kernel by its registered name)."""
    def digest(key):
        core, online, Analytical, profile, _ = PKGS[key]
        cache = core.TuningCache(str(tmp_path / f"{key}.json"))
        k = _toy_in(core)
        monkeypatch.setitem(core.registry.REGISTRY._kernels, k.name, k)
        cache.record(k.name, k.key_for({"N": 512}), profile.name, {"X": 4},
                     0.25, "full", 4, shape={"N": 512})
        resolutions = {
            "heuristic": core.lookup_resolved(k, {"N": 7}, cache=cache,
                                              policy="transfer",
                                              profile=profile),
            "transfer": core.lookup_resolved(k, {"N": 1024}, cache=cache,
                                             policy="transfer",
                                             profile=profile),
            "exact": core.lookup_resolved(k, {"N": 512}, cache=cache,
                                          policy="transfer",
                                          profile=profile),
            "tuned": core.lookup_resolved(
                k, {"N": 64}, cache=cache, policy="on_miss",
                strategy="full", profile=profile,
                evaluator=Analytical(profile=profile, noise_sigma=0.0)),
        }
        rows = [(name, r.config, r.provenance, r.exact, r.source_shape)
                for name, r in sorted(resolutions.items())]
        tuner = _tuner_for(key, cache)
        try:
            jobs = online.submit_for_resolutions(tuner, resolutions)
            assert tuner.wait(timeout=60)
            rows.append(sorted((name, j.provenance, j.status.value,
                                j.config) for name, j in jobs.items()))
        finally:
            tuner.close()
        rows.append(core.lookup_resolved(k, {"N": 1024}, cache=cache,
                                         policy="transfer",
                                         profile=profile).provenance)
        return rows

    port = digest("port")
    assert port == digest("jax")
    assert [r[0] for r in port[-2]] == ["heuristic", "transfer"]
