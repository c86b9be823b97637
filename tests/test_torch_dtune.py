"""The port's distributed tuning plane (``repro_torch.dtune``): a twin of
tests/test_dtune.py, on the CPU.

Sharding, workers, coordinator and fleet merge, the TuningCache merge
primitive and merge-on-disk save protocol (multiprocessing concurrent
writers, torn-file recovery), the default_cache() race fix, the nearest()
shape-index memoization and the engine's cooperative stop_event, each
as the JAX package's test checks it, with the port's analytical evaluator
and ``device="cpu"`` (a modeled H100).  The process driver always spawns
(a parent that has initialised CUDA cannot fork), so the tests that need
``fork`` in the JAX package run here under ``spawn``.

Added beside the twins: the same toy space gives identical shards and
per-worker trial sequences in both packages; two spawned processes that
ask ``build()`` for one library compile it once; a profile shipped as a
dict reaches a spawned worker with every field.
"""

import dataclasses
import json
import math
import multiprocessing
import os
import threading

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (H100_SXM, AnalyticalEvaluator,  # noqa: E402
                              EngineConfig, EvaluationEngine, KernelSpec,
                              SearchSpace, TuningCache, make_strategy)
from repro_torch.core.cache import default_cache  # noqa: E402
from repro_torch.core.evaluators import Evaluator, Measurement  # noqa: E402
from repro_torch.dtune import (ISLAND_STRATEGIES,  # noqa: E402
                               DistributedTuner, Shard, TuningWorker,
                               WorkerSpec, run_workers, shard_space)
from repro_torch.kernels import build, launch_counts  # noqa: E402

SHAPE = {"M": 512, "N": 512, "K": 512}
ANALYTICAL = {"name": "analytical", "noise_sigma": 0.0}
#: every fleet here runs on the CPU against a modeled H100
CPU = {"device": "cpu"}


def make_space(n_params=3, n_values=4):
    sp = SearchSpace()
    for i in range(n_params):
        sp.add_parameter(name=f"p{i}", values=tuple(range(n_values)))
    return sp


class CountingEvaluator(Evaluator):
    """Deterministic objective; counts evaluations."""

    name = "counting"

    def __init__(self):
        self.calls = 0

    def prepare(self, spec, config):
        return None

    def measure(self, spec, config, prepared=None, prune_threshold_s=None):
        self.calls += 1
        return Measurement(time_s=1.0 + sum(config.values()), ok=True)


SPEC = KernelSpec(name="stub", build=lambda c: (lambda: None))


# -- partitioning -------------------------------------------------------------

def test_strided_shards_partition_space_exactly():
    space = make_space()
    shards = shard_space(space, 4, "strided")
    seen = {}
    for shard in shards:
        strat = make_strategy(shard.strategy, **shard.strategy_kwargs)
        res = strat.run(space, lambda c: 1.0, budget=None)
        for t in res.trials:
            key = space.config_key(t.config)
            assert key not in seen, \
                f"config visited by shards {seen[key]} and {shard.index}"
            seen[key] = shard.index
    assert len(seen) == space.cardinality()          # union covers everything
    # balanced: strided split sizes differ by at most one
    sizes = [sum(1 for v in seen.values() if v == i) for i in range(4)]
    assert max(sizes) - min(sizes) <= 1


def test_shard_space_validation():
    space = make_space(1, 4)
    with pytest.raises(ValueError, match="at least one shard"):
        shard_space(space, 0)
    with pytest.raises(ValueError, match="unknown shard mode"):
        shard_space(space, 2, "rings")
    with pytest.raises(ValueError, match="full search"):
        shard_space(space, 2, "strided", strategies=["pso"])
    with pytest.raises(ValueError, match="at least one strategy"):
        shard_space(space, 2, "islands", strategies=[])


def test_islands_rotate_strategies_and_seeds():
    shards = shard_space(make_space(), 6, "islands", budget=10, seed=7)
    assert [s.strategy for s in shards] == \
        list(ISLAND_STRATEGIES) + list(ISLAND_STRATEGIES[:2])
    assert len({s.seed for s in shards}) == 6        # all distinct
    assert all(s.budget == 10 for s in shards)


def test_full_search_stride_validation():
    with pytest.raises(ValueError):
        make_strategy("full", offset=2, stride=2)
    with pytest.raises(ValueError):
        make_strategy("full", offset=-1, stride=2)
    with pytest.raises(ValueError):
        make_strategy("full", stride=0)


def test_full_search_asktell_respects_stride():
    space = make_space(2, 4)                         # 16 configs
    eng = EvaluationEngine(CountingEvaluator(), SPEC, space, EngineConfig())
    res = eng.run(make_strategy("full", offset=1, stride=4), None)
    assert res.evaluations == 4                      # 16 / 4


# -- engine stop event --------------------------------------------------------

def test_stop_event_yields_graceful_partial_result():
    space = make_space()
    stop = threading.Event()
    stop.set()                                       # stop before any batch
    eng = EvaluationEngine(CountingEvaluator(), SPEC, space,
                           EngineConfig(stop_event=stop))
    res = eng.run(make_strategy("full"), None)
    assert res.extra["aborted"]["stopped"] is True
    assert res.evaluations == 0 and res.best is None
    assert res.extra["engine"]["aborted"] is True


def test_stop_event_unset_changes_nothing():
    space = make_space()
    eng = EvaluationEngine(CountingEvaluator(), SPEC, space,
                           EngineConfig(stop_event=threading.Event()))
    res = eng.run(make_strategy("full"), None)
    assert "aborted" not in res.extra
    assert res.evaluations == space.cardinality()


# -- workers ------------------------------------------------------------------

def _spec(tmp_path, shard, **kw):
    defaults = dict(kernel="gemm", shape=dict(SHAPE), shard=shard,
                    evaluator=ANALYTICAL, device="cpu",
                    cache_path=str(tmp_path / f"w{shard.index}.json"))
    defaults.update(kw)
    return WorkerSpec(**defaults)


def test_worker_runs_one_shard_and_records(tmp_path):
    shard = Shard(index=0, total=2, mode="strided", strategy="full",
                  strategy_kwargs={"offset": 0, "stride": 2})
    res = TuningWorker(_spec(tmp_path, shard)).run()
    assert res.status == "ok" and res.ok
    assert math.isfinite(res.best_time) and res.evaluations > 0
    private = TuningCache(res.cache_path).load()
    assert len(private) == 1                         # shard winner recorded
    entry = private.get("gemm", "M512_N512_K512_float32", "h100_sxm")
    assert entry is not None and entry.config == res.best_config


def test_worker_crash_becomes_failed_result(tmp_path):
    shard = Shard(index=0, total=1, mode="strided", strategy="full",
                  strategy_kwargs={"offset": 0, "stride": 1})
    res = TuningWorker(_spec(tmp_path, shard,
                             kernel="no-such-kernel")).run()
    assert res.status == "failed" and not res.ok
    assert "no-such-kernel" in (res.error or "")


def test_worker_stop_event_reports_aborted(tmp_path):
    shard = Shard(index=0, total=1, mode="strided", strategy="full",
                  strategy_kwargs={"offset": 0, "stride": 1})
    stop = threading.Event()
    stop.set()
    res = TuningWorker(_spec(tmp_path, shard), stop_event=stop).run()
    assert res.status == "aborted"
    assert res.best_config is None                   # stopped before work


def test_worker_reports_the_launches_it_made(tmp_path):
    """A worker returns the change in the kernels' launch counts over its
    run: what shows that its measurements ran the kernel."""
    from repro_torch.kernels.matmul import LAUNCHES

    class Launching(AnalyticalEvaluator):
        def measure(self, spec, config, prepared=None,
                    prune_threshold_s=None):
            LAUNCHES["gemm_scratch"] += 1
            return super().measure(spec, config, prepared,
                                   prune_threshold_s)

    shard = Shard(index=0, total=4, mode="strided", strategy="full",
                  strategy_kwargs={"offset": 0, "stride": 4})
    evaluator = Launching(profile=H100_SXM, noise_sigma=0.0)
    res = TuningWorker(_spec(tmp_path, shard, evaluator=evaluator)).run()
    assert res.status == "ok" and res.evaluations > 0
    assert set(res.launches) == set(launch_counts())
    assert res.launches["gemm_scratch"] == res.evaluations
    assert sum(res.launches.values()) == res.evaluations


def test_run_workers_rejects_unknown_driver():
    with pytest.raises(ValueError, match="unknown dtune driver"):
        run_workers([], driver="carrier-pigeon")


def test_evaluator_spec_forms(tmp_path):
    from repro_torch.dtune.worker import resolve_evaluator
    assert resolve_evaluator(None) is None
    ev = AnalyticalEvaluator(profile=H100_SXM)
    assert resolve_evaluator(ev) is ev
    # a modeled evaluator named without a profile models the fleet's
    assert resolve_evaluator("analytical", profile=H100_SXM).name == ev.name
    assert resolve_evaluator(ANALYTICAL,
                             profile=H100_SXM).noise_sigma == 0.0
    assert resolve_evaluator("analytical",
                             profile=H100_SXM).profile is H100_SXM
    # a wall-clock one named without a device measures on the worker's
    assert resolve_evaluator("wallclock", device="cpu").device.type == "cpu"
    with pytest.raises(ValueError, match="'name' key"):
        resolve_evaluator({"noise_sigma": 0.0})
    with pytest.raises(TypeError):
        resolve_evaluator(42)


# -- coordinator --------------------------------------------------------------

def test_distributed_strided_matches_single_process(tmp_path):
    cache = TuningCache(str(tmp_path / "fleet.json"))
    out = DistributedTuner("gemm", SHAPE, n_workers=4, mode="strided",
                           driver="thread", cache=cache,
                           evaluator=ANALYTICAL, **CPU).run()
    assert out.ok and all(w.status == "ok" for w in out.workers)

    from repro_torch.tune import tune_kernel
    single = tune_kernel("gemm", SHAPE, strategy="full", budget=10 ** 9,
                         record=False, warm_start=False, profile=H100_SXM,
                         evaluator=AnalyticalEvaluator(profile=H100_SXM,
                                                       noise_sigma=0.0))
    # exact partition: fleet winner time == single-process winner time and
    # total fleet evaluations == the full space, split ~evenly
    assert out.best_time == pytest.approx(single.best_time)
    assert out.evaluations == single.result.evaluations
    assert out.per_worker_evaluations <= single.result.evaluations / 3
    # the merged fleet winner is in the shared cache file
    again = TuningCache(cache.path).load()
    entry = again.get("gemm", "M512_N512_K512_float32", "h100_sxm")
    assert entry is not None
    assert entry.time_s == pytest.approx(out.best_time)
    assert out.merged_keys == ["gemm|M512_N512_K512_float32|h100_sxm"]


def test_distributed_islands_with_process_driver(tmp_path):
    # spawned, never forked: the JAX package's twin needs fork
    cache = TuningCache(str(tmp_path / "fleet.json"))
    out = DistributedTuner("gemm", SHAPE, n_workers=2, mode="islands",
                           driver="process", budget=8, cache=cache,
                           warm_start=False, evaluator=ANALYTICAL, **CPU
                           ).run(timeout_s=300)
    assert out.ok
    assert [w.status for w in out.workers] == ["ok", "ok"]
    assert all(w.evaluations == 8 for w in out.workers)
    assert len(TuningCache(cache.path).load()) == 1
    # each spawned worker reports its own launches: none on the CPU
    assert all(w.launches == dict.fromkeys(launch_counts(), 0)
               for w in out.workers)


def test_distributed_one_worker_failure_does_not_kill_fleet(tmp_path):
    cache = TuningCache(str(tmp_path / "fleet.json"))
    shards = shard_space(make_space(), 2, "strided")
    specs = [
        WorkerSpec(kernel="gemm", shape=dict(SHAPE), shard=shards[0],
                   evaluator=ANALYTICAL, device="cpu",
                   cache_path=str(tmp_path / "w0.json")),
        WorkerSpec(kernel="no-such-kernel", shape=dict(SHAPE),
                   shard=shards[1], evaluator=ANALYTICAL, device="cpu",
                   cache_path=str(tmp_path / "w1.json")),
    ]
    results = run_workers(specs, "thread")
    assert [r.status for r in results] == ["ok", "failed"]
    assert results[0].ok                             # shard 0 still tuned


def test_env_knobs(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_DTUNE_WORKERS", "7")
    monkeypatch.setenv("REPRO_DTUNE_MODE", "islands")
    monkeypatch.setenv("REPRO_DTUNE_DRIVER", "process")
    dt = DistributedTuner("gemm", SHAPE,
                          cache=TuningCache(str(tmp_path / "c.json")), **CPU)
    assert (dt.n_workers, dt.mode, dt.driver) == (7, "islands", "process")
    monkeypatch.setenv("REPRO_DTUNE_WORKERS", "not-a-number")
    dt = DistributedTuner("gemm", SHAPE, mode="strided", driver="thread",
                          cache=TuningCache(str(tmp_path / "c.json")), **CPU)
    assert dt.n_workers == 4                         # fallback, not a crash


def test_coordinator_rejects_engine_stop_event(tmp_path):
    with pytest.raises(ValueError, match="stop_event"):
        DistributedTuner("gemm", SHAPE,
                         cache=TuningCache(str(tmp_path / "c.json")),
                         engine={"stop_event": threading.Event()}, **CPU)


# -- cache merge --------------------------------------------------------------

def _cache(tmp_path, name="c.json"):
    return TuningCache(str(tmp_path / name))


def test_merge_keeps_best_finite_time_per_key(tmp_path):
    a, b = _cache(tmp_path, "a.json"), _cache(tmp_path, "b.json")
    a.record("k", "s", "p", {"x": 1}, 2.0, "full", 10)
    b.record("k", "s", "p", {"x": 2}, 1.0, "full", 20)
    changed = a.merge(b)
    assert list(changed) == ["k|s|p"]
    e = a.get("k", "s", "p")
    assert e.config == {"x": 2} and e.time_s == 1.0
    assert e.evaluations == 30                       # folded, not replaced
    # the worse entry never overwrites the better one in the other order
    # (count folding alone is not a "changed entry" — no subscriber event)
    assert b.merge(a) == {}
    assert b.get("k", "s", "p").config == {"x": 2}
    assert b.get("k", "s", "p").evaluations == 30


def test_merge_unions_disjoint_keys_and_shapes(tmp_path):
    a, b = _cache(tmp_path, "a.json"), _cache(tmp_path, "b.json")
    a.record("k", "s1", "p", {"x": 1}, 1.0, "full", 1)
    b.record("k", "s2", "p", {"x": 2}, 2.0, "full", 1, shape={"M": 64})
    a.merge(b)
    assert len(a) == 2
    assert a.get("k", "s2", "p").shape == {"M": 64}


def test_merge_adopts_shape_from_loser(tmp_path):
    a, b = _cache(tmp_path, "a.json"), _cache(tmp_path, "b.json")
    a.record("k", "s", "p", {"x": 1}, 1.0, "full", 1)            # no shape
    b.record("k", "s", "p", {"x": 2}, 5.0, "full", 1, shape={"M": 64})
    a.merge(b)
    e = a.get("k", "s", "p")
    assert e.config == {"x": 1} and e.shape == {"M": 64}         # union


def test_merge_is_idempotent(tmp_path):
    a, b = _cache(tmp_path, "a.json"), _cache(tmp_path, "b.json")
    a.record("k", "s", "p", {"x": 1}, 2.0, "full", 10, failures=3)
    b.record("k", "s", "p", {"x": 2}, 1.0, "full", 20, failures=5)
    a.merge(b)
    first = dataclasses.asdict(a.get("k", "s", "p"))
    assert not a.merge(b)                            # no further change
    assert dataclasses.asdict(a.get("k", "s", "p")) == first
    assert first["evaluations"] == 30 and first["failures"] == 8


def test_merge_sanitizes_poisoned_peer(tmp_path):
    a = _cache(tmp_path, "a.json")
    a.record("k", "s", "p", {"x": 1}, 1.0, "full", 1)
    changed = a.merge({"k|bad|p": {"time_s": math.inf, "config": {}},
                       "k|worse|p": "not-an-object",
                       "k|s2|p": {"config": {"x": 9}, "time_s": 2.0,
                                  "strategy": "full", "evaluations": 1,
                                  "timestamp": 0.0}})
    assert list(changed) == ["k|s2|p"]
    assert len(a) == 2                               # poison dropped
    a.save()                                         # strict JSON still OK


def test_merge_from_path_and_errors(tmp_path):
    a, b = _cache(tmp_path, "a.json"), _cache(tmp_path, "b.json")
    b.record("k", "s", "p", {"x": 1}, 1.0, "full", 1)
    b.save()
    assert list(a.merge(b.path)) == ["k|s|p"]
    with pytest.raises(FileNotFoundError):
        a.merge(str(tmp_path / "missing.json"))
    with pytest.raises(TypeError):
        a.merge(42)


def test_merge_fires_subscribers_for_changed_entries_only(tmp_path):
    a, b = _cache(tmp_path, "a.json"), _cache(tmp_path, "b.json")
    a.record("k", "s1", "p", {"x": 1}, 1.0, "full", 1)
    b.record("k", "s1", "p", {"x": 2}, 5.0, "full", 1)   # worse: no event
    b.record("k", "s2", "p", {"x": 3}, 1.0, "full", 1)   # new: event
    events = []
    a.subscribe(lambda key, entry: events.append((key, entry.config)))
    a.merge(b)
    assert events == [("k|s2|p", {"x": 3})]


# -- merge-on-disk save protocol ----------------------------------------------

def test_save_merges_with_concurrent_disk_state(tmp_path):
    path = str(tmp_path / "shared.json")
    first, second = TuningCache(path), TuningCache(path)
    second.load()                                    # loads the empty state
    first.record("k", "s1", "p", {"x": 1}, 1.0, "full", 1)
    first.save()
    # second never saw first's entry; its old-style save would erase it
    second.record("k", "s2", "p", {"x": 2}, 2.0, "full", 1)
    second.save()
    on_disk = TuningCache(path).load()
    assert len(on_disk) == 2                         # both survive
    assert len(second) == 2                          # merged back into memory
    # legacy overwrite is still available explicitly
    second.clear()
    second.save(merge_on_disk=False)
    assert len(TuningCache(path).load()) == 0


def test_save_keeps_best_on_overlapping_key(tmp_path):
    path = str(tmp_path / "shared.json")
    first, second = TuningCache(path), TuningCache(path)
    second.load()
    first.record("k", "s", "p", {"x": 1}, 1.0, "full", 1)
    first.save()
    second.record("k", "s", "p", {"x": 2}, 5.0, "full", 1)   # worse time
    second.save()
    assert TuningCache(path).load().get("k", "s", "p").config == {"x": 1}


def _writer(path, keys, t, barrier):
    cache = TuningCache(path)
    for key in keys:
        cache.record("k", key, "p", {"who": key, "t": t}, t, "full", 1)
    barrier.wait(timeout=60)                         # maximize save overlap
    cache.save()


def test_multiprocessing_concurrent_writers_converge(tmp_path):
    # spawned, as the port's process driver starts its workers
    ctx = multiprocessing.get_context("spawn")
    path = str(tmp_path / "shared.json")
    barrier = ctx.Barrier(2)
    procs = [
        ctx.Process(target=_writer,
                    args=(path, ["only-a", "both"], 1.0, barrier)),
        ctx.Process(target=_writer,
                    args=(path, ["only-b", "both"], 2.0, barrier)),
    ]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
        assert p.exitcode == 0
    merged = TuningCache(path).load()
    assert len(merged) == 3                          # disjoint keys union
    # the overlapping key kept the best finite time, not the last writer
    assert merged.get("k", "both", "p").time_s == 1.0
    assert merged.get("k", "only-a", "p") is not None
    assert merged.get("k", "only-b", "p") is not None


def test_torn_tmp_file_does_not_corrupt_load_or_save(tmp_path):
    path = str(tmp_path / "cache.json")
    cache = TuningCache(path)
    cache.record("k", "s", "p", {"x": 1}, 1.0, "full", 1)
    cache.save()
    # a crashed writer leaves a torn temp sibling + a stale lock file
    with open(str(tmp_path / "cache.json.tmp"), "w") as f:
        f.write('{"torn": ')
    with open(path + ".lock", "w") as f:
        f.write("")
    fresh = TuningCache(path).load()
    assert len(fresh) == 1                           # real file untouched
    fresh.record("k", "s2", "p", {"x": 2}, 2.0, "full", 1)
    fresh.save()                                     # lock path still works
    assert len(TuningCache(path).load()) == 2


def test_save_merge_survives_strict_json_gate(tmp_path):
    """In-memory non-finite entries must still make save() raise (the
    defense-in-depth contract) even on the merge path."""
    path = str(tmp_path / "cache.json")
    cache = TuningCache(path)
    cache.record("k", "s", "p", {"x": 1}, 1.0, "full", 1)
    cache._data["bad"] = {"time_s": math.inf}
    with pytest.raises(ValueError):
        cache.save()


# -- default_cache race -------------------------------------------------------

def test_default_cache_is_one_object_across_threads(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "dc.json"))
    import repro_torch.core.cache as cache_mod
    monkeypatch.setattr(cache_mod, "_default_cache", None)
    results = []
    barrier = threading.Barrier(8)

    def resolver():
        barrier.wait(timeout=30)
        results.append(default_cache())

    threads = [threading.Thread(target=resolver) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(results) == 8
    assert all(c is results[0] for c in results)     # one shared object


# -- nearest() memoization ----------------------------------------------------

def test_nearest_uses_memoized_index_and_invalidates(tmp_path):
    cache = _cache(tmp_path)
    cache.record("k", "s64", "p", {"x": 64}, 1.0, "full", 1,
                 shape={"M": 64})
    cache.record("k", "s128", "p", {"x": 128}, 1.0, "full", 1,
                 shape={"M": 128})
    out = cache.nearest("k", {"M": 100}, "p", k=1)
    assert [e.config["x"] for e in out] == [128]
    bucket = cache._shape_index[("k", "p", None)]
    cache.nearest("k", {"M": 70}, "p", k=1)
    assert cache._shape_index[("k", "p", None)] is bucket  # reused, not rebuilt
    cache.record("k", "s96", "p", {"x": 96}, 1.0, "full", 1,
                 shape={"M": 96})                    # put invalidates
    assert cache._shape_index is None
    out = cache.nearest("k", {"M": 100}, "p", k=1)
    assert [e.config["x"] for e in out] == [96]


def test_nearest_returns_copies(tmp_path):
    cache = _cache(tmp_path)
    cache.record("k", "s", "p", {"x": 1}, 1.0, "full", 1, shape={"M": 64})
    first = cache.nearest("k", {"M": 64}, "p", k=1)[0]
    first.config["x"] = 999                          # caller mutates freely
    first.shape["M"] = 0
    again = cache.nearest("k", {"M": 64}, "p", k=1)[0]
    assert again.config == {"x": 1} and again.shape == {"M": 64}


def test_nearest_index_invalidated_by_merge(tmp_path):
    a, b = _cache(tmp_path, "a.json"), _cache(tmp_path, "b.json")
    a.record("k", "s64", "p", {"x": 64}, 1.0, "full", 1, shape={"M": 64})
    assert a.nearest("k", {"M": 90}, "p", k=1)[0].config["x"] == 64
    b.record("k", "s96", "p", {"x": 96}, 1.0, "full", 1, shape={"M": 96})
    a.merge(b)
    assert a.nearest("k", {"M": 90}, "p", k=1)[0].config["x"] == 96


# -- CacheEntry.failures ------------------------------------------------------

def test_failures_field_roundtrip_and_legacy_stability(tmp_path):
    cache = _cache(tmp_path)
    cache.record("k", "s", "p", {"x": 1}, 1.0, "full", 5, failures=2)
    cache.record("k", "s2", "p", {"x": 2}, 1.0, "full", 5)       # zero
    cache.save()
    raw = json.load(open(cache.path))
    assert raw["k|s|p"]["failures"] == 2
    assert "failures" not in raw["k|s2|p"]           # legacy byte-stability
    again = TuningCache(cache.path).load()
    assert again.get("k", "s", "p").failures == 2
    assert again.get("k", "s2", "p").failures == 0


# -- coordinator workdir containment + shared artifact store ------------------

def _dtune_tmpdirs():
    import tempfile as _tempfile
    base = _tempfile.gettempdir()
    return {d for d in os.listdir(base) if d.startswith("repro-dtune-")}


def test_workdir_cleaned_up_on_coordinator_crash(tmp_path, monkeypatch):
    """A crash anywhere between mkdtemp and the merge (driver raising,
    worker fleet terminated) must not leak the private-cache tempdir."""
    from repro_torch.dtune import coordinator as mod

    def explode(*a, **kw):
        raise RuntimeError("fleet terminated")

    monkeypatch.setattr(mod, "run_workers", explode)
    before = _dtune_tmpdirs()
    dt = DistributedTuner("gemm", SHAPE, n_workers=2, driver="thread",
                          cache=TuningCache(str(tmp_path / "c.json")), **CPU)
    with pytest.raises(RuntimeError, match="fleet terminated"):
        dt.run()
    assert _dtune_tmpdirs() == before                # nothing leaked


def test_workdir_cleaned_up_on_spec_construction_crash(tmp_path, monkeypatch):
    from repro_torch.dtune import coordinator as mod

    def bad_spec(*a, **kw):
        raise TypeError("unpicklable spec")

    monkeypatch.setattr(mod, "WorkerSpec", bad_spec)
    before = _dtune_tmpdirs()
    dt = DistributedTuner("gemm", SHAPE, n_workers=2, driver="thread",
                          cache=TuningCache(str(tmp_path / "c.json")), **CPU)
    with pytest.raises(TypeError, match="unpicklable"):
        dt.run()
    assert _dtune_tmpdirs() == before


def test_workdir_cleaned_up_on_normal_run(tmp_path):
    before = _dtune_tmpdirs()
    DistributedTuner("gemm", SHAPE, n_workers=2, driver="thread",
                     budget=4, mode="islands", evaluator=ANALYTICAL,
                     cache=TuningCache(str(tmp_path / "c.json")), **CPU).run()
    assert _dtune_tmpdirs() == before


def test_worker_spec_ships_artifact_dir(tmp_path):
    """artifact_dir is plain picklable data; the worker opens its own
    store on it and records compiled artifacts there."""
    import pickle

    from repro_torch.core.artifacts import ArtifactStore

    shard = Shard(index=0, total=1, mode="strided", strategy="full",
                  strategy_kwargs={"offset": 0, "stride": 1})
    spec = _spec(tmp_path, shard, artifact_dir=str(tmp_path / "store"))
    assert pickle.loads(pickle.dumps(spec)).artifact_dir == spec.artifact_dir
    res = TuningWorker(spec).run()
    assert res.status == "ok"
    # the analytical evaluator has no compile phase: nothing persisted,
    # nothing crashed — the plumbing is exercised end to end
    assert len(ArtifactStore(str(tmp_path / "store"))) == 0


def test_distributed_reruns_share_artifact_store(tmp_path):
    """Second fleet run against the warm shared store: every prepare in
    every worker is a store hit — zero fresh compiles fleet-wide."""
    from repro_torch.core import KernelCost
    from repro_torch.core import SearchSpace as SS
    from repro_torch.core.artifacts import ArtifactStore
    from repro_torch.core.registry import tunable

    def space(shape):
        sp = SS()
        sp.add_parameter(name="k", values=(1.0, 2.0, 3.0, 4.0))
        return sp

    # the port prices a declared cost where the JAX package lowers
    @tunable(name="dtune-artifact-probe", space=space,
             heuristic=lambda s: {"k": 1.0},
             cost=lambda s, cfg: KernelCost(flops=64.0 * cfg["k"],
                                            bytes=512.0))
    def probe(shape, config):
        return lambda x: x * float(config["k"])

    store_dir = str(tmp_path / "store")

    def fleet():
        dt = DistributedTuner(
            "dtune-artifact-probe", {"N": 8}, n_workers=2, mode="strided",
            driver="thread", evaluator={"name": "costmodel"},
            artifact_store=store_dir,
            cache=TuningCache(str(tmp_path / "c.json")), **CPU)
        out = dt.run()
        stats = [w.engine_stats for w in out.workers if w.engine_stats]
        return (sum(s["unique_configs"] for s in stats),
                sum(s["artifact_hits"] for s in stats))

    unique_cold, hits_cold = fleet()
    assert unique_cold == 4
    # each distinct artifact was compiled at most once fleet-wide
    store = ArtifactStore(store_dir)
    assert len(store) == 4 - hits_cold
    unique_warm, hits_warm = fleet()
    assert (unique_warm, hits_warm) == (4, 4)        # zero fresh compiles


# -- the port's own: parity with the JAX package, builds, shipped profiles ---

def _toy_space(pkg):
    sp = pkg.SearchSpace()
    sp.add_parameter(name="A", values=(1, 2, 4, 8))
    sp.add_parameter(name="B", values=(16, 32, 64))
    sp.add_parameter(name="C", values=(False, True))
    sp.add_constraint(lambda a, b: a * b <= 256, ("A", "B"), "A*B <= 256")
    return sp


def _toy_objective(cfg):
    return 1.0 + abs(cfg["A"] - 4) + cfg["B"] / 16.0 + 0.5 * cfg["C"]


@pytest.mark.parametrize("mode", ["strided", "islands"])
def test_shards_and_trials_match_the_jax_package(mode):
    """The same toy space gives identical shards, and each shard's
    strategy the same trial sequence, in both packages."""
    import repro.core as ref_core
    import repro.dtune as ref_dtune
    import repro_torch.core as port_core
    kw = dict(budget=6, seed=3) if mode == "islands" else {}
    port_shards = shard_space(_toy_space(port_core), 4, mode, **kw)
    ref_shards = ref_dtune.shard_space(_toy_space(ref_core), 4, mode, **kw)
    assert ([dataclasses.asdict(s) for s in port_shards]
            == [dataclasses.asdict(s) for s in ref_shards])
    for pkg, shards, out in ((port_core, port_shards, []),
                             (ref_core, ref_shards, [])):
        for shard in shards:
            strat = pkg.make_strategy(shard.strategy,
                                      **shard.strategy_kwargs)
            res = strat.run(_toy_space(pkg), _toy_objective,
                            budget=shard.budget, seed=shard.seed)
            out.append([dict(t.config) for t in res.trials])
        if pkg is port_core:
            port_trials = out
        else:
            ref_trials = out
    assert port_trials == ref_trials
    assert all(port_trials)


def _counting_compile(source, defines, name, lib):
    """A stand-in for nvcc: writes the library and counts the call."""
    import time as _time
    _time.sleep(0.5)                             # widen the race window
    with open(os.path.join(os.path.dirname(lib), "compiles.txt"), "a") as f:
        f.write(f"{os.getpid()}\n")
    with open(lib, "w") as f:
        f.write("library")


def _build_once(build_dir, source, barrier):
    from repro_torch.kernels import build as mod
    mod.BUILD_DIR = build_dir
    mod._compile = _counting_compile
    barrier.wait(timeout=120)
    mod.build(source, {"BLOCK": 64}, "probe")


def test_two_spawned_processes_compile_one_library_once(tmp_path):
    source = str(tmp_path / "probe.cu")
    with open(source, "w") as f:
        f.write("// a kernel\n")
    build_dir = str(tmp_path / "kernels")
    ctx = multiprocessing.get_context("spawn")
    barrier = ctx.Barrier(2)
    procs = [ctx.Process(target=_build_once,
                         args=(build_dir, source, barrier))
             for _ in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=180)
        assert not p.is_alive() and p.exitcode == 0
    with open(os.path.join(build_dir, "compiles.txt")) as f:
        assert len(f.read().split()) == 1        # one compile, two askers
    key = build.digest(source, {"BLOCK": 64})
    assert os.path.exists(os.path.join(build_dir, f"probe-{key}.so"))


def test_build_logs_each_compile(tmp_path, monkeypatch):
    """Each nvcc run leaves one line in the build log; a cached library
    adds none."""
    source = str(tmp_path / "probe.cu")
    with open(source, "w") as f:
        f.write("// a kernel\n")

    def fake_compile(source, defines, name, lib):
        with open(lib, "w") as f:
            f.write("library")
        build.record_build(lib, 0.25)

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "kernels"))
    monkeypatch.setattr(build, "_compile", fake_compile)
    lib, address = build.build(source, {"X": 1}, "probe")
    assert build.build(source, {"X": 1}, "probe") == (lib, address)
    build.build(source, {"X": 2}, "probe")
    log = build.read_build_log()
    assert [r["library"] for r in log] == [
        os.path.basename(lib),
        f"probe-{build.digest(source, {'X': 2})}.so"]
    assert all(r["s"] == 0.25 and r["pid"] == os.getpid() for r in log)


def test_dict_profile_reaches_a_spawned_worker(tmp_path):
    """A card's runtime profile has no name in PROFILES: the coordinator
    ships its fields, and a spawned worker models those limits."""
    from repro_torch.kernels.matmul import smem_footprint
    card = dataclasses.replace(H100_SXM, name="runtime_card",
                               smem_per_block_optin=12_000,
                               hbm_bytes=85_017_493_504)
    cache = TuningCache(str(tmp_path / "fleet.json"))
    out = DistributedTuner("gemm", SHAPE, n_workers=2, mode="strided",
                           driver="process", cache=cache, profile=card,
                           evaluator=ANALYTICAL, **CPU).run(timeout_s=300)
    assert [w.status for w in out.workers] == ["ok", "ok"]
    assert out.profile == "runtime_card"
    # the shipped shared-memory limit bounded the search in the workers
    assert smem_footprint(out.best_config) <= 12_000
    wide = DistributedTuner("gemm", SHAPE, n_workers=2, mode="strided",
                            driver="thread", record=False,
                            evaluator=ANALYTICAL, **CPU).run()
    assert smem_footprint(wide.best_config) > 12_000
    entry = TuningCache(cache.path).load().get(
        "gemm", "M512_N512_K512_float32", "runtime_card")
    assert entry is not None and entry.config == out.best_config


def test_worker_spec_profile_forms():
    from repro_torch.dtune.worker import resolve_profile_spec
    import pickle
    card = dataclasses.replace(H100_SXM, name="runtime_card",
                               hbm_bytes=85_017_493_504)
    shipped = pickle.loads(pickle.dumps(dataclasses.asdict(card)))
    assert resolve_profile_spec(shipped) == card
    assert resolve_profile_spec("h100_sxm") is H100_SXM
    assert resolve_profile_spec(None, "cpu") is H100_SXM
    with pytest.raises(TypeError):
        resolve_profile_spec(42)
