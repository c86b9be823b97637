"""The port's compile-artifact cache (``repro_torch.core.artifacts``): a
twin of tests/test_artifacts.py, on the CPU — the typed CompiledArtifact
contract, the content-addressed store (concurrent writers, torn-tmp and
stale-lock recovery, corrupted-entry quarantine), the engine's
artifact_hits accounting, the evaluate() deprecation shim and the REPRO_*
env-knob parsing.

The port lowers nothing, so the JAX package's fingerprint of a lowered
module has its twin in :func:`~repro_torch.core.evaluators.source_digest`,
which keys the cost model's stored prices by what the declared cost and the
build are made of: the five fingerprint tests become tests of that digest.

The last section drives the JAX package's store, fingerprints, engine and
env knobs beside the port's in one process, and holds the port's store
hits, records and counts to the JAX package's.
"""

import json
import multiprocessing
import os
import threading
import warnings

import pytest

torch = pytest.importorskip("torch")

import repro.core as ref_core  # noqa: E402
from repro.core import artifacts as ref_artifacts  # noqa: E402
from repro.core import envknobs as ref_envknobs  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro_torch.core import artifacts as port_artifacts  # noqa: E402
from repro_torch.core import envknobs as port_envknobs  # noqa: E402

from repro_torch.core import (H100_SXM, EngineConfig,  # noqa: E402
                              EvaluationEngine, KernelCost, KernelSpec,
                              SearchSpace, make_strategy)
from repro_torch.core.artifacts import (  # noqa: E402
    ARTIFACT_FORMAT_VERSION, ArtifactStore, CompiledArtifact, default_store,
    resolve_store, spec_fingerprint)
from repro_torch.core.envknobs import (env_bool, env_int,  # noqa: E402
                                       env_str, parse_bool)
from repro_torch.core.evaluators import (AnalyticalEvaluator,  # noqa: E402
                                         CostModelEvaluator, source_digest)
from repro_torch.core.failures import CompileError  # noqa: E402
from repro_torch.core.tuner import Tuner  # noqa: E402

# -- source digests (the twin of the lowered-module fingerprint) --------------


def _scale(cfg):
    return 2.0 * cfg["k"]


def _scale_again(cfg):
    return 2.0 * cfg["k"]


def _scale_more(cfg):
    return 3.0 * cfg["k"]


def test_source_digest_moves_with_the_body():
    assert source_digest(_scale) == source_digest(_scale)
    assert source_digest(_scale) != source_digest(_scale_more)


def test_source_digest_follows_called_functions(monkeypatch):
    """A declaration's cost lambda that only calls a helper moves with the
    helper's body: an edit to traffic() is priced anew."""
    cost = lambda cfg: _scale(cfg)          # noqa: E731
    before = source_digest(cost)
    monkeypatch.setitem(globals(), "_scale", _scale_more)
    assert source_digest(cost) != before
    monkeypatch.setitem(globals(), "_scale", _scale_again)
    # the same text under another name is another function's source
    assert source_digest(cost) != before


def test_source_digest_falls_back_to_bytecode_without_source():
    ns = {}
    exec("def f(cfg):\n    return 2.0 * cfg['k']\n"
         "def g(cfg):\n    return 3.0 * cfg['k']\n", ns)
    assert source_digest(ns["f"]) == source_digest(ns["f"])
    assert source_digest(ns["f"]) != source_digest(ns["g"])


def test_source_digest_reads_device_sources(tmp_path):
    cu = tmp_path / "kernel.cu"
    cu.write_text("__global__ void k() {}\n")
    a = source_digest(_scale, str(cu))
    assert a == source_digest(_scale, str(cu))
    cu.write_text("__global__ void k() { int x = 1; }\n")
    assert source_digest(_scale, str(cu)) != a
    missing = source_digest(_scale, str(tmp_path / "gone.cu"))
    assert missing != a and missing != source_digest(_scale)


def test_source_digest_of_the_declarations_differ():
    from repro_torch.kernels.attention import FLASH_ATTENTION
    from repro_torch.kernels.conv2d import CONV2D
    from repro_torch.kernels.matmul import GEMM
    digests = {k.name: source_digest(k.cost, *k.sources)
               for k in (GEMM, CONV2D, FLASH_ATTENTION)}
    assert len(set(digests.values())) == 3
    assert all(len(k.sources) == 1 and k.sources[0].endswith(".cu")
               and os.path.exists(k.sources[0])
               for k in (GEMM, CONV2D, FLASH_ATTENTION))


def test_spec_fingerprint_keys_on_kernel_shape_config():
    a = spec_fingerprint("gemm", {"M": 8}, {"bm": 128})
    assert a == spec_fingerprint("gemm", {"M": 8}, {"bm": 128})
    assert a != spec_fingerprint("gemm", {"M": 16}, {"bm": 128})
    assert a != spec_fingerprint("gemm", {"M": 8}, {"bm": 256})
    assert a != spec_fingerprint("conv", {"M": 8}, {"bm": 128})
    assert a != spec_fingerprint("gemm", {"M": 8}, {"bm": 128}, extra="seed=1")
    assert a.startswith("spec:")


# -- the store ----------------------------------------------------------------

def _artifact(fp="spec:abc", profile="h100_sxm", kind="costmodel", flops=1.0):
    return CompiledArtifact(
        kind=kind, fingerprint=fp, profile=profile,
        payload={"flops": flops, "bytes": 2.0, "collective_bytes": 0.0,
                 "compile_s": 0.25},
        stats={"flops": flops}, compile_s=0.25, persistable=True)


def test_store_roundtrip_across_instances(tmp_path):
    root = str(tmp_path / "store")
    ArtifactStore(root).put(_artifact())
    got = ArtifactStore(root).get("costmodel", "spec:abc", "h100_sxm")
    assert got is not None and got.from_store
    assert got.compile_s == 0.0                      # the hit pays nothing
    assert got.payload["flops"] == 1.0
    assert got.persistable


def test_store_keys_on_kind_fingerprint_and_profile(tmp_path):
    store = ArtifactStore(str(tmp_path))
    store.put(_artifact())
    assert store.get("costmodel", "spec:abc", "a100") is None
    assert store.get("costmodel", "spec:other", "h100_sxm") is None
    assert store.get("wallclock", "spec:abc", "h100_sxm") is None
    assert store.get("costmodel", "spec:abc", "h100_sxm") is not None
    assert len(store) == 1


def test_store_refuses_live_payloads(tmp_path):
    store = ArtifactStore(str(tmp_path))
    live = CompiledArtifact(kind="wallclock", fingerprint="spec:xyz",
                            profile="", payload=lambda: None,
                            persistable=False)
    assert store.put(live) is None
    assert len(store) == 0
    with pytest.raises(TypeError, match="live"):
        live.to_json()


def test_corrupted_entry_is_quarantined_not_fatal(tmp_path):
    store = ArtifactStore(str(tmp_path))
    store.put(_artifact())
    path = store.path_for("costmodel", "spec:abc", "h100_sxm")
    with open(path, "w") as f:
        f.write('{"torn": ')
    fresh = ArtifactStore(str(tmp_path))
    assert fresh.get("costmodel", "spec:abc", "h100_sxm") is None
    assert fresh.stats.quarantined == 1
    assert os.path.exists(path + ".corrupt")
    assert not os.path.exists(path)
    # and the address is usable again
    assert fresh.put(_artifact()) is not None
    assert fresh.get("costmodel", "spec:abc", "h100_sxm") is not None


def test_foreign_format_version_is_quarantined(tmp_path):
    store = ArtifactStore(str(tmp_path))
    store.put(_artifact())
    path = store.path_for("costmodel", "spec:abc", "h100_sxm")
    with open(path) as f:
        record = json.load(f)
    record["format"] = ARTIFACT_FORMAT_VERSION + 1
    with open(path, "w") as f:
        json.dump(record, f)
    fresh = ArtifactStore(str(tmp_path))
    assert fresh.get("costmodel", "spec:abc", "h100_sxm") is None
    assert fresh.stats.quarantined == 1


def test_mismatched_address_inside_record_is_quarantined(tmp_path):
    store = ArtifactStore(str(tmp_path))
    store.put(_artifact())
    src = store.path_for("costmodel", "spec:abc", "h100_sxm")
    dst = store.path_for("costmodel", "spec:stolen", "h100_sxm")
    os.replace(src, dst)                 # record claims a different address
    fresh = ArtifactStore(str(tmp_path))
    assert fresh.get("costmodel", "spec:stolen", "h100_sxm") is None
    assert fresh.stats.quarantined == 1


def test_torn_tmp_and_stale_lock_do_not_break_store(tmp_path):
    store = ArtifactStore(str(tmp_path))
    store.put(_artifact())
    # a crashed writer leaves a torn temp sibling + a stale lock file
    with open(str(tmp_path / "dead.tmp"), "w") as f:
        f.write('{"torn": ')
    lock = store.path_for("costmodel", "spec:abc", "h100_sxm") + ".lock"
    with open(lock, "w") as f:
        f.write("")
    fresh = ArtifactStore(str(tmp_path))
    assert fresh.get("costmodel", "spec:abc", "h100_sxm") is not None
    # get_or_compute must acquire the stale lock, see the record, not compute
    calls = []
    art = fresh.get_or_compute("costmodel", "spec:abc", "h100_sxm",
                               lambda: calls.append(1) or _artifact())
    assert art.from_store and not calls


def test_get_or_compute_computes_once_and_persists(tmp_path):
    store = ArtifactStore(str(tmp_path))
    calls = []

    def compute():
        calls.append(1)
        return _artifact(fp="spec:fresh")

    a1 = store.get_or_compute("costmodel", "spec:fresh", "h100_sxm", compute)
    a2 = store.get_or_compute("costmodel", "spec:fresh", "h100_sxm", compute)
    assert len(calls) == 1
    assert a1.provenance == "fresh" and a2.from_store
    assert ArtifactStore(str(tmp_path)).get(
        "costmodel", "spec:fresh", "h100_sxm") is not None


def test_get_or_compute_propagates_compile_errors_uncached(tmp_path):
    store = ArtifactStore(str(tmp_path))

    def boom():
        raise CompileError("nope")

    for _ in range(2):                   # a failure is never cached
        with pytest.raises(CompileError):
            store.get_or_compute("costmodel", "spec:bad", "h100_sxm", boom)
    assert len(store) == 0
    assert store.stats.compiles == 2


def test_get_or_compute_threads_compile_at_most_once(tmp_path):
    store = ArtifactStore(str(tmp_path))
    barrier = threading.Barrier(4)
    calls = []
    results = []

    def compute():
        calls.append(1)
        return _artifact(fp="spec:contended")

    def worker():
        barrier.wait(timeout=30)
        results.append(store.get_or_compute(
            "costmodel", "spec:contended", "h100_sxm", compute))

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert len(calls) == 1
    assert len(results) == 4
    assert all(r.payload["flops"] == 1.0 for r in results)


def _store_writer(root, fp, barrier, log_path):
    store = ArtifactStore(root)

    def compute():
        with open(log_path, "a") as f:
            f.write("compiled\n")
        return _artifact(fp=fp)

    barrier.wait(timeout=60)             # maximize get_or_compute overlap
    store.get_or_compute("costmodel", fp, "h100_sxm", compute)
    store.put(_artifact(fp=fp + ":private"))


def test_multiprocessing_concurrent_writers_converge(tmp_path):
    # spawned, as the port's process driver starts its workers
    ctx = multiprocessing.get_context("spawn")
    root = str(tmp_path / "store")
    log_path = str(tmp_path / "compiles.log")
    barrier = ctx.Barrier(2)
    procs = [ctx.Process(target=_store_writer,
                         args=(root, "spec:shared", barrier, log_path))
             for _ in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
        assert p.exitcode == 0
    # the contended artifact compiled exactly once across both processes
    with open(log_path) as f:
        assert len(f.read().splitlines()) == 1
    merged = ArtifactStore(root)
    assert merged.get("costmodel", "spec:shared", "h100_sxm") is not None
    assert merged.get("costmodel", "spec:shared:private",
                      "h100_sxm") is not None
    assert len(merged) == 2


# -- default_store / resolve_store env gating ---------------------------------

def test_default_store_disabled_unless_enabled(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_ARTIFACT_CACHE", raising=False)
    assert default_store() is None
    monkeypatch.setenv("REPRO_ARTIFACT_CACHE", "1")
    monkeypatch.setenv("REPRO_ARTIFACT_DIR", str(tmp_path / "a"))
    store = default_store()
    assert store is not None and store.root == str(tmp_path / "a")
    assert default_store() is store      # singleton while env unchanged
    monkeypatch.setenv("REPRO_ARTIFACT_DIR", str(tmp_path / "b"))
    assert default_store().root == str(tmp_path / "b")
    monkeypatch.setenv("REPRO_ARTIFACT_CACHE", "off")
    assert default_store() is None


def test_default_store_rejects_garbage_enable_values(monkeypatch):
    monkeypatch.setenv("REPRO_ARTIFACT_CACHE", "2")
    with pytest.raises(TypeError, match="REPRO_ARTIFACT_CACHE"):
        default_store()


def test_resolve_store_forms(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_ARTIFACT_CACHE", raising=False)
    assert resolve_store(None) is None
    store = ArtifactStore(str(tmp_path))
    assert resolve_store(store) is store
    assert resolve_store(str(tmp_path)).root == str(tmp_path)
    with pytest.raises(TypeError, match="artifact_store"):
        resolve_store(123)


# -- evaluator integration ----------------------------------------------------

def _cost_spec():
    # the port prices a declared cost where the JAX package lowers
    return KernelSpec(
        name="probe",
        build=lambda cfg: (lambda x: x * float(cfg["k"])),
        cost=lambda cfg: KernelCost(flops=64.0 * cfg["k"], bytes=512.0),
        meta={"N": 8})


def test_costmodel_prepare_hits_warm_store(tmp_path):
    spec = _cost_spec()
    ev = CostModelEvaluator(H100_SXM)
    ev.artifact_store = ArtifactStore(str(tmp_path))
    fresh = ev.prepare(spec, {"k": 2.0})
    assert fresh.provenance == "fresh" and fresh.compile_s > 0
    assert fresh.profile == ev.profile.name
    # a different process/evaluator sharing the store skips the compile
    ev2 = CostModelEvaluator(H100_SXM)
    ev2.artifact_store = ArtifactStore(str(tmp_path))
    hit = ev2.prepare(spec, {"k": 2.0})
    assert hit.from_store and hit.compile_s == 0.0
    assert hit.fingerprint == fresh.fingerprint
    assert ev2.artifact_store.stats.compiles == 0
    # measure prices store hits and fresh compiles identically
    assert (ev2.measure(spec, {"k": 2.0}, hit).time_s
            == ev.measure(spec, {"k": 2.0}, fresh).time_s)
    # a different config lowers to a different address
    other = ev2.prepare(spec, {"k": 3.0})
    assert other.provenance == "fresh"
    assert other.fingerprint != fresh.fingerprint


def test_engine_counts_artifact_hits(tmp_path):
    spec = _cost_spec()
    space = SearchSpace()
    space.add_parameter(name="k", values=(1.0, 2.0, 3.0))

    def run():
        ev = CostModelEvaluator(H100_SXM)
        ev.artifact_store = ArtifactStore(str(tmp_path))
        engine = EvaluationEngine(ev, spec, space,
                                  EngineConfig(workers=1))
        result = engine.run(make_strategy("full"), None, seed=0)
        return result.extra["engine"]

    cold = run()
    assert cold["artifact_hits"] == 0
    assert cold["compiles_avoided"] == cold["memo_hits"]
    warm = run()                         # same search against the warm store
    assert warm["artifact_hits"] == warm["unique_configs"] == 3
    assert warm["compiles_avoided"] >= 3


def test_tuner_attaches_store_without_clobbering(tmp_path):
    ev = CostModelEvaluator(H100_SXM)
    tuner = Tuner(evaluator=ev, artifact_store=str(tmp_path / "a"),
                  profile=H100_SXM)
    assert ev.artifact_store is not None
    assert ev.artifact_store.root == str(tmp_path / "a")
    assert tuner.artifact_store is ev.artifact_store
    # a store the evaluator already carries wins over the tuner's
    tuner2 = Tuner(evaluator=ev, artifact_store=str(tmp_path / "b"),
                   profile=H100_SXM)
    assert ev.artifact_store.root == str(tmp_path / "a")
    assert tuner2.artifact_store is ev.artifact_store


def test_base_prepare_returns_typed_no_payload_artifact():
    ev = AnalyticalEvaluator(profile=H100_SXM)
    spec = KernelSpec(name="t", build=lambda c: None,
                      analytical_model=lambda c, p: 1e-3)
    art = ev.prepare(spec, {"a": 1})
    assert isinstance(art, CompiledArtifact)
    assert art.provenance == "none" and art.payload is None
    assert not art.persistable
    m = ev.measure(spec, {"a": 1}, art)
    assert m.ok


# -- the evaluate() deprecation shim ------------------------------------------

def test_evaluate_warns_once_per_process(monkeypatch):
    from repro_torch.core import evaluators as mod
    monkeypatch.setattr(mod, "_EVALUATE_DEPRECATION_EMITTED", False)
    ev = AnalyticalEvaluator(profile=H100_SXM, noise_sigma=0.0)
    spec = KernelSpec(name="t", build=lambda c: None,
                      analytical_model=lambda c, p: 1e-3)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        m1 = ev.evaluate(spec, {"a": 1})
        m2 = ev.evaluate(spec, {"a": 2})
    deprecations = [w for w in caught
                    if issubclass(w.category, DeprecationWarning)
                    and "prepare" in str(w.message)]
    assert len(deprecations) == 1
    assert m1.ok and m2.ok


def test_objective_path_does_not_warn(monkeypatch):
    from repro_torch.core import evaluators as mod
    monkeypatch.setattr(mod, "_EVALUATE_DEPRECATION_EMITTED", False)
    ev = AnalyticalEvaluator(profile=H100_SXM, noise_sigma=0.0)
    spec = KernelSpec(name="t", build=lambda c: None,
                      analytical_model=lambda c, p: 1e-3)
    obj = ev.objective(spec)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert obj({"a": 1}) > 0
    assert not [w for w in caught
                if issubclass(w.category, DeprecationWarning)]
    assert mod._EVALUATE_DEPRECATION_EMITTED is False


# -- envknobs -----------------------------------------------------------------

def test_parse_bool_canonical_spellings():
    assert parse_bool(True) is True and parse_bool(False) is False
    for raw in ("1", "true", "On", "YES"):
        assert parse_bool(raw) is True
    for raw in ("0", "false", "Off", "no", ""):
        assert parse_bool(raw) is False


def test_parse_bool_rejects_truthy_coercion():
    # 0 / 'off'-like values must never truthy-coerce
    for bad in (0, 1, 2, "enable", "tru", None, [], object()):
        with pytest.raises(TypeError):
            parse_bool(bad)


def test_env_bool(monkeypatch):
    monkeypatch.delenv("REPRO_X", raising=False)
    assert env_bool("REPRO_X", True) is True
    monkeypatch.setenv("REPRO_X", "on")
    assert env_bool("REPRO_X", False) is True
    monkeypatch.setenv("REPRO_X", "garbage")
    with pytest.raises(TypeError, match="REPRO_X"):
        env_bool("REPRO_X")


def test_env_int_warns_and_falls_back(monkeypatch):
    monkeypatch.delenv("REPRO_N", raising=False)
    assert env_int("REPRO_N", 4) == 4
    monkeypatch.setenv("REPRO_N", "7")
    assert env_int("REPRO_N", 4) == 7
    monkeypatch.setenv("REPRO_N", "seven")
    assert env_int("REPRO_N", 4) == 4


def test_env_str_choices(monkeypatch):
    monkeypatch.delenv("REPRO_S", raising=False)
    assert env_str("REPRO_S", "a") == "a"
    monkeypatch.setenv("REPRO_S", "")
    assert env_str("REPRO_S", "a") == "a"
    monkeypatch.setenv("REPRO_S", "b")
    assert env_str("REPRO_S", "a", choices=("a", "b")) == "b"
    monkeypatch.setenv("REPRO_S", "zzz")
    assert env_str("REPRO_S", "a", choices=("a", "b")) == "a"


# -- parity with the JAX package -------------------------------------------------

FINGERPRINTED = [
    ("gemm", {"M": 8}, {"bm": 128}, ""),
    ("gemm", {"M": 16, "dtype": "bfloat16"}, {"bm": 128, "bn": 64}, ""),
    ("conv", None, {"BLOCK_H": 16, "UNROLL": True}, "seed=1"),
    ("flash", {"S": 4096, "causal": True}, {"BLOCK_Q": 64}, "x"),
    ("k", {}, {}, ""),
]


def test_spec_fingerprints_match_the_jax_package():
    port = [port_artifacts.spec_fingerprint(k, m, c, extra=e)
            for k, m, c, e in FINGERPRINTED]
    assert port == [ref_artifacts.spec_fingerprint(k, m, c, extra=e)
                    for k, m, c, e in FINGERPRINTED]
    assert len(set(port)) == len(port)


def _store_digest(mod, root):
    """One sequence of puts, gets, computes and a torn record through
    ``mod``'s store: what each step returns, the files it leaves and the
    store's counters."""
    def art(fp, flops, profile="h100_sxm", kind="costmodel"):
        return mod.CompiledArtifact(
            kind=kind, fingerprint=fp, profile=profile,
            payload={"flops": flops, "bytes": 2.0}, stats={"flops": flops},
            compile_s=0.25, persistable=True)

    store = mod.ArtifactStore(root)
    steps = [store.put(art("spec:a", 1.0)) is not None,
             store.put(mod.CompiledArtifact(
                 kind="wallclock", fingerprint="spec:live", profile="",
                 payload=lambda: None, persistable=False)) is None]
    fresh = mod.ArtifactStore(root)
    for key in (("costmodel", "spec:a", "h100_sxm"),
                ("costmodel", "spec:a", "a100"),
                ("costmodel", "spec:b", "h100_sxm"),
                ("wallclock", "spec:a", "h100_sxm")):
        got = fresh.get(*key)
        steps.append(None if got is None else
                     (got.provenance, got.compile_s, got.payload))
    calls = []
    for fp in ("spec:a", "spec:c", "spec:c", "spec:d"):
        got = fresh.get_or_compute(
            "costmodel", fp, "h100_sxm",
            lambda fp=fp: calls.append(fp) or art(fp, 3.0))
        steps.append((got.provenance, got.fingerprint, got.payload))
    with open(fresh.path_for("costmodel", "spec:d", "h100_sxm"), "w") as f:
        f.write('{"torn": ')
    torn = mod.ArtifactStore(root)
    steps.append(torn.get("costmodel", "spec:d", "h100_sxm"))
    files = sorted(os.path.relpath(os.path.join(d, n), root)
                   for d, _, names in os.walk(root) for n in names
                   if not n.endswith(".lock"))
    return (steps, calls, files, fresh.stats.as_dict(),
            torn.stats.as_dict(), len(torn))


def test_store_matches_the_jax_package(tmp_path):
    port = _store_digest(port_artifacts, str(tmp_path / "port"))
    assert port == _store_digest(ref_artifacts, str(tmp_path / "jax"))
    assert port[3]["hits"] > 0 and port[4]["quarantined"] == 1


def _stored_evaluator(pkg):
    """An evaluator whose prepare goes through the artifact store, as the
    cost model's does, on ``pkg``'s types."""

    class Stored(pkg.Evaluator):
        name = "stored"

        def __init__(self, store):
            self.artifact_store = store

        def prepare(self, spec, config):
            fp = pkg.spec_fingerprint(spec.name, spec.meta, config)
            return self.artifact_store.get_or_compute(
                "stored", fp, "h100_sxm", lambda: pkg.CompiledArtifact(
                    kind="stored", fingerprint=fp, profile="h100_sxm",
                    payload={"t": 1.0 + sum(config.values())},
                    compile_s=0.1, persistable=True))

        def measure(self, spec, config, prepared=None,
                    prune_threshold_s=None):
            return pkg.Measurement(time_s=prepared.payload["t"], ok=True)

    return Stored


@pytest.mark.parametrize("strategy,budget,seed", [
    ("full", None, 0), ("pso", 30, 1), ("annealing", 20, 2)])
def test_engine_store_hits_match_the_jax_package(tmp_path, strategy, budget,
                                                 seed):
    """The same search cold, then warm on its store: the same trials and
    the same artifact hits in both packages."""
    def digest(pkg, root):
        sp = pkg.SearchSpace()
        sp.add_parameter(name="a", values=(0, 1, 2, 3))
        sp.add_parameter(name="b", values=(0, 1, 2))
        spec = pkg.KernelSpec(name="probe", build=lambda c: None,
                              meta={"N": 8})
        runs = []
        for _ in range(2):
            ev = _stored_evaluator(pkg)(pkg.ArtifactStore(root))
            eng = pkg.EvaluationEngine(ev, spec, sp,
                                       pkg.EngineConfig(workers=1))
            res = eng.run(pkg.make_strategy(strategy), budget, seed=seed)
            stats = res.extra["engine"]
            runs.append(([(t.config, t.time) for t in res.trials],
                         {k: stats[k] for k in (
                             "evaluations", "unique_configs", "memo_hits",
                             "compile_calls", "artifact_hits",
                             "compiles_avoided")},
                         ev.artifact_store.stats.as_dict()))
        return runs

    port = digest(port_core, str(tmp_path / "port"))
    assert port == digest(ref_core, str(tmp_path / "jax"))
    cold, warm = port
    assert cold[1]["artifact_hits"] == 0
    assert warm[1]["artifact_hits"] == warm[1]["unique_configs"] > 0


KNOB_VALUES = (None, "", "1", "0", "true", "On", "YES", "no", "off",
               "garbage", "7", "-3", "seven", "b", "zzz")


def test_env_knobs_match_the_jax_package(monkeypatch):
    def digest(mod):
        out = []
        for raw in KNOB_VALUES:
            if raw is None:
                monkeypatch.delenv("REPRO_PARITY", raising=False)
            else:
                monkeypatch.setenv("REPRO_PARITY", raw)
            row = []
            for read in (lambda: mod.env_bool("REPRO_PARITY", True),
                         lambda: mod.env_int("REPRO_PARITY", 4),
                         lambda: mod.env_str("REPRO_PARITY", "a",
                                             choices=("a", "b")),
                         lambda: mod.parse_bool(raw)):
                try:
                    row.append(read())
                except TypeError as e:
                    row.append(("TypeError", "REPRO_PARITY" in str(e)))
            out.append(row)
        return out

    port = digest(port_envknobs)
    assert port == digest(ref_envknobs)
