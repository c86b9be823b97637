"""The port's serve path (``repro_torch.serve.engine``, ``dist/step.py``,
``launch/serve.py``) on the CPU: twins of tests/test_serve.py and
tests/test_serve_buckets.py, then the port held against the JAX
package's engine.

The twins run the port's engine on a CPU parameter tree with the modeled
H100 profile where the JAX tests use the TPU one.  The JAX package's
``test_config_swap_changes_lowered_computation`` fingerprints the lowered
HLO; the port has no HLO, so its twin holds what the lowering showed: the
derived RunConfigs and the memoised steps differ, the chunked head issues
V / head_chunk products, and the greedy tokens are identical.
"""

import dataclasses
import logging
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch.overrides import TorchFunctionMode  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
import repro.core as ref_core  # noqa: E402
import repro.models as ref_models  # noqa: E402
import repro.serve as ref_serve  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (H100_SXM, SearchSpace, TuningCache,  # noqa: E402
                              lookup_resolved, tunable)
from repro_torch.dist.step import (apply_kernel_configs,  # noqa: E402
                                   make_prefill_step, make_serve_step)
from repro_torch.launch import serve as launcher  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.models.model import (RunConfig, forward,  # noqa: E402
                                      init_cache, init_model)
from repro_torch.serve import (BackgroundTuner,  # noqa: E402
                               BucketedServeEngine, JobStatus,
                               OnlineTuneConfig, Request, ServeEngine,
                               buckets_from_env, modeled_arrival_trace,
                               resolve_kernel_configs,
                               resolve_kernel_resolutions,
                               trace_evaluator_factory)


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("granite-3-2b", smoke=True)
    return cfg, init_model(cfg, 0, "cpu")



@pytest.fixture
def cache(tmp_path):
    return TuningCache(str(tmp_path / "cache.json"))


# -- twins of tests/test_serve.py ------------------------------------------------

def test_engine_completes_all_requests(setup, cache):
    cfg, params = setup
    engine = ServeEngine(cfg, params, slots=2, max_len=128, cache=cache)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(1, cfg.vocab_size, 5).tolist(),
                    max_new_tokens=6)
            for i in range(5)]          # 5 requests > 2 slots: forces refill
    for r in reqs:
        engine.submit(r)
    done = engine.run()
    assert len(done) == 5
    for r in done:
        assert len(r.output) == 6
        assert all(0 <= t < cfg.vocab_size for t in r.output)
    assert engine.device.type == "cpu"
    assert engine.profile is H100_SXM
    assert all(t.device.type == "cpu"
               for t in engine.cache["blocks"].values())


def test_engine_eos_stops_early(setup, cache):
    cfg, params = setup
    engine = ServeEngine(cfg, params, slots=1, max_len=128, cache=cache)
    engine.submit(Request(rid=0, prompt=[1, 2, 3], max_new_tokens=50,
                          eos_id=None))
    done = engine.run()
    assert done[0].done
    # an eos id the engine emits stops the request at that token
    first = done[0].output[0]
    eng2 = ServeEngine(cfg, params, slots=1, max_len=128, cache=cache)
    eng2.submit(Request(rid=1, prompt=[1, 2, 3], max_new_tokens=50,
                        eos_id=first))
    out = eng2.run()
    assert out[0].done and out[0].output == [first]


def test_engine_rejects_embedding_models():
    cfg = get_config("musicgen-medium", smoke=True)
    with pytest.raises(ValueError):
        ServeEngine(cfg, params=None)


def test_engine_max_steps_returns_unfinished_flagged(setup, cache, caplog):
    cfg, params = setup
    engine = ServeEngine(cfg, params, slots=1, max_len=128, cache=cache)
    reqs = [Request(rid=i, prompt=[1, 2, 3], max_new_tokens=6)
            for i in range(2)]          # 2 requests, 1 slot: one stays queued
    for r in reqs:
        engine.submit(r)
    with caplog.at_level(logging.WARNING, logger="repro_torch.serve"):
        out = engine.run(max_steps=3)
    assert {r.rid for r in out} == {0, 1}
    assert not any(r.done for r in out)
    assert any("max_steps" in rec.message for rec in caplog.records)
    done = engine.run()
    assert {r.rid for r in done} == {0, 1}
    assert all(r.done and len(r.output) == 6 for r in done)


# -- twins of tests/test_serve_buckets.py -------------------------------------

def _seed_exact(cfg, cache, slots, max_len):
    for res in resolve_kernel_resolutions(cfg, slots, max_len,
                                          profile=H100_SXM,
                                          cache=cache).values():
        cache.record(res.kernel, res.key, res.profile, res.config,
                     1.0, "full", 1, shape=res.shape)


def _ragged_requests(cfg, seed=0):
    rng = np.random.default_rng(seed)
    lens = [(3, 6), (4, 8), (10, 40), (20, 30), (2, 10)]   # prompt, new
    return [Request(rid=i,
                    prompt=rng.integers(1, cfg.vocab_size, p).tolist(),
                    max_new_tokens=n)
            for i, (p, n) in enumerate(lens)]


def test_buckets_from_env(monkeypatch):
    assert buckets_from_env(default=(128,)) == (128,)
    monkeypatch.setenv("REPRO_SERVE_BUCKETS", "512, 128,128,2048")
    assert buckets_from_env() == (128, 512, 2048)
    monkeypatch.setenv("REPRO_SERVE_BUCKETS", "128,banana")
    with pytest.raises(ValueError):
        buckets_from_env()
    monkeypatch.setenv("REPRO_SERVE_BUCKETS", "0,128")
    with pytest.raises(ValueError):
        buckets_from_env()
    monkeypatch.setenv("REPRO_SERVE_BUCKETS", " , ")
    with pytest.raises(ValueError):
        buckets_from_env()


def test_modeled_arrival_trace_deterministic_and_quantized():
    shape = {"Sq": 512, "Sk": 512, "D": 64, "causal": True}
    t1 = modeled_arrival_trace(shape, arrivals=8, min_dim=128)
    t2 = modeled_arrival_trace(shape, arrivals=8, min_dim=128)
    assert t1 == t2 and len(t1) == 8
    assert t1[0]["Sq"] == 512
    for s in t1:
        assert s["Sq"] % 128 == 0 and 128 <= s["Sq"] <= 512
        assert s["D"] == 64
        assert s["causal"] is True
    assert {s["Sq"] for s in t1} == {512, 256, 384, 128}
    assert t1 == ref_serve.modeled_arrival_trace(shape, arrivals=8,
                                                 min_dim=128)
    with pytest.raises(ValueError):
        modeled_arrival_trace(shape, arrivals=0)


def test_trace_evaluator_factory_requires_analytical_model():
    class NoModel:
        name = "nm"
        analytical_model = None

    with pytest.raises(ValueError):
        trace_evaluator_factory()(NoModel(), {"N": 64}, H100_SXM)


def test_bucket_assignment_and_completion(setup, cache):
    cfg, params = setup
    engine = BucketedServeEngine(cfg, params, buckets=(16, 64), slots=2,
                                 cache=cache, online_tune=False)
    try:
        reqs = _ragged_requests(cfg)
        assigned = {r.rid: engine.submit(r) for r in reqs}
        assert assigned == {0: 16, 1: 16, 2: 64, 3: 64, 4: 16}
        done = engine.run()
        assert {r.rid for r in done} == set(range(5))
        for r in done:
            assert r.done and len(r.output) == r.max_new_tokens
            assert all(0 <= t < cfg.vocab_size for t in r.output)
        assert engine.rejected == []
        assert engine.engines[16].steps_total > 0
        assert engine.engines[64].steps_total > 0
        assert engine.profile is H100_SXM
    finally:
        engine.close()


def test_bucketed_padding_matches_single_engine_outputs(setup, cache):
    cfg, params = setup
    req = lambda: Request(rid=0, prompt=[5, 7, 11], max_new_tokens=6)  # noqa: E731
    single = ServeEngine(cfg, params, slots=2, max_len=64, cache=cache)
    single.submit(ra := req())
    single.run()
    single.close()
    engine = BucketedServeEngine(cfg, params, buckets=(16, 64), slots=2,
                                 cache=cache, online_tune=False)
    try:
        assert engine.submit(rb := req()) == 16
        engine.run()
        assert rb.output == ra.output
    finally:
        engine.close()


def test_oversized_request_is_rejected(setup, cache):
    cfg, params = setup
    engine = BucketedServeEngine(cfg, params, buckets=(16,), slots=1,
                                 cache=cache, online_tune=False)
    try:
        big = Request(rid=9, prompt=[1] * 10, max_new_tokens=50)
        assert engine.submit(big) is None
        assert engine.rejected == [big]
        assert engine.run() == []
    finally:
        engine.close()


def test_bucketed_engine_env_buckets(setup, cache, monkeypatch):
    cfg, params = setup
    monkeypatch.setenv("REPRO_SERVE_BUCKETS", "32,8")
    engine = BucketedServeEngine(cfg, params, slots=1, cache=cache,
                                 online_tune=False)
    try:
        assert engine.buckets == (8, 32)
        assert set(engine.engines) == {8, 32}
    finally:
        engine.close()


def test_per_bucket_hot_swap_isolation(setup, cache):
    """A p99-scoped winner for one bucket's geometry swaps into that bucket
    alone.  The JAX twin swaps in BLOCK_Q=999, which the static proof
    refuses on an H100 (its shared memory is over 227 KB): the port swaps
    in a feasible BLOCK_Q and shows the refusal too."""
    cfg, params = setup
    for b in (16, 64):
        _seed_exact(cfg, cache, 2, b)               # exact hits: no jobs
    engine = BucketedServeEngine(
        cfg, params, buckets=(16, 64), slots=2, cache=cache,
        online_tune=OnlineTuneConfig(strategy="full", budget=2),
        objective="p99_time")
    try:
        assert engine.tuner.config.objective == "p99_time"
        small, large = engine.engines[16], engine.engines[64]
        res = small.kernel_resolutions["flash_attention"]
        before_small = small.kernel_configs["flash_attention"]
        before_large = large.kernel_configs["flash_attention"]
        refused = dict(res.config, BLOCK_Q=999)
        cache.record(res.kernel, res.key, res.profile, refused, 0.6,
                     "full", 1, shape=res.shape, objective="p99_time")
        assert small.kernel_configs["flash_attention"] == before_small
        upgraded = dict(res.config, BLOCK_Q=32)
        assert upgraded != before_small
        cache.record(res.kernel, res.key, res.profile, upgraded, 0.5,
                     "full", 1, shape=res.shape)
        assert small.kernel_configs["flash_attention"] == before_small
        cache.record(res.kernel, res.key, res.profile, upgraded, 0.4,
                     "full", 1, shape=res.shape, objective="p99_time")
        assert small.kernel_configs["flash_attention"] == upgraded
        assert large.kernel_configs["flash_attention"] == before_large
        assert engine.swap_events[64] == []
    finally:
        engine.close()


def _bucket_kernel(name="bkt"):
    """Tail-shaped toy kernel: X=8 is fastest at the full bucket but blows
    up on small arrivals; X=2 is steady across the trace (better p99)."""

    def space(shape):
        sp = SearchSpace()
        sp.add_parameter(name="X", values=(2, 8))
        return sp

    def model(shape, cfg, prof):
        n = shape["N"]
        if cfg["X"] == 8:
            return 1e-3 if n >= 512 else 50e-3
        return 2e-3

    @tunable(name=name, space=space, heuristic=lambda s: {"X": 2},
             analytical_model=model, register=False)
    def build(shape, config):
        return lambda: config["X"]

    return build


def test_background_p99_retune_over_trace_is_deterministic(tmp_path):
    winners = []
    for i in range(2):
        cache = TuningCache(str(tmp_path / f"c{i}.json"))
        k = _bucket_kernel()
        tuner = BackgroundTuner(cache=cache, profile=H100_SXM,
                                config=OnlineTuneConfig(
                                    strategy="full", objective="p99_time",
                                    evaluator_factory=trace_evaluator_factory(
                                        arrivals=8, seed=3)))
        try:
            job = tuner.submit(k, {"N": 512}, provenance="heuristic")
            assert job is not None and job.objective == "p99_time"
            assert tuner.wait(timeout=30)
            assert job.status is JobStatus.DONE
            entry = cache.get(k.name, k.key_for({"N": 512}), H100_SXM.name,
                              objective="p99_time")
            assert entry is not None and entry.objective == "p99_time"
            assert entry.config == job.config
            assert job.config == {"X": 2}
            winners.append((job.config, job.best_time))
        finally:
            tuner.close()
    assert winners[0] == winners[1]


@pytest.fixture(scope="module")
def chunky_setup():
    """Smoke model with a pow2 vocab so gemm BLOCK_N tiles divide it."""
    cfg = dataclasses.replace(get_config("granite-3-2b", smoke=True),
                              vocab_size=512)
    return cfg, init_model(cfg, 0, "cpu")


def test_apply_kernel_configs_derives_head_chunk(chunky_setup):
    cfg, _ = chunky_setup
    run = RunConfig()
    assert apply_kernel_configs(cfg, run, None) is run
    derived = apply_kernel_configs(cfg, run, {"gemm": {"BLOCK_N": 128}})
    assert derived.head_chunk == 128
    assert apply_kernel_configs(cfg, run, {"gemm": {"BLOCK_N": 100}}) is run
    assert apply_kernel_configs(cfg, run, {"gemm": {"BLOCK_N": 512}}) is run
    assert apply_kernel_configs(cfg, run, {"gemm": {}}) is run
    assert apply_kernel_configs(cfg, run, {"gemm": {"BLOCK_N": "x"}}) is run
    pinned = RunConfig(head_chunk=64)
    assert apply_kernel_configs(cfg, pinned,
                                {"gemm": {"BLOCK_N": 128}}) is pinned


class _HeadProducts(TorchFunctionMode):
    """Counts the LM-head products a step issues: matmuls whose right
    operand has the model's d_model rows and a column tile of the vocab."""

    def __init__(self, d, vocab):
        super().__init__()
        self.d, self.vocab, self.widths = d, vocab, []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.matmul and len(args) == 2:
            w = args[1]
            if w.dim() == 2 and w.shape[0] == self.d \
                    and self.vocab % w.shape[1] == 0 \
                    and w.shape[1] >= 64:
                self.widths.append(int(w.shape[1]))
        return func(*args, **(kwargs or {}))


def test_config_swap_changes_lowered_computation(chunky_setup, cache):
    """Two gemm winners with different BLOCK_N give different steps —
    different derived RunConfigs, different memoised steps, V / BLOCK_N
    head products where the JAX twin saw different lowered HLO — while
    decoding the same tokens."""
    cfg, params = chunky_setup
    tokens = torch.zeros((2, 1), dtype=torch.int32)

    def run_step(kernel_configs):
        kv = init_cache(cfg, 2, 16, "cpu")
        step = make_serve_step(cfg, RunConfig(), greedy=True,
                               kernel_configs=kernel_configs)
        with _HeadProducts(cfg.d_model, cfg.vocab_size) as mode:
            out, _ = step(params, kv, tokens, 0)
        return out, mode.widths

    derived = {bn: apply_kernel_configs(cfg, RunConfig(),
                                        {"gemm": {"BLOCK_N": bn}})
               for bn in (128, 256)}
    assert derived[128] != derived[256] != RunConfig()
    out_a, widths_a = run_step({"gemm": {"BLOCK_N": 128}})
    out_b, widths_b = run_step({"gemm": {"BLOCK_N": 256}})
    out_0, widths_0 = run_step(None)
    assert widths_a == [128] * 4 and widths_b == [256] * 2
    assert widths_0 == [512]
    assert torch.equal(out_a, out_0) and torch.equal(out_b, out_0)
    assert out_0.dtype == torch.int32 and out_0.shape == (2,)

    engine = ServeEngine(cfg, params, slots=2, max_len=16,
                         cache=cache, online_tune=False)
    steps = [engine._step_for({"gemm": {"BLOCK_N": bn}})
             for bn in (128, 256, 128)]
    assert steps[0] is not steps[1] and steps[0] is steps[2]
    assert set(engine._steps) >= set(derived.values())


def test_serve_engine_hot_swap_changes_jitted_step(chunky_setup, cache):
    """A cache write with a different BLOCK_N re-derives the engine's step
    at the swap boundary; one that folds to the same RunConfig reuses the
    memoised step.  (The H100 heuristic at (2, 512, 128) already has
    BLOCK_N 128, where the JAX twin's TPU one has none that divides.)"""
    cfg, params = chunky_setup
    _seed_exact(cfg, cache, 2, 16)
    engine = ServeEngine(cfg, params, slots=2, max_len=16, cache=cache,
                         online_tune=OnlineTuneConfig(strategy="full",
                                                      budget=2))
    try:
        res = engine.kernel_resolutions["gemm"]
        assert res.config["BLOCK_N"] == 128
        base_cfg = dict(res.config)
        base_cfg.pop("BLOCK_N", None)
        step_before = engine._step
        cache.record(res.kernel, res.key, res.profile,
                     dict(base_cfg, BLOCK_N=256), 0.5, "full", 1,
                     shape=res.shape)
        engine.submit(Request(rid=0, prompt=[1, 2], max_new_tokens=2))
        engine.run()
        step_256 = engine._step
        assert step_256 is not step_before          # swap re-derived the step
        cache.record(res.kernel, res.key, res.profile,
                     dict(base_cfg, BLOCK_N=64), 0.25, "full", 1,
                     shape=res.shape)
        engine.submit(Request(rid=1, prompt=[1, 2], max_new_tokens=2))
        engine.run()
        assert engine._step is not step_256
        cache.record(res.kernel, res.key, res.profile,
                     dict(base_cfg, BLOCK_N=256, INNER_STEPS=9), 0.1,
                     "full", 1, shape=res.shape)
        engine.submit(Request(rid=2, prompt=[1, 2], max_new_tokens=2))
        engine.run()
        assert engine._step is step_256             # memoised step reused
        assert [ev["sources"] for ev in engine.swap_events] == \
            [{"gemm": "tuned"}] * 3
    finally:
        engine.close()


# -- the port against the JAX package ---------------------------------------------

def _requests(make, vocab):
    rng = np.random.default_rng(11)
    return [make(rid=i,
                 prompt=rng.integers(1, vocab, int(rng.integers(3, 7)))
                 .tolist(), max_new_tokens=int(rng.integers(3, 9)))
            for i in range(5)]


@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-130m", "zamba2-7b",
                                  "deepseek-v3-671b"])
def test_engine_outputs_equal_the_jax_engine(tmp_path, arch):
    """The same float32 weights, 5 requests over 2 slots: refill, the
    global decode position (a request placed mid-run attends to what the
    slot's previous occupant wrote, and inherits its SSM state) and
    max_steps truncation and resume all give the JAX engine's greedy
    tokens, for a dense, an SSM, a hybrid and an MoE/MLA model."""
    ref_cfg = dataclasses.replace(
        ref_configs.get_config(arch, smoke=True), param_dtype="float32")
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              param_dtype="float32")
    ref_p = ref_models.init_model(ref_cfg, jax.random.PRNGKey(5))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_p),
                               "cpu")
    ref_eng = ref_serve.ServeEngine(
        ref_cfg, ref_p, slots=2, max_len=32,
        cache=ref_core.TuningCache(str(tmp_path / "ref.json")))
    eng = ServeEngine(cfg, params, slots=2, max_len=32,
                      cache=TuningCache(str(tmp_path / "port.json")))
    for r in _requests(ref_serve.Request, cfg.vocab_size):
        ref_eng.submit(r)
    for r in _requests(Request, cfg.vocab_size):
        eng.submit(r)

    def view(reqs):
        return [(r.rid, list(r.output), r.done) for r in reqs]

    ref_cut, cut = ref_eng.run(max_steps=9), eng.run(max_steps=9)
    assert view(cut) == view(ref_cut)
    assert any(not r.done for r in cut)
    ref_rest, rest = ref_eng.run(), eng.run()
    assert view(rest) == view(ref_rest)
    assert all(r.done for r in rest)
    assert eng.steps_total == ref_eng.steps_total
    # past max_len the write index clamps and serving goes on, as in JAX
    for e, make in ((ref_eng, ref_serve.Request), (eng, Request)):
        e.submit(make(rid=9, prompt=[1, 2, 3], max_new_tokens=4))
    assert view(eng.run()) == view(ref_eng.run())
    assert eng._pos > eng.max_len


def test_full_width_resolutions_match_the_jax_keys(tmp_path):
    """granite-3-2b full at 4 slots x 256 positions resolves flash and the
    LM-head gemm under the JAX package's cache keys; the configs are the
    port's own lookups (its spaces were re-derived for the H100)."""
    cfg = get_config("granite-3-2b")
    ours = resolve_kernel_resolutions(
        cfg, 4, 256, profile=H100_SXM,
        cache=TuningCache(str(tmp_path / "port.json")))
    theirs = ref_serve.resolve_kernel_resolutions(
        ref_configs.get_config("granite-3-2b"), 4, 256,
        cache=ref_core.TuningCache(str(tmp_path / "ref.json")))
    assert {n: r.key for n, r in ours.items()} == \
        {n: r.key for n, r in theirs.items()} == {
            "flash_attention": "Sq256_Sk256_D64_c",
            "gemm": "M4_N49155_K2048_float32"}
    cache = TuningCache(str(tmp_path / "own.json"))
    for name, res in ours.items():
        own = lookup_resolved(name, res.shape, profile=H100_SXM, cache=cache,
                              policy="transfer")
        assert (res.config, res.provenance) == (own.config, own.provenance)
        assert res.profile == H100_SXM.name
    assert resolve_kernel_configs(
        cfg, 4, 256, profile=H100_SXM,
        cache=TuningCache(str(tmp_path / "port.json"))) == \
        {n: r.config for n, r in ours.items()}
    # no BLOCK_N divides 49155: the head stays one product
    assert apply_kernel_configs(cfg, RunConfig(), {
        n: r.config for n, r in ours.items()}) == RunConfig()


def test_infeasible_gemm_retune_fails_like_the_jax_one(tmp_path):
    """The decode gemm (4, 49155, 2048) has no feasible point in either
    package's space: the background job ends FAILED, records nothing, and
    the served config stays."""
    cfg = get_config("granite-3-2b")
    cache = TuningCache(str(tmp_path / "port.json"))
    res = resolve_kernel_resolutions(cfg, 4, 256, profile=H100_SXM,
                                     cache=cache)["gemm"]
    ref_cache = ref_core.TuningCache(str(tmp_path / "ref.json"))
    ref_res = ref_serve.resolve_kernel_resolutions(
        ref_configs.get_config("granite-3-2b"), 4, 256,
        cache=ref_cache)["gemm"]
    jobs = []
    for tuner_cls, c, r, kw in (
            (BackgroundTuner, cache, res, {"profile": H100_SXM}),
            (ref_serve.BackgroundTuner, ref_cache, ref_res, {})):
        knobs = (OnlineTuneConfig if tuner_cls is BackgroundTuner
                 else ref_serve.OnlineTuneConfig)(budget=4)
        tuner = tuner_cls(cache=c, config=knobs, **kw)
        try:
            job = tuner.submit(r.kernel, r.shape, provenance=r.provenance)
            assert tuner.wait(timeout=60)
        finally:
            tuner.close()
        assert c.get(r.kernel, r.key, r.profile) is None
        jobs.append((job.status.value, job.error))
    assert jobs[0] == jobs[1] == (
        "failed", "ValueError: search space has no feasible configuration")


def test_prefill_step_is_the_forward(setup):
    cfg, params = setup
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32))
    logits = make_prefill_step(cfg)(params, {"tokens": toks})
    assert torch.equal(logits, forward(cfg, params, {"tokens": toks})[0])


def test_launcher_serves_on_the_cpu(capsys):
    done = launcher.main(["--device", "cpu", "--requests", "3",
                          "--max-new-tokens", "4", "--max-len", "64"])
    out = capsys.readouterr().out
    assert re.search(r"^served 3 requests, 12 tokens in [\d.]+s "
                     r"\([\d.]+ tok/s\)$", out, re.M), out
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(r.done and len(r.output) == 4 for r in done)
    reqs = launcher.make_requests(get_config("granite-3-2b", smoke=True),
                                  3, 4, seed=0)
    assert [r.prompt for r in sorted(done, key=lambda r: r.rid)] == \
        [r.prompt for r in reqs]
