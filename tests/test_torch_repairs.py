"""The port's repairs against the JAX package, on the CPU.

- conv2d takes bfloat16 operands, as the JAX package's kernel does: the
  plain version against the JAX Pallas conv in interpret mode at bfloat16
  (64 x 128 image, 3 x 3, 7 x 7 and 11 x 11 filters, the bf16 tolerance
  3e-2), and a build per input type (``IN_BF16``).
- A wall-clock sample on CUDA times k back-to-back launches after an
  untimed one, k chosen from the warm-up launch, under an exclusive lock
  on the card (the card is simulated here: events on a clock that only
  launches advance, so the times are exact; no device).
- The cost model's stored prices move with the declared cost and the
  kernel's source: a changed ``traffic`` misses the store.
- One element width, from the shape's ``dtype``, reaches the arguments,
  the build, the footprint, the model and the cost of GEMM, conv2d and
  flash attention; a bfloat16 search proves, prices and builds bfloat16
  (GEMM configs the build refuses at bfloat16 become CompileError trials).
- ``repro_torch.tune`` re-exports ``tune_matmul``, ``tune_conv2d`` and
  ``tune_flash_attention`` lazily, and ``CostModelEvaluator.analyze``
  folds a refused config into a failed measurement, as in the JAX package.
"""

import dataclasses
import fcntl
import importlib
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.kernels.conv2d as ref_conv  # noqa: E402
from repro.kernels.attention import ops as ref_flash_ops  # noqa: E402
from repro.kernels.conv2d import ops as ref_conv_ops  # noqa: E402
from repro.kernels.matmul import ops as ref_gemm_ops  # noqa: E402
from repro_torch.core import (H100_SXM, ArtifactStore,  # noqa: E402
                              CostModelEvaluator, KernelSpec, Tuner,
                              WallClockEvaluator)
from repro_torch.core import evaluators as ev_mod  # noqa: E402
from repro_torch.kernels import attention as fa  # noqa: E402
from repro_torch.kernels import conv2d as cv  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402
from repro_torch.kernels.matmul import ops as gemm_ops  # noqa: E402
from repro_torch.tune import tune_kernel  # noqa: E402

cv_kernel = importlib.import_module("repro_torch.kernels.conv2d.conv2d")

BF16_TOL = 3e-2


# -- conv2d in bfloat16 ---------------------------------------------------------

@pytest.mark.parametrize("filt", [(3, 3), (7, 7), (11, 11)])
@pytest.mark.parametrize("cfg", [
    {"BLOCK_H": 16, "BLOCK_W": 128, "SUB_H": 1, "UNROLL": True,
     "HALO_MODE": "materialize"},
    {"BLOCK_H": 32, "BLOCK_W": 128, "SUB_H": 2, "UNROLL": False,
     "HALO_MODE": "materialize"}])
def test_conv_bf16_plain_matches_pallas_interpret(cfg, filt):
    fh, fw = filt
    rng = np.random.default_rng(16)
    img = rng.normal(size=(64, 128)).astype(np.float32)
    flt = rng.normal(size=(fh, fw)).astype(np.float32)
    want = ref_conv.make_conv2d(64, 128, fh, fw, cfg, interpret=True)(
        jnp.asarray(img, jnp.bfloat16), jnp.asarray(flt, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    got = cv.make_conv2d(64, 128, fh, fw, cfg, dtype=torch.bfloat16)(
        torch.from_numpy(img).bfloat16(), torch.from_numpy(flt).bfloat16())
    assert got.dtype == torch.bfloat16 and got.shape == (64, 128)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)
    # and against the float32 oracle of the same (rounded) inputs
    oracle = cv.conv2d_reference(torch.from_numpy(img).bfloat16().float(),
                                 torch.from_numpy(flt).bfloat16().float())
    np.testing.assert_allclose(got.float().numpy(), oracle.numpy(),
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_conv_takes_one_type_of_float32_or_bf16():
    fn = cv.make_conv2d(32, 64, 3, 3)
    x32, f32 = torch.ones(32, 64), torch.ones(3, 3)
    assert fn(x32, f32).dtype == torch.float32
    bf = cv.make_conv2d(32, 64, 3, 3, dtype=torch.bfloat16)
    assert bf(x32.bfloat16(), f32.bfloat16()).dtype == torch.bfloat16
    # each object takes the one type it was made (and built) for
    with pytest.raises(ValueError, match="built for torch.float32"):
        fn(x32.bfloat16(), f32.bfloat16())
    with pytest.raises(ValueError, match="built for torch.bfloat16"):
        bf(x32, f32)
    with pytest.raises(ValueError, match="built for"):
        bf(x32.bfloat16(), f32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cv.make_conv2d(32, 64, 3, 3, dtype=torch.float16)


def test_conv_builds_one_library_per_input_type():
    bf16 = dict(cv.make_conv2d(32, 64, 3, 3, dtype=torch.bfloat16).defines())
    f32 = dict(cv.make_conv2d(32, 64, 3, 3).defines())
    assert bf16["IN_BF16"] == 1 and f32["IN_BF16"] == 0
    assert {k: v for k, v in bf16.items() if k != "IN_BF16"} == \
        {k: v for k, v in f32.items() if k != "IN_BF16"}
    assert cv.make_conv2d(32, 64, 3, 3).address is None   # nothing built


# -- wall-clock samples time the card ------------------------------------------

class _Clock:
    """The simulated card's clock: integer nanoseconds that only a launch
    advances, so the times the evaluator reads are exact whatever the
    host's load."""

    def __init__(self):
        self.ns = 0


class _HostEvent:
    """A CUDA event stand-in that records the simulated card's clock."""

    def __init__(self, clock, enable_timing=False):
        self.clock = clock
        self.ns = None

    def record(self, stream=None):
        self.ns = self.clock.ns

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.ns - self.ns) / 1e6


@pytest.fixture
def clock():
    return _Clock()


@pytest.fixture
def host_card(monkeypatch, tmp_path, clock):
    """A simulated card: CUDA events on ``clock``, the measurement lock
    under tmp_path."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda enable_timing=False: _HostEvent(clock))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(ev_mod, "LOCK_DIR", str(tmp_path / "locks"))
    return tmp_path


def _launch_spec(calls, launch_s, clock, lock_path=None, held=None):
    """A kernel whose every launch takes exactly ``launch_s`` on ``clock``."""
    def launch():
        calls.append(1)
        if lock_path is not None:
            fd = os.open(lock_path, os.O_RDWR)
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                held.append(False)
                fcntl.flock(fd, fcntl.LOCK_UN)
            except BlockingIOError:
                held.append(True)
            finally:
                os.close(fd)
        clock.ns += round(launch_s * 1e9)
        return torch.zeros(1)

    return KernelSpec(name="probe", build=lambda cfg: launch,
                      make_args=lambda rng: ())


def test_cuda_samples_time_back_to_back_launches(host_card, clock):
    calls = []
    ev = WallClockEvaluator(repeats=3, verify_outputs=False, device="cuda")
    spec = _launch_spec(calls, 2e-4, clock)
    m = ev.measure(spec, {}, ev.prepare(spec, {}))
    k = int(m.detail["launches_per_sample"])
    # four back-to-back launches of 2e-4 s pick k so that k launches span
    # the 1 ms window
    assert k == math.ceil(ev.WINDOW_S / 2e-4) == 5
    # first launch + (one untimed + four timed) to pick k + (one untimed +
    # k timed) a sample
    assert len(calls) == 1 + (1 + ev.PROBE_LAUNCHES) + 3 * (k + 1)
    # a sample is one launch's time, not the window's
    assert m.time_s == 2e-4
    assert m.metrics.samples == (2e-4,) * 3


def test_cuda_launches_per_sample_bounds(host_card, clock):
    calls = []
    ev = WallClockEvaluator(repeats=2, verify_outputs=False, device="cuda")
    slow = _launch_spec(calls, 3e-3, clock)
    assert ev.measure(slow, {}).detail["launches_per_sample"] == 1
    ev.WINDOW_S = 10.0                       # no launch fills this window
    fast = _launch_spec(calls, 0.0, clock)
    assert (ev.measure(fast, {}).detail["launches_per_sample"]
            == ev.MAX_LAUNCHES)


def test_cuda_measurement_holds_the_cards_lock(host_card, clock):
    calls, held = [], []
    ev = WallClockEvaluator(repeats=2, verify_outputs=False, device="cuda")
    path = ev.lock_path()
    assert path == os.path.join(str(host_card / "locks"), "cuda0.lock")
    spec = _launch_spec(calls, 1e-4, clock, lock_path=path, held=held)
    prepared = ev.prepare(spec, {})          # the build takes no lock
    assert not os.path.exists(path)
    ev.measure(spec, {}, prepared)
    assert held and all(held)                # every launch under the lock
    fd = os.open(path, os.O_RDWR)            # and released after it
    try:
        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
    finally:
        os.close(fd)


def test_cpu_samples_stay_one_call_each():
    calls = []
    ev = WallClockEvaluator(repeats=4, verify_outputs=False, device="cpu")
    spec = _launch_spec(calls, 0.0, _Clock())
    m = ev.measure(spec, {})
    assert len(calls) == 1 + 4 and "launches_per_sample" not in m.detail


# -- cost-model prices keyed by the kernel's source -------------------------------

SHAPE = {"M": 256, "N": 256, "K": 256}


def _priced(store, kernel=mm.GEMM):
    tuner = Tuner.from_tunable(kernel, SHAPE, profile=H100_SXM,
                               evaluator=CostModelEvaluator(H100_SXM),
                               artifact_store=store)
    cfg = mm.heuristic_config(256, 256, 256)
    return tuner.evaluator.prepare(tuner._spec, cfg)


def test_a_changed_traffic_misses_the_store(tmp_path, monkeypatch):
    store = ArtifactStore(str(tmp_path / "store"))
    assert _priced(store).provenance == "fresh"
    assert _priced(store).provenance == "store"
    real = gemm_ops.traffic

    def traffic(cfg, M, N, K, elt_bytes=4):   # counts C twice
        cost = real(cfg, M, N, K, elt_bytes)
        return dataclasses.replace(cost, bytes=cost.bytes + M * N * elt_bytes)

    monkeypatch.setattr(gemm_ops, "traffic", traffic)
    changed = _priced(store)
    assert changed.provenance == "fresh"
    assert changed.payload["bytes"] > _priced_payload_bytes(real)
    monkeypatch.setattr(gemm_ops, "traffic", real)
    assert _priced(store).provenance == "store"


def _priced_payload_bytes(traffic):
    return traffic(mm.heuristic_config(256, 256, 256), 256, 256, 256).bytes


def test_a_changed_kernel_source_misses_the_store(tmp_path):
    cu = tmp_path / "gemm.cu"
    cu.write_text(open(mm.GEMM.sources[0]).read())
    gemm = dataclasses.replace(mm.GEMM, sources=(str(cu),))
    store = ArtifactStore(str(tmp_path / "store"))
    assert _priced(store, gemm).provenance == "fresh"
    assert _priced(store, gemm).provenance == "store"
    cu.write_text(cu.read_text() + "\n// an edit\n")
    assert _priced(store, gemm).provenance == "fresh"


def test_costmodel_analyze_folds_refusals():
    tuner = Tuner.from_tunable(mm.GEMM, SHAPE, profile=H100_SXM,
                               evaluator=CostModelEvaluator(H100_SXM))
    ev, spec = tuner.evaluator, tuner._spec
    cfg = mm.heuristic_config(256, 256, 256)
    assert ev.analyze(spec, cfg).time_s == ev.measure(spec, cfg).time_s
    bad = dict(cfg, BLOCK_M=100)              # the declaration refuses it
    m = ev.analyze(spec, bad)
    assert not m.ok and m.time_s == math.inf


# -- one width end to end ------------------------------------------------------

def test_elt_bytes_match_the_jax_package():
    for dtype, width in (("float32", 4), ("bfloat16", 2)):
        for ref_ops, port_ops in ((ref_gemm_ops, gemm_ops),
                                  (ref_conv_ops, cv.ops),
                                  (ref_flash_ops, fa.ops)):
            shape = {"dtype": dtype}
            assert ref_ops._elt_bytes(shape) == width
            assert port_ops._elt_bytes(shape) == width
    # the keys stay the JAX package's: GEMM's has the dtype; conv's and
    # flash's float32 keys have none, and a bfloat16 shape, whose build is
    # the tensor cores', appends it
    assert gemm_ops.shape_key(64, 64, 64, "bfloat16") == \
        ref_gemm_ops.shape_key(64, 64, 64, "bfloat16")
    conv = {"H": 64, "W": 128, "Fh": 3, "Fw": 3}
    assert cv.CONV2D.key_for(conv) == \
        cv.CONV2D.key_for(dict(conv, dtype="float32")) == \
        ref_conv_ops.shape_key(64, 128, 3, 3) == "H64_W128_F3x3"
    assert cv.CONV2D.key_for(dict(conv, dtype="bfloat16")) == \
        "H64_W128_F3x3_bfloat16"
    flash = {"Sq": 64, "Sk": 64, "D": 64, "causal": True}
    assert fa.FLASH_ATTENTION.key_for(dict(flash, dtype="float32")) == \
        ref_flash_ops.shape_key(64, 64, 64, True) == "Sq64_Sk64_D64_c"
    assert fa.FLASH_ATTENTION.key_for(dict(flash, dtype="bfloat16")) == \
        "Sq64_Sk64_D64_c_bfloat16"


GEMM_BF16 = {"M": 64, "N": 64, "K": 64, "dtype": "bfloat16"}
CONV_BF16 = {"H": 32, "W": 64, "Fh": 3, "Fw": 3, "dtype": "bfloat16"}
FLASH_BF16 = {"Sq": 64, "Sk": 64, "D": 64, "causal": True,
              "dtype": "bfloat16"}


def test_gemm_declaration_has_one_width():
    cfg = mm.heuristic_config(64, 64, 64)
    args = mm.GEMM.make_args(GEMM_BF16, np.random.default_rng(0))
    assert all(a.dtype == torch.bfloat16 for a in args)
    fn = mm.GEMM.build(GEMM_BF16, cfg)
    assert fn.dtype == torch.bfloat16
    assert mm.GEMM.smem_footprint(GEMM_BF16, cfg) == \
        mm.smem_footprint(cfg, 2)
    assert mm.GEMM.analytical_model(GEMM_BF16, cfg, H100_SXM) == \
        mm.analytical_time(cfg, H100_SXM, 64, 64, 64, elt_bytes=2)
    f32 = dict(GEMM_BF16, dtype="float32")
    assert 2 * mm.GEMM.cost(GEMM_BF16, cfg).bytes == \
        mm.GEMM.cost(f32, cfg).bytes
    assert 2 * mm.GEMM.smem_footprint(GEMM_BF16, cfg) == \
        mm.GEMM.smem_footprint(f32, cfg)


def test_gemm_proof_and_model_agree_at_bf16():
    """The proof (the footprint against the profile) and the model's cliff
    reject the same configs at bfloat16, on a card with little shared
    memory: among configs the model takes on the H100, exactly those the
    proof rejects become infinite."""
    import random
    card = dataclasses.replace(H100_SXM, smem_per_block_optin=24_576)
    shape = {"M": 512, "N": 512, "K": 512, "dtype": "bfloat16"}
    space = mm.GEMM.make_space(shape, extended=True)
    rejected = kept = 0
    for cfg in space.sample_unique(random.Random(0), 400):
        if not math.isfinite(mm.GEMM.analytical_model(shape, cfg, H100_SXM)):
            continue
        fits = card.fits_smem(mm.GEMM.smem_footprint(shape, cfg))
        t = mm.GEMM.analytical_model(shape, cfg, card)
        assert math.isfinite(t) == fits, cfg
        rejected += not fits
        kept += fits
    assert rejected and kept                  # the cliff was crossed


def test_conv_and_flash_declarations_have_one_width():
    cfg = cv.heuristic_config(32, 64, 3, 3)
    args = cv.CONV2D.make_args(CONV_BF16, np.random.default_rng(0))
    assert all(a.dtype == torch.bfloat16 for a in args)
    fn = cv.CONV2D.build(CONV_BF16, cfg)
    assert fn.dtype == torch.bfloat16 and dict(fn.defines())["IN_BF16"] == 1
    f32 = dict(CONV_BF16, dtype="float32")
    # each input type stages its own tile: bfloat16 the tensor cores'
    assert cv.CONV2D.smem_footprint(CONV_BF16, cfg) == \
        cv.smem_footprint(cfg, 3, 3, 2)
    assert cv.CONV2D.smem_footprint(f32, cfg) == cv.smem_footprint(cfg, 3, 3)
    assert cv.CONV2D.analytical_model(CONV_BF16, cfg, H100_SXM) == \
        cv.analytical_time(cfg, H100_SXM, 32, 64, 3, 3, elt_bytes=2)
    assert 2 * cv.CONV2D.cost(CONV_BF16, cfg).bytes == \
        cv.CONV2D.cost(f32, cfg).bytes

    fcfg = fa.heuristic_config(64, 64, 64)
    args = fa.FLASH_ATTENTION.make_args(FLASH_BF16, np.random.default_rng(0))
    assert all(a.dtype == torch.bfloat16 for a in args)
    assert fa.FLASH_ATTENTION.build(FLASH_BF16, fcfg).dtype == torch.bfloat16
    assert fa.FLASH_ATTENTION.smem_footprint(FLASH_BF16, fcfg) == \
        fa.smem_footprint(fcfg, 64, 2)
    assert fa.FLASH_ATTENTION.analytical_model(FLASH_BF16, fcfg, H100_SXM) \
        == fa.analytical_time(fcfg, H100_SXM, 64, 64, 64, 2, causal=True)
    f32 = dict(FLASH_BF16, dtype="float32")
    assert 2 * fa.FLASH_ATTENTION.cost(FLASH_BF16, fcfg).bytes == \
        fa.FLASH_ATTENTION.cost(f32, fcfg).bytes


def test_bf16_gemm_search_measures_bf16_builds(tmp_path):
    """A bfloat16 search times bfloat16 builds; the in-place accumulator,
    which the build refuses at bfloat16, becomes CompileError trials."""
    from repro_torch.core import TuningCache
    out = tune_kernel(mm.GEMM, GEMM_BF16, strategy="full", budget=288,
                      profile=H100_SXM, record=False, warm_start=False,
                      cache=TuningCache(str(tmp_path / "c.json")),
                      evaluator=WallClockEvaluator(repeats=1,
                                                   device="cpu"))
    trials = out.result.trials
    refused = [t for t in trials if t.config["ACC_IN_OUTPUT"]]
    assert refused and all(t.failure is not None
                           and t.failure.error_type == "CompileError"
                           for t in refused)
    timed = [t for t in trials if not t.config["ACC_IN_OUTPUT"]]
    assert timed and all(math.isfinite(t.time) for t in timed)
    assert out.best_config["ACC_IN_OUTPUT"] is False
    fn = mm.GEMM.build(GEMM_BF16, out.best_config)
    a, b = mm.GEMM.make_args(GEMM_BF16, np.random.default_rng(1))
    assert fn(a, b).dtype == torch.bfloat16


def test_bf16_conv_and_flash_searches_run_bf16():
    for kernel, shape in ((cv.CONV2D, CONV_BF16),
                          (fa.FLASH_ATTENTION, FLASH_BF16)):
        out = tune_kernel(kernel, shape, strategy="annealing", budget=3,
                          profile=H100_SXM, record=False, warm_start=False,
                          evaluator=WallClockEvaluator(repeats=1,
                                                       device="cpu"))
        assert out.best_config is not None
        assert all(m.verified for m in out.measurements.values() if m.ok)
        assert kernel.build(shape, out.best_config).dtype == torch.bfloat16


# -- surface gaps ----------------------------------------------------------------

def test_tune_reexports_resolve_lazily():
    import repro_torch.tune as tune_pkg
    from repro_torch.kernels.attention import ops as fa_ops
    from repro_torch.kernels.conv2d import ops as cv_ops
    assert tune_pkg.tune_matmul is gemm_ops.tune_matmul
    assert tune_pkg.tune_conv2d is cv_ops.tune_conv2d
    assert tune_pkg.tune_flash_attention is fa_ops.tune_flash_attention
    assert {"tune_matmul", "tune_conv2d", "tune_flash_attention",
            "tune_kernel_distributed"} <= set(tune_pkg.__all__)
    with pytest.raises(AttributeError):
        tune_pkg.tune_nothing
