"""The port's cost-model and arrival-trace evaluators (``core/cost.py``,
``core/evaluators.py``) against the JAX package's, in one process.

The arrival-trace evaluator is ported as it is: its noise is seeded from
sha256, so its samples must equal the JAX package's exactly.  The cost
model prices a declared :class:`KernelCost` where the JAX package prices
XLA's ``cost_analysis()``; the pricing itself must agree exactly on the
same payload and the same device rates, and the declared GEMM FLOPs must
equal what XLA counts for the same product.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as ref_core  # noqa: E402
from repro.core import evaluators as ref_ev  # noqa: E402
from repro.kernels.matmul.ref import gemm_reference as ref_gemm  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
from repro_torch.core import (H100_SXM, ArtifactStore,  # noqa: E402
                              CompileError, CostModelEvaluator,
                              InfeasibleConfigError, KernelCost, KernelSpec,
                              MeasureError, Tuner, TuningCache)
from repro_torch.kernels.attention import FLASH_ATTENTION  # noqa: E402
from repro_torch.kernels.conv2d import CONV2D  # noqa: E402
from repro_torch.kernels.matmul import GEMM  # noqa: E402
from repro_torch.tune import tune_kernel  # noqa: E402

#: the JAX package's profile with the H100's name and rates, so both
#: packages price against the same numbers
REF_H100 = dataclasses.replace(
    ref_core.TPU_V5E, name="h100_sxm", peak_flops=H100_SXM.peak_f32_flops,
    hbm_bw=H100_SXM.hbm_bw, launch_overhead=H100_SXM.launch_overhead)


# -- arrival trace ------------------------------------------------------------

def _trace_model(shape, cfg, profile):
    """A block model over ragged arrivals: a block that does not divide
    the arrival is infeasible there; the bucket (first) shape may be too."""
    if shape["S"] % cfg["B"]:
        return math.inf
    if cfg.get("BAD"):
        raise RuntimeError("model bug")
    return (shape["S"] / cfg["B"]) * 1e-6 + cfg["B"] * 2e-8


def _trace(seed, n=24):
    rng = np.random.default_rng(seed)
    return [{"S": 512}] + [{"S": int(s)} for s in rng.integers(1, 512, n)]


@pytest.mark.parametrize("seed,sigma,block", [
    (0, 0.03, 16), (1, 0.03, 64), (2, 0.1, 1), (3, 0.0, 32)])
def test_arrival_trace_samples_equal_the_jax_package(seed, sigma, block):
    trace = _trace(seed)
    ref = ref_ev.ArrivalTraceEvaluator(_trace_model, trace, profile=REF_H100,
                                       noise_sigma=sigma, seed=seed)
    port = port_core.ArrivalTraceEvaluator(_trace_model, trace,
                                           profile=H100_SXM,
                                           noise_sigma=sigma, seed=seed)
    spec = KernelSpec(name="trace", build=lambda cfg: None)
    r = ref.measure(None, {"B": block})
    p = port.measure(spec, {"B": block})
    assert p.metrics.samples == r.metrics.samples
    assert p.time_s == r.time_s
    assert p.detail == r.detail
    assert p.detail["padded_arrivals"] == r.detail["padded_arrivals"]


@pytest.mark.parametrize("cfg,error", [
    ({"B": 3}, InfeasibleConfigError),         # 512 % 3: the bucket shape
    ({"B": 16, "BAD": True}, MeasureError)])   # the model raises
def test_arrival_trace_errors_equal_the_jax_package(cfg, error):
    trace = _trace(0)
    ref = ref_ev.ArrivalTraceEvaluator(_trace_model, trace, profile=REF_H100)
    port = port_core.ArrivalTraceEvaluator(_trace_model, trace,
                                           profile=H100_SXM)
    ref_error = getattr(ref_core, error.__name__)
    with pytest.raises(ref_error) as r:
        ref.measure(None, cfg)
    with pytest.raises(error) as p:
        port.measure(None, cfg)
    assert str(p.value) == str(r.value)


def test_make_evaluator_knows_the_jax_packages_four_names():
    names = {"wallclock": {"device": "cpu"}, "analytical": {},
             "costmodel": {},
             "trace": {"model": _trace_model, "trace": _trace(0)}}
    for name, kw in names.items():
        ev = port_core.make_evaluator(name, profile=H100_SXM, **kw) \
            if name != "wallclock" else port_core.make_evaluator(name, **kw)
        assert ev.name == name
        with pytest.raises(KeyError, match="unknown evaluator"):
            port_core.make_evaluator("hlo")
    for name in names:                   # the JAX package's table
        ref_core.make_evaluator(name, **(
            {"model": _trace_model, "trace": _trace(0)}
            if name == "trace" else {}))


# -- cost model ---------------------------------------------------------------

GEMM_SHAPE = {"M": 256, "N": 512, "K": 128, "dtype": "float32"}
CONV_SHAPE = {"H": 64, "W": 256, "Fh": 5, "Fw": 3}
FLASH_SHAPE = {"Sq": 512, "Sk": 512, "D": 64, "causal": True}


def _configs(kernel, shape, n, seed=0):
    """``n`` feasible configs of the kernel's space, drawn from a seed."""
    import random
    space = kernel.make_space(shape)
    return space.sample_unique(random.Random(seed), n)


@pytest.mark.parametrize("kernel,shape", [
    (GEMM, GEMM_SHAPE), (CONV2D, CONV_SHAPE), (FLASH_ATTENTION, FLASH_SHAPE)],
    ids=["gemm", "conv2d", "flash"])
def test_cost_model_prices_like_the_jax_package(kernel, shape):
    t = Tuner.from_tunable(kernel, shape, profile=H100_SXM,
                           evaluator=CostModelEvaluator(profile=H100_SXM))
    ref = ref_ev.CostModelEvaluator(profile=REF_H100)
    for cfg in _configs(kernel, shape, 6):
        art = t.evaluator.prepare(t._spec, cfg)
        assert set(art.payload) == {"flops", "bytes", "collective_bytes",
                                    "compile_s"}
        assert art.payload["collective_bytes"] == 0.0
        assert art.persistable and art.kind == "costmodel"
        port = t.evaluator.measure(t._spec, cfg, art)
        # the JAX package prices a bare cost payload the same way
        want = ref.measure(None, cfg, prepared=dict(art.payload))
        assert port.time_s == want.time_s
        for key in ("flops", "bytes", "compute_t", "memory_t"):
            assert port.detail[key] == want.detail[key]
        assert port.metrics.work == want.metrics.work


def test_declared_gemm_cost_against_xla_cost_analysis():
    M, N, K = 128, 128, 64
    lowered = jax.jit(ref_gemm).lower(
        jax.ShapeDtypeStruct((M, K), jnp.float32),
        jax.ShapeDtypeStruct((K, N), jnp.float32))
    xla = lowered.compile().cost_analysis()
    xla = xla[0] if isinstance(xla, (list, tuple)) else xla
    shape = {"M": M, "N": N, "K": K, "dtype": "float32"}
    one_block = dict(GEMM.heuristic(shape), BLOCK_M=M, BLOCK_N=N)
    cost = GEMM.cost(shape, one_block)
    assert cost.flops == xla["flops"] == 2 * M * N * K
    # one block reads each operand once: XLA's count exactly
    assert cost.bytes == xla["bytes accessed"]
    # smaller blocks read A N/BLOCK_N and B M/BLOCK_M times
    tiled = GEMM.cost(shape, dict(one_block, BLOCK_M=32, BLOCK_N=64))
    assert tiled.flops == cost.flops
    assert tiled.bytes == 4 * (M * K * (N // 64) + K * N * (M // 32) + M * N)


def test_declared_costs_follow_the_block_geometry():
    # flash: causal reads about half of K and V, and half the FLOPs
    cfg = {"BLOCK_Q": 64, "BLOCK_K": 64, "PIPELINE_DEPTH": 2}
    causal = FLASH_ATTENTION.cost(FLASH_SHAPE, cfg)
    full = FLASH_ATTENTION.cost(dict(FLASH_SHAPE, causal=False), cfg)
    assert causal.flops == full.flops / 2
    S, D = FLASH_SHAPE["Sq"], FLASH_SHAPE["D"]
    assert full.bytes == 4 * (2 * S * D + 2 * (S // 64) * S * D)
    # query block i (of 8) reads keys up to its own last row: 64 * (i + 1)
    assert causal.bytes == 4 * (2 * S * D + 2 * 64 * sum(range(1, 9)) * D)
    # conv: halo tiles overlap, so small blocks read more than the image
    H, W = CONV_SHAPE["H"], CONV_SHAPE["W"]
    base = {"SUB_H": 1, "UNROLL": True, "HALO_MODE": "materialize"}
    small = CONV2D.cost(CONV_SHAPE, dict(base, BLOCK_H=8, BLOCK_W=128))
    large = CONV2D.cost(CONV_SHAPE, dict(base, BLOCK_H=32, BLOCK_W=256))
    assert small.flops == large.flops == (1 + 2 * 5 * 3) * H * W
    assert 2 * 4 * H * W < large.bytes < small.bytes
    # the halo is clipped at the borders: one block reads the image once
    whole = CONV2D.cost({"H": 32, "W": 256, "Fh": 5, "Fw": 3},
                        dict(base, BLOCK_H=32, BLOCK_W=256))
    assert whole.bytes == 4 * (2 * 32 * 256 + 15)


def test_a_config_the_declaration_refuses_is_a_compile_error_as_in_jax():
    """The JAX package's cost model raises CompileError when the build
    refuses a config; the port's does when the declared cost does."""
    def refuse(cfg):
        raise ValueError(f"dims not divisible by blocks {cfg}")

    ref_spec = ref_core.KernelSpec(
        name="refused", build=refuse,
        arg_specs=lambda: (jax.ShapeDtypeStruct((8, 8), jnp.float32),))
    with pytest.raises(ref_core.CompileError, match="ValueError"):
        ref_ev.CostModelEvaluator(profile=REF_H100).prepare(ref_spec, {"B": 3})
    ev = CostModelEvaluator(profile=H100_SXM)
    with pytest.raises(CompileError, match="ValueError"):
        ev.prepare(KernelSpec(name="refused", build=refuse, cost=refuse),
                   {"B": 3})
    with pytest.raises(CompileError, match="not divisible"):
        t = Tuner.from_tunable(GEMM, GEMM_SHAPE, profile=H100_SXM,
                               evaluator=ev)
        ev.prepare(t._spec, dict(GEMM.heuristic(GEMM_SHAPE), BLOCK_M=96))
    with pytest.raises(CompileError, match="requires spec.cost"):
        ev.prepare(KernelSpec(name="bare", build=lambda c: None), {})
    with pytest.raises(ValueError, match="finite"):
        KernelCost(flops=math.inf, bytes=1.0)


def test_cost_model_answers_a_second_search_from_the_store(tmp_path):
    def search():
        ev = CostModelEvaluator(profile=H100_SXM)
        ev.artifact_store = ArtifactStore(str(tmp_path / "store"))
        return tune_kernel(GEMM, GEMM_SHAPE, strategy="full", budget=None,
                           evaluator=ev, profile=H100_SXM, record=False,
                           warm_start=False,
                           cache=TuningCache(str(tmp_path / "c.json")))

    cold, warm = search(), search()
    assert cold.evaluator == "costmodel"
    assert cold.engine_stats["artifact_hits"] == 0
    assert warm.engine_stats["artifact_hits"] == \
        warm.engine_stats["unique_configs"] > 0
    assert [(t.config, t.time) for t in warm.result.trials] == \
        [(t.config, t.time) for t in cold.result.trials]
    # a store hit carries no build time and prices the same
    spec = Tuner.from_tunable(GEMM, GEMM_SHAPE, profile=H100_SXM)._spec
    ev = CostModelEvaluator(profile=H100_SXM)
    ev.artifact_store = ArtifactStore(str(tmp_path / "store"))
    hit = ev.prepare(spec, cold.best_config)
    assert hit.provenance == "store" and hit.compile_s == 0.0
    assert ev.measure(spec, cold.best_config, hit).time_s == cold.best_time
