"""The port's GEMM (plain version, on the CPU) against the JAX package's
Pallas GEMM in interpret mode, on the same inputs.

Tolerances are the JAX package's own GEMM tests' (2e-4 for float32 and
3e-2 for bfloat16 results).  The CUDA kernel itself runs only on the card
(see ``chip_smoke.py``); here its wrapper is checked for what it accepts.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.matmul import make_matmul as ref_make_matmul  # noqa: E402
from repro.kernels.matmul import validate_config as ref_validate  # noqa: E402
from repro_torch.core import H100_SXM, SearchSpace, Parameter  # noqa: E402
from repro_torch.kernels.matmul import (  # noqa: E402
    DEFAULT_CONFIG, analytical_time, gemm_plain, heuristic_config,
    make_matmul, smem_footprint, tuning_space, validate_config)
from repro_torch.kernels.matmul.matmul import tile  # noqa: E402
from test_kernels_matmul import CONFIGS  # noqa: E402


def _inputs(M, N, K, dtype="float32", seed=0, trans_a=False):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(K, M) if trans_a else (M, K)).astype(np.float32)
    b = rng.normal(size=(K, N)).astype(np.float32)
    ref = (jnp.asarray(a, dtype), jnp.asarray(b, dtype))
    tdt = getattr(torch, dtype)
    port = (torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt))
    return ref, port


def _compare(M, N, K, cfg, dtype="float32", tol=2e-4, trans_a=False):
    (ra, rb), (pa, pb) = _inputs(M, N, K, dtype, trans_a=trans_a)
    want = ref_make_matmul(M, N, K, cfg, out_dtype=jnp.dtype(dtype),
                           interpret=True)(ra, rb)
    got = make_matmul(M, N, K, cfg, out_dtype=getattr(torch, dtype))(pa, pb)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("cfg", CONFIGS)
def test_plain_matches_pallas_interpret(cfg):
    _compare(256, 256, 256, cfg)


def test_trans_a():
    _compare(256, 128, 128, {"BLOCK_M": 128, "BLOCK_N": 128,
                             "BLOCK_K": 128, "TRANS_A": True}, trans_a=True)


def test_rectangular():
    _compare(384, 256, 512, {"BLOCK_M": 128, "BLOCK_N": 128, "BLOCK_K": 256})


def test_bf16_inputs():
    _compare(256, 256, 256, {"BLOCK_M": 128, "BLOCK_N": 128, "BLOCK_K": 128},
             dtype="bfloat16", tol=3e-2)


@pytest.mark.parametrize("inner", [1, 2, 4])
def test_bf16_accumulator_rounds_where_the_tpu_kernel_does(inner):
    cfg = {"BLOCK_M": 128, "BLOCK_N": 128, "BLOCK_K": 128,
           "INNER_STEPS": inner, "ACC_DTYPE": "bfloat16"}
    _compare(256, 256, 256, cfg, tol=3e-2)
    # the rounding is real: a float32 sum is far closer to the exact product
    (_, _), (pa, pb) = _inputs(256, 256, 256)
    exact = pa.double() @ pb.double()
    err_bf16 = (gemm_plain(pa, pb, cfg).double() - exact).abs().max()
    err_f32 = (gemm_plain(pa, pb, {**cfg, "ACC_DTYPE": "float32"}).double()
               - exact).abs().max()
    assert err_bf16 > 100 * err_f32


@pytest.mark.parametrize("cfg", [
    {"BLOCK_M": 100, "BLOCK_N": 128, "BLOCK_K": 128},
    {"BLOCK_M": 128, "BLOCK_N": 128, "BLOCK_K": 128, "INNER_STEPS": 3},
    {"BLOCK_M": 128, "BLOCK_N": 128, "BLOCK_K": 128,
     "ACC_IN_OUTPUT": True, "ACC_DTYPE": "bfloat16"},
])
def test_validate_rejects_what_the_reference_rejects(cfg):
    full_ref = {**{"BLOCK_M": 512, "BLOCK_N": 512, "BLOCK_K": 512,
                   "GRID_ORDER": "mn", "INNER_STEPS": 1,
                   "ACC_DTYPE": "float32", "ACC_IN_OUTPUT": False,
                   "TRANS_A": False}, **cfg}
    with pytest.raises(ValueError):
        ref_validate(full_ref, 256, 256, 256)
    with pytest.raises(ValueError):
        validate_config({**DEFAULT_CONFIG, **cfg}, 256, 256, 256)
    with pytest.raises(ValueError):
        make_matmul(256, 256, 256, cfg)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    # more threads than a block may have
    with pytest.raises(ValueError):
        make_matmul(512, 512, 64, {"BLOCK_M": 512, "BLOCK_N": 512,
                                   "BLOCK_K": 64})
    # in-place accumulation into a bfloat16 output (the JAX kernel fails too)
    with pytest.raises(ValueError):
        make_matmul(256, 256, 256, {"ACC_IN_OUTPUT": True},
                    out_dtype=torch.bfloat16)
    fn = make_matmul(256, 256, 256, {"BLOCK_M": 128, "BLOCK_N": 128})
    a = torch.zeros(256, 256)
    with pytest.raises(ValueError):          # wrong shape
        fn(a, torch.zeros(128, 256))
    with pytest.raises(ValueError):          # wrong dtype
        fn(a.bfloat16(), a.bfloat16())
    with pytest.raises(ValueError):          # no kernel for this device
        fn(a.to("meta"), a.to("meta"))


def test_smem_footprint_and_model_show_the_cliff():
    small = {"BLOCK_M": 128, "BLOCK_N": 128, "BLOCK_K": 32}
    huge = {"BLOCK_M": 256, "BLOCK_N": 256, "BLOCK_K": 128}
    # two stages (the default PIPELINE_DEPTH) of unpadded A and B slices
    assert smem_footprint(small) == 2 * 4 * 32 * (128 + 128)
    assert smem_footprint({**small, "PIPELINE_DEPTH": 3}) == \
        3 * 4 * 32 * (128 + 128)
    assert smem_footprint(small, elt_bytes=2) == 2 * 2 * 32 * (128 + 128)
    assert smem_footprint(small) <= H100_SXM.smem_per_block_optin
    assert smem_footprint(huge) > H100_SXM.smem_per_block_optin
    assert math.isfinite(analytical_time(small, H100_SXM, 2048, 2048, 2048))
    assert math.isinf(analytical_time(huge, H100_SXM, 2048, 2048, 2048))
    # exactly at the budget still fits
    at = {"BLOCK_M": 128, "BLOCK_N": 128, "BLOCK_K": 32}
    tight = dataclasses.replace(H100_SXM,
                                smem_per_block_optin=smem_footprint(at))
    assert math.isfinite(analytical_time(at, tight, 2048, 2048, 2048))
    assert math.isinf(analytical_time({**at, "BLOCK_K": 64}, tight,
                                      2048, 2048, 2048))


def test_model_is_bounded_by_the_f32_roofline():
    t = analytical_time({"BLOCK_M": 128, "BLOCK_N": 128, "BLOCK_K": 32},
                        H100_SXM, 2048, 2048, 2048)
    assert t >= 2 * 2048 ** 3 / H100_SXM.peak_f32_flops
    # smaller tiles stream more bytes
    t_small = analytical_time({"BLOCK_M": 32, "BLOCK_N": 32, "BLOCK_K": 32},
                              H100_SXM, 2048, 2048, 2048)
    assert t_small > t


def test_model_is_bounded_by_the_bf16_roofline():
    # bfloat16 operands run on the tensor cores: the model prices them at
    # the card's bfloat16 rate, far under the float32 FMA time
    cfg = {"BLOCK_M": 128, "BLOCK_N": 128, "BLOCK_K": 32}
    t = analytical_time(cfg, H100_SXM, 2048, 2048, 2048, elt_bytes=2)
    assert t >= 2 * 2048 ** 3 / H100_SXM.peak_bf16_tensor_flops
    assert t < 2 * 2048 ** 3 / H100_SXM.peak_f32_flops
    assert t < analytical_time(cfg, H100_SXM, 2048, 2048, 2048)


def test_extended_space_exceeds_paper_scale():
    params, _ = tuning_space(extended=True)
    sp = SearchSpace()
    for n, v in params.items():
        sp.add_parameter(Parameter(n, tuple(v)))
    assert sp.cardinality() > 200_000          # paper: 241,600


def test_compact_space_fits_the_card():
    params, constraints = tuning_space()
    sp = SearchSpace()
    for n, v in params.items():
        sp.add_parameter(Parameter(n, tuple(v)))
    for fn, names, label in constraints:
        sp.add_constraint(fn, names, label)
    configs = sp.enumerate()
    assert configs and {c["ACC_IN_OUTPUT"] for c in configs} == {False, True}
    for c in configs:
        assert smem_footprint(c) <= H100_SXM.smem_per_block_optin
        validate_config(c, 2048, 2048, 2048)


def test_heuristic_config_divides_and_is_in_the_lists():
    cfg = heuristic_config(768, 1536, 384)
    params, _ = tuning_space()
    for name in ("BLOCK_M", "BLOCK_N", "BLOCK_K"):
        assert cfg[name] in params[name]
    assert 768 % cfg["BLOCK_M"] == 0
    assert 1536 % cfg["BLOCK_N"] == 0
    assert 384 % cfg["BLOCK_K"] == 0
    assert heuristic_config(2048, 2048, 2048)["BLOCK_K"] == 64



def test_pipeline_depth_is_the_number_of_shared_memory_stages():
    from repro_torch.kernels.matmul.matmul import _defines
    cfg = {"BLOCK_M": 128, "BLOCK_N": 128, "BLOCK_K": 64}
    # the compact space has no PIPELINE_DEPTH: the JAX default of 2 builds
    assert _defines({**DEFAULT_CONFIG, **cfg},
                    torch.float32)["PIPELINE_DEPTH"] == 2
    assert _defines({**DEFAULT_CONFIG, **cfg, "PIPELINE_DEPTH": 4},
                    torch.float32)["PIPELINE_DEPTH"] == 4
    assert smem_footprint(cfg) == 131_072 <= H100_SXM.smem_per_block_optin
    params, constraints = tuning_space(extended=True)
    names = [n for _, n, _ in constraints]
    assert ("BLOCK_M", "BLOCK_N", "BLOCK_K", "PIPELINE_DEPTH") in names
    fits = dict((n, fn) for fn, n, _ in constraints)[
        ("BLOCK_M", "BLOCK_N", "BLOCK_K", "PIPELINE_DEPTH")]
    assert fits(128, 128, 64, 2) and not fits(128, 128, 64, 4)
    _, compact = tuning_space()
    assert all("PIPELINE_DEPTH" not in n for _, n, _ in compact)


@pytest.mark.parametrize("cfg", [
    {"BLOCK_M": 128, "BLOCK_N": 128, "BLOCK_K": 64, "PIPELINE_DEPTH": 1},
    {"BLOCK_M": 128, "BLOCK_N": 128, "BLOCK_K": 4, "PIPELINE_DEPTH": 1},
])
def test_validate_rejects_what_the_ring_cannot_take(cfg):
    with pytest.raises(ValueError):
        make_matmul(256, 256, 256, cfg)
    # a ring of two stages takes the block in both builds, BLOCK_K 4 too
    # (no whole 16-byte chunks: the build copies element by element, and
    # in bfloat16 pads the depth to the mma's 8), and computes the JAX
    # kernel's product
    ring = {**cfg, "PIPELINE_DEPTH": 2}
    bk = cfg["BLOCK_K"]
    for dtype, depth in ((torch.float32, bk), (torch.bfloat16, max(bk, 8))):
        fn = make_matmul(256, 256, 256, ring, out_dtype=dtype)
        assert tile(fn.config, dtype.itemsize)[2] == depth
    _compare(256, 256, 256, ring)
