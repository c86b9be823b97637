"""The GEMM's bfloat16 build, which multiplies on the tensor cores.

Its Python model (``warp_tile``, ``block_threads``, ``smem_footprint``)
must accept every config the tuning spaces admit at a bfloat16 shape; its
plain version must agree with the JAX package's Pallas GEMM in interpret
mode on the same bfloat16 inputs; its CUDA source must multiply with
``mma`` and no longer widen operands for the FMA units.  The build itself
runs only on the card (``chip_smoke.py``: ``[sweep]``, ``[build-space]``,
``[main-bf16]``).

Tolerances: 3e-2, the JAX package's bfloat16 GEMM test tolerance; with a
bfloat16 accumulator, two ulps of the sums' size beside it, and bit for bit
where a sub-dot is one product (``chip_smoke.py::plain_tolerance``).
"""

import random
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.matmul import make_matmul as ref_make_matmul  # noqa: E402
from repro_torch.core import H100_SXM, TuningCache  # noqa: E402
from repro_torch.kernels.matmul import (  # noqa: E402
    GEMM, block_threads, gemm_plain, heuristic_config, lookup_config,
    make_matmul, micro_tile, smem_footprint, warp_tile)
from repro_torch.kernels.matmul import ops  # noqa: E402
from repro_torch.kernels.matmul.matmul import (SOURCE, _defines,  # noqa: E402
                                               ragged, tile)

BF16_TOL = 3e-2
SHAPE = {"M": 512, "N": 512, "K": 512, "dtype": "bfloat16"}


def _accepts(cfg):
    """The bfloat16 build's model takes ``cfg`` at SHAPE: no refusal, whole
    warps, at most 1024 threads, and no more shared memory than
    ``smem_footprint(cfg, 2)``, which fits the card."""
    M, N, K = SHAPE["M"], SHAPE["N"], SHAPE["K"]
    if cfg["ACC_IN_OUTPUT"]:
        # in-place accumulation into a bfloat16 output stays refused, as
        # the JAX package's kernel fails on it
        with pytest.raises(ValueError, match="float32 output"):
            make_matmul(M, N, K, cfg, out_dtype=torch.bfloat16)
        return
    fn = make_matmul(M, N, K, cfg, out_dtype=torch.bfloat16)
    wm, wn, threads = warp_tile(fn.config)
    assert fn.config["BLOCK_M"] % wm == 0 and fn.config["BLOCK_N"] % wn == 0
    assert threads % 32 == 0 and threads <= H100_SXM.max_threads_per_block
    assert GEMM.block_threads(SHAPE, cfg) == threads == \
        block_threads(fn.config, 2)
    assert GEMM.smem_footprint(SHAPE, cfg) <= smem_footprint(cfg, 2)
    assert H100_SXM.fits_smem(GEMM.smem_footprint(SHAPE, cfg))


def test_model_accepts_the_compact_space():
    configs = GEMM.make_space(SHAPE).enumerate()
    assert len(configs) == 288
    for cfg in configs:
        _accepts(cfg)


def test_model_accepts_a_sample_of_the_extended_space():
    space = GEMM.make_space(SHAPE, extended=True)
    sample = space.sample_unique(random.Random(0), 400)
    assert len(sample) == 400
    for cfg in sample:
        _accepts(cfg)


@pytest.mark.parametrize("cfg, want", [
    ({"BLOCK_M": 128, "BLOCK_N": 128}, (64, 64, 128)),
    ({"BLOCK_M": 64, "BLOCK_N": 64}, (32, 32, 128)),
    ({"BLOCK_M": 16, "BLOCK_N": 16}, (16, 16, 32)),
    ({"BLOCK_M": 32, "BLOCK_N": 512}, (16, 64, 512)),
    ({"BLOCK_M": 128, "BLOCK_N": 128, "ACC_DTYPE": "bfloat16"},
     (64, 32, 256)),
    ({"BLOCK_M": 96, "BLOCK_N": 48}, (16, 16, 576)),
])
def test_warp_tile(cfg, want):
    assert warp_tile(cfg) == want
    # the float32 build keeps its micro-tiles
    assert block_threads(cfg, 4) == micro_tile(cfg)[2]


def test_warp_tile_refuses_what_the_mma_cannot_tile():
    # BLOCK_M 8 is no mma tile: the bfloat16 build takes it on a tile of 16
    # rows (the 8 past the block zero-filled and not stored), as the
    # float32 build takes it
    cfg = {"BLOCK_M": 8, "BLOCK_N": 64, "BLOCK_K": 16}
    fn = make_matmul(64, 64, 64, cfg, out_dtype=torch.bfloat16)
    make_matmul(64, 64, 64, cfg)
    assert tile(fn.config, 2) == (16, 64, 16) and ragged(fn.config, 2)
    assert warp_tile(cfg) == (16, 32, 64) == (16, 32, block_threads(cfg, 2))
    assert smem_footprint(cfg, 2) == 2 * 2 * 16 * (16 + 64)
    assert _defines(fn.config, torch.bfloat16)["TILE_M"] == 16
    # the plain version equals the JAX package's kernel at that config
    got, want = _compare(64, 64, 64, cfg)
    np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)
    # what the card cannot launch stays refused, naming the limit
    with pytest.raises(ValueError, match="at most 1024"):
        make_matmul(512, 512, 64, {"BLOCK_M": 512, "BLOCK_N": 512,
                                   "BLOCK_K": 16}, out_dtype=torch.bfloat16)


def test_a_bf16_product_resolves_what_was_tuned_for_bf16(tmp_path,
                                                         monkeypatch):
    cache = TuningCache(str(tmp_path / "tuned.json"))
    f32_cfg = dict(heuristic_config(256, 256, 256), BLOCK_K=32)
    bf16_cfg = dict(heuristic_config(256, 256, 256), GRID_ORDER="nm")
    for dtype, cfg in (("float32", f32_cfg), ("bfloat16", bf16_cfg)):
        cache.record("gemm", ops.shape_key(256, 256, 256, dtype),
                     H100_SXM.name, cfg, 1e-5, "annealing", 1,
                     shape=ops._shape(256, 256, 256, dtype))
    assert lookup_config(256, 256, 256, H100_SXM, cache) == f32_cfg
    assert lookup_config(256, 256, 256, H100_SXM, cache,
                         dtype=torch.bfloat16) == bf16_cfg
    # matmul(config=None) asks for its operands' dtype
    asked = []
    monkeypatch.setattr(ops, "lookup_config", lambda *a, **kw: (
        asked.append(kw["dtype"]) or bf16_cfg))
    a = torch.ones(256, 256, dtype=torch.bfloat16)
    assert ops.matmul(a, a, profile=H100_SXM).dtype == torch.bfloat16
    assert asked == [torch.bfloat16]


def _inputs(M, N, K, trans_a=False, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(K, M) if trans_a else (M, K)).astype(np.float32)
    b = rng.normal(size=(K, N)).astype(np.float32)
    return a, b


def _compare(M, N, K, cfg, trans_a=False):
    """gemm_plain and the Pallas GEMM in interpret mode on the same
    bfloat16 inputs: both results in float32."""
    a, b = _inputs(M, N, K, trans_a)
    want = ref_make_matmul(M, N, K, cfg, out_dtype=jnp.bfloat16,
                           interpret=True)(jnp.asarray(a, jnp.bfloat16),
                                           jnp.asarray(b, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    got = gemm_plain(torch.from_numpy(a).bfloat16(),
                     torch.from_numpy(b).bfloat16(), cfg)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    return got.float().numpy(), np.asarray(want, np.float32)


def test_trans_a():
    got, want = _compare(128, 64, 128, {"BLOCK_M": 64, "BLOCK_N": 64,
                                        "BLOCK_K": 32, "TRANS_A": True},
                         trans_a=True)
    np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("bk", [8, 64])
@pytest.mark.parametrize("inner", [1, 2, 4, 8])
def test_inner_steps(bk, inner):
    cfg = {"BLOCK_M": 32, "BLOCK_N": 32, "BLOCK_K": bk, "INNER_STEPS": inner}
    got, want = _compare(64, 64, 128, cfg)
    np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("bk, inner", [(64, 1), (64, 8), (8, 8), (32, 4)])
def test_bf16_accumulator_with_bf16_inputs(bk, inner):
    cfg = {"BLOCK_M": 32, "BLOCK_N": 32, "BLOCK_K": bk, "INNER_STEPS": inner,
           "ACC_DTYPE": "bfloat16"}
    got, want = _compare(64, 64, 128, cfg)
    if bk // inner == 1:
        # one product a sub-dot, exact in float32: both round it alike
        np.testing.assert_array_equal(got, want)
        return
    # chip_smoke.py::plain_tolerance: a sub-dot summed in another order
    # may round the running sum the other way, two ulps of the sums' size
    atol = 2 * 2.0 ** -8 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=atol)


def _branches(src, name):
    """The text of ``#if name``'s two branches at the top level of ``src``:
    (what builds when it is set, what builds when it is not)."""
    lines = src.splitlines()
    start = lines.index(f"#if {name}")
    depth, mid = 0, None
    for i in range(start, len(lines)):
        directive = lines[i].split()[0] if lines[i].startswith("#") else ""
        if directive in ("#if", "#ifdef", "#ifndef"):
            depth += 1
        elif directive == "#else" and depth == 1:
            mid = i
        elif directive == "#endif":
            depth -= 1
            if depth == 0:
                return ("\n".join(lines[start + 1:mid]),
                        "\n".join(lines[mid + 1:i]))
    raise AssertionError(f"#if {name} is not closed")


def _code(text):
    """``text`` without its // comments."""
    return "\n".join(line.split("//")[0] for line in text.splitlines())


def test_bf16_body_multiplies_on_the_tensor_cores():
    with open(SOURCE) as f:
        src = f.read()
    bf16, f32 = (_code(b) for b in _branches(src, "IN_BF16"))
    # the bfloat16 body: ldmatrix-fed mma.sync, 16 and 8 deep, with a
    # float32 accumulator
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in bf16
    assert "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32" in bf16
    assert re.search(r"ldmatrix\.sync\.aligned\.m8n8\.x4\.trans", bf16)
    assert "cp.async" in src and "mma_k16(" in bf16
    # ... and none of the FMA route: no load_n, no widening, no fmaf
    for word in ("load_n", "fmaf", "__uint_as_float", "to_f32"):
        assert word not in bf16, word
    # the float32 body stays on the FMA units, and load_n there reads
    # floats only
    assert "fmaf" in f32 and "load_n" in f32 and "mma" not in f32
    assert "__uint_as_float" not in src and "__nv_bfloat16" not in f32
