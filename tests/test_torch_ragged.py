"""Ragged shapes and blocks: the port's ops take every shape and every
block that the JAX package's ops compute.

The builds round a block the thread geometry cannot tile up to a tile it
can (``matmul.py::tile``, ``flash.py::tile``, ``conv2d.py::column_blocks``)
and mask the excess, so the heuristics may return any block that divides
its dim.  Here, on the CPU, where the ops take the plain versions after
the same config checks as on the card:

- at the shapes where the ops once refused the heuristic's config, and at
  explicit configs the JAX package's ``validate_config`` accepts, the
  port's op equals the JAX op (Pallas in interpret mode) on the same
  inputs, within ``core/verify.py::_TOLS`` in float32 and BF16_TOL (the
  JAX package's bfloat16 test tolerance) in bfloat16;
- for every dim 1-1100 (and flash head width 1-256), in both types, the
  heuristic's config passes ``validate_config`` and its threads and shared
  memory fit an H100.

The kernels themselves run only on the card (``chip_smoke.py``:
``[ragged]``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.kernels.attention as ref_fa  # noqa: E402
import repro.kernels.conv2d as ref_cv  # noqa: E402
import repro.kernels.matmul as ref_mm  # noqa: E402
from repro_torch.core import H100_SXM  # noqa: E402
from repro_torch.core.verify import _TOLS  # noqa: E402
from repro_torch.kernels import attention as fa  # noqa: E402
from repro_torch.kernels import conv2d as cv  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402
# the kernels' modules (the packages' ``matmul`` is the op)
fa_kernel = importlib.import_module("repro_torch.kernels.attention.flash")
mm_kernel = importlib.import_module("repro_torch.kernels.matmul.matmul")

BF16_TOL = 3e-2
DTYPES = ("float32", "bfloat16")

#: GEMM (M, N, K) at which matmul(config=None) once refused the heuristic's
#: blocks (100 -> BLOCK 100, 36 x 52 x 20, 8 and 24 in bfloat16), primes
#: and a dim of 1
GEMM_SHAPES = [(100, 100, 100), (36, 52, 20), (8, 8, 8), (24, 24, 24),
               (13, 17, 19), (1, 7, 3)]
#: flash (S, D), q = k = v of length S: lengths whose blocks are not whole
#: warps or mma tiles, and head widths the geometry does not tile
FLASH_SHAPES = [(16, 64), (48, 64), (100, 64), (200, 64), (64, 40),
                (64, 80), (13, 24)]
#: conv (H, W, Fh, Fw): the heuristic's BLOCK_W of 200 is no mma tile
CONV_SHAPES = [(50, 200, 3, 3)]

GEMM_CONFIGS = [
    ((64, 64, 64), {"BLOCK_M": 8, "BLOCK_N": 64, "BLOCK_K": 16}),
    ((64, 48, 40), {"BLOCK_M": 32, "BLOCK_N": 48, "BLOCK_K": 20,
                    "INNER_STEPS": 4, "ACC_DTYPE": "bfloat16"}),
    ((128, 128, 96), {"BLOCK_M": 128, "BLOCK_N": 128, "BLOCK_K": 24,
                      "INNER_STEPS": 8, "ACC_DTYPE": "bfloat16"}),
    ((60, 60, 12), {"BLOCK_M": 60, "BLOCK_N": 60, "BLOCK_K": 12,
                    "TRANS_A": True}),
]
FLASH_CONFIGS = [
    ((128, 64), {"BLOCK_Q": 8, "BLOCK_K": 64}),
    ((128, 64), {"BLOCK_Q": 64, "BLOCK_K": 8}),
    ((256, 64), {"BLOCK_Q": 4, "BLOCK_K": 128}),
    ((128, 64), {"BLOCK_Q": 16, "BLOCK_K": 16}),
]
CONV_CONFIGS = [
    ((50, 200, 3, 3), {"BLOCK_H": 16, "BLOCK_W": 200}),
    ((64, 256, 3, 3), {"BLOCK_H": 16, "BLOCK_W": 100}),
    ((50, 200, 7, 7), {"BLOCK_H": 8, "BLOCK_W": 50}),
]
CONV_BASE = {"SUB_H": 1, "UNROLL": True, "HALO_MODE": "materialize"}


@pytest.fixture(autouse=True)
def _empty_cache(tmp_path, monkeypatch):
    """Both packages' lookups see an empty record: config=None is the
    heuristic's."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tuned.json"))


def _tol(dtype, cfg):
    """BF16_TOL where a result or a GEMM's running sum is bfloat16 (each
    sum rounds where the JAX kernel's does, so an order of summation may
    flip one rounding), else the float32 default."""
    if dtype == "bfloat16" or (cfg or {}).get("ACC_DTYPE") == "bfloat16":
        return BF16_TOL, BF16_TOL
    return _TOLS[torch.float32]


def _close(got, want, dtype, cfg=None):
    assert got.dtype == getattr(torch, dtype)
    atol, rtol = _tol(dtype, cfg)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _normal(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]


def _pair(x, dtype):
    return jnp.asarray(x, jnp.dtype(dtype)), \
        torch.from_numpy(x).to(getattr(torch, dtype))


def _gemm(shape, cfg, dtype):
    M, N, K = shape
    trans = bool((cfg or {}).get("TRANS_A"))
    a, b = _normal(0, (K, M) if trans else (M, K), (K, N))
    (ja, ta), (jb, tb) = _pair(a, dtype), _pair(b, dtype)
    want = ref_mm.matmul(ja, jb, cfg, interpret=True)
    _close(mm.matmul(ta, tb, cfg, profile=H100_SXM), want, dtype, cfg)


def _flash(shape, cfg, dtype):
    S, D = shape
    q, k, v = _normal(1, (1, S, D), (1, S, D), (1, S, D), scale=0.5)
    pairs = [_pair(x, dtype) for x in (q, k, v)]
    want = ref_fa.flash_attention(*(p[0] for p in pairs), causal=True,
                                  config=cfg, interpret=True)
    got = fa.flash_attention(*(p[1] for p in pairs), causal=True,
                             config=cfg, profile=H100_SXM)
    _close(got, want, dtype)


def _conv(shape, cfg, dtype):
    H, W, Fh, Fw = shape
    img, flt = _normal(2, (H, W), (Fh, Fw))
    (ji, ti), (jf, tf) = _pair(img, dtype), _pair(flt, dtype)
    want = ref_cv.conv2d(ji, jf, cfg, interpret=True)
    _close(cv.conv2d(ti, tf, cfg, profile=H100_SXM), want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", GEMM_SHAPES, ids=str)
def test_gemm_heuristic_matches_jax(shape, dtype):
    _gemm(shape, None, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape, cfg", GEMM_CONFIGS, ids=str)
def test_gemm_config_matches_jax(shape, cfg, dtype):
    ref_mm.validate_config({**ref_mm.DEFAULT_CONFIG, **cfg}, *shape)
    _gemm(shape, cfg, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=str)
def test_flash_heuristic_matches_jax(shape, dtype):
    _flash(shape, None, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape, cfg", FLASH_CONFIGS, ids=str)
def test_flash_config_matches_jax(shape, cfg, dtype):
    _flash(shape, cfg, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", CONV_SHAPES, ids=str)
def test_conv_heuristic_matches_jax(shape, dtype):
    _conv(shape, None, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape, cfg", CONV_CONFIGS, ids=str)
def test_conv_config_matches_jax(shape, cfg, dtype):
    _conv(shape, {**CONV_BASE, **cfg}, dtype)


# -- the builds' tiles ----------------------------------------------------

@pytest.mark.parametrize("cfg, elt, want, is_ragged", [
    # what the threads tiled before: the tile is the block, unmasked
    ({"BLOCK_M": 128, "BLOCK_N": 64, "BLOCK_K": 32}, 4, (128, 64, 32), False),
    ({"BLOCK_M": 96, "BLOCK_N": 48, "BLOCK_K": 8}, 2, (96, 48, 8), False),
    # the micro-tile and the mma tiles round the block up
    ({"BLOCK_M": 100, "BLOCK_N": 36, "BLOCK_K": 50}, 4, (104, 36, 50), True),
    ({"BLOCK_M": 100, "BLOCK_N": 20, "BLOCK_K": 50}, 2, (128, 32, 64), True),
    ({"BLOCK_M": 1, "BLOCK_N": 1, "BLOCK_K": 1}, 4, (4, 4, 1), True),
    ({"BLOCK_M": 1, "BLOCK_N": 1, "BLOCK_K": 1}, 2, (16, 16, 8), True),
    # a bfloat16 sum ends where each sub-dot of 3 ends: a segment each
    ({"BLOCK_M": 64, "BLOCK_N": 64, "BLOCK_K": 24, "INNER_STEPS": 8,
      "ACC_DTYPE": "bfloat16"}, 2, (64, 64, 64), True),
    # ... while sub-dots of 1, 2 or 4 share the 8-deep steps, as before
    ({"BLOCK_M": 64, "BLOCK_N": 64, "BLOCK_K": 8, "INNER_STEPS": 8,
      "ACC_DTYPE": "bfloat16"}, 2, (64, 64, 8), False),
], ids=str)
def test_gemm_tile(cfg, elt, want, is_ragged):
    cfg = {**mm.DEFAULT_CONFIG, **cfg}
    assert mm_kernel.tile(cfg, elt) == want
    assert mm_kernel.ragged(cfg, elt) == is_ragged
    defines = mm_kernel._defines(cfg, mm_kernel.DTYPES[
        "float32" if elt == 4 else "bfloat16"])
    assert ("RAGGED" in defines) == is_ragged
    tm, tn, tk = want
    assert mm.smem_footprint(cfg, elt) == elt * 2 * tk * (tm + tn)


@pytest.mark.parametrize("cfg, D, elt, want", [
    ({"BLOCK_Q": 64, "BLOCK_K": 64}, 128, 4, (64, 64, 128)),
    ({"BLOCK_Q": 64, "BLOCK_K": 64}, 40, 4, (64, 64, 64)),
    ({"BLOCK_Q": 50, "BLOCK_K": 50}, 64, 4, (64, 56, 64)),
    ({"BLOCK_Q": 16, "BLOCK_K": 16}, 64, 4, (32, 16, 64)),
    ({"BLOCK_Q": 1, "BLOCK_K": 1}, 1, 4, (128, 4, 4)),
    ({"BLOCK_Q": 50, "BLOCK_K": 50}, 40, 2, (64, 64, 48)),
    ({"BLOCK_Q": 1, "BLOCK_K": 1}, 1, 2, (16, 16, 16)),
], ids=str)
def test_flash_tile(cfg, D, elt, want):
    assert fa_kernel.tile(cfg, D, elt) == want
    assert fa_kernel.ragged(cfg, D, elt) == (want != (cfg["BLOCK_Q"],
                                                      cfg["BLOCK_K"], D))
    assert fa.block_threads(cfg, D, elt) % 32 == 0


# -- the heuristics, at every dim -----------------------------------------

def _fits(threads, smem, limit):
    return threads <= limit and H100_SXM.fits_smem(smem)


@pytest.mark.parametrize("dtype", DTYPES)
def test_every_dim_has_a_config_the_builds_take(dtype):
    """Each dim 1-1100 in each place of the GEMM, the flash lengths and
    the conv image, and each head width 1-256: the heuristic's config
    passes validate_config, and its threads and shared memory fit."""
    elt = 2 if dtype == "bfloat16" else 4
    for d in range(1, 1101):
        e, f = d * 7 % 1100 + 1, d * 13 % 1100 + 1
        for M, N, K in ((d, e, f), (e, f, d), (f, d, e)):
            cfg = mm.heuristic_config(M, N, K)
            mm.validate_config(cfg, M, N, K, elt)
            assert _fits(mm.block_threads(cfg, elt),
                         mm.smem_footprint(cfg, elt), 1024), (M, N, K, cfg)
        D = d % 256 + 1
        for Sq, Sk in ((d, e), (e, d)):
            cfg = fa.heuristic_config(Sq, Sk, D)
            fa.validate_config(cfg, Sq, Sk, D, elt)
            assert _fits(fa.block_threads(cfg, D, elt),
                         fa.smem_footprint(cfg, D, elt), 512), (Sq, Sk, D)
        for filt in (3, 7, 11):
            cfg = cv.heuristic_config(d, e, filt, filt)
            cv.validate_config(cfg, d, e, filt, filt, elt)
            assert _fits(cv.block_threads(cfg, elt),
                         cv.smem_footprint(cfg, filt, filt, elt), 1024)
    for D in range(1, 257):
        for S in (1, 7, 64, 100, 1009, 1024):
            cfg = fa.heuristic_config(S, S, D)
            fa.validate_config(cfg, S, S, D, elt)
            assert _fits(fa.block_threads(cfg, D, elt),
                         fa.smem_footprint(cfg, D, elt), 512), (S, D, cfg)


def test_non_dividing_and_oversized_blocks_stay_refused():
    """The one difference from the JAX package's validate_config: what the
    card cannot launch, named by its limit."""
    with pytest.raises(ValueError, match="not divisible"):
        mm.make_matmul(100, 100, 100, {"BLOCK_M": 64})
    with pytest.raises(ValueError, match="not divisible"):
        fa.make_flash_attention(100, 100, 64, {"BLOCK_Q": 64, "BLOCK_K": 50})
    ref_mm.validate_config({**ref_mm.DEFAULT_CONFIG, "BLOCK_M": 512,
                            "BLOCK_N": 512}, 512, 512, 512)
    with pytest.raises(ValueError, match="at most 1024"):
        mm.make_matmul(512, 512, 512, {"BLOCK_M": 512, "BLOCK_N": 512})
    with pytest.raises(ValueError, match="at most 512"):
        fa.make_flash_attention(1000, 1000, 64, {"BLOCK_Q": 1000,
                                                 "BLOCK_K": 8},
                                dtype=torch.bfloat16)
    assert jax.default_backend() == "cpu"
