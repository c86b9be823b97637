"""Flash attention's bfloat16 build, which multiplies on the tensor cores.

Its plain version rounds the weights P to bfloat16 before P V, where the
build rounds them, and must still agree with the JAX package's Pallas
flash attention in interpret mode on the same bfloat16 inputs; its Python
model (``geometry``, ``block_threads``, ``smem_footprint``,
``register_estimate``, ``analytical_time``) describes the warp-per-rows
build with no P buffer; its space, key and lookup are its own.  The build
itself runs only on the card (``chip_smoke.py``: ``[flash-sweep]``,
``[flash-main-bf16]``, ``[build-space]``).

Tolerance: 3e-2, the JAX package's bfloat16 attention test tolerance.
Rounding P moves each weight by at most 2^-9 relative, so the output by at
most 2^-9 max|v|, well inside it.
"""

import importlib.util
import math
import os
import re

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.kernels.attention as ref_pkg  # noqa: E402
from repro.kernels.attention import ops as ref_ops  # noqa: E402
from repro_torch.core import (H100_SXM, AnalyticalEvaluator,  # noqa: E402
                              CacheEntry, TuningCache, lookup_resolved)
from repro_torch.kernels.attention import (  # noqa: E402
    FLASH_ATTENTION, analytical_time, block_threads, flash_attention,
    flash_plain, geometry, kv_steps, make_flash_attention,
    register_estimate, shape_key, smem_footprint, tuning_space,
    validate_config)
from repro_torch.kernels.attention import ops  # noqa: E402
from repro_torch.kernels.attention.flash import (  # noqa: E402
    FMA_EFFICIENCY, SOURCE, tile)
from repro_torch.tune import tune_kernel  # noqa: E402

BF16_TOL = 3e-2


def _qkv(lead, sq, sk, d, seed=5):
    rng = np.random.default_rng(seed)
    def mk(s):
        return (rng.normal(size=lead + s) * 0.5).astype(np.float32)
    return mk((sq, d)), mk((sk, d)), mk((sk, d))


def _jax(q, k, v, cfg, causal):
    """The Pallas kernel in interpret mode on bfloat16 inputs, vmapped over
    the heads, as float32."""
    sq, d = q.shape[-2:]
    fn = ref_pkg.make_flash_attention(sq, k.shape[-2], d, cfg, causal=causal,
                                      dtype=jnp.bfloat16, interpret=True)
    out = jax.vmap(fn)(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    assert out.dtype == jnp.bfloat16
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("sq, sk, causal", [
    (256, 256, True),           # causal
    (256, 256, False),          # full
    (128, 512, True),           # prefix: query ends align with the KV end
    (512, 128, True),           # Sq > Sk: the first rows see no key
])
def test_plain_with_rounded_p_matches_pallas_interpret(sq, sk, causal):
    cfg = {"BLOCK_Q": 64, "BLOCK_K": 64}
    q, k, v = _qkv((2,), sq, sk, 64)
    want = _jax(q, k, v, cfg, causal)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = flash_plain(tq, tk, tv, cfg, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == (2, sq, 64)
    np.testing.assert_allclose(got.float().numpy(), want,
                               rtol=BF16_TOL, atol=BF16_TOL)
    if causal and sq > sk:
        # rows that see no key return the mean of v, as in the JAX package
        mean_v = tv.float().mean(dim=-2, keepdim=True)
        torch.testing.assert_close(
            got[:, :sq - sk].float(), mean_v.expand(2, sq - sk, 64),
            rtol=BF16_TOL, atol=BF16_TOL)


def test_plain_rounds_p_where_the_build_does():
    """The bfloat16 plain version differs from the float32 schedule on the
    same (bf16-valued) inputs by P's rounding alone: at most 2^-9 max|v|
    before the output's own rounding, and not zero."""
    q, k, v = (torch.from_numpy(x).bfloat16() for x in _qkv((), 256, 256,
                                                             64, seed=8))
    cfg = {"BLOCK_Q": 64, "BLOCK_K": 32}
    got = flash_plain(q, k, v, cfg).float()
    exact = flash_plain(q.float(), k.float(), v.float(), cfg)
    bound = 2.0 ** -9 * v.float().abs().max().item()
    # each side is then rounded to bfloat16 (half an ulp of max|out|)
    ulp = 2.0 ** -8 * exact.abs().max().item()
    diff = (got - exact).abs().max().item()
    assert 0 < diff <= bound + ulp


@pytest.mark.parametrize("cfg, d, want", [
    ({"BLOCK_Q": 64, "BLOCK_K": 64}, 128,
     {"WARPS": 4, "NT": 8, "DT": 16, "threads": 128,
      "smem": (64 + 2 * 2 * 64) * 272, "regs": 4 * (8 + 16) + 64}),
    ({"BLOCK_Q": 128, "BLOCK_K": 32}, 128,
     {"WARPS": 8, "NT": 4, "DT": 16, "threads": 256,
      "smem": (128 + 2 * 2 * 32) * 272, "regs": 4 * (4 + 16) + 64}),
    ({"BLOCK_Q": 256, "BLOCK_K": 16, "PIPELINE_DEPTH": 3}, 64,
     {"WARPS": 16, "NT": 2, "DT": 8, "threads": 512,
      "smem": (256 + 2 * 3 * 16) * 144, "regs": 4 * (2 + 8) + 64}),
    ({"BLOCK_Q": 16, "BLOCK_K": 16}, 16,
     {"WARPS": 1, "NT": 2, "DT": 2, "threads": 32,
      "smem": (16 + 2 * 2 * 16) * 48, "regs": 4 * (2 + 2) + 64}),
    ({"BLOCK_Q": 192, "BLOCK_K": 128, "PIPELINE_DEPTH": 3}, 128,
     {"WARPS": 12, "NT": 16, "DT": 16, "threads": 384,
      "smem": (192 + 2 * 3 * 128) * 272, "regs": 4 * (16 + 16) + 64}),
])
def test_bf16_geometry_footprint_and_registers(cfg, d, want):
    """Warps of 16 rows; shared memory is Q and the K/V stages, rows padded
    by 16 bytes, and no P buffer; registers are the score and output
    fragments plus 64."""
    g = geometry(cfg, d, 2)
    assert g == {k: want[k] for k in ("WARPS", "NT", "DT", "threads")}
    assert block_threads(cfg, d, 2) == want["threads"]
    assert smem_footprint(cfg, d, 2) == want["smem"]
    assert register_estimate(cfg, d, 2) == want["regs"]
    validate_config(cfg, 768, 768, d, 2)
    # the float32 build keeps its own geometry and its P buffer
    if d >= 64:
        assert block_threads(cfg, d) == geometry(cfg, d)["threads"]
        p_bytes = 4 * cfg["BLOCK_Q"] * (cfg["BLOCK_K"] + 4)
        assert smem_footprint(cfg, d) > p_bytes


def test_bf16_build_refuses_what_the_mma_cannot_tile():
    # blocks of 8 and D = 24 are no mma tiles: the bfloat16 build takes
    # them on tiles rounded up to 16 (the rows, keys and dims past the
    # block zero-filled, the keys' scores -inf, none stored), as the
    # float32 build takes them
    for cfg, d, want in (({"BLOCK_Q": 8, "BLOCK_K": 64}, 64, (16, 64, 64)),
                         ({"BLOCK_Q": 64, "BLOCK_K": 8}, 64, (64, 16, 64)),
                         ({"BLOCK_Q": 64, "BLOCK_K": 64}, 24, (64, 64, 32))):
        validate_config(cfg, 128, 128, d)
        make_flash_attention(128, 128, d, cfg)
        fn = make_flash_attention(128, 128, d, cfg, dtype=torch.bfloat16)
        tq, tk, td = tile(fn.config, d, 2)
        assert (tq, tk, td) == want
        assert geometry(cfg, d, 2) == {"WARPS": tq // 16, "NT": tk // 8,
                                       "DT": td // 8, "threads": 2 * tq}
        assert smem_footprint(cfg, d, 2) == \
            (tq + 2 * 2 * tk) * (2 * td + 16)
        # the model prices the rounded tile
        assert math.isfinite(analytical_time(cfg, H100_SXM, 128, 128, d, 2))
        # the plain version equals the JAX package's kernel there
        q, k, v = _qkv((), 128, 128, d)
        want_out = ref_pkg.make_flash_attention(
            128, 128, d, cfg, causal=True, dtype=jnp.bfloat16,
            interpret=True)(*(jnp.asarray(x, jnp.bfloat16)
                              for x in (q, k, v)))
        got = fn(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)))
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want_out, np.float32),
                                   rtol=BF16_TOL, atol=BF16_TOL)
    with pytest.raises(ValueError, match="at most 512"):
        validate_config({"BLOCK_Q": 320, "BLOCK_K": 64}, 640, 128, 64, 2)


def _smoke():
    """chip_smoke.py as a module (its phases run only under __main__)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reordered(q, k, v, bk, causal=True, diagonal=True):
    """The bfloat16 build's schedule summed in another order: scores and
    P V in float64 (rounded to float32), exp2 with the scale folded in,
    P rounded to bfloat16, the output by a reciprocal.  ``diagonal=False``
    plants a fault: the causal rule drops the key on the diagonal."""
    sq, d = q.shape[-2:]
    sk = k.shape[-2]
    c = d ** -0.5 * math.log2(math.e)
    qd, kd, vd = (x.double() for x in (q, k, v))
    m = torch.full((*q.shape[:-1], 1), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros((*q.shape[:-1], d))
    q_pos = torch.arange(sq)[:, None] + (sk - sq)
    for k0 in range(0, sk, bk):
        s = (qd @ kd[..., k0:k0 + bk, :].transpose(-1, -2)).float() * c
        if causal:
            k_pos = torch.arange(k0, k0 + bk)[None, :]
            s = torch.where(q_pos >= k_pos if diagonal else q_pos > k_pos,
                            s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha, p = torch.exp2(m - m_new), torch.exp2(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        p = p.bfloat16().double()
        acc = acc * alpha + (p @ vd[..., k0:k0 + bk, :]).float()
        m = m_new
    return (acc * (1.0 / l.clamp_min(1e-30))).bfloat16()


@pytest.mark.parametrize("sq, sk", [(512, 512), (1024, 256)])
def test_card_bound_on_the_plain_version_catches_planted_faults(sq, sk):
    """chip_smoke.py holds each bfloat16 build to flash_plain by
    ``flash_bf16_agreement``.  The same schedule summed in another order
    stays inside it; P left in float32, the last query block skipping its
    last KV step, and a causal rule that drops the diagonal key do not."""
    smoke = _smoke()
    cfg = {"BLOCK_Q": 64, "BLOCK_K": 64}
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in _qkv((2,), sq, sk, 64, seed=3))
    plain = flash_plain(q, k, v, cfg)
    limit = smoke.FLASH_BF16_DIFFER

    def agreement(out):
        return smoke.flash_bf16_agreement(out, plain)

    assert agreement(plain) == (0.0, 0.0)
    share, differ = agreement(_reordered(q, k, v, 64))
    assert share <= 0.5 and differ <= limit / 2
    # P left in float32: every element within the bound, but a share of
    # them rounds the other way far above the limit
    unrounded = flash_plain(q.float(), k.float(), v.float(), cfg).bfloat16()
    assert agreement(unrounded)[1] > 5 * limit
    # the last query block stops one KV step short (its rows see every key
    # before the last block, as they do under the causal rule)
    short = plain.clone()
    short[..., -64:, :] = flash_plain(q[..., -64:, :], k[..., :-64, :],
                                      v[..., :-64, :], cfg, causal=False)
    assert agreement(short)[0] > 5
    assert agreement(_reordered(q, k, v, 64, diagonal=False))[0] > 5


BF16_SHAPE = {"Sq": 4096, "Sk": 4096, "D": 128, "causal": True,
              "dtype": "bfloat16"}


def test_bf16_space_keeps_its_constraints_and_fits_the_card():
    configs = FLASH_ATTENTION.make_space(BF16_SHAPE).enumerate()
    # 4 and 8 warps at every BLOCK_K to 128 (16 warps of 256 rows have 128
    # registers a thread, fewer than their fragments need; BLOCK_K 256
    # needs more than 255), and 3 stages where they fit 227 KB
    assert len(configs) == 15
    assert {(c["BLOCK_Q"], c["BLOCK_K"]) for c in configs} == {
        (bq, bk) for bq in (64, 128) for bk in (16, 32, 64, 128)}
    assert {"BLOCK_Q": 128, "BLOCK_K": 128, "PIPELINE_DEPTH": 3} \
        not in configs
    params, constraints = tuning_space(128, 2)
    assert params == tuning_space(128)[0]
    for c in configs:
        for fn, names, _ in constraints:
            assert fn(*(c[n] for n in names))
        threads = block_threads(c, 128, 2)
        assert ops.MIN_THREADS <= threads <= 512 and threads % 32 == 0
        assert register_estimate(c, 128, 2) <= min(
            255, H100_SXM.regs_per_sm // threads)
        assert smem_footprint(c, 128, 2) <= H100_SXM.smem_per_block_optin
        assert FLASH_ATTENTION.smem_footprint(BF16_SHAPE, c) == \
            smem_footprint(c, 128, 2)
        assert FLASH_ATTENTION.block_threads(BF16_SHAPE, c) == threads
        assert math.isfinite(FLASH_ATTENTION.analytical_model(
            BF16_SHAPE, c, H100_SXM))
    # the float32 space at the same shape is the float32 build's
    f32 = FLASH_ATTENTION.make_space(dict(BF16_SHAPE, dtype="float32"))
    assert len(f32.enumerate()) == 7


def test_bf16_key_is_its_own_and_float32_keeps_the_jax_key():
    assert shape_key(4096, 4096, 128, True, "bfloat16") == \
        "Sq4096_Sk4096_D128_c_bfloat16"
    assert shape_key(4096, 4096, 128, True, torch.bfloat16) == \
        shape_key(4096, 4096, 128, True, "bfloat16")
    for causal in (True, False):
        want = ref_ops.shape_key(4096, 4096, 128, causal)
        assert shape_key(4096, 4096, 128, causal) == want
        assert shape_key(4096, 4096, 128, causal, torch.float32) == want
        assert shape_key(4096, 4096, 128, causal, "bfloat16") != want
    # a float32 shape names no dtype (the serve engine's and the JAX
    # package's), a bfloat16 one does
    assert ops._shape(64, 64, 64) == {"Sq": 64, "Sk": 64, "D": 64,
                                      "causal": True}
    assert ops._shape(64, 64, 64, dtype=torch.bfloat16)["dtype"] == \
        "bfloat16"


def test_bf16_model_prices_the_tensor_cores():
    cfg = {"BLOCK_Q": 64, "BLOCK_K": 64, "PIPELINE_DEPTH": 2}
    steps = kv_steps(cfg, 4096, 4096, causal=True)
    flops = 4.0 * steps * 64 * 64 * 128
    t2 = analytical_time(cfg, H100_SXM, 4096, 4096, 128, 2)
    t4 = analytical_time(cfg, H100_SXM, 4096, 4096, 128, 4)
    assert t2 >= flops / H100_SXM.peak_bf16_tensor_flops
    assert t2 < flops / (FMA_EFFICIENCY * H100_SXM.peak_f32_flops)
    # the float32 pricing is the FMA rate's, as before
    assert t4 >= flops / (FMA_EFFICIENCY * H100_SXM.peak_f32_flops)
    assert FLASH_ATTENTION.analytical_model(BF16_SHAPE, cfg, H100_SXM) == t2
    # past the registers (16 warps of 256 rows) it is infeasible
    assert math.isinf(analytical_time({"BLOCK_Q": 256, "BLOCK_K": 64},
                                      H100_SXM, 4096, 4096, 128, 2))


def test_tune_record_lookup_run_in_bf16_and_float32_on_one_cache(tmp_path):
    """One cache holds a float32 and a bfloat16 search at one shape; each
    lookup resolves its own dtype's winner, and flash_attention on
    bfloat16 tensors runs the bfloat16 one."""
    cache = TuningCache(str(tmp_path / "tuned.json"))
    f32_shape = {"Sq": 512, "Sk": 512, "D": 128, "causal": True}
    bf16_shape = dict(f32_shape, dtype="bfloat16")
    best = {}
    for name, shape in (("float32", f32_shape), ("bfloat16", bf16_shape)):
        out = tune_kernel(FLASH_ATTENTION, shape, strategy="full",
                          budget=64,
                          evaluator=AnalyticalEvaluator(profile=H100_SXM),
                          profile=H100_SXM, cache=cache, warm_start=False)
        best[name] = out.result.best.config
    assert best["float32"] != best["bfloat16"]
    assert best["bfloat16"] in FLASH_ATTENTION.make_space(
        bf16_shape).enumerate()
    for name, shape in (("float32", f32_shape), ("bfloat16", bf16_shape)):
        res = lookup_resolved(FLASH_ATTENTION, shape, profile=H100_SXM,
                              cache=cache)
        assert res.provenance == "exact" and res.config == best[name]
        assert ops.lookup_config(512, 512, 128, True, H100_SXM, cache,
                                 dtype=name) == best[name]
    assert set(cache.entries()) == {
        "flash_attention|Sq512_Sk512_D128_c|h100_sxm",
        "flash_attention|Sq512_Sk512_D128_c_bfloat16|h100_sxm"}
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in _qkv((2,), 512, 512, 128, seed=9))
    asked = []
    real = ops.lookup_config

    def spy(*a, **kw):
        asked.append(kw.get("dtype"))
        return real(*a, cache=cache, **{n: x for n, x in kw.items()
                                        if n != "cache"})

    ops.lookup_config = spy
    try:
        got = flash_attention(q, k, v, profile=H100_SXM)
    finally:
        ops.lookup_config = real
    assert asked == [torch.bfloat16] and got.dtype == torch.bfloat16
    want = make_flash_attention(512, 512, 128, best["bfloat16"],
                                dtype=torch.bfloat16)(q, k, v)
    assert torch.equal(got, want)


@pytest.mark.parametrize("ask, want_from", [
    # a float32 shape that names no dtype (the serve engine's) must not
    # borrow the bfloat16 winner at its own sizes, only the float32 one
    ({"Sq": 1024, "Sk": 1024, "D": 128, "causal": True}, "float32"),
    ({"Sq": 1024, "Sk": 1024, "D": 128, "causal": True,
      "dtype": "float32"}, "float32"),
    ({"Sq": 256, "Sk": 256, "D": 128, "causal": True,
      "dtype": "bfloat16"}, "bfloat16"),
])
def test_transfer_borrows_only_from_its_own_dtype(tmp_path, ask, want_from):
    """Under TRANSFER a lookup borrows from the nearest entry of its own
    dtype, even where another dtype's entry lies nearer in size: a float32
    entry at 256 names no dtype, a bfloat16 one sits at 1024, each with a
    config the other shape's space also takes."""
    cache = TuningCache(str(tmp_path / "tuned.json"))
    f32_at = {"Sq": 256, "Sk": 256, "D": 128, "causal": True}
    bf16_at = {"Sq": 1024, "Sk": 1024, "D": 128, "causal": True,
               "dtype": "bfloat16"}
    configs = {"float32": {"BLOCK_Q": 64, "BLOCK_K": 64, "PIPELINE_DEPTH": 2},
               "bfloat16": {"BLOCK_Q": 128, "BLOCK_K": 32,
                            "PIPELINE_DEPTH": 2}}
    for at in (f32_at, bf16_at, ask):
        for cfg in configs.values():
            assert cfg in FLASH_ATTENTION.make_space(at).enumerate()
    for name, at in (("float32", f32_at), ("bfloat16", bf16_at)):
        cache.put(FLASH_ATTENTION.name, FLASH_ATTENTION.key_for(at),
                  H100_SXM.name,
                  CacheEntry(config=dict(configs[name]), time_s=1e-3,
                             strategy="full", evaluations=1, timestamp=0.0,
                             shape=dict(at)))
    res = lookup_resolved(FLASH_ATTENTION, ask, profile=H100_SXM,
                          cache=cache, policy="transfer")
    assert res.provenance == "transfer"
    assert res.config == configs[want_from]
    assert res.source_shape == (f32_at if want_from == "float32"
                                else bf16_at)


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
    # the bfloat16 body: ldmatrix-fed mma.sync with float32 sums, V read
    # transposed, P packed from the score fragments, base-2 exponentials
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in bf16
    assert re.search(r"ldmatrix\.sync\.aligned\.m8n8\.x4\.trans", bf16)
    assert re.search(r"ldmatrix\.sync\.aligned\.m8n8\.x4\.shared", bf16)
    assert "pack_bf16(" in bf16 and "exp2f(" in bf16
    # ... and none of the FMA route: no P buffer, no widening, no fmaf
    for word in ("Ps", "P_STRIDE", "load_vec", "load4", "fmaf",
                 "__uint_as_float", "expf(", "__syncwarp"):
        assert not re.search(rf"\b{re.escape(word)}", bf16), word
    # the float32 body stays on the FMA units with expf and its P buffer
    assert "fmaf" in f32 and "expf(" in f32 and "P_STRIDE" in f32
    assert "mma" not in f32 and "exp2f" not in f32
    assert "__nv_bfloat16" not in f32 and "__uint_as_float" not in src
