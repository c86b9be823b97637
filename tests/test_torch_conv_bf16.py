"""conv2d's bfloat16 build, which multiplies on the tensor cores.

The build sums, for each filter row, a banded product of the filter row
(16 x 16*KS) with the staged bfloat16 image on ``mma.sync``; every product
is exact in float32, every sum float32, and each output is rounded once to
bfloat16 after ``weight``, as the plain version does.  Here, on the CPU:

- the plain version equals the JAX package's Pallas conv in interpret mode
  on the same bfloat16 inputs, bit for bit, at every case of the card's
  conv sweep (XLA's CPU backend keeps each product in float32 too);
- the build's schedule written in PyTorch (``conv2d_banded``: staging
  origin, band offset, band, k-steps, column blocks) equals the plain
  version up to the order of the float32 sum, and the bound the card holds
  each build to (``chip_smoke.py::conv_bf16_agreement``) catches a band
  shifted by a column and a staging origin that forgets the offset;
- a bfloat16 shape has its own key and record, which ``conv2d()`` on
  bfloat16 tensors looks up; the float32 key stays the JAX package's;
- the Python models of the build (warp tile, threads, shared bytes,
  registers, the space's constraints, the price) describe it.

The build itself runs only on the card (``chip_smoke.py``: ``[conv-bf16]``,
``[conv-main-bf16]``, ``[build-new]``, ``[build-space]``).
"""

import importlib
import importlib.util
import math
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.kernels.conv2d as ref_pkg  # noqa: E402
from repro.kernels.conv2d import ops as ref_ops  # noqa: E402
from repro_torch.core import (H100_SXM, CacheEntry, TuningCache,  # noqa: E402
                              lookup_resolved)
from repro_torch.kernels.conv2d import (CONV2D, conv2d,  # noqa: E402
                                        conv2d_plain, heuristic_config,
                                        make_conv2d, ops, tuning_space)

cvk = importlib.import_module("repro_torch.kernels.conv2d.conv2d")

M = {"UNROLL": True, "HALO_MODE": "materialize"}
#: the card's conv sweep (chip_smoke.py::conv_cases), the configs of the
#: JAX package's conv tests
CONFIGS = [dict(M, BLOCK_H=16, BLOCK_W=128, SUB_H=1),
           dict(M, BLOCK_H=32, BLOCK_W=128, SUB_H=2, UNROLL=False),
           dict(M, BLOCK_H=8, BLOCK_W=256, SUB_H=4)]
SWEEP = ([(f"CONFIGS[{i}] {f}x{f}", c, (64, 256), (f, f), 1.0)
          for i, c in enumerate(CONFIGS) for f in (3, 7, 11)]
         + [("non_divisible", CONFIGS[0], (50, 200), (7, 7), 1.0),
            ("weight", CONFIGS[0], (32, 128), (3, 3), 2.5),
            ("even 4x4", CONFIGS[0], (64, 256), (4, 4), 1.0),
            ("even 2x5", CONFIGS[0], (64, 256), (2, 5), 1.0)])
IDS = [case[0] for case in SWEEP]


def _inputs(hw, filt, seed=25):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=hw).astype(np.float32)
    flt = rng.normal(size=filt).astype(np.float32)
    return img, flt


def _bf16(x):
    return torch.from_numpy(x).bfloat16()


def _smoke():
    """chip_smoke.py as a module (its phases run only under __main__)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- (a) the plain version is the JAX kernel's arithmetic ---------------------

@pytest.mark.parametrize("name, cfg, hw, filt, weight", SWEEP, ids=IDS)
def test_plain_matches_pallas_interpret_bit_for_bit(name, cfg, hw, filt,
                                                     weight):
    img, flt = _inputs(hw, filt)
    want = ref_pkg.make_conv2d(*hw, *filt, cfg, weight, interpret=True)(
        jnp.asarray(img, jnp.bfloat16), jnp.asarray(flt, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    got = make_conv2d(*hw, *filt, cfg, weight, dtype=torch.bfloat16)(
        _bf16(img), _bf16(flt))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == hw
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


# -- (b) the build's schedule -------------------------------------------------

@pytest.mark.parametrize("name, cfg, hw, filt, weight", SWEEP, ids=IDS)
def test_banded_schedule_equals_plain(name, cfg, hw, filt, weight):
    """In float32 on bfloat16 values the schedule and the plain version
    differ by the order of the float32 sum alone: at most Fh*Fw units of
    roundoff of the sum of |products|.  Rounded to bfloat16, they agree
    within the card's bound."""
    img, flt = (_bf16(x).float() for x in _inputs(hw, filt))
    banded = cvk.conv2d_banded(img, flt, cfg, weight)
    plain = conv2d_plain(img, flt, cfg, weight)
    magnitude = conv2d_plain(img.abs(), flt.abs(), cfg, abs(weight))
    bound = filt[0] * filt[1] * 2.0 ** -24 * magnitude
    assert ((banded - plain).abs() <= bound).all()
    smoke = _smoke()
    share, differ = smoke.conv_bf16_agreement(
        cvk.conv2d_banded(img.bfloat16(), flt.bfloat16(), cfg, weight),
        conv2d_plain(img.bfloat16(), flt.bfloat16(), cfg, weight))
    assert share <= 1.0 and differ <= smoke.CONV_BF16_DIFFER


@pytest.mark.parametrize("name, cfg, hw, filt, weight",
                         [SWEEP[0], SWEEP[5], SWEEP[7], SWEEP[12]],
                         ids=[IDS[0], IDS[5], IDS[7], IDS[12]])
def test_card_bound_catches_planted_faults(monkeypatch, name, cfg, hw, filt,
                                           weight):
    """``conv_bf16_agreement`` passes the schedule and fails, by more than
    100x its bound, a band shifted by one column and a staging origin that
    forgets the alignment the band absorbs (``band_offset``)."""
    smoke = _smoke()
    img, flt = (_bf16(x) for x in _inputs(hw, filt))
    plain = conv2d_plain(img, flt, cfg, weight)

    def agreement():
        return smoke.conv_bf16_agreement(
            cvk.conv2d_banded(img, flt, cfg, weight), plain)

    assert agreement()[0] <= 1.0
    band = cvk.band
    with monkeypatch.context() as m:
        m.setattr(cvk, "band",
                  lambda f: torch.nn.functional.pad(band(f), (1, 0))[..., :-1])
        assert agreement()[0] > 100
    with monkeypatch.context() as m:
        m.setattr(cvk, "staging_origin", lambda c0, Fw: c0 - Fw // 2)
        assert agreement()[0] > 100


def test_band_and_staging_origin():
    """The band of a filter row is the row slid one column a band row,
    starting band_offset columns in; the origin is 16-byte aligned."""
    flt = torch.arange(1.0, 12.0)[None, :]           # one 11-wide row
    b = cvk.band(flt)
    off, ks = cvk.band_offset(11), cvk.k_steps(11)
    assert (off, ks) == (3, 2) and b.shape == (1, 16, 32)
    for m in range(16):
        row = b[0, m]
        assert torch.equal(row[off + m:off + m + 11], flt[0])
        assert row.abs().sum() == flt.abs().sum()     # zeros elsewhere
    for fw in range(1, 40):
        off, ks = cvk.band_offset(fw), cvk.k_steps(fw)
        assert 0 <= off < 8 and (fw // 2 + off) % 8 == 0
        # the last column block's last tap stays inside its K columns
        assert off + 15 + fw - 1 < 16 * ks <= off + fw + 15 + 15
        for c0 in (0, 16, 256, 4096):
            s0 = cvk.staging_origin(c0, fw)
            assert s0 % 8 == 0 and c0 - fw // 2 - 8 < s0 <= c0 - fw // 2
    # two k-steps for every odd filter up to 17 wide
    assert {cvk.k_steps(f) for f in range(1, 18, 2)} == {1, 2}


# -- (c) the bfloat16 key and lookup ------------------------------------------

def test_bf16_key_is_its_own_and_float32_keeps_the_jax_key():
    assert ops.shape_key(4096, 4096, 3, 3, "bfloat16") == \
        "H4096_W4096_F3x3_bfloat16"
    assert ops.shape_key(4096, 4096, 3, 3, torch.bfloat16) == \
        ops.shape_key(4096, 4096, 3, 3, "bfloat16")
    want = ref_ops.shape_key(4096, 4096, 3, 3)
    assert ops.shape_key(4096, 4096, 3, 3) == want
    assert ops.shape_key(4096, 4096, 3, 3, torch.float32) == want
    assert ops._shape(64, 64, 3, 3) == {"H": 64, "W": 64, "Fh": 3, "Fw": 3}
    assert ops._shape(64, 64, 3, 3, torch.bfloat16)["dtype"] == "bfloat16"


def _entry(cfg, shape):
    return CacheEntry(config=dict(cfg), time_s=1e-3, strategy="annealing",
                      evaluations=1, timestamp=0.0, shape=dict(shape))


def test_conv2d_on_bf16_tensors_resolves_the_bf16_record(tmp_path):
    """One cache holds a float32 and a bfloat16 record at one shape; each
    lookup resolves its own, and conv2d() on bfloat16 tensors runs the
    bfloat16 one."""
    cache = TuningCache(str(tmp_path / "tuned.json"))
    f32_shape = {"H": 64, "W": 256, "Fh": 3, "Fw": 3}
    bf16_shape = dict(f32_shape, dtype="bfloat16")
    records = {"float32": dict(M, BLOCK_H=8, BLOCK_W=128, SUB_H=1,
                               UNROLL=False),
               "bfloat16": dict(M, BLOCK_H=32, BLOCK_W=256, SUB_H=2)}
    for name, shape in (("float32", f32_shape), ("bfloat16", bf16_shape)):
        assert records[name] in CONV2D.make_space(shape).enumerate()
        cache.put(CONV2D.name, CONV2D.key_for(shape), H100_SXM.name,
                  _entry(records[name], shape))
    assert set(cache.entries()) == {"conv2d|H64_W256_F3x3|h100_sxm",
                                    "conv2d|H64_W256_F3x3_bfloat16|h100_sxm"}
    for name, shape in (("float32", f32_shape), ("bfloat16", bf16_shape)):
        res = lookup_resolved(CONV2D, shape, profile=H100_SXM, cache=cache)
        assert res.provenance == "exact" and res.config == records[name]
        assert ops.lookup_config(64, 256, 3, 3, H100_SXM, cache,
                                 dtype=name) == records[name]
    img, flt = (_bf16(x) for x in _inputs((64, 256), (3, 3)))
    asked, built = [], []
    real_lookup, real_make = ops.lookup_config, ops.make_conv2d

    def spy_lookup(*a, **kw):
        asked.append(kw.get("dtype"))
        return real_lookup(*a, cache=cache, **{n: x for n, x in kw.items()
                                               if n != "cache"})

    def spy_make(*a, **kw):
        fn = real_make(*a, **kw)
        built.append((fn.config, fn.dtype))
        return fn

    ops.lookup_config, ops.make_conv2d = spy_lookup, spy_make
    try:
        got = conv2d(img, flt, profile=H100_SXM)
        conv2d(img.float(), flt.float(), profile=H100_SXM)
    finally:
        ops.lookup_config, ops.make_conv2d = real_lookup, real_make
    assert asked == [torch.bfloat16, torch.float32]
    assert built == [(dict(records["bfloat16"]), torch.bfloat16),
                     (dict(records["float32"]), torch.float32)]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, conv2d_plain(img, flt, records["bfloat16"]))


def test_transfer_borrows_only_from_its_own_dtype(tmp_path):
    """Under TRANSFER a bfloat16 shape borrows the nearest bfloat16 record
    and a float32 one (which names no dtype) the nearest float32 record,
    though the other dtype's lies nearer in size."""
    cache = TuningCache(str(tmp_path / "tuned.json"))
    f32_at = {"H": 256, "W": 256, "Fh": 3, "Fw": 3}
    bf16_at = {"H": 2048, "W": 2048, "Fh": 3, "Fw": 3, "dtype": "bfloat16"}
    configs = {"float32": dict(M, BLOCK_H=8, BLOCK_W=128, SUB_H=1),
               "bfloat16": dict(M, BLOCK_H=32, BLOCK_W=256, SUB_H=2)}
    for name, at in (("float32", f32_at), ("bfloat16", bf16_at)):
        cache.put(CONV2D.name, CONV2D.key_for(at), H100_SXM.name,
                  _entry(configs[name], at))
    for ask, want in (({"H": 2048, "W": 1024, "Fh": 3, "Fw": 3},
                       "float32"),
                      ({"H": 256, "W": 512, "Fh": 3, "Fw": 3,
                        "dtype": "bfloat16"}, "bfloat16")):
        res = lookup_resolved(CONV2D, ask, profile=H100_SXM, cache=cache,
                              policy="transfer")
        assert res.provenance == "transfer"
        assert {k: res.config[k] for k in configs[want]} == configs[want]


# -- (d) the bfloat16 build's geometry ----------------------------------------

@pytest.mark.parametrize("cfg, filt, want", [
    # the heuristic at 11x11: one row group, 8 of 16 column blocks a warp
    (dict(M, BLOCK_H=16, BLOCK_W=256, SUB_H=1), (11, 11),
     {"tile": (1, 8, 2), "threads": 128, "rows": 16,
      "smem": 2 * ((16 + 10) * 8 * (34 + 1) + 11 * 16 * 40 + 11 * 48),
      "regs": 4 * 8 + 4 * 2 + 32}),
    # SUB_H 4 of an 8-row block: one row group (BLOCK_H caps it)
    (dict(M, BLOCK_H=8, BLOCK_W=256, SUB_H=4), (3, 3),
     {"tile": (1, 8, 2), "threads": 64, "rows": 8,
      "smem": 2 * ((8 + 2) * 8 * (34 + 1) + 3 * 16 * 40 + 3 * 48),
      "regs": 4 * 8 + 4 * 2 + 32}),
    # two row groups a warp: 4 column blocks; PAD_W adds two chunks a row
    (dict(M, BLOCK_H=32, BLOCK_W=128, SUB_H=2, PAD_W=1), (7, 7),
     {"tile": (2, 4, 2), "threads": 128, "rows": 32,
      "smem": 2 * ((32 + 6) * 8 * (18 + 1 + 2) + 7 * 16 * 40 + 7 * 48),
      "regs": 4 * 8 + 4 * 2 + 32}),
    # four rows summed as a group of 8, the other four not stored
    (dict(M, BLOCK_H=4, BLOCK_W=64, SUB_H=4), (2, 5),
     {"tile": (1, 4, 2), "threads": 32, "rows": 8,
      "smem": 2 * ((8 + 1) * 8 * (10 + 1) + 2 * 16 * 40 + 2 * 48),
      "regs": 4 * 4 + 4 * 2 + 32}),
    # SUB_H 8 sums four row groups (the most), two column blocks a warp;
    # 18 wide: three k-steps
    (dict(M, BLOCK_H=64, BLOCK_W=256, SUB_H=8), (3, 18),
     {"tile": (4, 2, 3), "threads": 512, "rows": 64,
      "smem": 2 * ((64 + 2) * 8 * (36 + 1) + 3 * 16 * 56 + 3 * 64),
      "regs": 4 * 8 + 4 * 3 + 32}),
    # 40 rows: three warps of two row groups sum 48, 8 not stored
    (dict(M, BLOCK_H=40, BLOCK_W=64, SUB_H=2), (3, 3),
     {"tile": (2, 4, 2), "threads": 96, "rows": 48,
      "smem": 2 * ((48 + 2) * 8 * (10 + 1) + 3 * 16 * 40 + 3 * 48),
      "regs": 4 * 8 + 4 * 2 + 32}),
])
def test_bf16_warp_tile_threads_footprint_and_registers(cfg, filt, want):
    fh, fw = filt
    assert cvk.warp_tile(cfg, fh, fw) == want["tile"]
    assert cvk.micro_tile(cfg, fh, fw, 2) == want["tile"]
    assert cvk.block_threads(cfg, 2) == want["threads"]
    assert cvk.summed_rows(cfg) == want["rows"]
    assert cvk.smem_footprint(cfg, fh, fw, 2) == want["smem"]
    assert cvk.warp_registers(cfg, fh, fw) == want["regs"]
    cvk.validate_config(cfg, 256, 256, fh, fw, 2)
    # the rolled build shares it; the float32 build keeps its own
    rolled = dict(cfg, UNROLL=not cfg["UNROLL"])
    assert cvk.block_threads(rolled, 2) == want["threads"]
    assert cvk.smem_footprint(rolled, fh, fw, 2) == want["smem"]
    assert cvk.micro_tile(cfg, fh, fw) != want["tile"] or cfg["SUB_H"] == 1


def _owners(cfg, H, W, Fh, Fw):
    """Image output -> the (block, warp) that stores it, mapped the way the
    bfloat16 build maps warps: warp w of block (bx, by) sums row groups
    (w / WARPS_X) * RG + g and column blocks (w % WARPS_X) * NB + t, and
    stores rows under BLOCK_H inside the image.  Also checks that each
    tile's products read staged rows and columns only."""
    bh, bw = cfg["BLOCK_H"], cfg["BLOCK_W"]
    rg, nb, ks = cvk.warp_tile(cfg, Fh, Fw)
    warps_x = bw // 16 // nb
    rows = cvk.summed_rows(cfg)
    span = 16 * (bw // 16 + ks - 1)
    owners = {}
    for by in range(-(-H // bh)):
        for bx in range(-(-W // bw)):
            r0, c0 = by * bh, bx * bw
            for w in range(cvk.block_threads(cfg, 2) // 32):
                y0, t0 = (w // warps_x) * rg * 8, (w % warps_x) * nb
                for g in range(rg):
                    for t in range(nb):
                        # the tile's reads: rows y + i, columns 16 t + k
                        assert y0 + 8 * g + 7 + Fh - 1 < rows + Fh - 1
                        assert 16 * (t0 + t) + 16 * ks <= span
                        for n in range(8):
                            y = y0 + 8 * g + n
                            for m in range(16):
                                x = 16 * (t0 + t) + m
                                if y < bh and r0 + y < H and c0 + x < W:
                                    owners.setdefault(
                                        (r0 + y, c0 + x), []).append(
                                            (by, bx, w))
    return owners


@pytest.mark.parametrize("cfg", CONFIGS + [
    dict(M, BLOCK_H=4, BLOCK_W=64, SUB_H=4),
    dict(M, BLOCK_H=64, BLOCK_W=256, SUB_H=8),
    dict(M, BLOCK_H=40, BLOCK_W=64, SUB_H=2),
    dict(M, BLOCK_H=16, BLOCK_W=1024, SUB_H=2)])
def test_every_output_has_exactly_one_owner(cfg):
    H, W, Fh, Fw = 37, 1031, 11, 11         # odd, ragged at both edges
    owners = _owners(cfg, H, W, Fh, Fw)
    assert set(owners) == {(r, c) for r in range(H) for c in range(W)}
    assert all(len(o) == 1 for o in owners.values())


def test_bf16_build_refuses_what_the_mma_cannot_tile():
    # BLOCK_W 100 is no whole number of mma column blocks: the bfloat16
    # build sums 7 blocks of 16 (the 12 columns past BLOCK_W summed and
    # not stored), as the float32 build takes it
    cfg = dict(M, BLOCK_H=16, BLOCK_W=100, SUB_H=1)
    make_conv2d(64, 256, 3, 3, cfg)
    fn = make_conv2d(64, 256, 3, 3, cfg, dtype=torch.bfloat16)
    assert cvk.column_blocks(cfg) == 7
    rg, nb, ks = cvk.warp_tile(cfg, 3, 3)
    assert (rg, nb) == (1, 7) and cvk.block_threads(cfg, 2) == 32 * 2
    stride = 8 * (2 * (7 + ks - 1) + 1)
    assert cvk.smem_footprint(cfg, 3, 3, 2) == 2 * (
        (16 + 2) * stride + 3 * 16 * (16 * ks + 8) + 3 * (16 * ks + 16))
    # the plain version equals the JAX package's kernel there, and the
    # build's schedule (conv2d_banded) sums what it sums
    rng = np.random.default_rng(3)
    img = rng.normal(size=(64, 256)).astype(np.float32)
    flt = rng.normal(size=(3, 3)).astype(np.float32)
    want = ref_pkg.make_conv2d(64, 256, 3, 3, cfg, interpret=True)(
        jnp.asarray(img, jnp.bfloat16), jnp.asarray(flt, jnp.bfloat16))
    ti, tf = torch.from_numpy(img).bfloat16(), torch.from_numpy(flt).bfloat16()
    got = fn(ti, tf)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    smoke = _smoke()
    share, differ = smoke.conv_bf16_agreement(cvk.conv2d_banded(ti, tf, cfg),
                                              got)
    assert share <= 1.0 and differ <= smoke.CONV_BF16_DIFFER
    with pytest.raises(ValueError, match="at most 1024"):
        make_conv2d(64, 256, 3, 3, dict(M, BLOCK_H=128, BLOCK_W=1024,
                                         SUB_H=8), dtype=torch.bfloat16)
    # 'xla' builds nothing, in either type
    make_conv2d(64, 256, 3, 3, dict(cfg, HALO_MODE="xla"),
                dtype=torch.bfloat16)
    assert math.isinf(cvk.analytical_time(
        dict(M, BLOCK_H=128, BLOCK_W=1024, SUB_H=8), H100_SXM, 4096, 4096,
        3, 3, elt_bytes=2))


@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("filt", [(3, 3), (7, 7), (11, 11)])
def test_bf16_space_constraints_follow_the_dtype(extended, filt):
    fh, fw = filt
    bf16 = {"H": 8192, "W": 4096, "Fh": fh, "Fw": fw, "dtype": "bfloat16"}
    f32 = {k: v for k, v in bf16.items() if k != "dtype"}
    configs = CONV2D.make_space(bf16, extended=extended).enumerate()
    for c in configs:
        if c["HALO_MODE"] == "xla":
            continue
        threads = cvk.block_threads(c, 2)
        assert threads <= 1024 and threads % 32 == 0
        assert c["BLOCK_W"] % 16 == 0
        assert cvk.smem_footprint(c, fh, fw, 2) <= \
            H100_SXM.smem_per_block_optin
        assert cvk.warp_registers(c, fh, fw) <= min(
            255, H100_SXM.regs_per_sm // threads)
        assert CONV2D.smem_footprint(bf16, c) == \
            cvk.smem_footprint(c, fh, fw, 2)
        assert CONV2D.block_threads(bf16, c) == threads
        assert CONV2D.register_estimate(bf16, c) == \
            cvk.warp_registers(c, fh, fw)
        assert math.isfinite(CONV2D.analytical_model(bf16, c, H100_SXM))
    # the heuristic is feasible in bfloat16, as conv2d(config=None)
    # resolves it at 8192 x 4096
    heur = dict(heuristic_config(8192, 4096, fh, fw),
                **({"PAD_W": 0, "PIPELINE_DEPTH": 2} if extended else {}))
    assert heur in configs
    # the float32 space is the float32 build's, as before
    params, constraints = tuning_space(extended)
    assert tuning_space(extended, 2)[0] == params
    assert CONV2D.make_space(f32, extended=extended).enumerate() == \
        CONV2D.make_space(dict(f32, dtype="float32"),
                          extended=extended).enumerate()
    if extended:
        # the constraints are the dtype's: the 2-byte tile takes blocks the
        # float32 tile cannot, and the warps' registers refuse others
        f32_configs = CONV2D.make_space(f32, extended=True).enumerate()
        assert any(c not in f32_configs for c in configs)
        assert any(c not in configs for c in f32_configs)


@pytest.mark.parametrize("f", [3, 7, 11])
def test_bf16_model_prices_the_tensor_cores(f):
    cfg = heuristic_config(8192, 4096, f, f)
    flops = cvk.conv_flops(8192, 4096, f, f)
    t2 = cvk.analytical_time(cfg, H100_SXM, 8192, 4096, f, f, elt_bytes=2)
    t4 = cvk.analytical_time(cfg, H100_SXM, 8192, 4096, f, f)
    useful = f / (16 * cvk.k_steps(f))
    assert t2 >= flops / (H100_SXM.peak_bf16_tensor_flops * useful)
    assert t2 >= 2 * 8192 * 4096 * 2 / H100_SXM.hbm_bw
    # the FMA build's price is the float32 rate's, above the tensor cores'
    assert t4 > t2
    assert CONV2D.analytical_model(
        {"H": 8192, "W": 4096, "Fh": f, "Fw": f, "dtype": "bfloat16"}, cfg,
        H100_SXM) == t2


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
    with open(cvk.SOURCE) as f:
        src = f.read()
    bf16, f32 = (_code(b) for b in _branches(src, "IN_BF16"))
    # the bfloat16 body: ldmatrix-fed mma.sync with float32 sums, 16-byte
    # cp.async staging of bfloat16, the band's constants the models'
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in bf16
    assert re.search(r"ldmatrix\.sync\.aligned\.m8n8\.x4\.shared", bf16)
    assert "cp.async.cg.shared.global [%0], [%1], 16, %2" in bf16
    assert "OFF = (8 - (FW / 2) % 8) % 8" in bf16
    assert "KS = (OFF + FW + 15 + 15) / 16" in bf16
    assert f"MAX_TILES = {cvk.MAX_WARP_TILES};" in bf16
    assert f"MAX_RG = {cvk.MAX_ROW_GROUPS};" in bf16
    # ... and none of the FMA route: no widening to float32, no fmaf
    for word in ("fmaf", "to_f32", "__bfloat162float", "cp_async4",
                 "load_vec"):
        assert not re.search(rf"\b{re.escape(word)}", bf16), word
    # the float32 body stays on the FMA units, with no bfloat16 in it
    assert "fmaf" in f32 and "cp_async4" in f32
    assert "mma" not in f32 and "__nv_bfloat16" not in f32
