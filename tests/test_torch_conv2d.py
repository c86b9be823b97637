"""The port's conv2d (plain version, on the CPU) against the JAX package's
Pallas conv2d in interpret mode, on the same inputs.

The tolerance is the JAX package's own conv2d tests' (1e-4).  The CUDA
kernel itself runs only on the card (see ``chip_smoke.py``); here its
wrapper, its space and its model are checked.
"""

import importlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.kernels.conv2d as ref_pkg  # noqa: E402
from repro.kernels.conv2d import ops as ref_ops  # noqa: E402
from repro_torch.core import (H100_SXM, AnalyticalEvaluator,  # noqa: E402
                              SearchSpace, TuningCache, lookup_resolved)
from repro_torch.kernels.conv2d import (  # noqa: E402
    CONV2D, analytical_time, block_threads, conv2d, conv2d_plain,
    conv2d_reference, conv_bytes, conv_flops, heuristic_config, make_conv2d,
    micro_tile, shape_key, smem_footprint, tuning_space, validate_config)
from repro_torch.kernels.conv2d import ops as port_ops  # noqa: E402
from repro_torch.tune import tune_kernel  # noqa: E402

# the kernel's module (the package's ``conv2d`` is the op)
port_kernel = importlib.import_module("repro_torch.kernels.conv2d.conv2d")

TOL = 1e-4

#: the configs tests/test_kernels_conv2d.py sweeps
CONFIGS = [
    {"BLOCK_H": 16, "BLOCK_W": 128, "SUB_H": 1, "UNROLL": True,
     "HALO_MODE": "materialize"},
    {"BLOCK_H": 32, "BLOCK_W": 128, "SUB_H": 2, "UNROLL": False,
     "HALO_MODE": "materialize"},
    {"BLOCK_H": 8, "BLOCK_W": 256, "SUB_H": 4, "UNROLL": True,
     "HALO_MODE": "materialize"},
    {"BLOCK_H": 16, "BLOCK_W": 128, "SUB_H": 1, "UNROLL": True,
     "HALO_MODE": "xla"},
]


def _data(H, W, Fh, Fw, seed=1):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(H, W)).astype(np.float32)
    flt = rng.normal(size=(Fh, Fw)).astype(np.float32)
    return img, flt


def _compare(H, W, Fh, Fw, cfg, weight=1.0):
    img, flt = _data(H, W, Fh, Fw)
    want = ref_pkg.make_conv2d(H, W, Fh, Fw, cfg, weight=weight,
                               interpret=True)(jnp.asarray(img),
                                               jnp.asarray(flt))
    got = make_conv2d(H, W, Fh, Fw, cfg, weight=weight)(
        torch.from_numpy(img), torch.from_numpy(flt))
    assert got.shape == (H, W) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    return got


@pytest.mark.parametrize("filt", [(3, 3), (7, 7), (11, 11)])
@pytest.mark.parametrize("cfg", CONFIGS)
def test_plain_matches_pallas_interpret(filt, cfg):
    _compare(64, 256, *filt, cfg)


def test_non_divisible_image():
    _compare(50, 200, 7, 7, CONFIGS[0])


def test_weight_factor():
    _compare(32, 128, 3, 3, CONFIGS[0], weight=2.5)


@pytest.mark.parametrize("filt", [(4, 4), (2, 5)])
@pytest.mark.parametrize("cfg", [CONFIGS[0], CONFIGS[3]])
def test_even_filters_pad_asymmetrically(filt, cfg):
    _compare(64, 256, *filt, cfg)


@pytest.mark.parametrize("filt", [(3, 3), (4, 4), (2, 5), (11, 11)])
def test_oracle_matches_the_jax_oracle(filt):
    img, flt = _data(50, 200, *filt)
    want = ref_pkg.conv2d_reference(jnp.asarray(img), jnp.asarray(flt),
                                    weight=2.5)
    got = conv2d_reference(torch.from_numpy(img), torch.from_numpy(flt),
                           weight=2.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    # and the plain version, tap by tap, agrees with both
    plain = conv2d_plain(torch.from_numpy(img), torch.from_numpy(flt),
                         weight=2.5)
    np.testing.assert_allclose(plain.numpy(), got.numpy(),
                               rtol=TOL, atol=TOL)


def test_names_keys_and_heuristic_match_the_jax_package():
    assert port_ops.KERNEL_NAME == ref_ops.KERNEL_NAME == CONV2D.name
    for shape in [(4096, 4096, 3, 3), (8192, 4096, 11, 11), (50, 200, 4, 4)]:
        assert shape_key(*shape) == ref_ops.shape_key(*shape)
        assert heuristic_config(*shape) == ref_ops.heuristic_config(*shape)
    assert CONV2D.defaults == ref_ops.CONV2D.defaults
    assert CONV2D.default_shapes == ref_ops.CONV2D.default_shapes
    # the evaluator's inputs are the JAX package's draws
    s = {"H": 32, "W": 64, "Fh": 3, "Fw": 5}
    got = CONV2D.make_args(s, np.random.default_rng(3))
    want = ref_ops.CONV2D.make_args(s, np.random.default_rng(3))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _h100_ok(cfg, Fh, Fw):
    return (block_threads(cfg) <= 1024
            and smem_footprint(cfg, Fh, Fw) <= H100_SXM.smem_per_block_optin)


@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("filt", [(3, 3), (11, 11)])
def test_space_is_the_jax_space_minus_what_the_card_cannot_run(extended,
                                                               filt):
    shape = {"H": 4096, "W": 4096, "Fh": filt[0], "Fw": filt[1]}
    want = [c for c in ref_ops.CONV2D.make_space(shape, extended=extended)
            .enumerate() if _h100_ok(c, *filt)]
    got = CONV2D.make_space(shape, extended=extended).enumerate()
    assert got == want
    # the compact space fits the card whole; the extended one does not
    ref_all = ref_ops.CONV2D.make_space(shape, extended=extended).enumerate()
    assert (len(got) < len(ref_all)) == extended
    assert {c["HALO_MODE"] for c in got} == {"materialize", "xla"}
    for c in got:
        validate_config(c, 4096, 4096, *filt)


def test_tune_record_lookup_run_on_cpu(tmp_path, monkeypatch):
    path = str(tmp_path / "tuned.json")
    monkeypatch.setenv("REPRO_TUNE_CACHE", path)
    shape = {"H": 64, "W": 256, "Fh": 3, "Fw": 3}
    outcome = tune_kernel(CONV2D, shape, strategy="annealing", budget=12,
                          evaluator=AnalyticalEvaluator(profile=H100_SXM),
                          profile=H100_SXM, cache=TuningCache(path))
    best = outcome.result.best
    assert best is not None and math.isfinite(best.time)
    assert outcome.failure_summary["failed_trials"] == 0
    res = lookup_resolved(CONV2D, shape, profile=H100_SXM,
                          cache=TuningCache(path))
    assert res.provenance == "exact" and res.config == best.config
    # the op's own lookup (default cache) serves the tuned config
    assert port_ops.lookup_config(64, 256, 3, 3,
                                  profile=H100_SXM) == res.config
    img, flt = _data(64, 256, 3, 3, seed=5)
    got = conv2d(torch.from_numpy(img), torch.from_numpy(flt),
                 profile=H100_SXM)
    want = ref_pkg.make_conv2d(64, 256, 3, 3, res.config, interpret=True)(
        jnp.asarray(img), jnp.asarray(flt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    # more threads than a block may have: 64 rows of single-row threads
    with pytest.raises(ValueError):
        make_conv2d(256, 256, 3, 3, {"BLOCK_H": 64, "BLOCK_W": 128,
                                     "SUB_H": 1})
    with pytest.raises(ValueError):
        make_conv2d(64, 256, 3, 3, {"BLOCK_H": 16, "SUB_H": 3})
    with pytest.raises(ValueError):
        make_conv2d(64, 256, 3, 3, {"HALO_MODE": "cudnn"})
    fn = make_conv2d(64, 256, 3, 3)
    img, f = torch.zeros(64, 256), torch.zeros(3, 3)
    with pytest.raises(ValueError):          # wrong shape
        fn(img, torch.zeros(5, 5))
    with pytest.raises(ValueError):          # wrong dtype
        fn(img.double(), f.double())
    with pytest.raises(ValueError):          # no kernel for this device
        fn(img.to("meta"), f.to("meta"))


def test_thread_geometry_and_footprint():
    assert block_threads(CONFIGS[0]) == 32 * 16
    assert block_threads(CONFIGS[2]) == 128 * 2
    assert block_threads(CONFIGS[3]) == 0
    # tile rows: the 128 + 2 columns the windows read, rounded up to 8,
    # plus PAD_W quads; filter rows rounded up to a quad
    assert smem_footprint(CONFIGS[0], 3, 3) == 4 * (18 * 136 + 3 * 4)
    assert smem_footprint({**CONFIGS[0], "PAD_W": 1}, 3, 3) == \
        4 * (18 * 140 + 3 * 4)
    assert smem_footprint(CONFIGS[3], 11, 11) == 0
    # the JAX heuristic at 11x11: 8 adjacent columns a thread, one group
    assert micro_tile(heuristic_config(8192, 4096, 11, 11), 11, 11) == \
        (1, 8, 1)
    assert micro_tile(CONFIGS[2], 3, 3) == (4, 2, 1)
    # four rows of 4 columns: 4 * (4 + 8) + 8 = 56 registers fit 64
    assert micro_tile({**CONFIGS[0], "BLOCK_H": 64, "SUB_H": 4}, 3, 3) == \
        (4, 4, 1)


def _space_configs(extended, filt):
    shape = {"H": 4096, "W": 4096, "Fh": filt[0], "Fw": filt[1]}
    return [c for c in CONV2D.make_space(shape, extended=extended).enumerate()
            if c["HALO_MODE"] == "materialize"]


@pytest.mark.parametrize("extended", [False, True])
@pytest.mark.parametrize("filt", [(3, 3), (11, 11)])
def test_micro_tile_covers_the_block_within_the_register_cap(extended, filt):
    fh, fw = filt
    for c in _space_configs(extended, filt):
        rows, cols, groups = micro_tile(c, fh, fw)
        _, tx, _ = port_kernel.row_geometry(c)
        assert rows == c["SUB_H"]
        assert cols * groups * tx == c["BLOCK_W"], c
        assert 1 <= cols <= port_kernel.MAX_GROUP_COLS
        regs = rows * (cols + port_kernel._window(cols, fw)) + 8
        assert regs == port_kernel.register_estimate(c, fw, cols)
        # one column is the narrowest tile: eight rows of 11x11 windows
        # overflow 64 registers whatever the width
        assert regs <= port_kernel.REGISTERS or cols == 1, (c, regs)
        # a wider group would not fit: the widest that does is taken
        wider = [w for w in range(cols + 1, port_kernel.MAX_GROUP_COLS + 1)
                 if (c["BLOCK_W"] // tx) % w == 0]
        assert all(port_kernel.register_estimate(c, fw, w)
                   > port_kernel.REGISTERS for w in wider), c


def _owners(cfg, H, W, Fh, Fw):
    """Image output -> the (block, thread) that stores it, mapped the way
    csrc/conv2d.cu maps threads: thread (tx, ty) of block (bx, by) sums
    rows ty*SUB_H + s and, in group g, columns g*CG*TX + tx*CG + k of the
    tile, and stores those under BLOCK_W and inside the image.  Also
    checks each window's alignment and that it stays in its tile row."""
    bh, bw, sub = cfg["BLOCK_H"], cfg["BLOCK_W"], cfg["SUB_H"]
    ty_n, tx_n, _ = port_kernel.row_geometry(cfg)
    rows, cols, groups = micro_tile(cfg, Fh, Fw)
    vec = port_kernel._vec(cols)
    row_len = ((smem_footprint({**cfg, "PAD_W": 0}, Fh, Fw) // 4
                - Fh * -(-Fw // 4) * 4) // (bh + Fh - 1))
    owners = {}
    for by in range(-(-H // bh)):
        for bx in range(-(-W // bw)):
            r0, c0 = by * bh, bx * bw
            lim = min(W, c0 + bw)
            for tid in range(block_threads(cfg)):
                tx, ty = tid % tx_n, tid // tx_n
                for g in range(groups):
                    cs = g * cols * tx_n + tx * cols
                    assert cs % vec == 0
                    assert cs + port_kernel._window(cols, Fw) <= row_len
                    for s in range(rows):
                        gr = r0 + ty * sub + s
                        for k in range(cols):
                            gc = c0 + cs + k
                            if gr < H and gc < lim:
                                owners.setdefault((gr, gc), []).append(
                                    (by, bx, tid))
    return owners


@pytest.mark.parametrize("cfg", [
    CONFIGS[0], CONFIGS[1], CONFIGS[2],
    # 12 and 6 rows: 4 and 3 row groups, so 64 and 85 threads a row, which
    # leave 96 and 100 columns owned unevenly (2 a thread, the rest unstored)
    {"BLOCK_H": 12, "BLOCK_W": 96, "SUB_H": 3, "UNROLL": True,
     "HALO_MODE": "materialize"},
    {"BLOCK_H": 6, "BLOCK_W": 100, "SUB_H": 2, "UNROLL": False,
     "HALO_MODE": "materialize"},
    {"BLOCK_H": 8, "BLOCK_W": 1024, "SUB_H": 1, "UNROLL": True,
     "HALO_MODE": "materialize"}])
def test_every_output_has_exactly_one_owner(cfg):
    H, W, Fh, Fw = 37, 1031, 11, 11         # odd, ragged at both edges
    owners = _owners(cfg, H, W, Fh, Fw)
    assert set(owners) == {(r, c) for r in range(H) for c in range(W)}
    assert all(len(o) == 1 for o in owners.values())


@pytest.mark.parametrize("filt", [(3, 3), (7, 7), (11, 11)])
def test_rolled_and_unrolled_builds_share_their_geometry(filt):
    for c in _space_configs(True, filt):
        if not c["UNROLL"]:
            continue
        rolled = {**c, "UNROLL": False}
        assert block_threads(rolled) == block_threads(c)
        assert smem_footprint(rolled, *filt) == smem_footprint(c, *filt)
        assert micro_tile(rolled, *filt) == micro_tile(c, *filt)


def test_model_shows_the_cliffs_and_the_bounds():
    H, W = 8192, 4096
    ok = {"BLOCK_H": 32, "BLOCK_W": 256, "SUB_H": 2, "UNROLL": True,
          "HALO_MODE": "materialize"}
    too_wide = {**ok, "BLOCK_H": 128, "BLOCK_W": 1024, "SUB_H": 8}
    too_many = {**ok, "BLOCK_H": 64, "SUB_H": 1}
    assert math.isfinite(analytical_time(ok, H100_SXM, H, W, 11, 11))
    assert math.isinf(analytical_time(too_wide, H100_SXM, H, W, 11, 11))
    assert math.isinf(analytical_time(too_many, H100_SXM, H, W, 3, 3))
    for f in (3, 11):
        floor = max(conv_flops(H, W, f, f) / H100_SXM.peak_f32_flops,
                    conv_bytes(H, W) / H100_SXM.hbm_bw)
        assert analytical_time(ok, H100_SXM, H, W, f, f) >= floor
    # rolled taps cost more than unrolled ones at 11x11
    assert analytical_time({**ok, "UNROLL": False}, H100_SXM, H, W, 11, 11) \
        > analytical_time(ok, H100_SXM, H, W, 11, 11)


def test_flops_and_bytes_formulas():
    assert conv_flops(8192, 4096, 3, 3) == ref_pkg.conv_flops(8192, 4096, 3, 3)
    assert conv_bytes(8192, 4096) == ref_pkg.conv_bytes(8192, 4096)


def test_compact_space_fits_the_card():
    params, constraints = tuning_space()
    sp = SearchSpace()
    for n, v in params.items():
        sp.add_parameter(name=n, values=v)
    for fn, names, label in constraints:
        sp.add_constraint(fn, names, label)
    for c in sp.enumerate():
        assert block_threads(c) <= 1024
        assert smem_footprint(c, 11, 11) <= H100_SXM.smem_per_block_optin


def test_legacy_delegates_search_the_extended_space(tmp_path):
    t = port_ops.make_tuner(64, 256, 3, 3, profile=H100_SXM)
    assert isinstance(t.evaluator, AnalyticalEvaluator)
    assert "PAD_W" in t.space.names
    out = port_ops.tune_conv2d(64, 256, 3, 3, budget=6, profile=H100_SXM,
                               cache=TuningCache(str(tmp_path / "c.json")))
    assert out.best_config is not None and "PAD_W" in out.best_config
