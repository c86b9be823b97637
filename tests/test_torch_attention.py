"""The port's flash attention (plain version, on the CPU) against the JAX
package's Pallas flash attention in interpret mode, on the same inputs.

Tolerances are the JAX package's own attention tests' (2e-5 for float32)
and its bf16 tolerance (3e-2).  The CUDA kernel itself runs only on the
card (see ``chip_smoke.py``); here its wrapper, its space and its model
are checked.
"""

import math

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.kernels.attention as ref_pkg  # noqa: E402
from repro.kernels.attention import ops as ref_ops  # noqa: E402
from repro_torch.core import (H100_SXM, AnalyticalEvaluator,  # noqa: E402
                              TuningCache, lookup_resolved)
from repro_torch.kernels.attention import (  # noqa: E402
    FLASH_ATTENTION, analytical_time, attention_flops, attention_reference,
    block_threads, flash_attention, flash_plain, geometry, heuristic_config,
    kv_end, kv_steps, make_flash_attention, shape_key, smem_footprint,
    tuning_space, validate_config)
from repro_torch.kernels.attention.flash import (  # noqa: E402
    tile as port_tile)
from repro_torch.kernels.attention.ref import NEG  # noqa: E402
from repro_torch.kernels.attention import ops as port_ops  # noqa: E402
from repro_torch.tune import tune_kernel  # noqa: E402

TOL = 2e-5
BF16_TOL = 3e-2


def _qkv(lead, sq, sk, d, seed=2):
    rng = np.random.default_rng(seed)
    def mk(s):
        return (rng.normal(size=lead + s) * 0.5).astype(np.float32)
    return mk((sq, d)), mk((sk, d)), mk((sk, d))


def _compare(sq, sk, d, cfg, causal, dtype="float32", tol=TOL):
    q, k, v = _qkv((), sq, sk, d)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = ref_pkg.make_flash_attention(
        sq, sk, d, cfg, causal=causal, dtype=jdt, interpret=True)(
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    got = make_flash_attention(sq, sk, d, cfg, causal=causal, dtype=tdt)(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)))
    assert got.shape == (sq, d) and got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    return got, (q, k, v)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("cfg", [
    {"BLOCK_Q": 128, "BLOCK_K": 128},
    {"BLOCK_Q": 64, "BLOCK_K": 256},
])
def test_plain_matches_pallas_interpret(causal, cfg):
    _compare(256, 256, 64, cfg, causal)


def test_prefix_cache_alignment():
    """Sq < Sk: query block ends align with KV end (decode prefill)."""
    _compare(128, 512, 64, {"BLOCK_Q": 64, "BLOCK_K": 128}, True)


@pytest.mark.parametrize("cfg", [{"BLOCK_Q": 64, "BLOCK_K": 64},
                                 {"BLOCK_Q": 128, "BLOCK_K": 32}])
def test_fully_masked_rows_return_the_mean_of_v(cfg):
    """Sq > Sk causal: the first Sq - Sk rows see no key; the finite mask
    gives them the mean of v, as in the JAX package."""
    got, (_, _, v) = _compare(512, 128, 64, cfg, True)
    assert torch.isfinite(got).all()
    mean_v = torch.from_numpy(v).mean(dim=0)
    torch.testing.assert_close(got[:512 - 128],
                               mean_v.expand(512 - 128, 64),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_inputs(causal):
    _compare(256, 256, 64, {"BLOCK_Q": 64, "BLOCK_K": 128}, causal,
             dtype="bfloat16", tol=BF16_TOL)


def test_batched_multihead_wrapper():
    q, k, v = _qkv((2, 4), 128, 128, 64)
    cfg = {"BLOCK_Q": 64, "BLOCK_K": 64}
    want = ref_pkg.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True, config=cfg,
                                   interpret=True)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=True, config=cfg)
    assert got.shape == (2, 4, 128, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bq,bk,d", [(64, 64, 64), (128, 256, 64),
                                     (64, 128, 128), (128, 64, 128)])
def test_block_sweep(bq, bk, d):
    _compare(256, 256, d, {"BLOCK_Q": bq, "BLOCK_K": bk}, True)


def test_invalid_blocks_rejected():
    with pytest.raises(ValueError):
        make_flash_attention(256, 256, 64, {"BLOCK_Q": 100, "BLOCK_K": 128})
    # 4 query rows are not whole warps of row groups: the build takes the
    # block on a tile of 8 rows (32 threads), the rows past it zeros and
    # not stored, and its plain version equals the JAX kernel
    cfg = {"BLOCK_Q": 4, "BLOCK_K": 128}
    assert port_tile(cfg, 64) == (8, 128, 64)
    assert block_threads(cfg, 64) == 32
    assert geometry(cfg, 64) == {"TM": 4, "TK": 16, "TN": 8, "TD": 4,
                                 "threads": 32}
    _compare(256, 256, 64, cfg, True)
    with pytest.raises(ValueError):          # 1024 threads
        make_flash_attention(512, 256, 64, {"BLOCK_Q": 512, "BLOCK_K": 128})
    with pytest.raises(ValueError):
        make_flash_attention(256, 256, 64, dtype=torch.float16)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    fn = make_flash_attention(128, 128, 64)
    q = torch.zeros(128, 64)
    with pytest.raises(ValueError):          # wrong shape
        fn(q, torch.zeros(64, 64), torch.zeros(64, 64))
    with pytest.raises(ValueError):          # leading dims differ
        fn(q[None], q, q)
    with pytest.raises(ValueError):          # wrong dtype
        fn(q.bfloat16(), q.bfloat16(), q.bfloat16())
    with pytest.raises(ValueError):          # no kernel for this device
        fn(q.to("meta"), q.to("meta"), q.to("meta"))


@pytest.mark.parametrize("causal,sq,sk", [(True, 256, 256),
                                          (False, 256, 256),
                                          (True, 384, 128)])
def test_oracle_and_plain_match_the_jax_oracle(causal, sq, sk):
    q, k, v = _qkv((), sq, sk, 64, seed=4)
    want = ref_pkg.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=causal)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    for got in (attention_reference(tq, tk, tv, causal=causal),
                flash_plain(tq, tk, tv, {"BLOCK_K": 32}, causal=causal)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL, atol=TOL)


def test_names_and_keys_match_the_jax_package():
    assert port_ops.KERNEL_NAME == ref_ops.KERNEL_NAME == FLASH_ATTENTION.name
    for shape in [(4096, 4096, 128, True), (128, 512, 64, False)]:
        assert shape_key(*shape) == ref_ops.shape_key(*shape)
    assert FLASH_ATTENTION.default_shapes == \
        ref_ops.FLASH_ATTENTION.default_shapes
    assert attention_flops(4096, 4096, 128) == \
        ref_pkg.attention_flops(4096, 4096, 128)
    s = {"Sq": 64, "Sk": 32, "D": 16, "causal": True}
    got = FLASH_ATTENTION.make_args(s, np.random.default_rng(3))
    want = ref_ops.FLASH_ATTENTION.make_args(s, np.random.default_rng(3))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_space_fits_the_card_and_keeps_the_names():
    ref_params, _ = ref_ops.tuning_space()
    params, _ = tuning_space(128)
    assert list(params) == list(ref_params)
    shape = {"Sq": 4096, "Sk": 4096, "D": 128, "causal": True}
    configs = FLASH_ATTENTION.make_space(shape).enumerate()
    # the K/V ring (PIPELINE_DEPTH stages), the register tiles and blocks
    # of 4 to 16 whole warps leave 7 of the 50 points
    assert len(configs) == 7
    assert {c["PIPELINE_DEPTH"] for c in configs} == {2, 3}
    assert {(c["BLOCK_Q"], c["BLOCK_K"]) for c in configs} == {
        (32, 64), (64, 32), (64, 64), (128, 32)}
    for c in configs:
        assert 128 <= block_threads(c, 128) <= 512
        assert block_threads(c, 128) % 32 == 0
        assert smem_footprint(c, 128) <= H100_SXM.smem_per_block_optin
        assert math.isfinite(analytical_time(c, H100_SXM, 4096, 4096, 128))
    # every JAX block pair at D = 128 needs more than a block's memory
    assert all(smem_footprint({"BLOCK_Q": bq, "BLOCK_K": bk}, 128)
               > H100_SXM.smem_per_block_optin
               for bq in ref_params["BLOCK_Q"] if bq >= 512
               for bk in ref_params["BLOCK_K"])


@pytest.mark.parametrize("sq,sk,d", [(4096, 4096, 128), (128, 512, 64),
                                     (96, 48, 256)])
def test_heuristic_divides_fits_and_is_in_the_lists(sq, sk, d):
    cfg = heuristic_config(sq, sk, d)
    params, _ = tuning_space(d)
    assert cfg["BLOCK_Q"] in params["BLOCK_Q"]
    assert cfg["BLOCK_K"] in params["BLOCK_K"]
    assert sq % cfg["BLOCK_Q"] == 0 and sk % cfg["BLOCK_K"] == 0
    assert smem_footprint(cfg, d) <= H100_SXM.smem_per_block_optin
    assert cfg["PIPELINE_DEPTH"] in params["PIPELINE_DEPTH"]


def test_model_shows_the_cliff_and_the_flop_floor():
    ok = {"BLOCK_Q": 64, "BLOCK_K": 64}
    t = analytical_time(ok, H100_SXM, 4096, 4096, 128)
    # the kernel skips the causal blocks, so the floor is the causal work
    assert t >= (attention_flops(4096, 4096, 128, causal=True)
                 / H100_SXM.peak_f32_flops)
    assert math.isinf(analytical_time({"BLOCK_Q": 128, "BLOCK_K": 128},
                                      H100_SXM, 4096, 4096, 128))
    assert math.isinf(analytical_time(ok, H100_SXM, 4000, 4096, 128))


SKIP_BLOCKS = [(16, 16), (32, 64), (64, 32), (64, 64), (128, 128)]


@pytest.mark.parametrize("sq,sk", [(512, 512), (128, 512), (512, 128)])
@pytest.mark.parametrize("bq,bk", SKIP_BLOCKS)
def test_causal_skip_rule_against_a_brute_force_mask(sq, sk, bq, bk):
    """No query block drops a visible key, and every KV block it drops is
    fully masked for all its rows (Sq = Sk, the prefix Sq < Sk, and
    Sq > Sk with rows that see no key)."""
    cfg = {"BLOCK_Q": bq, "BLOCK_K": bk}
    visible = (np.arange(sq)[:, None] + (sk - sq)) >= np.arange(sk)[None, :]
    for q0 in range(0, sq, bq):
        end = kv_end(q0, cfg, sq, sk, causal=True)
        assert end % bk == 0 and 0 < end <= sk
        rows = visible[q0:q0 + bq]
        assert not rows[:, end:].any(), "a visible key was dropped"
        if not rows.any(axis=1).all():
            assert end == sk, "rows that see no key must visit every block"
        # the rule is tight: the last visited block holds a visible key
        assert rows[:, end - bk:end].any() or end == sk
        assert kv_end(q0, cfg, sq, sk, causal=False) == sk
    assert kv_steps(cfg, sq, sk, causal=False) == (sq // bq) * (sk // bk)


def _online_softmax(q, k, v, q0, bk, sq, sk, k_stop):
    """The kernel's loop for one query block, over the keys below k_stop."""
    scale = q.shape[-1] ** -0.5
    m = torch.full((q.shape[0], 1), NEG)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q)
    q_pos = torch.arange(q0, q0 + q.shape[0])[:, None] + (sk - sq)
    for k0 in range(0, k_stop, bk):
        s = (q @ k[k0:k0 + bk].T) * scale
        s = torch.where(q_pos >= torch.arange(k0, k0 + bk)[None, :], s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p @ v[k0:k0 + bk]
        m = m_new
    return acc / l.clamp_min(1e-30)


@pytest.mark.parametrize("sq,sk,bq,bk", [(256, 256, 64, 32),
                                         (128, 512, 32, 64),
                                         (512, 128, 64, 64)])
def test_skipping_leaves_the_float32_result_bit_for_bit(sq, sk, bq, bk):
    """The skipped blocks add exp(-1e30 - m) = 0 with alpha = 1, so a
    query block that stops at kv_end gives exactly what visiting every KV
    block gives."""
    q, k, v = (torch.from_numpy(x) for x in _qkv((), sq, sk, 64, seed=7))
    cfg = {"BLOCK_Q": bq, "BLOCK_K": bk}
    skipped = 0
    for q0 in range(0, sq, bq):
        end = kv_end(q0, cfg, sq, sk, causal=True)
        skipped += (sk - end) // bk
        qb = q[q0:q0 + bq]
        full = _online_softmax(qb, k, v, q0, bk, sq, sk, sk)
        short = _online_softmax(qb, k, v, q0, bk, sq, sk, end)
        assert torch.equal(full, short)
    assert skipped > 0


def test_model_counts_the_causal_blocks_the_kernel_visits():
    cfg = {"BLOCK_Q": 64, "BLOCK_K": 64}
    causal = analytical_time(cfg, H100_SXM, 4096, 4096, 128, causal=True)
    full = analytical_time(cfg, H100_SXM, 4096, 4096, 128, causal=False)
    assert 0.45 < causal / full < 0.6
    assert causal >= (attention_flops(4096, 4096, 128, causal=True)
                      / H100_SXM.peak_f32_flops)
    # the ops declaration feeds `causal` from the shape
    for c in (True, False):
        s = {"Sq": 4096, "Sk": 4096, "D": 128, "causal": c}
        assert FLASH_ATTENTION.analytical_model(s, cfg, H100_SXM) == \
            analytical_time(cfg, H100_SXM, 4096, 4096, 128, causal=c)


@pytest.mark.parametrize("bq,bk,d,want", [
    (64, 64, 128, {"TM": 4, "TK": 16, "TN": 4, "TD": 8, "threads": 256}),
    (128, 32, 128, {"TM": 8, "TK": 8, "TN": 4, "TD": 16, "threads": 128}),
    (64, 256, 64, {"TM": 4, "TK": 16, "TN": 16, "TD": 4, "threads": 256}),
    (32, 16, 128, {"TM": 4, "TK": 4, "TN": 4, "TD": 32, "threads": 32}),
])
def test_geometry_is_the_builds(bq, bk, d, want):
    cfg = {"BLOCK_Q": bq, "BLOCK_K": bk}
    assert geometry(cfg, d) == want
    assert block_threads(cfg, d) == want["threads"]
    g = want
    assert g["TN"] * g["TK"] == bk and g["TD"] * g["TK"] == d
    assert 32 % g["TK"] == 0 and g["TD"] % 4 == 0
    validate_config(cfg, 256, 256, d)


def test_smem_footprint_counts_the_stages_and_the_input_type():
    cfg = {"BLOCK_Q": 64, "BLOCK_K": 64, "PIPELINE_DEPTH": 2}
    # P (float32, rows + 4), Q and K rows + 16 bytes, V unpadded
    assert smem_footprint(cfg, 128) == (4 * 64 * 68 + 64 * 528
                                        + 2 * 64 * (528 + 512))
    deeper = smem_footprint({**cfg, "PIPELINE_DEPTH": 3}, 128)
    assert deeper - smem_footprint(cfg, 128) == 64 * (528 + 512)
    assert smem_footprint(cfg, 128, elt_bytes=2) < smem_footprint(cfg, 128)
    assert smem_footprint({"BLOCK_Q": 64, "BLOCK_K": 64}, 128) == \
        smem_footprint(cfg, 128)
    with pytest.raises(ValueError):
        make_flash_attention(256, 256, 64, {**cfg, "PIPELINE_DEPTH": 1})


def test_tune_record_lookup_run_on_cpu(tmp_path, monkeypatch):
    path = str(tmp_path / "tuned.json")
    monkeypatch.setenv("REPRO_TUNE_CACHE", path)
    shape = {"Sq": 256, "Sk": 256, "D": 64, "causal": True}
    outcome = tune_kernel(FLASH_ATTENTION, shape, strategy="annealing",
                          budget=10,
                          evaluator=AnalyticalEvaluator(profile=H100_SXM),
                          profile=H100_SXM, cache=TuningCache(path))
    best = outcome.result.best
    assert best is not None and math.isfinite(best.time)
    assert outcome.failure_summary["failed_trials"] == 0
    res = lookup_resolved(FLASH_ATTENTION, shape, profile=H100_SXM,
                          cache=TuningCache(path))
    assert res.provenance == "exact" and res.config == best.config
    # the op's own lookup (default cache) serves the tuned config
    assert port_ops.lookup_config(256, 256, 64, True,
                                  profile=H100_SXM) == res.config
    q, k, v = _qkv((2,), 256, 256, 64, seed=6)
    got = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                          profile=H100_SXM)
    fn = ref_pkg.make_flash_attention(
        256, 256, 64, {n: res.config[n] for n in ("BLOCK_Q", "BLOCK_K")},
        causal=True, interpret=True)
    want = jax.vmap(fn)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def test_legacy_delegates(tmp_path):
    t = port_ops.make_tuner(256, 256, 64, profile=H100_SXM)
    assert isinstance(t.evaluator, AnalyticalEvaluator)
    out = port_ops.tune_flash_attention(
        256, 256, 64, budget=6, profile=H100_SXM,
        cache=TuningCache(str(tmp_path / "c.json")))
    assert out.best_config is not None
    assert 256 % out.best_config["BLOCK_Q"] == 0
