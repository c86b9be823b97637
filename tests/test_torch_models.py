"""The port's LM stack (``repro_torch.configs``, ``repro_torch.models``)
held against the JAX package's on the CPU.

The weights are the JAX package's, carried over path for path by
``params_from_numpy``; inputs come from ``np.random.default_rng(seed)``.
Tolerances, each relative to the JAX side's largest |value|: 1e-5 in
float32 (layers, forward, decode), 2e-2 in bfloat16 (the two packages
round their bf16 intermediates at different points), 1e-4 for decode
against forward (``tests/test_models_math.py``'s bound) and for
granite-3-2b at full width.

After the parity tests come twins of the model-side cases of
``tests/test_models_smoke.py`` that need no training.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
import repro.models as ref_models  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import params as ref_params  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch import models  # noqa: E402
from repro_torch.models import config as port_config  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import params as port_params  # noqa: E402
from repro_torch.models.model import (RunConfig, _head_logits,  # noqa: E402
                                      decode_step, forward, init_cache,
                                      init_model, model_defs)

#: every architecture: dense, VLM, audio, MoE (with MLA for deepseek),
#: SSM and hybrid
PORTED = ("mistral-large-123b", "qwen2.5-32b", "granite-34b", "granite-3-2b",
          "llava-next-34b", "musicgen-medium", "deepseek-v3-671b",
          "kimi-k2-1t-a32b", "zamba2-7b", "mamba2-130m")

F32_TOL = 1e-5
BF16_TOL = 2e-2
DECODE_TOL = 1e-4
B, S = 2, 16


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(arch, dtype="float32", seed=0, **changes):
    """(JAX cfg, JAX params, port cfg, port params) with the same weights."""
    ref_cfg = dataclasses.replace(ref_configs.get_config(arch, smoke=True),
                                  param_dtype=dtype, **changes)
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              param_dtype=dtype, **changes)
    ref_p = ref_models.init_model(ref_cfg, jax.random.PRNGKey(seed))
    return ref_cfg, ref_p, cfg, models.params_from_numpy(_np_tree(ref_p),
                                                         "cpu")


def _inputs(cfg, rng, shape):
    """(JAX input, port input) for tokens or embeddings models."""
    if cfg.input_mode == "embeddings":
        x = (rng.normal(size=shape + (cfg.d_model,)) * 0.1).astype(np.float32)
    else:
        x = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    return jnp.asarray(x), torch.from_numpy(x)


def _key(cfg):
    return "embeds" if cfg.input_mode == "embeddings" else "tokens"


def _rel(port, ref):
    a = np.asarray(ref, np.float64)
    b = port.double().numpy() if isinstance(port, torch.Tensor) \
        else np.asarray(port, np.float64)
    return np.abs(a - b).max() / np.abs(a).max()


def _t(x):
    return torch.from_numpy(np.asarray(x))


# -- configs ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_every_config_equals_its_jax_twin(arch):
    ref, port = ref_configs.get_arch(arch), configs.get_arch(arch)
    for a, b in ((ref.full, port.full), (ref.smoke, port.smoke)):
        assert isinstance(b, port_config.ModelConfig)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.num_params() == b.num_params()
        assert a.num_active_params() == b.num_active_params()
        assert a.layer_plan() == b.layer_plan()
    assert ref.skip_shapes == port.skip_shapes and ref.notes == port.notes


def test_registry_loads_the_port_modules():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    for arch in configs.ARCH_IDS:
        cfg = configs.get_config(arch)
        assert type(cfg) is port_config.ModelConfig
        assert type(cfg).__module__ == "repro_torch.models.config"
    assert list(configs.all_cells()) == list(ref_configs.all_cells())
    assert list(configs.all_cells(True)) == list(ref_configs.all_cells(True))
    assert (configs.PAPER_CONV, configs.PAPER_GEMM, configs.PAPER_BUDGETS) \
        == (ref_configs.PAPER_CONV, ref_configs.PAPER_GEMM,
            ref_configs.PAPER_BUDGETS)
    assert {k: dataclasses.asdict(v) for k, v in models.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_models.SHAPES.items()}
    with pytest.raises(KeyError):
        configs.get_arch("no-such-arch")


# -- parameter trees ----------------------------------------------------------

@pytest.mark.parametrize("arch", PORTED)
def test_model_defs_match_the_jax_tree(arch):
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    ours = models.tree_paths(model_defs(cfg))
    theirs = ref_models.tree_paths(ref_models.model_defs(ref_cfg))
    assert list(ours) == list(theirs)
    for path in ours:
        assert dataclasses.asdict(ours[path]) == \
            dataclasses.asdict(theirs[path]), path
    assert models.count_params(model_defs(cfg)) == \
        ref_models.count_params(ref_models.model_defs(ref_cfg))
    assert models.param_bytes(model_defs(cfg), cfg.param_dtype) == \
        ref_models.param_bytes(ref_models.model_defs(ref_cfg),
                               ref_cfg.param_dtype)
    assert models.param_axes(model_defs(cfg)) == \
        ref_models.param_axes(ref_models.model_defs(ref_cfg))
    ours = models.tree_paths(models.cache_defs(cfg, 4, 256))
    theirs = ref_models.tree_paths(ref_models.cache_defs(ref_cfg, 4, 256))
    assert {p: dataclasses.asdict(d) for p, d in ours.items()} == \
        {p: dataclasses.asdict(d) for p, d in theirs.items()}


def test_abstract_trees_are_shapes_on_the_meta_device():
    cfg = configs.get_config("granite-3-2b")
    ref_cfg = ref_configs.get_config("granite-3-2b")
    for ours, theirs in (
            (models.abstract_model(cfg), ref_models.abstract_model(ref_cfg)),
            (models.abstract_cache(cfg, 4, 256),
             ref_models.abstract_cache(ref_cfg, 4, 256))):
        flat_o = port_params._flatten_tree(ours)
        flat_t = port_params._flatten_tree(theirs)
        assert list(flat_o) == list(flat_t)
        for path, t in flat_o.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == flat_t[path].shape
            assert str(t.dtype).split(".")[-1] == flat_t[path].dtype.name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("flat", [False, True])
def test_params_from_numpy_carries_every_bit(dtype, flat):
    ref_cfg = dataclasses.replace(
        ref_configs.get_config("qwen2.5-32b", smoke=True), param_dtype=dtype)
    ref_p = _np_tree(ref_models.init_model(ref_cfg, jax.random.PRNGKey(3)))
    paths = ref_params.tree_paths(ref_models.model_defs(ref_cfg))
    src = port_params._flatten_tree(ref_p) if flat else ref_p
    ours = port_params._flatten_tree(models.params_from_numpy(src, "cpu"))
    assert list(ours) == list(port_params._flatten_tree(ref_p))
    assert set(ours) == set(paths)
    for path, arr in port_params._flatten_tree(ref_p).items():
        t = ours[path]
        assert str(t.dtype).split(".")[-1] == arr.dtype.name
        assert tuple(t.shape) == arr.shape
        if arr.dtype.name == "bfloat16":
            bits = t.view(torch.int16).numpy().view(np.uint16)
            np.testing.assert_array_equal(bits, arr.view(np.uint16))
        else:
            np.testing.assert_array_equal(t.numpy(), arr)
    # the tensors own their memory: the source is not aliased
    ours["embed"].zero_()
    assert np.abs(np.asarray(ref_p["embed"], np.float32)).max() > 0


def test_init_params_is_seeded_and_follows_the_defs():
    cfg = dataclasses.replace(configs.get_config("granite-3-2b", smoke=True),
                              param_dtype="float32")
    a = port_params._flatten_tree(init_model(cfg, 7, "cpu"))
    b = port_params._flatten_tree(init_model(
        cfg, torch.Generator().manual_seed(7), "cpu"))
    c = port_params._flatten_tree(init_model(cfg, 8, "cpu"))
    defs = models.tree_paths(model_defs(cfg))
    for path, d in defs.items():
        assert torch.equal(a[path], b[path])
        assert tuple(a[path].shape) == d.shape
        if d.init == "ones":
            assert torch.all(a[path] == 1)
        elif d.init == "zeros":
            assert torch.all(a[path] == 0)
        else:
            assert not torch.equal(a[path], c[path])
    # fan-in init: every dim but the last and the stacked layers is an
    # input, so std = 1 / sqrt(d_model * H) for the (L, d, H, hd) queries
    std = a["blocks/attn/wq"].std().item()
    assert abs(std * np.sqrt(cfg.d_model * cfg.num_heads) - 1.0) < 0.05
    assert abs(a["embed"].std().item() / 0.02 - 1.0) < 0.05
    # norms stay float32 in a bf16 model, as the defs say
    bf = port_params._flatten_tree(init_model(
        configs.get_config("granite-3-2b", smoke=True), 0, "cpu"))
    assert bf["blocks/ln1"].dtype == torch.float32
    assert bf["blocks/attn/wq"].dtype == torch.bfloat16


# -- layers, float32 ------------------------------------------------------------

def test_rms_norm_matches():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32)
    ref = ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)
    assert _rel(layers.rms_norm(_t(x), _t(scale), 1e-6), ref) < F32_TOL


@pytest.mark.parametrize("heads", [(), (3,), (2, 3)])
def test_apply_rope_matches(heads):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7) + heads + (32,)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 7)).astype(np.int32)
    ref = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    assert _rel(layers.apply_rope(_t(x), _t(pos), 10_000.0), ref) < F32_TOL
    np.testing.assert_allclose(
        layers.rope_frequencies(32, 1e6).numpy(),
        np.asarray(ref_layers.rope_frequencies(32, 1e6)), rtol=1e-6)


@pytest.mark.parametrize("variant", ["swiglu", "gelu"])
def test_apply_mlp_matches(variant):
    ref_cfg = dataclasses.replace(
        ref_configs.get_config("granite-3-2b", smoke=True),
        mlp_variant=variant, param_dtype="float32")
    cfg = dataclasses.replace(configs.get_config("granite-3-2b", smoke=True),
                              mlp_variant=variant, param_dtype="float32")
    p = ref_params.init_params(ref_layers.mlp_defs(ref_cfg),
                               jax.random.PRNGKey(0), "float32")
    assert {k: dataclasses.asdict(d) for k, d in layers.mlp_defs(cfg).items()} \
        == {k: dataclasses.asdict(d)
            for k, d in ref_layers.mlp_defs(ref_cfg).items()}
    x = np.random.default_rng(2).normal(size=(2, 5, cfg.d_model)) \
        .astype(np.float32)
    ref = ref_layers.apply_mlp(p, jnp.asarray(x))
    ours = layers.apply_mlp(models.params_from_numpy(_np_tree(p), "cpu"),
                            _t(x))
    assert set(p) == ({"wi", "wo", "wg"} if variant == "swiglu"
                      else {"wi", "wo"})
    assert _rel(ours, ref) < F32_TOL


def _attn_setup(arch="qwen2.5-32b"):
    """(JAX cfg, JAX params, port cfg, port params) of one attention layer
    with nonzero biases, so qkv_bias is exercised."""
    ref_cfg = dataclasses.replace(ref_configs.get_config(arch, smoke=True),
                                  param_dtype="float32")
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              param_dtype="float32")
    p = ref_params.init_params(ref_layers.attention_defs(ref_cfg),
                               jax.random.PRNGKey(4), "float32")
    p = {k: (v + 0.1 if k.startswith("b") else v) for k, v in p.items()}
    return ref_cfg, p, cfg, models.params_from_numpy(_np_tree(p), "cpu")


@pytest.mark.parametrize("mode,chunk", [("grouped", 0), ("expanded", 0),
                                        ("grouped", 4), ("expanded", 8)])
def test_apply_attention_full_sequence_matches(mode, chunk):
    ref_cfg, ref_p, cfg, p = _attn_setup()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16)).copy()
    ref, _ = ref_layers.apply_attention(ref_cfg, ref_p, jnp.asarray(x),
                                        jnp.asarray(pos), attn_chunk=chunk,
                                        mode=mode)
    ours, cache = layers.apply_attention(cfg, p, _t(x), _t(pos),
                                         attn_chunk=chunk, mode=mode)
    assert cache is None
    assert _rel(ours, ref) < F32_TOL


def test_apply_attention_decode_matches_and_clamps_like_the_reference():
    """Decode writes k/v at the position and attends over the buffer; a
    write at pos >= max_len lands at max_len - 1, as
    lax.dynamic_update_slice does, with every row's valid length pos + 1."""
    ref_cfg, ref_p, cfg, p = _attn_setup()
    T = 6
    rng = np.random.default_rng(6)
    ref_cache = ref_params.init_params(
        ref_layers.attention_cache_defs(ref_cfg, 2, T), jax.random.PRNGKey(0),
        "float32")
    cache = port_params.init_params(layers.attention_cache_defs(cfg, 2, T),
                                    0, "float32", "cpu")
    for pos in range(T + 3):
        x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        positions = np.full((2, 1), pos, np.int32)
        ref, ref_cache = ref_layers.apply_attention(
            ref_cfg, ref_p, jnp.asarray(x), jnp.asarray(positions),
            cache=ref_cache, cache_pos=pos)
        ours, cache = layers.apply_attention(cfg, p, _t(x), _t(positions),
                                             cache=cache, cache_pos=pos)
        assert _rel(ours, ref) < F32_TOL, pos
        assert _rel(cache["k"], ref_cache["k"]) < F32_TOL, pos
        assert _rel(cache["v"], ref_cache["v"]) < F32_TOL, pos


# -- forward and decode, every ported smoke config ---------------------------------

_REF_DECODE = {}


def _ref_decode(ref_cfg):
    """One jitted JAX decode step per config (pos is traced)."""
    if ref_cfg not in _REF_DECODE:
        _REF_DECODE[ref_cfg] = jax.jit(
            lambda p, c, t, pos: ref_models.decode_step(ref_cfg, p, c, t,
                                                        pos))
    return _REF_DECODE[ref_cfg]


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
@pytest.mark.parametrize("arch", PORTED)
def test_forward_and_decode_match_jax(arch, dtype, tol):
    """In bf16 the JAX side runs op by op (``jax.disable_jit``), as the
    port does: under jit XLA fuses elementwise chains and rounds to bf16
    only at a fusion's edge, which alone moves the zamba2 smoke logits
    past the bf16 bound over its nine layers."""
    ref_cfg, ref_p, cfg, p = _pair(arch, dtype)
    rng = np.random.default_rng(8)
    jx, tx = _inputs(cfg, rng, (B, S))
    with jax.disable_jit(dtype == "bfloat16"):
        ref, ref_aux = jax.jit(
            lambda p, b: ref_models.forward(ref_cfg, p, b))(
                ref_p, {_key(cfg): jx})
        ours, aux = forward(cfg, p, {_key(cfg): tx})
        assert ours.shape == (B, S, cfg.vocab_size)
        assert ours.dtype == port_params.torch_dtype(dtype)
        assert _rel(ours, ref) < tol
        if cfg.is_moe:      # the MoE layers' load-balance losses, summed
            assert abs(float(aux) - float(ref_aux)) <= tol * float(ref_aux)
        else:
            assert float(aux) == float(ref_aux) == 0.0

        ref_cache = ref_models.init_cache(ref_cfg, B, 8)
        cache = init_cache(cfg, B, 8, "cpu")
        step = _ref_decode(ref_cfg)
        jt, tt = _inputs(cfg, rng, (B, 3))
        for pos in range(3):
            ref, ref_cache = step(ref_p, ref_cache, jt[:, pos:pos + 1], pos)
            ours, cache = decode_step(cfg, p, cache, tt[:, pos:pos + 1], pos)
            assert ours.shape == (B, cfg.vocab_size)
            assert _rel(ours, ref) < tol, pos


def test_decode_matches_forward():
    """Twin of tests/test_models_math.py::test_decode_matches_forward for
    granite: float32 decode step by step reproduces the forward."""
    cfg = dataclasses.replace(configs.get_config("granite-3-2b", smoke=True),
                              param_dtype="float32")
    params = init_model(cfg, 1, "cpu")
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))
    full, _ = forward(cfg, params, {"tokens": toks})
    cache = init_cache(cfg, B, S + 4, "cpu")
    outs = []
    for pos in range(S):
        lg, cache = decode_step(cfg, params, cache, toks[:, pos:pos + 1], pos)
        outs.append(lg)
    a, b = full.double(), torch.stack(outs, dim=1).double()
    assert ((a - b).abs().max() / a.abs().max()).item() < DECODE_TOL


def test_decode_twice_on_the_same_inputs_gives_the_same_answer():
    cfg = configs.get_config("granite-3-2b", smoke=True)
    params = init_model(cfg, 0, "cpu")
    cache = init_cache(cfg, 2, 8, "cpu")
    toks = torch.tensor([[3], [5]], dtype=torch.int32)
    a, cache = decode_step(cfg, params, cache, toks, 2)
    b, cache = decode_step(cfg, params, cache, toks, 2)
    assert torch.equal(a, b)


def test_head_chunk_gives_the_unchunked_logits():
    cfg = dataclasses.replace(configs.get_config("granite-3-2b", smoke=True),
                              vocab_size=512, param_dtype="float32")
    params = init_model(cfg, 0, "cpu")
    x = torch.randn(2, 3, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    whole = _head_logits(cfg, params, x)
    for hc in (64, 128, 256):
        tiled = _head_logits(cfg, params, x, RunConfig(head_chunk=hc))
        torch.testing.assert_close(tiled, whole, rtol=0, atol=1e-5)
    # a tile that does not divide the vocab is ignored
    assert torch.equal(_head_logits(cfg, params, x, RunConfig(head_chunk=100)),
                       whole)


def test_tied_embeddings_and_softcap_match_jax():
    """Branches no shipped config takes: the tied head and the soft cap."""
    ref_cfg, ref_p, cfg, p = _pair("granite-3-2b", "float32",
                                   tie_embeddings=True, logit_softcap=30.0)
    assert "head" not in p
    jx, tx = _inputs(cfg, np.random.default_rng(9), (B, S))
    ref, _ = ref_models.forward(ref_cfg, ref_p, {"tokens": jx})
    ours, _ = forward(cfg, p, {"tokens": tx})
    assert _rel(ours, ref) < F32_TOL
    assert ours.abs().max().item() <= 30.0


def test_granite_full_width_two_layers_matches_jax():
    """granite-3-2b at its published widths (d_model 2048, 32 heads over 8
    KV heads, d_ff 8192, vocab 49155), 2 of its 40 layers, float32: four
    decode steps at 4 slots, port against JAX, within 1e-4 of max|logit|."""
    ref_cfg = dataclasses.replace(ref_configs.get_config("granite-3-2b"),
                                  num_layers=2, param_dtype="float32")
    cfg = dataclasses.replace(configs.get_config("granite-3-2b"),
                              num_layers=2, param_dtype="float32")
    ref_p = ref_models.init_model(ref_cfg, jax.random.PRNGKey(0))
    p = models.params_from_numpy(_np_tree(ref_p), "cpu")
    slots, steps = 4, 4
    toks = np.random.default_rng(10).integers(
        0, cfg.vocab_size, (slots, steps)).astype(np.int32)
    ref_cache = ref_models.init_cache(ref_cfg, slots, 8)
    cache = init_cache(cfg, slots, 8, "cpu")
    step = jax.jit(lambda p, c, t, pos: ref_models.decode_step(
        ref_cfg, p, c, t, pos))
    for pos in range(steps):
        ref, ref_cache = step(ref_p, ref_cache,
                              jnp.asarray(toks[:, pos:pos + 1]), pos)
        ours, cache = decode_step(cfg, p, cache,
                                  torch.from_numpy(toks[:, pos:pos + 1]),
                                  pos)
        assert _rel(ours, ref) < DECODE_TOL, pos


# -- twins of tests/test_models_smoke.py (the cases that need no training) -----

SMOKE_B, SMOKE_S = 2, 64


def _smoke_batch(cfg, rng):
    if cfg.input_mode == "embeddings":
        return {"embeds": (torch.from_numpy(
            rng.normal(size=(SMOKE_B, SMOKE_S, cfg.d_model)) * 0.1)
            .to(torch.bfloat16))}
    return {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (SMOKE_B, SMOKE_S)).astype(np.int32))}


@pytest.mark.parametrize("arch", PORTED)
def test_forward_shapes_and_no_nans(arch):
    cfg = configs.get_config(arch, smoke=True)
    params = init_model(cfg, 0, "cpu")
    logits, aux = forward(cfg, params, _smoke_batch(
        cfg, np.random.default_rng(0)))
    assert logits.shape == (SMOKE_B, SMOKE_S, cfg.vocab_size)
    assert not torch.isnan(logits.float()).any()
    assert np.isfinite(float(aux))


@pytest.mark.parametrize("arch", PORTED)
def test_decode_steps(arch):
    cfg = configs.get_config(arch, smoke=True)
    params = init_model(cfg, 2, "cpu")
    rng = np.random.default_rng(2)
    cache = init_cache(cfg, SMOKE_B, 16, "cpu")
    for pos in range(3):
        if cfg.input_mode == "embeddings":
            t = torch.from_numpy(rng.normal(size=(SMOKE_B, 1, cfg.d_model))
                                 * 0.1).to(torch.bfloat16)
        else:
            t = torch.from_numpy(rng.integers(
                0, cfg.vocab_size, (SMOKE_B, 1)).astype(np.int32))
        logits, cache = decode_step(cfg, params, cache, t, pos)
        assert logits.shape == (SMOKE_B, cfg.vocab_size)
        assert not torch.isnan(logits.float()).any()


def test_full_param_counts_match_published():
    expected = {
        "mistral-large-123b": (110e9, 130e9),
        "qwen2.5-32b": (30e9, 35e9),
        "granite-34b": (32e9, 36e9),
        "granite-3-2b": (2.0e9, 3.2e9),
        "llava-next-34b": (32e9, 36e9),
        "musicgen-medium": (1.0e9, 1.8e9),
        "deepseek-v3-671b": (640e9, 700e9),
        "kimi-k2-1t-a32b": (950e9, 1100e9),
        "zamba2-7b": (4.5e9, 8.5e9),
        "mamba2-130m": (0.11e9, 0.15e9),
    }
    assert set(expected) == set(PORTED)
    for arch, (lo, hi) in expected.items():
        n = models.count_params(model_defs(configs.get_config(arch)))
        assert lo <= n <= hi, f"{arch}: {n/1e9:.2f}B not in [{lo/1e9}-{hi/1e9}]"
    assert models.count_params(model_defs(
        configs.get_config("granite-3-2b"))) == 2_634_201_088
    assert models.count_params(model_defs(
        configs.get_config("mamba2-130m"))) == 128_940_480
    assert models.count_params(model_defs(
        configs.get_config("zamba2-7b"))) == 5_191_124_496


def test_skip_shapes_documented():
    for arch in configs.ARCH_IDS:
        spec = configs.get_arch(arch)
        if arch in ("zamba2-7b", "mamba2-130m"):
            assert "long_500k" not in spec.skip_shapes
        else:
            assert "long_500k" in spec.skip_shapes


def test_run_config_variants():
    """remat / scan / attention chunking and layout give the same logits
    (the JAX twin compares losses, which wait for training)."""
    cfg = dataclasses.replace(configs.get_config("granite-3-2b", smoke=True),
                              param_dtype="float32")
    params = init_model(cfg, 3, "cpu")
    batch = _smoke_batch(cfg, np.random.default_rng(3))
    base, _ = forward(cfg, params, batch, RunConfig())
    for run in (RunConfig(remat="full"), RunConfig(remat="dots"),
                RunConfig(ce_chunk=16), RunConfig(scan_blocks=False),
                RunConfig(attn_chunk=16), RunConfig(attn_mode="expanded")):
        val, _ = forward(cfg, params, batch, run)
        rel = ((val - base).abs().max() / base.abs().max()).item()
        assert rel < F32_TOL, run
    with pytest.raises(ValueError):
        forward(cfg, params, batch, RunConfig(remat="sometimes"))
