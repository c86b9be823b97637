"""The port's training path for the state-space families (mamba2-130m,
zamba2-7b with its weight-shared attention block) held against the JAX
package's on the CPU: ``loss_fn``'s metrics and gradients through the
chunked SSD, one ``make_train_step``, and the remat and chunked
cross-entropy variants (zamba2's super-blocks recompute nested, as the
JAX package's ``jax.checkpoint`` nests).  The bounds are
``tests/test_torch_train.py``'s.

A variant's values are the JAX package's default's
(``tests/test_models_smoke.py::test_run_config_variants``), so each port
variant is held to the JAX default's loss and gradients.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
import repro.models as ref_models  # noqa: E402
from repro.dist import step as ref_step  # noqa: E402
from repro.models.model import RunConfig as RefRunConfig  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402

from repro_torch import configs, models  # noqa: E402
from repro_torch.dist.step import make_train_step  # noqa: E402
from repro_torch.models.model import RunConfig, loss_fn  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
#: ``tests/test_torch_train.py``'s bounds after a step with AdamW's eps at
#: STEP_EPS (why there): parameters within STEP_TOL of the learning rate,
#: moments within GRAD_TOL of each leaf's largest |value|; with a bfloat16
#: accumulator BF16_ACCUM_STEP_TOL and one bfloat16 ulp
STEP_EPS = 1e-3
STEP_TOL = 1e-3
BF16_ACCUM_STEP_TOL = 3e-2
BF16_ACCUM_TOL = 2.0 ** -7
B, S = 2, 16
ARCHS = ("mamba2-130m", "zamba2-7b")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(arch, seed=0, **changes):
    """(JAX cfg, JAX params, port cfg, port params) in float32 with the
    same weights."""
    ref_cfg = dataclasses.replace(ref_configs.get_config(arch, smoke=True),
                                  param_dtype="float32", **changes)
    cfg = dataclasses.replace(configs.get_config(arch, smoke=True),
                              param_dtype="float32", **changes)
    ref_p = ref_models.init_model(ref_cfg, jax.random.PRNGKey(seed))
    return ref_cfg, ref_p, cfg, models.params_from_numpy(_np_tree(ref_p),
                                                         "cpu")


def _batch(cfg, seed=1):
    """(JAX batch, port batch) of tokens from one seeded generator."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return ({"tokens": jnp.asarray(x), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(x), "labels": torch.from_numpy(labels)})


@functools.lru_cache(maxsize=None)
def _ref_grads(arch):
    """The JAX package's (metrics, grads) on ``_pair(arch)`` and
    ``_batch``, one compile per architecture."""
    ref_cfg, ref_p, cfg, _ = _pair(arch)
    ref_b, _ = _batch(cfg)
    (_, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref_models.loss_fn(ref_cfg, p, b), has_aux=True))(
        ref_p, ref_b)
    return {k: float(v) for k, v in metrics.items()}, grads


def _port_grads(cfg, params, batch, run=RunConfig()):
    live = models.tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(cfg, live, batch, run)
    grads = torch.autograd.grad(loss, models.tree_leaves(live),
                                allow_unused=True, materialize_grads=True)
    return {k: v.item() for k, v in metrics.items()}, grads


def _assert_leaves(port_leaves, ref_tree, tol, what):
    ref_leaves = jax.tree_util.tree_leaves(ref_tree)
    assert len(port_leaves) == len(ref_leaves)
    errs = []
    for p, r in zip(port_leaves, ref_leaves):
        r = np.asarray(r, np.float64)
        p = p.detach().double().numpy()
        assert p.shape == r.shape
        errs.append(np.abs(p - r).max() / (np.abs(r).max() or 1.0))
    assert max(errs) <= tol, (what, max(errs))


def _assert_step(port_leaves, ref_tree, lr, tol, what):
    """Every parameter within ``tol * lr`` of the JAX package's."""
    err = max(np.abs(p.double().numpy() - np.asarray(r, np.float64)).max()
              for p, r in zip(port_leaves,
                              jax.tree_util.tree_leaves(ref_tree)))
    assert err <= tol * lr, (what, err / lr)


def _assert_metrics(port, ref, tol, what):
    assert set(port) == set(ref), what
    for k in ref:
        assert port[k] == pytest.approx(ref[k], rel=tol, abs=tol), (what, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    _, _, cfg, params = _pair(arch)
    _, b = _batch(cfg)
    r_met, r_grads = _ref_grads(arch)
    met, grads = _port_grads(cfg, params, b)
    _assert_metrics(met, r_met, LOSS_TOL, arch)
    _assert_leaves(grads, r_grads, GRAD_TOL, arch)


@pytest.mark.parametrize("mb,accum", [(1, "float32"), (2, "bfloat16")])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, mb, accum):
    """One ``make_train_step`` against the JAX package's jitted step."""
    kw = dict(microbatch=mb, accum_dtype=accum)
    okw = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=STEP_EPS)
    ref_cfg, ref_p, cfg, params = _pair(arch)
    ref_b, b = _batch(cfg, seed=2)
    ref_oc = ref_adamw.OptimConfig(**okw)
    r_p, r_opt, r_met = jax.jit(ref_step.make_train_step(
        ref_cfg, RefRunConfig(**kw), ref_oc))(
        ref_p, ref_adamw.init(ref_oc, ref_p), ref_b)
    oc = adamw.OptimConfig(**okw)
    opt = adamw.init(oc, params)
    p, opt, met = make_train_step(cfg, RunConfig(**kw), oc)(params, opt, b)
    _assert_metrics({k: v.item() for k, v in met.items()},
                    {k: float(v) for k, v in r_met.items()}, LOSS_TOL, arch)
    bf16 = accum == "bfloat16"
    _assert_step(models.tree_leaves(p), r_p, okw["lr"],
                 BF16_ACCUM_STEP_TOL if bf16 else STEP_TOL, arch)
    mtol = BF16_ACCUM_TOL if bf16 else GRAD_TOL
    _assert_leaves(models.tree_leaves(opt.m), r_opt.m, mtol, arch)
    _assert_leaves(models.tree_leaves(opt.v), r_opt.v, 2 * mtol, arch)


@pytest.mark.parametrize("run", [
    RunConfig(remat="full"), RunConfig(remat="dots"), RunConfig(ce_chunk=4),
    RunConfig(remat="dots", ce_chunk=8)], ids=repr)
@pytest.mark.parametrize("arch", ARCHS)
def test_run_config_variants_match_jax(arch, run):
    _, _, cfg, params = _pair(arch)
    _, b = _batch(cfg)
    r_met, r_grads = _ref_grads(arch)
    met, grads = _port_grads(cfg, params, b, run)
    _assert_metrics(met, r_met, LOSS_TOL, run)
    _assert_leaves(grads, r_grads, GRAD_TOL, run)


def test_ssd_gradients_stay_finite_where_a_chunks_decay_overflows():
    """At A = -exp(3) the log decay across a 16-position chunk passes
    exp's float32 range (~88): the JAX package's SSD gradients are NaN
    there (it masks after exp), the port's are finite, with the JAX
    package's loss, and equal its own over 4-position chunks, which do not
    overflow (the same sums, grouped otherwise)."""
    ref_cfg, ref_p, cfg, _ = _pair("mamba2-130m")
    ref_p["blocks"]["mamba"]["A_log"] = jnp.full_like(
        ref_p["blocks"]["mamba"]["A_log"], 3.0)
    params = models.params_from_numpy(_np_tree(ref_p), "cpu")
    ref_b, b = _batch(cfg)
    (_, r_met), r_grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref_models.loss_fn(ref_cfg, p, b), has_aux=True))(
        ref_p, ref_b)
    assert any(np.isnan(np.asarray(g)).any()
               for g in jax.tree_util.tree_leaves(r_grads))
    met, grads = _port_grads(cfg, params, b)
    _assert_metrics(met, {k: float(v) for k, v in r_met.items()}, LOSS_TOL,
                    "A_log 3")
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    _, grads4 = _port_grads(dataclasses.replace(cfg, ssm_chunk=4), params, b)
    for g, g4 in zip(grads, grads4):
        assert (g - g4).abs().max() <= GRAD_TOL * (g4.abs().max() or 1.0)
