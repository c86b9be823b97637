"""The port's training path — ``loss_fn``, ``make_train_step``, ``Trainer``
and ``launch/train.py`` — held against the JAX package's on the CPU, for
the dense, VLM and audio architectures (the MoE and SSM families are in
``test_torch_train_moe.py`` and ``test_torch_train_ssm.py``), then twins
of ``tests/test_fault_tolerance.py``.

Weights are the JAX package's, carried over by ``params_from_numpy``;
inputs come from ``np.random.default_rng(seed)``; the JAX side is jitted.
Bounds in float32: the loss within 1e-5 relative; each gradient leaf
within 1e-4 of its largest |value| (the two packages sum in other
orders); after a train step the moments within 1e-4 of each
leaf's largest |value| (with a bfloat16 accumulator ``BF16_ACCUM_TOL``)
and the parameters within ``STEP_TOL`` of the learning rate.
"""

import dataclasses
import functools
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
import repro.models as ref_models  # noqa: E402
from repro.data import DataConfig as RefDataConfig  # noqa: E402
from repro.dist import step as ref_step  # noqa: E402
from repro.models.model import RunConfig as RefRunConfig  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.train import Trainer as RefTrainer  # noqa: E402
from repro.train import TrainerConfig as RefTrainerConfig  # noqa: E402

from repro_torch import configs, models  # noqa: E402
from repro_torch.data import DataConfig  # noqa: E402
from repro_torch.dist.step import make_train_step  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models.model import RunConfig, loss_fn  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402

#: the dense-stack architectures of the port's ``PORTED`` list
DENSE = ("mistral-large-123b", "qwen2.5-32b", "granite-34b", "granite-3-2b",
         "llava-next-34b", "musicgen-medium")

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
#: parameters after train steps: |port - JAX| over the learning rate.
#: The steps use AdamW's eps = 1e-3: with the default 1e-8 the first step
#: lr * g / (|g| + eps) has slope lr / eps at g ~ 0, so the packages'
#: last-bit gradient differences move such elements by up to two steps
#: (0.46 lr measured, zamba2 smoke); with eps = 1e-3 the update is smooth.
#: In float32 one ulp of a parameter near 1 is already 1.2e-4 lr at
#: lr = 1e-3 (measured up to 3.1e-4 lr over the ten architectures)
STEP_EPS = 1e-3
STEP_TOL = 1e-3
#: the same with a bfloat16 accumulator: each microbatch gradient is
#: rounded to 8 bits, and where the packages' float32 gradients straddle a
#: rounding boundary the sums differ by a bfloat16 ulp (2**-8 relative) of
#: a summand, which moves the step by up to lr * 2**-8 * |g| / (4 eps) and
#: more where two summands nearly cancel (measured up to 8.6e-3 lr)
BF16_ACCUM_STEP_TOL = 3e-2
#: moments after a step with a bfloat16 gradient accumulator: the two
#: packages' float32 microbatch gradients differ in the last bits, and
#: where that straddles a bfloat16 rounding boundary the accumulators
#: differ by one bfloat16 ulp, up to 2**-7 of the leaf's largest |value|
BF16_ACCUM_TOL = 2.0 ** -7
#: bfloat16 weights: loss and gradients relative to the JAX side's.  Both
#: packages round every bfloat16 product and activation, at different
#: points (XLA at a fusion's edge, torch at each operation), so they
#: differ by bfloat16 rounding noise.  The loss is a float32 mean over
#: many rounded logits: well inside one bfloat16 ulp (2**-8 = 3.9e-3;
#: measured up to 2.9e-4 over three seeds); each gradient leaf carries a
#: few ulps through two layers and the head: the JAX package's bf16
#: kernel tolerance, 3e-2 (measured 1.4e-2 to 1.7e-2 of the leaf's
#: largest |value|)
BF16_LOSS_TOL = 2e-3
BF16_GRAD_TOL = 3e-2
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


def _batch(cfg, seed=1):
    """(JAX batch, port batch) from one seeded generator."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "embeddings":
        key = "embeds"
        x = (rng.normal(size=(B, S, cfg.d_model)) * 0.1).astype(np.float32)
    else:
        key = "tokens"
        x = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return ({key: jnp.asarray(x), "labels": jnp.asarray(labels)},
            {key: torch.from_numpy(x), "labels": torch.from_numpy(labels)})


@functools.lru_cache(maxsize=None)
def _ref_grad_fn(ref_cfg, run):
    """The JAX package's jitted (loss, metrics), grads — one compile per
    configuration and run."""
    return jax.jit(jax.value_and_grad(
        lambda p, b: ref_models.loss_fn(ref_cfg, p, b, run), has_aux=True))


def _ref_grads(ref_cfg, ref_p, ref_b, run=RefRunConfig()):
    (loss, metrics), grads = _ref_grad_fn(ref_cfg, run)(ref_p, ref_b)
    return float(loss), {k: float(v) for k, v in metrics.items()}, grads


def _port_grads(cfg, params, batch, run=RunConfig()):
    live = models.tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(cfg, live, batch, run)
    grads = torch.autograd.grad(loss, models.tree_leaves(live),
                                allow_unused=True, materialize_grads=True)
    return loss.item(), {k: v.item() for k, v in metrics.items()}, grads


def _leaf_err(port, ref):
    """|port - ref| over the JAX leaf's largest |value| (absolute where the
    leaf is all zeros)."""
    r = np.asarray(ref, np.float64)
    p = port.detach().double().numpy()
    assert p.shape == r.shape
    return np.abs(p - r).max() / (np.abs(r).max() or 1.0)


def _assert_leaves(port_leaves, ref_tree, tol, what):
    ref_leaves = jax.tree_util.tree_leaves(ref_tree)
    assert len(port_leaves) == len(ref_leaves)
    errs = [_leaf_err(p, r) for p, r in zip(port_leaves, ref_leaves)]
    assert max(errs) <= tol, (what, max(errs))


def _assert_step(port_leaves, ref_tree, lr, tol, what):
    """Every parameter within ``tol * lr`` of the JAX package's."""
    ref_leaves = jax.tree_util.tree_leaves(ref_tree)
    assert len(port_leaves) == len(ref_leaves)
    err = max(np.abs(p.double().numpy() - np.asarray(r, np.float64)).max()
              for p, r in zip(port_leaves, ref_leaves))
    assert err <= tol * lr, (what, err / lr)


def _assert_metrics(port, ref, tol, what):
    assert set(port) == set(ref), what
    for k in ref:
        assert port[k] == pytest.approx(ref[k], rel=tol, abs=tol), (what, k)


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_gradients_match_jax(arch):
    ref_cfg, ref_p, cfg, params = _pair(arch)
    ref_b, b = _batch(cfg)
    r_loss, r_met, r_grads = _ref_grads(ref_cfg, ref_p, ref_b)
    loss, met, grads = _port_grads(cfg, params, b)
    assert set(met) == {"ce", "aux", "loss"}
    _assert_metrics(met, r_met, LOSS_TOL, arch)
    _assert_leaves(grads, r_grads, GRAD_TOL, arch)


@pytest.mark.parametrize("arch,mb,accum", [
    (arch, 1, "float32") for arch in DENSE] + [
    (arch, 2, "bfloat16") for arch in DENSE] + [
    ("granite-3-2b", 2, "float32")])
def test_train_step_matches_jax(arch, mb, accum):
    """One ``make_train_step`` against the JAX package's jitted step, with
    one microbatch or two accumulated in ``accum``."""
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
    leaves = [id(t) for t in models.tree_leaves(params)]
    p, opt2, met = make_train_step(cfg, RunConfig(**kw), oc)(params, opt, b)
    assert p is params and opt2 is opt          # updated in place
    assert [id(t) for t in models.tree_leaves(p)] == leaves
    _assert_metrics({k: v.item() for k, v in met.items()},
                    {k: float(v) for k, v in r_met.items()}, LOSS_TOL, arch)
    bf16 = accum == "bfloat16"
    _assert_step(models.tree_leaves(p), r_p, okw["lr"],
                 BF16_ACCUM_STEP_TOL if bf16 else STEP_TOL, arch)
    mtol = BF16_ACCUM_TOL if bf16 else GRAD_TOL
    _assert_leaves(models.tree_leaves(opt.m), r_opt.m, mtol, arch)
    _assert_leaves(models.tree_leaves(opt.v), r_opt.v, 2 * mtol, arch)
    assert int(opt.count) == int(r_opt.count) == 1


@pytest.mark.parametrize("run", [
    RunConfig(remat="full"), RunConfig(remat="dots"), RunConfig(ce_chunk=4),
    RunConfig(remat="dots", ce_chunk=8, attn_chunk=8),
    RunConfig(attn_mode="expanded")], ids=repr)
def test_run_config_variants_match_jax(run):
    """remat, chunked cross-entropy and chunked attention give the JAX
    package's loss (its own variant's) and gradients (its default's)."""
    ref_cfg, ref_p, cfg, params = _pair("granite-3-2b")
    ref_b, b = _batch(cfg, seed=3)
    ref_run = RefRunConfig(**dataclasses.asdict(run))
    r_loss, r_met, _ = _ref_grads(ref_cfg, ref_p, ref_b, ref_run)
    _, _, r_grads = _ref_grads(ref_cfg, ref_p, ref_b)
    loss, met, grads = _port_grads(cfg, params, b, run)
    _assert_metrics(met, r_met, LOSS_TOL, run)
    _assert_leaves(grads, r_grads, GRAD_TOL, run)


def test_ce_chunk_falls_back_where_jax_does():
    """No chunking when the chunk does not divide S or S <= chunk: the
    same values as the unchunked loss, bit for bit."""
    _, _, cfg, params = _pair("granite-3-2b")
    _, b = _batch(cfg)
    base = loss_fn(cfg, params, b)[0]
    for chunk in (5, 16, 32):
        assert torch.equal(loss_fn(cfg, params, b,
                                   RunConfig(ce_chunk=chunk))[0], base)


def test_unknown_remat_raises():
    _, _, cfg, params = _pair("granite-3-2b")
    _, b = _batch(cfg)
    with pytest.raises(ValueError, match="remat"):
        loss_fn(cfg, params, b, RunConfig(remat="some"))


def test_dots_remat_saves_projections_and_recomputes_attention():
    """Under ``"dots"`` the backward pass recomputes attention's batched
    products (``aten.bmm``) and none of the projections (``aten.mm``);
    under ``"full"`` it recomputes both (of a layer's 7 projections, the
    6 whose outputs the backward pass reads: recomputation stops once it
    has them, before the MLP's output projection)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {"mm": 0, "bmm": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in self.n:
                self.n[name] += 1
            return func(*args, **(kwargs or {}))

    _, _, cfg, params = _pair("granite-3-2b")
    _, b = _batch(cfg)
    counts = {}
    for remat in ("none", "dots", "full"):
        live = models.tree_map(lambda t: t.detach().requires_grad_(True),
                               params)
        loss, _ = loss_fn(cfg, live, b, RunConfig(remat=remat))
        with Count() as c:
            torch.autograd.grad(loss, models.tree_leaves(live))
        counts[remat] = c.n
    layers = cfg.num_layers
    # each layer's forward runs 2 bmm (scores, P.V) and 7 projections
    assert counts["dots"]["bmm"] == counts["none"]["bmm"] + 2 * layers
    assert counts["dots"]["mm"] == counts["none"]["mm"]
    assert counts["full"]["mm"] == counts["none"]["mm"] + 6 * layers
    assert counts["full"]["bmm"] == counts["dots"]["bmm"]


def test_bf16_loss_and_gradients_follow_jax():
    ref_cfg, ref_p, cfg, params = _pair("granite-3-2b", dtype="bfloat16")
    ref_b, b = _batch(cfg, seed=4)
    r_loss, r_met, r_grads = _ref_grads(ref_cfg, ref_p, ref_b)
    loss, met, grads = _port_grads(cfg, params, b)
    assert all(g.dtype == torch.bfloat16 for g, p in zip(
        grads, models.tree_leaves(params)) if p.dtype == torch.bfloat16)
    _assert_metrics(met, r_met, BF16_LOSS_TOL, "bf16")
    _assert_leaves(grads, r_grads, BF16_GRAD_TOL, "bf16")


def test_grad_shardings_and_mesh_wait_for_the_dtensor_slice(tmp_path):
    """The DTensor slice has landed: ``grad_shardings`` and ``mesh`` are
    taken (``tests/test_torch_dist.py`` drives both on gloo ranks), and a
    mesh of another device type than the trainer's is refused."""
    cfg = configs.get_config("granite-3-2b", smoke=True)
    assert callable(make_train_step(cfg, grad_shardings={"embed": None}))
    with pytest.raises(ValueError, match="mesh"):
        Trainer(cfg, DataConfig(8, 2, cfg.vocab_size),
                TrainerConfig(ckpt_dir=str(tmp_path)),
                mesh=types.SimpleNamespace(device_type="cuda"),
                device="cpu")


# ---------------------------------------------------------------------------
# the trainer and its launcher
# ---------------------------------------------------------------------------

def test_trainer_history_matches_the_jax_trainer(tmp_path):
    """Six steps of both trainers from the same carried-over weights, on
    the same data stream (float32)."""
    ref_cfg, ref_p, cfg, params = _pair("granite-3-2b")
    okw = dict(lr=1e-3, warmup_steps=2, total_steps=6, eps=STEP_EPS)
    dkw = dict(seq_len=16, global_batch=2, vocab_size=cfg.vocab_size, seed=5)
    tkw = dict(total_steps=6, ckpt_every=100, ckpt_async=False,
               log_every=100)
    ref = RefTrainer(ref_cfg, RefDataConfig(**dkw),
                     RefTrainerConfig(ckpt_dir=str(tmp_path / "ref"), **tkw),
                     opt_cfg=ref_adamw.OptimConfig(**okw))
    ref.params = ref_p
    ref.opt_state = ref_adamw.init(ref.opt_cfg, ref_p)
    port = Trainer(cfg, DataConfig(**dkw),
                   TrainerConfig(ckpt_dir=str(tmp_path / "port"), **tkw),
                   opt_cfg=adamw.OptimConfig(**okw), device="cpu")
    port.params = params
    port.opt_state = adamw.init(port.opt_cfg, params)
    want = ref.train()["history"]
    got = port.train()["history"]
    assert [h["step"] for h in got] == [h["step"] for h in want]
    for g, w in zip(got, want):
        _assert_metrics({k: v for k, v in g.items() if k != "step"},
                        {k: v for k, v in w.items() if k != "step"},
                        LOSS_TOL, g["step"])
    _assert_step(models.tree_leaves(port.params), ref.params, okw["lr"],
                 STEP_TOL, "final params")


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    out = launcher.main(["--device", "cpu", "--steps", "3", "--seq-len",
                         "16", "--global-batch", "2", "--ckpt-every", "2",
                         "--ckpt-dir", str(tmp_path)])
    assert out["final_step"] == 3 and len(out["history"]) == 3
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    line = capsys.readouterr().out
    assert "trained granite-3-2b (granite-3-2b-smoke) to step 3: loss" in line
    assert sorted(os.listdir(tmp_path)) == ["step_000002"]


def test_launcher_resumes_from_its_checkpoint(tmp_path):
    args = ["--device", "cpu", "--seq-len", "16", "--global-batch", "2",
            "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)]
    launcher.main(args + ["--steps", "2"])
    out = launcher.main(args + ["--steps", "3", "--resume"])
    assert [h["step"] for h in out["history"]] == [3]


# ---------------------------------------------------------------------------
# twins of tests/test_fault_tolerance.py (granite-3-2b smoke, bfloat16)
# ---------------------------------------------------------------------------

def _mk_trainer(tmp_path, tag, total=10, ckpt_every=3):
    cfg = configs.get_config("granite-3-2b", smoke=True)
    data_cfg = DataConfig(seq_len=32, global_batch=2,
                          vocab_size=cfg.vocab_size, seed=11)
    return Trainer(
        cfg, data_cfg,
        TrainerConfig(total_steps=total, ckpt_every=ckpt_every,
                      ckpt_dir=str(tmp_path / tag), ckpt_keep=5,
                      ckpt_async=False, log_every=100),
        run=RunConfig(),
        opt_cfg=adamw.OptimConfig(lr=1e-3, warmup_steps=2, total_steps=total),
        device="cpu")


def _leaves(tree):
    return [t.float().numpy() for t in models.tree_leaves(tree)]


def test_crash_restore_resumes_bitwise(tmp_path):
    ref = _mk_trainer(tmp_path, "ref")
    ref.init_state()
    ref.train()
    ref_params = _leaves(ref.params)

    crash = _mk_trainer(tmp_path, "crash")
    crash.init_state()
    with pytest.raises(RuntimeError, match="simulated node failure"):
        crash.train(simulate_failure_at=7)

    recov = _mk_trainer(tmp_path, "crash")
    assert recov.try_restore()
    assert recov.step == 6
    recov.train()
    rec_params = _leaves(recov.params)

    for a, b in zip(ref_params, rec_params):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_restore_resumes_data_stream(tmp_path):
    ref = _mk_trainer(tmp_path, "r2", total=8, ckpt_every=4)
    ref.init_state()
    out_ref = ref.train()
    ref_losses = [h["loss"] for h in out_ref["history"]]

    crash = _mk_trainer(tmp_path, "c2", total=8, ckpt_every=4)
    crash.init_state()
    with pytest.raises(RuntimeError):
        crash.train(simulate_failure_at=5)
    recov = _mk_trainer(tmp_path, "c2", total=8, ckpt_every=4)
    recov.try_restore()
    out_rec = recov.train()
    rec_losses = [h["loss"] for h in out_rec["history"]]
    np.testing.assert_allclose(ref_losses[4:], rec_losses, rtol=1e-5)


def test_straggler_monitor_integration(tmp_path):
    t = _mk_trainer(tmp_path, "s", total=5, ckpt_every=100)
    t.init_state()
    out = t.train()
    assert out["final_step"] == 5
    assert isinstance(out["straggler_events"], list)
