"""The port's training substrate — ``repro_torch.optim``, ``data``,
``ckpt`` and ``runtime`` — on the CPU: twins of ``tests/test_substrate.py``
(less its two elastic-mesh tests, whose module comes with the DTensor
slice), then parity with the JAX package on the same seeded inputs.

Parity bounds: batches bit for bit; AdamW within 1e-6 of each JAX leaf's
largest |value| (the same float32 operations in the same order; the
transcendental functions of the schedule and of ``b ** count`` may
differ in the last bit between XLA and torch); checkpoints bit for bit
across the two packages, both ways.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.ckpt import CheckpointManager as RefCheckpointManager  # noqa: E402
from repro.data import DataConfig as RefDataConfig  # noqa: E402
from repro.data import TokenSource as RefTokenSource  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402

from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.models import (params_from_numpy, tree_leaves,  # noqa: E402
                                tree_map)
from repro_torch.data import (DataConfig, Prefetcher,  # noqa: E402
                              TokenSource, to_device)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import StragglerConfig, StragglerMonitor  # noqa: E402

ADAMW_TOL = 1e-6


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_adamw_converges_on_quadratic():
    cfg = adamw.OptimConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                            total_steps=200, schedule="constant",
                            clip_norm=0.0)
    params = {"w": torch.tensor([3.0, -2.0, 5.0])}
    state = adamw.init(cfg, params)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}          # d/dw (w^2)
        params, state, _ = adamw.update(cfg, grads, state, params)
    assert float(params["w"].abs().max()) < 0.05


def test_adamw_clipping_and_metrics():
    cfg = adamw.OptimConfig(lr=1e-3, clip_norm=1.0)
    params = {"w": torch.ones(4)}
    state = adamw.init(cfg, params)
    grads = {"w": torch.full((4,), 100.0)}
    _, _, metrics = adamw.update(cfg, grads, state, params)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)


def test_adamw_schedule_shapes():
    cfg = adamw.OptimConfig(lr=1.0, warmup_steps=10, total_steps=100,
                            min_lr_ratio=0.1, schedule="cosine")
    lrs = [float(adamw.schedule_lr(cfg, torch.tensor(s)))
           for s in (0, 5, 10, 55, 100)]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert 0.1 < lrs[3] < 1.0
    assert lrs[4] == pytest.approx(0.1)


def test_adamw_bf16_moments():
    cfg = adamw.OptimConfig(moment_dtype="bfloat16")
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = adamw.init(cfg, params)
    assert state.m["w"].dtype == torch.bfloat16
    grads = {"w": torch.ones(4, dtype=torch.bfloat16)}
    p2, s2, _ = adamw.update(cfg, grads, state, params)
    assert s2.m["w"].dtype == torch.bfloat16
    assert p2["w"].dtype == torch.bfloat16


def test_update_in_place_writes_update_values_into_the_given_tensors():
    cfg = adamw.OptimConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    rng = np.random.default_rng(5)
    params = {"a": torch.from_numpy(rng.normal(size=(3, 4))
                                    .astype(np.float32)),
              "b": {"c": torch.from_numpy(rng.normal(size=5)
                                          .astype(np.float32))
                    .to(torch.bfloat16)}}
    grads = tree_map(lambda p: torch.randn(p.shape).to(p.dtype),
                           params)
    state = adamw.init(cfg, params)
    want_p, want_s, want_m = adamw.update(cfg, grads, state, params)
    ids = [id(t) for t in tree_leaves(params)]
    got_p, got_s, got_m = adamw.update_(cfg, grads, state, params)
    assert got_p is params and got_s is state
    assert [id(t) for t in tree_leaves(got_p)] == ids
    for a, b in zip(tree_leaves({"p": got_p, "m": got_s.m, "v": got_s.v}),
                    tree_leaves({"p": want_p, "m": want_s.m,
                                 "v": want_s.v})):
        assert torch.equal(a, b)
    assert int(got_s.count) == int(want_s.count) == 1
    assert torch.equal(got_m["lr"], want_m["lr"])


def test_abstract_state_is_shapes_only():
    cfg = adamw.OptimConfig(moment_dtype="bfloat16")
    st = adamw.abstract_state(cfg, {"w": torch.empty(3, 2, device="meta")})
    assert st.m["w"].device.type == "meta"
    assert st.m["w"].dtype == torch.bfloat16 and st.count.dtype == torch.int32


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

def test_data_deterministic_per_step():
    cfg = DataConfig(seq_len=32, global_batch=4, vocab_size=100, seed=1)
    src = TokenSource(cfg)
    b1, b2 = src.batch(7), src.batch(7)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    b3 = src.batch(8)
    assert not np.array_equal(b1["tokens"], b3["tokens"])


def test_data_labels_are_shifted_tokens():
    cfg = DataConfig(seq_len=32, global_batch=2, vocab_size=100)
    b = TokenSource(cfg).batch(0)
    assert b["tokens"].shape == (2, 32)
    assert b["labels"].shape == (2, 32)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_data_host_sharding_disjoint_and_union():
    full = DataConfig(seq_len=16, global_batch=8, vocab_size=50, seed=3)
    h0 = DataConfig(seq_len=16, global_batch=8, vocab_size=50, seed=3,
                    host_index=0, host_count=2)
    h1 = DataConfig(seq_len=16, global_batch=8, vocab_size=50, seed=3,
                    host_index=1, host_count=2)
    bf = TokenSource(full).batch(5)
    b0 = TokenSource(h0).batch(5)
    b1 = TokenSource(h1).batch(5)
    np.testing.assert_array_equal(
        np.concatenate([b0["tokens"], b1["tokens"]]), bf["tokens"])


def test_data_tokens_in_vocab_range():
    cfg = DataConfig(seq_len=64, global_batch=4, vocab_size=37)
    b = TokenSource(cfg).batch(0)
    assert b["tokens"].min() >= 0
    assert b["tokens"].max() < 37


def test_prefetcher_ordered_and_resumable():
    cfg = DataConfig(seq_len=16, global_batch=2, vocab_size=50)
    src = TokenSource(cfg)
    pf = Prefetcher(src, start_step=5, depth=2)
    steps = []
    for _ in range(3):
        s, batch = next(pf)
        steps.append(s)
        np.testing.assert_array_equal(batch["tokens"],
                                      src.batch(s)["tokens"])
    pf.close()
    assert steps == [5, 6, 7]


def test_to_device_gives_int32_tensors_of_the_batch():
    b = TokenSource(DataConfig(seq_len=8, global_batch=2,
                               vocab_size=50)).batch(1)
    t = to_device(b, "cpu")
    for k in ("tokens", "labels"):
        assert t[k].dtype == torch.int32 and t[k].is_contiguous()
        np.testing.assert_array_equal(t[k].numpy(), b[k])


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------

def _tree(x=1.0):
    return {"a": torch.full((4, 4), x), "b": {"c": torch.arange(8)}}


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(3, _tree(2.0), extra={"note": "x"})
    out = mgr.restore(template=_tree())
    assert out["step"] == 3
    assert out["extra"]["note"] == "x"
    np.testing.assert_array_equal(out["tree"]["a"].numpy(),
                                  np.full((4, 4), 2.0))


def test_checkpoint_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(float(s)))
    assert mgr.steps() == [3, 4]


def test_checkpoint_latest_ignores_partial(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, _tree())
    os.makedirs(tmp_path / "step_000009")
    assert mgr.latest_step() == 1


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
    mgr.save(7, _tree(7.0), block=False)
    mgr.wait()
    assert mgr.latest_step() == 7
    assert mgr.verify(7)


def test_checkpoint_async_write_is_a_copy_of_the_saved_step(tmp_path):
    """An update in place after an async save does not reach the file."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    tree = _tree(1.0)
    mgr.save(1, tree, block=False)
    tree["a"].add_(5.0)
    mgr.wait()
    np.testing.assert_array_equal(mgr.restore(1)["tree"]["a"].numpy(),
                                  np.full((4, 4), 1.0))


def test_checkpoint_verify_detects_corruption(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    assert mgr.verify(1)
    with open(tmp_path / "step_000001" / "arrays.npz", "wb") as f:
        f.write(b"garbage")
    assert not mgr.verify(1)


def test_checkpoint_namedtuple_roundtrip(tmp_path):
    state = adamw.init(adamw.OptimConfig(), {"w": torch.ones(3)})
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"opt": {"m": state.m, "v": state.v, "count": state.count}})
    out = mgr.restore(template={"opt": {"m": state.m, "v": state.v,
                                        "count": state.count}})
    assert out["tree"]["opt"]["count"].shape == ()


def test_restore_places_leaves_on_the_template_device_and_dtype(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"w": torch.randn(3, 2).to(torch.bfloat16),
            "n": torch.tensor(4, dtype=torch.int32)}
    mgr.save(2, tree)
    meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in tree.items()}
    got = mgr.restore(template=meta)["tree"]
    for k in tree:
        assert got[k].device.type == "cpu" and got[k].dtype == tree[k].dtype
        assert torch.equal(got[k], tree[k])
    flat = mgr.restore(2, device="cpu")["tree"]
    assert flat["w"].dtype == torch.bfloat16 and torch.equal(flat["w"],
                                                             tree["w"])


# ---------------------------------------------------------------------------
# runtime: straggler
# ---------------------------------------------------------------------------

def test_straggler_flags_outliers():
    events_seen = []
    mon = StragglerMonitor(StragglerConfig(window=30, z_threshold=4.0,
                                           patience=2, warmup_steps=5),
                           on_straggler=events_seen.append)
    for _ in range(20):
        mon.observe(0.10)
    assert not mon.events
    e1 = mon.observe(1.0)
    assert e1 and not e1["mitigate"]
    e2 = mon.observe(1.0)
    assert e2 and e2["mitigate"]
    assert events_seen and events_seen[0]["consecutive"] == 2


def test_straggler_tolerates_jitter():
    mon = StragglerMonitor(StragglerConfig(window=30, warmup_steps=5))
    rng = np.random.default_rng(0)
    for _ in range(50):
        mon.observe(0.1 + rng.normal(0, 0.005))
    assert not mon.events


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", ["synthetic", "file"])
@pytest.mark.parametrize("host", [(0, 1), (1, 2)])
def test_batches_equal_the_jax_packages_bit_for_bit(tmp_path, source, host):
    path = None
    if source == "file":
        path = str(tmp_path / "tokens.bin")
        np.random.default_rng(9).integers(
            0, 1000, 4096).astype(np.int32).tofile(path)
    kw = dict(seq_len=48, global_batch=4, vocab_size=1000, seed=7,
              source=source, path=path, host_index=host[0],
              host_count=host[1], mean_doc_len=20)
    port, ref = TokenSource(DataConfig(**kw)), RefTokenSource(
        RefDataConfig(**kw))
    for step in (0, 1, 13):
        a, b = port.batch(step), ref.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def _adamw_inputs(seed, moment_dtype):
    """(params, grads-by-step) as numpy trees: float32 and bfloat16 leaves,
    grads large enough that clipping at 1.0 acts."""
    rng = np.random.default_rng(seed)
    params = {"blocks": {"w": rng.normal(size=(2, 8, 6)).astype(np.float32),
                         "n": np.ones((2, 6), np.float32)},
              "embed": rng.normal(size=(10, 6)).astype(jnp.bfloat16),
              "head": (rng.normal(size=(6, 10)) * 0.1).astype(np.float32)}
    grads = [jax.tree_util.tree_map(
        lambda p: (rng.normal(size=p.shape) * 3).astype(p.dtype), params)
        for _ in range(4)]
    return params, grads


def _close(port, ref, tol):
    for path, r in jax.tree_util.tree_flatten_with_path(ref)[0]:
        node = port
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        r64 = np.asarray(r, np.float64)
        p64 = node.double().numpy()
        scale = max(np.abs(r64).max(), 1e-30)
        assert np.abs(p64 - r64).max() <= tol * scale, (path, tol)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
@pytest.mark.parametrize("clip", [1.0, 0.0])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_the_jax_packages(schedule, clip, moment_dtype):
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, schedule=schedule,
              clip_norm=clip, moment_dtype=moment_dtype, weight_decay=0.1)
    ref_cfg, cfg = ref_adamw.OptimConfig(**kw), adamw.OptimConfig(**kw)
    params_np, grads_np = _adamw_inputs(3, moment_dtype)
    rp = jax.tree_util.tree_map(jnp.asarray, params_np)
    rs = ref_adamw.init(ref_cfg, rp)
    pp = params_from_numpy(params_np, "cpu")
    ps = adamw.init(cfg, pp)
    ref_update = jax.jit(lambda g, s, p: ref_adamw.update(ref_cfg, g, s, p))
    for g_np in grads_np:
        rp, rs, rm = ref_update(jax.tree_util.tree_map(jnp.asarray, g_np),
                                rs, rp)
        pp, ps, pm = adamw.update_(cfg, params_from_numpy(g_np, "cpu"), ps,
                                   pp)
        _close(pp, rp, ADAMW_TOL)
        _close(ps.m, rs.m, ADAMW_TOL)
        _close(ps.v, rs.v, ADAMW_TOL)
        assert int(ps.count) == int(rs.count)
        for k in ("grad_norm", "lr"):
            assert float(pm[k]) == pytest.approx(float(rm[k]), rel=1e-6,
                                                 abs=1e-12)
    assert ps.m["embed"].dtype == getattr(torch, moment_dtype)


def _mixed_tree(rng):
    """A tree of mixed-dtype leaves with an optimizer-state NamedTuple."""
    params = {"embed": rng.normal(size=(6, 4)).astype(jnp.bfloat16),
              "blocks": {"w": rng.normal(size=(2, 4, 4)).astype(jnp.bfloat16),
                         "ln": rng.normal(size=(2, 4)).astype(np.float32)},
              "ids": rng.integers(0, 9, 5).astype(np.int32),
              "pos": rng.integers(0, 9, 3).astype(np.int64)}
    return params


def test_a_jax_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    rng = np.random.default_rng(11)
    params = _mixed_tree(rng)
    rp = jax.tree_util.tree_map(jnp.asarray, params)
    opt = ref_adamw.init(ref_adamw.OptimConfig(moment_dtype="bfloat16"),
                         {"embed": rp["embed"]})
    ref_tree = {"params": rp, "opt": opt, "seq": [rp["ids"], rp["embed"]]}
    RefCheckpointManager(str(tmp_path)).save(4, ref_tree, extra={"k": 1})

    pp = params_from_numpy(params, "cpu")
    popt = adamw.init(adamw.OptimConfig(moment_dtype="bfloat16"),
                      {"embed": pp["embed"]})
    template = {"params": pp, "opt": popt, "seq": [pp["ids"], pp["embed"]]}
    out = CheckpointManager(str(tmp_path)).restore(template=template)
    assert out["step"] == 4 and out["extra"] == {"k": 1}
    got = out["tree"]
    assert isinstance(got["opt"], adamw.OptState)
    _bit_equal(got["params"], params)
    assert got["opt"].count.dtype == torch.int32
    assert int(got["opt"].count) == 0
    assert got["opt"].m["embed"].dtype == torch.bfloat16
    assert torch.equal(got["seq"][1], pp["embed"])


def test_a_port_checkpoint_restores_in_the_jax_package_bit_for_bit(tmp_path):
    rng = np.random.default_rng(12)
    params = _mixed_tree(rng)
    pp = params_from_numpy(params, "cpu")
    opt = adamw.init(adamw.OptimConfig(), {"embed": pp["embed"]})
    opt.m["embed"].copy_(torch.randn(6, 4))
    CheckpointManager(str(tmp_path)).save(
        2, {"params": pp, "opt": opt, "seq": [pp["ids"]]})

    rp = jax.tree_util.tree_map(jnp.asarray, params)
    ropt = ref_adamw.init(ref_adamw.OptimConfig(), {"embed": rp["embed"]})
    out = RefCheckpointManager(str(tmp_path)).restore(
        template={"params": rp, "opt": ropt, "seq": [rp["ids"]]})
    got = out["tree"]
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    for path, want in leaves:
        node = got["params"]
        for key in path:
            node = node[key.key]
        node = np.asarray(node)
        assert node.dtype == want.dtype, path
        np.testing.assert_array_equal(node.view(np.uint8),
                                      want.view(np.uint8))
    assert isinstance(got["opt"], ref_adamw.OptState)
    np.testing.assert_array_equal(np.asarray(got["opt"].m["embed"]),
                                  opt.m["embed"].numpy())
    assert np.asarray(got["opt"].count).dtype == np.int32
    np.testing.assert_array_equal(np.asarray(got["seq"][0]), params["ids"])


def _bit_equal(port_tree, np_tree):
    for k, want in np_tree.items():
        got = port_tree[k]
        if isinstance(want, dict):
            _bit_equal(got, want)
            continue
        if want.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16, k
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy(),
                want.view(np.uint16).view(np.int16))
        else:
            assert str(got.dtype).removeprefix("torch.") == want.dtype.name
            np.testing.assert_array_equal(got.numpy(), want)
