"""The port's distribution layer (``repro_torch.dist``, ``launch/mesh.py``,
``runtime/elastic.py``) held against the JAX package's on the CPU.

Pure functions (``spec_for``, ``plan_mesh``) are compared entry for entry.
The JAX ``spec_for`` reads only ``mesh.axis_names`` and
``mesh.devices.shape``, the port's only ``mesh_dim_names`` and ``shape``,
so small stand-in meshes serve for (2, 4), (16, 16) and (2, 16, 16).

Sharded steps run for real: 8 (then 4) processes of the ``gloo`` backend,
each a rank of a (4, 2) (then (2, 2)) CPU mesh, started as subprocesses
with the worker script below.  The smoke configs run in float32 (gloo has
no bfloat16 reductions) on seeded weights written as numpy arrays, which
the ranks load through ``params_from_numpy`` and the JAX package's loss
reads as they are; the batch comes from ``np.random.default_rng``.
Bounds: a sharded loss within 2e-3 (relative) of the meshless port step's
and of the JAX package's single-device loss, every updated leaf within
2e-3 of the meshless step's and every first moment (0.1 x its gradient)
within 2e-3 of its leaf's largest |value| (the ranks sum in other
orders; a step moves a parameter by at most about 2 x lr, so the
moments are what hold the gradients); a checkpoint restored onto
another mesh bit for bit.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.configs as ref_configs  # noqa: E402
import repro.models as ref_models  # noqa: E402
from repro.dist import sharding as ref_sharding  # noqa: E402
from repro.runtime import elastic as ref_elastic  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import (make_host_mesh,  # noqa: E402
                                     make_production_mesh, mesh_chips)
from repro_torch.models.model import (cache_defs, init_model,  # noqa: E402
                                      model_defs)
from repro_torch.models.params import tree_paths  # noqa: E402
from repro_torch.runtime import (make_elastic_mesh, plan_mesh,  # noqa: E402
                                 validate_batch)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-3
B, S = 8, 16


# ---------------------------------------------------------------------------
# spec_for against the JAX function
# ---------------------------------------------------------------------------

def _meshes(shape):
    """(JAX stand-in, port stand-in) meshes of ``shape``."""
    names = ("pod", "data", "model")[-len(shape):]
    ref = types.SimpleNamespace(axis_names=names,
                                devices=np.empty(shape, dtype=np.int8))
    port = types.SimpleNamespace(mesh_dim_names=names, shape=tuple(shape))
    return ref, port


def _jax_entries(spec):
    return tuple(spec)


MESHES = [(2, 4), (16, 16), (2, 16, 16)]


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: "x".join(
    map(str, s)))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_for_matches_jax_for_every_param_and_cache_leaf(arch,
                                                             mesh_shape):
    ref_mesh, mesh = _meshes(mesh_shape)
    cfg = get_arch(arch).full
    ref_cfg = ref_configs.get_arch(arch).full
    rules = dict(sharding.DEFAULT_RULES)
    assert rules == ref_sharding.DEFAULT_RULES
    for defs, ref_defs in ((model_defs(cfg), ref_models.model_defs(ref_cfg)),
                           (cache_defs(cfg, 128, 32_768),
                            ref_models.cache_defs(ref_cfg, 128, 32_768))):
        flat, ref_flat = tree_paths(defs), ref_models.params.tree_paths(
            ref_defs)
        assert list(flat) == list(ref_flat)
        for path, d in flat.items():
            got = sharding.spec_for(d.shape, d.axes, rules, mesh)
            want = ref_sharding.spec_for(d.shape, d.axes, rules, ref_mesh)
            assert got == _jax_entries(want), (path, got, want)


@pytest.mark.parametrize("shape,axes,want", [
    ((16, 8, 32), ("embed", "heads", None), ("data", "model")),
    ((16, 6, 32), ("embed", "heads", None), ("data",)),
    ((8, 16, 32), ("batch", "seq", "embed"), ("data",)),
    ((8,), ("batch",), ("data",)),
], ids=["divisible", "indivisible-dropped", "dedup", "multi-axis-filtered"])
def test_spec_for_divisibility_and_dedup(shape, axes, want):
    """The four cases of ``tests/test_dist.py``'s twin, on a (2, 4) mesh."""
    _, mesh = _meshes((2, 4))
    assert sharding.spec_for(shape, axes, dict(sharding.DEFAULT_RULES),
                             mesh) == want


def test_placements_for_multi_axis_entries():
    from torch.distributed.tensor import Replicate, Shard
    _, mesh = _meshes((2, 16, 16))
    # batch over (pod, data): dim 0 sharded on both, pod major
    spec = sharding.spec_for((64, 128, 512), ("batch", "seq", "heads"),
                             dict(sharding.DEFAULT_RULES), mesh)
    assert spec == (("pod", "data"), None, "model")
    assert sharding.placements(spec, 3, mesh) == (Shard(0), Shard(0),
                                                  Shard(2))
    assert sharding.local_shape((64, 128, 512), sharding.placements(
        spec, 3, mesh), mesh) == (2, 128, 32)
    # a size-1 mesh dim holds the whole tensor: replicated
    _, one = _meshes((1, 1))
    assert sharding.placements(("data", "model"), 2, one) == (Replicate(),
                                                              Replicate())
    assert sharding.sharding_for((8, 4), ("embed", "heads"), mesh) == (
        Replicate(), Replicate(), Replicate())       # 8 % 32, 4 % 16


def test_shard_is_the_identity_outside_a_scope_and_refuses_plain_tensors():
    x = torch.ones(4, 4)
    assert sharding.shard(x, "batch", None) is x
    _, mesh = _meshes((2, 4))
    with sharding.use_sharding(mesh, {"heads": None}):
        assert sharding.current_mesh() is mesh
        assert sharding.current()[1]["heads"] is None
        with pytest.raises(TypeError, match="plain"):
            sharding.shard(x, "batch", None)
    assert sharding.current() is None


# ---------------------------------------------------------------------------
# elastic planning and meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model_parallel", [1, 2, 8, 16])
def test_plan_mesh_matches_jax(model_parallel):
    for n in range(1, 601):
        got = plan_mesh(n, model_parallel=model_parallel)
        want = ref_elastic.plan_mesh(n, model_parallel=model_parallel)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), n


def test_validate_batch():
    _, single = _meshes((4, 2))
    _, multi = _meshes((2, 16, 16))
    assert validate_batch(8, single) and not validate_batch(6, single)
    assert validate_batch(64, multi) and not validate_batch(48, multi)


def test_production_and_elastic_meshes_in_a_fake_world():
    with dryrun.fake_world(512):
        mm = make_production_mesh(multi_pod=True, device_type="cpu")
        assert tuple(mm.shape) == (2, 16, 16)
        assert mm.mesh_dim_names == ("pod", "data", "model")
        assert mesh_chips(mm) == 512
        m = make_production_mesh(device_type="cpu")
        assert tuple(m.shape) == (16, 16)
        assert m.mesh_dim_names == ("data", "model")
        host = make_host_mesh(model_axis=8, device_type="cpu")
        assert tuple(host.shape) == (64, 8)
        em, decision = make_elastic_mesh(model_parallel=16,
                                         device_type="cpu")
        assert decision == plan_mesh(512, model_parallel=16)
        assert tuple(em.shape) == decision.mesh_shape == (2, 16, 16)
        em, decision = make_elastic_mesh(300, device_type="cpu")
        assert tuple(em.shape) == (18, 16) and decision.dropped == 12
        with pytest.raises(RuntimeError, match="default process group"):
            with dryrun.fake_world(8):
                pass
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# sharded steps on gloo processes
# ---------------------------------------------------------------------------

_WORKER = r'''
import json, os, sys, tempfile
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
import dataclasses
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data import DataConfig
from repro_torch.dist import partition, sharding
from repro_torch.dist.step import make_serve_step, make_train_step
from repro_torch.models.config import ShapeConfig
from repro_torch.models.model import abstract_model, init_cache, init_model
from torch.distributed.tensor import Replicate
from repro_torch.models.params import params_from_numpy, tree_leaves, tree_map
from repro_torch.optim import adamw
from repro_torch.train import Trainer, TrainerConfig

rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
job = json.loads(os.environ["JOB"])
dist.init_process_group("gloo", init_method="tcp://localhost:%s"
                        % os.environ["PORT"], rank=rank, world_size=world)
mesh = DeviceMesh("cpu", torch.arange(world).reshape(job["mesh"]),
                  mesh_dim_names=("data", "model"))
out = {}

def cfg_of(arch):
    return dataclasses.replace(get_arch(arch).smoke, param_dtype="float32")

def load(arch):
    with np.load(os.path.join(job["dir"], arch + ".npz")) as z:
        flat = {k: z[k] for k in z.files}
    batch = {k.split(":", 1)[1]: torch.from_numpy(v)
             for k, v in flat.items() if k.startswith("batch:")}
    return {k: v for k, v in flat.items() if ":" not in k}, batch

def step_parity(arch, mesh=mesh, run=None):
    """One train step on ``mesh`` against the meshless step, both under
    ``run`` (a dict of RunConfig fields; the defaults when None)."""
    from repro_torch.launch.dryrun import default_rules_override
    from repro_torch.models.model import RunConfig
    rules = dict(sharding.DEFAULT_RULES, **default_rules_override(arch))
    run = RunConfig(**(run or {}))
    cfg = cfg_of(arch)
    flat, batch = load(arch)
    ocfg = adamw.OptimConfig(eps=1e-3)
    plain = params_from_numpy(flat, "cpu")
    p, o, m = make_train_step(cfg, run, opt_cfg=ocfg)(
        plain, adamw.init(ocfg, plain), batch)
    p_sh = partition.model_shardings(cfg, mesh, rules)
    params = params_from_numpy(flat, "cpu", shardings=p_sh)
    opt = partition.distribute(adamw.init(ocfg, params_from_numpy(flat, "cpu")),
                               partition.opt_shardings(p_sh, mesh))
    shape = ShapeConfig("t", job["S"], job["B"], "train")
    layouts = partition.batch_shardings(cfg, shape, mesh, rules)
    dbatch = partition.distribute(batch, {k: layouts[k] for k in batch})
    step = make_train_step(cfg, run, opt_cfg=ocfg, grad_shardings=p_sh)
    with sharding.use_sharding(mesh, rules):
        dp, do, dm = step(params, opt, dbatch)
    err = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(partition.gather(dp)), tree_leaves(p)))
    scale = max(float(b.abs().max()) for b in tree_leaves(p))
    # the first moments are 0.1 x the gradients: each leaf against its own
    # largest |value|
    mom = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
              for a, b in zip(tree_leaves(partition.gather(do.m)),
                              tree_leaves(o.m)) if float(b.abs().max()) > 0)
    placed = sorted({str(tuple(t.placements)) for t in tree_leaves(dp)})
    return {"loss_plain": float(m["loss"]),
            "loss_mesh": float(partition.gather(dm)["loss"]),
            "leaf_err": err, "leaf_scale": scale, "moment_rel_err": mom,
            "placements": placed}

def trainer(arch, m, d, steps):
    cfg = cfg_of(arch)
    tr = Trainer(cfg, DataConfig(seq_len=job["S"], global_batch=job["B"],
                                 vocab_size=cfg.vocab_size, seed=3),
                 TrainerConfig(total_steps=steps, ckpt_every=steps,
                               ckpt_dir=d, ckpt_async=False,
                               log_every=10 ** 9),
                 opt_cfg=adamw.OptimConfig(warmup_steps=1, eps=1e-3),
                 mesh=m, device="cpu")
    tr.train()
    return tr

def decode_parity(arch, batch, steps=6, T=4, rules=None, kv_heads=None):
    """Decode steps at positions 0..T+1 (the last two clamp their write
    to T - 1) with the cache's time dim split by the rules (seq_kv ->
    ("data", "model"): batch 2 takes "data", so time is split 2 ways;
    batch 3 divides nothing, so 4), against the meshless step.  With
    ``rules`` and ``kv_heads`` given: those rules, and a config of that
    many KV heads."""
    cfg = cfg_of(arch)
    if kv_heads:
        cfg = dataclasses.replace(cfg, num_kv_heads=kv_heads)
    rules = {"seq_kv": ("data", "model")} if rules is None else rules
    from types import SimpleNamespace
    from repro_torch.models import layers
    with sharding.use_sharding(mesh, rules):
        by_heads = layers._decode_by_query_heads(
            (batch, 1, cfg.num_heads, cfg.resolved_head_dim),
            cfg.num_kv_heads, {"k": SimpleNamespace(shape=(
                batch, T, cfg.num_kv_heads, cfg.resolved_head_dim))})
    params = init_model(cfg, 0, "cpu")
    cache = init_cache(cfg, batch, T, "cpu")
    dparams = partition.distribute(
        params, partition.model_shardings(cfg, mesh, rules))
    dcache = partition.distribute(
        init_cache(cfg, batch, T, "cpu"),
        partition.cache_shardings(cfg, batch, T, mesh, rules))
    step = make_serve_step(cfg)
    gen = torch.Generator().manual_seed(batch)
    err = 0.0
    for pos in range(steps):
        tok = torch.randint(0, cfg.vocab_size, (batch, 1), generator=gen)
        ref, cache = step(params, cache, tok, pos)
        dtok = partition.distribute(
            tok, partition.Layout(mesh, (Replicate(), Replicate())))
        with sharding.use_sharding(mesh, rules):
            got, dcache = step(dparams, dcache, dtok, pos)
        err = max(err, float((got.full_tensor() - ref).abs().max()
                             / ref.abs().max()))
    return {"logit_rel_err": err, "by_heads": by_heads,
            "cache_err": max(float((a - b).abs().max()) for a, b in zip(
                tree_leaves(partition.gather(dcache)), tree_leaves(cache))),
            "time_ways": sorted({time_ways(name, t)
                                 for name, t in leaves_named(dcache)
                                 if name in TIME_DIM})}

def leaves_named(tree):
    """(key, leaf) of every leaf of a nested dict."""
    for k, v in tree.items():
        yield from leaves_named(v) if isinstance(v, dict) else [(k, v)]

#: a cache leaf's time dim, counted from its end
TIME_DIM = {"k": -3, "v": -3, "c_kv": -2, "k_rope": -2}

def time_ways(name, t):
    """Over how many ranks the leaf's time dim is split."""
    dim = t.dim() + TIME_DIM[name]
    return int(np.prod([mesh.size(m) for m, p in enumerate(t.placements)
                        if p.is_shard(dim)]))

for arch in job.get("steps", []):
    out[arch] = step_parity(arch)
for name, arch, shape, run in job.get("variants", []):
    out[name] = step_parity(
        arch, DeviceMesh("cpu", torch.arange(world).reshape(shape),
                         mesh_dim_names=("data", "model")), run)
for arch in job.get("decode", []):
    out["decode:" + arch] = {str(b): decode_parity(arch, b) for b in (2, 3)}
for arch in job.get("decode_by_heads", []):
    out["by_heads:" + arch] = {str(b): decode_parity(arch, b, rules={},
                                                     kv_heads=1)
                               for b in (2, 3)}
if job.get("trainer"):
    arch = job["trainer"]
    a = trainer(arch, None, tempfile.mkdtemp(), 2)
    b = trainer(arch, mesh, os.path.join(job["dir"], "ckpt"), 2)
    out["trainer"] = {
        "plain": [h["loss"] for h in a.history],
        "mesh": [h["loss"] for h in b.history],
        "leaf_err": max(float((x - y).abs().max()) for x, y in zip(
            tree_leaves(partition.gather(b.params)),
            tree_leaves(a.params)))}
    saved = partition.gather(b.params)          # a collective: every rank
    if rank == 0:
        torch.save(saved, os.path.join(job["dir"], "saved.pt"))
if job.get("restore"):
    arch = job["restore"]
    cfg = cfg_of(arch)
    sh = partition.model_shardings(cfg, mesh)
    res = CheckpointManager(os.path.join(job["dir"], "ckpt")).restore(
        template={"params": abstract_model(cfg),
                  "opt": {"m": abstract_model(cfg), "v": abstract_model(cfg),
                          "count": torch.empty((), dtype=torch.int32,
                                               device="meta")}},
        shardings={"params": sh, "opt": {"m": sh, "v": sh, "count":
                   partition.opt_shardings(sh, mesh).count}})
    saved = torch.load(os.path.join(job["dir"], "saved.pt"))
    restored = res["tree"]["params"]
    out["restore"] = {
        "step": res["step"],
        "equal": all(torch.equal(x, y) for x, y in zip(
            tree_leaves(partition.gather(restored)), tree_leaves(saved))),
        "placements": sorted({str(tuple(t.placements))
                              for t in tree_leaves(restored)})}
if rank == 0:
    with open(os.path.join(job["dir"], "out-%s.json" % job["name"]), "w") as f:
        json.dump(out, f)
dist.destroy_process_group()
'''


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(job, tmp):
    """Start the worker on ``prod(job['mesh'])`` gloo ranks."""
    world = int(np.prod(job["mesh"]))
    job = dict(job, dir=str(tmp), B=B, S=S)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               PORT=str(_free_port()), WORLD_SIZE=str(world),
               JOB=json.dumps(job), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER],
                              env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    return job, procs


def _finish(started, timeout=240):
    """Wait for a started worker; rank 0's JSON."""
    job, procs = started
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
        errs.append((p.returncode, err))
    # a rank whose peer died reports a closed connection: show the first
    # failure that is not one
    failed = [err for rc, err in errs if rc]
    assert not failed, next((e for e in failed if "Connection closed" not in
                             e), failed[0])[-4000:]
    with open(os.path.join(job["dir"], f"out-{job['name']}.json")) as f:
        return json.load(f)


STEP_ARCHS = {"granite-3-2b": (4, 2), "mamba2-130m": (2, 2),
              "deepseek-v3-671b": (2, 2), "qwen2.5-32b": (2, 2)}


def _write_inputs(arch, tmp):
    """Write seeded float32 weights (the port's initialiser, as numpy) and
    a seeded batch for ``arch``'s smoke config."""
    cfg = dataclasses.replace(get_arch(arch).smoke, param_dtype="float32")
    params = init_model(cfg, 0, "cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    np.savez(os.path.join(tmp, arch + ".npz"),
             **{k: v.numpy() for k, v in _flat(params).items()},
             **{"batch:tokens": tokens, "batch:labels": labels})


def _jax_loss(arch, tmp):
    """The JAX package's single-device loss on the written weights."""
    ref_cfg = dataclasses.replace(ref_configs.get_config(arch, smoke=True),
                                  param_dtype="float32")
    with np.load(os.path.join(tmp, arch + ".npz")) as z:
        flat = {k: z[k] for k in z.files}
    tree = {}
    for path, a in flat.items():
        if ":" in path:
            continue
        node = tree
        *parents, leaf = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = jax.numpy.asarray(a)
    batch = {"tokens": flat["batch:tokens"], "labels": flat["batch:labels"]}
    loss, _ = jax.jit(lambda p, b: ref_models.loss_fn(ref_cfg, p, b))(
        tree, batch)
    return float(loss)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


@pytest.fixture(scope="module")
def gloo_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("gloo")


#: sharded steps on the 8 ranks of ``gloo_4x2`` on meshes of their own,
#: under run configs of their own: qwen2.5's sequence-parallel attention
#: recomputed (``remat="full"``: each saved layer input a sequence shard),
#: and granite's expanded attention on 4 "model" ranks, which its 2 KV
#: heads do not divide (``sharding.project_heads``), without and with
#: recomputation
VARIANTS = {
    "qwen2.5-32b-4x2-remat": ("qwen2.5-32b", (4, 2), {"remat": "full"}),
    "granite-3-2b-2x4-expanded": ("granite-3-2b", (2, 4),
                                  {"attn_mode": "expanded"}),
    "granite-3-2b-2x4-expanded-remat": ("granite-3-2b", (2, 4),
                                        {"attn_mode": "expanded",
                                         "remat": "full"}),
}


@pytest.fixture(scope="module")
def gloo_4x2(gloo_dir):
    """8 ranks on (4, 2): granite's sharded step, the trainer with and
    without a mesh, the trainer's step-2 checkpoint, and the VARIANTS.
    The JAX loss is computed while the ranks run."""
    _write_inputs("granite-3-2b", gloo_dir)
    _write_inputs("qwen2.5-32b", gloo_dir)
    run = _start({"name": "a", "mesh": [4, 2], "steps": ["granite-3-2b"],
                  "trainer": "granite-3-2b",
                  "variants": [[k, a, list(m), r]
                               for k, (a, m, r) in VARIANTS.items()]},
                 gloo_dir)
    jax_loss = {arch: _jax_loss(arch, gloo_dir)
                for arch in ("granite-3-2b", "qwen2.5-32b")}
    return {"jax": jax_loss, **_finish(run)}


@pytest.fixture(scope="module")
def gloo_mamba2(gloo_dir, gloo_4x2):
    """4 ranks on (2, 2): mamba2's sharded step, and the (4, 2)
    checkpoint restored onto this mesh."""
    _write_inputs("mamba2-130m", gloo_dir)
    run = _start({"name": "b", "mesh": [2, 2], "steps": ["mamba2-130m"],
                  "restore": "granite-3-2b"}, gloo_dir)
    jax_loss = _jax_loss("mamba2-130m", gloo_dir)
    return {"jax": {"mamba2-130m": jax_loss}, **_finish(run)}


@pytest.fixture(scope="module")
def gloo_deepseek(gloo_dir):
    """4 ranks on (2, 2): deepseek's sharded step (MoE and MLA), and
    qwen2.5's under its sequence-parallel attention rule (seq_attn ->
    "model")."""
    archs = ["deepseek-v3-671b", "qwen2.5-32b"]
    for arch in archs:
        _write_inputs(arch, gloo_dir)
    run = _start({"name": "c", "mesh": [2, 2], "steps": archs}, gloo_dir)
    jax_loss = {arch: _jax_loss(arch, gloo_dir) for arch in archs}
    return {"jax": jax_loss, **_finish(run)}


@pytest.fixture(scope="module")
def gloo_decode(gloo_dir):
    """4 ranks on (2, 2): decode over a time-split cache for the three
    attention kinds, and decode split by query heads."""
    return _finish(_start({"name": "d", "mesh": [2, 2],
                           "decode": list(DECODE_ARCHS),
                           "decode_by_heads": list(BY_HEADS_ARCHS)},
                          gloo_dir))


#: decode over a time-split cache: GQA, MLA, and the hybrid's shared
#: attention
DECODE_ARCHS = ("granite-3-2b", "deepseek-v3-671b", "zamba2-7b")

#: decode split by query heads: one KV head, whole on every rank
BY_HEADS_ARCHS = ("granite-3-2b", "zamba2-7b")


FIXTURE = {"granite-3-2b": "gloo_4x2", "mamba2-130m": "gloo_mamba2",
           "deepseek-v3-671b": "gloo_deepseek", "qwen2.5-32b": "gloo_deepseek"}


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


@pytest.mark.parametrize("arch", list(STEP_ARCHS), ids=lambda a: (
    f"{a}-{'x'.join(map(str, STEP_ARCHS[a]))}"))
def test_sharded_train_step_matches_the_meshless_step_and_jax(request,
                                                              arch):
    gloo_runs = request.getfixturevalue(FIXTURE[arch])
    r = gloo_runs[arch]
    assert _rel(r["loss_mesh"], r["loss_plain"]) < TOL, r
    assert _rel(r["loss_mesh"], gloo_runs["jax"][arch]) < TOL, (
        r, gloo_runs["jax"][arch])
    assert r["leaf_err"] < TOL * max(1.0, r["leaf_scale"]), r
    assert r["moment_rel_err"] < TOL, r               # the gradients
    # the update kept the parameters' layouts (grad_shardings given)
    assert any("Shard" in p for p in r["placements"]), r["placements"]


@pytest.mark.parametrize("name", list(VARIANTS))
def test_sharded_step_under_its_run_config_matches_the_meshless_step(
        gloo_4x2, name):
    """The loss, every updated leaf and every first moment (the gradients)
    of the sharded step against the meshless step under the same run
    config, and the loss against the JAX package's on the same inputs
    (neither recomputation nor the attention mode changes it), within the
    file's tolerance."""
    r = gloo_4x2[name]
    jax_loss = gloo_4x2["jax"][VARIANTS[name][0]]
    assert _rel(r["loss_mesh"], r["loss_plain"]) < TOL, r
    assert _rel(r["loss_mesh"], jax_loss) < TOL, (r, jax_loss)
    assert r["leaf_err"] < TOL * max(1.0, r["leaf_scale"]), r
    assert r["moment_rel_err"] < TOL, r
    assert any("Shard" in p for p in r["placements"]), r["placements"]


def test_trainer_on_a_mesh_equals_the_meshless_trainer(gloo_4x2):
    r = gloo_4x2["trainer"]
    assert len(r["mesh"]) == len(r["plain"]) == 2
    for a, b in zip(r["mesh"], r["plain"]):
        assert _rel(a, b) < TOL, r
    assert r["leaf_err"] < TOL, r


def test_checkpoint_saved_on_4x2_restores_bit_equal_onto_2x2(gloo_mamba2):
    r = gloo_mamba2["restore"]
    assert r["step"] == 2 and r["equal"], r
    assert any("Shard" in p for p in r["placements"]), r


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_over_a_time_split_cache_matches_the_meshless_decode(
        gloo_decode, arch):
    """Each rank attends over its chunk of the cache's time steps and the
    chunks merge by their log-sum-exp; the rank holding the write index
    writes.  Logits and the whole cache against the meshless steps."""
    for batch, r in gloo_decode["decode:" + arch].items():
        assert r["logit_rel_err"] < TOL, (batch, r)
        assert r["cache_err"] < TOL, (batch, r)
        # batch 2 takes the data axis, so time is split over model only;
        # batch 3 divides neither, so time takes both
        assert r["time_ways"] == [{"2": 2, "3": 4}[batch]], (batch, r)


@pytest.mark.parametrize("arch", BY_HEADS_ARCHS)
def test_decode_split_by_query_heads_matches_the_meshless_decode(
        gloo_decode, arch):
    """One KV head does not divide the "model" axis, the query heads do:
    each rank writes the new k/v into its whole copy of the cache and
    attends for its own query heads.  Logits and the whole cache against
    the meshless steps (batch 3 also leaves "data" to the embedding, so
    the norms reduce a sharded dim)."""
    for batch, r in gloo_decode["by_heads:" + arch].items():
        assert r["by_heads"], (batch, r)
        assert r["logit_rel_err"] < TOL, (batch, r)
        assert r["cache_err"] < TOL, (batch, r)
        assert r["time_ways"] == [1], (batch, r)


def test_input_specs_match_the_jax_shapes_and_dtypes():
    from repro_torch.configs import input_specs
    for arch in ARCH_IDS:
        cfg, ref_cfg = get_arch(arch).full, ref_configs.get_arch(arch).full
        for name in ("train_4k", "prefill_32k", "decode_32k"):
            got = input_specs(cfg, name)
            want = ref_configs.input_specs(ref_cfg, name)
            assert list(got) == list(want)
            for k in got:
                assert got[k].device.type == "meta"
                assert tuple(got[k].shape) == tuple(want[k].shape)
                assert str(got[k].dtype).removeprefix("torch.") == str(
                    want[k].dtype)

