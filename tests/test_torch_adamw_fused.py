"""AdamW's two paths (``repro_torch.optim.adamw.update_``) on the CPU:
which leaves take the leafwise step and how it is counted, what the fused
passes refuse, their host-side layout and DTensor shards
(``repro_torch.optim.fused``; the shards on four gloo ranks), and the CUDA
update's order of operations, emulated in float32 NumPy, against
``adamw._leaf``.  The kernels themselves run only on the card
(``chip_smoke.py``'s ``[adamw]``)."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import trace  # noqa: E402
from repro_torch.models import tree_leaves  # noqa: E402
from repro_torch.optim import adamw, fused  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

F32, BF16 = torch.float32, torch.bfloat16
#: (parameter, gradient, moment_dtype) of every path the fused update takes
COMBOS = [(p, g, m) for p in (F32, BF16) for g in (F32, BF16)
          for m in ("float32", "bfloat16")]


@pytest.fixture
def recording():
    trace.take()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.take()


def _trees(pdt, gdt, moment_dtype, seed=0, shapes=((3, 5), (7,), (2, 2, 3))):
    cfg = adamw.OptimConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                            moment_dtype=moment_dtype)
    rng = np.random.default_rng(seed)
    draw = lambda shape, dt, s=1.0: torch.from_numpy(
        (rng.standard_normal(shape) * s).astype(np.float32)).to(dt)
    names = [f"w{i}" for i in range(len(shapes))]
    params = {n: draw(s, pdt) for n, s in zip(names, shapes)}
    grads = {n: draw(s, gdt, 3.0) for n, s in zip(names, shapes)}
    state = adamw.init(cfg, params)
    mdt = state.m[names[0]].dtype
    state = adamw.OptState(
        m={n: draw(s, mdt, 0.1) for n, s in zip(names, shapes)},
        v={n: draw(s, mdt, 0.1).abs() for n, s in zip(names, shapes)},
        count=torch.tensor(3, dtype=torch.int32))
    return cfg, params, grads, state


def _assert_bits_equal(got, want):
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int16 if a.element_size() == 2
                                  else torch.int32),
                           b.view(torch.int16 if b.element_size() == 2
                                  else torch.int32))


# ------------------------------------------------- which path, and counted

@pytest.mark.parametrize("pdt, gdt, moment_dtype", COMBOS)
def test_update_in_place_equals_update_on_the_cpu(pdt, gdt, moment_dtype,
                                                  recording):
    cfg, params, grads, state = _trees(pdt, gdt, moment_dtype)
    want_p, want_s, want_m = adamw.update(cfg, grads, state, params)
    got_p, got_s, got_m = adamw.update_(cfg, grads, state, params)
    _assert_bits_equal(got_p, want_p)
    _assert_bits_equal(got_s.m, want_s.m)
    _assert_bits_equal(got_s.v, want_s.v)
    assert int(got_s.count) == int(want_s.count) == 4
    assert torch.equal(got_m["grad_norm"], want_m["grad_norm"])
    assert trace.take()["counters"] == {"optim.adamw.leafwise": 1}


def _non_contiguous(pdt, gdt, moment_dtype):
    cfg, params, grads, state = _trees(pdt, gdt, moment_dtype)
    grads["w0"] = grads["w0"].t().contiguous().t()
    assert not grads["w0"].is_contiguous()
    return cfg, params, grads, state


def _cpu(pdt, gdt, moment_dtype):
    return _trees(pdt, gdt, moment_dtype)


@pytest.mark.parametrize("make", [_cpu, _non_contiguous],
                         ids=["cpu", "non_contiguous"])
def test_cpu_and_non_contiguous_leaves_take_the_leafwise_step(make,
                                                              recording):
    cfg, params, grads, state = make(BF16, BF16, "float32")
    leaves = [tree_leaves(t) for t in (params, grads, state.m, state.v)]
    # the passes would take a non-contiguous gradient (as a copy), not CPU
    # leaves
    with pytest.raises(ValueError, match="not all on one CUDA device"):
        fused.Leaves(torch.float32, *leaves)
    want_p, want_s, _ = adamw.update(cfg, grads, state, params)
    adamw.update_(cfg, grads, state, params)
    assert trace.take()["counters"] == {"optim.adamw.leafwise": 1}
    _assert_bits_equal(params, want_p)
    _assert_bits_equal(state.m, want_s.m)
    _assert_bits_equal(state.v, want_s.v)


def test_meta_leaves_take_the_leafwise_step(recording):
    """Shapes traced on the ``meta`` device (the step's traffic count,
    the dry run) go through ``_leaf``: no data, no card."""
    cfg, params, grads, state = _trees(BF16, F32, "float32")
    meta = lambda tree: {k: torch.empty_like(v, device="meta")
                         for k, v in tree.items()}
    state = adamw.OptState(meta(state.m), meta(state.v),
                           torch.zeros((), dtype=torch.int32, device="meta"))
    params, grads = meta(params), meta(grads)
    got_p, got_s, got_m = adamw.update_(cfg, grads, state, params)
    assert trace.take()["counters"] == {"optim.adamw.leafwise": 1}
    assert all(t.device.type == "meta" for t in tree_leaves(got_p))
    assert got_m["grad_norm"].device.type == "meta"


def test_dtensor_leaves_take_the_leafwise_step(recording):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import dryrun
    cfg, params, grads, state = _trees(BF16, F32, "float32")
    want_p, want_s, _ = adamw.update(cfg, grads, state, params)
    with dryrun.fake_world(1):
        mesh = init_device_mesh("cpu", (1,))
        dt = lambda tree: {k: DTensor.from_local(v, mesh, [Replicate()])
                           for k, v in tree.items()}
        d_params, d_grads = dt(params), dt(grads)
        d_state = adamw.OptState(dt(state.m), dt(state.v), state.count)
        leaves = [tree_leaves(t) for t in (d_params, d_grads, d_state.m,
                                           d_state.v)]
        got_mesh, local_leaves, counted = fused.shards(*leaves)
        assert got_mesh is mesh and counted == [True] * len(local_leaves)
        assert all(torch.equal(a, b.to_local())
                   for leaf, *trees in zip(local_leaves, *leaves)
                   for a, b in zip(leaf, trees))
        with pytest.raises(ValueError, match="not all on one CUDA device"):
            fused.Leaves(torch.float32, *leaves)
        with implicit_replication():
            adamw.update_(cfg, d_grads, d_state, d_params)
        local = lambda tree: {k: v.to_local() for k, v in tree.items()}
        got_p, got_m, got_v = (local(d_params), local(d_state.m),
                               local(d_state.v))
    assert trace.take()["counters"] == {"optim.adamw.leafwise": 1}
    _assert_bits_equal(got_p, want_p)
    _assert_bits_equal(got_m, want_s.m)
    _assert_bits_equal(got_v, want_s.v)


@pytest.mark.parametrize("moment_dtype, lengths, reason", [
    (torch.float16, (1, 1, 1, 1), "moments of torch.float16"),
    (torch.float32, (2, 1, 2, 2), "leaf lists empty or of unequal lengths"),
    (torch.float32, (0, 0, 0, 0), "leaf lists empty or of unequal lengths"),
])
def test_why_leafwise_names_what_the_fused_passes_do_not_take(
        moment_dtype, lengths, reason):
    leaf = torch.zeros(4)
    lists = [[leaf] * n for n in lengths]
    with pytest.raises(ValueError, match=reason):
        fused.Leaves(moment_dtype, *lists)


def _leaf_of(p=F32, g=F32, m=F32, v=F32, shape=(4, 6)):
    return [[torch.zeros(shape, dtype=dt)] for dt in (p, g, m, v)]


def _t(leaf):
    leaf[0][0] = torch.zeros(6, 4).t()
    return leaf


def _g_shape(leaf):
    leaf[1][0] = torch.zeros(3, 8)
    return leaf


@pytest.mark.parametrize("lists, reason", [
    (_leaf_of(p=torch.float16), "a parameter of torch.float16"),
    (_leaf_of(g=torch.float16), "a gradient of torch.float16"),
    (_leaf_of(v=BF16), "moments of torch.float32 and torch.bfloat16"),
    (_g_shape(_leaf_of()), "differ in shape"),
    (_t(_leaf_of()), "a parameter or moment is not contiguous"),
    (_leaf_of(), "not all on one CUDA device"),
], ids=["param_f16", "grad_f16", "moments_mixed", "shape", "param_view",
        "cpu"])
def test_the_fused_passes_refuse_what_they_do_not_take(lists, reason):
    with pytest.raises(ValueError, match=reason):
        fused.Leaves(torch.float32, *lists)
    assert fused._lib is None


def test_the_fused_passes_refuse_cpu_tensors_before_any_pointer():
    cfg, params, grads, state = _trees(BF16, BF16, "float32")
    leaves = [tree_leaves(t) for t in (params, grads, state.m, state.v)]
    with pytest.raises(ValueError, match="not all on one CUDA device"):
        fused.Leaves(torch.float32, *leaves)
    with pytest.raises(ValueError, match="empty"):
        fused.Leaves(torch.float32, [], [], [], [])
    assert fused._lib is None


def test_importing_adamw_needs_neither_nvcc_nor_a_card():
    code = ("import repro_torch.optim.adamw as a, repro_torch.optim.fused "
            "as f, repro_torch.kernels.build as b\n"
            "assert f._lib is None and not b._LIBS\n"
            "try:\n    b.nvcc()\nexcept RuntimeError:\n    print('no nvcc')\n")
    env = dict(os.environ, PATH="/nonexistent", NVCC="",
               CUDA_HOME="/nonexistent", CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "no nvcc"


# ------------------------------------------ DTensor shards on four ranks

_SHARDS_WORKER = r"""
import json, os
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.optim import fused

rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
shape = json.loads(os.environ["MESH"])
dist.init_process_group("gloo", init_method="tcp://localhost:%s"
                        % os.environ["PORT"], rank=rank, world_size=world)
mesh = init_device_mesh("cpu", shape)
P = {"R": Replicate(), "S0": Shard(0), "S1": Shard(1)}
# (shape, the parameter's placements, the gradient's): uneven and empty
# shards, a leaf replicated everywhere, a gradient laid out otherwise
LEAVES = [((8, 6), ("S0", "R"), ("S0", "R")),
          ((3, 10), ("R", "S0"), ("R", "S0")),
          ((5, 4), ("R", "R"), ("R", "R")),
          ((6, 9), ("S0", "S1"), ("R", "S0")),
          ((7,), ("R", "S0"), ("S0", "S0"))]
gen = torch.Generator().manual_seed(3)
trees = {k: [] for k in "pgmv"}
whole = []
for size, pp, gp in LEAVES:
    places = [P[x] for x in pp[:mesh.ndim]]
    full = {k: torch.randn(size, generator=gen) for k in "pgmv"}
    whole.append(full)
    for k in "pmv":
        trees[k].append(distribute_tensor(full[k], mesh, places))
    trees["g"].append(distribute_tensor(
        full["g"], mesh, [P[x] for x in gp[:mesh.ndim]]))
got_mesh, shards, counted = fused.shards(trees["p"], trees["g"], trees["m"],
                                        trees["v"])
ok = got_mesh is mesh
for (p, g, m, v), full, d in zip(shards, whole, trees["p"]):
    want_g = distribute_tensor(full["g"], mesh, d.placements).to_local()
    ok = ok and torch.equal(g, want_g) and torch.equal(p, d.to_local())
part = sum((g.double().square().sum() for (_, g, _, _), c
            in zip(shards, counted) if c), torch.zeros((), dtype=torch.float64))
total = fused.mesh_sum(part, mesh)
want = sum(float(f["g"].double().square().sum()) for f in whole)
print(json.dumps({"rank": rank, "ok": bool(ok), "counted": counted,
                  "total": float(total), "want": want}))
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("mesh", [[4], [2, 2], [1, 4]],
                         ids=["4", "2x2", "1x4"])
def test_dtensor_shards_add_up_to_the_whole_tree_over_the_mesh(mesh):
    world = int(np.prod(mesh))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               PORT=str(_free_port()), WORLD_SIZE=str(world),
               MESH=json.dumps(mesh), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _SHARDS_WORKER],
                              env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    outs = []
    for proc in procs:
        try:
            out, err = proc.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        assert proc.returncode == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    for rec in outs:
        assert rec["ok"], rec
        assert rec["total"] == pytest.approx(rec["want"], rel=1e-12)
    # a replicated leaf counts on the mesh's first copy alone
    for rec in outs:
        coordinate = np.unravel_index(rec["rank"], mesh)
        assert rec["counted"][2] == all(c == 0 for c in coordinate)


# ------------------------------------------------------- the host layout

@pytest.mark.parametrize("arrays, n, layout", [
    # every array 16-byte aligned: no head
    ([(4096, 2), (8192, 2), (1024, 4), (2048, 4)], 100, (0, 12)),
    # bfloat16 starting 3 elements past a boundary: 5 elements first
    ([(4096 + 6, 2)], 100, (5, 11)),
    # float32 one element past a boundary: 3 first
    ([(4096 + 4, 4)], 20, (3, 2)),
    # bfloat16 5 past and float32 1 past: 3 elements align both
    ([(4096 + 10, 2), (8192 + 4, 4)], 40, (3, 4)),
    # no common head (bfloat16 needs 3, float32 needs 0 or 4): elementwise
    ([(4096 + 10, 2), (8192, 4)], 40, (40, 0)),
    # fewer elements than the head needs: elementwise
    ([(4096 + 6, 2)], 4, (4, 0)),
    ([(4096, 4)], 0, (0, 0)),
    ([(4096, 4)], 7, (0, 0)),
    ([(4096, 4)], 8, (0, 1)),
])
def test_vector_layout_against_hand_computed_heads(arrays, n, layout):
    head, nvec = fused.vector_layout(arrays, n, 8, 16)
    assert (head, nvec) == layout
    assert 0 <= head <= n and head + nvec * 8 <= n


@pytest.mark.parametrize("n, nvec, blocks", [
    (0, 0, 0), (5, 0, 1), (8, 1, 1), (8192, 1024, 1), (8193, 1024, 1),
    (8200, 1025, 2), (40 * 2048 * 8192, 40 * 2048 * 1024, 81920),
])
def test_norm_blocks_against_hand_computed_counts(n, nvec, blocks):
    assert fused.norm_blocks(n, nvec, 1024) == blocks


# ------------------------------------- the update's order of operations

def _kernel_step(cfg, p, g, m, v, scale, lr, c1, c2):
    """``adamw.cu``'s ``step`` in float32 NumPy: each operation rounded,
    the Python constants rounded from their doubles; results cast to the
    leaves' dtypes with round-to-nearest-even.  The square root is
    PyTorch's: on the CPU it is not always the correctly rounded one
    (``__fsqrt_rn``, and CUDA's), and the point here is the order."""
    f = np.float32
    b1, b2 = cfg.betas
    np_ = lambda t: t.float().numpy()
    p32, g32, m32, v32 = np_(p), np_(g), np_(m), np_(v)
    scale, lr, c1, c2 = (f(float(x)) for x in (scale, lr, c1, c2))
    g32 = g32 * scale
    m32 = f(b1) * m32 + f(1 - b1) * g32
    v32 = f(b2) * v32 + (f(1 - b2) * g32) * g32
    sqrt = lambda x: torch.sqrt(torch.from_numpy(x)).numpy()
    upd = (m32 / c1) / (sqrt(v32 / c2) + f(cfg.eps))
    p32 = p32 - lr * (upd + f(cfg.weight_decay) * p32)
    back = lambda x, like: torch.from_numpy(x).to(like.dtype)
    return back(p32, p), back(m32, m), back(v32, v)


@pytest.mark.parametrize("pdt, gdt, moment_dtype", COMBOS)
def test_the_kernel_s_order_of_operations_is_leaf_s(pdt, gdt, moment_dtype):
    cfg, params, grads, state = _trees(pdt, gdt, moment_dtype, seed=7,
                                       shapes=((64, 33),))
    scalars = adamw._scalars(cfg, adamw.global_norm(grads), state.count)
    assert float(scalars[0]) < 1.0          # the clip is on
    args = (params["w0"], grads["w0"], state.m["w0"], state.v["w0"])
    _assert_bits_equal(dict(zip("pmv", _kernel_step(cfg, *args, *scalars))),
                       dict(zip("pmv", adamw._leaf(cfg, *args, *scalars))))
