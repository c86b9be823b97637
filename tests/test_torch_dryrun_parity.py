"""The port's fake-world dry-run against the JAX package's compiled
dry-run: per-chip FLOPs, collective bytes and memory of seven smoke-size
cells, on a 1x1 and a 2x4 ("data", "model") mesh, on the CPU.

JAX side: one process per group of cells, with 8 virtual CPU devices and
``JAX_PLATFORMS=cpu`` set before JAX starts (``repro.launch.dryrun`` sets
``XLA_FLAGS`` to 512 devices when imported; the backend is started after
the flag is set back).  The mesh is built here with Auto axes: the JAX
package's ``make_production_mesh`` builds Explicit ones, which its
``shard()`` cannot lower under the installed JAX (ROADMAP, faults of the
reference).  Each cell is ``_build_lowered(smoke, shape, run_m, ...)
.compile()`` read by ``_module_costs`` and ``_mem_analysis``, at
``measure_costs``' run config ``run_m``.

Port side, in this process: ``analyze_cell`` at the same run config,
whose cost keys are a full-depth trace of that step and whose memory is
the same trace's peak.

What the comparison corrects for, and why (ROADMAP, faults of the
reference, has the op and bytes of each):

* XLA's CPU backend runs every bfloat16 operation in float32 and counts
  the converts it adds (one FLOP an element); on the card there are
  none.  The JAX FLOPs are taken net of them
  (``tools/dryrun_parity.py::emulation_converts``, checked on one
  product below).
* The JAX decode step scans its layers whatever ``scan_blocks`` says, and
  ``cost_analysis`` counts a loop body once: decode cells run at one
  layer on both sides, where the count is exact.

Run it alone with
``JAX_PLATFORMS=cpu PYTHONPATH=src python -m pytest -q
tests/test_torch_dryrun_parity.py``.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: ``tests/test_torch_dryrun.py``'s SMALL shapes: sequence 64, batch 8
SEQ, BATCH = 64, 8
#: id -> (arch, shape name, kind)
CELLS = {
    "granite-train": ("granite-3-2b", "train_4k", "train"),
    "granite-prefill": ("granite-3-2b", "prefill_32k", "prefill"),
    "granite-decode": ("granite-3-2b", "decode_32k", "decode"),
    "mamba2-train": ("mamba2-130m", "train_4k", "train"),
    "mamba2-decode": ("mamba2-130m", "decode_32k", "decode"),
    "qwen2.5-train": ("qwen2.5-32b", "train_4k", "train"),
    "zamba2-train": ("zamba2-7b", "train_4k", "train"),
}
MESHES = ((1, 1), (2, 4))

#: the bounds: FLOPs port/JAX on one chip; the 2x4 ratio over the 1x1
#: ratio (FLOPs, memory a device); collective bytes at 2x4 over JAX's
FLOPS_ONE_CHIP = (0.85, 1.15)
FLOPS_SCALE = 1.2
GATHER_LIKE = 1.5
WEIGHTED = 1.5
MEMORY_SCALE = 1.5

#: all-gather, all-to-all and collective-permute: the ops that move a
#: buffer to ranks that did not hold it (a CPU mesh turns DTensor's
#: all-to-all into an all-gather)
GATHER_OPS = ("all-gather", "all-to-all", "collective-permute")

#: a decode step's product: x (rows on "data") by w (rows on "data",
#: columns on "model")
DECODE_X, DECODE_W = (8, 512), (512, 1024)
#: a decode step's head on a 2x2 mesh: x (rows on "data") by w (rows on
#: "data", its columns on no mesh axis: a vocabulary "model" does not
#: divide)
HEAD_X, HEAD_W = (16, 256), (256, 1000)

_JAX = (f"DECODE_X, DECODE_W = {DECODE_X}, {DECODE_W}\n"
        f"HEAD_X, HEAD_W = {HEAD_X}, {HEAD_W}\n") + r'''
import dataclasses, json, os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
from repro.launch import dryrun as d      # sets XLA_FLAGS to 512 devices
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from jax.sharding import AxisType
from repro.configs import get_arch
from repro.dist import sharding
from repro.models.config import ShapeConfig

assert len(jax.devices()) == 8, jax.devices()

sys.path.insert(0, os.path.join(sys.argv[2], "tools"))
from dryrun_parity import emulation_converts

out = {}
for key, arch, sname, kind, mesh_shape, layers, seq, batch in json.loads(
        sys.argv[1]):
    cfg = get_arch(arch).smoke
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    shape = ShapeConfig(sname, seq, batch, kind)
    run = d.default_run_config(arch, sname)
    run_m = dataclasses.replace(run, scan_blocks=False, ce_chunk=0,
                                attn_chunk=0, microbatch=1)
    n = mesh_shape[0] * mesh_shape[1]
    mesh = jax.make_mesh(tuple(mesh_shape), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:n])
    rules = dict(sharding.DEFAULT_RULES, **d.default_rules_override(arch))
    compiled = d._build_lowered(cfg, shape, run_m, mesh, rules,
                                d.default_opt_config(arch)).compile()
    out[key] = {"costs": d._module_costs(compiled),
                "memory": d._mem_analysis(compiled),
                "emulation": emulation_converts(compiled.as_text())}
if len(sys.argv) > 3:                       # the instrument's own check
    import jax.numpy as jnp
    a = jnp.ones((64, 32), jnp.bfloat16)
    b = jnp.ones((32, 48), jnp.bfloat16)
    c = jax.jit(lambda x, y: x @ y).lower(a, b).compile()
    out["product"] = {"flops": c.cost_analysis()["flops"],
                      "emulation": emulation_converts(c.as_text())}
    from jax.sharding import NamedSharding, PartitionSpec as P
    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    x = jax.ShapeDtypeStruct(DECODE_X, jnp.float32,
                             sharding=NamedSharding(mesh, P("data", None)))
    w = jax.ShapeDtypeStruct(DECODE_W, jnp.float32,
                             sharding=NamedSharding(mesh, P("data", "model")))
    c = jax.jit(lambda x, y: x @ y).lower(x, w).compile()
    out["decode_product"] = d._module_costs(c)["coll_by_op"]
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:4])
    x = jax.ShapeDtypeStruct(HEAD_X, jnp.float32,
                             sharding=NamedSharding(mesh, P("data", None)))
    w = jax.ShapeDtypeStruct(HEAD_W, jnp.float32,
                             sharding=NamedSharding(mesh, P("data", None)))
    c = jax.jit(lambda x, y: x @ y).lower(x, w).compile()
    out["head_product"] = d._module_costs(c)["coll_by_op"]
print(json.dumps(out))
'''


#: the layout repairs' smoke cases, each against the JAX compile of the
#: same step at ``run_m`` on the 2x4 Auto-axes mesh: qwen2.5's
#: sequence-parallel step under ``remat="full"``, whose saved layer
#: inputs are sequence shards; and granite's expanded attention with 16
#: query heads of width 48 over its 2 KV heads, which do not divide the 4
#: "model" ranks (48 is the width of no other product of the step, so
#: the k/v products can be told apart by their shapes)
KV_CFG = {"num_heads": 16, "head_dim": 48}
KV_HD = 48

_JAX_LAYOUTS = (f"SEQ, BATCH, KV_CFG = {SEQ}, {BATCH}, {KV_CFG}\n") + r'''
import dataclasses, json, os, re, sys
sys.path.insert(0, os.path.join(sys.argv[1], "tools"))
import dryrun_parity as t
peak = t.jax_peak("qwen2.5-32b", "train_4k", 8, 10 ** 6, smoke=True, seq=SEQ,
                  batch=BATCH, run_m=True, mesh_shape=(2, 4))
import jax
from jax.sharding import AxisType
from repro.configs import get_arch
from repro.dist import sharding
from repro.launch import dryrun as d
from repro.models.config import ShapeConfig
cfg = dataclasses.replace(get_arch("granite-3-2b").smoke, **KV_CFG)
run = d.default_run_config("granite-3-2b", "train_4k")
run_m = dataclasses.replace(run, scan_blocks=False, ce_chunk=0,
                            attn_chunk=0, microbatch=1)
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:8])
compiled = d._build_lowered(cfg, ShapeConfig("train_4k", SEQ, BATCH, "train"),
                            run_m, mesh, dict(sharding.DEFAULT_RULES),
                            d.default_opt_config("granite-3-2b")).compile()
text = compiled.as_text()
moves = [[int(x) for x in m.group(1).split(",") if x] for m in re.finditer(
    r"= \w+\[([\d,]*)\]\S* (?:all-gather|collective-permute|all-to-all)\(",
    text)]
print(json.dumps({"peak": peak, "kv_dots": t.dot_flops(text, "dhk->bshk"),
                  "kv_moves": moves}))
'''


def _layers(kind):
    """Decode cells run at one layer (the module docstring says why)."""
    return 1 if kind == "decode" else None


def _key(cell, mesh_shape):
    return f"{cell}|{mesh_shape[0]}x{mesh_shape[1]}"


def _jax_groups():
    """The JAX compiles in four processes of about equal work: zamba2's
    two (the longest), mamba2's, and the dense cells'."""
    jobs = [[_key(c, m), *CELLS[c], list(m), _layers(CELLS[c][2]), SEQ,
             BATCH] for c in CELLS for m in MESHES]
    zamba = [j for j in jobs if j[1] == "zamba2-7b"]
    return [zamba[:1], zamba[1:],
            [j for j in jobs if j[1] == "mamba2-130m"],
            [j for j in jobs if j[1] in ("granite-3-2b", "qwen2.5-32b")]]


def _port(cell, mesh_shape):
    arch, sname, kind = CELLS[cell]
    cfg = get_arch(arch).smoke
    if _layers(kind):
        cfg = dataclasses.replace(cfg, num_layers=_layers(kind))
    run = dryrun.measurement_run(dryrun.default_run_config(arch, sname))
    return dryrun.analyze_cell(arch, ShapeConfig(sname, SEQ, BATCH, kind),
                               mesh_shape=mesh_shape, cfg=cfg,
                               device_type="cpu", run=run)


@pytest.fixture(scope="module")
def both():
    """{"jax": {key: record}, "port": {key: record}}: the JAX processes
    run while this process traces the port's cells."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _JAX, json.dumps(g), REPO]
        + (["check"] if i == 0 else []),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i, g in enumerate(_jax_groups())]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", _JAX_LAYOUTS, REPO], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env))
    try:
        port = {_key(c, m): _port(c, m) for c in CELLS for m in MESHES}
        port["layouts"] = _port_layouts()
    finally:
        outs = [p.communicate(timeout=600) for p in procs]
    jax_out = {}
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        jax_out.update(json.loads(out.strip().splitlines()[-1]))
    return {"jax": jax_out, "port": port}


def _port_layouts():
    """The port's side of the layout repairs' cases: qwen2.5's peak
    buffers (``tools/dryrun_parity.py::port_peak``), and granite's
    products (M, K, N) and collectives, each local to rank 0."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import dryrun_parity
    from repro_torch.dist import sharding

    shape = ShapeConfig("train_4k", SEQ, BATCH, "train")
    run = dryrun.measurement_run(dryrun.default_run_config("qwen2.5-32b",
                                                           "train_4k"))
    peak = dryrun_parity.port_peak(
        "qwen2.5-32b", "train_4k", 10 ** 6, cfg=get_arch("qwen2.5-32b").smoke,
        shape=shape, mesh_shape=(2, 4), run=run, device_type="cpu")

    products = []

    class Products(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            if func is torch.ops.aten.mm.default:
                products.append((args[0].shape[0], args[0].shape[1],
                                 args[1].shape[1]))
            return func(*args, **(kwargs or {}))

    cfg = dataclasses.replace(get_arch("granite-3-2b").smoke, **KV_CFG)
    run = dryrun.measurement_run(dryrun.default_run_config("granite-3-2b",
                                                           "train_4k"))
    with dryrun._cell_mesh(False, (2, 4), "cpu") as mesh, Products():
        trace = dryrun._traced_step(cfg, shape, run, mesh,
                                    dict(sharding.DEFAULT_RULES),
                                    dryrun.default_opt_config("granite-3-2b"))
    moves = [list(r.shape) for r in trace.records
             if r.op.rsplit(".", 1)[-1] in ("all_gather_into_tensor",
                                            "all_to_all_single")]
    return {"peak": peak, "products": products, "moves": moves}


def _jax_flops(rec):
    """XLA's FLOPs net of the CPU backend's bfloat16 converts."""
    return rec["costs"]["flops"] - rec["emulation"]


def _flops_ratio(both, cell, mesh_shape):
    k = _key(cell, mesh_shape)
    return both["port"][k]["flops_per_chip"] / _jax_flops(both["jax"][k])


def test_cpu_backend_converts_are_what_the_adjustment_removes(both):
    """A bfloat16 product (64x32 by 32x48): XLA counts 2MNK and a convert
    per element of both operands and of the result; net of the converts
    it is the product alone."""
    rec = both["jax"]["product"]
    assert rec["emulation"] == 64 * 32 + 32 * 48 + 64 * 48
    assert rec["flops"] - rec["emulation"] == 2 * 64 * 48 * 32


def _product_collectives(mesh_shape, x_shape, w_shape, w_model):
    """``sharding.matmul``'s collectives (bytes by op) for x (rows on
    "data") by w (rows on "data", columns on "model" if ``w_model``) in
    a fake world of ``mesh_shape``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.core import cost
    from repro_torch.dist import sharding

    def meta(shape, placements, mesh):
        local = list(shape)
        for m, p in enumerate(placements):
            if isinstance(p, Shard):
                local[p.dim] //= mesh.size(m)
        return DTensor.from_local(torch.empty(local, device="meta"), mesh,
                                  placements, shape=torch.Size(shape),
                                  stride=(shape[1], 1))

    with dryrun.fake_world(mesh_shape[0] * mesh_shape[1]):
        mesh = dryrun._mesh(mesh_shape, "cpu")
        x = meta(x_shape, [Shard(0), Replicate()], mesh)
        w = meta(w_shape, [Shard(0), Shard(1) if w_model else Replicate()],
                 mesh)
        trace = cost.OpTrace()
        with trace:
            sharding.matmul(x, w)
    return trace.collectives().bytes_by_op


def test_a_decode_product_moves_what_gspmd_moves(both):
    """``sharding.matmul`` on the decode product above, against the JAX
    compile of ``x @ w`` with the same shardings: the same collectives,
    byte for byte (the weight's shard gathered over "data")."""
    got = _product_collectives((2, 4), DECODE_X, DECODE_W, True)
    want = both["jax"]["decode_product"]
    assert want["all-gather"] > 0
    assert got == want, want


def test_a_decode_head_moves_one_weight_shard_as_gspmd_does(both):
    """The head above: GSPMD splits the contraction over "model" (free in
    both operands) and sends each rank the one weight shard it then needs
    (a collective-permute); the port moves the same shard (an all-to-all
    that sends one shard a rank), byte for byte, where DTensor alone
    would gather the weight over "data".  The result stays partial over
    "model" in the port; the JAX compile, whose output is unconstrained,
    all-reduces it there."""
    got = _product_collectives((2, 2), HEAD_X, HEAD_W, False)
    want = both["jax"]["head_product"]
    shard = HEAD_W[0] // 2 * HEAD_W[1] * 4
    assert want["collective-permute"] == shard and want["all-gather"] == 0
    assert got["all-to-all"] == shard
    assert sum(got[op] for op in GATHER_OPS) == \
        sum(want[op] for op in GATHER_OPS)


@pytest.mark.parametrize("cell", list(CELLS))
def test_flops_on_one_chip_match_the_reference(both, cell):
    lo, hi = FLOPS_ONE_CHIP
    r = _flops_ratio(both, cell, (1, 1))
    assert lo <= r <= hi, (cell, r)


@pytest.mark.parametrize("cell", list(CELLS))
def test_flops_fall_with_the_mesh_as_the_reference_s_do(both, cell):
    """Per-chip FLOPs from 1x1 to 2x4: the port's ratio to JAX's stays
    within FLOPS_SCALE of its 1x1 ratio, so the port repeats no work on
    every rank that the reference splits."""
    scale = _flops_ratio(both, cell, (2, 4)) / _flops_ratio(both, cell,
                                                            (1, 1))
    assert 1 / FLOPS_SCALE <= scale <= FLOPS_SCALE, (cell, scale)


@pytest.mark.parametrize("cell", list(CELLS))
def test_gather_like_bytes_at_most_the_reference_s(both, cell):
    k = _key(cell, (2, 4))
    port = sum(both["port"][k]["collective_by_op"][op] for op in GATHER_OPS)
    ref = sum(both["jax"][k]["costs"]["coll_by_op"][op] for op in GATHER_OPS)
    assert ref > 0 and port <= GATHER_LIKE * ref, (cell, port, ref)


@pytest.mark.parametrize("cell", list(CELLS))
def test_weighted_collective_bytes_at_most_the_reference_s(both, cell):
    """All-reduce bytes count twice (a ring moves the buffer twice), as
    both packages weigh them."""
    k = _key(cell, (2, 4))
    port = both["port"][k]["collective_weighted_bytes"]
    ref = both["jax"][k]["costs"]["coll_weighted"]
    assert ref > 0 and port <= WEIGHTED * ref, (cell, port, ref)


@pytest.mark.parametrize("cell", list(CELLS))
def test_memory_a_device_falls_with_the_mesh_as_the_reference_s_does(
        both, cell):
    def ratio(m):
        k = _key(cell, m)
        return (both["port"][k]["memory"]["total_bytes_per_device"]
                / both["jax"][k]["memory"]["total_bytes_per_device"])
    scale = ratio((2, 4)) / ratio((1, 1))
    assert 1 / MEMORY_SCALE <= scale <= MEMORY_SCALE, (cell, scale)


@pytest.mark.parametrize("cell", list(CELLS))
def test_one_chip_moves_no_collective_bytes_on_either_side(both, cell):
    k = _key(cell, (1, 1))
    assert both["port"][k]["collective_bytes_per_chip"] == 0
    assert both["jax"][k]["costs"]["coll_total"] == 0
    assert both["port"][k]["mesh"] == "1x1"


def test_a_sequence_parallel_step_saves_sequence_shards_as_the_reference(
        both):
    """qwen2.5 smoke under ``remat="full"`` at 2x4 ("seq_attn" on
    "model"): at the memory peak both sides hold each saved layer input
    (the residual stream's forward adds) as its rank's quarter of the
    sequence, (B / 2, S / 4, d), and neither holds one whole; the port's
    gather-like bytes stay at most the reference's."""
    cfg = get_arch("qwen2.5-32b").smoke
    shard, whole = ([BATCH // 2, s, cfg.d_model] for s in (SEQ // 4, SEQ))

    def jax_adds(shp):
        return sum(1 for b in both["jax"]["peak"]["buffers"]
                   if b["op"].endswith("jvp()/add")
                   and b["shape"].startswith(
                       "f32[" + ",".join(map(str, shp)) + "]"))

    def port_adds(shp):
        return sum(b["count"] for b in both["port"]["layouts"]["peak"][
            "buffers"] if b["op"] == "aten.add" and b["shape"] == shp
            and b["dtype"] == "torch.bfloat16")

    assert jax_adds(shard) >= 1 and jax_adds(whole) == 0
    assert port_adds(shard) >= jax_adds(shard), both["port"]["layouts"]
    assert port_adds(whole) == 0
    k = _key("qwen2.5-train", (2, 4))
    port = sum(both["port"][k]["collective_by_op"][op] for op in GATHER_OPS)
    ref = sum(both["jax"][k]["costs"]["coll_by_op"][op] for op in GATHER_OPS)
    assert port <= ref, (port, ref)


def _kv(dims, k):
    """Whether a product (its output dims, its contraction) is a k or v
    projection's, forward or backward: only those have the width of one
    or both KV heads (a rank's 4 query heads are 192 wide)."""
    return bool({KV_HD, 2 * KV_HD} & {*dims, k})


def test_k_v_products_split_over_query_heads_as_the_reference_s(both):
    """granite smoke with 16 query heads over 2 KV heads at 2x4: the k and
    v products' FLOPs a chip (forward, recomputed, and both backward
    products) within 5 % of the JAX compile's, where the port used to
    compute all KV heads on every "model" rank; each rank gathers only
    its own KV head's columns of ``wk`` and ``wv`` (d, 1, hd), as the
    reference does, never both heads, and no k or v activation."""
    port = sum(2 * m * k * n for m, k, n in both["port"]["layouts"][
        "products"] if _kv((m, n), k))
    ref = sum(f for dims, k, f in both["jax"]["kv_dots"] if _kv(dims, k))
    assert ref > 0 and 0.95 <= port / ref <= 1.05, (port, ref)
    d = get_arch("granite-3-2b").smoke.d_model
    head = [d, 1, KV_HD]
    moved = [m for m in both["port"]["layouts"]["moves"] if KV_HD in m]
    ref_moved = [m for m in both["jax"]["kv_moves"] if KV_HD in m]
    assert head in ref_moved and head in moved, (moved, ref_moved)
    kv_heads = 2
    assert all(m[-2] != kv_heads and m[-1] != kv_heads * KV_HD
               for m in moved), moved
