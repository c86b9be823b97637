"""The port's fake-world dry-run (``launch/dryrun.py``) and the collective
half of ``core/cost.py``, held against the JAX package's
``launch/dryrun.py`` and ``core/hlo.py`` on the CPU.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` (512 host devices) when it is
imported, which would leak into every later test of a pytest worker, so
its tables are read in one subprocess.  The port's dry-run runs here in
small fake worlds on a ``cpu`` mesh at smoke size: on a CPU mesh DTensor
lowers an all-to-all to an all-gather plus a chunk (gloo has none), so
the MoE cells count their dispatch as all-gather here; on the card's
``cuda`` mesh it is an all-to-all.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import hlo as ref_hlo  # noqa: E402

from repro_torch.configs import all_cells, get_arch  # noqa: E402
from repro_torch.core import cost  # noqa: E402
from repro_torch.core.profiles import H100_SXM  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.config import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.models.model import RunConfig  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: HLO dtype -> torch dtype, for every dtype both packages know
HLO_DTYPES = {
    "pred": torch.bool, "s8": torch.int8, "u8": torch.uint8,
    "s16": torch.int16, "u16": torch.uint16, "f16": torch.float16,
    "bf16": torch.bfloat16, "s32": torch.int32, "u32": torch.uint32,
    "f32": torch.float32, "s64": torch.int64, "u64": torch.uint64,
    "f64": torch.float64, "c64": torch.complex64, "c128": torch.complex128,
    "f8e4m3fn": torch.float8_e4m3fn, "f8e5m2": torch.float8_e5m2,
}

#: the port's functional-collective op -> its HLO instruction
TORCH_TO_HLO = {
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
}


# ---------------------------------------------------------------------------
# collective accounting against core/hlo.py
# ---------------------------------------------------------------------------

def test_shape_bytes_match_jax_for_every_shared_dtype():
    rng = np.random.default_rng(0)
    for name, dt in HLO_DTYPES.items():
        assert name in ref_hlo._DTYPE_BYTES
        for _ in range(5):
            shape = tuple(int(d) for d in rng.integers(1, 64, rng.integers(
                0, 4)))
            text = f"{name}[{','.join(map(str, shape))}]{{0}}"
            assert cost._shape_bytes(dt, shape) == ref_hlo._shape_bytes(
                text), (name, shape)
            assert cost._shape_bytes(str(dt), shape) == cost._shape_bytes(
                dt, shape)


def _trace(seed, n=60):
    """A seeded list of (op, dtype, shape): collectives among other ops."""
    rng = np.random.default_rng(seed)
    ops = list(TORCH_TO_HLO) + ["aten.mm", "aten.add", "_c10d_functional"
                                ".wait_tensor"]
    names = list(HLO_DTYPES)
    out = []
    for _ in range(n):
        op = ops[rng.integers(len(ops))]
        name = names[rng.integers(len(names))]
        shape = tuple(int(d) for d in rng.integers(1, 512, rng.integers(
            0, 4)))
        out.append((op, name, shape))
    return out


def _hlo_text(trace):
    lines = ["HloModule m", "ENTRY main {"]
    for i, (op, name, shape) in enumerate(trace):
        hlo_op = TORCH_TO_HLO.get(op, op.split(".")[-1].replace("_", "-"))
        dims = ",".join(map(str, shape))
        lines.append(f"  %v{i} = {name}[{dims}]{{0}} {hlo_op}(%p{i})")
    return "\n".join(lines + ["}"])


@pytest.mark.parametrize("seed", range(4))
def test_collective_stats_match_jax_on_the_same_trace(seed):
    trace = _trace(seed)
    got = cost.collective_stats(cost.OpRecord(op, HLO_DTYPES[n], s)
                                for op, n, s in trace)
    want = ref_hlo.collective_stats(_hlo_text(trace))
    assert got.counts == want.counts
    assert got.bytes_by_op == want.bytes_by_op
    assert got.weighted_bytes == want.weighted_bytes
    assert got.total_bytes == want.total_bytes
    assert got.summary() == want.summary()


def test_count_ops_and_fusion_stats_keep_the_jax_keys():
    recs = [cost.OpRecord("aten.mm", torch.float32, (2, 2)),
            cost.OpRecord("aten.bmm", torch.float32, (1, 2, 2)),
            cost.OpRecord("aten.view", torch.float32, (4,)),
            cost.OpRecord("aten.copy_", torch.float32, (4,))]
    stats = cost.fusion_stats(recs)
    assert list(stats) == ["fusion", "dot", "convolution", "transpose",
                           "reshape", "copy", "dynamic-slice",
                           "dynamic-update-slice", "while", "custom-call"]
    assert stats["dot"] == 2 and stats["reshape"] == 1
    assert stats["fusion"] == stats["while"] == 0
    assert cost.count_ops(recs, ["mm", "view", "conv"]) == {
        "mm": 1, "view": 1, "conv": 0}


# ---------------------------------------------------------------------------
# the dry-run's tables against the JAX module (one subprocess)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_tables():
    code = textwrap.dedent("""
        import dataclasses, json
        from repro.launch import dryrun
        from repro.configs import all_cells, get_arch
        from repro.models.config import SHAPES
        out = {}
        for arch, shape, _ in all_cells():
            cfg = get_arch(arch).full
            s = SHAPES[shape]
            out[arch + "|" + shape] = {
                "run": dataclasses.asdict(dryrun.default_run_config(arch, shape)),
                "rules": dryrun.default_rules_override(arch),
                "opt": dataclasses.asdict(dryrun.default_opt_config(arch)),
                "depths": list(dryrun._measurement_depths(cfg)),
                "flops": dryrun.model_flops(cfg, s, s.kind)}
        print(json.dumps(out))
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


def _jsonable(x):
    return json.loads(json.dumps(x))


def test_cell_tables_match_the_jax_dryrun(jax_tables):
    cells = list(all_cells())
    assert sorted(f"{a}|{s}" for a, s, _ in cells) == sorted(jax_tables)
    for arch, shape, _ in cells:
        want = jax_tables[f"{arch}|{shape}"]
        cfg = get_arch(arch).full
        s = SHAPES[shape]
        assert _jsonable(dataclasses.asdict(dryrun.default_run_config(
            arch, shape))) == want["run"], (arch, shape)
        assert dryrun.default_rules_override(arch) == want["rules"]
        assert _jsonable(dataclasses.asdict(dryrun.default_opt_config(
            arch))) == want["opt"]
        assert list(dryrun._measurement_depths(cfg)) == want["depths"]
        assert dryrun.model_flops(cfg, s, s.kind) == want["flops"]


# ---------------------------------------------------------------------------
# per-rank counts in a fake world
# ---------------------------------------------------------------------------

def test_sharded_linear_counts_per_rank_flops_and_collectives():
    """x (M, K) rows on "data", columns on "model"; w (K, N) rows on
    "model": each rank multiplies (M/2, K/4) by (K/4, N) — 2*M*N*K/8
    FLOPs — and the partial sums over "model" are all-reduced: one
    all-reduce of the (M/2, N) float32 result."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    M, K, N = 64, 32, 48
    with dryrun.fake_world(8):
        mesh = DeviceMesh("cpu", torch.arange(8).reshape(2, 4),
                          mesh_dim_names=("data", "model"))
        x = DTensor.from_local(torch.empty(M // 2, K // 4, device="meta"),
                               mesh, [Shard(0), Shard(1)],
                               shape=torch.Size([M, K]), stride=(K, 1))
        w = DTensor.from_local(torch.empty(K // 4, N, device="meta"),
                               mesh, [Replicate(), Shard(0)],
                               shape=torch.Size([K, N]), stride=(N, 1))
        trace = cost.OpTrace()
        with trace:
            y = x @ w
            assert tuple(y.placements) == (Shard(0), Partial())
            y.redistribute(mesh, [Shard(0), Replicate()])
    assert trace.flops == 2 * M * N * K / 8
    coll = trace.collectives()
    assert coll.counts["all-reduce"] == 1 and coll.total_bytes == \
        coll.bytes_by_op["all-reduce"] == (M // 2) * N * 4
    assert coll.weighted_bytes == 2 * (M // 2) * N * 4


def _meta_dtensor(shape, placements, mesh, dtype=torch.float32):
    from torch.distributed.tensor import DTensor, Shard
    local = list(shape)
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(m)
    return DTensor.from_local(
        torch.empty(local, dtype=dtype, device="meta"), mesh, placements,
        shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


@pytest.mark.parametrize("M,K,cut", [(16, 64, True), (64, 16, False)])
def test_matmul_cuts_a_replicated_product_with_few_rows(M, K, cut):
    """``sharding.matmul``'s few-rows rule (``_MATMUL_FEW_ROWS``), both
    operands replicated on a 2x4 mesh: with fewer rows than the
    contraction (a weight's gradient) each rank multiplies its eighth of
    the contraction and the result is partial on both mesh dims, with no
    collective (cutting a replicated operand is local); with more rows
    the product is whole on every rank.  GSPMD makes that cut inside a
    step: without the rule, the granite decode cell of
    ``tests/test_torch_dryrun_parity.py`` repeats 2x the work a rank
    that the JAX step splits."""
    from torch.distributed.tensor import Partial, Replicate
    from repro_torch.dist import sharding
    N = 32
    with dryrun.fake_world(8):
        mesh = dryrun._mesh((2, 4), "cpu")
        x = _meta_dtensor((M, K), [Replicate(), Replicate()], mesh)
        w = _meta_dtensor((K, N), [Replicate(), Replicate()], mesh)
        trace = cost.OpTrace()
        with trace:
            y = sharding.matmul(x, w)
    assert tuple(y.placements) == ((Partial(), Partial()) if cut else
                                   (Replicate(), Replicate()))
    assert trace.flops == 2 * M * N * K / (8 if cut else 1)
    assert trace.collectives().total_bytes == 0


def test_matmul_gathers_a_split_weight_to_a_decode_step_s_rows():
    """A decode step's few rows on "data" against a weight split on
    "data" (rows, FSDP) and "model" (columns): the weight's shard is
    gathered over "data", one all-gather of (K, N/4) float32, as GSPMD
    does for the same product (``tests/test_torch_dryrun_parity.py``
    holds the bytes against the JAX compile); the rows do not move."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.dist import sharding
    M, K, N = 8, 512, 1024
    with dryrun.fake_world(8):
        mesh = dryrun._mesh((2, 4), "cpu")
        x = _meta_dtensor((M, K), [Shard(0), Replicate()], mesh)
        w = _meta_dtensor((K, N), [Shard(0), Shard(1)], mesh)
        trace = cost.OpTrace()
        with trace:
            y = sharding.matmul(x, w)
    assert tuple(y.placements) == (Shard(0), Shard(1))
    assert trace.flops == 2 * M * N * K / 8
    coll = trace.collectives()
    assert coll.counts["all-gather"] == 1
    assert coll.total_bytes == coll.bytes_by_op["all-gather"] == \
        K * (N // 4) * 4


@pytest.mark.parametrize("mesh_shape", [(4, 4), (2, 4)])
def test_matmul_moves_a_weight_shard_from_data_to_model(mesh_shape):
    """A decode head: x (128 rows on "data") by w (768, 1000) with its
    rows on "data" and nothing on "model".  The few-rows rule cuts the
    contraction over "model", so w's split moves from "data" to "model":
    where the two dims have one size each rank receives the one shard it
    needs (an all-to-all of K/4 x N float32), as GSPMD's
    collective-permute does; otherwise DTensor gathers w over "data"
    (2 x that).  Either way the result's rows stay on "data", partial
    over "model"."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.dist import sharding
    D, Mo = mesh_shape
    M, K, N = 128, 768, 1000
    with dryrun.fake_world(D * Mo):
        mesh = dryrun._mesh(mesh_shape, "cpu")
        x = _meta_dtensor((M, K), [Shard(0), Replicate()], mesh)
        w = _meta_dtensor((K, N), [Shard(0), Replicate()], mesh)
        trace = cost.OpTrace()
        with trace:
            y = sharding.matmul(x, w)
    assert tuple(y.placements) == (Shard(0), Partial())
    assert trace.flops == 2 * M * N * K / (D * Mo)
    coll = trace.collectives()
    op = "all-to-all" if D == Mo else "all-gather"
    assert coll.counts[op] == 1
    assert coll.total_bytes == coll.bytes_by_op[op] == \
        (K // D) * N * 4 * (1 if D == Mo else D)


@pytest.mark.parametrize("n_ids,gathered", [(8, 8 * 4),
                                            (512, (256 // 4) * 64 * 4)])
def test_embed_rows_gathers_a_few_ids_or_else_the_table(n_ids, gathered):
    """``sharding.embed_rows`` on a (256, 64) table, the vocabulary on
    "model" and d on "data" (FSDP), ids on "data": 8 ids (and their
    rows) move fewer elements than the table, so the int32 ids are
    gathered and each rank looks up its d columns of every row; 512 ids
    do not, so the table's vocabulary chunk is gathered over "data"
    (transposed).  Either way the rows are partial over "model", each
    rank holding its vocabulary chunk's."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.dist import sharding
    rules = dict(sharding.DEFAULT_RULES)
    with dryrun.fake_world(8):
        mesh = dryrun._mesh((2, 4), "cpu")
        with sharding.use_sharding(mesh, rules):
            table = _meta_dtensor((256, 64), sharding.placements(
                sharding.spec_for((256, 64), ("vocab", "embed"), rules,
                                  mesh), 2, mesh), mesh)
            assert tuple(table.placements) == (Shard(1), Shard(0))
            ids = _meta_dtensor((8, n_ids // 8), [Shard(0), Replicate()],
                                mesh, torch.int32)
            trace = cost.OpTrace()
            with trace:
                rows = sharding.embed_rows(table, ids)
    assert tuple(rows.placements) == (
        (Shard(2) if n_ids == 8 else Shard(0)), Partial())
    coll = trace.collectives()
    assert coll.counts["all-gather"] == 1
    assert coll.total_bytes == coll.bytes_by_op["all-gather"] == gathered


SMALL = {"train": ShapeConfig("train_4k", 64, 8, "train"),
         "prefill": ShapeConfig("prefill_32k", 64, 8, "prefill"),
         "decode": ShapeConfig("decode_32k", 64, 8, "decode")}

#: one architecture of each family
FAMILIES = {"dense": "granite-3-2b", "moe": "deepseek-v3-671b",
            "ssm": "mamba2-130m", "hybrid": "zamba2-7b",
            "vlm": "llava-next-34b", "audio": "musicgen-medium"}

#: the JAX record's keys (repro/launch/dryrun.py::analyze_cell)
JAX_KEYS = {"arch", "shape", "kind", "mesh", "chips", "multi_pod",
            "run_config", "rules_override", "lower_s", "compile_s",
            "hlo_ops", "memory", "scanned_module_costs", "measure_s",
            "flops_per_chip", "bytes_per_chip", "collective_bytes_per_chip",
            "collective_weighted_bytes", "collective_by_op",
            "collective_counts", "measured_depths", "roofline",
            "model_flops_global", "model_flops_per_chip",
            "useful_flops_ratio"}


@pytest.mark.parametrize("kind", list(SMALL))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_analyze_cell_at_smoke_size(family, kind):
    arch = FAMILIES[family]
    shape = SMALL[kind]
    # the cell's default knobs with one microbatch (the default's 2 or 8
    # repeat the same trace), and recomputation in the dense cell only:
    # under DTensor it re-dispatches the whole forward (~6x the trace time)
    run = dataclasses.replace(
        dryrun.default_run_config(arch, shape.name), microbatch=1,
        remat="full" if kind == "train" and family == "dense" else "none")
    rec = dryrun.analyze_cell(arch, shape, mesh_shape=(2, 4),
                              cfg=get_arch(arch).smoke, device_type="cpu",
                              run=run)
    assert JAX_KEYS <= set(rec), JAX_KEYS - set(rec)
    assert rec["chips"] == 8 and rec["mesh"] == "2x4"
    # the costs are the full-depth trace's own, not an extrapolation
    costs = rec["scanned_module_costs"]
    assert rec["flops_per_chip"] == costs["flops"] > 0
    assert rec["bytes_per_chip"] == costs["bytes"]
    assert rec["collective_by_op"] == costs["coll_by_op"]
    assert rec["measured_depths"] == [get_arch(arch).smoke.num_layers]
    assert 0 < rec["useful_flops_ratio"] <= 1.05, rec["useful_flops_ratio"]
    r = rec["roofline"]
    assert r["step_t"] > 0 and r["dominant"] in ("compute", "memory",
                                                 "collective")
    assert rec["memory"]["total_bytes_per_device"] >= \
        rec["memory"]["argument_size_in_bytes"] > 0
    assert set(rec["collective_by_op"]) == set(cost.COLLECTIVE_OPS)
    assert rec["collective_counts"]["all-to-all"] == 0, (
        "a cpu mesh lowers all-to-all to all-gather + chunk; "
        f"{rec['collective_counts']}")
    if family == "moe" and kind != "decode":
        assert rec["collective_counts"]["all-gather"] > 0, rec


def test_costs_come_from_the_measurement_config_memory_from_the_cell_s():
    """qwen2.5-32b's train cell runs 4 microbatches: its cost keys are the
    trace at ``measure_costs``' run config (one microbatch, no chunks),
    as the JAX record's are, and its memory the trace at its own."""
    arch, shape = "qwen2.5-32b", SMALL["train"]
    cfg = get_arch(arch).smoke
    run = dryrun.default_run_config(arch, shape.name)
    assert run.microbatch == 4
    cell = dryrun.analyze_cell(arch, shape, mesh_shape=(2, 4), cfg=cfg,
                               device_type="cpu")
    run_m = dryrun.measurement_run(run)
    assert (run_m.microbatch, run_m.ce_chunk, run_m.attn_chunk,
            run_m.scan_blocks) == (1, 0, 0, False)
    measured = dryrun.analyze_cell(arch, shape, mesh_shape=(2, 4), cfg=cfg,
                                   device_type="cpu", run=run_m)
    assert cell["run_config"]["microbatch"] == 4
    assert cell["scanned_module_costs"] == measured["scanned_module_costs"]
    assert cell["flops_per_chip"] == measured["flops_per_chip"]
    assert cell["collective_by_op"] == measured["collective_by_op"]
    assert cell["measured_depths"] == [cfg.num_layers]
    assert cell["measure_s"] > 0
    from repro_torch.dist import sharding
    rules = dict(sharding.DEFAULT_RULES,
                 **dryrun.default_rules_override(arch))
    with dryrun._cell_mesh(False, (2, 4), "cpu") as mesh:
        own = dryrun._traced_step(cfg, shape, run, mesh, rules,
                                  dryrun.default_opt_config(arch))
    assert cell["memory"]["total_bytes_per_device"] == own.peak != \
        measured["memory"]["total_bytes_per_device"]


@pytest.mark.parametrize("kind,ce_chunk,attn_chunk,same", [
    ("train", 512, 0, True), ("train", 32, 0, False),
    ("prefill", 0, 128, True), ("prefill", 0, 16, False),
    ("decode", 0, 16, True)])
def test_eager_step_says_when_two_run_configs_trace_the_same_step(
        kind, ce_chunk, attn_chunk, same):
    """``RunConfig.eager_step`` (whether ``analyze_cell`` may take the
    cell's own trace for ``measure_costs``' run config) agrees with the
    traces: equal where a chunk does not split the 64 positions or a
    decode step ignores it, different where it does."""
    cfg = dataclasses.replace(get_arch("granite-3-2b").smoke, num_layers=1)
    shape = SMALL[kind]
    run = RunConfig(ce_chunk=ce_chunk, attn_chunk=attn_chunk,
                    scan_blocks=False)
    run_m = dryrun.measurement_run(run)
    from repro_torch.dist import sharding
    from repro_torch.optim import adamw
    with dryrun.fake_world(1):
        mesh = dryrun._mesh((1, 1), "cpu")
        by_op = [dryrun._traced_step(cfg, shape, r, mesh,
                                     dict(sharding.DEFAULT_RULES),
                                     adamw.OptimConfig()).by_op
                 for r in (run, run_m)]
    assert (run.eager_step(shape.seq_len, kind) ==
            run_m.eager_step(shape.seq_len, kind)) == same
    assert (by_op[0] == by_op[1]) == same


def test_peak_live_adds_up_to_the_peak():
    """``OpTrace(detail=True)`` (``tools/dryrun_parity.py peak port``):
    the storages it lists at the peak, each by the operation that
    allocated it, and the resident tensors add up to the peak; without
    ``detail`` it keeps no list and counts the same peak."""
    from repro_torch.dist import sharding
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(get_arch("granite-3-2b").smoke, num_layers=2)
    with dryrun.fake_world(8):
        mesh = dryrun._mesh((2, 4), "cpu")
        plain, detailed = (
            dryrun._traced_step(cfg, SMALL["train"], RunConfig(), mesh,
                                dict(sharding.DEFAULT_RULES),
                                adamw.OptimConfig(), detail=d)
            for d in (False, True))
    assert plain.peak_live == [] and detailed.peak == plain.peak
    assert detailed.peak_live and detailed.resident + sum(
        nb for *_, nb in detailed.peak_live) == detailed.peak
    for op, dtype, shape, nb in detailed.peak_live:
        assert op in detailed.by_op and isinstance(dtype, torch.dtype)
        assert nb >= math.prod(shape) * dtype.itemsize


def test_each_layer_s_weight_gradients_are_reduced_as_the_backward_goes():
    """qwen2.5 smoke with 8 layers at 2x4 under ``remat="full"``: a
    layer's whole (d, d) weight-gradient product is reduced to its shard
    as the backward leaves the layer (``model._layers`` lays each layer's
    views out as the layer runs), so the memory peak holds at most one
    such product, not one for every layer (the JAX compile reduces each
    layer's gradient inside its backward loop)."""
    from repro_torch.dist import sharding
    cfg = dataclasses.replace(get_arch("qwen2.5-32b").smoke, num_layers=8)
    run = dryrun.measurement_run(dryrun.default_run_config("qwen2.5-32b",
                                                           "train_4k"))
    with dryrun.fake_world(8):
        mesh = dryrun._mesh((2, 4), "cpu")
        trace = dryrun._traced_step(
            cfg, ShapeConfig("train_4k", 64, 32, "train"), run, mesh,
            dict(sharding.DEFAULT_RULES,
                 **dryrun.default_rules_override("qwen2.5-32b")),
            dryrun.default_opt_config("qwen2.5-32b"), detail=True)
    d = cfg.d_model
    held = [r for r in trace.peak_live if r[0] == "aten.mm"
            and r[2] == (d, d)]
    assert len(held) <= 1, held


def test_roofline_divides_by_the_h100_profile():
    costs = {"flops": 989e12, "bytes": 3.35e12, "coll_weighted": 450e9}
    r = dryrun.roofline(costs, H100_SXM)
    assert r["compute_t"] == pytest.approx(1.0)
    assert r["memory_t"] == pytest.approx(1.0)
    assert r["collective_t"] == pytest.approx(1.0)
    assert H100_SXM.link_count * H100_SXM.link_bw == 450e9


def _one_by_one_counts_as_meshless(run: RunConfig) -> None:
    cfg = dataclasses.replace(get_arch("granite-3-2b").full, num_layers=2)
    shape = ShapeConfig("train_4k", 256, 8, "train")
    from repro_torch.dist import sharding
    from repro_torch.dist.step import make_train_step
    from repro_torch.models.model import abstract_model
    from repro_torch.optim import adamw
    meta = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")
    params = abstract_model(cfg)
    state = adamw.abstract_state(adamw.OptimConfig(), params)
    batch = {k: meta((8, 256), torch.int32) for k in ("tokens", "labels")}
    plain = cost.OpTrace()
    with plain:
        make_train_step(cfg, run, opt_cfg=adamw.OptimConfig())(
            params, state, batch)
    with dryrun.fake_world(1):
        mesh = dryrun._mesh((1, 1), "cpu")
        traced = dryrun._traced_step(cfg, shape, run, mesh,
                                     dict(sharding.DEFAULT_RULES),
                                     adamw.OptimConfig())
    assert traced.collectives().total_bytes == 0
    ops = set(traced.by_op) | set(plain.by_op)
    diff = {k: (traced.by_op.get(k), plain.by_op.get(k)) for k in ops
            if traced.by_op.get(k) != plain.by_op.get(k)}
    assert not diff, diff
    assert (traced.ops, traced.bytes, traced.flops) == (
        plain.ops, plain.bytes, plain.flops)


def test_one_by_one_mesh_counts_what_the_meshless_step_counts():
    """On a 1x1 mesh every layout is the whole tensor: the DTensor step's
    local operations and bytes are the meshless step's (the rule of
    ``chip_smoke.py::step_traffic``), granite-3-2b at full width, cut to
    2 layers, at the trainer's 8 x 256 tokens."""
    _one_by_one_counts_as_meshless(RunConfig())


def test_one_by_one_mesh_counts_what_the_meshless_step_counts_with_remat():
    """The same under ``remat="full"`` (every train cell's default): the
    recomputation in the backward stops where the meshless step's does,
    after the last saved tensor of a layer, so each layer's last product
    is not run again."""
    _one_by_one_counts_as_meshless(RunConfig(remat="full"))


def test_a_column_tiled_head_regathers_a_vocab_sharded_head():
    """``RunConfig.head_chunk`` (the serve path's tuned GEMM ``BLOCK_N``)
    slices the LM head into column tiles; with the vocab sharded over
    "model" (4 ranks) each tile of the decode step's head is gathered
    again: more all-gathers and more all-gather bytes than one
    whole-vocab product (values are the same; PERF.md §6 has the
    counts)."""
    cfg = dataclasses.replace(get_arch("granite-3-2b").smoke, vocab_size=512)
    shape = SMALL["decode"]
    costs = {}
    for hc in (0, 128):
        run = dataclasses.replace(dryrun.default_run_config(
            "granite-3-2b", shape.name), head_chunk=hc)
        rec = dryrun.analyze_cell("granite-3-2b", shape, mesh_shape=(2, 4),
                                  cfg=cfg, device_type="cpu", run=run)
        costs[hc] = rec["scanned_module_costs"]
    assert costs[128]["coll_counts"]["all-gather"] > \
        costs[0]["coll_counts"]["all-gather"], costs
    assert costs[128]["coll_by_op"]["all-gather"] > \
        costs[0]["coll_by_op"]["all-gather"], costs
    assert costs[128]["coll_by_op"]["all-reduce"] == \
        costs[0]["coll_by_op"]["all-reduce"]
