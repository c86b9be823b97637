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


def test_roofline_divides_by_the_h100_profile():
    costs = {"flops": 989e12, "bytes": 3.35e12, "coll_weighted": 450e9}
    r = dryrun.roofline(costs, H100_SXM)
    assert r["compute_t"] == pytest.approx(1.0)
    assert r["memory_t"] == pytest.approx(1.0)
    assert r["collective_t"] == pytest.approx(1.0)
    assert H100_SXM.link_count * H100_SXM.link_bw == 450e9


def test_one_by_one_mesh_counts_what_the_meshless_step_counts():
    """On a 1x1 mesh every layout is the whole tensor: the DTensor step's
    local operations and bytes are the meshless step's (the rule of
    ``chip_smoke.py::step_traffic``), granite-3-2b at full width, cut to
    2 layers, at the trainer's 8 x 256 tokens."""
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
        make_train_step(cfg, opt_cfg=adamw.OptimConfig())(params, state,
                                                          batch)
    with dryrun.fake_world(1):
        mesh = dryrun._mesh((1, 1), "cpu")
        traced = dryrun._traced_step(cfg, shape, RunConfig(), mesh,
                                     dict(sharding.DEFAULT_RULES),
                                     adamw.OptimConfig())
    assert traced.collectives().total_bytes == 0
    ops = set(traced.by_op) | set(plain.by_op)
    diff = {k: (traced.by_op.get(k), plain.by_op.get(k)) for k in ops
            if traced.by_op.get(k) != plain.by_op.get(k)}
    assert not diff, diff
    assert (traced.ops, traced.bytes, traced.flops) == (
        plain.ops, plain.bytes, plain.flops)


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
