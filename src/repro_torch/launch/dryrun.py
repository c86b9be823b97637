"""Fake-world dry-run: run every (architecture x input shape) step on the
production meshes without the ranks, and emit per-rank costs and the
roofline terms.

The JAX package lowers and compiles each cell on 512 virtual CPU devices.
The port runs the step eagerly in a *fake world*: one process joins a
``torch.distributed`` group of the ``fake`` backend as rank 0 of 256
(16x16) or 512 (2x16x16) ranks, every collective returns at once, and the
parameters, optimizer state and batch are DTensors whose local shards are
``meta`` tensors (shapes, no storage).  What rank 0 does is what every
rank does, so an :class:`~repro_torch.core.cost.OpTrace` of its local
operations gives per-rank FLOPs, bytes, collectives and live memory.  The
world is entered and left inside :func:`analyze_cell`: importing this
module has no side effect, and the fake world refuses to start in a
process that already has a default process group (a real one would be
taken over).

The mesh's device type is the card's (``"cuda"``) unless the caller asks
for ``"cpu"``: no storage is touched either way, but DTensor lowers an
all-to-all on a CPU mesh to an all-gather plus a chunk (gloo has none),
so only the CUDA mesh records the MoE dispatch's all-to-all.

Each record key has the JAX record's definition and run config.  The
costs (``flops_per_chip``, ``bytes_per_chip``, ``collective_*`` and
``scanned_module_costs``) are measured at ``measure_costs``' run config
(:func:`measurement_run`: one microbatch, no cross-entropy or attention
chunks, layers unrolled), as the JAX package measures them; eager
execution runs every layer, so the trace is taken at full depth and
nothing is extrapolated (``measured_depths`` is ``[num_layers]``,
``measure_s`` that trace's time).  ``memory`` comes from a trace at the
cell's own run config, as the JAX record's comes from its production
compile.  (An earlier revision took the costs from the cell's own config
too; that compared a different step with the JAX record.)  FLOPs follow
XLA's convention (:class:`~repro_torch.core.cost.OpTrace`): products at
2 per multiply-add, one per output element of an elementwise op, one per
folded element of a reduction, transcendentals apart.
``measure_costs`` itself, two reduced depths extrapolated as in the JAX
package, serves the sharding tuner as its cheap objective.  The roofline
divides by the H100 profile's datasheet rates — a model, not a
measurement.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Iterator, Optional

import torch
import torch.distributed as dist

from ..configs import get_arch, input_specs
from ..core.cost import OpTrace, fusion_stats
from ..core.profiles import H100_SXM
from ..dist import partition, sharding
from ..dist.step import make_prefill_step, make_serve_step, make_train_step
from ..launch.mesh import mesh_chips
from ..models.config import SHAPES, ShapeConfig
from ..models.model import RunConfig, abstract_cache, abstract_model
from ..optim import adamw

# gradient-sharding constraints: opt-in via env var so the recorded
# baseline sweep stays reproducible (the JAX package's switch).
SHARD_GRADS_DEFAULT = os.environ.get("REPRO_SHARD_GRADS", "0") == "1"


# per-arch attention sharding mode: 'expanded' when KV < 16 but H divides
# the model axis; 'grouped' + sequence-parallel rule when H does not
# divide (qwen 40, llava 56, musicgen 24).  The JAX package's tables.
ARCH_ATTN_MODE = {
    "mistral-large-123b": "expanded",   # H=96, KV=8
    "qwen2.5-32b": "grouped",           # H=40 indivisible -> seq-parallel
    "granite-34b": "expanded",          # H=48, KV=1
    "granite-3-2b": "expanded",         # H=32, KV=8
    "deepseek-v3-671b": "grouped",      # MLA, H=128 divisible
    "kimi-k2-1t-a32b": "expanded",      # H=64, KV=8
    "llava-next-34b": "grouped",        # H=56 indivisible -> seq-parallel
    "zamba2-7b": "grouped",             # KV=32 divisible
    "musicgen-medium": "grouped",       # H=24 indivisible -> seq-parallel
    "mamba2-130m": "grouped",           # attention-free
}

SEQ_PARALLEL_ARCHS = {"qwen2.5-32b", "llava-next-34b", "musicgen-medium"}

# gradient-accumulation microbatches for training (keeps per-layer residual
# memory bounded); scaled roughly with d_model * layers.
ARCH_TRAIN_MICROBATCH = {
    "mistral-large-123b": 8,
    "qwen2.5-32b": 4,
    "granite-34b": 4,
    "granite-3-2b": 1,
    "deepseek-v3-671b": 8,
    "kimi-k2-1t-a32b": 8,
    "llava-next-34b": 4,
    "zamba2-7b": 2,
    "musicgen-medium": 1,
    "mamba2-130m": 1,
}


def default_rules_override(arch_id: str) -> Dict[str, Any]:
    if arch_id in SEQ_PARALLEL_ARCHS:
        return {"seq_attn": "model"}
    return {}


def default_run_config(arch_id: str, shape_name: str) -> RunConfig:
    """Baseline execution knobs per cell (the hillclimb's starting point)."""
    shape = SHAPES[shape_name]
    remat = "full" if shape.kind == "train" else "none"
    attn_chunk = 2048 if (shape.kind != "decode"
                          and shape.seq_len >= 32_768) else 0
    ce_chunk = 512 if shape.kind == "train" else 0
    micro = ARCH_TRAIN_MICROBATCH.get(arch_id, 1) \
        if shape.kind == "train" else 1
    accum = "bfloat16" if arch_id in ("deepseek-v3-671b",
                                      "kimi-k2-1t-a32b") else "float32"
    return RunConfig(remat=remat, attn_chunk=attn_chunk, ce_chunk=ce_chunk,
                     attn_mode=ARCH_ATTN_MODE.get(arch_id, "grouped"),
                     microbatch=micro, accum_dtype=accum)


def default_opt_config(arch_id: str) -> adamw.OptimConfig:
    # giant MoEs: bf16 moments (compressed optimizer) so params+opt approach
    # the device's memory; everything else keeps f32 moments.
    if arch_id in ("deepseek-v3-671b", "kimi-k2-1t-a32b"):
        return adamw.OptimConfig(moment_dtype="bfloat16")
    return adamw.OptimConfig()


def model_flops(cfg, shape, kind: str) -> float:
    """6*N*D (train) / 2*N*D (inference) with N = active params."""
    n_active = cfg.num_active_params()
    if kind == "train":
        return 6.0 * n_active * shape.tokens
    if kind == "prefill":
        return 2.0 * n_active * shape.tokens
    return 2.0 * n_active * shape.global_batch      # one decode step


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(world_size: int) -> Iterator[None]:
    """A default process group of the ``fake`` backend: this process is
    rank 0 of ``world_size`` and every collective returns at once.  Torn
    down on exit.  Refuses to start over an existing default group."""
    if dist.is_initialized():
        raise RuntimeError(
            "fake_world: this process already has a default process group; "
            "run the dry-run in a process of its own")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(mesh_shape, device_type: str):
    """A ("data", "model") or ("pod", "data", "model") mesh of
    ``mesh_shape`` over the current world."""
    from torch.distributed.device_mesh import DeviceMesh
    axes = (("pod", "data", "model") if len(mesh_shape) == 3
            else ("data", "model"))
    return DeviceMesh(device_type,
                      torch.arange(math.prod(mesh_shape)).reshape(mesh_shape),
                      mesh_dim_names=axes)


@contextlib.contextmanager
def _cell_mesh(multi_pod: bool, mesh_shape, device_type: str):
    """The production mesh (or ``mesh_shape``) in a fake world of its
    size, for one ``with`` block."""
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    with fake_world(math.prod(mesh_shape)):
        yield _mesh(tuple(mesh_shape), device_type)


def _traced_step(cfg, shape: ShapeConfig, run: RunConfig, mesh, rules,
                 opt_cfg: adamw.OptimConfig,
                 shard_grads: Optional[bool] = None,
                 detail: bool = False) -> OpTrace:
    """Run one step of (cfg, shape) on ``mesh`` under ``rules`` eagerly,
    with ``meta`` local shards, and return its trace (``detail``: with
    ``OpTrace.peak_live``)."""
    if shard_grads is None:
        shard_grads = SHARD_GRADS_DEFAULT
    with sharding.use_sharding(mesh, rules):
        p_shard = partition.model_shardings(cfg, mesh, rules)
        params = partition.distribute(abstract_model(cfg), p_shard)
        b_shard = partition.batch_shardings(cfg, shape, mesh, rules)
        batch = partition.distribute(input_specs(cfg, shape), b_shard)
        if shape.kind == "train":
            opt = partition.distribute(
                adamw.abstract_state(opt_cfg, abstract_model(cfg)),
                partition.opt_shardings(p_shard, mesh))
            fn = make_train_step(
                cfg, run, opt_cfg,
                grad_shardings=p_shard if shard_grads else None)
            trace = OpTrace(resident=(params, opt, batch), detail=detail)
            with trace:
                fn(params, opt, batch)
            return trace
        if shape.kind == "prefill":
            trace = OpTrace(resident=(params, batch), detail=detail)
            with trace:
                make_prefill_step(cfg, run)(params, batch)
            return trace
        cache = partition.distribute(
            abstract_cache(cfg, shape.global_batch, shape.seq_len),
            partition.cache_shardings(cfg, shape.global_batch,
                                      shape.seq_len, mesh, rules))
        trace = OpTrace(resident=(params, cache, batch), detail=detail)
        with trace:
            make_serve_step(cfg, run)(params, cache, batch["inputs"],
                                      shape.seq_len - 1)
        return trace


def _module_costs(trace: OpTrace) -> Dict[str, Any]:
    coll = trace.collectives()
    return {
        "flops": float(trace.flops),
        "bytes": float(trace.bytes),
        "ops": trace.ops,
        "coll_weighted": coll.weighted_bytes,
        "coll_total": float(coll.total_bytes),
        "coll_by_op": dict(coll.bytes_by_op),
        "coll_counts": dict(coll.counts),
    }


def _mem_analysis(trace: OpTrace) -> Dict[str, Any]:
    """The JAX record's memory keys, from the trace's live-storage peak:
    arguments are the local shards resident before the step (updated in
    place, so no output or alias bytes of their own), temporaries what
    the step's operations held at the peak on top of them."""
    return {
        "argument_size_in_bytes": float(trace.resident),
        "output_size_in_bytes": 0.0,
        "temp_size_in_bytes": float(trace.peak - trace.resident),
        "alias_size_in_bytes": 0.0,
        "total_bytes_per_device": float(trace.peak),
        "peak_includes": ("local shards of parameters, optimizer state, "
                          "batch and cache, plus every storage a local "
                          "operation allocated while it was referenced; "
                          "not allocator caching, the CUDA context or "
                          "library workspaces"),
    }


# ---------------------------------------------------------------------------
# cost measurement.  The JAX package measures reduced-depth unrolled
# variants (depths L1 < L2) and extrapolates linearly, because XLA's
# cost_analysis counts a scanned layer once.  An eager trace counts every
# layer (analyze_cell traces run_m at full depth); the extrapolation is
# kept only as the tuner's cheaper objective.
# ---------------------------------------------------------------------------

def _measurement_depths(cfg) -> tuple:
    """(L1, L2, extrapolation-count) reduced depths for cost measurement."""
    if cfg.family == "hybrid":
        unit = cfg.hybrid_mamba_per_attn + 1
        return unit, 2 * unit, None     # per-super-block delta
    if cfg.is_moe:
        d = cfg.moe_first_dense
        return d + 1, d + 2, None
    return 1, 2, None


def _extrapolate(c1: Dict[str, Any], c2: Dict[str, Any],
                 n_units: float) -> Dict[str, Any]:
    """cost = c1 + (n_units - 1) * (c2 - c1), element-wise."""
    out: Dict[str, Any] = {}
    for k in ("flops", "bytes", "coll_weighted", "coll_total"):
        out[k] = c1[k] + (n_units - 1) * max(0.0, c2[k] - c1[k])
    out["coll_by_op"] = {
        op: c1["coll_by_op"][op] + (n_units - 1)
        * max(0.0, c2["coll_by_op"][op] - c1["coll_by_op"][op])
        for op in c1["coll_by_op"]}
    out["coll_counts"] = {
        op: int(c1["coll_counts"][op] + (n_units - 1)
                * max(0, c2["coll_counts"][op] - c1["coll_counts"][op]))
        for op in c1["coll_counts"]}
    return out


def measurement_run(run: RunConfig) -> RunConfig:
    """The run config the JAX package measures costs at (``measure_costs``'
    ``run_m``): one microbatch, no cross-entropy or attention chunks, the
    layers unrolled."""
    return dataclasses.replace(run, scan_blocks=False, ce_chunk=0,
                               attn_chunk=0, microbatch=1)


def measure_costs(cfg, shape, run: RunConfig, mesh, rules,
                  opt_cfg: adamw.OptimConfig) -> Dict[str, Any]:
    """Per-rank flops/bytes/collective costs from two reduced depths,
    extrapolated to the full depth.  Must run inside a fake world (or a
    real one) that ``mesh`` belongs to."""
    run_m = measurement_run(run)
    L1, L2, _ = _measurement_depths(cfg)
    cfg1 = dataclasses.replace(cfg, num_layers=L1)
    cfg2 = dataclasses.replace(cfg, num_layers=L2)
    c1 = _module_costs(_traced_step(cfg1, shape, run_m, mesh, rules,
                                    opt_cfg))
    c2 = _module_costs(_traced_step(cfg2, shape, run_m, mesh, rules,
                                    opt_cfg))
    if cfg.family == "hybrid":
        unit = cfg.hybrid_mamba_per_attn + 1
        n_units = cfg.num_layers / unit     # tail mambas ~ fractional unit
    elif cfg.is_moe:
        n_units = cfg.num_layers - cfg.moe_first_dense
    else:
        n_units = cfg.num_layers
    out = _extrapolate(c1, c2, n_units)
    out["measured_depths"] = [L1, L2]
    out["n_units"] = n_units
    return out


def cell_costs(arch_id: str, shape_name: str, run: RunConfig,
               rules_override: Optional[Dict[str, Any]] = None, *,
               multi_pod: bool = False, device_type: str = "cuda",
               mesh_shape=None, cfg=None) -> Dict[str, Any]:
    """:func:`measure_costs` of one cell on its production mesh (or
    ``mesh_shape``) in a fake world of its own: the sharding tuner's
    objective."""
    cfg = cfg or get_arch(arch_id).full
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    rules = dict(sharding.DEFAULT_RULES, **(rules_override or {}))
    with _cell_mesh(multi_pod, mesh_shape, device_type) as mesh:
        return measure_costs(cfg, shape, run, mesh, rules,
                             default_opt_config(arch_id))


def roofline(costs: Dict[str, Any], profile) -> Dict[str, Any]:
    """(compute, memory, collective) times of per-rank costs at the
    profile's datasheet rates, the dominant term and the step time."""
    compute_t = costs["flops"] / profile.peak_bf16_tensor_flops
    memory_t = costs["bytes"] / profile.hbm_bw
    coll_t = costs["coll_weighted"] / (profile.link_count * profile.link_bw)
    dominant = max((("compute", compute_t), ("memory", memory_t),
                    ("collective", coll_t)), key=lambda kv: kv[1])[0]
    return {"compute_t": compute_t, "memory_t": memory_t,
            "collective_t": coll_t, "dominant": dominant,
            "step_t": max(compute_t, memory_t) + coll_t}


def analyze_cell(arch_id: str, shape_name, *, multi_pod: bool = False,
                 run: Optional[RunConfig] = None,
                 rules_override: Optional[Dict[str, Any]] = None,
                 opt_cfg: Optional[adamw.OptimConfig] = None,
                 profile=H100_SXM, keep_text: bool = False,
                 device_type: str = "cuda", mesh_shape=None,
                 cfg=None) -> Dict[str, Any]:
    """Trace one cell in a fake world; return the dry-run/roofline record.

    ``shape_name`` names a cell shape (or is a ``ShapeConfig``);
    ``mesh_shape`` replaces the production mesh (a 2-tuple is
    ("data", "model"), a 3-tuple adds "pod"), ``cfg`` the arch's full
    config (smoke-size tests), ``device_type`` the card's mesh type.
    ``keep_text`` keeps the trace's op list under ``"hlo_text"``."""
    spec = get_arch(arch_id)
    cfg = cfg or spec.full
    shape = (SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    shape_key = shape.name
    run = run or default_run_config(arch_id, shape_key)
    opt_cfg = opt_cfg or default_opt_config(arch_id)
    if rules_override is None:
        rules_override = default_rules_override(arch_id)
    rules = dict(sharding.DEFAULT_RULES, **(rules_override or {}))
    with _cell_mesh(multi_pod, mesh_shape, device_type) as mesh:
        chips = mesh_chips(mesh)
        record: Dict[str, Any] = {
            "arch": arch_id, "shape": shape_key, "kind": shape.kind,
            "mesh": "x".join(str(s) for s in tuple(mesh.shape)),
            "chips": chips, "multi_pod": multi_pod,
            "run_config": dataclasses.asdict(run),
            "rules_override": rules_override or {},
        }
        # 1) the cell's own step: memory and op structure, as the JAX
        #    record takes them from its production compile
        t0 = time.perf_counter()
        trace = _traced_step(cfg, shape, run, mesh, rules, opt_cfg)
        record["lower_s"] = round(time.perf_counter() - t0, 2)
        record["compile_s"] = 0.0          # eager: nothing is compiled
        record["hlo_ops"] = fusion_stats(trace.records)
        record["memory"] = _mem_analysis(trace)
        record["ops_by_name"] = {k: v[0] for k, v in trace.by_op.items()}
        if keep_text:
            record["hlo_text"] = "\n".join(
                f"{r.op} {r.dtype} {list(r.shape)}" for r in trace.records)
        # 2) the costs: the step at the measurement config (measure_costs'
        #    run_m), traced at full depth (an eager trace counts every
        #    layer, so nothing is extrapolated); the cell's own trace
        #    serves when the two configs run the same step
        run_m = measurement_run(run)
        if run.eager_step(shape.seq_len, shape.kind) == \
                run_m.eager_step(shape.seq_len, shape.kind):
            costs = _module_costs(trace)
            record["measure_s"] = record["lower_s"]
        else:
            del trace
            gc.collect()
            t2 = time.perf_counter()
            trace = _traced_step(cfg, shape, run_m, mesh, rules, opt_cfg)
            costs = _module_costs(trace)
            record["measure_s"] = round(time.perf_counter() - t2, 2)
        record["scanned_module_costs"] = costs
        del trace
        gc.collect()

    p = profile
    flops, bytes_ = costs["flops"], costs["bytes"]
    roof = roofline(costs, p)
    mf = model_flops(cfg, shape, shape.kind)
    step_t = roof["step_t"]
    record.update({
        "flops_per_chip": flops,
        "bytes_per_chip": bytes_,
        "collective_bytes_per_chip": costs["coll_total"],
        "collective_weighted_bytes": costs["coll_weighted"],
        "collective_by_op": costs["coll_by_op"],
        "collective_counts": costs["coll_counts"],
        "measured_depths": [cfg.num_layers],
        "roofline": {
            **roof,
            # fraction of the step the chip spends at its compute roofline
            "roofline_fraction": (mf / chips / p.peak_bf16_tensor_flops)
            / step_t if step_t else 0.0,
        },
        "model_flops_global": mf,
        "model_flops_per_chip": mf / chips,
        "useful_flops_ratio": (mf / chips) / flops if flops else 0.0,
        "profile": p.name,
    })
    return record


def run_cells(cells, multi_pod: bool, out_dir: str,
              run_overrides: Optional[Dict[str, Any]] = None,
              rules_override: Optional[Dict[str, Any]] = None,
              keep_going: bool = True, device_type: str = "cuda"):
    os.makedirs(out_dir, exist_ok=True)
    results = []
    for arch_id, shape_name in cells:
        tag = f"{arch_id}__{shape_name}__{'multi' if multi_pod else 'single'}"
        print(f"=== dry-run {tag} ===", flush=True)
        try:
            run = default_run_config(arch_id, shape_name)
            if run_overrides:
                run = dataclasses.replace(run, **run_overrides)
            rec = analyze_cell(arch_id, shape_name, multi_pod=multi_pod,
                               run=run, rules_override=rules_override,
                               device_type=device_type)
            rec["status"] = "ok"
        except Exception as e:  # noqa: BLE001 — recorded, never hidden
            if not keep_going:
                raise
            rec = {"arch": arch_id, "shape": shape_name,
                   "multi_pod": multi_pod, "status": "error",
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
            print(f"    FAILED: {rec['error']}", flush=True)
        path = os.path.join(out_dir, tag + ".json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=2, default=str)
        gc.collect()
        if rec["status"] == "ok":
            r = rec["roofline"]
            print(f"    lower={rec['lower_s']}s "
                  f"flops/chip={rec['flops_per_chip']:.3e} "
                  f"dominant={r['dominant']} step={r['step_t']*1e3:.2f}ms "
                  f"mem={rec['memory']['total_bytes_per_device']/2**30:.2f}"
                  f"GiB", flush=True)
        results.append(rec)
    return results


def _run_parallel(cells, meshes, args, argv):
    """Each (cell, mesh) by ``python -m repro_torch.launch.dryrun`` in a
    process of its own, ``args.jobs`` at a time; their records are read
    back from ``args.out``."""
    import subprocess
    import sys
    from concurrent.futures import ThreadPoolExecutor
    rest, skip = [], False
    for a in (sys.argv[1:] if argv is None else list(argv)):
        if skip:
            skip = False
            continue
        if a in ("--all", "--multi-pod", "--both-meshes"):
            continue
        if a in ("--jobs", "--arch", "--shape"):
            skip = True
            continue
        if a.startswith(("--jobs=", "--arch=", "--shape=")):
            continue
        rest.append(a)

    def one(job):
        (arch, shape), mp = job
        tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path):
            os.remove(path)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape] + (["--multi-pod"] if mp else []) \
            + rest
        done = subprocess.run(cmd, capture_output=True, text=True)
        print(done.stdout, end="", flush=True)
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
        return {"arch": arch, "shape": shape, "multi_pod": mp,
                "status": "error", "error": done.stderr[-2000:]}

    jobs = [(c, mp) for mp in meshes for c in cells]
    with ThreadPoolExecutor(args.jobs) as pool:
        return list(pool.map(one, jobs))


def main(argv=None):
    ap = argparse.ArgumentParser(description="fake-world dry-run")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=[None] + list(SHAPES), nargs="?")
    ap.add_argument("--all", action="store_true",
                    help="run every non-skipped (arch x shape) cell")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--remat", default=None,
                    choices=[None, "none", "full", "dots"], nargs="?")
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--attn-chunk", type=int, default=None)
    ap.add_argument("--moe-impl", default=None,
                    choices=[None, "scatter", "gather", "onehot"], nargs="?")
    ap.add_argument("--no-scan-blocks", action="store_true",
                    help="unroll the layer stack (no effect in eager mode)")
    ap.add_argument("--attn-mode", default=None,
                    choices=[None, "grouped", "expanded"], nargs="?")
    ap.add_argument("--accum-dtype", default=None,
                    choices=[None, "float32", "bfloat16"], nargs="?")
    ap.add_argument("--rules", default=None,
                    help="JSON logical->mesh-axis rule overrides")
    ap.add_argument("--fail-fast", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its "
                         "own (host cores; the trace is single-threaded)")
    args = ap.parse_args(argv)

    from ..configs import all_cells
    if args.all:
        cells = [(a, s) for a, s, _ in all_cells()]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    overrides = {}
    for k in ("remat", "microbatch", "attn_chunk", "moe_impl", "attn_mode",
              "accum_dtype"):
        v = getattr(args, k.replace("-", "_"))
        if v is not None:
            overrides[k] = v
    if args.no_scan_blocks:
        overrides["scan_blocks"] = False
    rules_override = json.loads(args.rules) if args.rules else None

    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    results = []
    if args.jobs > 1 and len(cells) * len(meshes) > 1:
        results = _run_parallel(cells, meshes, args, argv)
    else:
        for mp in meshes:
            results += run_cells(cells, mp, args.out,
                                 run_overrides=overrides or None,
                                 rules_override=rules_override,
                                 keep_going=not args.fail_fast)
    bad = [r for r in results if r["status"] != "ok"]
    if len(results) > 1:
        print(summary_table(results), flush=True)
    print(f"dry-run: {len(results) - len(bad)} of {len(results)} cells ok",
          flush=True)
    return 1 if bad else 0


def summary_table(records) -> str:
    """A markdown table of dry-run records: per cell the dominant roofline
    term, the step, memory per device and collective bytes by op (GB,
    per rank)."""
    lines = ["| cell | mesh | dominant | step ms | GiB/device | all-reduce "
             "| all-gather | reduce-scatter | all-to-all | lower s |",
             "| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |"]
    for r in records:
        cell = f"{r['arch']} {r['shape']}"
        if r.get("status") != "ok":
            lines.append(f"| {cell} | | {r.get('status')}: "
                         f"{r.get('error', '')[:60]} | | | | | | | |")
            continue
        by = r["collective_by_op"]
        gb = " | ".join(f"{by[k] / 1e9:.3f}" for k in (
            "all-reduce", "all-gather", "reduce-scatter", "all-to-all"))
        lines.append(
            f"| {cell} | {r['mesh']} | {r['roofline']['dominant']} | "
            f"{r['roofline']['step_t'] * 1e3:.2f} | "
            f"{r['memory']['total_bytes_per_device'] / 2 ** 30:.2f} | {gb} | "
            f"{r['lower_s']} |")
    return "\n".join(lines)


if __name__ == "__main__":
    raise SystemExit(main())
