"""Distributed-configuration auto-tuning — the paper's technique, lifted to
the production meshes.

A point in the space is (sharding rules x execution knobs): remat policy,
microbatch, CE/attention chunking, attention sharding mode, FSDP extent,
MoE dispatch implementation, KV-cache layout.  The objective is the
roofline step time of the dry-run's per-rank costs
(``launch/dryrun.measure_costs`` in a fake world: no card needed) at the
H100 profile's datasheet rates, NVLink for the collective term — exactly
the role wall-clock timing plays in CLTune.  Search strategies are the
paper's own (random / annealing / PSO / greedy) via ``repro_torch.core``.

``build_space`` and ``config_to_run_rules`` are the JAX package's,
unchanged.  The dry-run module is imported lazily, so importing this one
(the registry's builtin autoload does) stays cheap.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from ..core import SearchSpace
from ..core.evaluators import AnalyticalEvaluator
from ..core.profiles import H100_SXM, DeviceProfile
from ..core.registry import Shape, tunable
from ..models.config import SHAPES

GiB = 1024 ** 3


def build_space(arch_id: str, shape_name: str,
                heads_divisible: bool, is_moe: bool = False) -> SearchSpace:
    """The distributed-config search space for one cell."""
    shape = SHAPES[shape_name]
    sp = SearchSpace()
    if shape.kind == "train":
        sp.add_parameter(name="REMAT", values=("none", "dots", "full"))
        sp.add_parameter(name="MICROBATCH", values=(1, 2, 4, 8, 16))
        sp.add_parameter(name="CE_CHUNK", values=(0, 512, 2048))
        sp.add_parameter(name="ACCUM_DTYPE",
                         values=("float32", "bfloat16"))
        sp.add_constraint(lambda m: shape.global_batch % m == 0,
                          ("MICROBATCH",), "microbatch divides batch")
    if shape.kind != "decode":
        chunks = (0, 1024, 2048, 8192) if shape.seq_len >= 32_768 \
            else (0, 1024)
        sp.add_parameter(name="ATTN_CHUNK", values=chunks)
        sp.add_parameter(name="ATTN_MODE", values=("grouped", "expanded"))
        sp.add_parameter(name="SEQ_ATTN", values=(None, "model"))
        if not heads_divisible:
            # expanded mode needs H % model == 0
            sp.add_constraint(lambda m: m != "expanded", ("ATTN_MODE",),
                              "H indivisible: no expanded mode")
    sp.add_parameter(name="FSDP", values=("none", "data", "pod_data"))
    if shape.kind == "decode":
        # time-dim cache layout: model / data+model / replicated
        sp.add_parameter(name="SEQ_KV",
                         values=("model", ("data", "model"), None))
    if is_moe:
        sp.add_parameter(name="MOE_IMPL", values=("scatter", "gather"))
    return sp


def config_to_run_rules(config: Dict[str, Any], base_run
                        ) -> Tuple[Any, Dict[str, Any]]:
    """Translate a search-space point into (RunConfig, rules overrides)."""
    kw: Dict[str, Any] = {}
    if "REMAT" in config:
        kw["remat"] = config["REMAT"]
    if "MICROBATCH" in config:
        kw["microbatch"] = config["MICROBATCH"]
    if "CE_CHUNK" in config:
        kw["ce_chunk"] = config["CE_CHUNK"]
    if "ACCUM_DTYPE" in config:
        kw["accum_dtype"] = config["ACCUM_DTYPE"]
    if "ATTN_CHUNK" in config:
        kw["attn_chunk"] = config["ATTN_CHUNK"]
    if "ATTN_MODE" in config:
        kw["attn_mode"] = config["ATTN_MODE"]
    if "MOE_IMPL" in config:
        kw["moe_impl"] = config["MOE_IMPL"]
    run = dataclasses.replace(base_run, **kw)

    rules: Dict[str, Any] = {}
    if "SEQ_ATTN" in config:
        rules["seq_attn"] = config["SEQ_ATTN"]
    if "SEQ_KV" in config:
        rules["seq_kv"] = config["SEQ_KV"]
    fsdp = config.get("FSDP", "pod_data")
    rules["embed"] = {"none": None, "data": ("data",),
                      "pod_data": ("pod", "data")}[fsdp]
    return run, rules


@dataclasses.dataclass
class CellObjective:
    """Roofline step time of one (arch, shape, mesh) cell as an objective.

    Each evaluation traces two reduced-depth steps in a fake world
    (``launch/dryrun.measure_costs``) — seconds of host time, no card.
    Memory feasibility enters as a soft penalty on the full-depth trace's
    peak per rank against ``hbm_limit`` (the profile's device memory by
    default) when ``check_memory`` is set (slower; used for final
    candidates).  A configuration the step cannot run with scores
    ``inf`` and its error is logged, as an infeasible one does in the
    JAX package."""

    arch_id: str
    shape_name: str
    multi_pod: bool = False
    profile: DeviceProfile = H100_SXM
    check_memory: bool = False
    hbm_limit: Optional[float] = None
    device_type: str = "cuda"
    log: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if self.hbm_limit is None:
            self.hbm_limit = float(self.profile.hbm_bytes)

    def __call__(self, config: Dict[str, Any]) -> float:
        from ..launch import dryrun

        base = dryrun.default_run_config(self.arch_id, self.shape_name)
        run, rules = config_to_run_rules(config, base)
        rules = dict(dryrun.default_rules_override(self.arch_id), **rules)
        t0 = time.perf_counter()
        try:
            if self.check_memory:
                rec = dryrun.analyze_cell(
                    self.arch_id, self.shape_name, multi_pod=self.multi_pod,
                    run=run, rules_override=rules, profile=self.profile,
                    device_type=self.device_type)
                step_t = rec["roofline"]["step_t"]
                mem = rec["memory"].get("total_bytes_per_device", 0.0)
                over = max(0.0, mem - self.hbm_limit) / self.hbm_limit
                score = step_t * (1.0 + 2.0 * over)
                detail = {"step_t": step_t, "mem_gib": mem / GiB,
                          "roofline": rec["roofline"]}
            else:
                costs = dryrun.cell_costs(
                    self.arch_id, self.shape_name, run, rules,
                    multi_pod=self.multi_pod, device_type=self.device_type)
                roof = dryrun.roofline(costs, self.profile)
                step_t = roof["step_t"]
                score = step_t
                detail = {k: roof[k] for k in ("step_t", "compute_t",
                                               "memory_t", "collective_t")}
        except Exception as e:  # noqa: BLE001 — infeasible configuration
            self.log.append({"config": dict(config), "score": None,
                             "error": f"{type(e).__name__}: {e}"[:300],
                             "eval_s": round(time.perf_counter() - t0, 1)})
            return math.inf
        self.log.append({"config": dict(config), "score": score,
                         "eval_s": round(time.perf_counter() - t0, 1),
                         **detail})
        return score


# ---------------------------------------------------------------------------
# registry integration: the distributed-config space of one cell is itself a
# tunable "kernel" — same declaration API, same cache, same lookup path as
# the CUDA kernels, so serving/launch can resolve a cell's best sharding
# config with registry.lookup("sharding_cell", ...).
# ---------------------------------------------------------------------------

#: sensible starting point per knob, filtered by each cell's actual space
_CELL_PREFERRED: Dict[str, Any] = {
    "REMAT": "none", "MICROBATCH": 1, "CE_CHUNK": 0,
    "ACCUM_DTYPE": "float32", "ATTN_CHUNK": 0, "ATTN_MODE": "grouped",
    "SEQ_ATTN": None, "FSDP": "pod_data", "SEQ_KV": "model",
    "MOE_IMPL": "scatter",
}

#: memoised CellObjective per cell, so repeated lookups share one eval log
_cell_objectives: Dict[Tuple[str, str, bool], CellObjective] = {}


def _cell_heads_divisible(shape: Shape) -> bool:
    hd = shape.get("heads_divisible")
    if hd is not None:
        return bool(hd)
    from ..configs import get_arch
    cfg = get_arch(shape["arch"]).full
    return bool(cfg.num_heads) and cfg.num_heads % 16 == 0


def _cell_space(shape: Shape) -> SearchSpace:
    from ..configs import get_arch
    cfg = get_arch(shape["arch"]).full
    return build_space(shape["arch"], shape["shape"],
                       _cell_heads_divisible(shape), is_moe=cfg.is_moe)


def _cell_heuristic(shape: Shape) -> Dict[str, Any]:
    return {name: _CELL_PREFERRED[name] for name in _cell_space(shape).names}


def cell_objective(shape: Shape) -> CellObjective:
    key = (shape["arch"], shape["shape"], bool(shape.get("multi_pod")))
    if key not in _cell_objectives:
        _cell_objectives[key] = CellObjective(
            key[0], key[1], multi_pod=key[2])
    return _cell_objectives[key]


@tunable(
    name="sharding_cell",
    space=_cell_space,
    heuristic=_cell_heuristic,
    shape_key=lambda s: (f"{s['arch']}|{s['shape']}|"
                         f"{'mp' if s.get('multi_pod') else 'sp'}"),
    # the roofline objective plays the analytical-model role: dry-run
    # costs, no card.  The profile is the objective's own.
    analytical_model=lambda s, cfg, prof: cell_objective(s)(cfg),
    defaults={"strategy": "greedy", "budget": 16},
    tags=("distributed", "beyond-paper"))
def SHARDING_CELL(shape: Shape, config: Dict[str, Any]):
    """'Building' a cell = translating its config into (RunConfig, rules)."""
    from ..launch import dryrun
    base = dryrun.default_run_config(shape["arch"], shape["shape"])

    def apply():
        return config_to_run_rules(config, base)
    return apply


def tune_cell(arch_id: str, shape_name: str, *, multi_pod: bool = False,
              strategy: str = "greedy", budget: int = 16, seed: int = 0,
              out_path: Optional[str] = None,
              heads_divisible: Optional[bool] = None,
              record: bool = True,
              engine: Optional[Dict[str, Any]] = None,
              cache=None):
    """Run the paper's search over one cell's distributed-config space.

    Routed through the generic registry API: the search runs via
    ``tune_kernel("sharding_cell", ...)`` with a noise-free analytical
    evaluator wrapping the roofline objective, and the winner is recorded
    in the same TuningCache the CUDA kernels use (``cache``, default the
    process's), under the objective's profile.  Each evaluation enters a
    fake world of its own, so evaluations run one at a time
    (``engine`` overrides the default single-worker configuration).
    """
    from .api import tune_kernel
    shape = {"arch": arch_id, "shape": shape_name, "multi_pod": multi_pod}
    if heads_divisible is not None:
        shape["heads_divisible"] = heads_divisible
    objective = cell_objective(shape)
    log_start = len(objective.log)      # the objective is memoized; only
    outcome = tune_kernel(              # this run's evaluations belong here
        SHARDING_CELL, shape, strategy=strategy, budget=budget, seed=seed,
        record=record, cache=cache, profile=objective.profile,
        engine=engine if engine is not None else {"workers": 1},
        evaluator=AnalyticalEvaluator(profile=objective.profile,
                                      noise_sigma=0.0))
    summary = {
        "arch": arch_id, "shape": shape_name, "multi_pod": multi_pod,
        "strategy": strategy, "budget": outcome.budget,
        "best_config": outcome.result.best_config,
        "best_step_t": outcome.result.best_time,
        "evaluations": outcome.result.evaluations,
        "engine_stats": outcome.engine_stats,
        "log": objective.log[log_start:],
    }
    if out_path:
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(summary, f, indent=2, default=str)
    return summary
