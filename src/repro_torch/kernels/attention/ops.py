"""Batched/multi-head entry point + tunable declaration for flash attention.

``FLASH_ATTENTION`` is the complete tuning declaration for the shape
family; ``flash_attention(q, k, v)`` resolves its configuration through
``repro_torch.core.registry.lookup``.

The space is re-derived for the H100: the JAX package's blocks (BLOCK_Q
up to 1024, BLOCK_K up to 2048) need megabytes at D = 128, and a Hopper
block has 227 KB of shared memory and 65,536 registers.  The kernel's
geometry (whole warps, 128 to 512 threads), its register estimate and
its shared memory with PIPELINE_DEPTH K/V stages are constraints of the
space (paper section III-A), so an infeasible config is pruned and never
a failed launch.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ...core import SearchSpace, Tuner, TuningCache
from ...core.profiles import H100_SXM, DeviceProfile, resolve_profile
from ...core.registry import AutotunePolicy, Shape, lookup, tunable
from ...core.space import Config
from .flash import (DTYPES, SOURCE, analytical_time, block_threads,
                    make_flash_attention, register_estimate, smem_footprint,
                    traffic, validate_config)
from .ref import attention_reference

KERNEL_NAME = "flash_attention"

#: block sizes of the H100 space
BLOCK_Q = (16, 32, 64, 128, 256)
BLOCK_K = (16, 32, 64, 128, 256)
#: fewest threads a block of the space has: one warp for each of the
#: SM's four schedulers
MIN_THREADS = 128


def _shape(Sq: int, Sk: int, D: int, causal: bool = True) -> Dict[str, Any]:
    return {"Sq": Sq, "Sk": Sk, "D": D, "causal": bool(causal)}


def shape_key(Sq: int, Sk: int, D: int, causal: bool = True) -> str:
    return f"Sq{Sq}_Sk{Sk}_D{D}_{'c' if causal else 'f'}"


def heuristic_config(Sq: int, Sk: int, D: int = 128) -> Dict[str, Any]:
    """64 x 64 blocks where they divide (smaller listed ones where not),
    BLOCK_K halved until one block's shared memory fits the H100."""
    def pick(d, cands):
        for c in cands:
            if d % c == 0:
                return c
        # no candidate divides d: return d itself — likely out of the
        # declared value list, which the registry's feasibility projection
        # (project_feasible) repairs to the nearest in-space point
        return d
    cfg = {"BLOCK_Q": pick(Sq, (64, 32, 16)),
           "BLOCK_K": pick(Sk, (64, 32, 16)),
           "PIPELINE_DEPTH": 2}
    while (cfg["BLOCK_K"] > BLOCK_K[0]
           and not H100_SXM.fits_smem(smem_footprint(cfg, D))):
        cfg["BLOCK_K"] //= 2
    return cfg


def kernel_takes(bq: int, bk: int, D: int) -> bool:
    """Whether the blocks tile into the kernel's thread geometry at D."""
    try:
        validate_config({"BLOCK_Q": bq, "BLOCK_K": bk}, bq, bk, D)
    except ValueError:
        return False
    return True


def tuning_space(D: int = 128):
    """(values, constraints) of the H100 space at head width ``D``."""
    params = {
        "BLOCK_Q": BLOCK_Q,
        "BLOCK_K": BLOCK_K,
        "PIPELINE_DEPTH": (2, 3),
    }
    def registers_fit(bq, bk):
        cfg = {"BLOCK_Q": bq, "BLOCK_K": bk}
        return register_estimate(cfg, D) <= min(
            255, H100_SXM.regs_per_sm // block_threads(cfg, D))
    constraints = [
        (lambda bq, bk: kernel_takes(bq, bk, D), ("BLOCK_Q", "BLOCK_K"),
         "whole warps, at most 512 threads per block"),
        (registers_fit, ("BLOCK_Q", "BLOCK_K"),
         "the score and output tiles fit the registers"),
        # the K/V ring leaves room for one or two blocks an SM, so a block
        # of fewer than four warps leaves SM schedulers idle (on many heads
        # such blocks ran 2x slower than the best, though one head with
        # more, smaller blocks may time faster)
        (lambda bq, bk: block_threads({"BLOCK_Q": bq, "BLOCK_K": bk}, D)
         >= MIN_THREADS, ("BLOCK_Q", "BLOCK_K"),
         "at least four warps a block"),
        (lambda bq, bk, depth: H100_SXM.fits_smem(smem_footprint(
            {"BLOCK_Q": bq, "BLOCK_K": bk, "PIPELINE_DEPTH": depth}, D)),
         ("BLOCK_Q", "BLOCK_K", "PIPELINE_DEPTH"),
         "Q, P and PIPELINE_DEPTH K/V stages fit an H100 block (227 KB)"),
    ]
    return params, constraints


def _space(shape: Shape) -> SearchSpace:
    Sq, Sk = shape["Sq"], shape["Sk"]
    params, constraints = tuning_space(shape["D"])
    sp = SearchSpace()
    for name, values in params.items():
        sp.add_parameter(name=name, values=values)
    for fn, names, label in constraints:
        sp.add_constraint(fn, names, label)
    sp.add_constraint(lambda bq: Sq % bq == 0, ("BLOCK_Q",), "Sq % BLOCK_Q")
    sp.add_constraint(lambda bk: Sk % bk == 0, ("BLOCK_K",), "Sk % BLOCK_K")
    return sp


def _dtype(shape: Shape) -> torch.dtype:
    """The input type the shape names (default float32)."""
    return DTYPES[shape.get("dtype", "float32")]


def _elt_bytes(shape: Shape) -> int:
    """q/k/v element width from the shape's dtype (default float32)."""
    return _dtype(shape).itemsize


def _make_args(shape: Shape, rng: np.random.Generator):
    """Host (CPU) operands in the shape's dtype; the evaluator moves them
    to its device."""
    Sq, Sk, D = shape["Sq"], shape["Sk"], shape["D"]
    def mk(s):
        x = torch.from_numpy((rng.normal(size=s) * 0.5).astype(np.float32))
        return x.to(_dtype(shape))
    return mk((Sq, D)), mk((Sk, D)), mk((Sk, D))


@tunable(
    name=KERNEL_NAME,
    space=_space,
    heuristic=lambda s: heuristic_config(s["Sq"], s["Sk"], s["D"]),
    shape_key=lambda s: shape_key(s["Sq"], s["Sk"], s["D"],
                                  s.get("causal", True)),
    make_args=_make_args,
    # one element width reaches the args, the build, the model, the
    # footprint and the cost (the key stays the JAX package's, without it)
    analytical_model=lambda s, cfg, prof: analytical_time(
        cfg, prof, s["Sq"], s["Sk"], s["D"], elt_bytes=_elt_bytes(s),
        causal=s.get("causal", True)),
    smem_footprint=lambda s, cfg: smem_footprint(cfg, s["D"],
                                                 elt_bytes=_elt_bytes(s)),
    block_threads=lambda s, cfg: block_threads(cfg, s["D"]),
    register_estimate=lambda s, cfg: register_estimate(cfg, s["D"]),
    cost=lambda s, cfg: traffic(cfg, s["Sq"], s["Sk"], s["D"],
                                causal=s.get("causal", True),
                                elt_bytes=_elt_bytes(s)),
    sources=(SOURCE,),
    reference=lambda s: (lambda q, k, v: attention_reference(
        q, k, v, causal=s.get("causal", True))),
    default_shapes=(_shape(4096, 4096, 128, causal=True),),
    defaults={"strategy": "annealing", "budget": 40},
    tags=("beyond-paper", "attention"))
def FLASH_ATTENTION(shape: Shape, config: Config):
    """Flash attention (beyond paper; same tuning methodology)."""
    return make_flash_attention(shape["Sq"], shape["Sk"], shape["D"], config,
                                causal=shape.get("causal", True),
                                dtype=_dtype(shape))


def lookup_config(Sq: int, Sk: int, D: int, causal: bool = True,
                  profile: Optional[DeviceProfile] = None,
                  cache: Optional[TuningCache] = None,
                  policy: "AutotunePolicy | str | None" = None
                  ) -> Dict[str, Any]:
    return lookup(FLASH_ATTENTION, _shape(Sq, Sk, D, causal),
                  profile=profile, cache=cache, policy=policy)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    config: Optional[Dict[str, Any]] = None,
                    profile: Optional[DeviceProfile] = None,
                    policy: "AutotunePolicy | str | None" = None
                    ) -> torch.Tensor:
    """q: (..., Sq, D), k/v: (..., Sk, D); the leading dims are heads, all
    in one launch.  With ``config=None`` the configuration comes from the
    registry for the profile of ``q``'s device (``profile`` overrides)."""
    Sq, D = q.shape[-2:]
    Sk = k.shape[-2]
    cfg = config or lookup_config(Sq, Sk, D, causal,
                                  resolve_profile(profile, q.device),
                                  policy=policy)
    return make_flash_attention(Sq, Sk, D, cfg, causal=causal,
                                dtype=q.dtype)(q, k, v)


# ---------------------------------------------------------------------------
# legacy tuner integration — thin delegates to the generic API
# ---------------------------------------------------------------------------

def make_tuner(Sq: int, Sk: int, D: int, *, causal: bool = True,
               evaluator=None, profile: Optional[DeviceProfile] = None
               ) -> Tuner:
    return Tuner.from_tunable(FLASH_ATTENTION, _shape(Sq, Sk, D, causal),
                              evaluator=evaluator, profile=profile)


def tune_flash_attention(Sq: int, Sk: int, D: int, *, causal: bool = True,
                         strategy: str = "annealing", budget: int = 40,
                         profile: Optional[DeviceProfile] = None,
                         record: bool = True, seed: int = 0, **kwargs):
    from ...tune.api import tune_kernel
    return tune_kernel(FLASH_ATTENTION, _shape(Sq, Sk, D, causal),
                       strategy=strategy, budget=budget, profile=profile,
                       record=record, seed=seed, **kwargs)
