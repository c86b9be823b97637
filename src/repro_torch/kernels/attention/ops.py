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
a failed launch.  Each input type has its own build, so a shape's
``dtype`` picks the constraints, and a bfloat16 shape has a key of its
own (``shape_key``; the float32 key stays the JAX package's).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ...core import SearchSpace, Tuner, TuningCache, trace
from ...core.profiles import H100_SXM, DeviceProfile, resolve_profile
from ...core.registry import AutotunePolicy, Shape, lookup, tunable
from ...core.space import Config
from .flash import (DTYPES, SOURCE, analytical_time, block_threads,
                    make_flash_attention, register_estimate, smem_footprint,
                    tile, traffic, validate_config)
from .ref import attention_reference

KERNEL_NAME = "flash_attention"

#: block sizes of the H100 space
BLOCK_Q = (16, 32, 64, 128, 256)
BLOCK_K = (16, 32, 64, 128, 256)
#: fewest threads a block of the space has: one warp for each of the
#: SM's four schedulers
MIN_THREADS = 128


def _dtype_name(dtype: "torch.dtype | str") -> str:
    return str(dtype).removeprefix("torch.")


def _shape(Sq: int, Sk: int, D: int, causal: bool = True,
           dtype: "torch.dtype | str" = "float32") -> Dict[str, Any]:
    """The declaration's shape; a float32 one names no dtype, as the JAX
    package's shapes do."""
    shape = {"Sq": Sq, "Sk": Sk, "D": D, "causal": bool(causal)}
    if _dtype_name(dtype) != "float32":
        shape["dtype"] = _dtype_name(dtype)
    return shape


def shape_key(Sq: int, Sk: int, D: int, causal: bool = True,
              dtype: "torch.dtype | str" = "float32") -> str:
    """The JAX package's key; a bfloat16 shape appends ``_bfloat16``, since
    its build (and winner) is another than the float32 one's."""
    key = f"Sq{Sq}_Sk{Sk}_D{D}_{'c' if causal else 'f'}"
    return key + ("_bfloat16" if _dtype_name(dtype) == "bfloat16" else "")


def _divisors_down(d: int, top: int):
    """The divisors of ``d`` not above ``top``, largest first (1 divides
    every length)."""
    return [c for c in range(min(d, top), 0, -1) if d % c == 0]


def heuristic_config(Sq: int, Sk: int, D: int = 128) -> Dict[str, Any]:
    """64 x 64 blocks where they divide (smaller listed ones where not;
    failing those, the largest divisor below 64: the build takes every
    block that divides its length), BLOCK_K stepped down through the
    divisors of Sk until one block's shared memory fits the H100."""
    def pick(d, cands):
        for c in cands:
            if d % c == 0:
                return c
        return _divisors_down(d, cands[0])[0]
    cfg = {"BLOCK_Q": pick(Sq, (64, 32, 16)),
           "BLOCK_K": pick(Sk, (64, 32, 16)),
           "PIPELINE_DEPTH": 2}
    smaller = _divisors_down(Sk, cfg["BLOCK_K"])[1:]
    while smaller and not H100_SXM.fits_smem(smem_footprint(cfg, D)):
        cfg["BLOCK_K"] = smaller.pop(0)
    return cfg


def kernel_takes(bq: int, bk: int, D: int, elt_bytes: int = 4) -> bool:
    """Whether the blocks tile the thread geometry of the build for
    ``elt_bytes``-wide inputs at D exactly (whole warps, no rows or keys
    masked; D may be padded) within its thread limit: what a search
    sweeps.  The build also takes blocks it must round up."""
    try:
        validate_config({"BLOCK_Q": bq, "BLOCK_K": bk}, bq, bk, D, elt_bytes)
    except ValueError:
        return False
    return tile({"BLOCK_Q": bq, "BLOCK_K": bk}, D, elt_bytes)[:2] == (bq, bk)


def tuning_space(D: int = 128, elt_bytes: int = 4):
    """(values, constraints) of the H100 space at head width ``D`` for the
    build of ``elt_bytes``-wide inputs."""
    params = {
        "BLOCK_Q": BLOCK_Q,
        "BLOCK_K": BLOCK_K,
        "PIPELINE_DEPTH": (2, 3),
    }
    def registers_fit(bq, bk):
        cfg = {"BLOCK_Q": bq, "BLOCK_K": bk}
        return register_estimate(cfg, D, elt_bytes) <= min(
            255, H100_SXM.regs_per_sm // block_threads(cfg, D, elt_bytes))
    staged = "Q, P" if elt_bytes == 4 else "Q"
    constraints = [
        (lambda bq, bk: kernel_takes(bq, bk, D, elt_bytes),
         ("BLOCK_Q", "BLOCK_K"),
         "whole warps, at most 512 threads per block"),
        (registers_fit, ("BLOCK_Q", "BLOCK_K"),
         "the score and output tiles fit the registers"),
        # the K/V ring leaves room for one or two blocks an SM, so a block
        # of fewer than four warps leaves SM schedulers idle (on many heads
        # such blocks ran 2x slower than the best, though one head with
        # more, smaller blocks may time faster)
        (lambda bq, bk: block_threads({"BLOCK_Q": bq, "BLOCK_K": bk}, D,
                                      elt_bytes)
         >= MIN_THREADS, ("BLOCK_Q", "BLOCK_K"),
         "at least four warps a block"),
        (lambda bq, bk, depth: H100_SXM.fits_smem(smem_footprint(
            {"BLOCK_Q": bq, "BLOCK_K": bk, "PIPELINE_DEPTH": depth}, D,
            elt_bytes)),
         ("BLOCK_Q", "BLOCK_K", "PIPELINE_DEPTH"),
         f"{staged} and PIPELINE_DEPTH K/V stages fit an H100 block "
         "(227 KB)"),
    ]
    return params, constraints


def _space(shape: Shape) -> SearchSpace:
    Sq, Sk = shape["Sq"], shape["Sk"]
    params, constraints = tuning_space(shape["D"], _elt_bytes(shape))
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
                                  s.get("causal", True),
                                  s.get("dtype", "float32")),
    # a float32 shape names no dtype, so a nearest-shape comparison reads
    # its omission as float32: a bf16 winner is no float32 neighbour
    shape_defaults={"dtype": "float32"},
    make_args=_make_args,
    # one element width reaches the key, the args, the build, the space,
    # the model, the footprint, the threads, the registers and the cost
    analytical_model=lambda s, cfg, prof: analytical_time(
        cfg, prof, s["Sq"], s["Sk"], s["D"], elt_bytes=_elt_bytes(s),
        causal=s.get("causal", True)),
    smem_footprint=lambda s, cfg: smem_footprint(cfg, s["D"],
                                                 elt_bytes=_elt_bytes(s)),
    block_threads=lambda s, cfg: block_threads(cfg, s["D"], _elt_bytes(s)),
    register_estimate=lambda s, cfg: register_estimate(cfg, s["D"],
                                                       _elt_bytes(s)),
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
                  policy: "AutotunePolicy | str | None" = None,
                  dtype: "torch.dtype | str" = "float32"
                  ) -> Dict[str, Any]:
    return lookup(FLASH_ATTENTION, _shape(Sq, Sk, D, causal, dtype),
                  profile=profile, cache=cache, policy=policy)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    config: Optional[Dict[str, Any]] = None,
                    profile: Optional[DeviceProfile] = None,
                    policy: "AutotunePolicy | str | None" = None
                    ) -> torch.Tensor:
    """q: (..., Sq, D), k/v: (..., Sk, D); the leading dims are heads, all
    in one launch.  With ``config=None`` the configuration comes from the
    registry for the profile of ``q``'s device (``profile`` overrides) and
    ``q``'s dtype."""
    with trace.span("op.flash_attention"):
        Sq, D = q.shape[-2:]
        Sk = k.shape[-2]
        cfg = config or lookup_config(Sq, Sk, D, causal,
                                      resolve_profile(profile, q.device),
                                      policy=policy, dtype=q.dtype)
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
