"""Public entry point for the tuned GEMM, declared via the tunable registry.

``GEMM`` is the complete tuning declaration (space, heuristic, models,
reference) for the shape family; ``matmul(a, b)`` resolves its block
configuration through ``repro_torch.core.registry.lookup`` — tuned-cache
hit, then heuristic, with optional tune-on-miss (CLTune scenario 3).  The
per-kernel helpers (``make_tuner``/``tune_matmul``/``lookup_config``)
are thin delegates to the generic API.

The space is re-derived for the H100: the JAX package's 128-512 tiles
need megabytes of fast memory, and a Hopper block has 227 KB of shared
memory.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ...core import SearchSpace, Tuner, TuningCache, trace
from ...core.profiles import H100_SXM, DeviceProfile, resolve_profile
from ...core.registry import AutotunePolicy, Shape, lookup, tunable
from ...core.space import Config
from . import ref
from .matmul import (DTYPES, SOURCE, analytical_time, block_threads,
                     make_matmul, micro_tile, smem_footprint, traffic)

KERNEL_NAME = "gemm"


def _dtype_name(dtype: "torch.dtype | str") -> str:
    return str(dtype).removeprefix("torch.")


def _shape(M: int, N: int, K: int, dtype="float32") -> Dict[str, Any]:
    return {"M": M, "N": N, "K": K, "dtype": _dtype_name(dtype)}


def shape_key(M: int, N: int, K: int, dtype="float32") -> str:
    return f"M{M}_N{N}_K{K}_{_dtype_name(dtype)}"


#: block sizes the heuristic and the compact space draw from
BLOCK_MN = (32, 64, 128)
BLOCK_K = (8, 16, 32, 64)


def _pick(d: int, cands) -> int:
    """The largest of ``cands`` that divides ``d``; failing that, the
    largest divisor of ``d`` not above the largest of them (1 divides
    every dim, so a prime dim gets 1)."""
    for c in sorted(cands, reverse=True):
        if d % c == 0:
            return c
    return max(c for c in range(1, min(d, max(cands)) + 1) if d % c == 0)


def heuristic_config(M: int, N: int, K: int) -> Dict[str, Any]:
    """Largest listed blocks that divide the problem (:func:`_pick`; the
    build takes every block that divides its dim), sensible defaults."""
    return {
        "BLOCK_M": _pick(M, BLOCK_MN),
        "BLOCK_N": _pick(N, BLOCK_MN),
        "BLOCK_K": _pick(K, BLOCK_K),
        "GRID_ORDER": "mn", "INNER_STEPS": 1,
        "ACC_DTYPE": "float32", "ACC_IN_OUTPUT": False, "TRANS_A": False,
    }


def tuning_space(extended: bool = False):
    """(values, constraints) for the GEMM space.

    ``extended=True`` is the paper-scale space (>200k configurations,
    paper Fig. 7), whose larger tiles fall off the shared-memory and
    thread cliffs; the compact space is what a search on the card sweeps.
    """
    if extended:
        params = {
            "BLOCK_M": (16, 32, 64, 128, 256, 512),
            "BLOCK_N": (16, 32, 64, 128, 256, 512),
            "BLOCK_K": (8, 16, 32, 64, 128, 256),
            "GRID_ORDER": ("mn", "nm"),
            "INNER_STEPS": (1, 2, 4, 8),
            "ACC_DTYPE": ("float32", "bfloat16"),
            "ACC_IN_OUTPUT": (False, True),
            "TRANS_A": (False, True),
            "PIPELINE_DEPTH": (2, 3, 4),
            "NBUF_OUT": (1, 2),
            "PACK": (1, 2, 4),
        }
    else:
        params = {
            "BLOCK_M": BLOCK_MN,
            "BLOCK_N": BLOCK_MN,
            "BLOCK_K": BLOCK_K,
            "GRID_ORDER": ("mn", "nm"),
            "INNER_STEPS": (1, 2),
            "ACC_DTYPE": ("float32",),
            "ACC_IN_OUTPUT": (False, True),
            "TRANS_A": (False,),
        }
    constraints = [
        (lambda bk, s: bk % s == 0, ("BLOCK_K", "INNER_STEPS"),
         "BLOCK_K divisible by INNER_STEPS"),
        (lambda acc_out, acc: (not acc_out) or acc == "float32",
         ("ACC_IN_OUTPUT", "ACC_DTYPE"), "in-place acc requires f32"),
        (lambda bm, bn: micro_tile({"BLOCK_M": bm, "BLOCK_N": bn})[2] <= 1024,
         ("BLOCK_M", "BLOCK_N"), "at most 1024 threads per block"),
    ]
    if extended:
        constraints.append((
            lambda bm, bn, bk, depth: H100_SXM.fits_smem(smem_footprint(
                {"BLOCK_M": bm, "BLOCK_N": bn, "BLOCK_K": bk,
                 "PIPELINE_DEPTH": depth})),
            ("BLOCK_M", "BLOCK_N", "BLOCK_K", "PIPELINE_DEPTH"),
            "PIPELINE_DEPTH stages fit an H100 block (227 KB)"))
    else:
        # the compact space has no PIPELINE_DEPTH: the JAX default of 2
        constraints.append((
            lambda bm, bn, bk: H100_SXM.fits_smem(smem_footprint(
                {"BLOCK_M": bm, "BLOCK_N": bn, "BLOCK_K": bk})),
            ("BLOCK_M", "BLOCK_N", "BLOCK_K"),
            "two stages fit an H100 block (227 KB)"))
    return params, constraints


def _space(shape: Shape, extended: bool = False) -> SearchSpace:
    M, N, K = shape["M"], shape["N"], shape["K"]
    params, constraints = tuning_space(extended=extended)
    sp = SearchSpace()
    for name, values in params.items():
        sp.add_parameter(name=name, values=values)
    for fn, names, label in constraints:
        sp.add_constraint(fn, names, label)
    # problem-size divisibility (device-independent feasibility)
    sp.add_constraint(lambda bm: M % bm == 0, ("BLOCK_M",), "M % BLOCK_M")
    sp.add_constraint(lambda bn: N % bn == 0, ("BLOCK_N",), "N % BLOCK_N")
    sp.add_constraint(lambda bk: K % bk == 0, ("BLOCK_K",), "K % BLOCK_K")
    return sp


def _dtype(shape: Shape) -> torch.dtype:
    """The input type the shape names (default float32)."""
    return DTYPES[shape.get("dtype", "float32")]


def _elt_bytes(shape: Shape) -> int:
    """Input element width from the shape's dtype (default float32)."""
    return _dtype(shape).itemsize


def _make_args(shape: Shape, rng: np.random.Generator):
    """Host (CPU) operands in the shape's dtype; the evaluator moves them
    to its device."""
    M, N, K = shape["M"], shape["N"], shape["K"]
    a = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32))
    return a.to(_dtype(shape)), b.to(_dtype(shape))


@tunable(
    name=KERNEL_NAME,
    space=_space,
    heuristic=lambda s: heuristic_config(s["M"], s["N"], s["K"]),
    shape_key=lambda s: shape_key(s["M"], s["N"], s["K"],
                                  s.get("dtype", "float32")),
    make_args=_make_args,
    # one element width reaches the args, the build, the model, the
    # footprint and the cost, so a proof, a price and a time describe the
    # same build
    analytical_model=lambda s, cfg, prof: analytical_time(
        cfg, prof, s["M"], s["N"], s["K"], elt_bytes=_elt_bytes(s)),
    smem_footprint=lambda s, cfg: smem_footprint(
        cfg, elt_bytes=_elt_bytes(s)),
    block_threads=lambda s, cfg: block_threads(cfg, _elt_bytes(s)),
    cost=lambda s, cfg: traffic(cfg, s["M"], s["N"], s["K"],
                                elt_bytes=_elt_bytes(s)),
    sources=(SOURCE,),
    reference=lambda s: (lambda a, b: ref.gemm_reference(a, b)),
    default_shapes=(_shape(2048, 2048, 2048),),
    defaults={"strategy": "annealing", "budget": 100},
    tags=("paper-case-study", "gemm"))
def GEMM(shape: Shape, config: Config):
    """The paper's section VI case study: the tiled CUDA GEMM."""
    return make_matmul(shape["M"], shape["N"], shape["K"], config,
                       out_dtype=_dtype(shape))


def lookup_config(M: int, N: int, K: int,
                  profile: Optional[DeviceProfile] = None,
                  cache: Optional[TuningCache] = None,
                  policy: "AutotunePolicy | str | None" = None,
                  dtype: "torch.dtype | str" = "float32"
                  ) -> Dict[str, Any]:
    return lookup(GEMM, _shape(M, N, K, dtype), profile=profile,
                  cache=cache, policy=policy)


def matmul(a: torch.Tensor, b: torch.Tensor,
           config: Optional[Dict[str, Any]] = None,
           *, alpha: float = 1.0, beta: float = 0.0,
           c: Optional[torch.Tensor] = None,
           profile: Optional[DeviceProfile] = None,
           policy: "AutotunePolicy | str | None" = None) -> torch.Tensor:
    """C = alpha * op(A) @ B (+ beta * C), on the tiled GEMM.

    With ``config=None`` the configuration comes from the registry for the
    profile of ``a``'s device (``profile`` overrides) and ``a``'s dtype:
    a bfloat16 product resolves what was tuned for bfloat16.  The alpha/beta
    epilogue is plain PyTorch; the kernel does the FLOP-heavy product, as
    in the paper's GEMM.
    """
    with trace.span("op.matmul"):
        trans = bool((config or {}).get("TRANS_A", False))
        M = a.shape[1] if trans else a.shape[0]
        K = a.shape[0] if trans else a.shape[1]
        N = b.shape[1]
        cfg = config or lookup_config(M, N, K,
                                      resolve_profile(profile, a.device),
                                      policy=policy, dtype=a.dtype)
        out = make_matmul(M, N, K, cfg, out_dtype=a.dtype)(a, b)
        if alpha != 1.0:
            out = alpha * out
        if c is not None and beta != 0.0:
            out = out + beta * c
        return out


# ---------------------------------------------------------------------------
# legacy tuner integration — thin delegates to the generic API
# ---------------------------------------------------------------------------

def make_tuner(M: int, N: int, K: int, *, evaluator=None,
               profile: Optional[DeviceProfile] = None,
               extended_space: bool = False) -> Tuner:
    """A ready-to-run Tuner for this GEMM shape (the paper's case study 2)."""
    return Tuner.from_tunable(GEMM, _shape(M, N, K), evaluator=evaluator,
                              profile=profile, extended_space=extended_space)


def tune_matmul(M: int, N: int, K: int, strategy: str = "annealing",
                budget: int = 100, profile: Optional[DeviceProfile] = None,
                record: bool = True, seed: int = 0, **kwargs):
    from ...tune.api import tune_kernel
    return tune_kernel(GEMM, _shape(M, N, K), strategy=strategy,
                       budget=budget, profile=profile, record=record,
                       seed=seed, **kwargs)
