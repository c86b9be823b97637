"""Public entry point + tunable declaration for the conv2d case study.

``CONV2D`` is the complete tuning declaration (space, heuristic, models,
reference) for the shape family; ``conv2d(image, filt)`` resolves its
configuration through ``repro_torch.core.registry.lookup``.  The space
keeps the JAX package's parameters and values; the card's limits are
added as constraints (paper section III-A): at most 1024 threads a block,
and a halo tile that fits one block's shared memory (227 KB).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ...core import SearchSpace, Tuner, TuningCache
from ...core.profiles import H100_SXM, DeviceProfile, resolve_profile
from ...core.registry import AutotunePolicy, Shape, lookup, tunable
from ...core.space import Config
from .conv2d import (DTYPES, SOURCE, analytical_time, block_threads,
                     make_conv2d, micro_tile, register_estimate,
                     smem_footprint, traffic)
from .ref import conv2d_reference

KERNEL_NAME = "conv2d"


def _shape(H: int, W: int, Fh: int, Fw: int) -> Dict[str, Any]:
    return {"H": H, "W": W, "Fh": Fh, "Fw": Fw}


def shape_key(H: int, W: int, Fh: int, Fw: int) -> str:
    return f"H{H}_W{W}_F{Fh}x{Fw}"


def heuristic_config(H: int, W: int, Fh: int, Fw: int) -> Dict[str, Any]:
    # tiny images make min(...) fall outside the declared value lists;
    # the registry's project_feasible snaps those to the nearest in-space
    # values before the config is served
    return {"BLOCK_H": min(16, H), "BLOCK_W": min(256, W),
            "SUB_H": 1, "UNROLL": True, "HALO_MODE": "materialize"}


def _threads_fit(bh, bw, sub, mode) -> bool:
    return block_threads({"BLOCK_H": bh, "BLOCK_W": bw, "SUB_H": sub,
                          "HALO_MODE": mode}) <= 1024


def tuning_space(extended: bool = False):
    """Conv parameter space (compare paper Table II: 3424 configurations);
    the shared-memory constraint depends on the filter and is added by the
    declaration's space for a shape."""
    if extended:
        params = {
            "BLOCK_H": (4, 8, 16, 32, 64, 128),
            "BLOCK_W": (64, 128, 256, 512, 1024),
            "SUB_H": (1, 2, 4, 8),
            "UNROLL": (True, False),
            "HALO_MODE": ("materialize", "xla"),
            "PAD_W": (0, 1),
            "PIPELINE_DEPTH": (2, 3, 4),
        }
    else:
        params = {
            "BLOCK_H": (8, 16, 32),
            "BLOCK_W": (128, 256),
            "SUB_H": (1, 2),
            "UNROLL": (True, False),
            "HALO_MODE": ("materialize", "xla"),
        }
    constraints = [
        (lambda bh, s: bh % s == 0, ("BLOCK_H", "SUB_H"),
         "BLOCK_H divisible by SUB_H"),
        (_threads_fit, ("BLOCK_H", "BLOCK_W", "SUB_H", "HALO_MODE"),
         "at most 1024 threads per block"),
    ]
    return params, constraints


def _space(shape: Shape, extended: bool = True) -> SearchSpace:
    Fh, Fw = shape["Fh"], shape["Fw"]
    params, constraints = tuning_space(extended=extended)
    sp = SearchSpace()
    for name, values in params.items():
        sp.add_parameter(name=name, values=values)
    for fn, names, label in constraints:
        sp.add_constraint(fn, names, label)
    names = ("BLOCK_H", "BLOCK_W", "HALO_MODE") + (
        ("PAD_W",) if "PAD_W" in params else ())

    def fits(bh, bw, mode, pad=0):
        return H100_SXM.fits_smem(smem_footprint(
            {"BLOCK_H": bh, "BLOCK_W": bw, "HALO_MODE": mode, "PAD_W": pad},
            Fh, Fw))
    sp.add_constraint(fits, names, "shared memory fits an H100 block (227 KB)")
    return sp


def _dtype(shape: Shape) -> torch.dtype:
    """The input type the shape names (default float32)."""
    return DTYPES[shape.get("dtype", "float32")]


def _elt_bytes(shape: Shape) -> int:
    """Image element width from the shape's dtype (default float32)."""
    return _dtype(shape).itemsize


def _make_args(shape: Shape, rng: np.random.Generator):
    """Host (CPU) operands in the shape's dtype; the evaluator moves them
    to its device."""
    H, W, Fh, Fw = shape["H"], shape["W"], shape["Fh"], shape["Fw"]
    img = torch.from_numpy(rng.normal(size=(H, W)).astype(np.float32))
    flt = torch.from_numpy(rng.normal(size=(Fh, Fw)).astype(np.float32))
    return img.to(_dtype(shape)), flt.to(_dtype(shape))


def _registers(cfg: Config, Fh: int, Fw: int) -> int:
    """Registers a thread of ``cfg`` needs at the build's register tile
    (0 for 'xla', which launches no kernel of ours)."""
    if cfg.get("HALO_MODE", "materialize") == "xla":
        return 0
    return register_estimate(cfg, Fw, micro_tile(cfg, Fh, Fw)[1])


@tunable(
    name=KERNEL_NAME,
    space=_space,
    heuristic=lambda s: heuristic_config(s["H"], s["W"], s["Fh"], s["Fw"]),
    shape_key=lambda s: shape_key(s["H"], s["W"], s["Fh"], s["Fw"]),
    make_args=_make_args,
    # the shape's dtype reaches the args, the build, the model and the
    # cost alike; the footprint is the float32 tile the build stages for
    # either input type
    analytical_model=lambda s, cfg, prof: analytical_time(
        cfg, prof, s["H"], s["W"], s["Fh"], s["Fw"],
        elt_bytes=_elt_bytes(s)),
    smem_footprint=lambda s, cfg: smem_footprint(cfg, s["Fh"], s["Fw"]),
    block_threads=lambda s, cfg: block_threads(cfg),
    register_estimate=lambda s, cfg: _registers(cfg, s["Fh"], s["Fw"]),
    cost=lambda s, cfg: traffic(cfg, s["H"], s["W"], s["Fh"], s["Fw"],
                                elt_bytes=_elt_bytes(s)),
    sources=(SOURCE,),
    reference=lambda s: conv2d_reference,
    default_shapes=(_shape(4096, 4096, 3, 3),),
    # paper V-B: budget 107 = 1/32 of the 3424-config EXTENDED space, so
    # registry-driven tuning must search that space too
    defaults={"strategy": "annealing", "budget": 107, "extended_space": True},
    tags=("paper-case-study", "conv"))
def CONV2D(shape: Shape, config: Config):
    """The paper's section V case study: 2D convolution."""
    return make_conv2d(shape["H"], shape["W"], shape["Fh"], shape["Fw"],
                       config, dtype=_dtype(shape))


def lookup_config(H: int, W: int, Fh: int, Fw: int,
                  profile: Optional[DeviceProfile] = None,
                  cache: Optional[TuningCache] = None,
                  policy: "AutotunePolicy | str | None" = None
                  ) -> Dict[str, Any]:
    return lookup(CONV2D, _shape(H, W, Fh, Fw), profile=profile, cache=cache,
                  policy=policy)


def conv2d(image: torch.Tensor, filt: torch.Tensor,
           config: Optional[Dict[str, Any]] = None, weight: float = 1.0,
           profile: Optional[DeviceProfile] = None,
           policy: "AutotunePolicy | str | None" = None) -> torch.Tensor:
    """weight * (image cross-correlated with filt), same size, zero padded.

    With ``config=None`` the configuration comes from the registry for the
    profile of ``image``'s device (``profile`` overrides).
    """
    H, W = image.shape
    Fh, Fw = filt.shape
    cfg = config or lookup_config(H, W, Fh, Fw,
                                  resolve_profile(profile, image.device),
                                  policy=policy)
    return make_conv2d(H, W, Fh, Fw, cfg, weight=weight,
                       dtype=image.dtype)(image, filt)


# ---------------------------------------------------------------------------
# legacy tuner integration — thin delegates to the generic API
# ---------------------------------------------------------------------------

def make_tuner(H: int, W: int, Fh: int, Fw: int, *, evaluator=None,
               profile: Optional[DeviceProfile] = None,
               extended_space: bool = True) -> Tuner:
    return Tuner.from_tunable(CONV2D, _shape(H, W, Fh, Fw),
                              evaluator=evaluator, profile=profile,
                              extended_space=extended_space)


def tune_conv2d(H: int, W: int, Fh: int, Fw: int,
                strategy: str = "annealing", budget: int = 107,
                profile: Optional[DeviceProfile] = None, record: bool = True,
                seed: int = 0, **kwargs):
    """Paper section V-B used budget=107 (1/32 of its 3424-config space)."""
    from ...tune.api import tune_kernel
    kwargs.setdefault("extended_space", True)
    return tune_kernel(CONV2D, _shape(H, W, Fh, Fw), strategy=strategy,
                       budget=budget, profile=profile, record=record,
                       seed=seed, **kwargs)
