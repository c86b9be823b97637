"""Static resource checker: CLTune §III-A device limits, proven offline.

The paper queries the device for its limits (max workgroup size, local
memory bytes) and auto-imposes them as search-space constraints so
illegal configs are never launched.  The CUDA analogue: a kernel's
declared ``smem_footprint(shape, config) -> bytes`` evaluated against
``DeviceProfile.smem_per_block_optin`` (the shared memory one block may
claim after opting in), and its declared ``block_threads(shape, config)``
against ``DeviceProfile.max_threads_per_block`` (1024).  A config over
either limit is **proven infeasible** — the card refuses its launch
(``cudaFuncSetAttribute`` or the launch itself fails) — so the engine can
answer it as an ``inf`` trial without building it, the lookup chain can
refuse to transfer it, and no survivor-fraction hedge is needed (unlike
*predicted* pruning, a proof cannot be wrong about more than the
declaration itself).

Registers are not proven: ptxas decides them, so a kernel's
``register_estimate`` only feeds an advisory finding.  Warp and vector
alignment are advisory too: a block of threads that is not whole warps
wastes lanes, and a tile row that is not a multiple of 16 bytes breaks
16-byte ``cp.async``/vector loads, but both still run, so making them
hard constraints would change search winners.
"""

from __future__ import annotations

from typing import (TYPE_CHECKING, Any, Callable, Dict, List, Mapping,
                    Optional, Tuple)

from ..core.profiles import DeviceProfile
from ..core.space import SearchSpace
from .findings import Finding

if TYPE_CHECKING:                                    # pragma: no cover
    from ..core.registry import TunableKernel

Shape = Mapping[str, Any]
Config = Mapping[str, Any]
#: a proven checker maps a config to the list of violated limits
ProvenChecker = Callable[[Config], List[str]]

_DTYPE_BYTES = {"float32": 4, "f32": 4, "bfloat16": 2, "bf16": 2,
                "float16": 2, "f16": 2, "int8": 1, "fp8": 1,
                "float64": 8, "f64": 8}

#: threads of one warp
WARP = 32
#: bytes one ``cp.async``/vector load moves at its widest
VECTOR_BYTES = 16


def dtype_bytes(shape: Shape, default: int = 4) -> int:
    """Element width implied by a shape dict's ``dtype`` entry."""
    name = str(shape.get("dtype", "")).lower()
    return _DTYPE_BYTES.get(name, default)


def footprint_bytes(kernel: "TunableKernel", shape: Shape,
                    config: Config) -> Optional[int]:
    """Declared shared memory of ``config`` at ``shape``, or ``None``
    when the kernel declares no model (no proof possible)."""
    if kernel.smem_footprint is None:
        return None
    return int(kernel.smem_footprint(dict(shape), dict(config)))


def threads_per_block(kernel: "TunableKernel", shape: Shape,
                      config: Config) -> Optional[int]:
    """Declared threads of one block, or ``None`` when not declared."""
    if kernel.block_threads is None:
        return None
    return int(kernel.block_threads(dict(shape), dict(config)))


def limit_violations(smem: Optional[int], threads: Optional[int],
                     profile: DeviceProfile) -> List[str]:
    """The device limits a block of ``smem`` bytes and ``threads`` threads
    violates on ``profile`` (None = not declared, nothing to prove)."""
    out = []
    if smem is not None and not profile.fits_smem(smem):
        out.append(f"smem: declared footprint {smem} B > "
                   f"{profile.smem_per_block_optin} B on {profile.name}")
    if threads is not None and not profile.fits_threads(threads):
        out.append(f"threads: declared {threads} threads per block > "
                   f"{profile.max_threads_per_block} on {profile.name}")
    return out


def proven_violations(kernel: "TunableKernel", shape: Shape, config: Config,
                      profile: DeviceProfile) -> List[str]:
    """Device limits ``config`` provably violates at ``shape``.

    Empty list means "no proof of infeasibility" — it does NOT mean the
    config is feasible.  A model that raises yields no proof (the
    declaration bug is the linter's job, not the prune path's).
    """
    try:
        smem = footprint_bytes(kernel, shape, config)
        threads = threads_per_block(kernel, shape, config)
    except Exception:
        return []
    return limit_violations(smem, threads, profile)


def proven_checker(kernel: "TunableKernel", shape: Shape,
                   profile: DeviceProfile) -> Optional[ProvenChecker]:
    """Engine-attachable checker, or ``None`` if no limit model."""
    if kernel.smem_footprint is None and kernel.block_threads is None:
        return None
    frozen = dict(shape)

    def check(config: Config) -> List[str]:
        return proven_violations(kernel, frozen, config, profile)

    return check


def device_constraints(
        kernel: "TunableKernel", shape: Shape, profile: DeviceProfile,
        names: Tuple[str, ...]
) -> List[Tuple[Callable[..., bool], Tuple[str, ...], str]]:
    """Auto-imposed constraints, CLTune §III-A style.

    Returns ``(fn, names, label)`` triples ready for
    ``SearchSpace.add_constraint``, spanning the given parameter
    ``names``.  Only *proof* rules become constraints (shared memory and
    threads per block); alignment stays advisory because a misaligned
    tile is legal.
    """
    checker = proven_checker(kernel, shape, profile)
    if checker is None:
        return []

    def fits(*values: object) -> bool:
        return not checker(dict(zip(names, values)))

    label = f"analyze:smem<={profile.smem_per_block_optin}B@{profile.name}"
    return [(fits, tuple(names), label)]


def install_device_constraints(space: SearchSpace, kernel: "TunableKernel",
                               shape: Shape,
                               profile: DeviceProfile) -> int:
    """Add the proven device constraints to ``space``; returns count."""
    triples = device_constraints(kernel, shape, profile, space.names)
    for fn, names, label in triples:
        space.add_constraint(fn, names, label=label)
    return len(triples)


def alignment_findings(kernel: "TunableKernel", shape: Shape, config: Config,
                       profile: DeviceProfile, *,
                       context: str = "heuristic") -> List[Finding]:
    """Advisory warp and vector alignment report for one config.

    ``align-warp``: the declared threads per block are not whole warps
    (the last warp runs with idle lanes).  ``align-vector``: an integer
    block-like parameter (``BLOCK_*``) whose row of elements is not a
    multiple of 16 bytes, so 16-byte ``cp.async``/vector loads do not
    tile it.  Info severity: legal, just suspicious.
    """
    out: List[Finding] = []
    try:
        threads = threads_per_block(kernel, shape, config)
    except Exception:
        threads = None
    if threads and threads % WARP:
        out.append(Finding(
            rule_id="align-warp", severity="info", kernel=kernel.name,
            shape=dict(shape), profile=profile.name,
            detail=f"{context} config has {threads} threads per block, not "
                   f"a multiple of the {WARP}-thread warp (idle lanes)",
            data={"threads": threads, "warp": WARP, "context": context}))
    elt = dtype_bytes(shape)
    for name, value in config.items():
        if not name.startswith("BLOCK"):
            continue
        if isinstance(value, bool) or not isinstance(value, int):
            continue
        if (value * elt) % VECTOR_BYTES:
            out.append(Finding(
                rule_id="align-vector", severity="info",
                kernel=kernel.name, shape=dict(shape),
                profile=profile.name,
                detail=f"{context} {name}={value} is {value * elt} B of "
                       f"{elt}-byte elements, not a multiple of the "
                       f"{VECTOR_BYTES}-byte cp.async/vector load",
                data={"param": name, "value": value, "elt_bytes": elt,
                      "context": context}))
    return out


def register_findings(kernel: "TunableKernel", shape: Shape, config: Config,
                      profile: DeviceProfile, *,
                      context: str = "heuristic") -> List[Finding]:
    """Advisory register report for one config: the declared estimate
    against what one thread may hold when the block is resident (the
    register file over the threads, at most 255).  ptxas decides the
    real count and spills past it, so this is never a proof."""
    if kernel.register_estimate is None:
        return []
    try:
        regs = int(kernel.register_estimate(dict(shape), dict(config)))
        threads = threads_per_block(kernel, shape, config)
    except Exception:
        return []
    if not threads:
        return []
    budget = min(255, profile.regs_per_sm // threads)
    if regs <= budget:
        return []
    return [Finding(
        rule_id="register-estimate", severity="info", kernel=kernel.name,
        shape=dict(shape), profile=profile.name,
        detail=f"{context} config needs about {regs} registers a thread; "
               f"{threads} threads leave {budget} on {profile.name} "
               f"(ptxas decides: spills or fewer resident blocks)",
        data={"registers": regs, "budget": budget, "threads": threads,
              "context": context})]


def resource_findings(kernel: "TunableKernel", shape: Shape,
                      profile: DeviceProfile,
                      feasible_sample: List[Dict[str, Any]],
                      confidence: str) -> List[Finding]:
    """Device-feasibility findings for one (kernel, shape, profile).

    * every sampled feasible config over a limit -> the whole space is
      unusable on that device: error when the sample was exhaustive,
      warning otherwise;
    * a nonzero fraction over a limit -> info with the proven fraction
      (these are exactly the configs the engine will answer without
      building).
    """
    if (kernel.smem_footprint is None and kernel.block_threads is None) \
            or not feasible_sample:
        return []
    over = 0
    broken = 0
    for cfg in feasible_sample:
        try:
            smem = footprint_bytes(kernel, shape, cfg)
            threads = threads_per_block(kernel, shape, cfg)
        except Exception:
            broken += 1
            continue
        if limit_violations(smem, threads, profile):
            over += 1
    out: List[Finding] = []
    n = len(feasible_sample)
    if broken:
        out.append(Finding(
            rule_id="footprint-model-raises", severity="error",
            kernel=kernel.name, shape=dict(shape), profile=profile.name,
            detail=f"smem_footprint or block_threads raised on {broken}/{n} "
                   f"feasible config(s); a raising model yields no proofs "
                   f"and no pruning", data={"raised": broken, "sampled": n}))
    if over == n and broken == 0:
        exact = confidence == "exact" and n < 512  # sample not truncated
        out.append(Finding(
            rule_id="space-over-smem", severity="error" if exact
            else "warning",
            kernel=kernel.name, shape=dict(shape), profile=profile.name,
            detail=f"every {'feasible config' if exact else 'sampled config'}"
                   f" ({n}) exceeds the {profile.smem_per_block_optin} B "
                   f"shared memory or {profile.max_threads_per_block} "
                   f"threads of one block on {profile.name} — the space is "
                   f"unusable there",
            data={"over": over, "sampled": n, "confidence": confidence}))
    elif over:
        out.append(Finding(
            rule_id="device-feasibility", severity="info",
            kernel=kernel.name, shape=dict(shape), profile=profile.name,
            detail=f"{over}/{n} sampled feasible config(s) provably exceed "
                   f"one block's shared memory or threads on "
                   f"{profile.name}; the engine answers these without "
                   f"building them (proven_pruned)",
            data={"over": over, "sampled": n, "confidence": confidence}))
    return out
