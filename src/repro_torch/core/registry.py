"""Declarative tunable-kernel registry — one declaration API for any kernel.

CLTune's promise is a *generic* tuner: any kernel, any parameter space,
re-tuned per input shape (paper scenarios 1 and 3).  The registry is the
generic half of that promise on the framework side: a kernel package
declares *what* is tunable once, via :func:`tunable`, and every consumer —
the one-shot ``repro_torch.tune.api.tune_kernel``, the batch ``TuningSession``,
the serving engine, the public ops — resolves configurations through
:func:`lookup` instead of hand-rolling per-kernel ``shape_key`` /
``heuristic_config`` / ``lookup_config`` / ``make_tuner`` boilerplate.

A *shape* here is a plain dict of the kernel's problem dimensions
(``{"M": 2048, "N": 2048, "K": 2048}``); every declared callback takes it
as its first argument, so one :class:`TunableKernel` covers the whole shape
family and the cache keys instances by ``shape_key(shape)``.

Declaration (the whole public surface a new workload needs):

    @tunable(name="gemm",
             space=gemm_space,            # shape -> SearchSpace
             heuristic=gemm_heuristic,    # shape -> Config fallback
             analytical_model=gemm_time,  # (shape, config, profile) -> s
             smem_footprint=gemm_smem,    # (shape, config) -> bytes
             reference=gemm_oracle)       # shape -> callable oracle
    def gemm(shape, config):
        return make_matmul(shape["M"], shape["N"], shape["K"], config)

Call-site resolution, with the tune-on-miss policy of dynamic autotuners
(Kernel Tuning Toolkit, arXiv:1910.08498):

    cfg = lookup("gemm", {"M": M, "N": N, "K": K},
                 policy=AutotunePolicy.ON_MISS)

A config is resolved for a :class:`DeviceProfile`; where none is given
it is the profile of the current CUDA device (:func:`device_profile`).
"""

from __future__ import annotations

import dataclasses
import enum
import logging
from typing import (Any, Callable, Dict, Iterator, List, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np

from .cache import CacheEntry, TuningCache, default_cache
from .envknobs import env_str
from .failures import EvaluationError
from .profiles import DeviceProfile, resolve_profile
from .space import Config, SearchSpace
from .strategies import accepts_kwarg, project_feasible, usable_seeds

log = logging.getLogger("repro_torch.registry")

Shape = Mapping[str, Any]


class AutotunePolicy(enum.Enum):
    """What :func:`lookup` does when the cache has no entry for a shape.

    * ``OFF``      — cache hit or the declared heuristic; never tunes.
    * ``TRANSFER`` — cache hit, else the nearest tuned shape's config
                     (feasibility-checked against the new shape's space),
                     else the heuristic; never runs a search.  The serving
                     mode: an unseen decode shape must not stall on tuning.
    * ``ON_MISS``  — cache hit, else run a (budgeted) search once, record it,
                     and return the winner; the KTT-style dynamic mode.
    * ``ALWAYS``   — re-tune on every call (benchmarking / device bring-up).
    """

    OFF = "off"
    TRANSFER = "transfer"
    ON_MISS = "on_miss"
    ALWAYS = "always"

    @classmethod
    def coerce(cls, value: "AutotunePolicy | str | None") -> "AutotunePolicy":
        if value is None:
            return default_policy()
        if isinstance(value, cls):
            return value
        try:
            return cls(str(value).lower())
        except ValueError as e:
            raise ValueError(
                f"unknown autotune policy {value!r}; "
                f"known: {[p.value for p in cls]}") from e


def default_policy() -> AutotunePolicy:
    """Process-wide default policy, overridable via ``REPRO_AUTOTUNE``."""
    return AutotunePolicy.coerce(env_str("REPRO_AUTOTUNE", "off"))


def _escape_dim(field: str) -> str:
    """Escape the default shape key's separators inside a name or value.

    The old ``f"{name}{value}"`` form was ambiguous (``{"X": 12}`` and
    ``{"X1": 2}`` both produced ``X12``); ``name=value`` joined with ``_``
    is unambiguous once ``=``/``_`` occurring *inside* a field are escaped.
    """
    return (field.replace("\\", "\\\\").replace("=", "\\=")
            .replace("_", "\\_"))


_accepts = accepts_kwarg


@dataclasses.dataclass(frozen=True)
class TunableKernel:
    """One kernel family's complete tuning declaration.

    Required: ``name``, ``build(shape, config)`` (callable factory),
    ``space(shape) -> SearchSpace`` and
    ``heuristic(shape) -> Config``.  Everything else feeds specific
    evaluators or the verification path and is optional — exactly like the
    optional arguments of CLTune's ``AddKernel``.
    """

    name: str
    build: Callable[..., Callable]
    space: Callable[..., SearchSpace]
    heuristic: Callable[[Shape], Config]
    #: cache key for a shape; default joins sorted ``dim=value`` pairs
    shape_key: Optional[Callable[[Shape], str]] = None
    #: concrete host arguments for wall-clock runs + verification
    make_args: Optional[Callable[[Shape, np.random.Generator], Tuple]] = None
    #: structural time model: (shape, config, profile) -> seconds
    analytical_model: Optional[
        Callable[[Shape, Config, DeviceProfile], float]] = None
    #: shared memory one block claims: (shape, config) -> bytes, for the
    #: device auto-constraint
    smem_footprint: Optional[Callable[[Shape, Config], int]] = None
    #: threads one block has: (shape, config) -> int, for the device
    #: limit of 1024 (:mod:`repro_torch.analyze` proves configs over it)
    block_threads: Optional[Callable[[Shape, Config], int]] = None
    #: registers one thread needs, roughly: (shape, config) -> int.  ptxas
    #: decides the real count, so the analyzer only advises from it
    register_estimate: Optional[Callable[[Shape, Config], int]] = None
    #: declared cost: (shape, config) -> :class:`~repro_torch.core.cost.
    #: KernelCost`, the FLOPs and bytes the cost-model evaluator prices
    cost: Optional[Callable[[Shape, Config], Any]] = None
    #: device source files the build compiles (``.cu``); their bytes key
    #: the cost model's stored prices, so an edited kernel is priced anew
    sources: Tuple[str, ...] = ()
    #: shape -> oracle callable, for SetReference-style verification
    reference: Optional[Callable[[Shape], Callable]] = None
    #: shapes a TuningSession sweeps when none are given explicitly
    default_shapes: Tuple[Dict[str, Any], ...] = ()
    #: per-kernel tuning defaults consumed by tune_kernel (strategy, budget)
    defaults: Dict[str, Any] = dataclasses.field(default_factory=dict)
    tags: Tuple[str, ...] = ()

    def __post_init__(self):
        if not self.name:
            raise ValueError("TunableKernel needs a non-empty name")

    # -- resolution helpers ----------------------------------------------------
    def key_for(self, shape: Shape) -> str:
        if self.shape_key is not None:
            return self.shape_key(shape)
        return "_".join(f"{_escape_dim(k)}={_escape_dim(str(shape[k]))}"
                        for k in sorted(shape))

    def legacy_key_for(self, shape: Shape) -> Optional[str]:
        """The pre-v2 default shape key (ambiguous ``f"{name}{value}"``
        join), so :func:`lookup` can find — and re-key — entries recorded
        before the escaped ``name=value`` form.  None for kernels with a
        declared ``shape_key`` (their key format never changed)."""
        if self.shape_key is not None:
            return None
        return "_".join(f"{k}{shape[k]}" for k in sorted(shape))

    def supports_extended(self) -> bool:
        """True when the space factory takes an ``extended=`` kwarg."""
        return _accepts(self.space, "extended")

    def make_space(self, shape: Shape, extended: bool = False) -> SearchSpace:
        if _accepts(self.space, "extended"):
            sp = self.space(shape, extended=extended)
        else:
            sp = self.space(shape)
        if not isinstance(sp, SearchSpace):
            raise TypeError(f"{self.name}: space() must return a SearchSpace, "
                            f"got {type(sp).__name__}")
        return sp

    def __call__(self, shape: Shape, config: Config, **kwargs) -> Callable:
        return self.build(shape, config, **kwargs)

    def __repr__(self) -> str:
        opt = [f for f in ("make_args", "analytical_model",
                           "smem_footprint", "block_threads",
                           "register_estimate", "cost", "reference")
               if getattr(self, f) is not None]
        return f"TunableKernel({self.name!r}, with={opt})"


class KernelRegistry:
    """Name -> :class:`TunableKernel` map the runtime consults."""

    def __init__(self):
        self._kernels: Dict[str, TunableKernel] = {}

    def register(self, kernel: TunableKernel,
                 replace: bool = False) -> TunableKernel:
        if not isinstance(kernel, TunableKernel):
            raise TypeError(f"expected TunableKernel, got {type(kernel).__name__}")
        if kernel.name in self._kernels and not replace:
            raise ValueError(f"kernel {kernel.name!r} is already registered; "
                             "pass replace=True to override")
        self._kernels[kernel.name] = kernel
        return kernel

    def unregister(self, name: str) -> bool:
        return self._kernels.pop(name, None) is not None

    def get(self, name: str) -> TunableKernel:
        try:
            return self._kernels[name]
        except KeyError as e:
            raise KeyError(f"no tunable kernel {name!r} registered; "
                           f"known: {self.names()}") from e

    def names(self) -> Tuple[str, ...]:
        return tuple(sorted(self._kernels))

    def __contains__(self, name: object) -> bool:
        return name in self._kernels

    def __iter__(self) -> Iterator[TunableKernel]:
        return iter(self._kernels[n] for n in self.names())

    def __len__(self) -> int:
        return len(self._kernels)

    def __repr__(self) -> str:
        return f"KernelRegistry({list(self.names())})"


#: The process-wide registry the `@tunable` decorator populates.
REGISTRY = KernelRegistry()


def _ensure_builtins() -> None:
    """Import the packages whose module-level `@tunable` declarations
    populate the global registry, so by-name resolution works without the
    caller knowing which module declares a kernel."""
    import importlib
    for module in ("repro_torch.kernels",):
        try:
            importlib.import_module(module)
        except Exception as e:  # noqa: BLE001 — optional deps may be absent
            log.warning("builtin tunables: could not import %s (%s: %s)",
                        module, type(e).__name__, e)


def resolve(kernel: "TunableKernel | str",
            registry: Optional[KernelRegistry] = None) -> TunableKernel:
    """Accept either a kernel object or a registered name."""
    if isinstance(kernel, TunableKernel):
        return kernel
    # NB: "registry or REGISTRY" would treat an empty registry as absent
    reg = REGISTRY if registry is None else registry
    if reg is REGISTRY and kernel not in reg:
        _ensure_builtins()
    return reg.get(str(kernel))


def tunable(name: str, *, space: Callable[..., SearchSpace],
            heuristic: Callable[[Shape], Config],
            shape_key: Optional[Callable[[Shape], str]] = None,
            make_args: Optional[Callable] = None,
            analytical_model: Optional[Callable] = None,
            smem_footprint: Optional[Callable] = None,
            block_threads: Optional[Callable] = None,
            register_estimate: Optional[Callable] = None,
            cost: Optional[Callable] = None,
            sources: Sequence[str] = (),
            reference: Optional[Callable] = None,
            default_shapes: Sequence[Mapping[str, Any]] = (),
            defaults: Optional[Dict[str, Any]] = None,
            tags: Sequence[str] = (),
            register: bool = True,
            registry: Optional[KernelRegistry] = None
            ) -> Callable[[Callable], TunableKernel]:
    """Decorator: turn a ``build(shape, config)`` function into a registered
    :class:`TunableKernel`.  The decorated name becomes the kernel object
    (callable with the same signature), so a module-level declaration is the
    entire integration surface for a new workload.
    """

    def deco(build: Callable) -> TunableKernel:
        kernel = TunableKernel(
            name=name, build=build, space=space, heuristic=heuristic,
            shape_key=shape_key, make_args=make_args,
            analytical_model=analytical_model, smem_footprint=smem_footprint,
            block_threads=block_threads, register_estimate=register_estimate,
            cost=cost, sources=tuple(sources), reference=reference,
            default_shapes=tuple(dict(s) for s in default_shapes),
            defaults=dict(defaults or {}), tags=tuple(tags))
        if register:
            (REGISTRY if registry is None else registry).register(kernel)
        return kernel

    return deco


def _migrate_legacy_entry(k: TunableKernel, shape: Shape, key: str,
                          profile: DeviceProfile,
                          cache: TuningCache) -> Optional[CacheEntry]:
    """Find an entry recorded under the pre-v2 *default* shape-key format
    (the ambiguous ``f"{name}{value}"`` join) and re-key it in place, so
    tuned configs from older cache files keep resolving after the key-
    format fix.  Kernels with a declared ``shape_key`` are unaffected."""
    legacy = k.legacy_key_for(shape)
    if legacy is None or legacy == key:
        return None
    entry = cache.get(k.name, legacy, profile.name)
    if entry is None:
        return None
    log.info("cache: migrating legacy shape key %r -> %r for kernel %s",
             legacy, key, k.name)
    cache.put(k.name, key, profile.name, entry, only_if_better=False)
    return entry


def _validated_heuristic(k: TunableKernel, shape: Shape) -> Config:
    """The declared heuristic, feasibility-checked against its own space.

    A heuristic that violates the space's constraints is a declaration bug
    (it would never survive a search) — the violation is *logged*, then
    the config is projected to the nearest feasible space point (same
    repair :func:`~repro_torch.core.strategies.project_feasible` applies to
    transferred seeds), so an out-of-space config is never served.  Only
    when no feasible point exists (or the space itself is broken) does
    the raw declared config come back — the heuristic is the universal
    never-crash fallback.
    """
    cfg = dict(k.heuristic(shape))
    try:
        space = k.make_space(shape)
    except Exception as e:  # noqa: BLE001 — validation is advisory
        log.debug("heuristic validation skipped for %s (%s: %s)",
                  k.name, type(e).__name__, e)
        return cfg
    try:
        feasible = space.is_feasible(cfg)
        violated = None if feasible else space.violated(cfg)
    except KeyError as e:
        # a constraint references a parameter the heuristic never set —
        # that *is* a violation (missing value), not a validation error
        feasible, violated = False, [f"missing parameter {e}"]
    except Exception as e:  # noqa: BLE001 — validation is advisory
        log.debug("heuristic validation skipped for %s (%s: %s)",
                  k.name, type(e).__name__, e)
        return cfg
    if not feasible:
        log.warning("heuristic config for %s shape=%s violates its own "
                    "space constraints %s: %s", k.name, dict(shape),
                    violated, cfg)
        try:
            projected = project_feasible(space, cfg)
        except Exception:  # noqa: BLE001 — repair is best-effort
            projected = None
        if projected is not None:
            log.warning("heuristic config for %s projected to nearest "
                        "feasible point: %s", k.name, projected)
            return projected
    return cfg


def _proven_violations(k: TunableKernel, shape: Shape, config: Config,
                       profile: DeviceProfile) -> List[str]:
    """Static resource proofs against serving ``config`` on ``profile``.

    The transfer/predicted steps of the fallback chain borrow configs
    tuned elsewhere; a config tuned on a card with more shared memory
    must not be served onto one with less when its *declared* footprint
    proves it cannot fit.  Late import mirrors the ``tune.api`` pattern —
    ``repro_torch.analyze`` sits above the core.  Empty list = no proof.
    """
    try:
        from ..analyze.resource import proven_violations
        return proven_violations(k, shape, config, profile)
    except Exception:  # noqa: BLE001 — a proof layer must never break lookup
        return []


def transfer_config(k: TunableKernel, shape: Shape, *,
                    profile: Optional[DeviceProfile] = None,
                    cache: Optional[TuningCache] = None,
                    k_nearest: int = 3
                    ) -> Optional[Tuple[Config, CacheEntry]]:
    """Nearest tuned shape's config, feasibility-checked for ``shape``.

    Walks the ``k_nearest`` closest cached entries (log-space shape
    distance) and returns the first whose config is feasible in the *new*
    shape's search space, plus the source entry — block sizes tuned for
    ``M=1024`` may not divide ``M=1536``, so an unchecked transfer could
    hand the call site a config the kernel cannot build.  None = nothing
    transferable.
    """
    profile = resolve_profile(profile)
    cache = cache if cache is not None else default_cache()
    candidates = cache.nearest(k.name, dict(shape), profile.name, k=k_nearest)
    if not candidates:
        return None
    space = k.make_space(dict(shape))
    for entry in candidates:
        # same sanitation as warm-start seeding: project onto this space's
        # parameters, require in-list values and constraint feasibility —
        # a config tuned on an extended/older space layout must not leak
        # out-of-space values to a call site that will build with them
        usable = usable_seeds(space, [entry.config])
        if usable:
            proven = _proven_violations(k, shape, usable[0], profile)
            if proven:
                log.info("transfer: rejecting config tuned for %s (proven "
                         "infeasible on %s: %s): %s", entry.shape,
                         profile.name, "; ".join(proven),
                         dict(entry.config))
                continue
            return usable[0], entry
        log.info("transfer: rejecting config tuned for %s (infeasible for "
                 "%s): %s", entry.shape, dict(shape), dict(entry.config))
    return None


def _predicted_config(k: TunableKernel, shape: Shape, *,
                      profile: DeviceProfile,
                      cache: Optional[TuningCache],
                      predictor: Any
                      ) -> Optional[Tuple[Config, str]]:
    """PREDICTED step of the fallback chain: ask the configured predictor
    for a config, sanitized exactly like a transferred seed.

    Never raises — a broken model must degrade to the heuristic, not take
    the call site down.  Returns ``(config, predictor_name)`` or None.
    """
    from .predict import resolve_predictor   # late: keeps default path lean
    try:
        # suggestion + feasibility check run in the kernel's declared
        # default space — the one registry-served configs execute in
        extended = bool(k.defaults.get("extended_space", False))
        pred = resolve_predictor(predictor, k, profile=profile, cache=cache,
                                 extended=extended)
        if pred is None:
            return None
        suggested = pred.suggest(dict(shape), profile, k=1)
        if not suggested:
            return None
        space = k.make_space(dict(shape), extended=extended)
        usable = usable_seeds(space, suggested)
        if not usable:
            log.info("predicted config for %s rejected (infeasible): %s",
                     k.name, suggested[0])
            return None
        proven = _proven_violations(k, shape, usable[0], profile)
        if proven:
            log.info("predicted config for %s rejected (proven infeasible "
                     "on %s: %s): %s", k.name, profile.name,
                     "; ".join(proven), usable[0])
            return None
        return usable[0], getattr(pred, "name", type(pred).__name__)
    except Exception as e:  # noqa: BLE001 — prediction is advisory
        log.warning("predictor failed for %s shape=%s (%s: %s); falling "
                    "through", k.name, dict(shape), type(e).__name__, e)
        return None


@dataclasses.dataclass(frozen=True)
class Resolution:
    """A resolved configuration plus *where it came from*.

    ``provenance`` is one of:

    * ``"exact"``     — tuned-cache hit for this very shape (incl. entries
                        migrated from the legacy key format);
    * ``"transfer"``  — borrowed from the nearest tuned shape
                        (``source_shape`` says which);
    * ``"predicted"`` — suggested by a :mod:`repro_torch.core.predict`
                        predictor (``predictor`` names which one);
    * ``"tuned"``     — a search ran right now (ON_MISS/ALWAYS) and won;
    * ``"heuristic"`` — the declared static fallback.

    Anything that is *not* ``exact`` means the registry believes a strictly
    better config may exist for this shape — the online-tuning subsystem
    (:mod:`repro_torch.serve.online`) keys its background-retune decision on
    exactly that.
    """

    config: Config
    provenance: str
    kernel: str
    shape: Dict[str, Any]
    key: str
    profile: str
    #: the shape the config was actually tuned for, when transferred
    source_shape: Optional[Dict[str, Any]] = None
    #: name of the predictor that produced the config (``"predicted"``
    #: provenance only) — so a bad model is diagnosable from logs alone
    predictor: Optional[str] = None

    @property
    def exact(self) -> bool:
        return self.provenance == "exact"


def lookup_resolved(kernel: "TunableKernel | str", shape: Shape, *,
                    profile: Optional[DeviceProfile] = None,
                    cache: Optional[TuningCache] = None,
                    policy: "AutotunePolicy | str | None" = None,
                    registry: Optional[KernelRegistry] = None,
                    transfer: "bool | int | None" = None,
                    predictor: Any = None,
                    **tune_kwargs) -> Resolution:
    """:func:`lookup`, returning the config *with provenance*.

    Resolution order: tuned-cache hit -> (policy permitting) nearest-shape
    config transfer -> (TRANSFER policy) predictor suggestion -> (policy
    permitting) one-shot tune recorded back into the cache -> the kernel's
    declared heuristic.  This is the single code path behind every public
    op's ``config=None`` default.  ``profile`` defaults to the current CUDA
    device's.

    ``predictor`` is anything
    :func:`repro_torch.core.predict.resolve_predictor` accepts (None = the
    ``REPRO_PREDICTOR`` env default, a kind string, or an instance); with
    the default off, resolution is byte-identical to the predictor-less
    chain.

    ``transfer`` sizes the nearest-neighbour pool consulted by the
    ``TRANSFER`` policy and by ``ON_MISS``/``ALWAYS`` warm starting
    (int = k nearest; True = default 3; False = disable transfer/warm
    start entirely).  ``tune_kwargs`` (strategy/budget/evaluator/seed/...)
    flow to ``repro_torch.tune.api.tune_kernel`` when a search actually runs.
    """
    k = resolve(kernel, registry)
    profile = resolve_profile(profile)
    cache = cache if cache is not None else default_cache()
    pol = AutotunePolicy.coerce(policy)
    shape = dict(shape)
    key = k.key_for(shape)

    def _res(config: Config, provenance: str,
             source_shape: Optional[Dict[str, Any]] = None,
             predictor_name: Optional[str] = None) -> Resolution:
        return Resolution(config=config, provenance=provenance,
                          kernel=k.name, shape=dict(shape), key=key,
                          profile=profile.name, source_shape=source_shape,
                          predictor=predictor_name)

    # NB: `is` checks — `transfer=1` means k=1, but `1 in (None, True)`
    # would be True under ==
    k_nearest = 3 if (transfer is None or transfer is True) else int(transfer)

    if pol is not AutotunePolicy.ALWAYS:
        entry = cache.get(k.name, key, profile.name)
        if entry is None:
            entry = _migrate_legacy_entry(k, shape, key, profile, cache)
        if entry is not None:
            return _res(dict(entry.config), "exact")
        if pol is AutotunePolicy.OFF:
            return _res(_validated_heuristic(k, shape), "heuristic")
        if pol is AutotunePolicy.TRANSFER:
            moved = (transfer_config(k, shape, profile=profile, cache=cache,
                                     k_nearest=k_nearest)
                     if k_nearest > 0 else None)
            if moved is not None:
                cfg, src = moved
                log.info("transfer: %s %s <- config tuned for %s",
                         k.name, key, src.shape)
                return _res(cfg, "transfer",
                            dict(src.shape) if src.shape else None)
            predicted = _predicted_config(k, shape, profile=profile,
                                          cache=cache, predictor=predictor)
            if predicted is not None:
                cfg, pname = predicted
                log.info("predicted: %s %s <- %s", k.name, key, pname)
                return _res(cfg, "predicted", predictor_name=pname)
            return _res(_validated_heuristic(k, shape), "heuristic")

    # tune-on-miss / always: run the generic one-shot search, warm-started
    # from the nearest tuned shapes.  A shape the declared space cannot
    # cover (e.g. an empty feasible set for tiny decode batches) must not
    # crash the call site — the heuristic is the universal fallback.  But
    # only *search* failures are swallowed: a programming error in the
    # kernel's declaration (TypeError in its space fn, ...) re-raises.
    from ..tune.api import tune_kernel   # late: tune layers above core
    log.info("autotune (%s): kernel=%s shape=%s", pol.value, k.name, key)
    tune_kwargs.setdefault("record", True)
    tune_kwargs.setdefault("warm_start", k_nearest)
    try:
        outcome = tune_kernel(k, shape, profile=profile, cache=cache,
                              **tune_kwargs)
    except (EvaluationError, ValueError) as e:
        log.warning("autotune failed for %s %s (%s); using heuristic",
                    k.name, key, e)
        return _res(_validated_heuristic(k, shape), "heuristic")
    if outcome.best_config is not None:
        return _res(dict(outcome.best_config), "tuned")
    return _res(_validated_heuristic(k, shape), "heuristic")


def lookup(kernel: "TunableKernel | str", shape: Shape, *,
           profile: Optional[DeviceProfile] = None,
           cache: Optional[TuningCache] = None,
           policy: "AutotunePolicy | str | None" = None,
           registry: Optional[KernelRegistry] = None,
           transfer: "bool | int | None" = None,
           **tune_kwargs) -> Config:
    """Resolve the configuration to run ``kernel`` with for ``shape``.

    Thin wrapper over :func:`lookup_resolved` that drops the provenance —
    call sites that only need a config keep their one-liner."""
    return lookup_resolved(kernel, shape, profile=profile, cache=cache,
                           policy=policy, registry=registry,
                           transfer=transfer, **tune_kwargs).config
