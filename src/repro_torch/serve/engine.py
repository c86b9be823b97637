"""Batched serving engine: continuous batched greedy decoding.

A deliberately compact production shape: fixed-size slot pool, each slot
holds one request; finished slots are refilled from the queue (continuous
batching).  The decode step itself is the shared ``dist.step.make_serve_step``
— the same function the multi-pod dry-run lowers.

Kernel configurations are resolved through the tunable-kernel registry at
construction and live in an atomically-swappable :class:`ConfigSlot`: when
online tuning is enabled and a resolution was *not* an exact cache hit
(provenance ``transfer``/``heuristic``), a background search is queued, and
the winner — written to the tuning cache — hot-swaps into the live engine
at the next step boundary (never mid-step).

The engine runs where its parameters live: the KV cache and each step's
tokens go to the params' device, and the device profile the registry
resolves against defaults to that device's (the card's, read at run time;
a CPU run models an H100).  The JAX package jits the step; here it runs
eagerly, memoised per derived :class:`RunConfig` all the same.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import kernels  # noqa: F401 — populates the tunable registry
from ..core.cache import (CacheEntry, OBJ_PREFIX, TuningCache, default_cache,
                          normalize_objective, split_key)
from ..core.envknobs import env_bool, env_str
from ..core.evaluators import ArrivalTraceEvaluator
from ..core.profiles import DeviceProfile, resolve_profile
from ..core.registry import (AutotunePolicy, REGISTRY, Resolution,
                             lookup_resolved)
from ..dist.step import apply_kernel_configs, make_serve_step
from ..models.config import ModelConfig
from ..models.model import RunConfig, init_cache
from ..models.params import resolve_device
from .online import (BackgroundTuner, ConfigSlot, OnlineTuneConfig,
                     submit_for_resolutions)

log = logging.getLogger("repro_torch.serve")

#: env var enabling online (background) serve-path retuning by default
_ONLINE_ENV_VAR = "REPRO_ONLINE_TUNE"

#: env var overriding the bucketed engine's shape buckets (comma-separated
#: max_len values, e.g. ``REPRO_SERVE_BUCKETS=128,512,2048``)
_BUCKETS_ENV_VAR = "REPRO_SERVE_BUCKETS"

#: default shape buckets (max decode lengths) for BucketedServeEngine
DEFAULT_BUCKETS = (128, 256, 512)


def _online_tune_from_env() -> bool:
    # strict parse (envknobs): REPRO_ONLINE_TUNE=2 / =enable raises instead
    # of silently landing on either side of the feature flag
    return env_bool(_ONLINE_ENV_VAR, False)


def buckets_from_env(default=DEFAULT_BUCKETS):
    """Shape buckets from ``REPRO_SERVE_BUCKETS`` (sorted, deduplicated).

    Strict parse, same stance as the other env knobs: a malformed or
    empty list raises instead of silently serving with default buckets.
    """
    raw = env_str(_BUCKETS_ENV_VAR, None)
    if raw is None:
        return tuple(default)
    vals = []
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            v = int(part)
        except ValueError as e:
            raise ValueError(
                f"{_BUCKETS_ENV_VAR}={raw!r}: {part!r} is not an int") from e
        if v <= 0:
            raise ValueError(
                f"{_BUCKETS_ENV_VAR}={raw!r}: bucket {v} must be positive")
        vals.append(v)
    if not vals:
        raise ValueError(f"{_BUCKETS_ENV_VAR}={raw!r}: no buckets")
    return tuple(sorted(set(vals)))


def resolve_kernel_resolutions(cfg: ModelConfig, slots: int, max_len: int, *,
                               profile: Optional[DeviceProfile] = None,
                               policy: "AutotunePolicy | str | None" = None,
                               cache: Optional[TuningCache] = None
                               ) -> Dict[str, Resolution]:
    """Kernel configurations this serving shape should run with — resolved
    through the tunable-kernel registry, *with provenance*.  Shape-keyed
    re-tuning is CLTune scenario 3: the best block sizes depend on the
    serving geometry, so the engine asks the registry instead of
    hard-coding them.

    The serve-time default policy is ``TRANSFER``: an exact cache hit wins,
    an unseen decode geometry borrows the nearest tuned shape's config
    (feasibility-checked), and only then does the static heuristic apply —
    a new serving shape never stalls the engine on a tuning search.  An
    explicit ``REPRO_AUTOTUNE`` env setting still overrides this default
    (pass ``policy=`` to pin the behaviour regardless).  The provenance on
    each :class:`~repro_torch.core.registry.Resolution` is what the online
    tuner keys on: anything non-exact is a candidate for a background
    retune.  ``profile`` defaults to the current CUDA device's.
    """
    profile = resolve_profile(profile)
    if policy is None and "REPRO_AUTOTUNE" not in os.environ:
        policy = AutotunePolicy.TRANSFER
    out: Dict[str, Resolution] = {}
    head_dim = cfg.resolved_head_dim
    if cfg.num_heads and head_dim and "flash_attention" in REGISTRY:
        out["flash_attention"] = lookup_resolved(
            "flash_attention",
            {"Sq": max_len, "Sk": max_len, "D": head_dim, "causal": True},
            profile=profile, policy=policy, cache=cache)
    if "gemm" in REGISTRY:
        # the decode hot loop is (slots, d_model) @ (d_model, vocab)
        out["gemm"] = lookup_resolved(
            "gemm", {"M": slots, "N": cfg.vocab_size, "K": cfg.d_model},
            profile=profile, policy=policy, cache=cache)
    return out


def resolve_kernel_configs(cfg: ModelConfig, slots: int, max_len: int, *,
                           profile: Optional[DeviceProfile] = None,
                           policy: "AutotunePolicy | str | None" = None,
                           cache: Optional[TuningCache] = None
                           ) -> Dict[str, Dict[str, Any]]:
    """:func:`resolve_kernel_resolutions` minus the provenance — the
    config-only map call sites predating online tuning expect."""
    return {name: res.config
            for name, res in resolve_kernel_resolutions(
                cfg, slots, max_len, profile=profile, policy=policy,
                cache=cache).items()}


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    #: filled by the engine
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Continuous-batching decode engine with optional online autotuning.

    ``online_tune`` turns the serve path into a concurrent feedback loop:

    * ``False``/``None`` (default) — off; ``None`` defers to the
      ``REPRO_ONLINE_TUNE`` env var.
    * ``True`` — background retuning with default
      :class:`~repro_torch.serve.online.OnlineTuneConfig` knobs.
    * an :class:`~repro_torch.serve.online.OnlineTuneConfig` (or kwargs dict) —
      background retuning with those knobs.
    * a :class:`~repro_torch.serve.online.BackgroundTuner` — share one tuner
      (and its worker thread) across engines; the engine will not close it.

    Every non-exact kernel resolution (nearest-shape transfer or static
    heuristic) queues a real tuning job; when the search lands a winner in
    the tuning cache, the engine hot-swaps it into ``kernel_configs`` at
    the next step boundary via a generation-counted ConfigSlot — in-flight
    steps never observe a torn update, and ``swap_events`` records the
    step at which each upgrade took effect.

    The decode step *consumes* ``kernel_configs``: the resolved (or
    hot-swapped) gemm winner's block geometry is folded into the step
    function via :func:`~repro_torch.dist.step.apply_kernel_configs`, so an
    upgrade changes the products the step issues, not just bookkeeping.
    Step functions are memoized per derived :class:`RunConfig` — a swap
    that does not change the derived execution knobs reuses the step.

    The engine serves on the device its ``params`` are on, and ``profile``
    defaults to that device's.  Parameters on a CUDA device of a host
    without one raise.
    """

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 max_len: int = 512, run: RunConfig = RunConfig(),
                 profile: Optional[DeviceProfile] = None,
                 autotune: "AutotunePolicy | str | None" = None,
                 cache: Optional[TuningCache] = None,
                 online_tune: ("bool | dict | OnlineTuneConfig | "
                               "BackgroundTuner | None") = None):
        if cfg.input_mode != "tokens":
            raise ValueError("ServeEngine drives token models")
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(params["embed"].device)
        self.slots = slots
        self.max_len = max_len
        self.profile = profile = resolve_profile(profile, self.device)
        self._cache = cache if cache is not None else default_cache()
        #: registry-resolved kernel configurations for this serving shape,
        #: with provenance (exact / transfer / tuned / heuristic)
        self.kernel_resolutions = resolve_kernel_resolutions(
            cfg, slots, max_len, profile=profile, policy=autotune,
            cache=self._cache)
        #: live config holder; read once per decode step (hot-swap target)
        self._slot = ConfigSlot({name: res.config for name, res
                                 in self.kernel_resolutions.items()})
        self._seen_generation = self._slot.generation
        #: configs the current/most recent step ran with (slot snapshot)
        self._step_configs = self._slot.read()[0]
        #: where each kernel's *current* config came from — the resolution
        #: provenance, with the predictor named for "predicted" (so a bad
        #: model is diagnosable from the event log alone); hot-swaps
        #: upgrade the entry to "tuned"
        self._sources: Dict[str, str] = {
            name: (f"predicted:{res.predictor}"
                   if res.provenance == "predicted" and res.predictor
                   else res.provenance)
            for name, res in self.kernel_resolutions.items()}
        #: [{"step", "generation", "kernels", "sources"}] — when upgrades
        #: took effect, and what produced each swapped config
        self.swap_events: List[Dict[str, Any]] = []
        self._steps_total = 0
        self._closed = False
        self.cache = init_cache(cfg, slots, max_len, self.device)
        self.run_config = run
        #: decode steps, memoized by the RunConfig the resolved kernel
        #: configs fold down to (frozen dataclass — hashable)
        self._steps: Dict[RunConfig, Any] = {}
        self._step = self._step_for(self._step_configs)
        self._slot_req: List[Optional[Request]] = [None] * slots
        self._slot_pos = np.zeros(slots, np.int32)   # next write position
        self._queue: List[Request] = []
        self._pos = 0                                 # global decode position
        self._init_online(online_tune)

    def _step_for(self, configs: Dict[str, Dict[str, Any]]):
        """The decode step for one kernel-config snapshot.

        ``apply_kernel_configs`` folds the snapshot into the engine's
        RunConfig (tuned gemm BLOCK_N -> LM-head vocab tile); distinct
        derived RunConfigs get distinct steps, identical ones share one.
        """
        derived = apply_kernel_configs(self.cfg, self.run_config, configs)
        step = self._steps.get(derived)
        if step is None:
            step = make_serve_step(self.cfg, derived, greedy=True)
            self._steps[derived] = step
        return step

    # -- online tuning ---------------------------------------------------------
    def _init_online(self, online_tune) -> None:
        self.tuner: Optional[BackgroundTuner] = None
        self.tune_jobs: Dict[str, Any] = {}
        self._owns_tuner = False
        self._watched: Dict[tuple, str] = {}
        if online_tune is None:
            online_tune = _online_tune_from_env()
        if isinstance(online_tune, bool):
            if not online_tune:
                return
            knobs = OnlineTuneConfig()
        elif isinstance(online_tune, BackgroundTuner):
            knobs = None
        elif isinstance(online_tune, OnlineTuneConfig):
            knobs = online_tune
        elif isinstance(online_tune, dict):
            knobs = OnlineTuneConfig(**online_tune)
        else:
            # the truthy-coercion lesson: 0 / "off" / "" must not
            # silently ENABLE background tuning with default knobs
            raise TypeError(
                f"online_tune must be a bool, dict, OnlineTuneConfig or "
                f"BackgroundTuner, got {type(online_tune).__name__!s}: "
                f"{online_tune!r}")
        if isinstance(online_tune, BackgroundTuner):
            self.tuner = online_tune
            if self.tuner.cache is not self._cache:
                log.warning("online: shared BackgroundTuner writes to a "
                            "different cache than this engine watches; "
                            "hot-swaps will not fire — pass the same cache")
        else:
            self.tuner = BackgroundTuner(cache=self._cache, config=knobs,
                                         profile=self.profile)
            self._owns_tuner = True
        # watch the cache for our (kernel, shape-key, profile, objective)
        # quads: the background winner lands there first, then hot-swaps in
        # here.  The objective is the tuner's — a p99-tuned winner lands
        # under an obj=-scoped key and must not be missed, while a
        # median-tuned entry for the same geometry must not hot-swap into
        # an engine retuning for p99.
        obj = normalize_objective(self.tuner.config.objective)
        for name, res in self.kernel_resolutions.items():
            self._watched[(res.kernel, res.key, res.profile, obj)] = name
        self._cache.subscribe(self._on_cache_change)
        self.tune_jobs = submit_for_resolutions(self.tuner,
                                                self.kernel_resolutions)

    def _on_cache_change(self, key: str, entry: CacheEntry) -> None:
        """Cache-writer thread: hot-swap a freshly tuned winner for one of
        our watched geometries into the live slot (step boundary applies
        it; see :meth:`run`)."""
        if self._closed:
            return
        fields = split_key(key)
        if len(fields) == 3:
            triple, obj = tuple(fields), None
        elif len(fields) == 4 and fields[3].startswith(OBJ_PREFIX):
            triple, obj = tuple(fields[:3]), fields[3][len(OBJ_PREFIX):]
        else:
            return
        name = self._watched.get(triple + (obj,))
        if name is None:
            return
        # re-read the authoritative entry rather than trusting the
        # notification payload: two concurrent writers' notifications can
        # arrive out of order, and the cache's only_if_better semantics
        # make the *current* entry the best one — a stale late
        # notification then swaps in the same (current) config, a no-op
        current = self._cache.get(*triple, objective=obj)
        if current is None:
            return
        # static-proof guard: a fleet-merged or hand-edited cache entry
        # whose *declared* footprint exceeds this device's VMEM must never
        # hot-swap into the live slot (repro_torch.analyze proves it
        # cannot run)
        res = self.kernel_resolutions.get(name)
        if res is not None:
            try:
                from ..analyze.resource import proven_violations
                from ..core.registry import resolve as _resolve_kernel
                viol = proven_violations(_resolve_kernel(res.kernel),
                                         res.shape, current.config,
                                         self.profile)
            except Exception:  # noqa: BLE001 — the guard must not break swaps
                viol = []
            if viol:
                log.warning("online: refusing hot-swap for %s — cache "
                            "entry proven infeasible on %s: %s",
                            name, self.profile.name, "; ".join(viol))
                return
        self._sources[name] = "tuned"
        gen = self._slot.swap(name, dict(current.config))
        log.info("online: hot-swap %s -> %s (generation %d)",
                 name, dict(current.config), gen)

    def close(self) -> None:
        """Detach from the cache and stop an engine-owned tuner.  Idempotent;
        serving state (queue, KV cache) is untouched."""
        if self._closed:
            return
        self._closed = True
        if self._watched:
            self._cache.unsubscribe(self._on_cache_change)
        if self.tuner is not None and self._owns_tuner:
            self.tuner.close(wait=False)

    def __enter__(self) -> "ServeEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def kernel_configs(self) -> Dict[str, Dict[str, Any]]:
        """The configs the *next* step will run with (current snapshot)."""
        return self._slot.read()[0]

    @property
    def config_generation(self) -> int:
        return self._slot.generation

    @property
    def steps_total(self) -> int:
        """Decode steps executed across every :meth:`run` call."""
        return self._steps_total

    # -- public API -----------------------------------------------------------
    def submit(self, req: Request) -> None:
        self._queue.append(req)

    def run(self, max_steps: int = 10_000,
            on_step=None) -> List[Request]:
        """Decode until all submitted requests finish.

        Each iteration reads one consistent ``kernel_configs`` snapshot
        from the ConfigSlot, so a background hot-swap only ever takes
        effect *between* steps; ``swap_events`` records the step count at
        which each new generation was first used.  ``on_step(engine, step)``
        is an optional observability hook called at every step boundary
        (after the snapshot read, before the decode step).

        Hitting ``max_steps`` does **not** silently drop work: requests
        still in flight or queued are returned too, flagged ``done=False``,
        with a truncation warning logged — and they stay in the engine, so
        a subsequent :meth:`run` resumes them.
        """
        finished: List[Request] = []
        steps = 0
        while (any(self._slot_req) or self._queue) and steps < max_steps:
            configs, gen = self._slot.read()
            if gen != self._seen_generation:
                changed = [n for n, c in configs.items()
                           if self._step_configs.get(n) != c]
                self.swap_events.append({"step": self._steps_total,
                                         "generation": gen,
                                         "kernels": changed,
                                         "sources": {
                                             n: self._sources.get(n, "?")
                                             for n in changed}})
                log.info("online: step %d now running generation %d "
                         "(changed: %s)", self._steps_total, gen, changed)
                self._seen_generation = gen
                # fold the upgraded configs into the step (memoized: a swap
                # that derives the same RunConfig reuses the step; KV cache
                # and positions carry over)
                self._step = self._step_for(configs)
            self._step_configs = configs
            if on_step is not None:
                on_step(self, self._steps_total)
            self._fill_slots()
            tokens = self._current_tokens()
            next_tok, self.cache = self._step(self.params, self.cache,
                                              tokens, self._pos)
            self._pos += 1
            steps += 1
            self._steps_total += 1
            # the step's one device -> host read
            self._absorb(next_tok.cpu().numpy(), finished)
        unfinished = ([r for r in self._slot_req if r is not None]
                      + list(self._queue))
        if unfinished:
            log.warning(
                "serve: run() hit max_steps=%d with %d unfinished "
                "request(s) (%d in flight, %d queued); returning them with "
                "done=False — call run() again to resume", max_steps,
                len(unfinished),
                sum(1 for r in self._slot_req if r is not None),
                len(self._queue))
            finished.extend(unfinished)
        return finished

    # -- internals ---------------------------------------------------------------
    def _fill_slots(self):
        for i in range(self.slots):
            if self._slot_req[i] is None and self._queue:
                req = self._queue.pop(0)
                self._slot_req[i] = req
                # feed the prompt token-by-token starting at the global pos
                req._prompt_cursor = 0        # type: ignore[attr-defined]

    def _current_tokens(self) -> torch.Tensor:
        toks = np.zeros((self.slots, 1), np.int32)
        for i, req in enumerate(self._slot_req):
            if req is None:
                continue
            cur = req._prompt_cursor          # type: ignore[attr-defined]
            if cur < len(req.prompt):
                toks[i, 0] = req.prompt[cur]
            elif req.output:
                toks[i, 0] = req.output[-1]
        return torch.from_numpy(toks).to(self.device)

    def _absorb(self, next_tok: np.ndarray, finished: List[Request]):
        for i, req in enumerate(self._slot_req):
            if req is None:
                continue
            cur = req._prompt_cursor          # type: ignore[attr-defined]
            if cur < len(req.prompt) - 1:
                req._prompt_cursor = cur + 1  # still prefilling (teacher mode)
                continue
            req._prompt_cursor = cur + 1
            tok = int(next_tok[i])
            req.output.append(tok)
            hit_eos = req.eos_id is not None and tok == req.eos_id
            if len(req.output) >= req.max_new_tokens or hit_eos:
                req.done = True
                finished.append(req)
                self._slot_req[i] = None


# ---------------------------------------------------------------------------
# shape-bucketed serving (SLO / tail-latency path)
# ---------------------------------------------------------------------------

#: deterministic occupancy fractions a bucket's modeled arrivals cycle
#: through — quarter-quantized so traced geometries stay multiples of a
#: quarter of the bucket bound (block-alignment-friendly for pow2 buckets)
_TRACE_FRACTIONS = (1.0, 0.5, 0.75, 0.25)


def modeled_arrival_trace(shape: Dict[str, Any], arrivals: int = 8,
                          min_dim: int = 64) -> List[Dict[str, Any]]:
    """Deterministic ragged-arrival trace for one tuned shape bucket.

    Real traffic rarely fills a bucket: a request padded into a
    ``max_len=512`` bucket may only occupy 150 positions.  Each modeled
    arrival scales the shape's large integer dims (>= ``min_dim``) to a
    fraction of the bucket bound, quantized to quarters so the geometries
    stay block-aligned.  The trace is pure data — the same bucket always
    models the same arrivals, which keeps p99 retunes reproducible.
    """
    if arrivals <= 0:
        raise ValueError(f"arrivals must be positive, got {arrivals}")
    dims = [k for k, v in shape.items()
            if isinstance(v, int) and not isinstance(v, bool)
            and v >= min_dim]
    trace: List[Dict[str, Any]] = []
    for i in range(arrivals):
        frac = _TRACE_FRACTIONS[i % len(_TRACE_FRACTIONS)]
        s = dict(shape)
        for d in dims:
            v = shape[d]
            quarter = max(1, v // 4)
            s[d] = max(quarter, int(round(v * frac / quarter)) * quarter)
        trace.append(s)
    return trace


def trace_evaluator_factory(arrivals: int = 8, noise_sigma: float = 0.03,
                            seed: int = 0):
    """(kernel, shape, profile) -> ArrivalTraceEvaluator factory for
    :class:`~repro_torch.serve.online.OnlineTuneConfig.evaluator_factory`.

    Prices every candidate at each modeled arrival of the bucket via the
    kernel's ``analytical_model``; a config infeasible at *any* traced
    geometry is rejected outright, so a p99 winner is feasible across the
    whole bucket, not just at its padded bound.
    """
    def factory(k, shape, profile):
        model = getattr(k, "analytical_model", None)
        if model is None:
            raise ValueError(
                f"kernel {k.name!r} declares no analytical_model; "
                f"trace-based SLO retuning needs one")
        return ArrivalTraceEvaluator(
            model, modeled_arrival_trace(dict(shape), arrivals=arrivals),
            profile=profile, noise_sigma=noise_sigma, seed=seed)
    return factory


class BucketedServeEngine:
    """Shape-bucketed serving: quantize ragged geometries into tuned
    buckets, retune each bucket for tail latency.

    A single :class:`ServeEngine` serves every request at one padded
    ``max_len`` — a 40-token request pays the decode cost of the full
    geometry, and its tuned configs are whatever won at that one shape.
    This engine instead keeps one ServeEngine per *bucket* (ascending
    ``max_len`` bounds): admission assigns each request to the smallest
    bucket it fits (prompt + max_new_tokens), so short requests decode
    against short KV caches, and each bucket's kernel configs are resolved
    — and background-retuned — for *its* geometry.

    All buckets share one tuning cache and one
    :class:`~repro_torch.serve.online.BackgroundTuner` whose objective defaults
    to ``p99_time`` over a deterministic modeled arrival trace
    (:func:`modeled_arrival_trace`): the winner recorded for a bucket
    must be fast at the tail of the arrivals it actually absorbs, not
    just at its padded bound.  Winners land under objective-scoped cache
    keys and hot-swap into exactly the bucket that watches them —
    per-bucket isolation is the cache-key structure, not bookkeeping.

    ``REPRO_SERVE_BUCKETS`` (comma-separated max_lens) overrides the
    default buckets when ``buckets`` is not passed.
    """

    def __init__(self, cfg: ModelConfig, params, *,
                 buckets=None, slots: int = 4, run: RunConfig = RunConfig(),
                 profile: Optional[DeviceProfile] = None,
                 autotune: "AutotunePolicy | str | None" = None,
                 cache: Optional[TuningCache] = None,
                 online_tune: ("bool | dict | OnlineTuneConfig | "
                               "BackgroundTuner | None") = None,
                 objective: Optional[str] = "p99_time",
                 trace_arrivals: int = 8):
        if buckets is None:
            buckets = buckets_from_env()
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        if not self.buckets or self.buckets[0] <= 0:
            raise ValueError(f"buckets must be positive ints, got {buckets!r}")
        self.cfg = cfg
        self.profile = profile = resolve_profile(
            profile, resolve_device(params["embed"].device))
        self.objective = normalize_objective(objective)
        self._cache = cache if cache is not None else default_cache()
        self._owns_tuner = False
        self.tuner = self._make_tuner(online_tune, objective, trace_arrivals)
        #: bucket max_len -> the ServeEngine serving that geometry
        self.engines: Dict[int, ServeEngine] = {}
        for b in self.buckets:
            self.engines[b] = ServeEngine(
                cfg, params, slots=slots, max_len=b, run=run,
                profile=profile, autotune=autotune, cache=self._cache,
                online_tune=self.tuner if self.tuner is not None else False)
        #: requests refused at admission (no bucket fits), by rid
        self.rejected: List[Request] = []
        self._closed = False

    def _make_tuner(self, online_tune, objective, trace_arrivals
                    ) -> Optional[BackgroundTuner]:
        """One BackgroundTuner shared by every bucket (or None = offline).

        Bool/None/dict/OnlineTuneConfig follow ServeEngine's coercion
        rules; when the knobs don't pin an evaluator_factory or objective
        the SLO defaults apply — trace evaluation under this engine's
        objective.
        """
        if isinstance(online_tune, BackgroundTuner):
            return online_tune
        if online_tune is None:
            online_tune = _online_tune_from_env()
        if isinstance(online_tune, bool):
            if not online_tune:
                return None
            knobs = OnlineTuneConfig()
        elif isinstance(online_tune, OnlineTuneConfig):
            knobs = online_tune
        elif isinstance(online_tune, dict):
            knobs = OnlineTuneConfig(**online_tune)
        else:
            raise TypeError(
                f"online_tune must be a bool, dict, OnlineTuneConfig or "
                f"BackgroundTuner, got {type(online_tune).__name__!s}: "
                f"{online_tune!r}")
        if knobs.objective is None and objective is not None:
            knobs = dataclasses.replace(knobs, objective=objective)
        if knobs.evaluator_factory is None:
            knobs = dataclasses.replace(
                knobs, evaluator_factory=trace_evaluator_factory(
                    arrivals=trace_arrivals, seed=knobs.seed))
        self._owns_tuner = True
        return BackgroundTuner(cache=self._cache, config=knobs,
                               profile=self.profile)

    # -- admission -------------------------------------------------------------
    def bucket_for(self, req: Request) -> Optional[int]:
        """Smallest bucket the request fits, or None (admission refusal)."""
        needed = len(req.prompt) + req.max_new_tokens
        for b in self.buckets:
            if needed <= b:
                return b
        return None

    def submit(self, req: Request) -> Optional[int]:
        """Admit a request into its bucket; returns the bucket max_len, or
        None when no bucket fits (the request lands in ``rejected`` —
        admission control instead of silently truncated output)."""
        b = self.bucket_for(req)
        if b is None:
            log.warning("serve: rejecting request %d (needs %d positions, "
                        "largest bucket is %d)", req.rid,
                        len(req.prompt) + req.max_new_tokens,
                        self.buckets[-1])
            self.rejected.append(req)
            return None
        self.engines[b].submit(req)
        return b

    # -- serving ---------------------------------------------------------------
    def run(self, max_steps: int = 10_000, on_step=None) -> List[Request]:
        """Drain every bucket (smallest first); returns finished requests."""
        finished: List[Request] = []
        for b in self.buckets:
            eng = self.engines[b]
            if any(eng._slot_req) or eng._queue:
                finished.extend(eng.run(max_steps=max_steps, on_step=on_step))
        return finished

    @property
    def swap_events(self) -> Dict[int, List[Dict[str, Any]]]:
        """Per-bucket hot-swap history (bucket max_len -> events)."""
        return {b: list(self.engines[b].swap_events) for b in self.buckets}

    @property
    def steps_total(self) -> int:
        return sum(e.steps_total for e in self.engines.values())

    def close(self) -> None:
        """Close every bucket engine and an engine-owned tuner.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        for eng in self.engines.values():
            eng.close()
        if self.tuner is not None and self._owns_tuner:
            self.tuner.close(wait=False)

    def __enter__(self) -> "BucketedServeEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
