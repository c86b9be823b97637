"""Measurement backends for the tuner.

CLTune measures one thing: wall-clock kernel time on the attached OpenCL
device.  Here that device is a CUDA GPU, and the measurement stays
pluggable so that the search machinery can also run against a structural
model of the device where no card is attached (the CPU tests).

Four evaluators, one interface:

* :class:`WallClockEvaluator` — CUDA-event median timing of the built
  kernel on the card, verified against the kernel's oracle; the faithful
  CLTune measurement.  ``device="cpu"`` times the kernels' plain PyTorch
  versions on the host, for tests at small shapes.
* :class:`CostModelEvaluator` — the kernel's declared FLOPs and bytes
  (:mod:`repro_torch.core.cost`) priced as a roofline time against a
  :class:`~repro_torch.core.profiles.DeviceProfile`, with no build.
* :class:`AnalyticalEvaluator` — a structural model of the kernel on a
  :class:`~repro_torch.core.profiles.DeviceProfile` (supplied by the
  kernel's ``analytical_model``), with seeded multiplicative noise so the
  paper's stochastic-search experiments see realistic measurement jitter
  without a device.
* :class:`ArrivalTraceEvaluator` — a kernel model priced over a modeled
  trace of arrival shapes, one sample per arrival, for tail objectives.
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
import math
import os
import time
import types
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import verify
from .cost import KernelCost, declared_cost
from .artifacts import (PROVENANCE_NONE, ArtifactStore, CompiledArtifact,
                        spec_fingerprint)
from .cache import FileLock
from .paths import LOCK_DIR
from .failures import (CompileError, EvaluationError, InfeasibleConfigError,
                       MeasureError, VerificationFailure)
from .metrics import Metrics
from .profiles import DeviceProfile, resolve_profile
from .space import Config


@dataclasses.dataclass
class KernelSpec:
    """Everything the evaluators may need about one tunable kernel.

    ``build(config)`` returns a callable implementing the kernel for that
    parameter configuration (the analogue of CLTune recompiling the OpenCL
    source with new ``#define``\\ s).  When the callable has a
    ``compile()`` method, the wall-clock evaluator calls it on a CUDA
    device before the first launch; it does the host-side build (``nvcc``
    and loading the library) and returns the build's content address.
    The remaining fields feed the different evaluators and the
    verification path; only the ones the chosen evaluator needs must be
    provided.
    """

    name: str
    build: Callable[[Config], Callable]
    #: host arguments (tensors on the CPU) for wall-clock runs + verification;
    #: the evaluator moves them to its device
    make_args: Optional[Callable[[np.random.Generator], Tuple]] = None
    #: structural time model: (config, profile) -> seconds (math.inf = infeasible)
    analytical_model: Optional[Callable[[Config, DeviceProfile], float]] = None
    #: declared cost: config -> :class:`~repro_torch.core.cost.KernelCost`
    #: (FLOPs and bytes), priced by the cost-model evaluator
    cost: Optional[Callable[[Config], KernelCost]] = None
    #: reference oracle taking the same args, for SetReference verification
    reference: Optional[Callable] = None
    #: static metadata (shape key etc.) used by the results cache
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: functions and device source files (paths) that ``cost`` and
    #: ``build`` are made of; with ``cost`` itself they key the cost
    #: model's stored prices (:func:`source_digest`)
    sources: Tuple[Any, ...] = ()


#: this package's top-level name: source_digest follows its functions
_TOP = __name__.split(".")[0]


def source_digest(*objs: Any) -> str:
    """sha256 of what a kernel's cost and build are made of.

    A string is a path: its file's bytes.  A function contributes its
    source (``inspect.getsource``; where there is none, its qualified name
    and ``__code__.co_code``), then, depth first, every function it
    reaches through its closure or by a global name in its code (nested
    lambdas included), within this package and the function's own module.
    So an edit to ``traffic()`` moves the digest of a declaration whose
    ``cost`` lambda only calls it.  Anything else contributes its repr.
    """
    h = hashlib.sha256()
    seen: set = set()

    def visit(obj: Any, home: str) -> None:
        if isinstance(obj, str):
            h.update(b"file\0" + obj.encode() + b"\0")
            try:
                with open(obj, "rb") as f:
                    h.update(f.read())
            except OSError:
                h.update(b"missing")
            return
        if not isinstance(obj, types.FunctionType):
            h.update(repr(obj).encode())
            return
        if obj in seen:
            return
        seen.add(obj)
        try:
            h.update(inspect.getsource(obj).encode())
        except (OSError, TypeError):
            h.update(obj.__qualname__.encode() + obj.__code__.co_code)
        reached = [c.cell_contents for c in (obj.__closure__ or ())
                   if _cell_set(c)]
        codes = [obj.__code__]
        while codes:
            code = codes.pop(0)
            reached += [obj.__globals__[n] for n in code.co_names
                        if n in obj.__globals__]
            codes += [c for c in code.co_consts
                      if isinstance(c, types.CodeType)]
        for fn in reached:
            if isinstance(fn, types.FunctionType) and (
                    fn.__module__ == home
                    or (fn.__module__ or "").startswith(_TOP + ".")):
                visit(fn, home)

    for obj in objs:
        visit(obj, getattr(obj, "__module__", "") or "")
    return h.hexdigest()[:24]


def _cell_set(cell: Any) -> bool:
    try:
        cell.cell_contents
    except ValueError:          # an empty cell
        return False
    return True


@dataclasses.dataclass
class Measurement:
    """Outcome of evaluating one configuration."""

    time_s: float                       # objective; inf = failed
    ok: bool
    verified: Optional[bool] = None     # None = verification not performed
    compile_s: float = 0.0              # build cost (also real: the paper
                                        # notes recompilation limits tuning
                                        # throughput)
    error: str = ""
    detail: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: full per-repeat sample vector + derived stats; None on failure or
    #: from legacy backends that only produced a scalar
    metrics: Optional[Metrics] = None

    @property
    def pruned(self) -> bool:
        """True when the measurement was aborted by early-stop pruning."""
        return bool(self.detail.get("pruned", False))

    def as_metrics(self) -> Optional[Metrics]:
        """The structured metrics behind this measurement.  Falls back to a
        single-sample vector built from ``time_s`` for backends that never
        attached one; None for failed measurements (scalarizes to inf)."""
        if not self.ok:
            return None
        if self.metrics is not None:
            return self.metrics
        if not math.isfinite(self.time_s):
            return None
        return Metrics(samples=(self.time_s,), compile_s=self.compile_s)


def median_prune_loop(sample: Callable[[], float], repeats: int,
                      prune_threshold_s: Optional[float] = None,
                      min_samples: int = 1) -> Tuple[List[float], bool]:
    """Collect up to ``repeats`` timing samples with early-stop pruning.

    After each sample the running median is compared against
    ``prune_threshold_s`` (typically ``k × incumbent``); once it exceeds
    the threshold the loop aborts.  Returns ``(samples, pruned)``.  A
    configuration whose samples stay below the threshold can never be
    pruned, so the incumbent — or anything better — survives; real
    timing is noisy, though, so ``min_samples`` guards against a single
    outlier sample aborting a genuinely fast configuration (wall-clock
    measurement passes 2: pruning only ever triggers on a median of at
    least two samples).
    """
    samples: List[float] = []
    for _ in range(max(1, repeats)):
        samples.append(float(sample()))
        if (prune_threshold_s is not None
                and len(samples) >= max(1, min_samples)
                and len(samples) < repeats
                and float(np.median(samples)) > prune_threshold_s):
            return samples, True
    return samples, False


#: Evaluator.evaluate warns once per process
_EVALUATE_DEPRECATION_EMITTED = False


class Evaluator:
    """Interface: ``prepare`` -> :class:`CompiledArtifact` -> ``measure``.

    Evaluation splits into two typed phases for the parallel engine:

    * ``prepare(spec, config)`` — the compilation phase.  Must be safe to
      run concurrently from a worker pool and returns a
      :class:`~repro_torch.core.artifacts.CompiledArtifact` carrying the
      content-address, the device-profile key, stats, the measurable
      payload and its provenance (fresh-compile vs persistent-store hit).
      It does host work only: a launch from a worker thread would run on
      the card beside another configuration's timed samples.  The default
      prepares nothing and returns a payload-free artifact with
      ``provenance="none"``.
    * ``measure(spec, config, prepared, prune_threshold_s)`` — the launch,
      verification and timing phase, always serialized by the engine so
      measurements never contend.  ``prune_threshold_s`` enables
      early-stop pruning where the backend supports it.

    Evaluators that can skip compilation consult ``artifact_store`` (an
    :class:`~repro_torch.core.artifacts.ArtifactStore`, attached by the
    Tuner or set directly; None = no persistence) inside ``prepare``.

    **Failure contract**: a configuration that cannot be evaluated raises
    a typed :class:`~repro_torch.core.failures.EvaluationError` subclass —
    :class:`~repro_torch.core.failures.CompileError` from ``prepare``,
    :class:`~repro_torch.core.failures.MeasureError` (or
    :class:`~repro_torch.core.failures.VerificationFailure`) from
    ``measure`` — carrying the original exception as ``__cause__``.  The
    evaluation engine converts these into ``inf``-time trials with
    structured FailureRecords.  Failed compiles are never persisted to the
    store.

    ``objective`` adapts an evaluator to a bare strategy's
    ``Config -> float`` objective, outside the engine.  ``evaluate`` — the
    one-call compat shim — is deprecated: it warns once per process
    (``DeprecationWarning``) and routes through the same typed path.
    """

    name = "base"
    #: persistent compile-artifact store; None disables persistence.
    artifact_store: Optional[ArtifactStore] = None
    #: the DeviceProfile this evaluator models/measures against, when it
    #: has one.  None means "no modeled device".
    profile: Optional[Any] = None

    def evaluate(self, spec: KernelSpec, config: Config) -> Measurement:
        """Deprecated one-call path; use ``prepare`` + ``measure``
        (or ``objective``) instead."""
        global _EVALUATE_DEPRECATION_EMITTED
        if not _EVALUATE_DEPRECATION_EMITTED:
            _EVALUATE_DEPRECATION_EMITTED = True
            warnings.warn(
                "Evaluator.evaluate(spec, config) is deprecated; use the "
                "typed prepare()/measure() artifact path (or objective()) "
                "instead", DeprecationWarning, stacklevel=2)
        return self._evaluate(spec, config)

    def _evaluate(self, spec: KernelSpec, config: Config) -> Measurement:
        """measure(prepare(...)) with typed errors folded back into failed
        Measurements — so bare objective adapters keep seeing ``inf``
        instead of exceptions."""
        try:
            return self.measure(spec, config, self.prepare(spec, config))
        except EvaluationError as e:
            return _failed(e)

    def prepare(self, spec: KernelSpec, config: Config) -> CompiledArtifact:
        """Concurrent compile phase; default: nothing to prepare."""
        return CompiledArtifact(
            kind=self.name,
            fingerprint=spec_fingerprint(spec.name, spec.meta, config),
            profile="", payload=None, provenance=PROVENANCE_NONE)

    def measure(self, spec: KernelSpec, config: Config,
                prepared: Any = None,
                prune_threshold_s: Optional[float] = None) -> Measurement:
        raise NotImplementedError

    def objective(self, spec: KernelSpec) -> Callable[[Config], float]:
        """Adapt to the strategies' ``Config -> float`` objective."""
        def _obj(config: Config) -> float:
            return self._evaluate(spec, config).time_s
        return _obj


def _failed(err: Exception | str, compile_s: float = 0.0) -> Measurement:
    return Measurement(time_s=math.inf, ok=False, compile_s=compile_s,
                       error=str(err)[:500])


@dataclasses.dataclass
class _CompiledKernel:
    """Artifact of WallClockEvaluator.prepare: the built callable."""

    fn: Callable
    compile_s: float


class WallClockEvaluator(Evaluator):
    """Median-of-N wall-clock timing of the built kernel (CLTune's method).

    ``device`` is where the kernel runs: ``"cuda"`` (the default) times
    the kernel on the card with CUDA events; ``"cpu"`` times the kernels'
    plain PyTorch versions on the host with the host clock.  Asking for
    CUDA on a host without a card raises — a measurement never falls back
    to the CPU.

    ``prepare`` is host work only: it builds the callable and, on CUDA,
    calls its ``compile()`` (``nvcc`` and loading the library).  The
    artifact's fingerprint is the build's content address when the build
    reports one.  A loaded library does not serialize, so the artifact is
    *not persistable*.  ``measure`` — serialized by the engine — makes the
    first launch, verifies it against the oracle, warms up and times,
    optionally aborting early once the running median exceeds the prune
    threshold.

    **A sample on the card times the card, not the host.**  A kernel
    launched from Python leaves the card idle while the host prepares the
    launch, so one launch between two CUDA events reads high, most for
    short kernels.  On CUDA each sample is one untimed launch, then k
    back-to-back launches between one pair of events, and the window
    divided by k: the untimed launch keeps the card busy while the host
    enqueues the first timed one.  k is chosen once per measurement, after
    the warm-up, from :attr:`PROBE_LAUNCHES` back-to-back launches timed
    the same way, so that the window is at least :attr:`WINDOW_S` (1 ms),
    and at most :attr:`MAX_LAUNCHES`.
    ``repeats``, the median and ``prune_threshold_s`` keep their meaning:
    samples, their median, and the running median that prunes.  On the
    CPU a sample is one call on the host clock, as before.

    **One measurement at a time on a card.**  On CUDA ``measure`` holds an
    exclusive ``flock`` on ``build/locks/cuda<index>.lock`` (at the root of
    the checkout) from its first launch to its last sample, so evaluators
    in other threads or processes — a fleet of tuning workers, a
    background retune beside a serving loop's own measurements — never
    time each other's kernels.  ``prepare`` (the build) takes no such
    lock: builds run in parallel.
    """

    name = "wallclock"
    #: least time one CUDA sample's window of back-to-back launches spans
    WINDOW_S = 1e-3
    #: most launches one CUDA sample times
    MAX_LAUNCHES = 256
    #: back-to-back launches timed to choose k
    PROBE_LAUNCHES = 4

    def __init__(self, repeats: int = 5, warmup: int = 1,
                 verify_outputs: bool = True, seed: int = 0,
                 atol: Optional[float] = None, rtol: Optional[float] = None,
                 device: "torch.device | str" = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "WallClockEvaluator: no CUDA device is available; pass "
                "device='cpu' to time the plain versions on the host")
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {self.device}")
        self.repeats = repeats
        self.warmup = warmup
        self.verify_outputs = verify_outputs
        self.seed = seed
        self.atol, self.rtol = atol, rtol
        #: (spec identity, device args, oracle output): every config of one
        #: search shares the inputs, so they are made and checked once
        self._inputs: Optional[Tuple[Any, Tuple, Any]] = None

    def prepare(self, spec: KernelSpec, config: Config):
        if spec.make_args is None:
            raise CompileError("WallClockEvaluator requires spec.make_args")
        try:
            t0 = time.perf_counter()
            fn = spec.build(config)
            build = getattr(fn, "compile", None)
            digest = (build() if self.device.type == "cuda"
                      and build is not None else None)
            compile_s = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 — any build error = failed config
            raise CompileError(f"{type(e).__name__}: {e}") from e
        return CompiledArtifact(
            kind=self.name,
            fingerprint=digest or spec_fingerprint(
                spec.name, spec.meta, config, extra=f"seed={self.seed}"),
            profile="", payload=_CompiledKernel(fn=fn, compile_s=compile_s),
            stats={"compile_s": compile_s}, compile_s=compile_s,
            persistable=False)

    def _args_and_reference(self, spec: KernelSpec) -> Tuple[Tuple, Any]:
        ident = (spec.name, repr(sorted(spec.meta.items())),
                 spec.make_args, spec.reference)
        if self._inputs is None or self._inputs[0] != ident:
            rng = np.random.default_rng(self.seed)
            args = tuple(torch.as_tensor(x).to(self.device)
                         for x in spec.make_args(rng))
            ref_out = (spec.reference(*args)
                       if self.verify_outputs and spec.reference is not None
                       else None)
            self._inputs = (ident, args, ref_out)
        return self._inputs[1], self._inputs[2]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def lock_path(self) -> str:
        """The file whose ``flock`` serializes measurements on this
        evaluator's card."""
        index = (self.device.index if self.device.index is not None
                 else torch.cuda.current_device())
        return os.path.join(LOCK_DIR, f"cuda{index}.lock")

    def measure(self, spec: KernelSpec, config: Config,
                prepared=None,
                prune_threshold_s: Optional[float] = None) -> Measurement:
        if prepared is None:
            prepared = self.prepare(spec, config)
        if self.device.type != "cuda":
            return self._measure(spec, prepared, prune_threshold_s)
        os.makedirs(LOCK_DIR, exist_ok=True)
        with FileLock(self.lock_path()):
            return self._measure(spec, prepared, prune_threshold_s)

    def _launches_per_sample(self, fn: Callable, args: Tuple) -> int:
        """k for this config: a probe of :attr:`PROBE_LAUNCHES` back-to-back
        launches after an untimed one (so the host's launch gap stays out
        of it, as in a sample), k launches spanning at least WINDOW_S."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        fn(*args)
        start.record()
        for _ in range(self.PROBE_LAUNCHES):
            fn(*args)
        end.record()
        end.synchronize()
        one_s = max(start.elapsed_time(end) / 1e3 / self.PROBE_LAUNCHES,
                    1e-9)
        return max(1, min(self.MAX_LAUNCHES, math.ceil(self.WINDOW_S / one_s)))

    def _measure(self, spec: KernelSpec, prepared: CompiledArtifact,
                 prune_threshold_s: Optional[float]) -> Measurement:
        fn, compile_s = prepared.payload.fn, prepared.payload.compile_s
        args, ref_out = self._args_and_reference(spec)
        try:
            out = fn(*args)
            self._sync()
        except Exception as e:  # noqa: BLE001 — a refused launch = failed config
            raise MeasureError(f"{type(e).__name__}: {e}") from e

        verified: Optional[bool] = None
        if ref_out is not None:
            try:
                verify.assert_trees_close(out, ref_out,
                                          atol=self.atol, rtol=self.rtol)
                verified = True
            except Exception as e:  # verification failure => config is invalid
                raise VerificationFailure(
                    f"verification failed: {e}") from e
        del out

        launches = 1
        try:
            for _ in range(max(0, self.warmup - 1)):
                fn(*args)
            self._sync()
            if self.device.type == "cuda":
                launches = self._launches_per_sample(fn, args)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)

                def _sample() -> float:
                    fn(*args)               # busy while the next enqueues
                    start.record()
                    for _ in range(launches):
                        fn(*args)
                    end.record()
                    end.synchronize()
                    return start.elapsed_time(end) / 1e3 / launches
            else:
                def _sample() -> float:
                    t0 = time.perf_counter()
                    fn(*args)
                    return time.perf_counter() - t0

            samples, pruned = median_prune_loop(
                _sample, self.repeats, prune_threshold_s=prune_threshold_s,
                min_samples=2)
            t = float(np.median(samples))
        except Exception as e:  # noqa: BLE001
            raise MeasureError(f"{type(e).__name__}: {e}") from e
        detail = {"min_s": float(np.min(samples)),
                  "max_s": float(np.max(samples)),
                  "samples": float(len(samples))}
        if self.device.type == "cuda":
            detail["launches_per_sample"] = float(launches)
        if pruned:
            detail["pruned"] = True
        return Measurement(time_s=t, ok=True, verified=verified,
                           compile_s=compile_s, detail=detail,
                           metrics=Metrics(samples=tuple(samples),
                                           compile_s=compile_s))


class CostModelEvaluator(Evaluator):
    """Roofline time from the kernel's declared cost (no build, no launch).

    time = max(flops / peak_f32_flops, bytes / hbm_bw) + launch_overhead,
    on one card of ``profile``.  The declared cost
    (:mod:`repro_torch.core.cost`) takes the place of XLA's
    ``cost_analysis()`` of a lowered module in the JAX package; its
    ``collective_bytes`` are carried in the payload but priced at 0, since
    a one-card profile has no interconnect to price them against.

    ``prepare`` evaluates the declared cost — no ``nvcc`` — and, when an
    ``artifact_store`` is attached, persists the payload under kind
    ``costmodel`` keyed by :func:`spec_fingerprint` and ``profile.name``,
    so a second search answers from the store (``provenance="store"``,
    ``compile_s=0``).  The fingerprint folds in :func:`source_digest` of
    the spec's ``cost`` and ``sources`` (the declaration's cost function,
    what it calls, and the kernel's ``.cu``), so an edit to either is
    priced anew, as a changed lowering is in the JAX package.  A configuration its declaration refuses raises
    :class:`CompileError`, as a failed lowering does in the JAX package,
    and is never persisted.  ``measure`` prices the payload; a store-hit
    payload prices identically to a fresh one.
    """

    name = "costmodel"

    def __init__(self, profile: Optional[DeviceProfile] = None):
        self.profile = resolve_profile(profile)
        #: (cost, *sources) -> source_digest, computed once per spec
        self._digests: Dict[Tuple[Any, ...], str] = {}

    def _source_digest(self, spec: KernelSpec) -> str:
        key = (spec.cost,) + tuple(spec.sources)
        if key not in self._digests:
            self._digests[key] = source_digest(*key)
        return self._digests[key]

    def prepare(self, spec: KernelSpec, config: Config) -> CompiledArtifact:
        """Evaluate the declared cost, or fetch it from the store."""
        if spec.cost is None:
            raise CompileError("CostModelEvaluator requires spec.cost")
        fp = spec_fingerprint(spec.name, spec.meta, config,
                              extra=f"src={self._source_digest(spec)}")

        def _compute() -> CompiledArtifact:
            t0 = time.perf_counter()
            try:
                cost = declared_cost(spec.cost, config)
            except Exception as e:  # noqa: BLE001 — a refused config
                raise CompileError(f"{type(e).__name__}: {e}") from e
            compile_s = time.perf_counter() - t0
            payload = dict(cost.to_json(), compile_s=compile_s)
            return CompiledArtifact(
                kind=self.name, fingerprint=fp, profile=self.profile.name,
                payload=payload, stats=dict(payload), compile_s=compile_s,
                persistable=True)

        if self.artifact_store is not None:
            return self.artifact_store.get_or_compute(
                self.name, fp, self.profile.name, _compute)
        return _compute()

    def measure(self, spec: KernelSpec, config: Config,
                prepared=None,
                prune_threshold_s: Optional[float] = None) -> Measurement:
        if prepared is None:
            prepared = self.prepare(spec, config)
        compile_s, payload = prepared.compile_s, prepared.payload
        flops, bytes_ = payload["flops"], payload["bytes"]
        p = self.profile
        compute_t = flops / p.peak_f32_flops
        memory_t = bytes_ / p.hbm_bw
        t = max(compute_t, memory_t) + p.launch_overhead
        return Measurement(
            time_s=t, ok=True, compile_s=compile_s,
            detail={"flops": flops, "bytes": bytes_,
                    "collective_bytes": payload["collective_bytes"],
                    "compute_t": compute_t, "memory_t": memory_t,
                    "collective_t": 0.0},
            metrics=Metrics(samples=(t,), compile_s=compile_s, work=flops))

    def analyze(self, spec: KernelSpec, config: Config) -> Measurement:
        """Price one config, a failure folded into a failed Measurement."""
        return self._evaluate(spec, config)


class AnalyticalEvaluator(Evaluator):
    """Structural device model + seeded measurement noise.

    The kernel supplies ``analytical_model(config, profile) -> seconds``
    (math.inf for configurations that exceed shared memory or are
    otherwise infeasible on the profile).  We multiply by log-normal noise
    whose seed is derived from the configuration, so repeated evaluation
    of the same point is deterministic within one process — matching how
    a real timing distribution has a per-configuration systematic
    component plus jitter.  The seed comes from Python's ``hash()``, as in
    the JAX package, so that a search here and one there agree trial for
    trial in the same process.

    There is no compile phase: ``prepare`` is the base payload-free
    :class:`CompiledArtifact` (``provenance="none"``), ``measure`` prices
    the model directly and ignores the artifact.
    """

    name = "analytical"

    def __init__(self, profile: Optional[DeviceProfile] = None,
                 noise_sigma: float = 0.03, seed: int = 0,
                 repeats: int = 5):
        self.profile = resolve_profile(profile)
        self.noise_sigma = noise_sigma
        self.seed = seed
        self.repeats = max(1, repeats)

    def _noise_rng(self, config: Config) -> np.random.Generator:
        h = hash((self.seed,) + tuple(sorted(
            (k, str(v)) for k, v in config.items()))) & 0xFFFFFFFF
        return np.random.default_rng(h)

    def _noise_samples(self, config: Config, n: int) -> List[float]:
        """n deterministic noise factors drawn from one seeded stream."""
        if self.noise_sigma <= 0:
            return [1.0] * n
        rng = self._noise_rng(config)
        return [float(np.exp(rng.normal(0.0, self.noise_sigma)))
                for _ in range(n)]

    def measure(self, spec: KernelSpec, config: Config,
                prepared=None,
                prune_threshold_s: Optional[float] = None) -> Measurement:
        if spec.analytical_model is None:
            raise CompileError(
                "AnalyticalEvaluator requires spec.analytical_model")
        try:
            t = float(spec.analytical_model(config, self.profile))
        except Exception as e:  # noqa: BLE001
            raise MeasureError(f"{type(e).__name__}: {e}") from e
        if not math.isfinite(t):
            raise InfeasibleConfigError(
                "analytically infeasible (shared memory/limits)")
        noise = self._noise_samples(config, self.repeats)
        samples = tuple(t * n for n in noise)
        return Measurement(time_s=samples[0], ok=True,
                           detail={"model_time_s": t},
                           metrics=Metrics(samples=samples))


class ArrivalTraceEvaluator(Evaluator):
    """Price one configuration against a modeled **arrival trace**.

    SLO tuning measures a config against the traffic *distribution*, not
    one fixed geometry: the sample vector has one entry per traced
    arrival shape (times seeded log-normal jitter), so a p99 objective
    over these metrics is literally "the tail of the modeled trace".
    The first traced shape is the bucket's full (padded) geometry; a
    config must be feasible there, or the whole config raises
    :class:`InfeasibleConfigError`.  A *ragged* arrival the config
    cannot cover (e.g. a block size that does not divide that arrival's
    shape) is not infeasible — serving pads such a request up to the
    bucket bound, so the sample for that arrival is the full-geometry
    cost.  Configs with finer tiles therefore win on ragged tails
    exactly as they do in the real padded serve path.

    ``model(shape, config, profile) -> seconds`` matches the signature of
    a :class:`~repro_torch.core.registry.TunableKernel`'s
    ``analytical_model``, so a kernel's registered model plugs in
    directly.  ``time_s`` stays the median of the trace (the legacy scalar
    contract); tail objectives read the full vector through
    ``Measurement.metrics``.  The noise is seeded from a sha256 digest of
    the seed, the arrival index and the config, so it is the same in every
    process and equal to the JAX package's.
    """

    name = "trace"

    def __init__(self, model: Callable[[Dict[str, Any], Config, DeviceProfile],
                                       float],
                 trace, profile: Optional[DeviceProfile] = None,
                 noise_sigma: float = 0.03, seed: int = 0):
        if not trace:
            raise ValueError("ArrivalTraceEvaluator requires a non-empty trace")
        self.model = model
        self.trace = tuple(dict(s) for s in trace)
        self.profile = resolve_profile(profile)
        self.noise_sigma = noise_sigma
        self.seed = seed

    def _noise(self, config: Config, index: int) -> float:
        if self.noise_sigma <= 0:
            return 1.0
        # stable digest, NOT hash(): str hashing is per-process randomized
        # and a retune winner must reproduce across processes/hosts
        text = repr((self.seed, index) + tuple(sorted(
            (k, str(v)) for k, v in config.items())))
        h = int.from_bytes(hashlib.sha256(text.encode()).digest()[:4], "big")
        rng = np.random.default_rng(h)
        return float(np.exp(rng.normal(0.0, self.noise_sigma)))

    def measure(self, spec: KernelSpec, config: Config,
                prepared=None,
                prune_threshold_s: Optional[float] = None) -> Measurement:
        samples: List[float] = []
        padded = 0
        full_t: Optional[float] = None
        for i, shape in enumerate(self.trace):
            try:
                t = float(self.model(shape, config, self.profile))
            except Exception as e:  # noqa: BLE001
                raise MeasureError(f"{type(e).__name__}: {e}") from e
            if not math.isfinite(t):
                if full_t is None:
                    # the bucket's own geometry (trace[0]) must work
                    raise InfeasibleConfigError(
                        f"infeasible at bucket geometry {shape!r}")
                # ragged arrival the tiles can't cover: serving pads it
                # up to the bucket bound, so it costs the full geometry
                t = full_t
                padded += 1
            if full_t is None:
                full_t = t
            samples.append(t * self._noise(config, i))
        return Measurement(
            time_s=float(np.median(samples)), ok=True,
            detail={"trace_len": float(len(samples)),
                    "padded_arrivals": float(padded),
                    "min_s": float(np.min(samples)),
                    "max_s": float(np.max(samples))},
            metrics=Metrics(samples=tuple(samples)))


def make_evaluator(name: str, **kwargs) -> Evaluator:
    table = {
        "wallclock": WallClockEvaluator,
        "costmodel": CostModelEvaluator,
        "analytical": AnalyticalEvaluator,
        "trace": ArrivalTraceEvaluator,
    }
    try:
        return table[name](**kwargs)
    except KeyError as e:
        raise KeyError(f"unknown evaluator {name!r}; known: {sorted(table)}") from e
