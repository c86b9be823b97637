"""Distributed tuning workers: one shard, one EvaluationEngine.

A :class:`TuningWorker` executes one
:class:`~repro_torch.dtune.partition.Shard` of a distributed search by
wrapping the exact same stack a single-process tune uses —
``Tuner.from_tunable`` → ``EvaluationEngine`` — so every fault-tolerance
behaviour of the engine carries over: a failing config becomes a trial,
a circuit-breaker trip yields a *partial* :class:`WorkerResult` with
``status="aborted"`` instead of killing the job, and only an unexpected
crash in the worker scaffolding itself reports ``status="failed"``.

Everything in :class:`WorkerSpec` is plain data (kernel by registered
name, evaluator by name/kwargs spec, profile by name or by its fields) so a
spec crosses a process boundary by pickling; each worker records into its
own *private* cache file and the coordinator folds those into the shared
cache with :meth:`TuningCache.merge` afterwards.  A profile read from the
card at run time (:func:`~repro_torch.core.profiles.device_profile`) has
no name in :data:`~repro_torch.core.profiles.PROFILES`, so the coordinator
ships its fields, and a worker measures against the card's own limits.

Two drivers run a fleet of specs:

* ``thread`` — in-process pool.  Zero setup cost; right for analytical /
  cost-model evaluators (pure Python, cheap) and for tests.
* ``process`` — one OS process per worker, always started with ``spawn``:
  a parent that has initialised CUDA cannot ``fork`` safely.  True
  isolation: a worker crashing in a compiler cannot take the coordinator
  down; results come back over a queue and caches over the filesystem.
  A spawned child imports the parent's ``__main__`` again (as
  ``__mp_main__``), so a script that runs a fleet keeps its work under
  ``if __name__ == "__main__"``; it finds this package through the
  ``sys.path`` that ``spawn`` passes on.

Workers of either driver may share one card: the wall-clock evaluator
takes a per-card file lock for each measurement, so workers build in
parallel and measure one at a time, and the build's own file lock makes
each library compile once across the fleet.
"""

from __future__ import annotations

import dataclasses
import logging
import multiprocessing as mp
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Mapping, Optional, Union

from ..core.cache import TuningCache
from ..core.evaluators import Evaluator, make_evaluator
from ..core.profiles import DeviceProfile, get_profile, resolve_profile
from ..core.registry import resolve
from ..core.tuner import Tuner
from ..kernels import launch_counts
from .partition import Shard

log = logging.getLogger("repro_torch.dtune")

#: evaluator specification forms a WorkerSpec accepts: None (the kernel's
#: default), a make_evaluator name, a {"name": ..., **kwargs} dict, or a
#: live Evaluator instance (thread driver only — not spawn-safe)
EvaluatorSpec = Union[None, str, Mapping[str, Any], Evaluator]

#: a device profile as plain data: a name in PROFILES, or its fields
ProfileSpec = Union[None, str, Mapping[str, Any]]

#: how the process driver starts workers (see the module docstring)
START_METHOD = "spawn"


def resolve_evaluator(spec: EvaluatorSpec,
                      device: Optional[str] = None,
                      profile: Optional[DeviceProfile] = None
                      ) -> Optional[Evaluator]:
    """Materialize an evaluator from its picklable spec (None passes
    through: ``Tuner.from_tunable`` picks the kernel's default).  A
    ``"wallclock"`` spec without a ``device`` measures on ``device`` when
    one is given (a worker's device choice); any other named evaluator
    without a ``profile`` models ``profile`` when one is given (the
    fleet's)."""
    if spec is None or isinstance(spec, Evaluator):
        return spec
    if isinstance(spec, str):
        spec = {"name": spec}
    if isinstance(spec, Mapping):
        kwargs = dict(spec)
        try:
            name = kwargs.pop("name")
        except KeyError:
            raise ValueError("evaluator spec dict needs a 'name' key; "
                             f"got {dict(spec)!r}") from None
        if name == "wallclock":
            if device is not None:
                kwargs.setdefault("device", device)
        elif profile is not None:
            kwargs.setdefault("profile", profile)
        return make_evaluator(name, **kwargs)
    raise TypeError(f"bad evaluator spec: {spec!r}")


def spec_device(spec: EvaluatorSpec) -> Optional[str]:
    """The device an evaluator spec names (an instance's ``device``, a
    dict's ``"device"``), or None."""
    if isinstance(spec, Mapping):
        device = spec.get("device")
    else:
        device = getattr(spec, "device", None)
    return None if device is None else str(device)


def resolve_profile_spec(spec: ProfileSpec,
                         device: Optional[str] = None) -> DeviceProfile:
    """A profile from its plain-data form: a name in ``PROFILES``, the
    fields of a :class:`DeviceProfile` (``dataclasses.asdict``), or None —
    the profile of ``device`` (:func:`resolve_profile`, the current card
    by default)."""
    if spec is None:
        return resolve_profile(None, device)
    if isinstance(spec, str):
        return get_profile(spec)
    if isinstance(spec, Mapping):
        return DeviceProfile(**spec)
    raise TypeError(f"bad profile spec: {spec!r}")


@dataclasses.dataclass
class WorkerSpec:
    """Everything one worker needs, as plain picklable data."""

    kernel: str                             # registered TunableKernel name
    shape: Dict[str, Any]
    shard: Shard
    #: DeviceProfile by name or by its fields (``dataclasses.asdict``);
    #: None = the profile of ``device``
    profile: ProfileSpec = None
    evaluator: EvaluatorSpec = None
    #: EngineConfig kwargs (workers, prune_factor, max_failures, ...);
    #: the runtime stop event is injected separately, never pickled
    engine: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: where the worker runs: None = the evaluator's device (the card by
    #: default, as ``tune_kernel``); "cpu" for the plain versions and a
    #: modeled H100
    device: Optional[str] = None
    extended_space: bool = False
    #: private cache file this worker records its shard winner into;
    #: None = don't record (results only travel via WorkerResult)
    cache_path: Optional[str] = None
    #: warm-start seed configs (nearest-shape winners, heuristics)
    seeds: Optional[List[Dict[str, Any]]] = None
    #: root directory of the *shared* compile-artifact store (picklable
    #: path, not a live store): every worker opens its own ArtifactStore
    #: on it, and the store's per-artifact cross-process locks make each
    #: distinct artifact compile at most once fleet-wide.  None = no store.
    artifact_dir: Optional[str] = None
    #: predictor as plain picklable data: None (the REPRO_PREDICTOR env
    #: default), a kind string, or a ``{"kind", "payload"}`` dict carrying
    #: a fleet-trained LearnedPredictor's weights — the coordinator trains
    #: ONE model from the merged cache and ships it to every worker, so
    #: the whole fleet ranks with the same surrogate (never a live object)
    predictor: "str | Dict[str, Any] | None" = None


@dataclasses.dataclass
class WorkerResult:
    """One worker's outcome, as plain data (crosses process boundaries)."""

    index: int
    shard_label: str
    #: "ok" | "aborted" (circuit breaker / stop event, partial result) |
    #: "empty" (no feasible config in the shard) | "failed" (worker crash)
    status: str
    best_config: Optional[Dict[str, Any]] = None
    best_time: float = float("inf")
    evaluations: int = 0
    failures: int = 0                       # failed-config trials
    error: Optional[str] = None             # set when status == "failed"
    cache_path: Optional[str] = None
    engine_stats: Optional[Dict[str, Any]] = None
    #: kernel launches while the worker ran, by counter
    #: (:func:`~repro_torch.kernels.launch_counts`): the worker's own under
    #: the process driver; the thread driver's workers share one process,
    #: so each counts the fleet's launches in its window
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.status in ("ok", "aborted") \
            and self.best_config is not None


class TuningWorker:
    """Run one shard of a distributed search through the standard stack."""

    def __init__(self, spec: WorkerSpec, stop_event: Optional[Any] = None):
        self.spec = spec
        self.stop_event = stop_event

    def run(self) -> WorkerResult:
        spec = self.spec
        shard = spec.shard
        try:
            return self._run()
        except Exception as e:  # noqa: BLE001 — one worker crashing must
            # surface as a failed *result*, not kill the whole fleet
            log.exception("dtune: worker %s crashed", shard.label)
            return WorkerResult(
                index=shard.index, shard_label=shard.label, status="failed",
                error=f"{type(e).__name__}: {e}\n"
                      f"{traceback.format_exc(limit=5)}",
                cache_path=spec.cache_path)

    def _run(self) -> WorkerResult:
        spec = self.spec
        shard = spec.shard
        before = launch_counts()
        k = resolve(spec.kernel)
        cache = TuningCache(spec.cache_path) if spec.cache_path else None
        profile = resolve_profile_spec(
            spec.profile, spec.device or spec_device(spec.evaluator))
        tuner = Tuner.from_tunable(
            k, spec.shape, profile=profile,
            evaluator=resolve_evaluator(spec.evaluator, spec.device, profile),
            cache=cache, artifact_store=spec.artifact_dir,
            extended_space=spec.extended_space)
        engine = dict(spec.engine)
        if self.stop_event is not None:
            engine["stop_event"] = self.stop_event
        outcome = tuner.tune(
            strategy=shard.strategy, budget=shard.budget, seed=shard.seed,
            record_to_cache=spec.cache_path is not None,
            shape_key=k.key_for(spec.shape), engine=engine,
            seeds=spec.seeds or None, predictor=spec.predictor,
            **shard.strategy_kwargs)
        result = outcome.result
        best = result.best
        if result.extra.get("aborted"):
            status = "aborted"
        elif best is None:
            status = "empty"
        else:
            status = "ok"
        return WorkerResult(
            index=shard.index, shard_label=shard.label, status=status,
            best_config=dict(best.config) if best else None,
            best_time=best.time if best else float("inf"),
            evaluations=result.evaluations,
            failures=outcome.failure_summary["failed_trials"],
            cache_path=spec.cache_path,
            engine_stats=result.extra.get("engine"),
            launches={name: n - before.get(name, 0)
                      for name, n in launch_counts().items()})


# -- drivers -------------------------------------------------------------------

def _process_entry(spec: WorkerSpec, queue: "mp.Queue",
                   stop_event: Optional[Any] = None) -> None:
    """Module-level child entry point (picklable under spawn)."""
    result = TuningWorker(spec, stop_event).run()
    queue.put(dataclasses.asdict(result))


def run_workers(specs: List[WorkerSpec], driver: str = "thread", *,
                stop_event: Optional[Any] = None,
                timeout_s: Optional[float] = None) -> List[WorkerResult]:
    """Execute every spec and return results in spec order.

    ``driver="thread"`` runs workers on an in-process pool sized to the
    fleet; ``driver="process"`` spawns one OS process per worker.
    ``stop_event`` (optional) is handed to every worker's engine for
    cooperative early stop; with the process driver it must be a
    ``multiprocessing.Event``.  A worker that crashes, dies, or exceeds
    ``timeout_s`` yields a ``status="failed"`` result — never an
    exception out of this function.
    """
    if driver == "thread":
        with ThreadPoolExecutor(max_workers=max(1, len(specs)),
                                thread_name_prefix="dtune-worker") as pool:
            futures = [pool.submit(TuningWorker(s, stop_event).run)
                       for s in specs]
            return [f.result() for f in futures]
    if driver != "process":
        raise ValueError(f"unknown dtune driver {driver!r}; "
                         "known: 'thread', 'process'")
    # spawn, never fork: a parent that has initialised CUDA cannot fork
    # safely; it is why WorkerSpec is all-plain-data
    ctx = mp.get_context(START_METHOD)
    queues = [ctx.Queue() for _ in specs]
    procs = []
    for spec, q in zip(specs, queues):
        # NB a stop_event crossing this boundary must be a
        # multiprocessing.Event of the spawn context; a plain
        # threading.Event would fail to pickle
        p = ctx.Process(target=_process_entry, args=(spec, q, stop_event),
                        name=f"dtune-{spec.shard.label}")
        p.start()
        procs.append(p)
    results: List[WorkerResult] = []
    for spec, p, q in zip(specs, procs, queues):
        shard = spec.shard
        try:
            results.append(WorkerResult(**q.get(timeout=timeout_s)))
        except Exception as e:  # noqa: BLE001 — queue.Empty on timeout,
            # or a child that died before putting anything
            results.append(WorkerResult(
                index=shard.index, shard_label=shard.label, status="failed",
                error=f"worker process yielded no result ({e!r})",
                cache_path=spec.cache_path))
        p.join(timeout=5.0)
        if p.is_alive():
            p.terminate()
            p.join(timeout=5.0)
    return results
