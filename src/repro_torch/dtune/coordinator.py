"""Distributed tuning coordinator: shard, fan out, merge, publish.

``DistributedTuner`` is the driver loop of the distributed plane:

1. **shard** the kernel's search space across N workers
   (:func:`~repro_torch.dtune.partition.shard_space`);
2. **fan out** one :class:`~repro_torch.dtune.worker.TuningWorker` per shard
   (thread or process driver), each recording into a private cache file;
3. **merge** every private cache into the shared one with
   :meth:`TuningCache.merge` — best finite time per key wins, counts
   fold — then :meth:`TuningCache.save` (merge-on-disk) publishes the
   fleet winner;
4. the cache's ``subscribe`` hooks fire for merged-in winners, so live
   :class:`~repro_torch.serve.online.ConfigSlot` holders hot-swap without
   any
   coordinator → serve plumbing.

Env knobs (all overridable per-call, parsed by
:mod:`repro_torch.core.envknobs`):

* ``REPRO_DTUNE_WORKERS`` — fleet size (default 4)
* ``REPRO_DTUNE_MODE`` — ``strided`` | ``islands`` (default ``strided``)
* ``REPRO_DTUNE_DRIVER`` — ``thread`` | ``process`` (default ``thread``)
* ``REPRO_ARTIFACT_CACHE`` / ``REPRO_ARTIFACT_DIR`` — enable/locate the
  shared compile-artifact store every worker opens (at-most-once
  compiles fleet-wide); an explicit ``artifact_store`` argument wins

The fleet's profile is resolved once, here (the card's own when none is
given, read at run time), and shipped to every worker as its fields, so a
spawned worker proves and prices against the limits of the card it runs
on, not a datasheet entry of the same name.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import multiprocessing as mp
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, List, Mapping, Optional

from ..core.artifacts import ArtifactStore, resolve_store
from ..core.cache import CacheEntry, TuningCache, default_cache
from ..core.engine import EngineConfig
from ..core.envknobs import env_int, env_str
from ..core.profiles import DeviceProfile, resolve_profile
from ..core.registry import Shape, resolve
from .partition import Shard, shard_space
from .worker import (START_METHOD, EvaluatorSpec, WorkerResult, WorkerSpec,
                     run_workers, spec_device)

log = logging.getLogger("repro_torch.dtune")

ENV_WORKERS = "REPRO_DTUNE_WORKERS"
ENV_MODE = "REPRO_DTUNE_MODE"
ENV_DRIVER = "REPRO_DTUNE_DRIVER"

_DEFAULT_WORKERS = 4


@dataclasses.dataclass
class DistributedOutcome:
    """The fleet-level result of one distributed tune."""

    kernel: str
    shape: Dict[str, Any]
    profile: str
    mode: str
    driver: str
    n_workers: int
    best_config: Optional[Dict[str, Any]]
    best_time: float
    best_worker: Optional[int]              # index of the winning worker
    workers: List[WorkerResult]
    evaluations: int                        # fleet total
    #: cache keys the final merge changed (winners other workers lacked)
    merged_keys: List[str]

    @property
    def ok(self) -> bool:
        return self.best_config is not None

    @property
    def per_worker_evaluations(self) -> float:
        """Mean evaluations per worker — the speedup denominator."""
        live = [w for w in self.workers if w.status != "failed"]
        return (sum(w.evaluations for w in live) / len(live)) if live else 0.0

    def report(self) -> str:
        lines = [f"== distributed tune: {self.kernel} {self.shape} "
                 f"profile={self.profile} mode={self.mode} "
                 f"driver={self.driver} workers={self.n_workers} =="]
        for w in self.workers:
            desc = w.status
            if w.best_config is not None:
                desc += (f"  {w.best_time * 1e6:9.2f} us after "
                         f"{w.evaluations} evals  {w.best_config}")
            if w.failures:
                desc += f"  [{w.failures} failed trial(s)]"
            if w.error:
                desc += f"  [{w.error.splitlines()[0]}]"
            lines.append(f"  worker {w.index} ({w.shard_label}): {desc}")
        if self.best_config is None:
            lines.append("  fleet: no feasible config found")
        else:
            lines.append(f"  fleet best: {self.best_time * 1e6:.2f} us "
                         f"(worker {self.best_worker}), "
                         f"{self.evaluations} total evaluations, "
                         f"{self.per_worker_evaluations:.1f}/worker")
        return "\n".join(lines)


class DistributedTuner:
    """Shard one kernel's search across N workers and merge the results.

    The facade mirrors :func:`repro_torch.tune.api.tune_kernel` — same
    kernel / shape / profile / evaluator / cache vocabulary — with fleet
    knobs on top.  ``device`` is where the workers run: None = the
    evaluator spec's device (the card by default); ``"cpu"`` runs the
    plain versions against a modeled H100.  ``profile`` defaults to that
    device's (:func:`~repro_torch.core.profiles.resolve_profile`).  ``budget`` is **per worker** (None = exhaustive for strided
    shards, the tuner's 1/32 clamp per island otherwise).  Construction
    is cheap; :meth:`run` does the work and may be called once per
    instance.
    """

    def __init__(self, kernel: "str | Any", shape: Shape, *,
                 n_workers: Optional[int] = None,
                 mode: Optional[str] = None,
                 driver: Optional[str] = None,
                 profile: Optional[DeviceProfile] = None,
                 evaluator: EvaluatorSpec = None,
                 cache: Optional[TuningCache] = None,
                 artifact_store: "ArtifactStore | str | None" = None,
                 budget: Optional[int] = None,
                 engine: "EngineConfig | Mapping[str, Any] | None" = None,
                 device: Optional[str] = None,
                 extended_space: Optional[bool] = None,
                 warm_start: "bool | int" = True,
                 seed: int = 0,
                 record: bool = True,
                 objective: "str | Any | None" = None,
                 predictor: "str | Mapping[str, Any] | None" = None):
        self.kernel = resolve(kernel)
        self.shape = dict(shape)
        self.n_workers = (n_workers if n_workers is not None
                          else env_int(ENV_WORKERS, _DEFAULT_WORKERS))
        self.mode = mode or env_str(ENV_MODE, "strided")
        self.driver = driver or env_str(ENV_DRIVER, "thread")
        self.device = device
        self.profile = resolve_profile(profile,
                                       device or spec_device(evaluator))
        self.evaluator = evaluator
        self.cache = cache if cache is not None else default_cache()
        # workers only get the store's *directory* (a live store does not
        # pickle); each opens its own ArtifactStore on it and the per-
        # artifact file locks give at-most-once compiles across the fleet
        store = resolve_store(artifact_store)
        self.artifact_dir = store.root if store is not None else None
        self.budget = budget
        if isinstance(engine, EngineConfig):
            engine = {f.name: getattr(engine, f.name)
                      for f in dataclasses.fields(EngineConfig)}
        self.engine: Dict[str, Any] = dict(engine or {})
        if self.engine.get("stop_event") is not None:
            raise ValueError("pass no stop_event; the coordinator owns "
                             "cancellation (use DistributedTuner.stop())")
        self.engine.pop("stop_event", None)
        if objective is not None:
            self.engine["objective"] = objective
        # the objective travels to (possibly spawned) workers inside the
        # engine kwargs dict — canonicalize to its spec string so the dict
        # stays plain picklable data
        if self.engine.get("objective") is not None:
            self.engine["objective"] = str(self.engine["objective"])
        self.objective: Optional[str] = self.engine.get("objective")
        # same discipline as stop_event: a live Predictor does not pickle
        # and must not ride the engine kwargs — the coordinator owns the
        # fleet predictor (trained once, shipped as plain data)
        if self.engine.get("predictor") is not None:
            raise ValueError("pass no live predictor in engine=; use "
                             "DistributedTuner(predictor=...) instead")
        self.engine.pop("predictor", None)
        self.predictor = predictor
        if extended_space is None:
            extended_space = bool(
                self.kernel.defaults.get("extended_space", False))
        self.extended_space = bool(extended_space)
        self.warm_start = warm_start
        self.seed = seed
        self.record = record
        self._stop: Optional[Any] = None

    # -- cancellation ---------------------------------------------------------
    def stop(self) -> None:
        """Ask every worker to stop after its current batch (cooperative:
        workers return partial results with ``status='aborted'``)."""
        if self._stop is not None:
            self._stop.set()

    # -- warm start -----------------------------------------------------------
    def _seeds(self) -> Optional[List[Dict[str, Any]]]:
        if self.mode == "strided" or not self.warm_start:
            return None          # full search ignores seeds anyway
        k_nearest = 3 if self.warm_start is True else int(self.warm_start)
        if k_nearest <= 0:
            return None
        # lazy import: tune.api sits above core and below us; importing it
        # lazily keeps dtune importable from either side (same pattern as
        # serve/online.py)
        from ..tune.api import warm_start_seeds
        return warm_start_seeds(self.kernel, self.shape,
                                profile=self.profile, cache=self.cache,
                                k_nearest=k_nearest,
                                objective=self.objective) or None

    # -- fleet predictor ------------------------------------------------------
    def _predictor_spec(self) -> "str | Dict[str, Any] | None":
        """The fleet predictor as plain picklable data.

        Kind ``"learned"`` is resolved *here*: one model trains from the
        coordinator's merged cache (the whole fleet's history) and its
        weights ship to every worker as a ``{"kind", "payload"}`` dict —
        workers reconstruct it without retraining, so all shards rank
        with the same surrogate.  Other kinds travel as strings and are
        instantiated worker-side (they carry no state).
        """
        p = self.predictor
        if p is None:
            return None
        if isinstance(p, Mapping):
            return dict(p)
        if p == "learned":
            from ..core.predict import train_from_cache
            model = train_from_cache(self.kernel, self.cache,
                                     profile=self.profile,
                                     objective=self.objective,
                                     extended=self.extended_space)
            return {"kind": "learned", "payload": model.to_payload()}
        return str(p)

    # -- execution ------------------------------------------------------------
    def run(self, timeout_s: Optional[float] = None) -> DistributedOutcome:
        k = self.kernel
        space = k.make_space(self.shape, extended=self.extended_space)
        shards = shard_space(space, self.n_workers, self.mode,
                             budget=self.budget, seed=self.seed)
        seeds = self._seeds()
        pspec = self._predictor_spec()
        self._stop = (mp.get_context(START_METHOD).Event()
                      if self.driver == "process" else threading.Event())
        workdir = tempfile.mkdtemp(prefix="repro-dtune-")
        # everything between mkdtemp and the finally lives inside the try:
        # a crash anywhere here (spec construction, a driver raising, a
        # terminated worker fleet) used to leak the private-cache tempdir
        try:
            specs = [WorkerSpec(
                kernel=k.name, shape=dict(self.shape), shard=shard,
                profile=dataclasses.asdict(self.profile),
                evaluator=self.evaluator,
                engine=dict(self.engine), device=self.device,
                extended_space=self.extended_space,
                cache_path=os.path.join(workdir, f"worker{shard.index}.json"),
                seeds=seeds,
                artifact_dir=self.artifact_dir,
                predictor=pspec) for shard in shards]
            results = run_workers(specs, self.driver,
                                  stop_event=self._stop,
                                  timeout_s=timeout_s)
            merged = self._merge(results) if self.record else {}
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        best_worker = None
        for w in results:
            if w.ok and math.isfinite(w.best_time) and (
                    best_worker is None
                    or w.best_time < results[best_worker].best_time):
                best_worker = w.index
        best = results[best_worker] if best_worker is not None else None
        for w in results:
            if w.status == "failed":
                log.warning("dtune: worker %s failed: %s", w.shard_label,
                            (w.error or "").splitlines()[0]
                            if w.error else "?")
        return DistributedOutcome(
            kernel=k.name, shape=dict(self.shape), profile=self.profile.name,
            mode=self.mode, driver=self.driver, n_workers=self.n_workers,
            best_config=dict(best.best_config) if best else None,
            best_time=best.best_time if best else math.inf,
            best_worker=best_worker, workers=results,
            evaluations=sum(w.evaluations for w in results),
            merged_keys=sorted(merged))

    def _merge(self, results: List[WorkerResult]) -> Dict[str, CacheEntry]:
        """Fold every worker's private cache into the shared one, then
        publish with a merge-on-disk save.  Returns the changed keys."""
        changed: Dict[str, CacheEntry] = {}
        for w in results:
            if not w.cache_path or not os.path.exists(w.cache_path):
                continue          # failed/empty worker never recorded
            try:
                changed.update(self.cache.merge(w.cache_path))
            except Exception:  # noqa: BLE001 — a torn worker cache must
                # not lose the other workers' results
                log.exception("dtune: could not merge worker cache %s",
                              w.cache_path)
        if changed or len(self.cache):
            self.cache.save()
        return changed
