"""Persistent compile-artifact cache, content-addressed by build fingerprint.

Tuning cost in this reproduction is compile-dominated: the evaluation
engine overlaps compiles but every *process* still recompiles from
scratch — each background retune pays the full compile bill again on the
serving host, and every distributed worker rebuilds the configs its
peers already built.  This module amortizes that bill across runs,
processes and the fleet:

* :class:`CompiledArtifact` is the **typed contract** of the evaluator
  pipeline.  ``Evaluator.prepare()`` returns one, ``measure()`` consumes
  one, the engine's dedup memo and compile pool carry them, and
  ``EngineStats`` reports their provenance (``artifact_hits`` /
  ``compiles_avoided``).  It replaces the untyped ``prepare() -> Any``
  convention: the payload (a live executable, or a JSON-serializable cost
  record), the content address, the device-profile key, the lowered stats
  and the fresh-compile-vs-cache-hit provenance all travel together.
* :class:`ArtifactStore` is the **persistent half**: a directory of
  one-file-per-artifact JSON records keyed on (content fingerprint, device
  profile).  A CUDA kernel's fingerprint hashes its source bytes, its
  ``-D`` defines and its compiler flags (``cuda:<digest>``, from
  :mod:`repro_torch.kernels.build`).  Files are written with the same
  atomic tmp+replace discipline as the tuning cache, and :meth:`ArtifactStore.get_or_compute`
  takes a per-artifact cross-process file lock around the compile, so a
  fleet of dtune workers — or a serving host's background retunes racing
  a sibling replica — compiles each distinct artifact **at most once**;
  everyone else blocks briefly and reads the winner's record.
* Corrupted entries are **quarantined**, not fatal: a torn or truncated
  record is renamed to ``*.corrupt`` and recompiled, mirroring how the
  tuning cache drops malformed entries on load.

Device-profile keying follows Rupp et al.'s portability result: an
artifact built/priced for one device is wrong for another, so the
profile name is part of the address, never flattened away.

Env knobs (see :mod:`repro_torch.core.envknobs`):

* ``REPRO_ARTIFACT_CACHE`` — enable the process-default store (strict
  boolean; unset = disabled, so cold paths are byte-identical to the
  pre-store behavior unless a store is passed explicitly).
* ``REPRO_ARTIFACT_DIR`` — where the default store lives
  (default ``~/.cache/repro-cltune-torch/artifacts``, apart from the
  JAX package's store).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .envknobs import env_bool, env_str

log = logging.getLogger("repro_torch.artifacts")

#: bump when the on-disk record layout changes; readers refuse (and
#: quarantine) records from another format version instead of guessing
ARTIFACT_FORMAT_VERSION = 1

ENV_ENABLE = "REPRO_ARTIFACT_CACHE"
ENV_DIR = "REPRO_ARTIFACT_DIR"

_DEFAULT_DIR = os.path.join(os.path.expanduser("~"), ".cache",
                            "repro-cltune-torch", "artifacts")

#: provenance values a CompiledArtifact may carry
PROVENANCE_FRESH = "fresh"      # compiled in this process, this call
PROVENANCE_STORE = "store"      # answered from the persistent store
PROVENANCE_NONE = "none"        # evaluator had nothing to prepare


@dataclasses.dataclass
class CompiledArtifact:
    """One prepared (compiled) kernel configuration, typed end to end.

    ``payload`` is what the evaluator's ``measure()`` consumes: a live
    ``_CompiledKernel`` for wall-clock timing (never persistable — a
    loaded shared library does not serialize), or a plain
    JSON-serializable dict of compile-time facts (persistable).
    ``stats`` carries the lowered-module numbers worth reporting even
    when the payload is live (compile seconds, flops, bytes).
    """

    #: evaluator family that built it ("wallclock", "costmodel", ...)
    kind: str
    #: content address: ``cuda:<digest>`` of a built CUDA kernel (source,
    #: defines, flags) or ``spec:<digest>`` from :func:`spec_fingerprint`
    fingerprint: str
    #: device-profile key ("" = profile-independent)
    profile: str
    #: what measure() consumes (live callable bundle or JSON dict)
    payload: Any = None
    #: lowered-module stats (flops, bytes, compile_s, ...)
    stats: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: "fresh" (compiled now) | "store" (persistent-cache hit) | "none"
    provenance: str = PROVENANCE_FRESH
    #: trace+lower+compile seconds paid for this artifact *in this
    #: process* (0.0 on a store hit — that is the point)
    compile_s: float = 0.0
    #: True when payload is plain data an ArtifactStore may persist
    persistable: bool = False

    @property
    def key(self) -> Tuple[str, str, str]:
        return (self.kind, self.fingerprint, self.profile)

    @property
    def from_store(self) -> bool:
        return self.provenance == PROVENANCE_STORE

    def to_json(self) -> Dict[str, Any]:
        if not self.persistable:
            raise TypeError(
                f"artifact {self.fingerprint} ({self.kind}) carries a live "
                "payload and cannot be serialized")
        return {
            "format": ARTIFACT_FORMAT_VERSION,
            "kind": self.kind,
            "fingerprint": self.fingerprint,
            "profile": self.profile,
            "payload": self.payload,
            "stats": dict(self.stats),
            "created": time.time(),
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "CompiledArtifact":
        if d.get("format") != ARTIFACT_FORMAT_VERSION:
            raise ValueError(f"artifact format {d.get('format')!r} != "
                             f"{ARTIFACT_FORMAT_VERSION}")
        return cls(kind=d["kind"], fingerprint=d["fingerprint"],
                   profile=d["profile"], payload=d["payload"],
                   stats=dict(d.get("stats") or {}),
                   provenance=PROVENANCE_STORE, compile_s=0.0,
                   persistable=True)


def spec_fingerprint(kernel: str, meta: Optional[Dict[str, Any]],
                     config: Dict[str, Any], extra: str = "") -> str:
    """Content address for evaluators with no build of their own.

    Wall-clock and analytical artifacts are identified by what *built*
    them — kernel name, problem shape (the spec's meta) and the exact
    configuration — rather than by lowered text.  ``extra`` folds in
    evaluator identity that changes the payload (e.g. the RNG seed that
    generated concrete arguments)."""
    blob = json.dumps(
        {"kernel": kernel,
         "meta": {k: repr(v) for k, v in sorted((meta or {}).items())},
         "config": {k: repr(v) for k, v in sorted(config.items())},
         "extra": extra},
        sort_keys=True)
    return f"spec:{hashlib.sha256(blob.encode()).hexdigest()[:32]}"


@dataclasses.dataclass
class StoreStats:
    """Observability counters for one ArtifactStore instance."""

    hits: int = 0               # get()/get_or_compute() answered from disk
    misses: int = 0             # lookups that found no usable record
    puts: int = 0               # records written
    compiles: int = 0           # compute_fn invocations (fleet-local)
    quarantined: int = 0        # corrupted records moved aside
    errors: int = 0             # I/O errors swallowed (store degraded to off)

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class ArtifactStore:
    """Directory-backed, content-addressed store of compile artifacts.

    One JSON file per (kind, fingerprint, profile).  All writes are
    atomic (tmp + ``os.replace``), so readers never observe a torn
    record; a record that *is* unreadable (killed writer predating the
    tmp discipline, disk corruption, foreign garbage) is quarantined to
    ``<name>.corrupt`` and treated as a miss.  :meth:`get_or_compute`
    wraps the compile in a per-artifact cross-process ``flock`` — the
    PR 6 lock discipline — so concurrent workers (threads *or*
    processes) compile each distinct artifact at most once fleet-wide.

    The store is deliberately forgiving: any unexpected I/O error counts
    in ``stats.errors`` and degrades that one operation to a miss, so a
    broken cache volume slows tuning down but never breaks it.
    """

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.stats = StoreStats()
        self._mem: Dict[Tuple[str, str, str], CompiledArtifact] = {}
        self._lock = threading.Lock()

    # -- paths ----------------------------------------------------------------
    @staticmethod
    def _fname(kind: str, fp: str, profile: str) -> str:
        # fingerprints are `scheme:hex`; kind/profile are identifier-ish.
        # Hash anything suspicious rather than trusting it as a path part.
        def safe(s: str) -> str:
            if s and all(c.isalnum() or c in "._-" for c in s):
                return s
            return hashlib.sha256(s.encode()).hexdigest()[:16]
        return f"{safe(kind)}__{safe(fp.replace(':', '-'))}__" \
               f"{safe(profile) or 'any'}.json"

    def path_for(self, kind: str, fingerprint: str, profile: str) -> str:
        return os.path.join(self.root, self._fname(kind, fingerprint, profile))

    # -- read -----------------------------------------------------------------
    def get(self, kind: str, fingerprint: str, profile: str
            ) -> Optional[CompiledArtifact]:
        """Look one artifact up; None = miss (absent, foreign-format, or
        quarantined-corrupt).  A hit is returned with ``provenance="store"``
        and ``compile_s=0``."""
        with self._lock:
            mem = self._mem.get((kind, fingerprint, profile))
        if mem is not None:
            self.stats.hits += 1
            return dataclasses.replace(mem, provenance=PROVENANCE_STORE,
                                       compile_s=0.0)
        path = self.path_for(kind, fingerprint, profile)
        try:
            with open(path, "r") as f:
                raw = json.load(f)
            art = CompiledArtifact.from_json(raw)
            if art.fingerprint != fingerprint or art.profile != profile \
                    or art.kind != kind:
                raise ValueError(
                    f"record at {os.path.basename(path)} addresses "
                    f"({art.kind}, {art.fingerprint}, {art.profile})")
        except FileNotFoundError:
            self.stats.misses += 1
            return None
        except (json.JSONDecodeError, ValueError, KeyError, TypeError) as e:
            self._quarantine(path, e)
            self.stats.misses += 1
            return None
        except OSError as e:
            log.warning("artifacts: read failed for %s (%s)", path, e)
            self.stats.errors += 1
            return None
        self.stats.hits += 1
        with self._lock:
            self._mem[(kind, fingerprint, profile)] = art
        return dataclasses.replace(art)

    def _quarantine(self, path: str, err: Exception) -> None:
        """Move a corrupted record aside so it cannot crash (or shadow)
        every later lookup; the artifact simply gets recompiled."""
        quarantined = path + ".corrupt"
        log.warning("artifacts: quarantining corrupted record %s (%s)",
                    path, err)
        try:
            os.replace(path, quarantined)
        except OSError:
            try:                      # last resort: drop it entirely
                os.unlink(path)
            except OSError:
                pass
        self.stats.quarantined += 1

    # -- write ----------------------------------------------------------------
    def put(self, artifact: CompiledArtifact) -> Optional[str]:
        """Persist one artifact (atomic tmp+replace); returns the path, or
        None when the artifact is not persistable / the write failed."""
        if not artifact.persistable:
            return None
        path = self.path_for(artifact.kind, artifact.fingerprint,
                             artifact.profile)
        try:
            os.makedirs(self.root, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    # strict JSON, same rule as the tuning cache: a payload
                    # carrying Infinity/NaN must fail here, not poison
                    # every future reader
                    json.dump(artifact.to_json(), f, indent=2,
                              sort_keys=True, allow_nan=False)
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        except (OSError, ValueError, TypeError) as e:
            log.warning("artifacts: could not persist %s (%s)",
                        artifact.fingerprint, e)
            self.stats.errors += 1
            return None
        self.stats.puts += 1
        with self._lock:
            self._mem[artifact.key] = dataclasses.replace(artifact)
        return path

    # -- the compile-once protocol --------------------------------------------
    def get_or_compute(self, kind: str, fingerprint: str, profile: str,
                       compute: Callable[[], CompiledArtifact]
                       ) -> CompiledArtifact:
        """Return the stored artifact, or compile-and-store exactly once.

        The fast path is a lock-free read.  On a miss, a per-artifact
        cross-process file lock serializes compilers: the first holder
        compiles and persists, everyone queued behind it re-reads and
        gets a store hit — each distinct artifact is compiled at most
        once across the fleet.  ``compute`` exceptions propagate (a
        failed compile is the caller's typed CompileError, never a
        cached poison record) after the lock is released."""
        art = self.get(kind, fingerprint, profile)
        if art is not None:
            return art
        from .cache import _FileLock       # the PR 6 lock discipline
        lock_path = self.path_for(kind, fingerprint, profile) + ".lock"
        try:
            os.makedirs(self.root, exist_ok=True)
            lock = _FileLock(lock_path)
        except OSError as e:                # unwritable volume: degrade
            log.warning("artifacts: no lock at %s (%s); compiling "
                        "without the store", lock_path, e)
            self.stats.errors += 1
            self.stats.compiles += 1
            return compute()
        with lock:
            art = self.get(kind, fingerprint, profile)
            if art is not None:            # a peer compiled while we queued
                return art
            self.stats.compiles += 1
            art = compute()
            if art.persistable:
                self.put(art)
            return art

    # -- maintenance ----------------------------------------------------------
    def keys(self) -> List[Tuple[str, str, str]]:
        """(kind, fingerprint-filename-part, profile) of every record on
        disk — for reporting; the filename encodes the address."""
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return []
        out = []
        for n in names:
            if not n.endswith(".json"):
                continue
            parts = n[:-len(".json")].split("__")
            if len(parts) == 3:
                out.append((parts[0], parts[1], parts[2]))
        return out

    def __len__(self) -> int:
        return len(self.keys())

    def clear(self) -> None:
        """Remove every record (and stray tmp/lock/corrupt files)."""
        try:
            names = os.listdir(self.root)
        except OSError:
            return
        for n in names:
            if n.endswith((".json", ".tmp", ".lock", ".corrupt")):
                try:
                    os.unlink(os.path.join(self.root, n))
                except OSError:
                    pass
        with self._lock:
            self._mem.clear()


def resolve_store(store: "ArtifactStore | str | None"
                  ) -> Optional[ArtifactStore]:
    """Normalize an artifact-store argument: an instance passes through, a
    string is a root directory, None falls back to the env-gated process
    default (which may itself be None = disabled)."""
    if store is None:
        return default_store()
    if isinstance(store, ArtifactStore):
        return store
    if isinstance(store, str):
        return ArtifactStore(store)
    raise TypeError("artifact_store must be an ArtifactStore, a directory "
                    f"path or None; got {type(store).__name__}: {store!r}")


_default_store: Optional[ArtifactStore] = None
_default_store_lock = threading.Lock()


def default_store() -> Optional[ArtifactStore]:
    """The process-wide store, or None when ``REPRO_ARTIFACT_CACHE`` is
    not enabled.  Re-resolved when the env knobs change so tests can
    monkeypatch them; guarded by a module lock like
    :func:`repro_torch.core.cache.default_cache`."""
    global _default_store
    if not env_bool(ENV_ENABLE, False):
        return None
    root = os.path.abspath(env_str(ENV_DIR, _DEFAULT_DIR))
    with _default_store_lock:
        if _default_store is None or _default_store.root != root:
            _default_store = ArtifactStore(root)
        return _default_store
