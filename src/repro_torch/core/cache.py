"""Persistent tuning-results cache.

CLTune scenario 3 ("the optimal parameters change based on input arguments")
implies a database of best-found configurations keyed by kernel, input shape
and device.  This is that database: a JSON file the framework consults at
run time (``kernels/*/ops.py`` look tuned block sizes up here) and that the
tuner writes into after a search.

Cache format v2:

* keys are ``kernel|shape_key|profile`` with ``\\`` and ``|`` *escaped*
  inside each field, so a user ``shape_key`` containing ``|`` (the
  sharding tuner's does) can neither collide with another entry nor
  produce an unparseable key.  Legacy v1 keys (raw ``|`` joins) are
  migrated on load.
* entries carry an optional structured ``shape`` dict (the problem
  dimensions the entry was tuned for), which powers nearest-shape config
  transfer (:meth:`TuningCache.nearest`).  Entries written before v2
  simply lack the field and load with ``shape=None``.
* entries may carry a ``failures`` count (how many configs failed during
  the search behind this winner); absent means 0 and legacy entries stay
  byte-stable on save.
* entries tuned under a **non-default objective** carry an ``objective``
  spec and live under a 4-field ``kernel|shape_key|profile|obj=<spec>``
  key: winners tuned under different objectives are incomparable, so the
  key itself segregates them (merge keeps them side by side; ``nearest``
  only transfers same-objective winners).  Default (``median_time``)
  entries stay on 3-field keys with no ``objective`` field — byte-stable
  with pre-objective files.

Fleet merge (the distributed-tuning half, :mod:`repro_torch.dtune`): many
workers/replicas tune into *independent* caches that must converge on one
database.  Last-writer-wins is wrong — a replica saving a stale snapshot
would silently erase a better winner another replica just wrote.  Instead:

* :meth:`TuningCache.merge` folds another cache (object, file path or raw
  dict) into this one, keeping the **best finite** ``time_s`` per key,
  unioning ``shape`` information and folding evaluation/failure counts;
* :meth:`TuningCache.save` defaults to ``merge_on_disk=True``: it takes a
  cross-process file lock, re-reads the file, merges it into memory and
  atomically replaces the file — so concurrent savers converge on the
  union-of-best instead of clobbering each other;
* both fire the changed-entry subscribers, so a merged-in winner from
  another process hot-swaps into live serving engines exactly like a
  locally tuned one.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

from .envknobs import env_str
from .metrics import DEFAULT_SPEC, Objective

try:                                    # POSIX: real advisory file locks
    import fcntl
except ImportError:                     # pragma: no cover - non-POSIX hosts
    fcntl = None

log = logging.getLogger("repro_torch.cache")

_DEFAULT_PATH = os.path.join(os.path.dirname(__file__), "..", "tune",
                             "tuned_configs.json")

#: env var overriding where the default cache lives (deployments keep the
#: database outside the source tree; tests point it at a tmp dir)
_ENV_VAR = "REPRO_TUNE_CACHE"


def _default_path() -> str:
    return env_str(_ENV_VAR, _DEFAULT_PATH)


class FileLock:
    """Advisory cross-process lock guarding read-modify-write of one file.

    ``fcntl.flock`` on a sibling ``<path>.lock`` file where available
    (POSIX); elsewhere an ``O_CREAT|O_EXCL`` spin lock with a staleness
    timeout.  The merge-on-disk save path takes it, so two processes
    syncing the same ``tuned_configs.json`` serialize their
    read-merge-replace cycles instead of interleaving them; the artifact
    store, the kernel build (one ``nvcc`` per library across processes)
    and the wall-clock evaluator (one measurement at a time on a card) take
    it too.
    """

    def __init__(self, path: str, timeout_s: float = 30.0,
                 poll_s: float = 0.02):
        self.path = path
        self.timeout_s = timeout_s
        self.poll_s = poll_s
        self._fd: Optional[int] = None
        self._owns_file = False

    def __enter__(self) -> "FileLock":
        if fcntl is not None:
            self._fd = os.open(self.path, os.O_CREAT | os.O_RDWR, 0o644)
            fcntl.flock(self._fd, fcntl.LOCK_EX)
            return self
        deadline = time.monotonic() + self.timeout_s      # pragma: no cover
        while True:
            try:
                self._fd = os.open(self.path,
                                   os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o644)
                self._owns_file = True
                return self
            except FileExistsError:
                if time.monotonic() > deadline:
                    # a crashed holder must not wedge every later save
                    log.warning("cache: breaking stale lock %s", self.path)
                    try:
                        os.unlink(self.path)
                    except OSError:
                        pass
                time.sleep(self.poll_s)

    def __exit__(self, *exc) -> None:
        if self._fd is not None:
            if fcntl is not None:
                fcntl.flock(self._fd, fcntl.LOCK_UN)
            os.close(self._fd)
            self._fd = None
        if self._owns_file:                               # pragma: no cover
            try:
                os.unlink(self.path)
            except OSError:
                pass
            self._owns_file = False


# -- key encoding -------------------------------------------------------------

def _escape_field(field: str) -> str:
    """Escape the key separator (and the escape char itself) in one field."""
    return field.replace("\\", "\\\\").replace("|", "\\|")


#: marker prefix of the optional 4th key field carrying the objective spec
OBJ_PREFIX = "obj="


def normalize_objective(objective: "Objective | str | None"
                         ) -> Optional[str]:
    """Canonical objective spec for cache identity; None ≡ the default
    (``median_time``), which keeps legacy keys and entries byte-stable."""
    if objective is None:
        return None
    spec = str(objective)
    if not spec or spec == DEFAULT_SPEC:
        return None
    # canonicalize through the parser so differently-spelled equal specs
    # share one cache identity (including spellings of the default, e.g.
    # "1*median_time")
    spec = Objective.parse(spec).spec
    return None if spec == DEFAULT_SPEC else spec


def _key(kernel: str, shape_key: str, profile: str,
         objective: "Objective | str | None" = None) -> str:
    """Cache key; non-default objectives get a 4th ``obj=<spec>`` field so
    winners tuned under different objectives can never compare."""
    fields = [kernel, shape_key, profile]
    obj = normalize_objective(objective)
    if obj is not None:
        fields.append(OBJ_PREFIX + obj)
    return "|".join(_escape_field(f) for f in fields)


def split_key(key: str) -> List[str]:
    """Split a cache key on unescaped ``|``, undoing field escaping."""
    fields: List[str] = []
    cur: List[str] = []
    i = 0
    while i < len(key):
        c = key[i]
        if c == "\\" and i + 1 < len(key):
            cur.append(key[i + 1])
            i += 2
        elif c == "|":
            fields.append("".join(cur))
            cur = []
            i += 1
        else:
            cur.append(c)
            i += 1
    fields.append("".join(cur))
    return fields


def _migrate_key(key: str) -> Optional[str]:
    """Re-encode a legacy (v1) raw-join key; None = already canonical.

    v1 joined ``kernel|shape_key|profile`` without escaping, so a shape
    key containing ``|`` produced a key that splits into more than three
    fields.  The kernel name is the first field and the profile the last
    (neither may contain ``|``); everything in between is the shape key.
    A legacy key never contains ``\\|``/``\\\\`` sequences, so three-field
    keys are byte-identical in both formats and need no migration.
    """
    if "\\" in key:
        return None                      # already v2-escaped
    parts = key.split("|")
    if len(parts) <= 3:
        return None
    if parts[-1].startswith(OBJ_PREFIX):
        # a 4-field objective key whose fields happened to need no
        # escaping — canonical, NOT a legacy v1 key (v1 predates
        # objectives, so its last field is always a profile name)
        return None
    return _key(parts[0], "|".join(parts[1:-1]), parts[-1])


# -- shape distance -----------------------------------------------------------

def _numeric_dims(shape: Mapping[str, Any]) -> Dict[str, float]:
    return {d: float(v) for d, v in shape.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)}


def shape_distance(a: Mapping[str, Any], b: Mapping[str, Any]) -> float:
    """Log-space distance between two problem-shape dicts.

    Euclidean distance over the logs of the shared numeric dimensions
    (matrix sizes are scale-quantities: 1024→2048 should be as far as
    512→1024).  Non-numeric shared dimensions (dtype, causal, ...) must
    match exactly — a tuned config for a different dtype is not a
    neighbour.  Dimensions present in only one shape each add a fixed
    penalty so same-family shapes always rank first.  ``inf`` = not
    comparable.
    """
    num_a, num_b = _numeric_dims(a), _numeric_dims(b)
    # a dim only counts as numeric when it is numeric in BOTH shapes; a
    # dim numeric on one side and categorical on the other (int 1 vs
    # bool False) falls through to the exact-match rule below
    shared = [d for d in num_a if d in num_b]
    if not shared:
        return math.inf
    dist2 = 0.0
    for d in a.keys() & b.keys():
        if d in shared:
            va, vb = num_a[d], num_b[d]
            if va <= 0 or vb <= 0:
                if va != vb:             # non-positive dims: exact match only
                    return math.inf
                continue
            dist2 += (math.log(va) - math.log(vb)) ** 2
        elif a[d] != b[d]:
            return math.inf
    unshared = len(set(a) ^ set(b))
    return math.sqrt(dist2) + unshared


@dataclasses.dataclass
class CacheEntry:
    config: Dict[str, Any]
    time_s: float
    strategy: str
    evaluations: int
    timestamp: float
    #: structured problem dimensions this entry was tuned for (v2); None on
    #: entries written before the field existed — those can be looked up by
    #: exact key but cannot participate in nearest-shape transfer
    shape: Optional[Dict[str, Any]] = None
    #: failed configs behind this winner's search (folded on merge); 0 on
    #: entries written before the field existed
    failures: int = 0
    #: canonical spec of the objective this winner was tuned under; None
    #: ≡ the default (``median_time``) — legacy entries stay byte-stable
    objective: Optional[str] = None

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        if d.get("shape") is None:
            del d["shape"]               # keep legacy entries byte-stable
        if not d.get("failures"):
            del d["failures"]            # same: omit the zero default
        if d.get("objective") is None:
            del d["objective"]           # same: None ≡ median_time
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "CacheEntry":
        # tolerate missing optional fields: v1 files carry no ``shape``
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name in d:
                kwargs[f.name] = d[f.name]
            elif f.default is dataclasses.MISSING:
                raise KeyError(f.name)
            else:
                kwargs[f.name] = f.default
        return cls(**kwargs)


class TuningCache:
    """Thread-safe JSON-backed map: (kernel, shape, profile) -> best config.

    Every access — reads included — holds the lock: concurrent tuning
    sessions ``put`` from worker threads while ops look configs up, and an
    unlocked ``get``/``entries``/``len`` would race the lazy first load
    and in-place mutation.  The lock is re-entrant so the lazy
    ``_ensure_loaded`` can run inside any public method without the old
    double-lock dance.

    The JSON on disk is *strict* (``allow_nan=False``): a ``time_s`` of
    ``Infinity``/``NaN`` is not valid JSON and breaks every non-Python
    consumer, so non-finite entries are refused at :meth:`record`/:meth:`put`
    time and rejected again at :meth:`save` time as defense in depth.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = os.path.abspath(path or _default_path())
        self._lock = threading.RLock()
        self._data: Dict[str, Dict[str, Any]] = {}
        self._loaded = False
        #: changed-entry subscribers: fn(key, CacheEntry), called after a
        #: successful put() (see subscribe())
        self._subscribers: List[Callable[[str, "CacheEntry"], None]] = []
        #: memoized (kernel, profile, objective) -> [(key, decoded entry
        #: with shape)]; None = stale, rebuilt by the next nearest()
        self._shape_index: Optional[
            Dict[Tuple[str, str, Optional[str]],
                 List[Tuple[str, CacheEntry]]]] = None

    # -- persistence ---------------------------------------------------------
    @staticmethod
    def _sanitize(data: Dict[str, Any]) -> Dict[str, Any]:
        """Normalize raw file/peer data in place: drop malformed and
        non-finite entries, migrate legacy (v1) raw-join keys."""
        # entries must be objects with a finite numeric time_s: files
        # written before the strict-JSON change may carry Infinity/NaN
        # (json.load accepts them), and a merge peer may hand us garbage —
        # drop both here so save(), which refuses non-finite values,
        # cannot crash on foreign poison and lose the fresh results
        bad = [k for k, v in data.items()
               if not isinstance(v, dict)
               or not isinstance(v.get("time_s"), (int, float))
               or isinstance(v.get("time_s"), bool)
               or not math.isfinite(v["time_s"])]
        for k in bad:
            log.warning("cache: dropping malformed/non-finite entry %r", k)
            del data[k]
        # v1 keys joined fields with raw "|": a shape_key containing
        # the separator is unparseable (and can collide with a v2
        # escaped key), so re-encode it under the escaped form
        for k in [k for k in data if _migrate_key(k) is not None]:
            new = _migrate_key(k)
            if new in data:
                log.warning("cache: legacy key %r collides with %r; "
                            "keeping the existing entry", k, new)
            else:
                log.info("cache: migrating legacy key %r -> %r", k, new)
                data[new] = data[k]
            del data[k]
        return data

    def _read_file(self) -> Dict[str, Any]:
        with open(self.path, "r") as f:
            return self._sanitize(json.load(f))

    def _load_locked(self) -> None:
        if os.path.exists(self.path):
            self._data = self._read_file()
        self._loaded = True
        self._shape_index = None

    def _ensure_loaded(self) -> None:
        if not self._loaded:
            self._load_locked()

    def load(self) -> "TuningCache":
        with self._lock:
            self._load_locked()
        return self

    def _write_locked(self) -> None:
        # atomic write: temp file + rename, same discipline as checkpoints
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(self.path),
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                # strict JSON: raise rather than emit Infinity/NaN
                json.dump(self._data, f, indent=2, sort_keys=True,
                          allow_nan=False)
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def save(self, merge_on_disk: bool = True) -> None:
        """Persist the cache.

        With ``merge_on_disk`` (the default) the write is a synchronized
        read-merge-replace: take the cross-process file lock, re-read the
        file, fold it into memory under the best-finite-time-per-key rule
        and atomically replace the file.  Entries another process wrote
        since our load are *kept* (and folded into memory), so concurrent
        savers converge on the union-of-best instead of the last writer
        silently erasing the others — the failure mode the old
        whole-dict dump had.  Changed-entry subscribers fire for every
        entry the disk merge improved or added (the fleet-propagation
        hook).  ``merge_on_disk=False`` is the legacy overwrite (used by
        tests and explicit wipes after :meth:`clear`).
        """
        changed: Dict[str, CacheEntry] = {}
        with self._lock:
            self._ensure_loaded()
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            if merge_on_disk:
                with FileLock(self.path + ".lock"):
                    if os.path.exists(self.path):
                        changed = self._merge_locked(self._read_file())
                    self._write_locked()
            else:
                self._write_locked()
            subscribers = list(self._subscribers)
        self._notify(changed, subscribers)

    # -- merge ----------------------------------------------------------------
    @staticmethod
    def _fold(mine: Dict[str, Any], theirs: Dict[str, Any]
              ) -> Optional[Dict[str, Any]]:
        """Fold two raw entries for one key; None = ``mine`` stands.

        Last-writer-wins is wrong here: the rule is best-finite-``time_s``
        per key.  The loser still contributes what it knows — a structured
        ``shape`` the winner lacks (union), and its evaluation/failure
        counts, which are *summed* when the two entries describe different
        search results (total fleet effort behind the surviving winner)
        but *maxed* when they describe the same result (so re-merging the
        same file over and over stays idempotent instead of inflating the
        counters on every sync).
        """
        if mine == theirs:
            return None
        if (mine.get("objective") or None) != (theirs.get("objective") or None):
            # winners tuned under different objectives are incomparable —
            # a p99 winner must never beat a median winner on raw time_s.
            # The key normally segregates objectives, so reaching here
            # means a hand-edited or corrupted entry: keep ours, warn.
            log.warning(
                "cache: refusing to fold entries tuned under different "
                "objectives (%r vs %r); keeping the existing entry",
                mine.get("objective"), theirs.get("objective"))
            return None
        win, lose = ((mine, theirs) if mine["time_s"] <= theirs["time_s"]
                     else (theirs, mine))
        out = dict(win)
        same_result = (win.get("config") == lose.get("config")
                       and win["time_s"] == lose["time_s"])
        fold = max if same_result else (lambda a, b: a + b)
        out["evaluations"] = fold(int(win.get("evaluations") or 0),
                                  int(lose.get("evaluations") or 0))
        failures = fold(int(win.get("failures") or 0),
                        int(lose.get("failures") or 0))
        if failures:
            out["failures"] = failures
        elif "failures" in out:
            del out["failures"]
        if out.get("shape") is None and lose.get("shape") is not None:
            out["shape"] = lose["shape"]          # union shape knowledge
        out["timestamp"] = max(win.get("timestamp") or 0,
                               lose.get("timestamp") or 0)
        return None if out == mine else out

    def _merge_locked(self, incoming: Dict[str, Any]
                      ) -> Dict[str, CacheEntry]:
        """Fold sanitized raw ``incoming`` into ``self._data``; returns the
        entries that changed (added or improved), decoded."""
        changed: Dict[str, CacheEntry] = {}
        for key, theirs in incoming.items():
            mine = self._data.get(key)
            merged = dict(theirs) if mine is None else self._fold(mine, theirs)
            if merged is None:
                continue
            self._data[key] = merged
            # only an actual winner change matters to subscribers (count
            # folding alone does not swap any serving config)
            if mine is None or merged.get("config") != mine.get("config") \
                    or merged.get("time_s") != mine.get("time_s"):
                changed[key] = CacheEntry.from_json(merged)
        if changed:
            self._shape_index = None
        return changed

    def merge(self, other: "Union[TuningCache, str, Mapping[str, Any]]"
              ) -> Dict[str, CacheEntry]:
        """Fold another cache into this one (in memory; call :meth:`save`
        to persist).  ``other`` is a :class:`TuningCache`, a path to a
        cache JSON file, or a raw ``{key: entry}`` mapping.  Per key the
        best finite ``time_s`` wins, shapes are unioned and
        evaluation/failure counts folded (see :meth:`_fold`); subscribers
        fire for every changed entry, so merged-in fleet winners reach
        live serving engines like locally tuned ones.  Returns the
        changed entries."""
        if isinstance(other, TuningCache):
            with other._lock:
                other._ensure_loaded()
                incoming = {k: dict(v) for k, v in other._data.items()}
            incoming = self._sanitize(incoming)
        elif isinstance(other, str):
            if not os.path.exists(other):
                raise FileNotFoundError(f"no cache file at {other!r}")
            with open(other, "r") as f:
                incoming = self._sanitize(json.load(f))
        elif isinstance(other, Mapping):
            incoming = self._sanitize(
                {k: dict(v) if isinstance(v, Mapping) else v
                 for k, v in other.items()})
        else:
            raise TypeError("merge() takes a TuningCache, a path or a "
                            f"mapping, got {type(other).__name__}")
        with self._lock:
            self._ensure_loaded()
            changed = self._merge_locked(incoming)
            subscribers = list(self._subscribers)
        self._notify(changed, subscribers)
        return changed

    def _notify(self, changed: Dict[str, CacheEntry],
                subscribers: List[Callable[[str, "CacheEntry"], None]]
                ) -> None:
        """Fire subscribers outside the lock (same contract as put())."""
        if not changed:
            return
        for key, entry in changed.items():
            for fn in subscribers:
                try:
                    fn(key, entry)
                except Exception:  # noqa: BLE001 — a bad subscriber must not
                    log.exception("cache: change subscriber %r failed", fn)

    # -- access ---------------------------------------------------------------
    def get(self, kernel: str, shape_key: str, profile: str,
            objective: "Objective | str | None" = None
            ) -> Optional[CacheEntry]:
        with self._lock:
            self._ensure_loaded()
            raw = self._data.get(_key(kernel, shape_key, profile, objective))
        return CacheEntry.from_json(raw) if raw else None

    def put(self, kernel: str, shape_key: str, profile: str,
            entry: CacheEntry, only_if_better: bool = True,
            objective: "Objective | str | None" = None) -> bool:
        if not math.isfinite(entry.time_s):
            log.warning("cache: refusing non-finite time_s=%r for %s",
                        entry.time_s, _key(kernel, shape_key, profile))
            return False
        # the entry's recorded objective and the key's objective field must
        # agree — the explicit kwarg wins, else the entry's own field
        obj = normalize_objective(
            objective if objective is not None else entry.objective)
        if (entry.objective or None) != obj:
            entry = dataclasses.replace(entry, objective=obj)
        k = _key(kernel, shape_key, profile, obj)
        with self._lock:
            self._ensure_loaded()
            old = self._data.get(k)
            if old and (old.get("objective") or None) != obj:
                log.warning(
                    "cache: refusing to overwrite %s (tuned under objective "
                    "%r) with a winner tuned under %r", k,
                    old.get("objective"), obj)
                return False
            if only_if_better and old and old["time_s"] <= entry.time_s:
                return False
            self._data[k] = entry.to_json()
            self._shape_index = None
            subscribers = list(self._subscribers)
        # notify outside the lock: a subscriber may itself read the cache
        # (or take other locks) without deadlocking a concurrent writer
        for fn in subscribers:
            try:
                fn(k, entry)
            except Exception:  # noqa: BLE001 — a bad subscriber must not
                log.exception("cache: change subscriber %r failed", fn)
        return True

    # -- change notification ---------------------------------------------------
    def subscribe(self, fn: Callable[[str, CacheEntry], None]) -> None:
        """Register ``fn(key, entry)`` to run after every successful
        :meth:`put` (and hence :meth:`record`).  Callbacks fire on the
        *writer's* thread, outside the cache lock — the online-tuning
        hot-swap path listens here so a background winner landing in the
        cache reaches live serving engines without polling.  Exceptions
        in a subscriber are logged and swallowed."""
        with self._lock:
            self._subscribers.append(fn)

    def unsubscribe(self, fn: Callable[[str, CacheEntry], None]) -> bool:
        """Remove a subscriber; returns False when it was not registered."""
        with self._lock:
            try:
                self._subscribers.remove(fn)
                return True
            except ValueError:
                return False

    def entries(self) -> Dict[str, CacheEntry]:
        with self._lock:
            self._ensure_loaded()
            snapshot = dict(self._data)
        return {k: CacheEntry.from_json(v) for k, v in snapshot.items()}

    def trial_dataset(self, kernel: str,
                      profile: Optional[str] = None,
                      objective: "Objective | str | None" = None
                      ) -> List[Dict[str, Any]]:
        """Measured-trial rows for training a learned predictor.

        Returns ``[{"shape", "config", "time_s"}, ...]`` from every entry
        of ``kernel`` that carries a structured shape, a finite time, and
        matches ``profile`` / ``objective`` (both meaning "any" when
        None / "this one only" when given — objective identity follows
        :func:`normalize_objective`, so the default spec matches legacy
        unscoped entries).  Pre-v2 entries without a shape are skipped:
        a row without features cannot train anything.
        """
        want_obj = normalize_objective(objective)
        rows: List[Dict[str, Any]] = []
        for key, entry in sorted(self.entries().items()):
            fields = split_key(key)
            if len(fields) < 3 or fields[0] != kernel:
                continue
            if profile is not None and fields[2] != profile:
                continue
            entry_obj = normalize_objective(entry.objective)
            if objective is not None and entry_obj != want_obj:
                continue
            if not entry.shape or not math.isfinite(entry.time_s):
                continue
            rows.append({"shape": dict(entry.shape),
                         "config": dict(entry.config),
                         "time_s": float(entry.time_s)})
        return rows

    def record(self, kernel: str, shape_key: str, profile: str,
               config: Dict[str, Any], time_s: float, strategy: str,
               evaluations: int,
               shape: Optional[Mapping[str, Any]] = None,
               failures: int = 0,
               objective: "Objective | str | None" = None) -> bool:
        """Record a tuning winner; refuses non-finite times (a failed tune
        must never poison the cache other tools parse).  ``shape`` is the
        structured problem-dimension dict that makes the entry eligible
        for nearest-shape transfer; ``failures`` how many configs failed
        during the search behind this winner (folded on fleet merge);
        ``objective`` the objective it was tuned under (non-default
        objectives get their own key namespace — a p99 winner can never
        displace or be compared against a median winner)."""
        if not math.isfinite(time_s):
            log.warning("cache: refusing to record non-finite time_s=%r "
                        "for kernel=%r shape=%r", time_s, kernel, shape_key)
            return False
        return self.put(kernel, shape_key, profile, CacheEntry(
            config=config, time_s=time_s, strategy=strategy,
            evaluations=evaluations, timestamp=time.time(),
            shape=dict(shape) if shape is not None else None,
            failures=int(failures),
            objective=normalize_objective(objective)))

    # -- shape transfer --------------------------------------------------------
    def _shape_bucket(self, kernel: str, profile: str,
                      objective: Optional[str] = None
                      ) -> List[Tuple[str, CacheEntry]]:
        """Decoded shape-carrying entries for (kernel, profile, objective),
        memoized.

        The serve-path transfer lookup calls :meth:`nearest` on every
        cache miss; re-decoding the whole file each time is O(N) JSON
        work per lookup.  The index is invalidated (set to None) on
        put/load/merge/clear and rebuilt lazily here.  Buckets are never
        mutated in place, so a caller holding one across an invalidation
        still sees a consistent snapshot.  Buckets are objective-pure:
        a default-objective lookup only ever sees 3-field keys, a p99
        lookup only ``obj=p99_time`` keys — nearest-shape transfer never
        compares winners tuned under different objectives.
        """
        with self._lock:
            self._ensure_loaded()
            if self._shape_index is None:
                self._shape_index = {}
            bucket = self._shape_index.get((kernel, profile, objective))
            if bucket is None:
                bucket = []
                for key, raw in self._data.items():
                    fields = split_key(key)
                    if len(fields) == 3:
                        key_obj = None
                    elif (len(fields) == 4
                          and fields[3].startswith(OBJ_PREFIX)):
                        key_obj = fields[3][len(OBJ_PREFIX):]
                    else:
                        continue
                    if fields[0] != kernel or fields[2] != profile \
                            or key_obj != objective:
                        continue
                    entry = CacheEntry.from_json(raw)
                    if entry.shape is not None:
                        bucket.append((key, entry))
                self._shape_index[(kernel, profile, objective)] = bucket
            return bucket

    def nearest(self, kernel: str, shape: Mapping[str, Any], profile: str,
                k: int = 3,
                objective: "Objective | str | None" = None
                ) -> List[CacheEntry]:
        """The ``k`` tuned entries for (kernel, profile) nearest to ``shape``,
        among winners tuned under the same ``objective`` only.

        Ordered by :func:`shape_distance` (log-space over shared numeric
        dims), nearest first; an exact-shape entry sorts first with
        distance 0.  Entries without a structured ``shape`` (pre-v2) and
        entries at infinite distance (no shared dims / mismatched
        non-numeric dims) are excluded.  Served from a per-(kernel,
        profile, objective) memoized index; returned entries are copies,
        safe to mutate.
        """
        obj = normalize_objective(objective)
        scored: List[Tuple[float, str, CacheEntry]] = []
        for key, entry in self._shape_bucket(kernel, profile, obj):
            d = shape_distance(shape, entry.shape)
            if math.isfinite(d):
                scored.append((d, key, entry))
        scored.sort(key=lambda t: (t[0], t[1]))
        # hand out copies: the index memoizes these objects, and a caller
        # mutating e.config (warm-start seeds do) must not poison it
        return [dataclasses.replace(
                    e, config=dict(e.config),
                    shape=dict(e.shape) if e.shape is not None else None)
                for _, _, e in scored[:max(0, k)]]

    def clear(self, delete_file: bool = False) -> None:
        """Drop all in-memory entries; optionally unlink the backing file.

        NB: without ``delete_file``, a later ``save()`` (which merges the
        disk state back in by default) resurrects the file's entries —
        pass ``delete_file=True`` or ``save(merge_on_disk=False)`` for a
        true wipe."""
        with self._lock:
            self._data = {}
            self._loaded = True
            self._shape_index = None
            if delete_file and os.path.exists(self.path):
                os.unlink(self.path)

    def __len__(self) -> int:
        with self._lock:
            self._ensure_loaded()
            return len(self._data)


_default_cache: Optional[TuningCache] = None
_default_cache_lock = threading.Lock()


def default_cache() -> TuningCache:
    """The process-wide cache.  Re-resolved when REPRO_TUNE_CACHE changes,
    so tests can monkeypatch the env var and get a fresh isolated cache.
    Guarded by a module lock: two threads resolving simultaneously must
    share ONE TuningCache (its internal RLock is what makes concurrent
    put/get safe — two objects for one path would race on the file)."""
    global _default_cache
    path = os.path.abspath(_default_path())
    with _default_cache_lock:
        if _default_cache is None or _default_cache.path != path:
            _default_cache = TuningCache(path)
        return _default_cache
