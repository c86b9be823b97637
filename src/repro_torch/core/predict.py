"""Unified prediction layer: one typed interface over every config oracle.

The twin of the JAX package's ``repro/core/predict.py``, NumPy only.
Three prediction paths exist — static per-kernel heuristics
(``kernels/*/ops.py``), the analytical model
(``TunableKernel.analytical_model``) and nearest-shape cache transfer
(:meth:`TuningCache.nearest`).  This module puts them behind a single
:class:`Predictor` protocol so the engine, registry, serving plane and
distributed workers can consume *any* of them interchangeably:

  ``rank(configs, shape, profile) -> scores``
      Predicted objective per config (lower = better).  Used by the
      engine to order each strategy ``ask()`` batch predictor-first.
  ``suggest(shape, profile, k) -> configs``
      Best-guess configs for a shape never tuned before (cold start).
      Used by :func:`registry.lookup_resolved` as the PREDICTED step in
      the fallback chain exact -> transfer -> predicted -> heuristic.
  ``feasible(config, shape, profile) -> prob``
      Probability the config will compile + run at all.  Used by the
      engine to skip predicted-infeasible configs before compile.

Adapters wrap the legacy paths (:class:`HeuristicPredictor`,
:class:`CostModelPredictor`, :class:`TransferPredictor`) and
:class:`LearnedPredictor` adds the ML performance model of Falch &
Elster (PAPERS.md): a small pure-NumPy ridge regressor over encoded
(config x shape x DeviceProfile) features, pretrained on cost-model
pseudo-labels and fine-tuned on measured trials, plus a separate
infeasibility classifier.  Its device features are the Hopper limits
of the :class:`~repro_torch.core.profiles.DeviceProfile` (float32 peak,
memory bandwidth, opt-in shared memory per block, SM count).  Models
persist through the :class:`~repro_torch.core.artifacts.ArtifactStore`
under kind ``predictor``,
keyed by kernel + profile + objective + training-set fingerprint, so a
stale training set invalidates the stored model automatically.

Env knobs (strict parsing via :mod:`repro_torch.core.envknobs`):
  REPRO_PREDICTOR       default predictor kind
                        (off|heuristic|costmodel|transfer|learned; default off)
  REPRO_PREDICT_PRUNE   enable predicted-infeasible pruning in the engine
                        (strict bool; default off)
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
from typing import (Any, Dict, List, Mapping, Optional, Protocol, Sequence,
                    Tuple, runtime_checkable)

import numpy as np

from .artifacts import ArtifactStore, CompiledArtifact
from .envknobs import env_bool, env_str
from .metrics import Objective
from .profiles import DeviceProfile, resolve_profile
from .space import Config, SearchSpace
from .strategies import project_feasible, usable_seeds

log = logging.getLogger("repro_torch.predict")

ENV_PREDICTOR = "REPRO_PREDICTOR"
ENV_PRUNE = "REPRO_PREDICT_PRUNE"

#: predictor kinds accepted by :func:`make_predictor` / REPRO_PREDICTOR
PREDICTOR_KINDS = ("off", "heuristic", "costmodel", "transfer", "learned")

#: artifact kind under which trained predictors persist
PREDICTOR_ARTIFACT_KIND = "predictor"


@runtime_checkable
class Predictor(Protocol):
    """What every prediction backend must provide.

    Scores returned by :meth:`rank` are *predicted objectives* — lower is
    better, ``math.inf`` means predicted-infeasible.  Implementations
    must never raise on unseen configs; return a neutral score instead.
    """

    name: str

    def rank(self, configs: Sequence[Config], shape: Mapping[str, Any],
             profile: Optional[DeviceProfile]) -> List[float]:
        """Predicted objective per config (lower = better)."""
        ...

    def suggest(self, shape: Mapping[str, Any],
                profile: Optional[DeviceProfile],
                k: int = 1) -> List[Config]:
        """Up to ``k`` best-guess configs for a fresh shape."""
        ...

    def feasible(self, config: Config, shape: Mapping[str, Any],
                 profile: Optional[DeviceProfile]) -> float:
        """P(config compiles and runs), in [0, 1]."""
        ...


def _space_for(kernel, shape: Mapping[str, Any],
               extended: bool = False) -> Optional[SearchSpace]:
    try:
        return kernel.make_space(dict(shape), extended=extended)
    except Exception:  # noqa: BLE001 — a broken space must not kill prediction
        return None


def _candidate_pool(space: SearchSpace, limit: int) -> List[Config]:
    """Up to ``limit`` candidate configs for suggest() scoring.

    Small spaces are enumerated whole; a space larger than ``limit`` is
    *sampled* (deterministically) instead of truncated — the enumeration
    prefix of a big space holds the first parameter at its first value,
    which would silently bias every suggestion.
    """
    card = space.cardinality()
    if card <= limit:
        return space.enumerate(limit=limit)
    import random as _random
    return space.sample_unique(_random.Random(0), limit)


class HeuristicPredictor:
    """Adapter over the per-kernel static heuristic declarations.

    Ranks configs by index-distance from the (feasibility-projected)
    heuristic config: the heuristic's pick scores 0, neighbours score by
    how many value-steps away they are.
    """

    def __init__(self, kernel, *, extended: bool = False):
        self.kernel = kernel
        self.extended = bool(extended)
        self.name = f"heuristic:{kernel.name}"

    def _anchor(self, shape: Mapping[str, Any]) -> Tuple[Optional[Config],
                                                         Optional[SearchSpace]]:
        space = _space_for(self.kernel, shape, self.extended)
        if space is None or self.kernel.heuristic is None:
            return None, space
        try:
            cfg = dict(self.kernel.heuristic(dict(shape)))
        except Exception:  # noqa: BLE001
            return None, space
        projected = project_feasible(space, cfg)
        return (projected if projected is not None else cfg), space

    def rank(self, configs, shape, profile):
        anchor, space = self._anchor(shape)
        if anchor is None or space is None:
            return [0.0] * len(configs)
        scores = []
        for cfg in configs:
            d = 0.0
            for p in space.parameters:
                try:
                    d += abs(p.index_of(cfg[p.name]) -
                             p.index_of(anchor[p.name]))
                except (KeyError, ValueError):
                    d += len(p.values)
            scores.append(d)
        return scores

    def suggest(self, shape, profile, k: int = 1):
        anchor, _ = self._anchor(shape)
        return [anchor] if anchor is not None and k > 0 else []

    def feasible(self, config, shape, profile):
        space = _space_for(self.kernel, shape, self.extended)
        if space is None:
            return 1.0
        try:
            return 1.0 if space.is_feasible(dict(config)) else 0.0
        except KeyError:
            return 0.0


class CostModelPredictor:
    """Adapter over ``TunableKernel.analytical_model``.

    Also serves as the pseudo-label source for
    :meth:`LearnedPredictor.pretrain`.
    """

    #: cap on configs enumerated per suggest() call
    SUGGEST_LIMIT = 2048

    def __init__(self, kernel, profile: Optional[DeviceProfile] = None, *,
                 extended: bool = False):
        if kernel.analytical_model is None:
            raise ValueError(
                f"kernel {kernel.name!r} declares no analytical_model; "
                "CostModelPredictor needs one")
        self.kernel = kernel
        self.profile = resolve_profile(profile)
        self.extended = bool(extended)
        self.name = f"costmodel:{kernel.name}"

    def _time(self, shape, config, profile) -> float:
        prof = profile or self.profile
        try:
            return float(self.kernel.analytical_model(dict(shape),
                                                      dict(config), prof))
        except Exception:  # noqa: BLE001 — model bugs read as infeasible
            return math.inf

    def rank(self, configs, shape, profile):
        return [self._time(shape, c, profile) for c in configs]

    def suggest(self, shape, profile, k: int = 1):
        space = _space_for(self.kernel, shape, self.extended)
        if space is None or k <= 0:
            return []
        pool = _candidate_pool(space, self.SUGGEST_LIMIT)
        scored = sorted(((self._time(shape, c, profile), i, c)
                         for i, c in enumerate(pool)),
                        key=lambda t: (t[0], t[1]))
        return [c for t, _, c in scored[:k] if math.isfinite(t)]

    def feasible(self, config, shape, profile):
        return 1.0 if math.isfinite(self._time(shape, config, profile)) else 0.0


class TransferPredictor:
    """Adapter over nearest-shape cache transfer (``cache.nearest``).

    ``profile`` names the cache entries to transfer from when a caller
    passes none (the engine does, for an evaluator with no modeled
    device); None = the current CUDA device's."""

    def __init__(self, kernel, cache, *, k_nearest: int = 3,
                 objective: "Objective | str | None" = None,
                 extended: bool = False,
                 profile: Optional[DeviceProfile] = None):
        self.kernel = kernel
        self.cache = cache
        self.profile = profile
        self.k_nearest = int(k_nearest)
        self.objective = objective
        self.extended = bool(extended)
        self.name = f"transfer:{kernel.name}"

    def _pool(self, shape, profile) -> List[Config]:
        space = _space_for(self.kernel, shape, self.extended)
        if space is None or self.cache is None:
            return []
        prof = (profile.name if isinstance(profile, DeviceProfile)
                else (profile or resolve_profile(self.profile).name))
        entries = self.cache.nearest(self.kernel.name, dict(shape), prof,
                                     k=self.k_nearest,
                                     objective=self.objective,
                                     defaults=self.kernel.shape_defaults)
        return usable_seeds(space, [e.config for e in entries])

    def rank(self, configs, shape, profile):
        pool = self._pool(shape, profile)
        keys = {json.dumps(c, sort_keys=True, default=str): r
                for r, c in enumerate(pool)}
        return [float(keys.get(json.dumps(dict(c), sort_keys=True,
                                          default=str), len(pool)))
                for c in configs]

    def suggest(self, shape, profile, k: int = 1):
        return self._pool(shape, profile)[:max(0, k)]

    def feasible(self, config, shape, profile):
        space = _space_for(self.kernel, shape, self.extended)
        if space is None:
            return 1.0
        try:
            return 1.0 if space.is_feasible(dict(config)) else 0.0
        except KeyError:
            return 0.0


# ---------------------------------------------------------------------------
# learned performance model
# ---------------------------------------------------------------------------

def _encode_value(v: Any) -> float:
    """One scalar per config value: log2 for numerics, 0/1 for bools,
    a stable hash bucket for categoricals."""
    if isinstance(v, bool):
        return 1.0 if v else 0.0
    if isinstance(v, (int, float)) and math.isfinite(float(v)):
        return math.log2(1.0 + abs(float(v)))
    h = hashlib.sha256(repr(v).encode()).digest()
    return (h[0] % 16) / 16.0


def _numeric_dims(shape: Mapping[str, Any]) -> List[str]:
    return sorted(n for n, v in shape.items()
                  if isinstance(v, (int, float)) and not isinstance(v, bool))


def training_fingerprint(rows: Sequence[Mapping[str, Any]]) -> str:
    """Order-insensitive digest of a training set (shape/config/time rows).

    Feeding a changed dataset produces a different fingerprint, which is
    what invalidates a stored predictor artifact.
    """
    canon = sorted(json.dumps(dict(r), sort_keys=True, default=str)
                   for r in rows)
    return hashlib.sha256("\n".join(canon).encode()).hexdigest()[:32]


class LearnedPredictor:
    """Small learned performance model (Falch & Elster-style surrogate).

    A weighted ridge regressor on log-time over encoded
    (config x shape x profile) features, plus a second ridge head used as
    an infeasibility classifier.  Two-stage training:

      :meth:`pretrain`  — cheap pseudo-labels from the analytical model
                          (weight 1 per row);
      :meth:`finetune`  — measured trials harvested from the cache or the
                          engine tell history (weight 10 per row), so
                          real silicon overrides the model where they
                          disagree.

    Pure NumPy; fitting is a single linear solve, cheap enough to run in
    the serving path.
    """

    PRETRAIN_WEIGHT = 1.0
    FINETUNE_WEIGHT = 10.0
    RIDGE_LAMBDA = 1e-3

    def __init__(self, kernel, profile: Optional[DeviceProfile] = None,
                 objective: "Objective | str | None" = None, *,
                 extended: bool = False):
        self.kernel = kernel
        self.profile = resolve_profile(profile)
        self.objective = (Objective.coerce(objective).spec
                          if objective is not None else None)
        self.extended = bool(extended)
        self.name = f"learned:{kernel.name}"
        self._param_names: List[str] = []
        self._shape_names: List[str] = []
        self._theta: Optional[np.ndarray] = None        # regression weights
        self._theta_infeasible: Optional[np.ndarray] = None
        self._rows: List[Dict[str, Any]] = []           # pretrain pseudo-rows
        self._measured: List[Dict[str, Any]] = []       # finetuned rows
        self.training_fingerprint: str = training_fingerprint([])

    # -- featurization ------------------------------------------------------

    def _feature_names_from(self, rows: Sequence[Mapping[str, Any]]) -> None:
        params: set = set()
        dims: set = set()
        for r in rows:
            params.update(r["config"].keys())
            dims.update(_numeric_dims(r["shape"]))
        self._param_names = sorted(params)
        self._shape_names = sorted(dims)

    def _features(self, config: Mapping[str, Any],
                  shape: Mapping[str, Any],
                  profile: Optional[DeviceProfile]) -> np.ndarray:
        prof = profile or self.profile
        cvec = [_encode_value(config.get(n, 0)) for n in self._param_names]
        svec = [math.log2(1.0 + abs(float(shape.get(n, 0) or 0)))
                for n in self._shape_names]
        pvec = [math.log2(max(prof.peak_f32_flops, 2.0)),
                math.log2(max(prof.hbm_bw, 2.0)),
                math.log2(max(prof.smem_per_block_optin, 2.0)),
                prof.sm_count / 132.0]
        cross = [c * s for c in cvec for s in svec]
        return np.asarray([1.0] + cvec + svec + pvec + cross)

    # -- training -----------------------------------------------------------

    def _fit(self) -> None:
        rows = self._rows + self._measured
        if not rows:
            return
        self._feature_names_from(rows)
        X, y_t, w_t, y_f, w_f, ok_mask = [], [], [], [], [], []
        for r in rows:
            x = self._features(r["config"], r["shape"], self.profile)
            X.append(x)
            w = float(r.get("weight", 1.0))
            t = float(r["time_s"])
            bad = not math.isfinite(t) or t <= 0.0
            ok_mask.append(not bad)
            y_f.append(1.0 if bad else 0.0)
            w_f.append(w)
            if not bad:
                y_t.append(math.log(t))
                w_t.append(w)
        Xa = np.asarray(X)
        self._theta_infeasible = self._ridge(Xa, np.asarray(y_f),
                                             np.asarray(w_f))
        if y_t:
            self._theta = self._ridge(Xa[np.asarray(ok_mask)],
                                      np.asarray(y_t), np.asarray(w_t))

    @classmethod
    def _ridge(cls, X: np.ndarray, y: np.ndarray,
               w: np.ndarray) -> np.ndarray:
        d = X.shape[1]
        Xw = X * w[:, None]
        A = X.T @ Xw + cls.RIDGE_LAMBDA * np.eye(d)
        b = Xw.T @ y
        return np.linalg.solve(A, b)

    def pretrain(self, shapes: Sequence[Mapping[str, Any]],
                 limit: int = 256, seed: int = 0) -> int:
        """Label up to ``limit`` configs per shape with the analytical model."""
        if self.kernel.analytical_model is None:
            return 0
        import random as _random
        added = 0
        for shape in shapes:
            space = _space_for(self.kernel, shape, self.extended)
            if space is None:
                continue
            pool = space.sample_unique(_random.Random(seed), limit)
            for cfg in pool:
                try:
                    t = float(self.kernel.analytical_model(
                        dict(shape), dict(cfg), self.profile))
                except Exception:  # noqa: BLE001
                    t = math.inf
                self._rows.append({"shape": dict(shape), "config": dict(cfg),
                                   "time_s": t,
                                   "weight": self.PRETRAIN_WEIGHT})
                added += 1
        self._refresh()
        return added

    def finetune(self, rows: Sequence[Any],
                 shape: Optional[Mapping[str, Any]] = None) -> int:
        """Fold in measured trials: ``{"shape", "config", "time_s"}`` rows,
        or a search's :class:`~repro_torch.core.strategies.Trial`\\ s (a
        tuning outcome's ``result.trials``) measured at ``shape``.

        The cache keeps one winner per tuned shape, so a search's own
        trials — failed ones included, as infeasible rows — are what gives
        the model more than one measured row per shape."""
        added = 0
        for r in rows:
            if not isinstance(r, Mapping):
                r = {"config": r.config, "time_s": r.time}
            row_shape = r.get("shape", shape)
            if row_shape is None:
                raise ValueError("finetune: a row without a shape needs "
                                 "shape=")
            self._measured.append({"shape": dict(row_shape),
                                   "config": dict(r["config"]),
                                   "time_s": float(r["time_s"]),
                                   "weight": self.FINETUNE_WEIGHT})
            added += 1
        self._refresh()
        return added

    def _refresh(self) -> None:
        self.training_fingerprint = training_fingerprint(
            [{k: r[k] for k in ("shape", "config", "time_s")}
             for r in self._rows + self._measured])
        self._fit()

    @property
    def trained(self) -> bool:
        return self._theta is not None

    # -- Predictor protocol -------------------------------------------------

    def predict_time(self, config, shape, profile=None) -> float:
        if self._theta is None:
            return math.inf
        x = self._features(config, shape, profile)
        return float(math.exp(np.clip(x @ self._theta, -80.0, 80.0)))

    def rank(self, configs, shape, profile):
        if self._theta is None:
            return [0.0] * len(configs)
        return [self.predict_time(c, shape, profile) for c in configs]

    def suggest(self, shape, profile, k: int = 1):
        space = _space_for(self.kernel, shape, self.extended)
        if space is None or self._theta is None or k <= 0:
            return []
        pool = _candidate_pool(space, CostModelPredictor.SUGGEST_LIMIT)
        scored = sorted(((self.predict_time(c, shape, profile), i, c)
                         for i, c in enumerate(pool)),
                        key=lambda t: (t[0], t[1]))
        return [c for _, _, c in scored[:k]]

    def feasible(self, config, shape, profile):
        if self._theta_infeasible is None:
            return 1.0
        x = self._features(config, shape, profile)
        p_bad = float(np.clip(x @ self._theta_infeasible, 0.0, 1.0))
        return 1.0 - p_bad

    # -- persistence (ArtifactStore) ------------------------------------------

    def to_payload(self) -> Dict[str, Any]:
        return {
            "kernel": self.kernel.name,
            "profile": self.profile.name,
            "objective": self.objective,
            "extended": self.extended,
            "param_names": list(self._param_names),
            "shape_names": list(self._shape_names),
            "theta": (self._theta.tolist()
                      if self._theta is not None else None),
            "theta_infeasible": (self._theta_infeasible.tolist()
                                 if self._theta_infeasible is not None
                                 else None),
            "training_fingerprint": self.training_fingerprint,
            "n_pretrain": len(self._rows),
            "n_measured": len(self._measured),
        }

    @classmethod
    def from_payload(cls, kernel, payload: Mapping[str, Any],
                     profile: Optional[DeviceProfile] = None
                     ) -> "LearnedPredictor":
        self = cls(kernel, profile=profile,
                   objective=payload.get("objective"),
                   extended=bool(payload.get("extended", False)))
        self._param_names = list(payload.get("param_names", []))
        self._shape_names = list(payload.get("shape_names", []))
        theta = payload.get("theta")
        self._theta = np.asarray(theta) if theta is not None else None
        ti = payload.get("theta_infeasible")
        self._theta_infeasible = np.asarray(ti) if ti is not None else None
        self.training_fingerprint = payload.get(
            "training_fingerprint", training_fingerprint([]))
        return self

    def artifact_fingerprint(self) -> str:
        """Store key: kernel + profile + objective + training-set digest."""
        blob = json.dumps({"kernel": self.kernel.name,
                           "profile": self.profile.name,
                           "objective": self.objective,
                           "training": self.training_fingerprint},
                          sort_keys=True)
        return "pred:" + hashlib.sha256(blob.encode()).hexdigest()[:32]

    def save_to_store(self, store: ArtifactStore) -> Optional[str]:
        art = CompiledArtifact(kind=PREDICTOR_ARTIFACT_KIND,
                               fingerprint=self.artifact_fingerprint(),
                               profile=self.profile.name,
                               payload=self.to_payload(),
                               persistable=True)
        return store.put(art)

    @classmethod
    def load_from_store(cls, store: ArtifactStore, kernel,
                        profile: Optional[DeviceProfile] = None,
                        objective: "Objective | str | None" = None,
                        fingerprint: Optional[str] = None
                        ) -> Optional["LearnedPredictor"]:
        """Fetch a stored model matching the exact training fingerprint.

        ``fingerprint`` is the *training-set* digest the caller expects
        (from :func:`training_fingerprint` over its current dataset); a
        stale stored model — trained on different data — simply misses.
        """
        probe = cls(kernel, profile=profile, objective=objective)
        probe.training_fingerprint = fingerprint or probe.training_fingerprint
        art = store.get(PREDICTOR_ARTIFACT_KIND,
                        probe.artifact_fingerprint(), probe.profile.name)
        if art is None:
            return None
        return cls.from_payload(kernel, art.payload, profile=probe.profile)


# ---------------------------------------------------------------------------
# construction / resolution
# ---------------------------------------------------------------------------

def train_from_cache(kernel, cache, *,
                     profile: Optional[DeviceProfile] = None,
                     objective: "Objective | str | None" = None,
                     pretrain_limit: int = 128,
                     store: Optional[ArtifactStore] = None,
                     extended: bool = False) -> LearnedPredictor:
    """Build a :class:`LearnedPredictor` from a cache's measured history.

    Pretrains on analytical pseudo-labels over the cached shapes (when the
    kernel declares a model), then finetunes on the measured winners.  If
    ``store`` is given, a model persisted under the same training-set
    fingerprint is loaded instead of retraining, and fresh fits are saved
    back.
    """
    profile = resolve_profile(profile)
    rows = cache.trial_dataset(kernel.name, profile=profile.name,
                               objective=objective) if cache else []
    shapes = []
    seen = set()
    for r in rows:
        key = json.dumps(r["shape"], sort_keys=True, default=str)
        if key not in seen:
            seen.add(key)
            shapes.append(r["shape"])
    dataset_fp = training_fingerprint(
        [{k: r[k] for k in ("shape", "config", "time_s")} for r in rows])
    if store is not None:
        cached = LearnedPredictor.load_from_store(
            store, kernel, profile=profile, objective=objective,
            fingerprint=dataset_fp)
        if cached is not None:
            log.debug("predictor for %s loaded from artifact store", kernel.name)
            return cached
    model = LearnedPredictor(kernel, profile=profile, objective=objective,
                             extended=extended)
    if shapes:
        model.pretrain(shapes, limit=pretrain_limit)
    if rows:
        model.finetune(rows)
    # persist under the *measured* dataset fingerprint the loader probes with
    model.training_fingerprint = dataset_fp
    if store is not None and model.trained:
        try:
            model.save_to_store(store)
        except Exception:  # noqa: BLE001 — persistence is best-effort
            log.debug("could not persist predictor for %s", kernel.name,
                      exc_info=True)
    return model


def make_predictor(kind: str, kernel, *,
                   profile: Optional[DeviceProfile] = None,
                   cache=None,
                   objective: "Objective | str | None" = None,
                   store: Optional[ArtifactStore] = None,
                   extended: bool = False) -> Optional[Predictor]:
    """Instantiate a predictor by kind name (``PREDICTOR_KINDS``)."""
    kind = (kind or "off").lower()
    if kind not in PREDICTOR_KINDS:
        raise ValueError(f"unknown predictor kind {kind!r}; "
                         f"expected one of {PREDICTOR_KINDS}")
    if kind == "off":
        return None
    if kind == "heuristic":
        return HeuristicPredictor(kernel, extended=extended)
    if kind == "costmodel":
        return CostModelPredictor(kernel, profile=profile, extended=extended)
    if kind == "transfer":
        return TransferPredictor(kernel, cache, objective=objective,
                                 extended=extended, profile=profile)
    return train_from_cache(kernel, cache, profile=profile,
                            objective=objective, store=store,
                            extended=extended)


def default_predictor_kind() -> str:
    """REPRO_PREDICTOR, validated against ``PREDICTOR_KINDS`` (default off)."""
    return env_str(ENV_PREDICTOR, "off", choices=PREDICTOR_KINDS)


def predict_prune_default() -> bool:
    """REPRO_PREDICT_PRUNE (strict bool; default off)."""
    return env_bool(ENV_PRUNE, False)


def resolve_predictor(predictor, kernel, *,
                      profile: Optional[DeviceProfile] = None,
                      cache=None,
                      objective: "Objective | str | None" = None,
                      store: Optional[ArtifactStore] = None,
                      extended: bool = False) -> Optional[Predictor]:
    """Normalize a ``predictor=`` argument to an instance or None.

    Accepts: None (-> REPRO_PREDICTOR env default), a kind string, a
    plain-data dict ``{"kind": ..., "payload": ...}`` (how dtune ships a
    fleet-trained model across process boundaries), or a ready
    :class:`Predictor` instance.  ``extended`` selects the paper-scale
    space for predictors constructed here (instances pass through as-is).
    """
    if predictor is None:
        predictor = default_predictor_kind()
    if isinstance(predictor, str):
        return make_predictor(predictor, kernel, profile=profile,
                              cache=cache, objective=objective, store=store,
                              extended=extended)
    if isinstance(predictor, Mapping):
        kind = predictor.get("kind", "off")
        payload = predictor.get("payload")
        if kind == "learned" and payload is not None:
            return LearnedPredictor.from_payload(kernel, payload,
                                                 profile=profile)
        return make_predictor(str(kind), kernel, profile=profile,
                              cache=cache, objective=objective, store=store,
                              extended=extended)
    return predictor
