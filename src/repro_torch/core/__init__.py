"""repro_torch.core — the paper's contribution: a generic auto-tuner.

Public API surface (the CLTune analogue), as far as it is ported:

    from repro_torch.core import Tuner, Parameter, SearchSpace
    from repro_torch.core import WallClockEvaluator, AnalyticalEvaluator
    from repro_torch.core import make_strategy, device_profile, H100_SXM
"""

from .artifacts import (ARTIFACT_FORMAT_VERSION, ArtifactStore,
                        CompiledArtifact, StoreStats, default_store,
                        resolve_store, spec_fingerprint)
from .cache import (CacheEntry, TuningCache, default_cache, shape_distance,
                    split_key)
from .engine import EngineConfig, EngineStats, EvaluationEngine
from .envknobs import env_bool, env_int, env_str, parse_bool
from .evaluators import (AnalyticalEvaluator, Evaluator, KernelSpec,
                         Measurement, WallClockEvaluator, make_evaluator,
                         median_prune_loop)
from .failures import (CompileError, EvaluationError, EvaluationTimeout,
                       FailureRecord, InfeasibleConfigError, MeasureError,
                       RetryPolicy, TransientError, VerificationFailure,
                       summarize_failures)
from .metrics import (DEFAULT_OBJECTIVE, Metrics, Objective,
                      default_objective)
from .profiles import (H100_SXM, PROFILES, DeviceProfile, device_profile,
                       get_profile, resolve_profile)
from .registry import (REGISTRY, AutotunePolicy, KernelRegistry, Resolution,
                       TunableKernel, default_policy, lookup, lookup_resolved,
                       resolve, transfer_config, tunable)
from .space import Config, Constraint, Parameter, SearchSpace
from .strategies import (AskTellDriver, Evolutionary, FullSearch,
                         GreedyCoordinateDescent, ParticleSwarm,
                         RandomSearch, SearchResult, SequentialAskTell,
                         SimulatedAnnealing, Strategy, Trial,
                         available_strategies, make_strategy,
                         project_feasible, register_strategy, usable_seeds)
from .tuner import Tuner, TuningOutcome
from .verify import VerificationError, assert_trees_close, trees_close

__all__ = [
    "ARTIFACT_FORMAT_VERSION", "ArtifactStore", "CompiledArtifact",
    "StoreStats", "default_store", "resolve_store", "spec_fingerprint",
    "CacheEntry", "TuningCache", "default_cache", "shape_distance",
    "split_key",
    "EngineConfig", "EngineStats", "EvaluationEngine",
    "env_bool", "env_int", "env_str", "parse_bool",
    "AnalyticalEvaluator", "Evaluator", "KernelSpec", "Measurement",
    "WallClockEvaluator", "make_evaluator", "median_prune_loop",
    "DEFAULT_OBJECTIVE", "Metrics", "Objective", "default_objective",
    "CompileError", "EvaluationError", "EvaluationTimeout", "FailureRecord",
    "InfeasibleConfigError", "MeasureError", "RetryPolicy", "TransientError",
    "VerificationFailure", "summarize_failures",
    "H100_SXM", "PROFILES", "DeviceProfile", "device_profile",
    "get_profile", "resolve_profile",
    "REGISTRY", "AutotunePolicy", "KernelRegistry", "Resolution",
    "TunableKernel", "default_policy", "lookup", "lookup_resolved",
    "resolve", "transfer_config", "tunable",
    "Config", "Constraint", "Parameter", "SearchSpace",
    "AskTellDriver", "Evolutionary", "FullSearch",
    "GreedyCoordinateDescent", "ParticleSwarm", "RandomSearch",
    "SearchResult", "SequentialAskTell", "SimulatedAnnealing",
    "Strategy", "Trial",
    "available_strategies", "make_strategy", "project_feasible",
    "register_strategy", "usable_seeds",
    "Tuner", "TuningOutcome",
    "VerificationError", "assert_trees_close", "trees_close",
]
