"""repro_torch.core — the paper's contribution: a generic auto-tuner.

Public API surface (the CLTune analogue):

    from repro_torch.core import Tuner, Parameter, SearchSpace
    from repro_torch.core import WallClockEvaluator, CostModelEvaluator, \
        AnalyticalEvaluator
    from repro_torch.core import make_strategy, device_profile, H100_SXM

The JAX package's ``core/hlo.py`` has its twin in ``core/cost.py``
(declared FLOPs and bytes in place of XLA's ``cost_analysis()``).
"""

from .artifacts import (ARTIFACT_FORMAT_VERSION, ArtifactStore,
                        CompiledArtifact, StoreStats, default_store,
                        resolve_store, spec_fingerprint)
from .cache import (CacheEntry, TuningCache, default_cache, shape_distance,
                    split_key)
from .cost import KernelCost, declared_cost
from .engine import EngineConfig, EngineStats, EvaluationEngine
from .envknobs import env_bool, env_int, env_str, parse_bool
from .evaluators import (AnalyticalEvaluator, ArrivalTraceEvaluator,
                         CostModelEvaluator, Evaluator, KernelSpec,
                         Measurement, WallClockEvaluator, make_evaluator,
                         median_prune_loop)
from .failures import (CompileError, EvaluationError, EvaluationTimeout,
                       FailureRecord, InfeasibleConfigError, MeasureError,
                       RetryPolicy, TransientError, VerificationFailure,
                       summarize_failures)
from .metrics import (DEFAULT_OBJECTIVE, Metrics, Objective,
                      default_objective)
from .predict import (PREDICTOR_KINDS, CostModelPredictor,
                      HeuristicPredictor, LearnedPredictor, Predictor,
                      TransferPredictor, make_predictor, resolve_predictor,
                      train_from_cache, training_fingerprint)
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
    "KernelCost", "declared_cost",
    "EngineConfig", "EngineStats", "EvaluationEngine",
    "env_bool", "env_int", "env_str", "parse_bool",
    "AnalyticalEvaluator", "ArrivalTraceEvaluator", "CostModelEvaluator",
    "Evaluator", "KernelSpec", "Measurement", "WallClockEvaluator",
    "make_evaluator", "median_prune_loop",
    "DEFAULT_OBJECTIVE", "Metrics", "Objective", "default_objective",
    "CompileError", "EvaluationError", "EvaluationTimeout", "FailureRecord",
    "InfeasibleConfigError", "MeasureError", "RetryPolicy", "TransientError",
    "VerificationFailure", "summarize_failures",
    "PREDICTOR_KINDS", "CostModelPredictor", "HeuristicPredictor",
    "LearnedPredictor", "Predictor", "TransferPredictor", "make_predictor",
    "resolve_predictor", "train_from_cache", "training_fingerprint",
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
