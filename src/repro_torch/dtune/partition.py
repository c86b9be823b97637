"""Search-space partitioning for distributed tuning.

Two ways to split one :class:`~repro_torch.core.space.SearchSpace` across N
workers:

* **strided** — worker *i* exhaustively enumerates feasible configs
  ``i, i+n, i+2n, ...`` (``FullSearch(offset=i, stride=n)``).  The shards
  partition the space exactly: every feasible config is evaluated once,
  by exactly one worker, so the merged result equals a single-process
  full search at ~1/n the per-worker cost.  Deterministic, no
  duplicated work, but only meaningful for exhaustive search — a strided
  slice destroys the neighbourhood structure annealing/PSO walk.
* **islands** — every worker sees the *whole* space but runs its own
  strategy (annealing / PSO / evolutionary / random rotation) with its
  own seed, optionally warm-started from nearest-shape cache entries.
  Workers duplicate some evaluations but explore independently; the
  merge keeps whichever island found the best time.  This is the
  classic island model from parallel evolutionary computation, applied
  to CLTune-style kernel search.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, List, Optional, Sequence

from ..core.space import SearchSpace

log = logging.getLogger("repro_torch.dtune")

#: strategy rotation for islands mode: worker i runs ISLAND_STRATEGIES[i %
#: len].  Ordered so small fleets get the most complementary mix first.
ISLAND_STRATEGIES = ("annealing", "pso", "evolutionary", "random")

#: distinct-seed spacing between islands (any odd constant works; a prime
#: keeps per-worker RNG streams from trivially overlapping)
_SEED_STRIDE = 9973


@dataclasses.dataclass(frozen=True)
class Shard:
    """One worker's slice of a distributed search (picklable, no space)."""

    index: int                              # worker number, 0-based
    total: int                              # fleet size n
    mode: str                               # "strided" | "islands"
    strategy: str                           # strategy name for this worker
    #: strategy constructor kwargs (e.g. offset/stride for strided full)
    strategy_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    seed: int = 0                           # per-worker RNG seed
    #: per-worker evaluation budget; None = strategy default (exhaustive
    #: for full search, the tuner's 1/32 clamp for stochastic ones)
    budget: Optional[int] = None

    @property
    def label(self) -> str:
        return f"{self.mode}[{self.index}/{self.total}]:{self.strategy}"


def shard_space(space: SearchSpace, n: int, mode: str = "strided", *,
                budget: Optional[int] = None, seed: int = 0,
                strategies: Optional[Sequence[str]] = None) -> List[Shard]:
    """Split ``space`` into ``n`` worker shards.

    ``budget`` is the *per-worker* budget (None = per-strategy default);
    ``seed`` is the base RNG seed, offset per worker so islands explore
    distinct trajectories.  ``strategies`` overrides the islands-mode
    rotation (ignored for strided).  Returns one :class:`Shard` per
    worker; shards carry no reference to the space itself, so they are
    cheap to pickle into worker processes.
    """
    if n < 1:
        raise ValueError(f"need at least one shard; got n={n}")
    if mode not in ("strided", "islands"):
        raise ValueError(f"unknown shard mode {mode!r}; "
                         "known: 'strided', 'islands'")
    if mode == "strided":
        if strategies is not None:
            raise ValueError("strided mode always runs full search; "
                             "use mode='islands' for per-worker strategies")
        card = space.cardinality()
        if n > card:
            # legal — the tail shards simply enumerate nothing — but the
            # caller probably mis-sized the fleet, so say so
            log.warning("shard_space: %d shards over a %d-config space; "
                        "%d worker(s) will be idle", n, card, n - card)
        return [Shard(index=i, total=n, mode=mode, strategy="full",
                      strategy_kwargs={"offset": i, "stride": n},
                      seed=seed, budget=budget)
                for i in range(n)]
    rotation = ISLAND_STRATEGIES if strategies is None else tuple(strategies)
    if not rotation:
        raise ValueError("islands mode needs at least one strategy")
    return [Shard(index=i, total=n, mode=mode,
                  strategy=rotation[i % len(rotation)],
                  seed=seed + i * _SEED_STRIDE, budget=budget)
            for i in range(n)]
