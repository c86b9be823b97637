"""Search-space definition: parameters, constraints, neighbourhoods.

Faithful to CLTune section III: a parameter is a name plus a short list of
discrete values; the space is the cartesian product filtered by user
constraints (arbitrary predicates over parameter subsets, the paper's lambda
expressions) and device constraints (auto-imposed limits).

The paper's four search-space observations drive the representation:
  1. few values per parameter            -> values stored as tuples
  2. high dimensionality                 -> lazy product iteration, never
                                            materialise unless asked
  3. discrete, non-linear response       -> no continuous relaxation anywhere
  4. strong parameter interactions       -> constraints get exactly the
                                            parameters they declare
"""

from __future__ import annotations

import dataclasses
import inspect
import itertools
import math
import random
from typing import Callable, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

Config = Dict[str, object]      # one point in the space: {param name: value}


def _value_ident(value: object) -> Tuple[bool, object]:
    """Identity of a parameter value under type-aware matching.

    Python equality conflates ``True``/``1`` and ``False``/``0``, so a
    plain ``tuple.index``/``set`` treats bool and int values as the same
    point — silently aliasing configs (the same bug PR 4 fixed for shape
    dims).  Bools are categorical here: they only match bools.
    """
    return (isinstance(value, bool), value)


@dataclasses.dataclass(frozen=True)
class Parameter:
    """A tunable parameter: a name and its allowed discrete values."""

    name: str
    values: Tuple[object, ...]

    def __post_init__(self) -> None:
        if not self.values:
            raise ValueError(f"parameter {self.name!r} has no values")
        if len({_value_ident(v) for v in self.values}) != len(self.values):
            raise ValueError(f"parameter {self.name!r} has duplicate values")

    def index_of(self, value: object) -> int:
        ident = _value_ident(value)
        for i, v in enumerate(self.values):
            if _value_ident(v) == ident:
                return i
        raise ValueError(f"{value!r} is not a value of "
                         f"parameter {self.name!r}")


def constraint_arity_error(fn: Callable[..., bool],
                           n_names: int) -> Optional[str]:
    """Why ``fn`` cannot be called with ``n_names`` positional arguments.

    ``None`` means compatible — or unknowable: C builtins and exotic
    callables without an inspectable signature get the benefit of the
    doubt (the paper's constraints are always plain lambdas).  Varargs
    functions accept any arity, so the auto-imposed device constraints
    (``fn(*values)`` over every space parameter) always pass.
    """
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    required = 0
    maximum: Optional[int] = 0
    for p in sig.parameters.values():
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            maximum = None if maximum is None else maximum + 1
            if p.default is p.empty:
                required += 1
        elif p.kind is p.VAR_POSITIONAL:
            maximum = None
        elif p.kind is p.KEYWORD_ONLY and p.default is p.empty:
            return (f"constraint fn has required keyword-only parameter "
                    f"{p.name!r}; constraints are called positionally")
    if n_names < required:
        return (f"constraint declares {n_names} parameter name(s) but its "
                f"fn requires {required} positional argument(s)")
    if maximum is not None and n_names > maximum:
        return (f"constraint declares {n_names} parameter name(s) but its "
                f"fn accepts at most {maximum} positional argument(s)")
    return None


@dataclasses.dataclass(frozen=True)
class Constraint:
    """A predicate over a subset of parameters (CLTune's lambda constraints)."""

    fn: Callable[..., bool]
    names: Tuple[str, ...]
    label: str = ""

    def check(self, config: Mapping[str, object]) -> bool:
        return bool(self.fn(*(config[n] for n in self.names)))


class SearchSpace:
    """The cartesian product of parameters filtered by constraints.

    Points are exposed in two coordinate systems:
      * ``Config`` dicts (name -> value), the user-facing form;
      * index vectors (one index per parameter, in parameter order), the
        internal form used by the search strategies (SA neighbours, PSO
        per-dimension moves).
    """

    def __init__(self, parameters: Sequence[Parameter] | None = None) -> None:
        self._params: List[Parameter] = []
        self._by_name: Dict[str, Parameter] = {}
        self._constraints: List[Constraint] = []
        #: memoised feasible list, built lazily by the dense sampling
        #: fallback (invalidated whenever the space is mutated)
        self._feasible_memo: Optional[List[Config]] = None
        for p in parameters or ():
            self.add_parameter(p)

    # -- construction ------------------------------------------------------
    def add_parameter(self, param: Parameter | None = None, *,
                      name: str | None = None,
                      values: Sequence[object] | None = None) -> "SearchSpace":
        if param is None:
            if name is None or values is None:
                raise TypeError("add_parameter needs a Parameter or both "
                                "name= and values=")
            param = Parameter(name=name, values=tuple(values))
        if param.name in self._by_name:
            raise ValueError(f"duplicate parameter {param.name!r}")
        self._params.append(param)
        self._by_name[param.name] = param
        self._feasible_memo = None
        return self

    def add_constraint(self, fn: Callable[..., bool],
                       names: Sequence[str], label: str = "") -> "SearchSpace":
        missing = [n for n in names if n not in self._by_name]
        if missing:
            raise KeyError(f"constraint references unknown parameters {missing}")
        # arity mismatches raise here, at declaration time, instead of as
        # a bare TypeError mid-search deep inside a strategy
        arity_err = constraint_arity_error(fn, len(names))
        if arity_err:
            raise ValueError(
                f"constraint {label or tuple(names)!r}: {arity_err}")
        self._constraints.append(Constraint(fn=fn, names=tuple(names), label=label))
        self._feasible_memo = None
        return self

    # -- introspection -------------------------------------------------------
    @property
    def parameters(self) -> Tuple[Parameter, ...]:
        return tuple(self._params)

    @property
    def constraints(self) -> Tuple[Constraint, ...]:
        return tuple(self._constraints)

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(p.name for p in self._params)

    @property
    def num_dimensions(self) -> int:
        return len(self._params)

    def cardinality(self) -> int:
        """Size of the *unconstrained* product (paper's head-line numbers,
        e.g. 241,600 for GEMM, count feasible configs; see ``size``)."""
        return math.prod(len(p.values) for p in self._params)

    def size(self) -> int:
        """Number of feasible configs (exact, by enumeration)."""
        return sum(1 for _ in self)

    # -- coordinate transforms ----------------------------------------------
    def to_indices(self, config: Mapping[str, object]) -> Tuple[int, ...]:
        return tuple(p.index_of(config[p.name]) for p in self._params)

    def from_indices(self, idx: Sequence[int]) -> Config:
        return {p.name: p.values[i] for p, i in zip(self._params, idx)}

    def is_feasible(self, config: Mapping[str, object]) -> bool:
        return all(c.check(config) for c in self._constraints)

    def violated(self, config: Mapping[str, object]) -> List[str]:
        """Labels of violated constraints (debugging aid)."""
        return [c.label or repr(c.names) for c in self._constraints
                if not c.check(config)]

    # -- enumeration ---------------------------------------------------------
    def __iter__(self) -> Iterator[Config]:
        if self._feasible_memo is not None:
            # the dense sampling fallback already enumerated: serve copies
            # from the memo (callers may mutate the yielded dicts)
            yield from (dict(cfg) for cfg in self._feasible_memo)
            return
        names = self.names
        for combo in itertools.product(*(p.values for p in self._params)):
            cfg = dict(zip(names, combo))
            if self.is_feasible(cfg):
                yield cfg

    def _feasible_configs(self) -> List[Config]:
        """The full feasible list, enumerated once and memoised.

        Only the dense sampling fallback materialises this (spaces whose
        constraints are too tight for rejection sampling); plain iteration
        stays lazy until then.  Mutating the space invalidates the memo.
        """
        if self._feasible_memo is None:
            self._feasible_memo = list(self)
        return self._feasible_memo

    def enumerate(self, limit: Optional[int] = None) -> List[Config]:
        it = iter(self)
        if limit is None:
            return list(it)
        return list(itertools.islice(it, limit))

    # -- sampling -------------------------------------------------------------
    def sample(self, rng: random.Random, max_tries: int = 10_000) -> Config:
        """Uniformly sample a feasible config by rejection.

        Once any stalled call has paid for the dense fallback (one full
        enumeration, memoised), later calls draw from the memo directly —
        repeated sampling in a tightly-constrained space is O(1) per draw
        instead of re-enumerating the whole product every time.
        """
        if self._feasible_memo is None:
            for _ in range(max_tries):
                cfg = {p.name: rng.choice(p.values) for p in self._params}
                if self.is_feasible(cfg):
                    return cfg
        # Dense fallback: enumerate once and choose (guaranteed if non-empty).
        all_cfg = self._feasible_configs()
        if not all_cfg:
            raise ValueError("search space has no feasible configuration")
        return dict(rng.choice(all_cfg))

    def sample_unique(self, rng: random.Random, count: int,
                      max_tries_factor: int = 200) -> List[Config]:
        """Sample ``count`` distinct feasible configs.

        Rejection sampling first; if it stalls (tight constraints, near-
        duplicate draws) the remainder comes from a shuffled enumeration
        of the unseen feasible configs — the same dense fallback
        :meth:`sample` uses.  The result is shorter than ``count`` only
        when the feasible space itself holds fewer than ``count`` configs;
        callers (e.g. RandomSearch) report that shortfall instead of
        silently under-spending their budget.
        """
        seen = set()
        out: List[Config] = []
        tries = 0
        budget = max(count * max_tries_factor, 1000)
        while len(out) < count and tries < budget:
            # once the dense fallback has materialised the feasible list,
            # stop rejection-sampling the moment every config is seen —
            # further draws can only repeat
            if (self._feasible_memo is not None
                    and len(seen) >= len(self._feasible_memo)):
                break
            tries += 1
            cfg = self.sample(rng)
            key = self.config_key(cfg)
            if key not in seen:
                seen.add(key)
                out.append(cfg)
        if len(out) < count:
            remaining = [dict(cfg) for cfg in self._feasible_configs()
                         if self.config_key(cfg) not in seen]
            rng.shuffle(remaining)
            out.extend(remaining[: count - len(out)])
        return out

    # -- neighbourhood (for simulated annealing) ------------------------------
    def neighbours(self, config: Mapping[str, object],
                   mode: str = "any_value") -> List[Config]:
        """Feasible configs differing from ``config`` in exactly one parameter.

        ``mode='adjacent'`` restricts moves to +/-1 position within a
        parameter's value list (value lists are declared in sorted order for
        numeric parameters, so this is a small step).  ``mode='any_value'``
        allows any other value of one parameter, matching CLTune's neighbour
        definition for categorical/boolean parameters.
        """
        out: List[Config] = []
        idx = self.to_indices(config)
        for d, p in enumerate(self._params):
            if mode == "adjacent":
                cand = [i for i in (idx[d] - 1, idx[d] + 1)
                        if 0 <= i < len(p.values)]
            elif mode == "any_value":
                cand = [i for i in range(len(p.values)) if i != idx[d]]
            else:
                raise ValueError(f"unknown neighbour mode {mode!r}")
            for i in cand:
                cfg = dict(config)
                cfg[p.name] = p.values[i]
                if self.is_feasible(cfg):
                    out.append(cfg)
        return out

    def random_neighbour(self, config: Mapping[str, object],
                         rng: random.Random,
                         mode: str = "any_value") -> Optional[Config]:
        ns = self.neighbours(config, mode=mode)
        return rng.choice(ns) if ns else None

    # -- misc ------------------------------------------------------------------
    def config_key(self, config: Mapping[str, object]) -> Tuple[object, ...]:
        """Hashable identity of a config (parameter order normalised).

        Bool values are tagged so ``{"X": True}`` and ``{"X": 1}`` hash to
        *different* keys — Python equality would conflate them, silently
        merging distinct configs in the engine memo and the caches.
        """
        return tuple(_value_ident(config[n]) if isinstance(config[n], bool)
                     else config[n] for n in self.names)

    def __repr__(self) -> str:
        return (f"SearchSpace({self.num_dimensions} params, "
                f"cardinality={self.cardinality()}, "
                f"{len(self._constraints)} constraints)")
