"""Unified parsing for the ``REPRO_*`` environment knobs.

Every subsystem used to roll its own ``os.environ.get`` + coercion —
the serve engine's boolean parse silently treated garbage as *off*, the
dtune coordinator warned-and-defaulted on bad integers, and the cache
used ``raw or default``.  This module is the one place those rules live:

* :func:`env_bool` — recognizes the canonical spellings (``1/true/on/yes``
  and ``0/false/off/no``/empty) and **raises TypeError on anything else**.
  This is the PR 5 truthy-coercion rule extended to the environment: a
  value like ``REPRO_ONLINE_TUNE=2`` or ``=enable`` must not silently
  coerce to *either* side of a feature flag — it is a configuration error
  the operator should see immediately, not a behavior they discover in
  production.  :func:`parse_bool` is the same rule for API arguments
  (``online_tune=0`` raises instead of enabling with default knobs).
* :func:`env_int` — warns and falls back on a non-integer value (an
  unparseable *size* knob degrades gracefully; it cannot invert behavior
  the way a misread boolean can).
* :func:`env_str` — empty/unset returns the default; an optional
  ``choices`` set warns-and-defaults on unknown values.

Knobs parsed through here: ``REPRO_AUTOTUNE``, ``REPRO_ONLINE_TUNE``,
``REPRO_TUNE_CACHE``, ``REPRO_DTUNE_WORKERS/MODE/DRIVER``, the
compile-artifact store's ``REPRO_ARTIFACT_CACHE``/``REPRO_ARTIFACT_DIR``
and the prediction layer's ``REPRO_PREDICTOR``/``REPRO_PREDICT_PRUNE``,
plus the static analyzer's ``REPRO_ANALYZE`` (run the pre-search space
audit + proven-infeasible pruning by default) and
``REPRO_ANALYZE_STRICT`` (escalate error findings to a raised
ValueError before any search runs).
"""

from __future__ import annotations

import logging
import os
from typing import Iterable, Optional

log = logging.getLogger("repro_torch.envknobs")

_TRUE = frozenset(("1", "true", "on", "yes"))
_FALSE = frozenset(("0", "false", "off", "no", ""))


def parse_bool(value: object, *, name: str = "value") -> bool:
    """Strict boolean coercion: real bools and the canonical string
    spellings pass; everything else — ints included — raises TypeError.
    ``parse_bool(0)`` raising (instead of returning False) is deliberate:
    the call sites that accept richer types (``online_tune=``) dispatch on
    type *before* coercing, and a bare ``0``/``'off'`` reaching a truthy
    test historically meant a feature silently turned ON."""
    if isinstance(value, bool):
        return value
    if isinstance(value, str):
        v = value.strip().lower()
        if v in _TRUE:
            return True
        if v in _FALSE:
            return False
    raise TypeError(
        f"{name} must be a boolean or one of "
        f"{sorted(_TRUE)} / {sorted(_FALSE - {''})} (or empty); "
        f"got {type(value).__name__}: {value!r}")


def env_bool(name: str, default: bool = False) -> bool:
    """Boolean env knob; unset returns ``default``, an unrecognized value
    raises TypeError (see :func:`parse_bool`)."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    return parse_bool(raw, name=name)


def env_int(name: str, default: int) -> int:
    """Integer env knob; unset/empty returns ``default``, a non-integer
    value logs a warning and returns ``default``."""
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        log.warning("envknobs: ignoring non-integer %s=%r (using %r)",
                    name, raw, default)
        return default


def env_str(name: str, default: Optional[str] = None, *,
            choices: Optional[Iterable[str]] = None) -> Optional[str]:
    """String env knob; unset/empty returns ``default``.  With ``choices``,
    an unknown value logs a warning and returns ``default`` (validation
    that must *fail* belongs to the consumer, e.g. AutotunePolicy)."""
    raw = os.environ.get(name)
    if not raw:
        return default
    if choices is not None and raw not in set(choices):
        log.warning("envknobs: unknown %s=%r (known: %s; using %r)",
                    name, raw, sorted(set(choices)), default)
        return default
    return raw
