"""Cost accounting: a kernel's declared cost, and the operations,
collectives and memory of a recorded step.

The twin of the JAX package's ``repro/core/hlo.py``.  There, the cost
model reads FLOPs and bytes from XLA's ``cost_analysis()`` of the lowered
module and parses the HLO text for collective traffic.  The port has no
HLO, so:

* each CUDA kernel declares its cost: a function
  ``(shape, config) -> KernelCost`` beside its build (``traffic`` in
  ``kernels/*/``), wired into the declaration as ``TunableKernel.cost``.
  The count is per configuration, as XLA prices each lowered
  configuration separately;
* an eager step is recorded op by op (:class:`OpTrace`, a
  ``TorchDispatchMode``) and ``collective_stats`` / ``count_ops`` /
  ``fusion_stats`` read that trace instead of HLO text.

The JAX module's other half, ``canonicalize_hlo``/``fingerprint`` (the
content address of a lowered module), is not ported: it is replaced by
``cuda:<digest>`` of a CUDA build (:mod:`repro_torch.kernels.build`) and,
for evaluators with no build of their own,
:func:`~repro_torch.core.artifacts.spec_fingerprint`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterable, List, Mapping, NamedTuple

import torch

Config = Mapping[str, Any]


@dataclasses.dataclass(frozen=True)
class KernelCost:
    """What one launch of a configuration does: floating-point operations,
    bytes moved to and from device memory, and bytes sent between devices
    (0 on one card)."""

    flops: float
    bytes: float
    collective_bytes: float = 0.0

    def __post_init__(self) -> None:
        for name in ("flops", "bytes", "collective_bytes"):
            value = float(getattr(self, name))
            if not math.isfinite(value) or value < 0:
                raise ValueError(f"KernelCost.{name} must be finite and "
                                 f">= 0, got {value!r}")
            object.__setattr__(self, name, value)

    def to_json(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def declared_cost(cost: Callable[[Config], KernelCost],
                  config: Config) -> KernelCost:
    """Evaluate a kernel's declared cost for ``config``.

    ``cost`` is the shape-bound declaration (``KernelSpec.cost``).  It
    raises ``ValueError`` for a configuration its kernel cannot build, as
    a lowering fails in the JAX package; anything it returns must be a
    :class:`KernelCost`."""
    out = cost(dict(config))
    if not isinstance(out, KernelCost):
        raise TypeError(f"a declared cost must return a KernelCost, got "
                        f"{type(out).__name__}")
    return out


# -- recorded op traces: collectives, op counts, FLOPs, bytes, memory --------

#: collective op -> bytes multiplier relative to the result size.  A ring
#: all-reduce moves ~2x the buffer (reduce-scatter + all-gather phases); the
#: others move ~1x.  The JAX package's weights.
COLLECTIVE_OPS: Dict[str, float] = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

#: torch's functional-collective op names -> the JAX package's keys
#: (DTensor's ``shard_dim_alltoall`` is its all-to-all on a CUDA mesh)
TORCH_COLLECTIVES: Dict[str, str] = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "permute_tensor": "collective-permute",
}

#: operations that only re-describe storage (views, metadata, waits): no
#: kernel, no traffic.  The rule of ``chip_smoke.py::step_traffic``, plus
#: the functional collectives' wait and autograd wrapper.
VIEW_OPS = frozenset({
    "view", "_unsafe_view", "unbind", "t", "transpose", "expand", "slice",
    "select", "permute", "detach", "alias", "unsqueeze", "squeeze",
    "as_strided", "split", "lift_fresh", "wait_tensor",
    "_wrap_tensor_autograd"})


class OpRecord(NamedTuple):
    """One recorded operation: its name (``aten.mm``,
    ``_c10d_functional.all_reduce``), its result's dtype and shape."""

    op: str
    dtype: Any
    shape: tuple


def _shape_bytes(dtype: Any, shape: Iterable[int]) -> int:
    """Bytes of one result of ``dtype`` (a torch dtype or its name) and
    ``shape``; 0 for a dtype with no width (the JAX function skips
    opaque types too)."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype.removeprefix("torch."), None)
    if not isinstance(dtype, torch.dtype):
        return 0
    return math.prod(shape) * dtype.itemsize


def _base_name(op: str) -> str:
    """``aten.mm.default`` -> ``mm``; ``_c10d_functional.all_reduce`` ->
    ``all_reduce``."""
    parts = op.split(".")
    if len(parts) >= 3 and parts[-1] in ("default", "Tensor", "Scalar",
                                         "int", "dim", "self", "out"):
        parts = parts[:-1]
    return parts[-1] if len(parts) > 1 else parts[0]


def _collective_key(op: str):
    return TORCH_COLLECTIVES.get(_base_name(op))


@dataclasses.dataclass
class CollectiveStats:
    """Byte counts per collective op kind, plus the weighted total."""

    counts: Dict[str, int]
    bytes_by_op: Dict[str, int]
    weighted_bytes: float

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())

    def summary(self) -> str:
        parts = [f"{k}:{self.counts[k]}x/{self.bytes_by_op[k]/1e6:.1f}MB"
                 for k in sorted(self.bytes_by_op) if self.counts[k]]
        return ", ".join(parts) if parts else "none"


def collective_stats(records: Iterable[OpRecord]) -> CollectiveStats:
    """Bytes of every collective in a recorded trace: its result's size,
    as the JAX function counts an HLO collective's result shape (so an
    all-gather counts the gathered buffer, a reduce-scatter the scattered
    one)."""
    counts = {k: 0 for k in COLLECTIVE_OPS}
    bytes_by_op = {k: 0 for k in COLLECTIVE_OPS}
    for rec in records:
        key = _collective_key(rec.op)
        if key is None:
            continue
        counts[key] += 1
        bytes_by_op[key] += _shape_bytes(rec.dtype, rec.shape)
    weighted = sum(bytes_by_op[k] * COLLECTIVE_OPS[k] for k in COLLECTIVE_OPS)
    return CollectiveStats(counts=counts, bytes_by_op=bytes_by_op,
                           weighted_bytes=weighted)


def count_ops(records: Iterable[OpRecord], names: Iterable[str]
              ) -> Dict[str, int]:
    """How often each op in ``names`` (base names: ``mm``, ``all_reduce``)
    occurs in a recorded trace."""
    names = list(names)
    out = {n: 0 for n in names}
    for rec in records:
        base = _base_name(rec.op)
        if base in out:
            out[base] += 1
    return out


#: the JAX module's structural keys -> the aten ops counted under each in
#: an eager trace.  ``fusion`` and ``while`` are always 0 (eager PyTorch
#: neither fuses nor loops on the device); ``custom-call`` counts the
#: port's CUDA extension ops (``repro_torch::*``).
FUSION_KEYS: Dict[str, tuple] = {
    "fusion": (),
    "dot": ("mm", "bmm", "addmm", "baddbmm", "matmul", "dot"),
    "convolution": ("convolution", "convolution_backward"),
    "transpose": ("transpose", "permute", "t"),
    "reshape": ("view", "_unsafe_view", "reshape"),
    "copy": ("copy_", "clone", "_to_copy", "contiguous"),
    "dynamic-slice": ("slice", "narrow", "index", "gather", "select"),
    "dynamic-update-slice": ("slice_scatter", "index_put", "index_put_",
                             "scatter", "select_scatter", "copy_"),
    "while": (),
    "custom-call": (),
}


def fusion_stats(records: Iterable[OpRecord]) -> Dict[str, int]:
    """Quick structural profile of a recorded step (perf forensics), under
    the JAX function's keys (:data:`FUSION_KEYS` says which ops count
    under each)."""
    records = list(records)
    out = {}
    for key, ops in FUSION_KEYS.items():
        if key == "custom-call":
            out[key] = sum(1 for r in records
                           if r.op.startswith("repro_torch"))
        else:
            n = count_ops(records, ops)
            out[key] = sum(n.values())
    return out


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    if isinstance(x, dict):
        return [t for y in x.values() for t in _tensors(y)]
    return []


def _nbytes(ts: List[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class OpTrace:
    """Record what a step asks of each rank: every operation on plain
    (local) tensors, with its result's dtype and shape, its FLOPs
    (``torch.utils.flop_counter``'s formulas), the bytes it reads and
    writes (inputs plus outputs of every op that is not a view:
    ``chip_smoke.py::step_traffic``'s rule) and the peak of live local
    storage.

    Operations on DTensors are handed on to DTensor, which runs them on
    their local shards and issues the collectives its layouts need: those
    local operations and collectives are what the trace sees, so the
    counts are per rank.  Tensors made by DTensor's sharding propagation
    (fake tensors) are skipped.

    The live-memory peak counts the ``resident`` tensors (what the caller
    says is live before the step: the local shards of parameters,
    optimizer state and batch; a tree of tensors) plus every storage an
    operation allocates, from its allocation until no tensor refers to
    it; an operation's result that shares a storage already counted (a
    view of a parameter, an in-place update) adds nothing.  It does not
    count the allocator's caching or fragmentation, the CUDA context or
    library workspaces.

    Use as a context manager; ``records`` is the trace."""

    def __init__(self, resident: Any = ()):
        from torch.multiprocessing.reductions import StorageWeakRef
        from torch.utils.flop_counter import flop_registry
        self._flops_of = flop_registry
        self.records: List[OpRecord] = []
        self.flops = 0.0
        self.bytes = 0
        self.ops = 0
        self.by_op: Dict[str, List[float]] = {}
        self._storages: Dict[int, Any] = {}
        self._resident: Dict[int, Any] = {}
        for t in _tensors(resident):
            t = getattr(t, "_local_tensor", t)
            st = t.untyped_storage()
            self._resident[st._cdata] = (StorageWeakRef(st), st.nbytes())
        self.resident = sum(nb for _, nb in self._resident.values())
        self.live = 0
        self.peak = self.resident
        self._mode = None

    def __enter__(self):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        trace = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **kwargs)
                trace._record(func, args, kwargs, out)
                return out

        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self._mode = None
        return False

    def _record(self, func, args, kwargs, out) -> None:
        from torch._subclasses.fake_tensor import FakeTensor
        outs = _tensors(out)
        ins = _tensors(args) + _tensors(kwargs)
        if any(isinstance(t, FakeTensor) for t in outs + ins):
            return
        name = str(func.overloadpacket).removeprefix("torch.ops.")
        first = outs[0] if outs else None
        self.records.append(OpRecord(
            name, first.dtype if first is not None else None,
            tuple(first.shape) if first is not None else ()))
        base = func.overloadpacket.__name__
        if base in VIEW_OPS:
            return
        nb = _nbytes(ins) + _nbytes(outs)
        fl = 0.0
        count = self._flops_of.get(func.overloadpacket)
        if count is not None:
            fl = float(count(*args, **kwargs, out_val=out))
        self.ops += 1
        self.bytes += nb
        self.flops += fl
        entry = self.by_op.setdefault(name, [0, 0, 0.0])
        entry[0] += 1
        entry[1] += nb
        entry[2] += fl
        self._track(outs)

    def _track(self, outs: List[torch.Tensor]) -> None:
        from torch.multiprocessing.reductions import StorageWeakRef
        added = False
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._resident:
                continue
            if key in self._storages:
                ref, nb = self._storages[key]
                if not ref.expired():
                    continue
                self.live -= nb                  # an address reused
            self._storages[key] = (StorageWeakRef(st), st.nbytes())
            self.live += st.nbytes()
            added = True
        if added:
            dead = [k for k, (ref, _) in self._storages.items()
                    if ref.expired()]
            for k in dead:
                self.live -= self._storages.pop(k)[1]
            self.peak = max(self.peak, self.resident + self.live)

    def collectives(self) -> CollectiveStats:
        return collective_stats(self.records)
