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
from typing import (Any, Callable, Dict, Iterable, List, Mapping, NamedTuple,
                    Tuple)

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


#: XLA's ``HloCostAnalysis`` count, per output element, of the operations
#: that are neither products nor views: (FLOPs, transcendentals).  An
#: elementwise arithmetic op (a compare, a select and a convert among
#: them) is one FLOP; ``exp``, ``log``, ``rsqrt``, ``tanh`` ... are one
#: transcendental and no FLOP; the activations are what XLA counts for
#: their ``jax.nn`` forms and the fused backward ops what it counts for
#: ``jax.vjp`` of those forms (``tests/test_torch_cost_rule.py`` compiles
#: each and reads its ``cost_analysis()``).
POINTWISE_COST: Dict[str, tuple] = {
    **{k: (1, 0) for k in (
        "add", "sub", "rsub", "mul", "div", "neg", "reciprocal", "maximum",
        "minimum", "clamp", "clamp_min", "clamp_max", "where",
        "masked_fill", "eq", "ne", "gt", "ge", "lt", "le", "bitwise_and",
        "bitwise_or", "bitwise_xor", "bitwise_not", "logical_and",
        "logical_or", "logical_not", "abs", "sign", "floor", "ceil",
        "round", "trunc", "fmod", "remainder", "square")},
    **{k: (0, 1) for k in (
        "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "sqrt",
        "rsqrt", "tanh", "sin", "cos", "tan", "erf", "atan", "atan2")},
    "sigmoid": (3, 1),                 # lax.logistic
    "silu": (4, 1),                    # jax.nn.silu
    "softplus": (6, 2),                # jax.nn.softplus (logaddexp(x, 0))
    "gelu": (8, 1),                    # jax.nn.gelu, tanh form
    "silu_backward": (9, 1),           # jax.vjp(jax.nn.silu)
    "softplus_backward": (12, 3),      # jax.vjp(jax.nn.softplus)
    "gelu_backward": (20, 1),          # jax.vjp(jax.nn.gelu)
    "sigmoid_backward": (3, 0),        # g * y * (1 - y)
    "tanh_backward": (3, 0),           # g * (1 - y * y)
    "threshold_backward": (2, 0),      # where(x <= t, 0, g)
    "addcmul": (3, 0),                 # a + v * b * c
    "addcdiv": (3, 0),
}

#: reductions: XLA counts one FLOP per input element folded into an
#: output element (n - m for n inputs and m outputs); ``mean`` adds its
#: divide (m), arg-reductions carry a 9-op comparator
_REDUCE = frozenset({"sum", "amax", "amin", "max", "min", "prod", "any",
                     "all", "nansum"})
_CONVERTS = frozenset({"_to_copy", "to", "copy_", "copy"})


def _scalar_pow_cost(e: float) -> tuple:
    """``x ** e`` for a scalar ``e``: XLA multiplies an integer power out
    by squaring (a negative one adds a divide); any other is a
    transcendental."""
    if float(e) != int(e):
        return 0, 1
    k = abs(int(e))
    flops = (k.bit_length() - 1 + bin(k).count("1") - 1) if k else 0
    return flops + (1 if e < 0 else 0), 0


def _cumsum_flops(length: int) -> int:
    """XLA's count for a prefix sum of ``length`` on the CPU: a reduce
    window, which it rewrites into blocks of 16 past that length."""
    if length <= 16:
        return length * (length - 1)
    nb = -(-length // 16)
    return nb * 240 + 16 * nb + _cumsum_flops(nb) + (nb - 1 if nb <= 16
                                                      else 0)


def xla_pointwise_cost(func, args, kwargs, outs) -> tuple:
    """(FLOPs, transcendentals) that XLA's ``HloCostAnalysis`` counts for
    the same function as ``func`` (an aten op that is not a product, a
    convolution or attention): see :data:`POINTWISE_COST`.  Moves,
    layout changes, gathers, fills and collectives count 0."""
    name = func.overloadpacket.__name__
    if not outs:
        return 0, 0
    m = outs[0].numel()
    x = args[0] if args and isinstance(args[0], torch.Tensor) else None
    n = x.numel() if x is not None else m
    base = name[:-1] if name.endswith("_") and name[:-1] in \
        POINTWISE_COST else name
    if base in POINTWISE_COST:
        f, t = POINTWISE_COST[base]
        if base in ("add", "sub") and kwargs.get("alpha", 1) != 1:
            f += 1
        return f * m, t * m
    if base == "pow":
        if isinstance(x, torch.Tensor) and not isinstance(
                args[1], torch.Tensor):
            f, t = _scalar_pow_cost(args[1])
            return f * m, t * m
        return 0, m
    if name in _CONVERTS:
        src = args[1] if name in ("copy_", "copy") else x
        if isinstance(src, torch.Tensor) and src.dtype != outs[0].dtype:
            return m, 0
        return 0, 0
    if name in _REDUCE:
        return n - m, 0
    if name == "mean":
        return n, 0
    if name in ("argmax", "argmin"):
        return 9 * (n - m), 0
    if name == "linalg_vector_norm":
        return n + n - m, m
    if name == "logsumexp":
        return 2 * (n - m) + n + 4 * m, n + m
    if name in ("_softmax", "_log_softmax"):
        rows = n // max(x.shape[args[1]], 1)
        if name == "_softmax":
            return 2 * (n - rows) + 2 * n, n
        return 2 * (n - rows) + 2 * n, n + rows
    if name == "_softmax_backward_data":
        rows = m // max(outs[0].shape[args[2]], 1)
        return 3 * m + (m - rows), 0
    if name == "_log_softmax_backward_data":
        rows = m // max(outs[0].shape[args[2]], 1)
        return 2 * m + (m - rows), m
    if name == "cumsum":
        length = x.shape[args[1]] if x.dim() else 1
        return (n // max(length, 1)) * _cumsum_flops(length), 0
    if name in ("tril", "triu"):
        return m + math.prod(outs[0].shape[-2:]), 0
    if name in ("sort", "argsort"):
        dim = kwargs.get("dim", args[1] if len(args) > 1 and isinstance(
            args[1], int) else -1)
        length = x.shape[dim] if x.dim() else 1
        return n * (max(length - 1, 0).bit_length() + 3), 0
    if name == "embedding_dense_backward":
        return args[0].numel(), 0
    if name in ("index_put", "index_put_"):
        acc = args[3] if len(args) > 3 else kwargs.get("accumulate", False)
        return (args[2].numel() if acc else 0), 0
    if name in ("scatter_add", "scatter_add_", "index_add", "index_add_"):
        return args[3].numel(), 0
    return 0, 0


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
    (local) tensors, with its result's dtype and shape, its FLOPs, the
    bytes it reads and writes (inputs plus outputs of every op that is
    not a view: ``chip_smoke.py::step_traffic``'s rule) and the peak of
    live local storage.

    FLOPs are counted as XLA's ``cost_analysis()["flops"]`` counts them,
    so that a trace compares with the JAX package's compiled step:
    products, convolutions and attention by ``torch.utils.flop_counter``'s
    formulas (2 per multiply-add), every other operation that is not a
    view by :func:`xla_pointwise_cost` (one per output element of an
    elementwise op, one per input element folded by a reduction).
    Transcendentals (``exp``, ``log``, ``rsqrt``, ``tanh`` ...) are kept
    apart, in ``transcendentals``, as XLA keeps them; collectives count
    none (XLA counts an all-reduce's adds, a few per mille of a step).

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
    library workspaces.  With ``detail``, ``peak_live`` lists what is live
    at the peak beyond the resident tensors: (op, dtype, shape, bytes) of
    each storage, by the operation that allocated it.

    Use as a context manager; ``records`` is the trace."""

    def __init__(self, resident: Any = (), detail: bool = False):
        from torch.multiprocessing.reductions import StorageWeakRef
        from torch.utils.flop_counter import flop_registry
        self._flops_of = flop_registry
        self.records: List[OpRecord] = []
        self.flops = 0.0
        self.transcendentals = 0.0
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
        self.detail = detail
        self.peak_live: List[Tuple[str, Any, Tuple[int, ...], int]] = []
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
        count = self._flops_of.get(func.overloadpacket)
        if count is not None:
            fl, tr = float(count(*args, **kwargs, out_val=out)), 0
        else:
            fl, tr = xla_pointwise_cost(func, args, kwargs, outs)
        self.ops += 1
        self.bytes += nb
        self.flops += fl
        self.transcendentals += tr
        entry = self.by_op.setdefault(name, [0, 0, 0.0])
        entry[0] += 1
        entry[1] += nb
        entry[2] += fl
        self._track(outs, name)

    def _track(self, outs: List[torch.Tensor], name: str) -> None:
        from torch.multiprocessing.reductions import StorageWeakRef
        added = False
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._resident:
                continue
            if key in self._storages:
                ref, nb, _ = self._storages[key]
                if not ref.expired():
                    continue
                self.live -= nb                  # an address reused
            label = (name, t.dtype, tuple(t.shape)) if self.detail else None
            self._storages[key] = (StorageWeakRef(st), st.nbytes(), label)
            self.live += st.nbytes()
            added = True
        if added:
            dead = [k for k, (ref, _, _) in self._storages.items()
                    if ref.expired()]
            for k in dead:
                self.live -= self._storages.pop(k)[1]
            if self.resident + self.live > self.peak:
                self.peak = self.resident + self.live
                if self.detail:
                    self.peak_live = [label + (nb,) for _, nb, label
                                      in self._storages.values()]

    def collectives(self) -> CollectiveStats:
        return collective_stats(self.records)
