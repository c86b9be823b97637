"""Logical-axis sharding on DTensor: rules, specs and in-model annotations.

Model code never names mesh axes.  It tags tensor dimensions with
*logical* axes (``shard(x, "batch", "seq", "embed")``; ``ParamDef.axes``)
and this module maps them onto whatever ``DeviceMesh`` is active through
a rules table:

    rules = {"batch": ("pod", "data"), "heads": "model", ...}

``spec_for`` turns (shape, logical axes) into a spec — a tuple with one
entry per tensor dimension: a mesh-axis name, a tuple of them, or None —
with the JAX package's two safety properties:

  * divisibility — a dimension that does not divide the mapped mesh-axis
    extent is left replicated;
  * dedup — a mesh axis is claimed by at most one tensor dimension
    (first-come, left-to-right), so ``("batch", "seq", "embed")`` under
    FSDP rules cannot double-bind ``data``.

The entries equal those of the JAX package's ``PartitionSpec`` for the
same inputs.  :func:`placements` turns a spec into DTensor placements,
one per mesh dimension.

``use_sharding`` installs (mesh, rules) for a ``with`` scope.  ``shard``
returns its argument outside one; inside one it redistributes a DTensor
to the spec's placements (a ``Partial`` left by a sharded contraction
becomes a reduce-scatter or an all-reduce there, as GSPMD resolves it)
and refuses a plain tensor.

Where DTensor has no sharding rule for the maths, :func:`run_local` runs
a function on each rank's shards (DTensor's ``local_map``), its layouts
given as logical axes; :func:`rank_slice` tells a rank which chunk of a
logical dimension it holds, :func:`is_split` whether the rules lay a
dimension out over mesh axes at all (on axes of extent 1 too) and
:func:`is_cut` whether a rank holds only a part of it.  The models call only these,
``shard``, :func:`relayout` and the product helpers: they name logical
axes, never a spec or a mesh axis, so each layout rule lives here once.
"""

from __future__ import annotations

import contextlib
import math
import sys
import threading
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import torch

#: logical axis -> mesh axis (str), mesh axes (tuple, major-to-minor), or
#: None (replicated).  Axes absent from the active mesh are filtered, so one
#: table serves both the single-pod ("data", "model") and multi-pod
#: ("pod", "data", "model") meshes.  The JAX package's table, entry for entry.
DEFAULT_RULES: Dict[str, Any] = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "seq_attn": None,        # sequence-parallel attention cells map -> model
    "seq_kv": None,          # decode KV-cache time dim (tuner-controlled)
    "vocab": "model",
    # parameters
    "embed": ("pod", "data"),    # FSDP extent; tuner maps None/data/pod_data
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_mlp": "model",
    "expert_cap": None,
    "q_lora": None,
    "kv_lora": None,
    "ssm_inner": "model",
    "ssm_heads": "model",
    "ssm_pdim": None,
    "ssm_state": None,
    "conv_dim": None,
    "layers": None,
}

Spec = Tuple[Any, ...]


def _is_dtensor(x: Any) -> bool:
    """Whether ``x`` is a DTensor — without importing DTensor: a process
    that never imported it holds none."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def _api():
    """(DTensor, Replicate, Shard, Partial), imported on first use."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    return DTensor, Replicate, Shard, Partial


class _Active(threading.local):
    def __init__(self):
        self.stack: List[Tuple[Any, Dict[str, Any]]] = []


_active = _Active()


def merged_rules(rules: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
    """``DEFAULT_RULES`` updated with ``rules``."""
    out = dict(DEFAULT_RULES)
    if rules:
        out.update(rules)
    return out


@contextlib.contextmanager
def use_sharding(mesh, rules: Optional[Mapping[str, Any]] = None
                 ) -> Iterator[None]:
    """Activate (mesh, rules) for ``shard`` annotations in this scope."""
    _active.stack.append((mesh, merged_rules(rules)))
    try:
        yield
    finally:
        _active.stack.pop()


def current() -> Optional[Tuple[Any, Dict[str, Any]]]:
    return _active.stack[-1] if _active.stack else None


def current_mesh():
    ctx = current()
    return ctx[0] if ctx else None


def mesh_sizes(mesh) -> Dict[str, int]:
    """{mesh axis name: extent}; reads only ``mesh_dim_names`` and
    ``shape``, so a stand-in object with those two serves."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]],
             rules: Mapping[str, Any], mesh) -> Spec:
    """The spec for ``shape`` whose dims carry logical ``axes``.

    Mesh axes are claimed left-to-right at most once; a mapping is applied
    only when the dimension divides the product of the (present, unclaimed)
    mesh axes it names.  Trailing replicated dims are trimmed so specs
    compare equal to their hand-written forms.
    """
    sizes = mesh_sizes(mesh)
    used: set = set()
    entries: List[Any] = [None if logical is None
                          else _claim(dim, logical, rules, sizes, used)
                          for dim, logical in zip(shape, axes)]
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def _claim(dim: int, logical: str, rules: Mapping[str, Any],
           sizes: Mapping[str, int], used: set) -> Any:
    """The spec entry of a dimension of length ``dim`` with axis
    ``logical``: the mesh axes its rule names that are present and not in
    ``used``, if ``dim`` divides their extent (then added to ``used``),
    else None.  The one resolution rule of :func:`spec_for` and
    :func:`_axis_table`."""
    mapped = rules.get(logical)
    names = (tuple(mapped) if isinstance(mapped, (tuple, list))
             else (mapped,) if mapped is not None else ())
    cand = [m for m in names if m in sizes and m not in used]
    if not cand or dim % math.prod(sizes[m] for m in cand):
        return None
    used.update(cand)
    return cand[0] if len(cand) == 1 else tuple(cand)


def placements(spec: Spec, ndim: int, mesh) -> Tuple[Any, ...]:
    """DTensor placements of ``spec``: one per mesh dimension, ``Shard(d)``
    where tensor dim ``d`` names that mesh axis, else ``Replicate()``.  A
    dim mapped to ("pod", "data") is sharded over both mesh dims in mesh
    order — JAX's major-to-minor.  A mesh dim of extent 1 is
    ``Replicate()``: its one shard is the whole tensor either way."""
    _, Replicate, Shard, _ = _api()
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    owner: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                owner[name] = d
    return tuple(Shard(owner[n]) if n in owner and size > 1 else Replicate()
                 for n, size in zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def local_shape(shape: Sequence[int], places: Sequence[Any], mesh
                ) -> Tuple[int, ...]:
    """The shape of one rank's shard (``spec_for`` shards evenly only)."""
    Shard = _api()[2]
    out = list(shape)
    for size, p in zip(tuple(mesh.shape), places):
        if isinstance(p, Shard):
            if out[p.dim] % size:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"divide {size}")
            out[p.dim] //= size
    return tuple(out)


def shard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Lay ``x`` out by logical axes; ``x`` itself outside a mesh scope.

    Inside a scope ``x`` must be a DTensor on the scope's mesh: a plain
    tensor here would be one rank's values taken for the whole, so it
    raises."""
    ctx = current()
    if ctx is None:
        return x
    mesh, rules = ctx
    if not _is_dtensor(x):
        raise TypeError(f"shard{axes}: a plain {type(x).__name__} inside a "
                        f"mesh scope; distribute it first")
    want = placements(spec_for(x.shape, axes, rules, mesh), x.dim(), mesh)
    if not x.requires_grad:
        return x if tuple(x.placements) == want else \
            x.redistribute(mesh, want)
    return _Constrain.apply(x, mesh, want)


class _Constrain(torch.autograd.Function):
    """``x`` redistributed to ``want``, whose gradient is redistributed to
    ``want`` too: the transpose of JAX's ``with_sharding_constraint`` is
    the same constraint on the cotangent.  DTensor's own redistribute
    leaves the gradient in whatever layout reached it (a partial sum
    over the heads that a column-parallel projection's backward left),
    and a later backward product then gathers activations instead."""

    @staticmethod
    def forward(ctx, x, mesh, want):
        ctx.layout = (mesh, want)
        if tuple(x.placements) == want:
            return x.view_as(x)
        return x.redistribute(mesh, want)

    @staticmethod
    def backward(ctx, g):
        mesh, want = ctx.layout
        if tuple(g.placements) != want:
            g = g.redistribute(mesh, want)
        return g, None, None


def sharding_for(shape: Sequence[int], axes: Sequence[Optional[str]],
                 mesh, rules: Optional[Mapping[str, Any]] = None
                 ) -> Tuple[Any, ...]:
    """The DTensor placements of ``shape`` under ``rules`` on ``mesh``."""
    spec = spec_for(shape, axes, merged_rules(rules), mesh)
    return placements(spec, len(shape), mesh)


def per_batch(fn, *args, outs: int = 1):
    """``fn`` on each rank's rows of the leading (batch) dimension.

    For the few operations DTensor has no sharding rule for that act row
    by row (a stable sort, a one-hot, a roll along the sequence, the MoE
    dispatch's index writes): :func:`run_local` with every tensor laid
    out batch-sharded by the rules and replicated over every other mesh
    axis, and each of ``fn``'s ``outs`` results laid out so.  Outside a
    scope it is ``fn(*args)``."""
    if current() is None:
        return fn(*args)
    ref = next(a for a in args if isinstance(a, torch.Tensor))
    lead = scope_spec((ref.shape[0],), ("batch",))
    return _run_local(fn, args, [lead] * len(args), [lead] * outs)


def chunk_of(entry: Any, length: int) -> Tuple[Tuple[int, ...], int, int]:
    """(mesh dims, lo, hi): this rank's chunk ``[lo, hi)`` of a dimension
    of ``length`` laid out by one spec ``entry`` (a mesh-axis name, a
    tuple of them, or None) on the scope's mesh; no mesh dims and the
    whole ``[0, length)`` outside a scope, for None, or where the axes'
    extent is 1."""
    ctx = current()
    if ctx is None or entry is None:
        return (), 0, length
    mesh = ctx[0]
    names = entry if isinstance(entry, tuple) else (entry,)
    dims = tuple(mesh.mesh_dim_names.index(n) for n in names)
    index, count = 0, 1
    for d in dims:                                 # major-to-minor
        size = mesh.size(d)
        index = index * size + mesh.get_local_rank(d)
        count *= size
    if count == 1:
        return (), 0, length
    step = length // count
    return dims, index * step, (index + 1) * step


def rank_slice(shape: Sequence[int], axes: Sequence[Optional[str]],
               dim: int) -> Tuple[int, int]:
    """``(lo, hi)``: this rank's chunk of dimension ``dim`` of a tensor of
    ``shape`` laid out by logical ``axes`` under the scope (:func:`chunk_of`
    of that dimension's spec entry); the whole dimension outside a scope or
    where the rules leave it whole."""
    return chunk_of(scope_spec(shape, axes)[dim], shape[dim])[1:]


def is_split(shape: Sequence[int], axes: Sequence[Optional[str]],
             dim: int) -> bool:
    """Whether the scope's rules lay dimension ``dim`` of a tensor of
    ``shape`` with logical ``axes`` out over mesh axes: its spec entry is
    not None, on axes of extent 1 too, so that a 1x1 mesh runs the code
    path a larger mesh runs.  False outside a scope."""
    return scope_spec(shape, axes)[dim] is not None


def is_cut(shape: Sequence[int], axes: Sequence[Optional[str]],
           dim: int) -> bool:
    """Whether this rank holds only a part of dimension ``dim`` of a
    tensor of ``shape`` with logical ``axes``: the rules lay it out over
    mesh axes whose extent is above 1.  Unlike :func:`is_split`, false on
    a 1x1 mesh, where each rank holds the whole dimension."""
    return bool(chunk_of(scope_spec(shape, axes)[dim], shape[dim])[0])


def reshape(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``x.reshape(shape)``.  A DTensor is first replicated over the mesh
    dims that shard it where the reshape cannot carry the shard: a merged
    dim sharded past its first member, or a split dim whose first part
    does not divide the mesh extent (DTensor refuses both views).  Its
    gradient is reshaped back the same way."""
    if not _is_dtensor(x):
        return x.reshape(shape)
    return _Reshape.apply(x, tuple(shape))


class _Reshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = tuple(x.shape)
        return _carry_reshape(x, shape)

    @staticmethod
    def backward(ctx, g):
        return _carry_reshape(g, ctx.shape), None


def _carry_reshape(x, shape: Tuple[int, ...]):
    _, Replicate, Shard, _ = _api()
    shape = tuple(shape)
    if -1 in shape:
        known = math.prod(s for s in shape if s != -1)
        shape = tuple(x.numel() // known if s == -1 else s for s in shape)
    # group input dims with the output dims they become (dims merge or
    # split left to right; equal sizes pair off)
    i = j = 0
    bad = set()
    src, dst = tuple(x.shape), shape
    while i < len(src) and j < len(dst):
        a, b, gi, gj = src[i], dst[j], [i], [j]
        while a != b:
            if a < b:
                i += 1
                a *= src[i]
                gi.append(i)
            else:
                j += 1
                b *= dst[j]
                gj.append(j)
        for m, p in enumerate(x.placements):
            if isinstance(p, Shard) and p.dim in gi:
                extent = x.device_mesh.size(m)
                if p.dim != gi[0] or (len(gj) > 1 and dst[gj[0]] % extent):
                    bad.add(m)
        i, j = i + 1, j + 1
    if bad:
        x = x.redistribute(x.device_mesh,
                           [Replicate() if m in bad else p
                            for m, p in enumerate(x.placements)])
    return x.reshape(shape)


def take_last(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[..., index]`` for an integer ``index`` of ``x``'s leading shape
    (``torch.gather`` on the last dim).  Where the rules shard ``x``'s
    last dim as "vocab", each rank gathers from its own chunk (zero for an
    index outside it) and the partial values are summed across the chunk's
    mesh axes — what DTensor's masked gather does, without its mask
    buffer (which meta tensors cannot hold)."""
    if current() is None:
        return torch.gather(x, -1, index.long()[..., None])[..., 0]
    vocab = scope_spec((x.shape[-1],), ("vocab",))[0]
    dims, lo, hi = chunk_of(vocab, x.shape[-1])
    lead = scope_spec(index.shape, ("batch",) + (None,) * (index.dim() - 1))

    def gather(t, i):
        i = i.long()
        if not dims:
            return torch.gather(t, -1, i[..., None])[..., 0]
        inside = (i >= lo) & (i < hi)
        g = torch.gather(t, -1, torch.where(inside, i - lo, 0)[..., None])
        return torch.where(inside, g[..., 0], torch.zeros_like(g[..., 0]))

    xspec = lead + (None,) * (x.dim() - 1 - len(lead)) + (
        vocab if dims else None,)
    return replicate(_run_local(gather, (x, index), (xspec, lead), (lead,),
                                partial=dims), dims)

class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _run_local(fn, args: Sequence[Any], specs: Sequence[Optional[Spec]],
               out_specs: Sequence[Spec], partial: Sequence[int] = ()):
    """``fn`` on each rank's shards, for maths that is independent along
    the split dimensions (per batch row, per head): DTensor's
    ``local_map``, with layouts given as specs (:func:`run_local` takes
    logical axes).

    Outside a scope it is ``fn(*args)``.  Inside one each tensor argument
    is laid out by its spec (a tuple of mesh-axis entries per dimension,
    as :func:`spec_for` returns; a spec of None keeps a DTensor's layout
    — an in-place buffer; a plain tensor is a value the model made, the
    same on every rank), ``fn`` runs on the local shards, and its tensor
    results (one per entry of ``out_specs``: a tensor for one, else a
    tuple) come back as DTensors laid out by ``out_specs`` and, over the
    mesh dims in ``partial``, as partial sums (each rank summed its own
    part of the work; the caller's next ``shard`` or :func:`replicate`
    adds them up).  An argument replicated over a mesh dim the results
    are split or partial over gets a ``Partial`` gradient there: each
    rank saw only its part of the work."""
    ctx = current()
    if ctx is None:
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map
    mesh = ctx[0]
    DTensor, Replicate, _, Partial = _api()
    outs = [[Partial() if m in partial else p
             for m, p in enumerate(placements(s, len(s), mesh))]
            for s in out_specs]
    split = {m for pl in outs for m, p in enumerate(pl)
             if not isinstance(p, Replicate)}
    rep = (Replicate(),) * mesh.ndim
    dargs, ins, grads = [], [], []
    for a, spec in zip(args, specs):
        if isinstance(a, torch.Tensor):
            if not _is_dtensor(a):
                a = DTensor.from_local(a, mesh, rep, run_check=False)
            want = (tuple(a.placements) if spec is None
                    else placements(spec, a.dim(), mesh))
            ins.append(want)
            grads.append(tuple(
                Partial() if m in split and isinstance(p, Replicate) else p
                for m, p in enumerate(want)))
        else:
            ins.append(None)
            grads.append(None)
        dargs.append(a)

    def local(*xs):
        # DTensor views its local shards with ``view``, which a transposed
        # shard refuses: results and the gradients leaving the region are
        # made contiguous
        out = fn(*(_ContiguousGrad.apply(x) if isinstance(x, torch.Tensor)
                   else x for x in xs))
        if isinstance(out, tuple):
            return tuple(t.contiguous() for t in out)
        return out.contiguous()

    return local_map(local, outs[0] if len(outs) == 1 else tuple(outs),
                     ins, grads, mesh, redistribute_inputs=True)(*dargs)


#: per mesh dim, the layouts of a product's operands and result given the
#: operands' own: (x's, w's) -> (x wanted, w wanted, result), for x (M, K)
#: and w (K, N); "S0"/"S1" shard a dim, "R" replicates, "P" is a partial sum
_MATMUL_LAYOUT = {
    ("S0", "R"): ("S0", "R", "S0"), ("S0", "S0"): ("S0", "R", "S0"),
    ("S0", "S1"): ("S0", "R", "S0"),      # rows win; the weight gathered
    ("R", "S1"): ("R", "S1", "S1"),
    ("S1", "S0"): ("S1", "S0", "P"),
    ("R", "S0"): ("S1", "S0", "P"),       # x cut locally to w's rows
    ("S1", "R"): ("S1", "S0", "P"),       # w cut locally to x's columns
    ("S1", "S1"): ("R", "S1", "S1"),      # x gathered, w keeps its columns
    ("R", "R"): ("R", "R", "R"),
}
#: (R, R) with fewer rows than the contraction: both operands cut along
#: it and the (small) result partial, not the whole product on every rank
_MATMUL_FEW_ROWS = ("S1", "S0", "P")


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a 2-D ``x`` (M, K) and ``w`` (K, N), each rank
    multiplying its own shards in the layout GSPMD gives the product of
    annotated operands (:data:`_MATMUL_LAYOUT`, mesh dim by mesh dim): a
    mesh dim that splits x's rows splits the result's rows and gathers
    the weight there (FSDP); one that splits w's columns splits the
    result's columns; one that splits the contraction leaves the result
    partial; one that splits neither leaves the product whole on every
    rank, unless x has fewer rows than the contraction is long: then both
    are cut along the contraction and the result, smaller than the
    operands, is partial.  The backward's two products follow the same
    rule (a weight's gradient ``x.T @ g`` has few rows and a long
    contraction, so it is cut where the forward product was whole), as
    GSPMD partitions the transposed program: without that cut the
    granite cells of ``tests/test_torch_dryrun_parity.py`` repeat on
    every rank work that the JAX step splits.  A decode step's few rows
    do not move to a split weight: GSPMD gathers the weight there too.
    DTensor's own choice may instead cut a whole operand unevenly along
    a dim the rules leave whole and gather a large result (the logits of
    a vocabulary of 50,280 on 16 ranks).  Plain tensors: ``x @ w``."""
    if not (_is_dtensor(x) and _is_dtensor(w)):
        return x @ w
    x, w = _Operands.apply(x, w)
    return _Matmul.apply(x, w, x.grad_fn)


def _local_matmul(x, w):
    """``x @ w`` of two 2-D DTensors in :func:`matmul`'s layout, outside
    autograd: the operands redistributed, the local product wrapped."""
    DTensor, Replicate, Shard, Partial = _api()
    mesh = x.device_mesh

    def code(p):
        return f"S{p.dim}" if isinstance(p, Shard) else "R"

    def place(c):
        return {"S0": Shard(0), "S1": Shard(1), "R": Replicate(),
                "P": Partial()}[c]

    x = replicate(x, [m for m, p in enumerate(x.placements)
                      if isinstance(p, Partial)])
    M, K = x.shape

    def rule(m, pair):
        if mesh.size(m) > 1 and pair == ("R", "R") and M < K:
            return _MATMUL_FEW_ROWS
        return _MATMUL_LAYOUT[pair]

    want = [rule(m, (code(px), code(pw)))
            for m, (px, pw) in enumerate(zip(x.placements, w.placements))]
    x = _redistribute(x, [place(a) for a, _, _ in want])
    w = _redistribute(w, [place(b) for _, b, _ in want])
    out = x.to_local() @ w.to_local()
    return DTensor.from_local(out, mesh, [place(c) for _, _, c in want],
                              run_check=False,
                              shape=torch.Size((x.shape[0], w.shape[1])),
                              stride=(w.shape[1], 1))


def _redistribute(t, placements):
    """``t`` in ``placements``.  Where its split only moves from one mesh
    dim to another of the same size (a weight split on "data" wanted
    split on "model", the decode head's few rows), each rank receives the
    one shard it needs from the rank with its coordinates on the two dims
    swapped: an all-to-all that moves one shard a rank, GSPMD's
    collective-permute.  DTensor would gather the whole tensor over the
    first dim and keep a chunk.  Otherwise DTensor's redistribution."""
    import torch.distributed as dist
    DTensor, Replicate, Shard, _ = _api()
    mesh, have = t.device_mesh, list(t.placements)
    if have == list(placements):
        return t
    moved = [m for m, (a, b) in enumerate(zip(have, placements)) if a != b]
    if len(moved) == 2 and mesh.size() == dist.get_world_size():
        m1, m2 = moved if isinstance(have[moved[0]], Shard) else moved[::-1]
        a, b = have[m1], placements[m2]
        if isinstance(a, Shard) and a == b and \
                have[m2] == placements[m1] == Replicate() and \
                not any(p == a for m, p in enumerate(have) if m != m1) and \
                mesh.size(m1) == mesh.size(m2) and \
                t.shape[a.dim] % mesh.size(m1) == 0:
            from torch.distributed._functional_collectives import (
                all_to_all_single)
            c = list(mesh.get_coordinate())
            c[m1], c[m2] = c[m2], c[m1]
            peer = mesh.mesh.tolist()
            for i in c:
                peer = peer[i]
            splits = [0] * dist.get_world_size()
            local = t.to_local()
            splits[peer] = local.numel()
            got = all_to_all_single(local.reshape(-1), splits, splits,
                                    dist.group.WORLD)
            return DTensor.from_local(got.view(local.shape), mesh,
                                      placements, run_check=False,
                                      shape=t.shape, stride=t.stride())
    return t.redistribute(mesh, placements)


class _Operands(torch.autograd.Function):
    """``(x, w)`` as they are, saved for :class:`_Matmul`'s backward.
    Saved here, before the product runs, as autograd saves a built-in
    product's operands: ``torch.utils.checkpoint`` stops recomputing a
    layer at its last saved tensor, and operands saved when the product
    returns would have it recompute a layer's last product for nothing."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return x.view_as(x), w.view_as(w)

    @staticmethod
    def backward(ctx, gx, gw):
        return gx, gw


class _Matmul(torch.autograd.Function):
    """:func:`matmul`, whose backward products take its layout rule too;
    its operands are those ``saved`` (an :class:`_Operands` node) holds."""

    @staticmethod
    def forward(ctx, x, w, saved):
        ctx.saved = saved
        return _local_matmul(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved.saved_tensors
        gx = _local_matmul(g, w.t()) if ctx.needs_input_grad[0] else None
        gw = _local_matmul(x.t(), g) if ctx.needs_input_grad[1] else None
        return gx, gw, None


def project_heads(x: torch.Tensor, w: torch.Tensor, group: int,
                  axes: Axes, bias: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """``repeat_interleave(x @ w + bias, group, dim=2)`` for ``x`` (B, S, d),
    ``w`` (d, KV, hd) and ``bias`` (KV, hd): the keys or values of an
    attention whose KV heads are repeated over its ``KV * group`` query
    heads, laid out by ``axes`` (B, S, heads, hd).

    The layout rule of a product whose weight's output dims cannot take
    the mesh axis that splits the query heads (KV does not divide its
    extent M: granite-3-2b's 8 KV heads on 16 "model" ranks), as GSPMD
    lays it out: each rank gathers (FSDP) only the columns of the KV head
    its own query heads use and projects it, so the M / KV ranks whose
    query heads share a KV head each project it whole (the JAX compile's
    one KV head a rank, two ranks a head); nothing else is gathered.  In
    the backward each rank multiplies its own part of the head's
    gradient into ``x``'s (left partial over that axis), and the ranks of
    a head sum their parts (an all-reduce among them) and each forms its
    own rows of ``w``'s gradient (zero outside them, partial over the
    mesh axes; the parameter's own layout reduces it).  Raises outside a
    scope, or where the rules split the query heads over no mesh dim,
    over more than one, or over one whose extent KV does not divide.
    """
    B, S, d = x.shape
    KV, hd = w.shape[1], w.shape[2]
    mesh = current_mesh()
    spec = scope_spec((B, S, KV * group, hd), axes)
    hdims, lo, hi = chunk_of(spec[2], KV * group)
    if len(hdims) != 1 or mesh.size(hdims[0]) % KV:
        raise ValueError(f"project_heads{tuple(axes)}: {KV} KV heads on "
                         f"the query heads' mesh dims {hdims} of {mesh}")
    x = relayout(x, axes[0], axes[1], None)
    _, Replicate, Shard, Partial = _api()
    for m, p in enumerate(w.placements):
        if isinstance(p, Partial) or (isinstance(p, Shard) and p.dim) or \
                (m in hdims and not isinstance(p, Replicate)):
            raise ValueError(f"project_heads: a weight laid out {w.placements}"
                             f" (want its KV heads whole on mesh dims {hdims})")
    # the ranks of one KV head: consecutive blocks along the heads' dim
    dim, size = hdims[0], mesh.size(hdims[0]) // KV
    sub = _split_mesh(mesh, dim, size)
    return _HeadProjection.apply(
        x, w, bias, group, (lo, hi, lo // group),
        (dim, sub, mesh.get_local_rank(dim) % size, size),
        placements(spec, 4, mesh))


def _split_mesh(mesh, dim: int, size: int):
    """``mesh`` with its dim ``dim`` viewed as (extent / size, size): the
    same ranks, whose last new dim (``dim + 1``) groups ``size``
    consecutive ones.  Built once a mesh (its process groups are made
    collectively, so every rank builds it at the same point)."""
    cache = mesh.__dict__.setdefault("_split_meshes", {})
    if (dim, size) not in cache:
        from torch.distributed.device_mesh import DeviceMesh
        shape = list(mesh.mesh.shape)
        shape[dim:dim + 1] = [shape[dim] // size, size]
        names = list(mesh.mesh_dim_names)
        names[dim:dim + 1] = [names[dim] + "_outer", names[dim] + "_inner"]
        cache[(dim, size)] = DeviceMesh(mesh.device_type,
                                        mesh.mesh.reshape(shape),
                                        mesh_dim_names=tuple(names))
    return cache[(dim, size)]


def _gather_columns(w, k0: int, k1: int) -> torch.Tensor:
    """The local (d, k1 - k0, ...) columns ``[k0, k1)`` of a DTensor ``w``
    whole on every mesh dim but those that split its rows (FSDP), gathered
    over those: a gather of the columns alone."""
    DTensor, Replicate, Shard, _ = _api()
    local = w.to_local()[:, k0:k1]
    split = [p if isinstance(p, Shard) else Replicate() for p in w.placements]
    if all(isinstance(p, Replicate) for p in split):
        return local
    shape = (w.shape[0],) + tuple(local.shape[1:])
    cols = DTensor.from_local(local.contiguous(), w.device_mesh, split,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())
    return cols.redistribute(w.device_mesh,
                             [Replicate()] * w.device_mesh.ndim).to_local()


class _HeadProjection(torch.autograd.Function):
    """:func:`project_heads` on each rank's KV head ``k0``, of which its
    query heads ``[lo, hi)`` take ``copies`` each; ``ranks`` (mesh dim,
    split mesh, this rank's index among the head's ranks, their count)
    names the ranks of that head."""

    @staticmethod
    def forward(ctx, x, w, bias, copies, heads, ranks, out_pl):
        DTensor = _api()[0]
        lo, hi, k0 = heads
        B, S, d = x.shape
        KV, hd = w.shape[1], w.shape[2]
        xl = x.to_local()
        wl = _gather_columns(w, k0, k0 + 1)[:, 0]            # (d, hd)
        out = (xl.reshape(-1, d) @ wl).reshape(xl.shape[:2] + (1, hd))
        if bias is not None:
            out = out + bias.to_local()[k0]
        out = out.expand(xl.shape[:2] + (hi - lo, hd))
        ctx.save_for_backward(x, wl)
        ctx.layout = (k0, ranks, KV, out_pl)
        H = KV * copies
        return DTensor.from_local(out.contiguous(), x.device_mesh, out_pl,
                                  run_check=False,
                                  shape=torch.Size((B, S, H, hd)),
                                  stride=(S * H * hd, H * hd, hd, 1))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed._functional_collectives import all_reduce
        DTensor, Replicate, Shard, Partial = _api()
        k0, (dim, sub, index, size), KV, out_pl = ctx.layout
        x, wl = ctx.saved_tensors
        mesh = x.device_mesh
        if tuple(g.placements) != out_pl:
            g = g.redistribute(mesh, out_pl)
        dk = g.to_local().sum(dim=2)                # this rank's part (.., hd)
        dk2 = dk.reshape(-1, dk.shape[-1])
        xl = x.to_local()
        d = xl.shape[-1]
        # x's gradient: partial over the heads' mesh dim (each rank's query
        # heads contribute their part)
        gx = DTensor.from_local(
            (dk2 @ wl.t()).reshape(xl.shape), mesh,
            [Partial() if m == dim else p for m, p in enumerate(x.placements)],
            run_check=False, shape=x.shape, stride=x.stride())
        # w's and bias's: the head's parts summed among its ranks, each
        # rank forming its rows of the head's columns; zero elsewhere,
        # partial over the heads' dim and over the dims that split x
        rows = [Partial() if m == dim or isinstance(p, Shard) else Replicate()
                for m, p in enumerate(x.placements)]
        gw = gb = None
        if ctx.needs_input_grad[1]:
            total = all_reduce(dk2, "sum", (sub, dim + 1)) if size > 1 \
                else dk2
            r0, r1 = index * d // size, (index + 1) * d // size
            full = wl.new_zeros((d, KV, wl.shape[-1]))
            full[r0:r1, k0] = xl.reshape(-1, d)[:, r0:r1].t() @ total
            gw = DTensor.from_local(full, mesh, rows, run_check=False,
                                    shape=full.shape, stride=full.stride())
        if ctx.needs_input_grad[2]:
            full = dk2.new_zeros((KV, dk2.shape[-1]))
            full[k0] = dk2.sum(dim=0)
            gb = DTensor.from_local(full, mesh, rows, run_check=False,
                                    shape=full.shape, stride=full.stride())
        return gx, gw, gb, None, None, None, None


def scope_spec(shape: Sequence[int], axes: Sequence[Optional[str]]) -> Spec:
    """``spec_for`` under the scope's rules and mesh, padded with None to
    one entry per dim (all None outside a scope)."""
    ctx = current()
    if ctx is None:
        return (None,) * len(shape)
    mesh, rules = ctx
    spec = spec_for(shape, axes, rules, mesh)
    return spec + (None,) * (len(shape) - len(spec))


#: a tensor's layout in logical terms: one logical axis (or None) a dim
Axes = Tuple[Optional[str], ...]


def _axis_table(items: Sequence[Tuple[Optional[Sequence[int]], Axes]],
                rules: Mapping[str, Any], mesh) -> Dict[str, Any]:
    """{logical axis: spec entry} for the tensors of one local computation,
    ``items`` as (shape, logical axes), resolved jointly: an axis takes its
    entry where it first appears (the rules' mesh axes less those an
    earlier axis claimed, if the dimension divides their extent) and keeps
    it in every later tensor, so that the operands of the computation
    agree on each axis.  For the first tensor this is :func:`spec_for`.
    A result's axes (shape None) must all have appeared before."""
    sizes = mesh_sizes(mesh)
    table: Dict[str, Any] = {}
    used: set = set()
    for shape, axes in items:
        for i, name in enumerate(axes):
            if name is None or name in table:
                continue
            if shape is None:
                raise ValueError(f"logical axis {name!r} of a result is on "
                                 f"no operand: name its layout in ``like``")
            table[name] = _claim(shape[i], name, rules, sizes, used)
    return table


def _table_spec(shape: Optional[Sequence[int]], axes: Axes,
                table: Mapping[str, Any], mesh) -> Spec:
    """The spec of a tensor with logical ``axes`` under ``table``; raises
    where an operand's dimension does not divide its entry's extent."""
    sizes = mesh_sizes(mesh)
    spec = []
    for i, name in enumerate(axes):
        entry = None if name is None else table[name]
        if entry is not None and shape is not None:
            extent = math.prod(sizes[m] for m in (
                entry if isinstance(entry, tuple) else (entry,)))
            if shape[i] % extent:
                raise ValueError(f"dim {i} of {tuple(shape)} ({name!r}) does "
                                 f"not divide {entry} ({extent})")
        spec.append(entry)
    return tuple(spec)


def run_local(fn, args: Sequence[Any], in_axes: Sequence[Optional[Axes]],
              out_axes: Sequence[Axes], partial: Sequence[str] = (),
              like: Optional[Tuple[Sequence[int], Axes]] = None):
    """``fn`` on each rank's shards, its layouts given as logical axes:
    for maths that is independent along the split dimensions (per batch
    row, per head) and that DTensor has no sharding rule for.

    ``in_axes`` has one entry an argument: a tuple of logical axes, one a
    leading dim (``()``: replicated), or None (a DTensor keeps its layout:
    an in-place buffer; a non-tensor argument).  ``out_axes`` has one
    tuple a result.  The axes are resolved jointly (:func:`_axis_table`):
    ``like`` (shape, axes) first when given, then the arguments in order,
    so every tensor agrees with the first on the axes they share.  Over
    the mesh axes of the logical axes in ``partial`` the results are
    partial sums (each rank summed its own part of the work; the caller's
    next ``shard`` or :func:`replicate` adds them up).  Outside a scope it
    is ``fn(*args)``; inside one :func:`_run_local` with the specs."""
    ctx = current()
    if ctx is None:
        return fn(*args)
    mesh, rules = ctx
    tensors = [(a, ax) for a, ax in zip(args, in_axes)
               if isinstance(a, torch.Tensor) and ax is not None]
    table = _axis_table(([like] if like else [])
                        + [(tuple(a.shape), ax) for a, ax in tensors]
                        + [(None, ax) for ax in out_axes], rules, mesh)
    specs = [_table_spec(a.shape, ax, table, mesh)
             if isinstance(a, torch.Tensor) and ax is not None else None
             for a, ax in zip(args, in_axes)]
    outs = [_table_spec(None, ax, table, mesh) for ax in out_axes]
    dims = tuple(sorted({m for name in partial
                         for m in chunk_of(table[name], 1)[0]}))
    return _run_local(fn, args, specs, outs, partial=dims)


def relayout(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """``x`` laid out by logical axes as :func:`shard` lays it out, its
    gradient returned in ``x``'s own layout (DTensor's redistribution)
    instead of being held to the new one: for a value gathered once where
    the maths needs it whole, whose gradient goes back to the shard it
    came from (a reduce-scatter of a partial sum, a slice of a replicated
    one).  ``x`` itself outside a scope or where it is laid out so
    already; a plain tensor inside a scope raises, as in :func:`shard`."""
    ctx = current()
    if ctx is None:
        return x
    mesh, rules = ctx
    if not _is_dtensor(x):
        raise TypeError(f"relayout{axes}: a plain {type(x).__name__} inside "
                        f"a mesh scope; distribute it first")
    want = placements(spec_for(x.shape, axes, rules, mesh), x.dim(), mesh)
    if tuple(x.placements) == want:
        return x
    out = x.redistribute(mesh, want)
    local = out.to_local()
    # a shard cut from a whole tensor is a view of it: copied, so that the
    # whole can be freed while the shard is kept (a saved layer input)
    if local.untyped_storage().nbytes() > local.numel() * local.itemsize:
        out = out.clone()
    return out


def embed_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: rows of a (V, d) table for integer ``ids``.  Inside
    a scope each rank looks up its chunk of the vocabulary (the rules'
    "vocab" axes; the table all-gathered over any others), zero for an id
    outside it, and the partial rows are summed across the chunk's mesh
    axes by the caller's next ``shard``."""
    if current() is None:
        return table[ids]
    table = grad_as_input(table)
    V = table.shape[0]
    vocab = scope_spec((V,), ("vocab",))[0]
    dims, lo, hi = chunk_of(vocab, V)
    lead = scope_spec(ids.shape, ("batch",) + (None,) * (ids.dim() - 1))

    # a table split along d (FSDP) is gathered transposed: DTensor gathers
    # a later dim through a buffer of the leading one and a concatenation,
    # two whole tables at once; along the leading dim it is one.  With so
    # few ids that moving them and their rows costs less than the table (a
    # decode step), the ids are gathered instead and each rank looks up
    # its columns of every row; the caller's ``shard`` moves the rows
    split_d = _split_dims(table, (1,))
    few = bool(split_d) and \
        ids.numel() * (1 + table.shape[1]) < table.numel()
    flip = bool(split_d) and not few

    def rows(t, i):
        if flip:
            t = t.t()
        if not dims:
            return t[i]
        i = i.long()
        inside = (i >= lo) & (i < hi)
        out = t[torch.where(inside, i - lo, 0)]
        return torch.where(inside[..., None], out, torch.zeros_like(out))

    entry = vocab if dims else None
    if few:
        names = tuple(table.device_mesh.mesh_dim_names[m] for m in split_d)
        d_entry = names[0] if len(names) == 1 else names
        return _run_local(rows, (table, ids), ((entry, d_entry), ()),
                          ((None,) * ids.dim() + (d_entry,),), partial=dims)
    return _run_local(rows, (table.t() if flip else table, ids),
                      ((None, entry) if flip else (entry,), lead), (lead,),
                      partial=dims)

def replicate(x: torch.Tensor, dims: Optional[Sequence[int]] = None
              ) -> torch.Tensor:
    """``x`` replicated over the mesh dims ``dims`` (default: all) — an
    all-reduce of a partial sum or mean, an all-gather of a shard — its
    other placements kept; a plain tensor as it is.  Used where a
    reduction's partial result meets other values: DTensor does not turn
    one kind of partial into another, nor a shard into a partial."""
    if not _is_dtensor(x):
        return x
    Replicate = _api()[1]
    want = tuple(Replicate() if dims is None or m in dims else p
                 for m, p in enumerate(x.placements))
    return x if tuple(x.placements) == want else \
        x.redistribute(x.device_mesh, want)


def _split_dims(x: torch.Tensor, dims: Sequence[int]) -> Tuple[int, ...]:
    """The mesh dims that split ``x`` (a DTensor) along any of ``dims``;
    () for a plain tensor or one that holds a partial sum (DTensor then
    resolves the reduction itself)."""
    if not _is_dtensor(x):
        return ()
    _, _, Shard, Partial = _api()
    if any(isinstance(p, Partial) for p in x.placements):
        return ()
    dims = {d % x.dim() for d in dims}
    return tuple(m for m, p in enumerate(x.placements)
                 if isinstance(p, Shard) and p.dim in dims)


def _local_reduce(fn, x: torch.Tensor, split: Tuple[int, ...],
                  kind: str = "sum") -> torch.Tensor:
    """``fn`` (a reduction that keeps its dims) on each rank's shard of
    ``x``; the results are partial over the mesh dims ``split`` (of kind
    ``kind``) and replicated there by one all-reduce of the reduced
    tensor."""
    from torch.distributed.tensor.experimental import local_map
    Partial = _api()[3]
    outs = [Partial(kind) if m in split else p
            for m, p in enumerate(x.placements)]
    part = local_map(lambda t: fn(_ContiguousGrad.apply(t)).contiguous(),
                     outs, (tuple(x.placements),), (tuple(x.placements),),
                     x.device_mesh, redistribute_inputs=False)(x)
    return replicate(part, split)


def mean_over(x: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """``torch.mean(x, dims, keepdim=True)``.  Where the mesh splits ``x``
    along ``dims``, each rank sums its own shard and only the (..., 1)
    partial sums are all-reduced, forward and backward, as XLA reduces a
    sharded dim; DTensor alone would gather ``x`` (the norms over
    channels split by heads)."""
    dims = tuple(dims)
    split = _split_dims(x, dims)
    if not split:
        return torch.mean(x, dim=dims, keepdim=True)
    count = math.prod(x.shape[d] for d in dims)
    return _local_reduce(lambda t: t.sum(dim=dims, keepdim=True), x,
                         split) / count


def logsumexp_last(x: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp(x, -1)``.  Where the mesh splits the last dim
    (vocab-sharded logits), each rank takes its shard's max, the maxima
    are all-reduced (max), each rank sums ``exp`` of its shard less it,
    and the sums are all-reduced: two reduced tensors cross the mesh,
    never the logits."""
    split = _split_dims(x, (-1,))
    if not split:
        return torch.logsumexp(x, dim=-1)
    with torch.no_grad():
        top = _local_reduce(lambda t: t.amax(dim=-1, keepdim=True),
                            x.detach(), split, "max")
    total = _local_reduce(lambda t: torch.exp(t - top.to_local()).sum(
        dim=-1, keepdim=True), x, split)
    return (top + torch.log(total))[..., 0]


class _GradLayout(torch.autograd.Function):
    """The identity, whose gradient is laid out as its input was."""

    @staticmethod
    def forward(ctx, x):
        ctx.layout = (x.device_mesh, tuple(x.placements))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, want = ctx.layout
        return g if tuple(g.placements) == want else \
            g.redistribute(mesh, want)


def grad_as_input(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose gradient arrives laid out as ``x`` is.  For a
    parameter used twice (a tied embedding: the lookup and the LM head),
    so that autograd adds two gradients of one layout — DTensor may give
    each use's gradient another one and cannot add every pair (a shard to
    a partial sum) — and for each layer's view of a stacked parameter, so
    that its partial gradient is reduced to its shard in the backward.  A
    plain tensor is returned as it is."""
    return _GradLayout.apply(x) if _is_dtensor(x) else x
