"""AdamW's step on the card in two hand-written CUDA passes
(``csrc/adamw.cu``): the global norm of the gradients, then one read and
one write of every parameter and moment element.

``adamw.update_`` sends here every tree with a leaf on a CUDA device.
:class:`Leaves` checks them once and raises ``ValueError`` on what
the passes do not take; plain tensors go as they are, DTensor leaves as
their shards (:func:`shards`), whose sums of squares are added over the
mesh before the square root.  Given the same clip scale, learning rate and
bias corrections, :meth:`Leaves.update` writes ``adamw._leaf``'s values
bit for bit; the norm is a float32 sum in another order than
``adamw.global_norm``'s, the same bits from run to run.  Nothing here
waits for the card.

The library is built by ``kernels/build.py`` at first use and loaded once
per process (:func:`library`), so a step pays one ctypes call a leaf and
pass, and one more for the norm.  Nothing here runs when the module is
imported.
"""

from __future__ import annotations

import ctypes
import os
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..dist.sharding import _api, _is_dtensor
from ..kernels import build

SOURCE = os.path.join(os.path.dirname(__file__), "csrc", "adamw.cu")
BUILD_NAME = "adamw"

#: the dtypes the kernels take, by their code in the C interface
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches of each kernel in this process, counted at each launch: a step
#: over L non-empty leaves launches L of each pass and one norm finish
LAUNCHES = {"adamw_norm": 0, "adamw_norm_finish": 0, "adamw_update": 0}


class Library(NamedTuple):
    """The loaded library and its geometry: elements of a vector unit,
    the bytes their addresses align to, vector units of a norm block."""
    lib: ctypes.CDLL
    vec: int
    align: int
    block_units: int


_lib: Optional[Library] = None


def library() -> Library:
    """The built library with its functions typed, loaded once per
    process."""
    global _lib
    if _lib is None:
        lib, _ = build.load(SOURCE, {}, BUILD_NAME)
        i, ll, f, vp = (ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                        ctypes.c_void_p)
        lib.adamw_norm_leaf.argtypes = [i, vp, ll, ll, ll, vp, vp, i, vp]
        lib.adamw_norm_finish.argtypes = [vp, vp, i, vp, i, vp]
        lib.adamw_update.argtypes = [i, i, i, vp, vp, vp, vp, ll, ll, ll,
                                     vp, vp, vp, vp, f, f, f, f, f, f, i, vp]
        for fn in (lib.adamw_norm_leaf, lib.adamw_norm_finish,
                   lib.adamw_update, lib.adamw_vec, lib.adamw_align):
            fn.restype = i
        lib.adamw_norm_block_units.restype = ll
        lib.adamw_error_string.argtypes = [i]
        lib.adamw_error_string.restype = ctypes.c_char_p
        _lib = Library(lib, lib.adamw_vec(), lib.adamw_align(),
                       lib.adamw_norm_block_units())
    return _lib


def vector_layout(arrays: Sequence[Tuple[int, int]], n: int, vec: int,
                  align: int) -> Tuple[int, int]:
    """(head, nvec) for ``n`` elements of each of ``arrays``, given as
    (address, element bytes): the first ``head`` elements go one at a
    time, the next ``nvec`` units of ``vec`` elements start on
    ``align``-byte boundaries in every array, and the tail after them goes
    one at a time.  (n, 0) where no head below ``vec`` aligns every
    array."""
    for head in range(min(vec, n + 1)):
        if all((address + head * size) % align == 0
               for address, size in arrays):
            return head, (n - head) // vec
    return n, 0


def norm_blocks(n: int, nvec: int, block_units: int) -> int:
    """Blocks (and partial sums) of the norm pass over ``n`` elements with
    ``nvec`` vector units: one for each ``block_units`` units, at least
    one where there is an element."""
    return 0 if n == 0 else max(1, -(-nvec // block_units))


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank; any other tensor itself."""
    return t.to_local() if _is_dtensor(t) else t


def shards(params: Sequence, grads: Sequence, m: Sequence, v: Sequence
           ) -> Tuple[Any, List[Tuple[torch.Tensor, ...]], List[bool]]:
    """(mesh, [(p, g, m, v)], counted): the leaves as plain tensors, and
    whether each counts in this rank's part of the norm.

    Plain leaves: mesh None, each counted.  DTensor leaves, on one mesh:
    their shards, p, m and v laid out alike and never partial, g
    redistributed to their layout where it differs; a leaf counts where
    this rank holds the first copy along every mesh dim it is replicated
    over, so that the counted shards' sums of squares, added over the mesh,
    are the whole tree's."""
    if not params or not len(params) == len(grads) == len(m) == len(v):
        raise ValueError("leaf lists empty or of unequal lengths")
    leaves = list(zip(params, grads, m, v))
    if not _is_dtensor(params[0]):
        if any(_is_dtensor(t) for leaf in leaves for t in leaf):
            raise ValueError("plain and DTensor leaves mixed")
        return None, leaves, [True] * len(leaves)
    _, _, Shard, Partial = _api()
    mesh = params[0].device_mesh
    coordinate = mesh.get_coordinate()
    out, counted = [], []
    for p, g, a, b in leaves:
        if not all(_is_dtensor(t) and t.device_mesh == mesh
                   for t in (p, g, a, b)):
            raise ValueError("leaves on more than one mesh, or DTensor and "
                             "plain leaves mixed")
        places = tuple(p.placements)
        if any(isinstance(x, Partial) for x in places) \
                or tuple(a.placements) != places \
                or tuple(b.placements) != places:
            raise ValueError(f"a parameter laid out {places}, its moments "
                             f"{tuple(a.placements)}, {tuple(b.placements)}")
        if tuple(g.placements) != places:
            g = g.redistribute(mesh, places)
        out.append(tuple(t.to_local() for t in (p, g, a, b)))
        counted.append(all(isinstance(x, Shard) or c == 0
                           for x, c in zip(places, coordinate)))
    return mesh, out, counted


def mesh_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` (this rank's part) summed over every rank of ``mesh``, one
    all-reduce a mesh dim longer than 1; ``x`` itself where ``mesh`` is
    None."""
    if mesh is None:
        return x
    DTensor, Replicate, _, Partial = _api()
    return DTensor.from_local(
        x, mesh, [Partial() if n > 1 else Replicate() for n in mesh.shape],
        run_check=False).full_tensor()


class _Leaf(NamedTuple):
    tensors: Tuple[torch.Tensor, ...]     # p, g, m, v (g contiguous)
    codes: Tuple[int, int, int]           # dtypes of p, g, m
    pointers: Tuple[int, int, int, int]
    n: int
    head: int
    nvec: int
    counted: bool


def _raise(lib: ctypes.CDLL, err: int, what: str) -> None:
    raise RuntimeError(f"AdamW {what} launch failed ({err}: "
                       f"{lib.adamw_error_string(err).decode()})")


class Leaves:
    """A tree's leaves (four lists in the tree's order: parameters,
    gradients, first and second moments) checked once for the passes:
    plain tensors or DTensors (:func:`shards`) on one CUDA device, each
    parameter and gradient float32 or bfloat16 of one shape with its
    moments, the moments of ``moment_dtype``, parameters and moments
    contiguous (a gradient is made so); ``ValueError`` names the first
    thing against it.  Nothing is launched until :meth:`norm` or
    :meth:`update`."""

    def __init__(self, moment_dtype: torch.dtype, params: Sequence,
                 grads: Sequence, m: Sequence, v: Sequence):
        self.mesh, leaves, counted = shards(params, grads, m, v)
        if moment_dtype not in DTYPES:
            raise ValueError(f"moments of {moment_dtype}")
        for p, g, a, b in leaves:
            if p.dtype not in DTYPES or g.dtype not in DTYPES:
                raise ValueError(f"a parameter of {p.dtype} or a gradient "
                                 f"of {g.dtype}")
            if a.dtype != moment_dtype or b.dtype != moment_dtype:
                raise ValueError(f"moments of {a.dtype} and {b.dtype}")
            if not p.shape == g.shape == a.shape == b.shape:
                raise ValueError("a leaf's parameter, gradient and moments "
                                 "differ in shape")
            if not (p.is_contiguous() and a.is_contiguous()
                    and b.is_contiguous()):
                raise ValueError("a parameter or moment is not contiguous")
        self.device = leaves[0][0].device
        if self.device.type != "cuda" or any(
                t.device != self.device for leaf in leaves for t in leaf):
            raise ValueError("leaves not all on one CUDA device")
        geo = library()
        self.leaves: List[_Leaf] = []
        for (p, g, a, b), c in zip(leaves, counted):
            if p.numel() == 0:
                continue
            tensors = (p, g.contiguous(), a, b)
            pointers = tuple(t.data_ptr() for t in tensors)
            head, nvec = vector_layout(
                [(ptr, t.element_size()) for ptr, t in zip(pointers,
                                                           tensors)],
                p.numel(), geo.vec, geo.align)
            self.leaves.append(_Leaf(
                tensors, (DTYPES[p.dtype], DTYPES[g.dtype],
                          DTYPES[moment_dtype]),
                pointers, p.numel(), head, nvec, c))

    def norm(self) -> torch.Tensor:
        """sqrt of the sum of squares of every gradient, a float32 0-dim
        tensor on the leaves' device: each leaf's sum in float32 in an
        order fixed by its size and address alone, the leaves added in
        their order, then (on a mesh) the ranks' sums.  Launches one
        kernel a counted leaf and one more; does not synchronise."""
        geo = library()
        stream = torch.cuda.current_stream(self.device).cuda_stream
        leaves = [leaf for leaf in self.leaves if leaf.counted]
        blocks = sum(norm_blocks(leaf.n, leaf.nvec, geo.block_units)
                     for leaf in leaves)
        # the partials, then one int a leaf: its block count
        work = torch.empty(blocks + len(leaves), dtype=torch.float32,
                           device=self.device)
        total = torch.empty((), dtype=torch.float32, device=self.device)
        at, counts = work.data_ptr(), work.data_ptr() + 4 * blocks
        for i, leaf in enumerate(leaves):
            err = geo.lib.adamw_norm_leaf(
                leaf.codes[1], leaf.pointers[1], leaf.n, leaf.head,
                leaf.nvec, at, counts + 4 * i, self.device.index, stream)
            if err:
                _raise(geo.lib, err, "norm")
            LAUNCHES["adamw_norm"] += 1
            at += 4 * norm_blocks(leaf.n, leaf.nvec, geo.block_units)
        err = geo.lib.adamw_norm_finish(work.data_ptr(), counts, len(leaves),
                                        total.data_ptr(), self.device.index,
                                        stream)
        if err:
            _raise(geo.lib, err, "norm")
        LAUNCHES["adamw_norm_finish"] += 1
        return torch.sqrt(mesh_sum(total, self.mesh))

    def update(self, cfg, scale: torch.Tensor, lr: torch.Tensor,
               c1: torch.Tensor, c2: torch.Tensor) -> None:
        """``adamw._leaf``'s step written into every parameter and moment
        in place, with the clip scale, learning rate and bias corrections
        float32 0-dim tensors on the leaves' device (as ``adamw._scalars``
        makes them).  Launches one kernel a leaf; does not
        synchronise."""
        geo = library()
        stream = torch.cuda.current_stream(self.device).cuda_stream
        b1, b2 = cfg.betas
        # Python doubles, rounded to float by ctypes as PyTorch rounds a
        # scalar operand; 1 - b is taken in double first, as _leaf's
        # expression does
        consts = (b1, 1 - b1, b2, 1 - b2, cfg.eps, cfg.weight_decay)
        scalars = (scale.data_ptr(), lr.data_ptr(), c1.data_ptr(),
                   c2.data_ptr())
        for leaf in self.leaves:
            err = geo.lib.adamw_update(*leaf.codes, *leaf.pointers, leaf.n,
                                       leaf.head, leaf.nvec, *scalars,
                                       *consts, self.device.index, stream)
            if err:
                _raise(geo.lib, err, "update")
            LAUNCHES["adamw_update"] += 1
