"""Tunable 2D convolution for the H100 — the paper's case study 1 (section V).

The CUDA kernel ``csrc/conv2d.cu`` replaces the JAX package's Pallas TPU
kernel body ``repro/kernels/conv2d/conv2d.py::_conv_kernel``.  It loads
its own halo tile into shared memory (the paper's explicit local-memory
caching, L$); there is no staging of overlapping tiles through device
memory as the TPU path needs (``_materialise_tiles``).  The source's head
note says what bounds it and what the design does about that.

Parameter vocabulary (paper Table II, the JAX package's names and values):

  BLOCK_H / BLOCK_W   output tile of one thread block (paper: X_wg/Y_wg)
  SUB_H  1|2|4|8      output rows each thread sums at a time (paper: the
                      work per thread, X_wpt/Y_wpt)
  UNROLL True|False   True: every loop over the taps unrolled at compile
                      time; False: the loop over filter rows rolled, the
                      taps of one row and the register window unrolled (a
                      window held in registers cannot be indexed at run
                      time) (paper: UNR)
  HALO_MODE           'materialize' = the CUDA kernel, which stages its halo
                      in shared memory (paper L$=1/2); 'xla' = the library
                      convolution, ``F.conv2d`` with explicit padding and
                      TF32 off (paper L$=0; the JAX package's
                      ``lax.conv_general_dilated`` outside any Pallas
                      kernel).  'xla' is not a port of the TPU kernel: it
                      builds nothing and counts no launch.
  PAD_W  0|1          (extended space) 16-byte quads of padding at the end
                      of each shared-memory row, the paper's PAD (a quad,
                      not a float, so rows stay aligned for the kernel's
                      16-byte loads); a real build parameter
  PIPELINE_DEPTH      (extended space) analytical-model only: every value
                      builds the same kernel

Thread geometry: TY = BLOCK_H / SUB_H row groups and TX = min(BLOCK_W,
max(32, 256 / TY)) threads along a row, TX * TY threads a block
(:func:`block_threads`).  Thread (tx, ty) owns rows ty*SUB_H ..
ty*SUB_H + SUB_H - 1 and ceil(BLOCK_W / TX) columns, summed as a register
tile of SUB_H rows x CG adjacent columns, one column group at a time:
group g covers tile columns g*CG*TX + tx*CG .. + CG - 1
(:func:`micro_tile`).  For each filter row the thread loads the row's
weights and, for each of its rows, a sliding window of CG + Fw - 1 image
values into registers, then does Fw * CG FMAs from them.  A block may
have 1024 threads, so BLOCK_H / SUB_H <= 32 on the card; the space says
so as a constraint, with the shared-memory footprint
(:func:`smem_footprint`), so an infeasible config is pruned and never a
failed launch.

Operands are float32, or both bfloat16 as in the JAX package (whose kernel
writes the image's dtype).  The build for bfloat16 (``IN_BF16``) runs on
the tensor cores: for each filter row, 16 output columns of 8 output rows
are one ``mma.sync`` product of a band of the filter row (16 x 16*KS) and
the staged bfloat16 image (:func:`band_offset`, :func:`k_steps`,
:func:`staging_origin`, :func:`warp_tile`; :func:`conv2d_banded` is that
schedule in PyTorch).  A block sums :func:`column_blocks` of 16 columns,
so a BLOCK_W that is no multiple of 16 builds too: its last columns are
summed and not stored.  Every product is exact in float32 and summed in
float32, and each output is rounded once to bfloat16, as in
:func:`conv2d_plain`; only the order of the float32 sum differs.  Its
threads, shared bytes and registers are its own (``elt_bytes=2`` in the
models).  A :class:`Conv2d` is made for one input type and builds that
type's library.

Which implementation runs follows the tensors' device alone: tensors on
the CPU take the plain PyTorch version (:func:`conv2d_plain`, the kernel's
sums in the kernel's order, the counterpart of Pallas interpret mode);
CUDA tensors take the kernel, or the call raises.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ...core import trace
from ...core.cost import KernelCost
from ...core.profiles import DeviceProfile
from .. import build
from .ref import conv2d_reference, conv_bytes, conv_flops

Config = Dict[str, Any]

SOURCE = os.path.join(os.path.dirname(__file__), "csrc", "conv2d.cu")
BUILD_NAME = "conv2d"

DEFAULT_CONFIG: Config = {
    "BLOCK_H": 16, "BLOCK_W": 256, "SUB_H": 1, "UNROLL": True,
    "HALO_MODE": "materialize",
}

#: input types the kernel takes (the shape's ``dtype`` names one)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: launches of the CUDA kernel; comparisons and timing runs count too, so a
#: caller that wants one path's count resets it first
LAUNCHES: Dict[str, int] = {"conv2d": 0}


def _merged(config: Optional[Config]) -> Config:
    cfg = dict(DEFAULT_CONFIG)
    cfg.update(config or {})
    return cfg


def row_geometry(config: Config) -> Tuple[int, int, int]:
    """(TY, TX, columns a thread owns) of a 'materialize' config."""
    ty = config["BLOCK_H"] // config["SUB_H"]
    tx = min(config["BLOCK_W"], max(32, 256 // ty))
    return ty, tx, -(-config["BLOCK_W"] // tx)


def block_threads(config: Config, elt_bytes: int = 4) -> int:
    """Threads of one block the build for ``elt_bytes``-wide inputs derives
    from the tile (0 for 'xla', which launches no kernel of ours): float32
    TX * TY, bfloat16 a warp per :func:`warp_tile`."""
    if config.get("HALO_MODE", "materialize") == "xla":
        return 0
    if elt_bytes == 2:
        return 32 * _warps(config)
    ty, tx, _ = row_geometry(config)
    return tx * ty


# ---------------------------------------------------------------------------
# the bfloat16 build's geometry (csrc/conv2d.cu, IN_BF16): a banded product
# on mma.sync m16n8k16
# ---------------------------------------------------------------------------

#: m16n8 tiles (32 float32 sums a lane) a warp of the bfloat16 build holds
MAX_WARP_TILES = 8
#: row groups of 8 a warp of the bfloat16 build sums at most (eight of one
#: column block spilled: ptxas kept every group's next image fragments)
MAX_ROW_GROUPS = 4
#: registers a lane of the bfloat16 build keeps besides its sums and its
#: band fragments (image fragments, addresses, loop state)
REG_OVERHEAD_BF16 = 32


def band_offset(Fw: int) -> int:
    """Columns from the staging origin to a column block's first tap,
    (-(Fw // 2)) mod 8: the origin is the column at or below c0 - Fw // 2
    that lies as c0 does against 8 columns, 16-byte-aligned when c0 is a
    multiple of 8 (``OFF``)."""
    return -(Fw // 2) % 8


def k_steps(Fw: int) -> int:
    """k-steps of 16 one column block's band spans: its 16 columns' taps
    reach band_offset + Fw + 15 input columns (``KS``)."""
    return -(-(band_offset(Fw) + Fw + 15) // 16)


def staging_origin(c0: int, Fw: int) -> int:
    """The first image column a block at output column ``c0`` stages."""
    return c0 - Fw // 2 - band_offset(Fw)


def column_blocks(config: Config) -> int:
    """Column blocks of 16 a bfloat16 block sums: ceil(BLOCK_W / 16) (the
    columns past BLOCK_W are summed and not stored)."""
    return -(-config["BLOCK_W"] // 16)


def warp_tile(config: Config, Fh: int, Fw: int) -> Tuple[int, int, int]:
    """(row groups of 8, column blocks of 16, k-steps) of one warp's tile
    in the bfloat16 build: RG = min(SUB_H, :data:`MAX_ROW_GROUPS`,
    ceil(BLOCK_H / 8)), NB the widest divisor of :func:`column_blocks`
    with RG * NB <= :data:`MAX_WARP_TILES`, and :func:`k_steps`.  The
    filter height does not enter."""
    cfg = _merged(config)
    rg = min(cfg["SUB_H"], MAX_ROW_GROUPS, -(-cfg["BLOCK_H"] // 8))
    cb = column_blocks(cfg)
    nb = next(n for n in range(MAX_WARP_TILES // rg, 0, -1) if cb % n == 0)
    return rg, nb, k_steps(Fw)


def _warps_y(config: Config) -> int:
    """Warps down a bfloat16 block: its row groups of 8 over RG."""
    row_groups = -(-config["BLOCK_H"] // 8)
    return -(-row_groups // warp_tile(config, 1, 1)[0])


def _warps(config: Config) -> int:
    """Warps of a bfloat16 block: down the rows times across the column
    blocks (BLOCK_W / 16 over NB)."""
    nb = warp_tile(config, 1, 1)[1]
    return _warps_y(config) * (column_blocks(config) // nb)


def summed_rows(config: Config) -> int:
    """Rows a bfloat16 block sums: BLOCK_H rounded up to its warps' row
    groups (the rest are summed from staged rows and not stored)."""
    return 8 * warp_tile(config, 1, 1)[0] * _warps_y(config)


def warp_registers(config: Config, Fh: int, Fw: int) -> int:
    """Registers a lane of the bfloat16 build needs: 4 sums a tile, a
    filter row's KS band fragments (4 each) and
    :data:`REG_OVERHEAD_BF16`."""
    rg, nb, ks = warp_tile(config, Fh, Fw)
    return 4 * rg * nb + 4 * ks + REG_OVERHEAD_BF16


#: registers a thread may use at 1024 resident threads an SM (65536 over
#: 1024), and at 1536 (rounded down to 8); the build asks for 1536
#: (``__launch_bounds__``) for single-row threads whose register estimate
#: fits the smaller
REGISTERS, REGISTERS_SMALL = 64, 40
#: registers a thread keeps besides its sums and its rows' windows
#: (addresses, weights in flight, loop state); calibrated on ptxas's counts
#: and shared with the build
REG_OVERHEAD = 8
#: widest column group of the register tile
MAX_GROUP_COLS = 8


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _vec(cols: int) -> int:
    """Floats one window load moves: 16-, 8- or 4-byte loads."""
    return 4 if cols % 4 == 0 else 2 if cols % 2 == 0 else 1


def _window(cols: int, Fw: int) -> int:
    """Floats of one window: cols + Fw - 1, rounded up to whole loads."""
    return _round_up(cols + Fw - 1, _vec(cols))


def register_estimate(config: Config, Fw: int, cols: int) -> int:
    """Registers a thread needs with ``cols`` columns a group: its SUB_H x
    cols sums, the windows of its SUB_H rows for one filter row (ptxas
    issues those loads together) and :data:`REG_OVERHEAD` (``regs_of`` in
    the build)."""
    return config["SUB_H"] * (cols + _window(cols, Fw)) + REG_OVERHEAD


def micro_tile(config: Config, Fh: int, Fw: int,
               elt_bytes: int = 4) -> Tuple[int, int, int]:
    """(rows, columns, column groups) of one thread's register tile, as the
    float32 build derives them (``csrc/conv2d.cu``, ``pick_cg``); for
    bfloat16 (``elt_bytes=2``) the warp's tile, :func:`warp_tile`.

    The columns are the widest divisor of the thread's ceil(BLOCK_W / TX)
    columns, at most :data:`MAX_GROUP_COLS`, whose
    :func:`register_estimate` fits :data:`REGISTERS` (one column when none
    does); the groups take the rest, one after the other.  The filter
    height does not enter: one filter row is live at a time.
    """
    if elt_bytes == 2:
        return warp_tile(config, Fh, Fw)
    cfg = _merged(config)
    per_thread = row_geometry(cfg)[2]
    for cols in range(min(per_thread, MAX_GROUP_COLS), 1, -1):
        if (per_thread % cols == 0
                and register_estimate(cfg, Fw, cols) <= REGISTERS):
            return cfg["SUB_H"], cols, per_thread // cols
    return cfg["SUB_H"], 1, per_thread


def resident_threads(config: Config, Fh: int, Fw: int) -> int:
    """Threads an SM the build asks to hold (``RESIDENT``): 1536 for
    single-row threads whose register estimate fits
    :data:`REGISTERS_SMALL`, else 1024."""
    cfg = _merged(config)
    cols = micro_tile(cfg, Fh, Fw)[1]
    return (1536 if cfg["SUB_H"] == 1 and register_estimate(cfg, Fw, cols)
            <= REGISTERS_SMALL else 1024)


def smem_footprint(config: Config, Fh: int, Fw: int,
                   elt_bytes: int = 4) -> int:
    """Bytes of shared memory one block of the build for ``elt_bytes``-wide
    inputs claims (0 for 'xla').

    float32: the halo tile and the filter.  A tile row holds the columns
    the windows read, TX * ceil(BLOCK_W / TX) + Fw - 1, rounded up to a
    multiple of 8 (the kernel swizzles quads within pairs), plus PAD_W
    quads; a filter row is rounded up to a quad.

    bfloat16: the halo tile of :func:`summed_rows` + Fh - 1 rows, each of
    16 * (:func:`column_blocks` + KS - 1) columns in 16-byte chunks plus
    one chunk and 2 * PAD_W more (an odd count); the band, Fh x 16 rows of
    16 * KS + 8 columns; the zero-padded filter rows, Fh x (16 * KS + 16).
    The output is staged in the tile's place.
    """
    cfg = _merged(config)
    if cfg["HALO_MODE"] == "xla":
        return 0
    if elt_bytes == 2:
        ks = k_steps(Fw)
        chunks = 2 * (column_blocks(cfg) + ks - 1)
        stride = 8 * (chunks + 1 + 2 * int(cfg.get("PAD_W", 0)))
        tile = (summed_rows(cfg) + Fh - 1) * stride
        return 2 * (tile + Fh * 16 * (16 * ks + 8) + Fh * (16 * ks + 16))
    _, tx, per_thread = row_geometry(cfg)
    row = (_round_up(tx * per_thread + Fw - 1, 8)
           + 4 * int(cfg.get("PAD_W", 0)))
    return 4 * ((cfg["BLOCK_H"] + Fh - 1) * row + Fh * _round_up(Fw, 4))


def validate_config(config: Config, H: int, W: int, Fh: int, Fw: int,
                    elt_bytes: int = 4) -> None:
    bh, bw = config["BLOCK_H"], config["BLOCK_W"]
    if config["BLOCK_H"] % config["SUB_H"]:
        raise ValueError("BLOCK_H must divide by SUB_H")
    if bh <= 0 or bw <= 0:
        raise ValueError("blocks must be positive")
    if config["HALO_MODE"] not in ("materialize", "xla"):
        raise ValueError(f"bad HALO_MODE {config['HALO_MODE']!r}")
    if config["HALO_MODE"] == "xla":
        return
    threads = block_threads(config, elt_bytes)
    if threads > 1024:
        raise ValueError(f"({bh},{bw}) blocks with SUB_H={config['SUB_H']} "
                         f"need {threads} threads; a block has at most 1024")


def _defines(cfg: Config, Fh: int, Fw: int,
             dtype: torch.dtype = torch.float32) -> Dict[str, int]:
    return {"BLOCK_H": cfg["BLOCK_H"], "BLOCK_W": cfg["BLOCK_W"],
            "SUB_H": cfg["SUB_H"], "UNROLL": int(bool(cfg["UNROLL"])),
            "PAD_W": int(cfg.get("PAD_W", 0)), "FH": Fh, "FW": Fw,
            "IN_BF16": int(dtype == torch.bfloat16)}


def conv2d_plain(image: torch.Tensor, filt: torch.Tensor,
                 config: Optional[Config] = None,
                 weight: float = 1.0) -> torch.Tensor:
    """The plain PyTorch version, on any device.

    'materialize': the image padded by Fh//2 rows above and (Fh-1)//2 below
    (Fw//2 / (Fw-1)//2 columns), the taps added into one float32 sum in
    (i, j) order, then multiplied by ``weight``: the kernel's arithmetic,
    whatever the tiling (every output is computed alone).  'xla': the
    library convolution, as on the card.
    """
    cfg = _merged(config)
    if cfg["HALO_MODE"] == "xla":
        return conv2d_reference(image, filt, weight=weight)
    H, W = image.shape
    Fh, Fw = filt.shape
    img = F.pad(image.to(torch.float32),
                (Fw // 2, (Fw - 1) // 2, Fh // 2, (Fh - 1) // 2))
    f = filt.to(torch.float32)
    acc = torch.zeros((H, W), dtype=torch.float32, device=image.device)
    for i in range(Fh):
        for j in range(Fw):
            acc += f[i, j] * img[i:i + H, j:j + W]
    return (weight * acc).to(image.dtype)


def band(filt: torch.Tensor) -> torch.Tensor:
    """The bfloat16 build's band of each filter row, (Fh, 16, 16 * KS)
    float32: band[i, m, k] = filt[i, k - m - OFF] inside the filter, 0
    elsewhere (OFF = :func:`band_offset`, KS = :func:`k_steps`)."""
    Fh, Fw = filt.shape
    off, kw = band_offset(Fw), 16 * k_steps(Fw)
    j = (torch.arange(kw, device=filt.device)[None, :]
         - torch.arange(16, device=filt.device)[:, None] - off)
    inside = (j >= 0) & (j < Fw)
    taps = filt.to(torch.float32)[:, j.clamp(0, Fw - 1)]
    return torch.where(inside, taps, torch.zeros((), device=filt.device))


def conv2d_banded(image: torch.Tensor, filt: torch.Tensor,
                  config: Optional[Config] = None,
                  weight: float = 1.0) -> torch.Tensor:
    """The bfloat16 build's schedule in PyTorch, block by block: stage the
    halo tile from :func:`staging_origin` (zeros outside the image, every
    column the products read), then for each filter row and each column
    block of 16 the product of :func:`band` with the K staged columns
    from 16 * t, summed in float32 in filter-row order; times ``weight``,
    rounded once to the image's dtype.  It equals :func:`conv2d_plain` up
    to the order of the float32 sum (its tests hold it there) and so
    describes what the build computes; it is no fallback of the wrapper.
    """
    cfg = _merged(config)
    H, W = image.shape
    Fh, Fw = filt.shape
    bh, bw = cfg["BLOCK_H"], cfg["BLOCK_W"]
    rows, cb, kw = summed_rows(cfg), column_blocks(cfg), 16 * k_steps(Fw)
    span = 16 * (cb + k_steps(Fw) - 1)
    img = image.to(torch.float32)
    bands = band(filt)
    out = torch.empty((H, W), dtype=torch.float32, device=image.device)
    for r0 in range(0, H, bh):
        for c0 in range(0, W, bw):
            gr, gc = r0 - Fh // 2, staging_origin(c0, Fw)
            tile = torch.zeros((rows + Fh - 1, span), dtype=torch.float32,
                               device=image.device)
            r_lo, r_hi = max(gr, 0), min(gr + rows + Fh - 1, H)
            c_lo, c_hi = max(gc, 0), min(gc + span, W)
            if r_lo < r_hi and c_lo < c_hi:
                tile[r_lo - gr:r_hi - gr, c_lo - gc:c_hi - gc] = \
                    img[r_lo:r_hi, c_lo:c_hi]
            x = tile.unfold(1, kw, 16)           # (rows, cb, K): block t
            acc = torch.zeros((rows, cb, 16), dtype=torch.float32,
                              device=image.device)
            for i in range(Fh):
                acc += torch.einsum("rtk,mk->rtm", x[i:i + rows], bands[i])
            blk = (weight * acc).reshape(rows, cb * 16)
            out[r0:r0 + bh, c0:c0 + bw] = blk[:min(bh, H - r0),
                                              :min(bw, W - c0)]
    return out.to(image.dtype)


class Conv2d:
    """``fn(image, filt) -> (H, W)`` for one shape, configuration and input
    type.

    What :func:`make_conv2d` returns.  :meth:`compile` does the host-side
    build of the CUDA library for ``dtype`` (``nvcc`` and loading it) and
    returns its content address (None for 'xla', which builds nothing); the
    first call on CUDA tensors builds it if that has not happened yet.  A
    call on CPU tensors runs :func:`conv2d_plain`.  Operands of another
    type are refused.
    """

    build_name = BUILD_NAME
    source = SOURCE

    def __init__(self, H: int, W: int, Fh: int, Fw: int,
                 config: Optional[Config], weight: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        cfg = _merged(config)
        if dtype not in DTYPES.values():
            raise ValueError(f"conv2d takes float32 or bfloat16, not {dtype}")
        validate_config(cfg, H, W, Fh, Fw, dtype.itemsize)
        self.H, self.W, self.Fh, self.Fw = H, W, Fh, Fw
        self.config = cfg
        self.weight = float(weight)
        self.dtype = dtype
        self.route = "cuda" if cfg["HALO_MODE"] == "materialize" else "library"
        self._lib: Optional[ctypes.CDLL] = None
        self.address: Optional[str] = None

    def defines(self) -> Tuple[Tuple[str, int], ...]:
        """The build's -D defines: one library per distinct value."""
        return tuple(sorted(_defines(self.config, self.Fh, self.Fw,
                                     self.dtype).items()))

    def compile(self) -> Optional[str]:
        if self.route == "library":
            return None
        if self._lib is None:
            lib, address = build.load(SOURCE, dict(self.defines()),
                                      BUILD_NAME)
            lib.conv2d_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_int, ctypes.c_void_p]
            lib.conv2d_launch.restype = ctypes.c_int
            lib.conv2d_error_string.argtypes = [ctypes.c_int]
            lib.conv2d_error_string.restype = ctypes.c_char_p
            lib.conv2d_smem_bytes.restype = ctypes.c_int
            lib.conv2d_threads.restype = ctypes.c_int
            lib.conv2d_micro_tile.argtypes = [ctypes.POINTER(ctypes.c_int)]
            lib.conv2d_micro_tile.restype = None
            self._lib, self.address = lib, address
        return self.address

    def geometry(self) -> Tuple[int, int, Tuple[int, int, int]]:
        """(threads, shared-memory bytes, (rows, columns, column groups))
        of one block and thread, as the build reports them; builds the
        library if that has not happened yet."""
        if self.compile() is None:
            return 0, 0, (0, 0, 0)
        tile = (ctypes.c_int * 3)()
        self._lib.conv2d_micro_tile(tile)
        return (self._lib.conv2d_threads(), self._lib.conv2d_smem_bytes(),
                tuple(tile))

    def _check(self, image: torch.Tensor, filt: torch.Tensor) -> None:
        if (tuple(image.shape) != (self.H, self.W)
                or tuple(filt.shape) != (self.Fh, self.Fw)):
            raise ValueError(
                f"conv2d built for image {(self.H, self.W)} and filter "
                f"{(self.Fh, self.Fw)}, given {tuple(image.shape)} and "
                f"{tuple(filt.shape)}")
        if image.dtype != self.dtype or filt.dtype != self.dtype:
            raise ValueError(f"conv2d built for {self.dtype}, given "
                             f"{image.dtype} and {filt.dtype}")
        if image.device != filt.device:
            raise ValueError(f"operands on {image.device} and {filt.device}")

    def __call__(self, image: torch.Tensor, filt: torch.Tensor
                 ) -> torch.Tensor:
        self._check(image, filt)
        if image.device.type == "cpu":
            return conv2d_plain(image, filt, self.config, self.weight)
        if image.device.type != "cuda":
            raise ValueError(f"no conv2d for device {image.device}")
        if not torch.cuda.is_available():
            raise RuntimeError("conv2d: CUDA tensors given, but no CUDA "
                               "device is available")
        if self.route == "library":
            return conv2d_reference(image, filt, weight=self.weight)
        return self._launch(image, filt)

    def _launch(self, image: torch.Tensor, filt: torch.Tensor
                ) -> torch.Tensor:
        if not (image.is_contiguous() and filt.is_contiguous()):
            raise ValueError("the conv2d kernel takes contiguous operands")
        self.compile()
        lib = self._lib
        with trace.span("kernel.launch"):
            out = torch.empty((self.H, self.W), dtype=self.dtype,
                              device=image.device)
            stream = torch.cuda.current_stream(image.device).cuda_stream
            err = lib.conv2d_launch(image.data_ptr(), filt.data_ptr(),
                                    out.data_ptr(), self.H, self.W,
                                    self.weight, image.device.index, stream)
        if err:
            raise RuntimeError(
                f"conv2d launch failed ({err}: "
                f"{lib.conv2d_error_string(err).decode()}) for {self.config}")
        LAUNCHES["conv2d"] += 1
        return out


def make_conv2d(H: int, W: int, Fh: int, Fw: int,
                config: Optional[Config] = None,
                weight: float = 1.0,
                dtype: torch.dtype = torch.float32) -> Conv2d:
    """Return fn(image, filt) -> (H, W) convolved output; ``image``,
    ``filt`` and the result have ``dtype`` (float32 or bfloat16)."""
    return Conv2d(H, W, Fh, Fw, config, weight, dtype)


# ---------------------------------------------------------------------------
# structural cost model (feeds AnalyticalEvaluator and auto-constraints)
# ---------------------------------------------------------------------------

#: fixed cost of one wave of blocks over the SMs, seconds (a model constant)
WAVE_OVERHEAD_S = 1.0e-6


def analytical_time(config: Config, profile: DeviceProfile,
                    H: int, W: int, Fh: int, Fw: int,
                    elt_bytes: int = 4) -> float:
    """max(FMA time, byte time) + per-wave overhead, for searches without
    a card; it makes no claim about the kernel's time.

    'xla' is the library convolution, priced at half the float32 FMA rate
    and the footnote-2 bytes.  The bfloat16 build is priced by
    :func:`_bf16_time`.  'materialize' pays for the halo overlap in
    bytes and is infeasible past the shared-memory or thread limits
    (``math.inf``).  Its FMA efficiency follows the register tile
    (:func:`micro_tile`): per filter row and column group a warp issues
    Fw * cols * rows FMAs (an SM retires four such warp instructions a
    clock), rows windows of shared-memory loads (one clock per 32 words)
    and the weights' broadcast quad loads (one clock each); the FMAs' share
    of the slower of the shared-memory clocks and the issue slots is the
    efficiency, times 0.72 for rolled filter rows.  PIPELINE_DEPTH only
    scales how well bytes overlap the FMAs.
    """
    cfg = _merged(config)
    bh, bw = cfg["BLOCK_H"], cfg["BLOCK_W"]
    if bh % cfg["SUB_H"]:
        return math.inf
    flops = conv_flops(H, W, Fh, Fw)
    if cfg["HALO_MODE"] == "xla":
        compute_t = flops / (0.5 * profile.peak_f32_flops)
        memory_t = conv_bytes(H, W, elt_bytes) / profile.hbm_bw
        return max(compute_t, memory_t) + profile.launch_overhead
    if elt_bytes == 2:
        return _bf16_time(cfg, profile, H, W, Fh, Fw)
    threads = block_threads(cfg)
    smem = smem_footprint(cfg, Fh, Fw)
    if threads > 1024 or not profile.fits_smem(smem):
        return math.inf
    rows, cols, _ = micro_tile(cfg, Fh, Fw)
    fmas = Fw * cols * rows
    window = _window(cols, Fw)
    weight_loads = _round_up(Fw, 4) // 4
    smem_clocks = rows * window + weight_loads
    issued = fmas + rows * window // _vec(cols) + weight_loads
    eff = (min(1.0, fmas / 4 / smem_clocks, fmas / issued)
           * (1.0 if cfg["UNROLL"] else 0.72))
    compute_t = flops / (profile.peak_f32_flops * eff)
    dup = (1.0 + (Fh - 1) / bh) * (1.0 + (Fw - 1) / bw)
    memory_t = H * W * elt_bytes * (dup + 1.0) / profile.hbm_bw
    overlap = {2: 1.0, 3: 0.97, 4: 0.96}.get(
        int(cfg.get("PIPELINE_DEPTH", 2)), 1.0)
    per_sm = max(1, min(resident_threads(cfg, Fh, Fw) // threads,
                        profile.smem_per_block_optin // max(smem, 1)))
    blocks = -(-H // bh) * -(-W // bw)
    waves = math.ceil(blocks / (profile.sm_count * per_sm))
    return (max(compute_t, memory_t * overlap) + waves * WAVE_OVERHEAD_S
            + profile.launch_overhead)


#: share of the bfloat16 tensor-core peak mma.sync reaches when it is fed
#: (a model constant)
MMA_SYNC_SHARE = 0.6


def _bf16_time(cfg: Config, profile: DeviceProfile, H: int, W: int,
               Fh: int, Fw: int) -> float:
    """The bfloat16 build: infeasible past the thread or shared-memory
    limits; its operations at the tensor-core rate times the band's useful
    share, Fw / (16 * KS) (times BLOCK_H over the rows summed), and times
    :data:`MMA_SYNC_SHARE`; or its halo bytes at 2 bytes; the larger, plus
    per-wave overhead.  A warp's shared-memory wavefronts a product
    (KS band fragments of 4 for RG * NB * KS products, NB + KS - 1 image
    fragments of 2 a row group for NB * KS) slow the products where they
    exceed one a product."""
    threads = block_threads(cfg, 2)
    smem = smem_footprint(cfg, Fh, Fw, 2)
    if threads > 1024 or not profile.fits_smem(smem):
        return math.inf
    rg, nb, ks = warp_tile(cfg, Fh, Fw)
    bh, bw = cfg["BLOCK_H"], cfg["BLOCK_W"]
    useful = Fw / (16 * ks) * bh / summed_rows(cfg)
    mmas = rg * nb * ks
    waves_a_mma = (4 * ks + 2 * rg * (nb + ks - 1)) / mmas
    eff = (MMA_SYNC_SHARE * useful / max(1.0, waves_a_mma)
           * (1.0 if cfg["UNROLL"] else 0.9))
    compute_t = conv_flops(H, W, Fh, Fw) / (profile.peak_bf16_tensor_flops
                                            * eff)
    dup = (1.0 + (Fh - 1) / bh) * (1.0 + (Fw - 1) / bw)
    memory_t = H * W * 2 * (dup + 1.0) / profile.hbm_bw
    per_sm = max(1, min(2048 // threads,
                        profile.smem_per_block_optin // max(smem, 1)))
    blocks = -(-H // bh) * -(-W // bw)
    waves = math.ceil(blocks / (profile.sm_count * per_sm))
    return (max(compute_t, memory_t) + waves * WAVE_OVERHEAD_S
            + profile.launch_overhead)


def _halo_extent(n: int, block: int, before: int, after: int) -> int:
    """Image rows (or columns) all blocks along one axis read: each block
    of ``block`` reads ``before`` more ahead and ``after`` more behind,
    clipped to the image (the kernel zero-fills outside it, reading
    nothing)."""
    return sum(min(n, b + block + after) - max(0, b - before)
               for b in range(0, n, block))


def traffic(config: Config, H: int, W: int, Fh: int, Fw: int,
            elt_bytes: int = 4) -> KernelCost:
    """The declared cost of one call (:mod:`repro_torch.core.cost`).

    FLOPs are the paper's footnote 2, (1 + 2*Fh*Fw)*H*W.  Bytes follow the
    block geometry: 'materialize' reads each block's halo tile once
    (BLOCK_H + Fh - 1 rows of BLOCK_W + Fw - 1 columns, clipped to the
    image) and the filter once a block, and writes the output once.
    'xla' pads the image into a new tensor and convolves that: the image
    read and the padded copy written, then the copy and the filter read
    and the output written.  A configuration the kernel cannot build
    raises ``ValueError``.
    """
    cfg = _merged(config)
    validate_config(cfg, H, W, Fh, Fw)
    flops = conv_flops(H, W, Fh, Fw)
    taps = Fh * Fw
    if cfg["HALO_MODE"] == "xla":
        padded = (H + Fh - 1) * (W + Fw - 1)
        nbytes = elt_bytes * (2 * H * W + 2 * padded + taps)
        return KernelCost(flops=flops, bytes=nbytes)
    bh, bw = cfg["BLOCK_H"], cfg["BLOCK_W"]
    halo = (_halo_extent(H, bh, Fh // 2, (Fh - 1) // 2)
            * _halo_extent(W, bw, Fw // 2, (Fw - 1) // 2))
    blocks = -(-H // bh) * -(-W // bw)
    nbytes = elt_bytes * (halo + blocks * taps + H * W)
    return KernelCost(flops=flops, bytes=nbytes)
