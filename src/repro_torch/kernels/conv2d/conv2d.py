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


def block_threads(config: Config) -> int:
    """Threads of one block the build derives from the tile (0 for 'xla',
    which launches no kernel of ours)."""
    if config.get("HALO_MODE", "materialize") == "xla":
        return 0
    ty, tx, _ = row_geometry(config)
    return tx * ty


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


def micro_tile(config: Config, Fh: int, Fw: int) -> Tuple[int, int, int]:
    """(rows, columns, column groups) of one thread's register tile, as the
    build derives them (``csrc/conv2d.cu``, ``pick_cg``).

    The columns are the widest divisor of the thread's ceil(BLOCK_W / TX)
    columns, at most :data:`MAX_GROUP_COLS`, whose
    :func:`register_estimate` fits :data:`REGISTERS` (one column when none
    does); the groups take the rest, one after the other.  The filter
    height does not enter: one filter row is live at a time.
    """
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


def smem_footprint(config: Config, Fh: int, Fw: int) -> int:
    """Bytes of shared memory one block claims (0 for 'xla'): the halo
    tile and the filter.  A tile row holds the columns the windows read,
    TX * ceil(BLOCK_W / TX) + Fw - 1, rounded up to a multiple of 8 (the
    kernel swizzles quads within pairs), plus PAD_W quads; a filter row is
    rounded up to a quad."""
    cfg = _merged(config)
    if cfg["HALO_MODE"] == "xla":
        return 0
    _, tx, per_thread = row_geometry(cfg)
    row = (_round_up(tx * per_thread + Fw - 1, 8)
           + 4 * int(cfg.get("PAD_W", 0)))
    return 4 * ((cfg["BLOCK_H"] + Fh - 1) * row + Fh * _round_up(Fw, 4))


def validate_config(config: Config, H: int, W: int, Fh: int, Fw: int) -> None:
    bh, bw = config["BLOCK_H"], config["BLOCK_W"]
    if config["BLOCK_H"] % config["SUB_H"]:
        raise ValueError("BLOCK_H must divide by SUB_H")
    if bh <= 0 or bw <= 0:
        raise ValueError("blocks must be positive")
    if config["HALO_MODE"] not in ("materialize", "xla"):
        raise ValueError(f"bad HALO_MODE {config['HALO_MODE']!r}")
    if block_threads(config) > 1024:
        raise ValueError(f"({bh},{bw}) blocks with SUB_H={config['SUB_H']} "
                         f"need {block_threads(config)} threads; a block has "
                         "at most 1024")


def _defines(cfg: Config, Fh: int, Fw: int) -> Dict[str, int]:
    return {"BLOCK_H": cfg["BLOCK_H"], "BLOCK_W": cfg["BLOCK_W"],
            "SUB_H": cfg["SUB_H"], "UNROLL": int(bool(cfg["UNROLL"])),
            "PAD_W": int(cfg.get("PAD_W", 0)), "FH": Fh, "FW": Fw}


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


class Conv2d:
    """``fn(image, filt) -> (H, W)`` for one shape and configuration.

    What :func:`make_conv2d` returns.  :meth:`compile` does the host-side
    build of the CUDA library (``nvcc`` and loading it) and returns its
    content address (None for 'xla', which builds nothing); the first call
    on CUDA tensors builds it if that has not happened yet.  A call on CPU
    tensors runs :func:`conv2d_plain`.
    """

    build_name = BUILD_NAME

    def __init__(self, H: int, W: int, Fh: int, Fw: int,
                 config: Optional[Config], weight: float = 1.0):
        cfg = _merged(config)
        validate_config(cfg, H, W, Fh, Fw)
        self.H, self.W, self.Fh, self.Fw = H, W, Fh, Fw
        self.config = cfg
        self.weight = float(weight)
        self.route = "cuda" if cfg["HALO_MODE"] == "materialize" else "library"
        self._lib: Optional[ctypes.CDLL] = None
        self.address: Optional[str] = None

    def defines(self) -> Tuple[Tuple[str, int], ...]:
        """The build's -D defines: one library per distinct value."""
        return tuple(sorted(_defines(self.config, self.Fh, self.Fw).items()))

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
        if image.dtype != torch.float32 or filt.dtype != torch.float32:
            raise ValueError(f"conv2d takes float32, given {image.dtype} "
                             f"and {filt.dtype}")
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
        if self._lib is None:
            self.compile()
        lib = self._lib
        out = torch.empty((self.H, self.W), dtype=torch.float32,
                          device=image.device)
        stream = torch.cuda.current_stream(image.device).cuda_stream
        err = lib.conv2d_launch(image.data_ptr(), filt.data_ptr(),
                                out.data_ptr(), self.H, self.W, self.weight,
                                image.device.index, stream)
        if err:
            raise RuntimeError(
                f"conv2d launch failed ({err}: "
                f"{lib.conv2d_error_string(err).decode()}) for {self.config}")
        LAUNCHES["conv2d"] += 1
        return out


def make_conv2d(H: int, W: int, Fh: int, Fw: int,
                config: Optional[Config] = None,
                weight: float = 1.0) -> Conv2d:
    """Return fn(image, filt) -> (H, W) convolved output."""
    return Conv2d(H, W, Fh, Fw, config, weight)


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
    and the footnote-2 bytes.  'materialize' pays for the halo overlap in
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
