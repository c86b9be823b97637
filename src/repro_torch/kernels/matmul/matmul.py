"""Tunable GEMM for the H100 — the paper's matrix-multiplication case study.

The CUDA kernel ``csrc/gemm.cu`` replaces the JAX package's two Pallas
TPU kernel bodies, ``repro/kernels/matmul/matmul.py::_mm_kernel_scratch``
and ``::_mm_kernel_inplace``.  Both of its builds are bound by operations
on this card and stage their operands in a ring of PIPELINE_DEPTH
shared-memory stages filled with cp.async, so the copies of later K
slices are in flight while the current one is multiplied.  The bfloat16
build multiplies on the tensor cores (``mma.sync`` fed by ``ldmatrix``
from swizzled stages; a warp owns a :func:`warp_tile` of the output in
float32 fragments); the float32 build on the FMA units (no tensor cores,
no TF32), each thread owning a :func:`micro_tile` of the output in
registers.  The source's head note says how each is laid out.

Parameter vocabulary (paper Table IV, re-derived for Hopper):

  BLOCK_M / BLOCK_N / BLOCK_K   shared-memory tile sizes (paper: M_wg/N_wg/K_wg)
  GRID_ORDER  'mn' | 'nm'       which of M and N ``blockIdx.x`` walks
  INNER_STEPS 1|2|4|8           K sub-steps per BLOCK_K step (paper: K_wi)
  ACC_DTYPE   float32|bfloat16  accumulator precision: bfloat16 rounds the
                                running sum after every sub-step, exactly
                                where the TPU kernel's accumulator rounds
  ACC_IN_OUTPUT True|False      the TPU kernel sums into the output block
                                instead of a scratch buffer.  On Hopper the
                                sum lives in registers either way, so both
                                values build the same kernel; they are
                                counted apart (LAUNCHES).  Requires float32
                                accumulation and a float32 output, as in
                                the JAX package
  TRANS_A     True|False        A arrives (K, M): C = A^T B (the paper's form)

The thread geometry follows from the block shape inside the build
(:func:`block_threads`).  The threads cover a :func:`tile`: the block,
rounded up where the geometry does not tile it (BLOCK_M 100 in float32
is a tile of 104 rows, in bfloat16 of 128; its extra rows are zeros on
load and are not stored), so every block that divides the problem
builds.  In float32 each thread owns a TM x TN micro-tile, TM = 8 when
BLOCK_M >= 64 else 4 (TN likewise), so a block has (TILE_M/TM) *
(TILE_N/TN) threads.  In bfloat16 each warp owns a WM x WN warp tile,
the largest of 64, 32 and 16 that divides half the tile's side, else 16
(WN at most 32 under a bfloat16 accumulator), so a block has 32 *
(TILE_M/WM) * (TILE_N/WN) threads.

PIPELINE_DEPTH (the extended space's; 2 where a config does not name it,
the JAX default) is the number of shared-memory stages.  The extended
space's NBUF_OUT and PACK are analytic-model-only: they do not change the
build.

Which implementation runs follows the tensors' device alone: tensors on
the CPU take the plain PyTorch version (:func:`gemm_plain`, an emulation of
the same block schedule, the counterpart of Pallas interpret mode); CUDA
tensors take the kernel, or the call raises.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Any, Dict, Optional, Tuple

import torch

from ...core import trace
from ...core.cost import KernelCost
from ...core.profiles import DeviceProfile
from .. import build

Config = Dict[str, Any]

SOURCE = os.path.join(os.path.dirname(__file__), "csrc", "gemm.cu")
BUILD_NAME = "gemm"

DEFAULT_CONFIG: Config = {
    "BLOCK_M": 64, "BLOCK_N": 64, "BLOCK_K": 32,
    "GRID_ORDER": "mn", "INNER_STEPS": 1,
    "ACC_DTYPE": "float32", "ACC_IN_OUTPUT": False, "TRANS_A": False,
}

#: shared-memory stages when a config does not name PIPELINE_DEPTH (the
#: JAX default)
DEFAULT_PIPELINE_DEPTH = 2

#: input/output types the kernel is built for
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: launches of the CUDA kernel, by the TPU kernel body each one stands for
#: (``gemm_inplace`` = ACC_IN_OUTPUT); comparisons and timing runs count
#: too, so a caller that wants one path's count resets it first
LAUNCHES: Dict[str, int] = {"gemm_scratch": 0, "gemm_inplace": 0}


def _merged(config: Optional[Config]) -> Config:
    cfg = dict(DEFAULT_CONFIG)
    cfg.update(config or {})
    return cfg


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _side_bf16(b: int) -> int:
    """A block side as the bfloat16 build's warps tile it: the side itself
    when a multiple of 16 (the mma's m16 and two n8 tiles), else the
    smallest of 16, 32 and the multiples of 64 above it, which keeps the
    warp tiles of :func:`warp_tile` wide."""
    if b % 16 == 0:
        return b
    return 16 if b <= 16 else 32 if b <= 32 else _round_up(b, 64)


def k_segments(config: Config, elt_bytes: int = 4) -> Tuple[int, int, int]:
    """(segments, tile columns of a segment, depth of a segment) of one K
    slice in the build's tile.  The float32 build stages the BLOCK_K slice
    as it is: one segment.  The bfloat16 build multiplies 8 or 16 deep, and
    a sum rounded to bfloat16 (ACC_DTYPE) must end where a sub-dot of
    BLOCK_K / INNER_STEPS ends; where the sub-dot (the whole slice under a
    float32 accumulator) is neither a multiple of 8 nor 1, 2 or 4 of an
    8-deep slice, each sub-dot gets a segment of its own, padded to 8 (up
    to 8 deep) or to a multiple of 16, with zeros past its depth."""
    bk = config["BLOCK_K"]
    if elt_bytes == 4:
        return 1, bk, bk
    acc_bf16 = config.get("ACC_DTYPE", "float32") == "bfloat16"
    sub = bk // config.get("INNER_STEPS", 1) if acc_bf16 else bk
    if sub % 8 == 0 or (sub in (1, 2, 4) and bk % 8 == 0):
        return 1, bk, bk
    return bk // sub, (8 if sub <= 8 else _round_up(sub, 16)), sub


def tile(config: Config, elt_bytes: int = 4) -> Tuple[int, int, int]:
    """(TILE_M, TILE_N, TILE_K): the block as the build's threads cover it.

    Each side is rounded up to what the thread geometry needs: in float32
    to the micro-tile (TM = 8 when BLOCK_M >= 64 else 4, TN likewise), in
    bfloat16 to the mma tiles (:func:`_side_bf16`, :func:`k_segments`).
    The grid keeps one block per config block; the rows, columns and depth
    of the tile past the block are zero-filled on load and never stored.
    At every config whose block the threads tile exactly, the tile is the
    block."""
    bm, bn = config["BLOCK_M"], config["BLOCK_N"]
    segments, seg, _ = k_segments(config, elt_bytes)
    if elt_bytes == 4:
        tm, tn, _ = micro_tile(config)
        return _round_up(bm, tm), _round_up(bn, tn), segments * seg
    return _side_bf16(bm), _side_bf16(bn), segments * seg


def ragged(config: Config, elt_bytes: int = 4) -> bool:
    """Whether the build masks its tile (``RAGGED`` in the source) and
    copies element by element: the tile exceeds the block, or a block
    side is no multiple of 8, which the unmasked build, copying its slices
    in 16-byte chunks, does not take."""
    bm, bn, bk = config["BLOCK_M"], config["BLOCK_N"], config["BLOCK_K"]
    return (tile(config, elt_bytes) != (bm, bn, bk)
            or bool(bm % 8 or bn % 8 or bk % 8))


def micro_tile(config: Config) -> Tuple[int, int, int]:
    """(TM, TN, threads per block) the float32 build derives from the
    block shape: TM = 8 when BLOCK_M >= 64 else 4 (TN likewise), one
    thread a TM x TN micro-tile of the :func:`tile`."""
    bm, bn = config["BLOCK_M"], config["BLOCK_N"]
    tm = 8 if bm >= 64 else 4
    tn = 8 if bn >= 64 else 4
    return tm, tn, (_round_up(bm, tm) // tm) * (_round_up(bn, tn) // tn)


def warp_tile(config: Config) -> Tuple[int, int, int]:
    """(WM, WN, threads per block) the bfloat16 build derives from the
    block shape: each warp owns a WM x WN tile of the output as float32
    mma fragments, WM the largest of 64, 32 and 16 that divides half of
    the tile's side (:func:`_side_bf16` of BLOCK_M; else 16), WN likewise
    for BLOCK_N but at most 32 under a bfloat16 accumulator (which keeps a
    second set of fragments).  Two warps along each side keep a 64 x 64
    block at four warps: one warp of 64 x 64 fragments spills there."""
    bm, bn = _side_bf16(config["BLOCK_M"]), _side_bf16(config["BLOCK_N"])
    acc_bf16 = config.get("ACC_DTYPE", "float32") == "bfloat16"
    wm = next((w for w in (64, 32, 16) if bm % (2 * w) == 0), 16)
    wn = next((w for w in ((32, 16) if acc_bf16 else (64, 32, 16))
               if bn % (2 * w) == 0), 16)
    return wm, wn, 32 * (bm // wm) * (bn // wn)


def block_threads(config: Config, elt_bytes: int = 4) -> int:
    """Threads of one block of the build for ``elt_bytes``-wide operands:
    the float32 build's :func:`micro_tile` or the bfloat16 build's
    :func:`warp_tile`."""
    return (micro_tile(config) if elt_bytes == 4 else warp_tile(config))[2]


def validate_config(config: Config, M: int, N: int, K: int,
                    elt_bytes: int = 4) -> None:
    """Raise ``ValueError`` on what the JAX package refuses (blocks that do
    not divide the dims, INNER_STEPS that does not divide BLOCK_K, an
    in-place bfloat16 sum) and on what the card cannot launch: more than
    1024 threads, or fewer than two stages, in the build for
    ``elt_bytes``-wide operands."""
    bm, bn, bk = config["BLOCK_M"], config["BLOCK_N"], config["BLOCK_K"]
    if min(bm, bn, bk) < 1 or M % bm or N % bn or K % bk:
        raise ValueError(f"dims ({M},{N},{K}) not divisible by blocks "
                         f"({bm},{bn},{bk})")
    if bk % config["INNER_STEPS"]:
        raise ValueError("BLOCK_K must divide by INNER_STEPS")
    if config["ACC_IN_OUTPUT"] and config["ACC_DTYPE"] != "float32":
        raise ValueError("ACC_IN_OUTPUT requires float32 accumulation")
    if config["GRID_ORDER"] not in ("mn", "nm"):
        raise ValueError(f"bad GRID_ORDER {config['GRID_ORDER']!r}")
    if config["ACC_DTYPE"] not in DTYPES:
        raise ValueError(f"bad ACC_DTYPE {config['ACC_DTYPE']!r}")
    threads = block_threads(config, elt_bytes)
    if threads > 1024:
        raise ValueError(f"({bm},{bn}) blocks need {threads} threads; "
                         "a block has at most 1024")
    if int(config.get("PIPELINE_DEPTH", DEFAULT_PIPELINE_DEPTH)) < 2:
        raise ValueError("PIPELINE_DEPTH must be at least 2 (a ring)")


def smem_footprint(config: Config, elt_bytes: int = 4) -> int:
    """Bytes of shared memory one block claims: PIPELINE_DEPTH stages of a
    K slice of A and of B as the :func:`tile` holds them, unpadded, in the
    input type."""
    cfg = _merged(config)
    tm, tn, tk = tile(cfg, elt_bytes)
    depth = int(cfg.get("PIPELINE_DEPTH", DEFAULT_PIPELINE_DEPTH))
    return elt_bytes * depth * tk * (tm + tn)


def _defines(cfg: Config, dtype: torch.dtype) -> Dict[str, int]:
    """The build's -D defines; a :func:`ragged` build also names its tile
    and the K segments of :func:`k_segments`."""
    defines = {
        "BLOCK_M": cfg["BLOCK_M"], "BLOCK_N": cfg["BLOCK_N"],
        "BLOCK_K": cfg["BLOCK_K"],
        "GRID_NM": int(cfg["GRID_ORDER"] == "nm"),
        "INNER_STEPS": cfg["INNER_STEPS"],
        "ACC_BF16": int(cfg["ACC_DTYPE"] == "bfloat16"),
        "TRANS_A": int(bool(cfg["TRANS_A"])),
        "IN_BF16": int(dtype == torch.bfloat16),
        "PIPELINE_DEPTH": int(cfg.get("PIPELINE_DEPTH",
                                      DEFAULT_PIPELINE_DEPTH)),
    }
    if ragged(cfg, dtype.itemsize):
        tm, tn, tk = tile(cfg, dtype.itemsize)
        _, seg, sub = k_segments(cfg, dtype.itemsize)
        defines.update(RAGGED=1, TILE_M=tm, TILE_N=tn, TILE_K=tk, K_SEG=seg,
                       K_SUB=sub)
    return defines


def gemm_plain(a: torch.Tensor, b: torch.Tensor,
               config: Optional[Config] = None) -> torch.Tensor:
    """The plain PyTorch version: the kernel's block schedule on any device.

    K is walked in BLOCK_K steps of INNER_STEPS sub-dots, each a float32
    product; a bfloat16 accumulator rounds each sub-dot and then the running
    sum — the TPU kernel's rounding points.  M and N need no tiling: their
    blocks are independent.  The result has ``a``'s dtype.
    """
    cfg = _merged(config)
    lhs = (a.t() if cfg["TRANS_A"] else a).to(torch.float32)
    rhs = b.to(torch.float32)
    K = lhs.shape[1]
    bk = cfg["BLOCK_K"]
    sub = bk // cfg["INNER_STEPS"]
    acc_bf16 = cfg["ACC_DTYPE"] == "bfloat16"
    acc = torch.zeros((lhs.shape[0], rhs.shape[1]), dtype=torch.float32,
                      device=a.device)
    for k0 in range(0, K, bk):
        for s in range(k0, k0 + bk, sub):
            d = lhs[:, s:s + sub] @ rhs[s:s + sub, :]
            if acc_bf16:
                acc = (acc + d.bfloat16().float()).bfloat16().float()
            else:
                acc += d
    return acc.to(a.dtype)


class Gemm:
    """``fn(a, b) -> op(a) @ b`` for one shape and configuration.

    What :func:`make_matmul` returns.  :meth:`compile` does the host-side
    build of the CUDA library (``nvcc`` and loading it) and returns its
    content address; the first call on CUDA tensors builds it if that has
    not happened yet.  A call on CPU tensors runs :func:`gemm_plain`.
    """

    build_name = BUILD_NAME

    def __init__(self, M: int, N: int, K: int, config: Optional[Config],
                 dtype: torch.dtype):
        cfg = _merged(config)
        if dtype not in DTYPES.values():
            raise ValueError(f"the GEMM takes float32 or bfloat16, not {dtype}")
        validate_config(cfg, M, N, K, dtype.itemsize)
        if cfg["ACC_IN_OUTPUT"] and dtype != torch.float32:
            raise ValueError("ACC_IN_OUTPUT requires a float32 output")
        self.M, self.N, self.K = M, N, K
        self.config = cfg
        self.dtype = dtype
        self.variant = ("gemm_inplace" if cfg["ACC_IN_OUTPUT"]
                        else "gemm_scratch")
        self._lib: Optional[ctypes.CDLL] = None
        self.address: Optional[str] = None

    def compile(self) -> str:
        if self._lib is None:
            lib, address = build.load(SOURCE, _defines(self.config, self.dtype),
                                      BUILD_NAME)
            lib.gemm_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p]
            lib.gemm_launch.restype = ctypes.c_int
            lib.gemm_error_string.argtypes = [ctypes.c_int]
            lib.gemm_error_string.restype = ctypes.c_char_p
            lib.gemm_smem_bytes.restype = ctypes.c_int
            lib.gemm_threads.restype = ctypes.c_int
            self._lib, self.address = lib, address
        return self.address

    def geometry(self) -> Tuple[int, int]:
        """(threads, shared-memory bytes) of one block, as the build
        reports them; builds the library if that has not happened yet."""
        self.compile()
        return self._lib.gemm_threads(), self._lib.gemm_smem_bytes()

    def _check(self, a: torch.Tensor, b: torch.Tensor) -> None:
        a_shape = ((self.K, self.M) if self.config["TRANS_A"]
                   else (self.M, self.K))
        if tuple(a.shape) != a_shape or tuple(b.shape) != (self.K, self.N):
            raise ValueError(
                f"GEMM built for a{a_shape} @ b{(self.K, self.N)}, given "
                f"a{tuple(a.shape)} @ b{tuple(b.shape)}")
        if a.dtype != self.dtype or b.dtype != self.dtype:
            raise ValueError(f"GEMM built for {self.dtype}, given "
                             f"{a.dtype} and {b.dtype}")
        if a.device != b.device:
            raise ValueError(f"operands on {a.device} and {b.device}")

    def __call__(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        self._check(a, b)
        if a.device.type == "cpu":
            return gemm_plain(a, b, self.config)
        if a.device.type != "cuda":
            raise ValueError(f"no GEMM for device {a.device}")
        return self._launch(a, b)

    def _launch(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if not torch.cuda.is_available():
            raise RuntimeError("GEMM: CUDA tensors given, but no CUDA "
                               "device is available")
        if not all(x.is_contiguous() and x.data_ptr() % 16 == 0
                   for x in (a, b)):
            raise ValueError("the GEMM kernel takes contiguous operands on "
                             "16-byte boundaries (cp.async)")
        lib = self._lib
        if lib is None:
            self.compile()
            lib = self._lib
        with trace.span("kernel.launch"):
            c = torch.empty((self.M, self.N), dtype=self.dtype,
                            device=a.device)
            stream = torch.cuda.current_stream(a.device).cuda_stream
            err = lib.gemm_launch(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                  self.M, self.N, self.K, a.device.index,
                                  stream)
        if err:
            raise RuntimeError(
                f"GEMM launch failed ({err}: "
                f"{lib.gemm_error_string(err).decode()}) for {self.config}")
        LAUNCHES[self.variant] += 1
        return c


def make_matmul(M: int, N: int, K: int, config: Optional[Config] = None,
                out_dtype: torch.dtype = torch.float32) -> Gemm:
    """Return fn(a, b) -> op(a) @ b with the given tile configuration.

    ``a`` is (M, K), or (K, M) when TRANS_A (paper's A^T input layout);
    ``a``, ``b`` and the result have ``out_dtype`` (float32 or bfloat16).
    """
    return Gemm(M, N, K, config, out_dtype)


# ---------------------------------------------------------------------------
# structural cost model (feeds AnalyticalEvaluator and auto-constraints)
# ---------------------------------------------------------------------------

#: fixed cost of one wave of blocks over the SMs, seconds (a model constant)
WAVE_OVERHEAD_S = 1.0e-6


def analytical_time(config: Config, profile: DeviceProfile,
                    M: int, N: int, K: int, elt_bytes: int = 4) -> float:
    """max(FLOPs / peak, bytes / HBM bandwidth) + per-wave overhead.

    The peak is the rate of the units the build multiplies on: the
    float32 FMA rate for 4-byte operands, the bfloat16 tensor-core rate
    for 2-byte ones.

    The bytes are what the blocks stream: every block reads its BLOCK_M
    rows of A and BLOCK_N columns of B over all of K, and writes its tile
    once, so small tiles pay in traffic.  Past the shared-memory cliff (the
    footprint at ``elt_bytes``, as the build stages it) the configuration
    is infeasible (``math.inf``).  A model for searches
    without a card; it makes no claim about the kernel's time.
    """
    cfg = _merged(config)
    bm, bn, bk = cfg["BLOCK_M"], cfg["BLOCK_N"], cfg["BLOCK_K"]
    if M % bm or N % bn or K % bk or bk % cfg["INNER_STEPS"]:
        return math.inf
    if cfg["ACC_IN_OUTPUT"] and cfg["ACC_DTYPE"] != "float32":
        return math.inf
    if not profile.fits_smem(smem_footprint(cfg, elt_bytes)):
        return math.inf                       # the paper's local-memory cliff
    gm, gn = M // bm, N // bn
    peak = (profile.peak_f32_flops if elt_bytes == 4
            else profile.peak_bf16_tensor_flops)
    compute_t = flops(M, N, K) / peak
    traffic = gm * gn * (bm + bn) * K * elt_bytes + M * N * elt_bytes
    memory_t = traffic / profile.hbm_bw
    waves = math.ceil(gm * gn / profile.sm_count)
    return (max(compute_t, memory_t) + waves * WAVE_OVERHEAD_S
            + profile.launch_overhead)


def flops(M: int, N: int, K: int) -> float:
    return 2.0 * M * N * K


def traffic(config: Config, M: int, N: int, K: int,
            elt_bytes: int = 4) -> KernelCost:
    """The declared cost of one launch (:mod:`repro_torch.core.cost`).

    FLOPs are the product's 2*M*N*K.  Bytes follow the block geometry:
    each of the M/BLOCK_M * N/BLOCK_N blocks reads its BLOCK_M rows of A
    and BLOCK_N columns of B over all of K, so A is read N/BLOCK_N times
    and B M/BLOCK_M times; C is written once.  ACC_IN_OUTPUT does not add
    a read of C: the kernel sums in registers for both TPU bodies, so the
    in-place variant moves the same bytes.  A configuration the kernel
    cannot build raises ``ValueError``.
    """
    cfg = _merged(config)
    validate_config(cfg, M, N, K, elt_bytes)
    bm, bn = cfg["BLOCK_M"], cfg["BLOCK_N"]
    nbytes = elt_bytes * (M * K * (N // bn) + K * N * (M // bm) + M * N)
    return KernelCost(flops=flops(M, N, K), bytes=nbytes)
