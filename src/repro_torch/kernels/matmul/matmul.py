"""Tunable GEMM for the H100 — the paper's matrix-multiplication case study.

The CUDA kernel ``csrc/gemm.cu`` replaces the JAX package's two Pallas
TPU kernel bodies, ``repro/kernels/matmul/matmul.py::_mm_kernel_scratch``
and ``::_mm_kernel_inplace``.  It is float32 FMA work (no tensor cores, no
TF32), bound by FLOPs on this card; the source's head note says how the
design keeps the FMA units fed: register micro-tiles read from shared
memory 16 bytes at a time, and a ring of PIPELINE_DEPTH shared-memory
stages filled with cp.async, so the copies of later K slices are in
flight while the FMAs of the current one run.

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

The thread geometry follows from the block shape inside the build: each
thread owns a TM x TN micro-tile, TM = 8 when BLOCK_M >= 64 else 4 (TN
likewise), so a block has (BLOCK_M/TM) * (BLOCK_N/TN) threads.

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


def micro_tile(config: Config) -> Tuple[int, int, int]:
    """(TM, TN, threads per block) the build derives from the block shape."""
    bm, bn = config["BLOCK_M"], config["BLOCK_N"]
    tm = 8 if bm >= 64 else 4
    tn = 8 if bn >= 64 else 4
    return tm, tn, (bm // tm) * (bn // tn)


def validate_config(config: Config, M: int, N: int, K: int) -> None:
    bm, bn, bk = config["BLOCK_M"], config["BLOCK_N"], config["BLOCK_K"]
    if M % bm or N % bn or K % bk:
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
    tm, tn, threads = micro_tile(config)
    if bm % tm or bn % tn:
        raise ValueError(f"BLOCK_M/BLOCK_N ({bm},{bn}) must be multiples "
                         f"of the {tm}x{tn} micro-tile")
    if threads > 1024:
        raise ValueError(f"({bm},{bn}) blocks need {threads} threads; "
                         "a block has at most 1024")
    if bm % 8 or bn % 8 or bk % 8:
        raise ValueError(f"blocks ({bm},{bn},{bk}) must be multiples of 8: "
                         "the slices are copied 16 bytes at a time")
    if int(config.get("PIPELINE_DEPTH", DEFAULT_PIPELINE_DEPTH)) < 2:
        raise ValueError("PIPELINE_DEPTH must be at least 2 (a ring)")


def smem_footprint(config: Config, elt_bytes: int = 4) -> int:
    """Bytes of shared memory one block claims: PIPELINE_DEPTH stages of a
    BLOCK_K slice of A and of B, unpadded, in the input type."""
    cfg = _merged(config)
    bm, bn, bk = cfg["BLOCK_M"], cfg["BLOCK_N"], cfg["BLOCK_K"]
    depth = int(cfg.get("PIPELINE_DEPTH", DEFAULT_PIPELINE_DEPTH))
    return elt_bytes * depth * bk * (bm + bn)


def _defines(cfg: Config, dtype: torch.dtype) -> Dict[str, int]:
    return {
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
        validate_config(cfg, M, N, K)
        if dtype not in DTYPES.values():
            raise ValueError(f"the GEMM takes float32 or bfloat16, not {dtype}")
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
        c = torch.empty((self.M, self.N), dtype=self.dtype, device=a.device)
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.gemm_launch(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                              self.M, self.N, self.K, a.device.index, stream)
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
    """max(FLOPs / f32 peak, bytes / HBM bandwidth) + per-wave overhead.

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
    compute_t = flops(M, N, K) / profile.peak_f32_flops
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
    validate_config(cfg, M, N, K)
    bm, bn = cfg["BLOCK_M"], cfg["BLOCK_N"]
    nbytes = elt_bytes * (M * K * (N // bn) + K * N * (M // bm) + M * N)
    return KernelCost(flops=flops(M, N, K), bytes=nbytes)
