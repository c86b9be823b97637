"""Tunable flash attention for the H100 (online softmax, chunked KV).

Beyond-paper case study: the paper predates attention workloads, but its
thesis — tile sizes must be tuned per shape and device — applies directly.
The CUDA kernel ``csrc/flash.cu`` replaces the JAX package's Pallas TPU
kernel body ``repro/kernels/attention/flash.py::_flash_kernel``; the
source's head note says what bounds it and how it is laid out.

Tunables (the JAX package's names; values re-derived for the card in
``ops.py``):

  BLOCK_Q / BLOCK_K   query rows of one thread block / keys per step of its
                      loop over the keys
  PIPELINE_DEPTH      analytical-model only: every value builds the same
                      kernel
  (causal, scale are static problem properties, not tunables)

Thread geometry: 4 threads per query row, 4 * BLOCK_Q threads a block
(:func:`block_threads`).  One block's shared memory holds the Q tile, one
K and one V tile and the BLOCK_Q x BLOCK_K scores, all float32
(:func:`smem_footprint`), which caps the blocks at D = 128 well below the
JAX package's.

Leading dims (batch x heads), which the JAX package vmaps, are one more
grid dimension of the kernel: one launch for all heads.

Which implementation runs follows the tensors' device alone: tensors on
the CPU take the plain PyTorch version (:func:`flash_plain`, the same
online-softmax block schedule); CUDA tensors take the kernel, or the call
raises.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Any, Dict, Optional, Tuple

import torch

from ...core.profiles import DeviceProfile
from .. import build
from .ref import NEG

Config = Dict[str, Any]

SOURCE = os.path.join(os.path.dirname(__file__), "csrc", "flash.cu")
BUILD_NAME = "flash"

DEFAULT_CONFIG: Config = {"BLOCK_Q": 64, "BLOCK_K": 64}

#: input/output types the kernel is built for
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: threads per query row (the build's TPR)
THREADS_PER_ROW = 4

#: launches of the CUDA kernel (one per call, whatever the number of
#: heads); comparisons and timing runs count too, so a caller that wants
#: one path's count resets it first
LAUNCHES: Dict[str, int] = {"flash_attention": 0}


def _merged(config: Optional[Config]) -> Config:
    cfg = dict(DEFAULT_CONFIG)
    cfg.update(config or {})
    return cfg


def block_threads(config: Config) -> int:
    return THREADS_PER_ROW * config["BLOCK_Q"]


def smem_footprint(config: Config, D: int) -> int:
    """Bytes of shared memory one block claims: Q (BLOCK_Q x D), K (rows
    padded by one float), V, and the scores (rows padded by one float), all
    float32 whatever the input type."""
    bq, bk = config["BLOCK_Q"], config["BLOCK_K"]
    return 4 * (bq * D + bk * (D + 1) + bk * D + bq * (bk + 1))


def validate_config(config: Config, Sq: int, Sk: int, D: int) -> None:
    bq, bk = config["BLOCK_Q"], config["BLOCK_K"]
    if Sq % bq or Sk % bk:
        raise ValueError(f"({Sq},{Sk}) not divisible by blocks ({bq},{bk})")
    if bq % 8:
        raise ValueError(f"BLOCK_Q={bq}: the kernel needs a multiple of 8 "
                         "(whole warps of 4 threads per row)")
    if block_threads(config) > 1024:
        raise ValueError(f"BLOCK_Q={bq} needs {block_threads(config)} "
                         "threads; a block has at most 1024")
    if D % THREADS_PER_ROW:
        raise ValueError(f"D={D} must divide by {THREADS_PER_ROW}")


def _defines(cfg: Config, D: int, dtype: torch.dtype) -> Dict[str, int]:
    return {"BLOCK_Q": cfg["BLOCK_Q"], "BLOCK_K": cfg["BLOCK_K"], "D": D,
            "IN_BF16": int(dtype == torch.bfloat16)}


def flash_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                config: Optional[Config] = None, *, causal: bool = True,
                scale: Optional[float] = None) -> torch.Tensor:
    """The plain PyTorch version: the kernel's online-softmax schedule.

    The keys are walked in BLOCK_K steps; every query row keeps a running
    max m (initialised to -1e30), normaliser l and float32 accumulator acc;
    the result is acc / max(l, 1e-30) in q's dtype.  Query blocks are
    independent, so all rows go at once.  q: (..., Sq, D), k/v: (..., Sk, D).
    """
    cfg = _merged(config)
    sq, d = q.shape[-2:]
    sk = k.shape[-2]
    bk = cfg["BLOCK_K"]
    scale = (d ** -0.5) if scale is None else scale
    qf, kf, vf = (x.to(torch.float32) for x in (q, k, v))
    m = torch.full((*q.shape[:-1], 1), NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((*q.shape[:-1], d), dtype=torch.float32,
                      device=q.device)
    q_pos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    for k0 in range(0, sk, bk):
        s = (qf @ kf[..., k0:k0 + bk, :].transpose(-1, -2)) * scale
        if causal:
            k_pos = torch.arange(k0, k0 + bk, device=q.device)[None, :]
            s = torch.where(q_pos >= k_pos, s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p @ vf[..., k0:k0 + bk, :]
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


class FlashAttention:
    """``fn(q, k, v) -> (..., Sq, D)`` for one shape and configuration.

    What :func:`make_flash_attention` returns.  q is (..., Sq, D), k and v
    (..., Sk, D) with the same leading dims; each leading index is one
    independent head.  :meth:`compile` does the host-side build (``nvcc``
    and loading the library) and returns its content address; the first
    call on CUDA tensors builds it if that has not happened yet.  A call on
    CPU tensors runs :func:`flash_plain`.
    """

    build_name = BUILD_NAME

    def __init__(self, Sq: int, Sk: int, D: int, config: Optional[Config],
                 causal: bool = True, scale: Optional[float] = None,
                 dtype: torch.dtype = torch.float32):
        cfg = _merged(config)
        validate_config(cfg, Sq, Sk, D)
        if dtype not in DTYPES.values():
            raise ValueError(f"flash attention takes float32 or bfloat16, "
                             f"not {dtype}")
        self.Sq, self.Sk, self.D = Sq, Sk, D
        self.config = cfg
        self.causal = bool(causal)
        self.scale = (D ** -0.5) if scale is None else float(scale)
        self.dtype = dtype
        self._lib: Optional[ctypes.CDLL] = None
        self.address: Optional[str] = None

    def compile(self) -> str:
        if self._lib is None:
            lib, address = build.load(
                SOURCE, _defines(self.config, self.D, self.dtype), BUILD_NAME)
            lib.flash_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            lib.flash_launch.restype = ctypes.c_int
            lib.flash_error_string.argtypes = [ctypes.c_int]
            lib.flash_error_string.restype = ctypes.c_char_p
            lib.flash_smem_bytes.restype = ctypes.c_int
            lib.flash_threads.restype = ctypes.c_int
            self._lib, self.address = lib, address
        return self.address

    def geometry(self) -> Tuple[int, int]:
        """(threads, shared-memory bytes) of one block, as the build
        reports them; builds the library if that has not happened yet."""
        if self.compile() is None:
            return 0, 0
        return self._lib.flash_threads(), self._lib.flash_smem_bytes()

    def _check(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
               ) -> None:
        lead = tuple(q.shape[:-2])
        want_q = lead + (self.Sq, self.D)
        want_kv = lead + (self.Sk, self.D)
        if (tuple(q.shape) != want_q or tuple(k.shape) != want_kv
                or tuple(v.shape) != want_kv):
            raise ValueError(
                f"flash attention built for q{want_q}, k/v{want_kv}; given "
                f"q{tuple(q.shape)}, k{tuple(k.shape)}, v{tuple(v.shape)}")
        if not q.dtype == k.dtype == v.dtype == self.dtype:
            raise ValueError(f"flash attention built for {self.dtype}, given "
                             f"{q.dtype}, {k.dtype} and {v.dtype}")
        if not q.device == k.device == v.device:
            raise ValueError(f"operands on {q.device}, {k.device} and "
                             f"{v.device}")

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                 ) -> torch.Tensor:
        self._check(q, k, v)
        if q.device.type == "cpu":
            return flash_plain(q, k, v, self.config, causal=self.causal,
                               scale=self.scale)
        if q.device.type != "cuda":
            raise ValueError(f"no flash attention for device {q.device}")
        return self._launch(q, k, v)

    def _launch(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                ) -> torch.Tensor:
        if not torch.cuda.is_available():
            raise RuntimeError("flash attention: CUDA tensors given, but no "
                               "CUDA device is available")
        if not (q.is_contiguous() and k.is_contiguous()
                and v.is_contiguous()):
            raise ValueError("the flash kernel takes contiguous operands")
        if self._lib is None:
            self.compile()
        lib = self._lib
        heads = math.prod(q.shape[:-2])
        out = torch.empty(q.shape, dtype=self.dtype, device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               out.data_ptr(), heads, self.Sq, self.Sk,
                               int(self.causal), self.scale,
                               q.device.index, stream)
        if err:
            raise RuntimeError(
                f"flash launch failed ({err}: "
                f"{lib.flash_error_string(err).decode()}) for {self.config}")
        LAUNCHES["flash_attention"] += 1
        return out


def make_flash_attention(Sq: int, Sk: int, D: int,
                         config: Optional[Config] = None, *,
                         causal: bool = True, scale: Optional[float] = None,
                         dtype: torch.dtype = torch.float32
                         ) -> FlashAttention:
    """Return fn(q, k, v) -> (..., Sq, D) attention output."""
    return FlashAttention(Sq, Sk, D, config, causal, scale, dtype)


# ---------------------------------------------------------------------------
# structural cost model (feeds AnalyticalEvaluator and auto-constraints)
# ---------------------------------------------------------------------------

#: barriers and row statistics of one KV step of one block, seconds (a
#: model constant)
STEP_OVERHEAD_S = 0.5e-6
#: threads one SM holds
THREADS_PER_SM = 2048


def analytical_time(config: Config, profile: DeviceProfile,
                    Sq: int, Sk: int, D: int, elt_bytes: int = 4) -> float:
    """max(FMA time, byte time) + per-step overhead, for searches without
    a card; it makes no claim about the kernel's time.

    The kernel visits every KV block, so a causal problem costs as much as
    a full one and the model does not ask which it is.  Past the shared-memory or thread limits the config is
    infeasible (``math.inf``).  PIPELINE_DEPTH only scales how well bytes
    overlap the FMAs.
    """
    cfg = _merged(config)
    bq, bk = cfg["BLOCK_Q"], cfg["BLOCK_K"]
    if Sq % bq or Sk % bk or bq % 8:
        return math.inf
    threads = block_threads(cfg)
    smem = smem_footprint(cfg, D)
    if threads > 1024 or not profile.fits_smem(smem):
        return math.inf
    flops = 4.0 * Sq * Sk * D
    # both operands of a score FMA come from shared memory
    compute_t = flops / (0.4 * profile.peak_f32_flops)
    blocks = Sq // bq
    traffic = (2 * Sq * D + blocks * 2 * Sk * D) * elt_bytes
    overlap = {2: 1.0, 3: 0.97}.get(int(cfg.get("PIPELINE_DEPTH", 2)), 1.0)
    memory_t = traffic / profile.hbm_bw * overlap
    per_sm = max(1, min(THREADS_PER_SM // threads,
                        profile.smem_per_block_optin // smem))
    concurrent = min(blocks, profile.sm_count * per_sm)
    step_t = blocks * (Sk // bk) * STEP_OVERHEAD_S / concurrent
    return max(compute_t, memory_t) + step_t + profile.launch_overhead
