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
  PIPELINE_DEPTH      K/V stages in shared memory, filled with cp.async
                      while the block computes on an earlier stage
  (causal, scale are static problem properties, not tunables)

One build per input type, each bound by its multiplications
(:func:`geometry`, :func:`smem_footprint` and :func:`register_estimate`
take the element width and describe that build).  Every block that
divides the sequences builds, at any head width: the threads cover a
:func:`tile`, the blocks and D rounded up to the geometry, whose excess
is masked (zeros in shared memory, scores of -inf, nothing stored).

* float32: FMA work.  Each thread keeps a TM x TN tile of the scores and
  a TM x TD tile of the output in registers; TK threads share a row group
  and reduce its max and sum with shuffles.  One block's shared memory
  holds the Q tile, the K/V ring and the probabilities P (float32).
* bfloat16: the tensor cores (``mma.sync``), FlashAttention-2 style.
  Each of BLOCK_Q / 16 warps owns 16 query rows; scores and output are
  float32 fragments in registers, and P stays there, rounded to bfloat16
  as the next product's operand.  Shared memory holds Q and the K/V ring,
  rows padded by 16 bytes; there is no P buffer.  P's rounding is the one
  numerical difference from the JAX kernel, which keeps p in float32:
  :func:`flash_plain` rounds at the same point for bfloat16 inputs.

Causal blocks are skipped exactly: a query block whose first row sees key
0 stops after the KV block holding its last row's last visible key
(:func:`kv_end`; the CUDA source mirrors it), since every later block is
fully masked and adds exactly nothing.  A query block with rows that see
no key (causal with Sk < Sq) visits every KV block, which keeps their
mean-of-v answer.  :func:`analytical_time` counts the same blocks.

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

from ...core import trace
from ...core.cost import KernelCost
from ...core.profiles import DeviceProfile
from .. import build
from .ref import NEG, attention_flops

Config = Dict[str, Any]

SOURCE = os.path.join(os.path.dirname(__file__), "csrc", "flash.cu")
BUILD_NAME = "flash"

DEFAULT_CONFIG: Config = {"BLOCK_Q": 64, "BLOCK_K": 64}

#: input/output types the kernel is built for
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: K/V stages when a config does not name PIPELINE_DEPTH (the JAX default)
DEFAULT_PIPELINE_DEPTH = 2
#: threads a block may have: 65,536 registers / 512 leaves each thread 128
MAX_THREADS = 512

#: launches of the CUDA kernel (one per call, whatever the number of
#: heads); comparisons and timing runs count too, so a caller that wants
#: one path's count resets it first
LAUNCHES: Dict[str, int] = {"flash_attention": 0}


def _merged(config: Optional[Config]) -> Config:
    cfg = dict(DEFAULT_CONFIG)
    cfg.update(config or {})
    return cfg


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _threads_k(bk: int, D: int) -> int:
    """TK of the float32 build: the largest power of two not above
    ceil(BLOCK_K / 4), 32 and ceil(D / 4)."""
    n = min(-(-bk // 4), 32, -(-D // 4))
    return 1 << (n.bit_length() - 1)


def tile(config: Config, D: int, elt_bytes: int = 4) -> Tuple[int, int, int]:
    """(TILE_Q, TILE_K, TILE_D): the query rows, keys and head width one
    block of the build for ``elt_bytes``-wide inputs covers.

    The blocks and D rounded up to what the thread geometry tiles:
    bfloat16 to the mma's 16; float32 BLOCK_K to a multiple of 4 and of TK,
    D to 4 * TK and BLOCK_Q to the TM-row groups of whole warps (TM * 32 /
    TK rows).  The grid keeps one block per BLOCK_Q rows and the loop steps
    BLOCK_K keys; the rows, keys and dims past the block and D are zeros
    in shared memory, the keys' scores -inf, and none is stored.  Where the
    geometry tiles the blocks and D exactly, the tile is (BLOCK_Q,
    BLOCK_K, D)."""
    bq, bk = config["BLOCK_Q"], config["BLOCK_K"]
    if elt_bytes == 2:
        return _round_up(bq, 16), _round_up(bk, 16), _round_up(D, 16)
    tm = 8 if bq >= 128 else 4
    tk = _threads_k(bk, D)
    return (_round_up(bq, tm * 32 // tk), _round_up(bk, max(4, tk)),
            _round_up(D, 4 * tk))


def geometry(config: Config, D: int, elt_bytes: int = 4) -> Dict[str, int]:
    """The thread geometry the build for ``elt_bytes``-wide inputs derives
    (``csrc/flash.cu``) over its :func:`tile` (TILE_Q, TILE_K, TILE_D).

    float32: TM query rows a thread (8 when BLOCK_Q >= 128, else 4); TK
    threads share them (:func:`_threads_k`: min(BLOCK_K/4, 32, D/4) where
    those are powers of two); each thread owns TN = TILE_K/TK keys of the
    scores and TD = TILE_D/TK dims of the output.  bfloat16: each of
    WARPS = TILE_Q/16 warps owns 16 query rows as NT = TILE_K/8 score
    tiles and DT = TILE_D/8 output tiles of 16 x 8 (float32 mma
    fragments)."""
    tq, tkeys, td = tile(config, D, elt_bytes)
    if elt_bytes == 2:
        warps = tq // 16
        return {"WARPS": warps, "NT": tkeys // 8, "DT": td // 8,
                "threads": 32 * warps}
    tm = 8 if config["BLOCK_Q"] >= 128 else 4
    tk = _threads_k(config["BLOCK_K"], D)
    return {"TM": tm, "TK": tk, "TN": tkeys // tk, "TD": td // tk,
            "threads": (tq // tm) * tk}


def ragged(config: Config, D: int, elt_bytes: int = 4) -> bool:
    """Whether the build masks its tile (``RAGGED`` in the source): the
    :func:`tile` exceeds the blocks or D."""
    return tile(config, D, elt_bytes) != (config["BLOCK_Q"],
                                          config["BLOCK_K"], D)


def block_threads(config: Config, D: int, elt_bytes: int = 4) -> int:
    return geometry(config, D, elt_bytes)["threads"]


def register_estimate(config: Config, D: int, elt_bytes: int = 4) -> int:
    """32-bit registers a thread needs, roughly.  float32: the score and
    output tiles, m and l, one K vector a key and 32 for addresses and
    loop state.  bfloat16: the score and output fragments (TILE_K/2 and
    TILE_D/2 floats a lane) and 64 for the Q, K, V and P fragments of one
    product, m and l of two rows, addresses and loop state."""
    g = geometry(config, D, elt_bytes)
    if elt_bytes == 2:
        return 4 * (g["NT"] + g["DT"]) + 64
    return g["TM"] * (g["TN"] + g["TD"] + 2) + 4 * g["TN"] + 32


def smem_footprint(config: Config, D: int, elt_bytes: int = 4) -> int:
    """Bytes of shared memory one block claims, over its :func:`tile`.
    float32: P (TILE_Q x TILE_K, rows padded by 4), Q, and PIPELINE_DEPTH
    stages of K and V (Q and K rows padded by 16 bytes).  bfloat16: Q and
    PIPELINE_DEPTH stages of K and V, every row padded by 16 bytes; no
    P."""
    tq, tk, td = tile(config, D, elt_bytes)
    depth = int(config.get("PIPELINE_DEPTH", DEFAULT_PIPELINE_DEPTH))
    qk_row = td * elt_bytes + 16
    if elt_bytes == 2:
        return (tq + 2 * depth * tk) * qk_row
    return (4 * tq * (tk + 4) + tq * qk_row
            + depth * tk * (qk_row + td * elt_bytes))


def kv_end(q0: int, config: Config, Sq: int, Sk: int,
           causal: bool = True) -> int:
    """One past the last key the query block starting at row ``q0``
    visits: the rule of ``csrc/flash.cu``.

    A causal block whose first row sees key 0 (q0 + Sk - Sq >= 0) stops
    after the KV block holding its last row's last visible key; every later
    block is fully masked for all its rows.  A block with rows that see no
    key visits every KV block (their answer is the mean of v)."""
    bq, bk = config["BLOCK_Q"], config["BLOCK_K"]
    shift = Sk - Sq
    if not causal or q0 + shift < 0:
        return Sk
    return min(Sk, -(-(q0 + bq + shift) // bk) * bk)


def validate_config(config: Config, Sq: int, Sk: int, D: int,
                    elt_bytes: int = 4) -> None:
    """Raise ``ValueError`` on blocks that do not divide the sequences (as
    the JAX package does) and on what the card cannot run: fewer than two
    stages, or more than :data:`MAX_THREADS` threads in the build for
    ``elt_bytes``-wide inputs."""
    bq, bk = config["BLOCK_Q"], config["BLOCK_K"]
    if min(bq, bk) < 1 or Sq % bq or Sk % bk:
        raise ValueError(f"({Sq},{Sk}) not divisible by blocks ({bq},{bk})")
    depth = int(config.get("PIPELINE_DEPTH", DEFAULT_PIPELINE_DEPTH))
    if depth < 2:
        raise ValueError(f"PIPELINE_DEPTH={depth}: the ring needs 2 stages")
    threads = block_threads(config, D, elt_bytes)
    if threads > MAX_THREADS:
        raise ValueError(f"BLOCK_Q={bq}, BLOCK_K={bk} need {threads} "
                         f"threads; the kernel takes at most {MAX_THREADS}")


def _defines(cfg: Config, D: int, dtype: torch.dtype) -> Dict[str, int]:
    """The build's -D defines; a :func:`ragged` build also names its tile
    (and, in float32, TK, which the build cannot derive from the tile)."""
    defines = {"BLOCK_Q": cfg["BLOCK_Q"], "BLOCK_K": cfg["BLOCK_K"], "D": D,
               "PIPELINE_DEPTH": int(cfg.get("PIPELINE_DEPTH",
                                             DEFAULT_PIPELINE_DEPTH)),
               "IN_BF16": int(dtype == torch.bfloat16)}
    if ragged(cfg, D, dtype.itemsize):
        tq, tk, td = tile(cfg, D, dtype.itemsize)
        defines.update(RAGGED=1, TILE_Q=tq, TILE_K=tk, TILE_D=td)
        if dtype == torch.float32:
            defines["THREADS_K"] = _threads_k(cfg["BLOCK_K"], D)
    return defines


def flash_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                config: Optional[Config] = None, *, causal: bool = True,
                scale: Optional[float] = None) -> torch.Tensor:
    """The plain PyTorch version: the kernel's online-softmax schedule.

    The keys are walked in BLOCK_K steps; every query row keeps a running
    max m (initialised to -1e30), normaliser l and float32 accumulator acc;
    the result is acc / max(l, 1e-30) in q's dtype.  For bfloat16 inputs
    the weights P are rounded to bfloat16 before P V, where the bfloat16
    build rounds them (l sums them unrounded, as there).  Query blocks are
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
        if q.dtype == torch.bfloat16:
            p = p.to(torch.bfloat16).to(torch.float32)
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
        if dtype not in DTYPES.values():
            raise ValueError(f"flash attention takes float32 or bfloat16, "
                             f"not {dtype}")
        validate_config(cfg, Sq, Sk, D, dtype.itemsize)
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
        if not all(x.is_contiguous() and x.data_ptr() % 16 == 0
                   for x in (q, k, v)):
            raise ValueError("the flash kernel takes contiguous operands "
                             "on 16-byte boundaries (cp.async)")
        if self._lib is None:
            self.compile()
        lib = self._lib
        heads = math.prod(q.shape[:-2])
        with trace.span("kernel.launch"):
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
#: share of the FMA peak the register-tiled loops are modelled to reach
FMA_EFFICIENCY = 0.6


def kv_steps(config: Config, Sq: int, Sk: int, causal: bool = True) -> int:
    """KV steps all query blocks of one head take (:func:`kv_end`)."""
    bq, bk = config["BLOCK_Q"], config["BLOCK_K"]
    return sum(kv_end(q0, config, Sq, Sk, causal) // bk
               for q0 in range(0, Sq, bq))


def analytical_time(config: Config, profile: DeviceProfile,
                    Sq: int, Sk: int, D: int, elt_bytes: int = 4, *,
                    causal: bool = True) -> float:
    """max(compute time, byte time) + per-step overhead, for searches
    without a card; it makes no claim about the kernel's time.

    Both count the KV blocks the kernel visits (:func:`kv_steps`), so a
    causal problem costs about half a full one.  The compute rate is that
    of the units the build multiplies on: a share of the float32 FMA peak
    for 4-byte inputs, the bfloat16 tensor-core peak for 2-byte ones.  Past
    the shared-memory, thread or register limits of the build for
    ``elt_bytes`` the config is infeasible (``math.inf``).
    PIPELINE_DEPTH only scales how well bytes overlap the products.
    """
    cfg = _merged(config)
    bq, bk = cfg["BLOCK_Q"], cfg["BLOCK_K"]
    try:
        validate_config(cfg, Sq, Sk, D, elt_bytes)
    except ValueError:
        return math.inf
    threads = block_threads(cfg, D, elt_bytes)
    smem = smem_footprint(cfg, D, elt_bytes)
    if (not profile.fits_smem(smem) or register_estimate(cfg, D, elt_bytes)
            > min(255, profile.regs_per_sm // threads)):
        return math.inf
    steps = kv_steps(cfg, Sq, Sk, causal)
    flops = 4.0 * steps * bq * bk * D
    if elt_bytes == 2:
        compute_t = flops / profile.peak_bf16_tensor_flops
    else:
        compute_t = flops / (FMA_EFFICIENCY * profile.peak_f32_flops)
    blocks = Sq // bq
    traffic = (2 * Sq * D + steps * 2 * bk * D) * elt_bytes
    overlap = {2: 1.0, 3: 0.97}.get(int(cfg.get("PIPELINE_DEPTH", 2)), 1.0)
    memory_t = traffic / profile.hbm_bw * overlap
    per_sm = max(1, min(THREADS_PER_SM // threads,
                        profile.smem_per_block_optin // smem))
    concurrent = min(blocks, profile.sm_count * per_sm)
    step_t = steps * STEP_OVERHEAD_S / concurrent
    return max(compute_t, memory_t) + step_t + profile.launch_overhead


def traffic(config: Config, Sq: int, Sk: int, D: int, *,
            causal: bool = True, elt_bytes: int = 4) -> KernelCost:
    """The declared cost of one head (:mod:`repro_torch.core.cost`).

    FLOPs are the work itself, 4*Sq*Sk*D, halved when causal (the causal
    half, as the bounds count it).  Bytes follow the block geometry: Q is
    read and the output written once, and each query block reads K and V
    from key 0 up to :func:`kv_end`, so a causal problem reads about half
    of them.  A configuration the kernel cannot build raises
    ``ValueError``.
    """
    cfg = _merged(config)
    validate_config(cfg, Sq, Sk, D, elt_bytes)
    kv_rows = sum(kv_end(q0, cfg, Sq, Sk, causal)
                  for q0 in range(0, Sq, cfg["BLOCK_Q"]))
    nbytes = elt_bytes * (2 * Sq * D + 2 * kv_rows * D)
    return KernelCost(flops=attention_flops(Sq, Sk, D, causal),
                      bytes=nbytes)
