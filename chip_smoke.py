"""GPU smoke test of the PyTorch / CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py               # on the machine with the card
    python3 chip_smoke.py --rehearse    # the same control flow on the CPU,
                                        # plain versions only, tiny shapes
    python3 chip_smoke.py --times-bf16 GEMM_CONFIG FLASH_CONFIG [CONV_CONFIG]
                                        # [times-bf16] alone at these
                                        # configs (JSON)
    python3 chip_smoke.py --sass-against PARENT_ROOT SOURCE DEFINES...
                                        # one source's SASS from this
                                        # tree and another, compared

It drives the port's three main paths — tune -> record -> lookup -> run —
through the entry points a user calls, and holds every CUDA kernel on
them against its plain PyTorch version and the PyTorch oracle.  Phases,
each printing its own lines:

  1. environment: the card, its power limit, versions, the device profile
  2. build: every GEMM configuration of phase 3, all nvcc runs at once;
     the built threads and shared bytes must equal matmul.py's models
  3. GEMM kernel vs plain version vs oracle, for an H100 twin of every
     config the JAX package's GEMM tests sweep, and bfloat16 builds (A
     k-major, a bfloat16 accumulator, 8 sub-dots of 1, 16 x 16 tiles), at
     their shapes and 2048^3
  4. the GEMM main path at M = N = K = 2048 float32: tune_kernel with the
     wall-clock evaluator, lookup (provenance "exact"), matmul(config=None)
  5. GEMM times at 2048^3: tuned kernel, heuristic config, plain version,
     torch.matmul as the library yardstick, and the FLOP bound
  6. build_new: every conv2d and flash configuration of phases 7-10 and
     13, the bfloat16 conv space at 4096^2 3x3 and both flash spaces at
     (4096, 4096, 128), all nvcc runs at once; built threads and shared
     bytes (and each conv build's register or warp tile) against the
     models; ptxas's registers and spills of each conv build, and HMMA in
     the SASS of each bfloat16 one
  7. conv sweep: every case of the JAX package's conv2d tests, plus even
     filters, at its shape and at 4096^2, against conv2d_plain and the
     oracle (tolerance 1e-4, the JAX tests'); then conv-bf16 (after
     phase 9): every case again with bfloat16 operands (the IN_BF16
     builds, on the tensor cores), against conv2d_plain
     (conv_bf16_agreement: 2^-7 |plain| + 2^-12 rms, at most 0.5 % of
     elements differing) and the float32 oracle of the same inputs
     (3e-2), then the bfloat16 search's winner at 4096^2 3x3 and the
     heuristic at 8192x4096 7x7 and 11x11 timed beside conv2d_plain,
     F.conv2d in bfloat16 and the bound
  8. flash sweep: every case of the JAX package's attention tests, plus
     Sq > Sk causal (rows that see no key must return the mean of v) and
     bf16 inputs, at its shape and at the 4096 twin (D = 128), against
     flash_plain and the oracle (2e-5 and 3e-2 as in the JAX tests; at 4096
     a float32 bound derived from summation order, flash_bound); then every
     float32 case again with bf16 operands (the tensor-core build), against
     flash_plain (which rounds P where the build does) and the float32
     oracle of the same inputs (3e-2)
     ragged (after the background processes are collected): every shape
     at which the ops once refused the heuristic's config (GEMM 100^3,
     36x52x20, 8^3, 24^3, 1000^3 and the prime 1009^3; flash at S = 16,
     48, 100, 200 and D = 40, 80; conv 50x200 3x3) and explicit blocks
     the JAX package takes (RAGGED_CONFIGS), in float32 and bfloat16,
     through its op on the card: one launch a call, the result against
     the float32 oracle and the plain version, its builds (one parallel
     batch) against the models and without spills; each config=None case
     timed through its op, its kernel alone and its library call
 9. conv main path: tune_kernel(CONV2D) at 4096^2 3x3 (annealing, the
     extended space, budget 24), lookup "exact", conv2d(config=None); then
     conv2d(config=None) at 8192x4096 with 7x7 and 11x11 (heuristic);
     conv-main-bf16: the same path in bfloat16 on the tensor cores
     (compact space, budget 16, prebuilt in build_new, every candidate
     held to the float32 oracle at 3e-2; lookup "exact" under the
     bfloat16 key, the float32 record still the float32 winner;
     conv2d(config=None) on bfloat16 tensors at the three shapes, one
     launch each, against the oracle and conv2d_plain; the winner timed)
 10. flash main path: tune_kernel(FLASH_ATTENTION) at (4096, 4096, 128)
     causal (budget 24), lookup "exact", flash_attention(config=None) on
     (2, 8, 4096, 128) float32: one launch for all 16 heads; flash-main-bf16:
     the same path in bfloat16 on the tensor cores (budget 24 over the
     15-point bfloat16 space, every candidate held to the oracle at 3e-2,
     lookup "exact" under the bfloat16 key, the float32 record at the same
     shape still the float32 winner, flash_attention(config=None) on
     bfloat16 heads in one launch against the float32 oracle, the winner
     timed beside flash_plain and SDPA in bfloat16); then
     times-bf16: every kernel's bfloat16 build beside its library call in
     bfloat16 and its bound at the card's bfloat16 rate (the GEMM at 2048^3
     and 4096^3 with the float32 search's winner and the heuristic config
     beside torch.matmul, flash on (2, 8, 4096, 128) causal with the
     bfloat16 and the float32 searches' winners beside SDPA; conv-bf16
     times the conv); main-bf16: the
     GEMM main path in bfloat16 on the tensor cores, tune_kernel at 2048^3
     (compact space, budget 16, every candidate held to the oracle at
     3e-2), lookup "exact", matmul(config=None) on bfloat16 tensors, the
     winner timed beside its plain version and torch.matmul; then
     wallclock-gap: each of the three search winners' sample in its search
     against its back-to-back time (limit WALLCLOCK_GAP);
     analyze: the static analyzer's lint over the registry at the card's
     runtime profile (no error), no config the three searches measured
     proven infeasible, two GEMM builds the proof rejects for shared memory
     refused by the card's launch, and the flash search again with
     analyze=True over its whole space, its winner held against SDPA;
     costmodel: every config the three searches measured priced by the
     cost model (Spearman rank correlation with the measured times), then
     a full cost-model GEMM search over the 288-point space at 2048^3 (no
     builds; a second one answers from the artifact store), its winner run
     through matmul() against torch.matmul and timed beside the wall-clock
     winner; predict: a learned predictor (pretrained on the analytical
     model, fine-tuned on the GEMM search's trials) in an annealing search
     at (4096, 4096, 1024) beside one without it, each winner run through
     lookup -> matmul(), and a lookup at (1024, 4096, 4096) the predictor
     answers ("predicted"), run and timed beside torch.matmul; then
     dtune: tune_kernel_distributed over the first 32 points of the
     288-point compact GEMM space at 2048^3, strided, wall-clock, process
     (spawn) driver: 1 worker with budget 32, then 4 workers with budget 8
     each (the same 32 configs), each run's libraries deleted first so
     both build cold; wall and nvcc seconds, libraries built (none twice),
     the two winners' back-to-back times (within 5 %); then islands mode,
     4 workers of budget 8 on the thread driver, no library built twice;
     online: a BackgroundTuner (wall-clock, annealing, budget 8) retunes a
     GEMM shape no phase tunes from its heuristic resolution while the
     main thread keeps calling matmul() with the ConfigSlot's snapshot,
     every result held to the oracle before and after the swap; then
     serve: granite-3-2b at full width (40 layers, bf16, random weights
     from a seeded torch.Generator on the card) through the port's serve
     path: float32 decode against forward over (2, 32) tokens (1e-4 of
     max|logit|, TF32 off), bf16 against float32 over 6 decode steps at
     4 slots (8e-2), the launcher (8 requests x 16 tokens, 4 slots, 256
     positions), an engine retuning flash on the card while it serves
     (the flash launch count, a tuned swap, the decode gemm's job failing
     on its empty space) and an offline engine on the same traffic: the
     same tokens, the step's ms from CUDA events at each step boundary,
     tokens/s, the share of the weight-read bound, and one step's device
     kernels and busy share from one torch.profiler trace; then
     serve-families: mamba2-130m and zamba2-7b at their published
     configs and deepseek-v3 at full width cut to 2 layers (one dense,
     one MoE) with no MTP block, random bf16 weights from a seeded
     generator on the card: the launcher's traffic through the launcher
     (mamba2, zamba2; the same tokens as an engine on the same weights)
     or the engine (deepseek), one round timed and one step traced as in
     serve, the engine's resolutions with provenance, then bf16 against
     float32 (8e-2; the SSM families SERVE_SSM_BF16_TOL) and float32
     decode against forward (1e-4; MoE at capacity factor 8) on the same
     weights, upcast leaf by leaf; then train: the training path
     (loss_fn -> make_train_step -> Trainer), which launches none of the
     kernels: granite-3-2b's loss and gradients at 2 layers in float32 on
     the card against the CPU; all 40 layers in bf16 trained 20 steps at
     8 x 256 tokens through Trainer (step ms from CUDA events, one traced
     step, the bound, an async full-depth checkpoint verified); remat,
     ce_chunk and microbatch variants on the first batch with their peak
     memory; a crash at step 5 restored from step 4 at 2 layers under
     deterministic algorithms (in a spawned process: deterministic cuBLAS
     caps its workspace, and with it torch.matmul's speed), equal to an
     uninterrupted run; the
     launcher (--full, 4 steps) and mamba2-130m (10 steps); then the
     distribution layer, each part in a spawned process of its own (one
     default process group each; dryrun and sharding-tune need no card,
     start with the script and are collected before the conv search):
     dist (an NCCL world of one rank,
     make_host_mesh() -> a 1x1 ("data", "model") mesh; granite-3-2b at
     full width and depth trained 4 steps at 8 x 256 through Trainer with
     and without the mesh, losses within 1e-3, step ms and peak; a
     2-layer checkpoint of the mesh run restored onto the mesh with
     shardings=, bit for bit; the elastic mesh and validate_batch),
     dryrun (analyze_cell in fake worlds of 256 and 512 ranks with meta
     shards: granite-3-2b train_4k, mamba2-130m decode_32k,
     granite-3-2b decode_32k with its KV cache split along time over
     "model", deepseek-v3-671b train_4k multi-pod at full width cut to 5
     layers, whose MoE must move all-to-all bytes; then a 1x1 world at
     8 x 256 whose op, byte and FLOP counts
     must equal the meshless meta step's, FLOPs no lower than
     train_bound_ms's count, its peak within 25 % of dist's) and
     sharding-tune (tune_cell over granite-3-2b train_4k, greedy,
     budget 4, the winner resolved by lookup with provenance "exact");
     then build_space: every sixteenth distinct float32 conv build of the
     extended space at 3x3 (24 of its 372), every eighth bfloat16 GEMM
     build of the compact space (18 of 144), every build of the bfloat16
     flash space at (4096, 4096, 128) (15) and every sixteenth bfloat16
     conv build of the extended space at 11x11 (23 of 364), 16 nvcc at a
     time, with ptxas's registers and spills (none may spill; after the
     searches, so their nvcc time stays their own); each GEMM build
     launched at 256^3 against gemm_plain, and one's SASS must hold the
     tensor cores' HMMA; each flash build launched on 2 x 512 x 512 heads
     against flash_plain,
     each bfloat16 conv build on 64 x 512 against conv2d_plain, and every
     flash and conv one's SASS must hold HMMA
 11. the CUDA kernels one F.scaled_dot_product_attention call launches,
     in float32 and in bfloat16 (the device activities of one
     torch.profiler trace each, taken right after phase 5; no device time
     fails): the flash yardsticks' routes
 12. conv and flash times (CUDA events, the versions taking turns): each
     kernel, its plain version, F.conv2d or F.scaled_dot_product_attention
     as the library yardstick, and the bound (the flash kernel skips the
     causal blocks above the diagonal; the bound counts the causal half);
     conv at 4096^2 3x3 (the search's best kernel config) and at 8192x4096
     7x7 and 11x11 (the heuristic config)
 13. conv-large: SUB_H in {1, 2, 4, 8} x BLOCK_H in {16, 32} at BLOCK_W 256
     on 8192x4096 11x11, each checked against the oracle and timed: how far
     the JAX heuristic (SUB_H 1, 16 x 256) is from the card's best there
 14. one JSON line listing every ported kernel

Each main path zeroes its kernels' launch counters just before it and
reads them just after (the dtune workers of the process driver count in
their own processes and report what they launched, and each of them must
have launched the GEMM; the islands and online paths run in this one).  The
searches' budgets (GEMM 16 in float32 and 16 in bfloat16, conv 24 in
float32 and 16 in bfloat16, flash 24 in float32 and 24 in bfloat16) are
cut from the declarations' defaults
for the time limit: a search is bound by nvcc, about 2.7-4 s per
configuration (both flash spaces are built in build_new with the rest,
all at once, so those searches load their libraries).  The dtune workers are
spawned, so this script imports without side effects: its work is under
__main__.

The line before the last is the card's name and power limit as nvidia-smi
gives them; the last is {"ok": true, "device": {...}}.  Any failure raises
and exits non-zero before that line.  The full record is also written to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import logging
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from scipy import stats  # noqa: E402

import torch.nn.functional as F  # noqa: E402

from repro_torch.analyze import (analyze_registry,  # noqa: E402
                                 proven_violations)
from repro_torch.configs import get_config as get_model_config  # noqa: E402
from repro_torch.core.profiles import resolve_profile  # noqa: E402
from repro_torch.core import (H100_SXM, ArtifactStore,  # noqa: E402
                              CostModelEvaluator, LearnedPredictor, Tuner,
                              TuningCache, WallClockEvaluator, default_cache,
                              device_profile, lookup_resolved, make_strategy,
                              split_key)
from repro_torch.dist.step import apply_kernel_configs  # noqa: E402
from repro_torch.dtune import shard_space  # noqa: E402
from repro_torch.kernels import attention as fa  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import conv2d as cv  # noqa: E402
from repro_torch.kernels import launch_counts  # noqa: E402
# the kernel's module (the package's ``conv2d`` is the op)
cv_kernel = importlib.import_module("repro_torch.kernels.conv2d.conv2d")
from repro_torch.kernels.matmul import (GEMM, LAUNCHES, gemm_plain,  # noqa: E402
                                        gemm_reference, heuristic_config,
                                        lookup_config, make_matmul, matmul,
                                        smem_footprint)
from repro_torch.data import DataConfig, to_device  # noqa: E402
from repro_torch.dist.step import make_train_step  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import (SHAPES, RunConfig,  # noqa: E402
                                abstract_model, count_params, decode_step,
                                forward,
                                init_cache, init_model, loss_fn, model_defs,
                                params_from_numpy, tree_leaves, tree_map,
                                tree_paths)
from repro_torch.optim import (OptimConfig, OptState,  # noqa: E402
                               abstract_state)
from repro_torch.optim import update_ as adamw_update_  # noqa: E402
from repro_torch.serve import (BackgroundTuner, ConfigSlot,  # noqa: E402
                               JobStatus, OnlineTuneConfig, ServeEngine,
                               submit_for_resolutions)
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402
from repro_torch.tune import tune_kernel, tune_kernel_distributed  # noqa: E402
mm_kernel = importlib.import_module("repro_torch.kernels.matmul.matmul")

SOURCE = "src/repro_torch/kernels/matmul/csrc/gemm.cu"
#: each ported kernel's CUDA source
SOURCES = {"gemm_scratch": SOURCE, "gemm_inplace": SOURCE,
           "conv2d": "src/repro_torch/kernels/conv2d/csrc/conv2d.cu",
           "flash_attention": "src/repro_torch/kernels/attention/csrc/flash.cu"}
#: the TPU kernel bodies the CUDA kernels replace (JAX package)
REPLACES = {"gemm_scratch": "src/repro/kernels/matmul/matmul.py:54",
            "gemm_inplace": "src/repro/kernels/matmul/matmul.py:84",
            "conv2d": "src/repro/kernels/conv2d/conv2d.py:75",
            "flash_attention": "src/repro/kernels/attention/flash.py:34"}

#: the configs and shapes tests/test_kernels_matmul.py sweeps (CONFIGS,
#: then its TRANS_A, rectangular and bf16 tests), plus a bfloat16
#: accumulator, which checks the rounding points
REFERENCE_CASES = [
    ("CONFIGS[0]", {"BLOCK_M": 128, "BLOCK_N": 128, "BLOCK_K": 128},
     (256, 256, 256), "float32"),
    ("CONFIGS[1]", {"BLOCK_M": 256, "BLOCK_N": 128, "BLOCK_K": 128,
                    "GRID_ORDER": "nm"}, (256, 256, 256), "float32"),
    ("CONFIGS[2]", {"BLOCK_M": 128, "BLOCK_N": 256, "BLOCK_K": 256,
                    "INNER_STEPS": 2}, (256, 256, 256), "float32"),
    ("CONFIGS[3]", {"BLOCK_M": 128, "BLOCK_N": 128, "BLOCK_K": 128,
                    "ACC_IN_OUTPUT": True}, (256, 256, 256), "float32"),
    ("CONFIGS[4]", {"BLOCK_M": 128, "BLOCK_N": 128, "BLOCK_K": 128,
                    "INNER_STEPS": 4}, (256, 256, 256), "float32"),
    ("trans_a", {"BLOCK_M": 128, "BLOCK_N": 128, "BLOCK_K": 128,
                 "TRANS_A": True}, (256, 128, 128), "float32"),
    ("rectangular", {"BLOCK_M": 128, "BLOCK_N": 128, "BLOCK_K": 256},
     (384, 256, 512), "float32"),
    ("bf16_inputs", {"BLOCK_M": 128, "BLOCK_N": 128, "BLOCK_K": 128},
     (256, 256, 256), "bfloat16"),
    ("acc_bfloat16", {"BLOCK_M": 128, "BLOCK_N": 128, "BLOCK_K": 128,
                      "INNER_STEPS": 2, "ACC_DTYPE": "bfloat16"},
     (256, 256, 256), "float32"),
    # the bfloat16 (tensor-core) build: A k-major, the rounding points,
    # sub-dots narrower than the mma (8 sub-dots of 1), one-warp blocks
    ("bf16_trans_a", {"BLOCK_M": 128, "BLOCK_N": 128, "BLOCK_K": 128,
                      "TRANS_A": True}, (256, 128, 128), "bfloat16"),
    ("bf16_acc_bfloat16", {"BLOCK_M": 128, "BLOCK_N": 128, "BLOCK_K": 128,
                           "INNER_STEPS": 2, "ACC_DTYPE": "bfloat16"},
     (256, 256, 256), "bfloat16"),
    ("bf16_k8_inner8", {"BLOCK_M": 64, "BLOCK_N": 64, "BLOCK_K": 8,
                        "INNER_STEPS": 8, "ACC_DTYPE": "bfloat16"},
     (128, 128, 128), "bfloat16"),
    ("bf16_16x16", {"BLOCK_M": 16, "BLOCK_N": 16, "BLOCK_K": 16},
     (64, 64, 64), "bfloat16"),
]

#: main-path tolerance at K = 2048 (float32 sums): two valid orders of
#: summation differ by up to ~6e-4 there, so the float32 default of 1e-5
#: would reject every config; the JAX package's tests use 2e-4 at K = 256
MAIN_TOL = 1e-3
TEST_TOL = 2e-4
BF16_TOL = 3e-2        # the JAX package's bf16 test tolerance


def h100_twin(cfg):
    """The config with BLOCK_K halved until one block's shared memory fits
    the H100 (the JAX package's tiles were sized for TPU memory)."""
    cfg = dict(cfg)
    while smem_footprint(cfg) > H100_SXM.smem_per_block_optin:
        cfg["BLOCK_K"] //= 2
        cfg["INNER_STEPS"] = min(cfg.get("INNER_STEPS", 1), cfg["BLOCK_K"])
    return cfg


def tolerance(cfg, dtype, shape, oracle):
    """(atol, rtol) for the kernel against the oracle, and why."""
    if cfg.get("ACC_DTYPE") == "bfloat16":
        # each of the K/sub sub-steps rounds the sub-dot and the running sum
        # to bfloat16 (half an ulp each, 2^-9 relative): at most
        # K/sub * 2^-8 * max|C| in all
        sub = cfg["BLOCK_K"] // cfg.get("INNER_STEPS", 1)
        bound = shape[2] / sub * 2.0 ** -8 * oracle.float().abs().max().item()
        return bound, BF16_TOL, "bf16 accumulation bound"
    if dtype == "bfloat16":
        return BF16_TOL, BF16_TOL, "bf16 test tolerance"
    if shape[2] > 512:
        return MAIN_TOL, MAIN_TOL, "float32 at K=2048"
    return TEST_TOL, TEST_TOL, "JAX GEMM tests"


def plain_tolerance(cfg, dtype, plain, atol, rtol, why):
    """(atol, rtol, bit for bit) for the kernel against its plain version,
    which rounds where the kernel rounds.  A bfloat16 accumulator over
    bfloat16 operands (the tensor cores) sums each sub-dot in another order
    than the plain version's float32 product, so one rounding of the
    running sum may fall the other way: two ulps of the sums' size, 2 *
    2^-8 * max|C|, beside BF16_TOL.  A sub-dot one deep is one product,
    exact in float32, so there the two agree bit for bit.  Any other
    bfloat16 rounding is held to BF16_TOL, float32 to the oracle's."""
    if cfg.get("ACC_DTYPE") == "bfloat16" and dtype == "bfloat16":
        if cfg["BLOCK_K"] // cfg.get("INNER_STEPS", 1) == 1:
            return 0.0, 0.0, True
        ulps = 2 * 2.0 ** -8 * plain.float().abs().max().item()
        return ulps, BF16_TOL, False
    if "bf16" in why:
        return BF16_TOL, BF16_TOL, False
    return atol, rtol, False


def inputs(shape, dtype, trans_a, device, seed=0):
    M, N, K = shape
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.normal(size=(K, M) if trans_a else (M, K))
                         .astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32))
    dt = getattr(torch, dtype)
    return a.to(device, dt), b.to(device, dt)


def max_err(x, y):
    return (x.float() - y.float()).abs().max().item()


def tol_share(x, y, atol, rtol):
    """Largest |x - y| / (atol + rtol |y|): the share of the tolerance used."""
    x, y = x.double(), y.double()
    return ((x - y).abs() / (atol + rtol * y.abs())).max().item()


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def time_ms(fn, device, iters=50):
    """Mean ms of ``iters`` back-to-back calls (the caller warms up)."""
    sync(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_in_turns(fns, device, rounds=5, iters=50, warmup=3):
    """Per-name lists of ``rounds`` timed runs, the names taking turns
    (in reversed order every other round) so drift hits all alike."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    runs = {name: [] for name in fns}
    names = list(fns)
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            runs[name].append(time_ms(fns[name], device, iters))
    return runs


def ptxas_info(fn):
    """What ptxas reported for the kernel's build (registers, spills)."""
    name = fn.build_name
    if fn.address is None:
        return []
    return ptxas_lines(build.log_path(name, fn.address))


def ptxas_lines(log):
    with open(log) as f:
        return [" ".join(line.split()) for line in f
                if "registers" in line or "spill" in line]


def spill_bytes(lines):
    """Bytes of spill stores ptxas reported in ``lines``."""
    return sum(int(m) for line in lines
               for m in re.findall(r"(\d+) bytes spill stores", line))


def phase_environment(device):
    if device.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        prof = device_profile()
    else:
        smi, prof = "no card (rehearsal)", H100_SXM
    print(f"[env] card: {smi}")
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    print(f"[env] profile {prof.name}: {prof.sm_count} SMs, "
          f"{prof.smem_per_block_optin} B shared memory per block, "
          f"{prof.regs_per_sm} registers per SM, L2 {prof.l2_bytes} B, "
          f"HBM {prof.hbm_bytes} B; datasheet rates: "
          f"{prof.peak_f32_flops:.3g} f32 FLOP/s, {prof.hbm_bw:.3g} B/s")
    return smi, prof


def phase_build(cases, main_shape, device):
    """Build every (config, dtype) of the sweep and the heuristic config,
    one nvcc per build, all started together."""
    fns = {}
    for name, cfg, shape, dtype in cases:
        for s in (shape, main_shape):
            fns[(name, s)] = make_matmul(*s, cfg,
                                         out_dtype=getattr(torch, dtype))
    heur = make_matmul(*main_shape, heuristic_config(*main_shape))
    t0 = time.perf_counter()
    if device.type == "cuda":
        todo = list(fns.values()) + [heur]
        with ThreadPoolExecutor(len(todo)) as pool:
            addresses = set(pool.map(lambda f: f.compile(), todo))
        print(f"[build] {len(addresses)} libraries for {len(todo)} "
              f"kernel objects in {time.perf_counter() - t0:.2f} s")
        # the search prunes by these models: they must be what was built
        for f in todo:
            want = (mm_kernel.block_threads(f.config, f.dtype.itemsize),
                    smem_footprint(f.config, f.dtype.itemsize))
            if f.geometry() != want:
                raise AssertionError(f"GEMM {f.config}: built "
                                     f"{f.geometry()}, modelled {want}")
    return fns, heur


def phase_sweep(cases, fns, main_shape, device):
    rows = []
    for name, cfg, shape, dtype in cases:
        for s in (shape, main_shape):
            fn = fns[(name, s)]
            trans = bool(cfg.get("TRANS_A"))
            a, b = inputs(s, dtype, trans, device)
            out = fn(a, b)
            sync(device)
            plain = gemm_plain(a, b, fn.config)
            oracle = gemm_reference(a, b, trans_a=trans)
            atol, rtol, why = tolerance(cfg, dtype, s, oracle)
            p_atol, p_rtol, bitwise = plain_tolerance(fn.config, dtype,
                                                      plain, atol, rtol, why)
            equal = bool(torch.equal(out, plain))
            row = {"case": name, "config": cfg, "shape": list(s),
                   "dtype": dtype, "variant": fn.variant,
                   "finite": bool(torch.isfinite(out.float()).all()),
                   "err_plain": max_err(out, plain),
                   "err_oracle": max_err(out, oracle),
                   "bitwise_plain": equal,
                   "bitwise_oracle": bool(torch.equal(out, oracle)),
                   "share_plain": ((0.0 if equal else float("inf"))
                                   if bitwise else
                                   tol_share(out, plain, p_atol, p_rtol)),
                   "share_oracle": tol_share(out, oracle, atol, rtol),
                   "tol_plain": "bit for bit" if bitwise else [p_atol,
                                                               p_rtol],
                   "tol_oracle": [atol, rtol], "tol_why": why}
            rows.append(row)
            print("[sweep] " + json.dumps(row))
            if not (row["finite"] and row["share_plain"] <= 1.0
                    and row["share_oracle"] <= 1.0):
                raise AssertionError(f"GEMM {name} at {s} disagrees: {row}")
    return rows


def phase_main_path(main_shape, device, budget):
    M, N, K = main_shape
    shape = {"M": M, "N": N, "K": K}
    profile = device_profile(device)
    cache = default_cache()            # REPRO_TUNE_CACHE: a temporary file
    evaluator = WallClockEvaluator(atol=MAIN_TOL, rtol=MAIN_TOL,
                                   device=device)
    # the heuristic config is a warm-start seed already; seeding its
    # in-place twin makes both TPU kernel bodies' stand-ins run on the path
    inplace_seed = dict(heuristic_config(M, N, K), ACC_IN_OUTPUT=True)
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    t0 = time.perf_counter()
    outcome = tune_kernel(GEMM, shape, strategy="annealing", budget=budget,
                          seed=0, evaluator=evaluator, profile=profile,
                          cache=cache, seeds=[inplace_seed])
    tune_s = time.perf_counter() - t0
    best = outcome.result.best
    if best is None:
        raise AssertionError("the search found no verified config")
    # a config that fails verification is a failed trial, so every timed
    # one — the winner among them — was verified against the oracle
    if not all(m.verified for m in outcome.measurements.values() if m.ok):
        raise AssertionError("a timed config was not verified")
    stats = outcome.engine_stats or {}
    res = lookup_resolved(GEMM, shape, profile=profile, cache=cache)
    if res.provenance != "exact" or res.config != best.config:
        raise AssertionError(f"lookup gave {res}")
    a, b = inputs(main_shape, "float32", False, device, seed=1)
    before = dict(LAUNCHES)
    out = matmul(a, b)                          # config=None: the registry
    sync(device)
    launches = dict(LAUNCHES)
    oracle = gemm_reference(a, b)
    share = tol_share(out, oracle, MAIN_TOL, MAIN_TOL)
    record = {
        "winner": best.config, "winner_ms": best.time * 1e3,
        "evaluations": outcome.result.evaluations,
        "failures_by_type": outcome.failure_summary.get("by_type", {}),
        "compile_s": stats.get("compile_total_s"),
        "compile_calls": stats.get("compile_calls"),
        "tune_wall_s": tune_s, "lookup": res.provenance,
        "matmul_launches": {k: launches[k] - before[k] for k in launches},
        "matmul_err_oracle": max_err(out, oracle),
        "matmul_share_oracle": share, "launches": launches}
    print("[main] " + json.dumps(record))
    record["trials"] = [[t.config, t.time * 1e3]
                        for t in outcome.result.trials]
    if device.type == "cuda":
        if sum(record["matmul_launches"].values()) != 1:
            raise AssertionError("matmul() did not launch the GEMM kernel")
        missing = [k for k, n in launches.items() if n == 0]
        if missing:
            raise AssertionError(f"kernels not launched on the path: "
                                 f"{missing}")
    if share > 1.0:
        raise AssertionError(f"matmul() disagrees with the oracle: {record}")
    return record


def phase_times(main_shape, winner, heur, device):
    M, N, K = main_shape
    a, b = inputs(main_shape, "float32", False, device, seed=2)
    flop = 2.0 * M * N * K
    nbytes = 4.0 * (M * K + K * N + M * N)
    bound_ms = max(flop / H100_SXM.peak_f32_flops,
                   nbytes / H100_SXM.hbm_bw) * 1e3
    bound_by = ("operations" if flop / H100_SXM.peak_f32_flops
                >= nbytes / H100_SXM.hbm_bw else "bytes")
    gemms = {v: make_matmul(M, N, K, dict(winner, ACC_IN_OUTPUT=inplace))
             for v, inplace in (("gemm_scratch", False),
                                ("gemm_inplace", True))}
    fns = {v: (lambda fn=fn: fn(a, b)) for v, fn in gemms.items()}
    fns["heuristic"] = lambda: heur(a, b)
    fns["library"] = lambda: torch.matmul(a, b)
    runs = time_in_turns(fns, device)
    kernels = {}
    for variant, fn in gemms.items():
        plain = time_in_turns({"plain": lambda: gemm_plain(a, b, fn.config)},
                              device, rounds=3, iters=5)["plain"]
        kernels[variant] = {
            "config": fn.config, "ptxas": ptxas_info(fn),
            "ms": float(np.median(runs[variant])), "ms_runs": runs[variant],
            "plain_ms": float(np.median(plain)), "plain_ms_runs": plain,
            "max_abs_err": max_err(fn(a, b), gemm_plain(a, b, fn.config))}
    record = {"bound_ms": bound_ms, "bound_by": bound_by,
              "library_ms": float(np.median(runs["library"])),
              "library_ms_runs": runs["library"],
              "heuristic_ms": float(np.median(runs["heuristic"])),
              "heuristic_ms_runs": runs["heuristic"],
              "heuristic": heur.config, "kernels": kernels,
              "tuned_share_of_bound": bound_ms / kernels["gemm_scratch"]["ms"]}
    print("[times] " + json.dumps(record))
    return record


def phase_main_bf16(main_shape, device, budget):
    """The GEMM main path in bfloat16: tune_kernel over the compact space
    with the wall-clock evaluator (every candidate held against the oracle
    at BF16_TOL), lookup (provenance "exact"), matmul(config=None) on
    bfloat16 tensors launching the winner; then the winner timed beside
    its plain version, torch.matmul in bfloat16 and its bound."""
    M, N, K = main_shape
    shape = {"M": M, "N": N, "K": K, "dtype": "bfloat16"}
    profile = device_profile(device)
    cache = default_cache()
    evaluator = WallClockEvaluator(atol=BF16_TOL, rtol=BF16_TOL,
                                   device=device)
    zero_counts()
    t0 = time.perf_counter()
    outcome = tune_kernel(GEMM, shape, strategy="annealing", budget=budget,
                          seed=0, evaluator=evaluator, profile=profile,
                          cache=cache, extended_space=False)
    tune_s = time.perf_counter() - t0
    _check_tune(outcome, "bf16 GEMM")
    best = outcome.result.best
    res = lookup_resolved(GEMM, shape, profile=profile, cache=cache)
    if res.provenance != "exact" or res.config != best.config:
        raise AssertionError(f"bf16 GEMM lookup gave {res}")
    a, b = inputs(main_shape, "bfloat16", False, device, seed=1)
    before = LAUNCHES["gemm_scratch"]
    out = matmul(a, b)                          # config=None: the registry
    sync(device)
    op_launches = LAUNCHES["gemm_scratch"] - before
    launches = read_counts()
    oracle = gemm_reference(a, b)
    stats = outcome.engine_stats or {}
    record = {
        "winner": best.config, "winner_ms": best.time * 1e3,
        "evaluations": outcome.result.evaluations,
        "failures_by_type": outcome.failure_summary.get("by_type", {}),
        "compile_s": stats.get("compile_total_s"),
        "compile_calls": stats.get("compile_calls"),
        "tune_wall_s": tune_s, "lookup": res.provenance,
        "op_launches": op_launches, "launches": launches,
        "op_dtype": str(out.dtype), "op_err_oracle": max_err(out, oracle),
        "op_share_oracle": tol_share(out, oracle, BF16_TOL, BF16_TOL)}
    winner = make_matmul(M, N, K, best.config, out_dtype=torch.bfloat16)
    a, b = inputs(main_shape, "bfloat16", False, device, seed=2)
    runs = time_in_turns({"kernel": lambda: winner(a, b),
                          "library": lambda: torch.matmul(a, b)}, device)
    plain = time_in_turns({"plain": lambda: gemm_plain(a, b, best.config)},
                          device, rounds=3, iters=5)["plain"]
    bound_ms, bound_by = gemm_bf16_bound(M, N, K)
    record.update(
        ms=float(np.median(runs["kernel"])), ms_runs=runs["kernel"],
        library_ms=float(np.median(runs["library"])),
        library_ms_runs=runs["library"], plain_ms=float(np.median(plain)),
        plain_ms_runs=plain, bound_ms=bound_ms, bound_by=bound_by,
        max_abs_err=max_err(winner(a, b), gemm_plain(a, b, best.config)),
        ptxas=ptxas_info(winner))
    record["share_of_bound"] = bound_ms / record["ms"]
    record["over_library"] = record["ms"] / record["library_ms"]
    print("[main-bf16] " + json.dumps(
        {k: v for k, v in record.items() if not k.endswith("_runs")}))
    record["trials"] = _trials(outcome)
    if device.type == "cuda":
        if op_launches != 1:
            raise AssertionError("matmul() did not launch the bf16 GEMM")
        _check_launched(launches, ["gemm_scratch"], "[main-bf16]")
    if out.dtype != torch.bfloat16 or record["op_share_oracle"] > 1.0:
        raise AssertionError(f"bf16 matmul() disagrees with the oracle: "
                             f"{record}")
    return record


def gemm_bf16_bound(M, N, K):
    """(ms, "bytes" or "operations"): the least time of a bfloat16 GEMM:
    its 2MNK operations at the card's bfloat16 tensor-core rate, or its
    bytes (A and B read once, C written once, 2 bytes each) over the HBM
    rate, the larger."""
    return _bound(2.0 * M * N * K, 2.0 * (M * K + K * N + M * N),
                  peak=H100_SXM.peak_bf16_tensor_flops)


def phase_times_bf16(gemm_cfgs, flash_cfgs, flash_shape, shapes, device,
                     conv=()):
    """The bfloat16 builds against their library calls in bfloat16, the
    versions in turns (the median of 5 runs of back-to-back launches),
    each beside its bound at the card's bfloat16 rate: the GEMM at each
    of ``shapes`` with each of ``gemm_cfgs`` (label -> config) beside
    torch.matmul (a config given twice is timed once, under its first
    label), flash on ``flash_shape`` = (lead, S, D) causal with each
    of ``flash_cfgs`` (label -> config, the same rule) beside SDPA, and
    the conv at each ``conv`` (label, config, (H, W, Fh, Fw)) beside
    F.conv2d and conv2d_plain (:func:`_time_conv_bf16`).  Every result is
    held against the library's at BF16_TOL."""
    record = {"gemm": [], "conv": [
        _time_conv_bf16(label, cfg, size, device, tag="[times-bf16] conv")
        for label, cfg, size in conv]}
    for shape in shapes:
        M, N, K = shape
        a, b = inputs(shape, "bfloat16", False, device, seed=2)
        gemms = {}
        for label, cfg in gemm_cfgs.items():
            fn = make_matmul(M, N, K, dict(cfg, ACC_IN_OUTPUT=False),
                             out_dtype=torch.bfloat16)
            if all(fn.config != g.config for g in gemms.values()):
                gemms[label] = fn
        fns = {label: (lambda fn=fn: fn(a, b)) for label, fn in gemms.items()}
        fns["library"] = lambda: torch.matmul(a, b)
        runs = time_in_turns(fns, device)
        lib = torch.matmul(a, b)
        bound_ms, bound_by = gemm_bf16_bound(M, N, K)
        rec = {"shape": list(shape), "bound_ms": bound_ms,
               "bound_by": bound_by,
               "library_ms": float(np.median(runs["library"])),
               "library_ms_runs": runs["library"], "kernels": {}}
        for label, fn in gemms.items():
            out = fn(a, b)
            ms = float(np.median(runs[label]))
            rec["kernels"][label] = {
                "config": fn.config, "ms": ms, "ms_runs": runs[label],
                "share_of_bound": bound_ms / ms,
                "over_library": ms / rec["library_ms"],
                "err_library": max_err(out, lib),
                "share_library": tol_share(out, lib, BF16_TOL, BF16_TOL)}
        print("[times-bf16] gemm " + json.dumps(rec))
        record["gemm"].append(rec)
        bad = {k: v for k, v in rec["kernels"].items()
               if not v["share_library"] <= 1.0}
        if bad:
            raise AssertionError(f"bf16 GEMM at {shape} against "
                                 f"torch.matmul: {bad}")
    lead, S, D = flash_shape
    flashes = {}
    for label, cfg in flash_cfgs.items():
        fn = fa.make_flash_attention(S, S, D, cfg, causal=True,
                                     dtype=torch.bfloat16)
        if all(fn.config != f.config for f in flashes.values()):
            flashes[label] = fn
    q, k, v = flash_inputs(lead, S, S, D, "bfloat16", device, seed=2)
    q4, k4, v4 = (x.reshape(-1, 1, S, D) for x in (q, k, v))

    def library():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)

    fns = {label: (lambda fn=fn: fn(q, k, v))
           for label, fn in flashes.items()}
    runs = time_in_turns(dict(fns, library=library), device, iters=10)
    lib = library().reshape(q.shape)
    heads = int(np.prod(lead)) if lead else 1
    bound_ms, bound_by = _bound(
        heads * fa.attention_flops(S, S, D, causal=True),
        2.0 * heads * 4 * S * D, peak=H100_SXM.peak_bf16_tensor_flops)
    rec = {"shape": list(lead) + [S, S, D], "bound_ms": bound_ms,
           "bound_by": bound_by,
           "library_ms": float(np.median(runs["library"])),
           "library_ms_runs": runs["library"], "kernels": {}}
    for label, fn in flashes.items():
        out = fn(q, k, v)
        ms = float(np.median(runs[label]))
        rec["kernels"][label] = {
            "config": fn.config, "ms": ms, "ms_runs": runs[label],
            "share_of_bound": bound_ms / ms,
            "over_library": ms / rec["library_ms"],
            "err_library": max_err(out, lib),
            "share_library": tol_share(out, lib, BF16_TOL, BF16_TOL)}
    print("[times-bf16] flash " + json.dumps(rec))
    record["flash"] = rec
    bad = {k: v for k, v in rec["kernels"].items()
           if not v["share_library"] <= 1.0}
    if bad:
        raise AssertionError(f"bf16 flash against SDPA: {bad}")
    return record


# ---------------------------------------------------------------------------
# conv2d (paper section V) and flash attention: sweeps, main paths, times
# ---------------------------------------------------------------------------

#: the JAX package's conv2d test tolerance, used at every size: the kernel
#: adds the taps in the oracle's order, so only the rounding of single
#: products and sums separates them
CONV_TOL = 1e-4
#: the JAX package's attention test tolerances at the test shapes
FLASH_TOL = 2e-5
#: a float32 unit roundoff
U32 = 2.0 ** -24
#: a bfloat16 flash build against flash_plain, which rounds P and the output
#: where the build does (flash_bf16_agreement): two bfloat16 ulps of the
#: element at most (2^-6 relative), plus 2^-7 of the rms of the element's
#: row, and at most 1 % of the elements may differ at all
FLASH_BF16_RTOL = 2.0 ** -6
FLASH_BF16_ROW_ATOL = 2.0 ** -7
FLASH_BF16_DIFFER = 0.01

#: a bfloat16 conv build against conv2d_plain, which rounds the same float32
#: sum once to bfloat16 (conv_bf16_agreement): one ulp of the element
#: (2^-7 relative), plus 2^-12 of the output's rms, and at most 0.5 % of the
#: elements may differ at all
CONV_BF16_RTOL = 2.0 ** -7
CONV_BF16_ATOL = 2.0 ** -12
CONV_BF16_DIFFER = 0.005

#: the configs tests/test_kernels_conv2d.py sweeps
CONV_CONFIGS = [
    {"BLOCK_H": 16, "BLOCK_W": 128, "SUB_H": 1, "UNROLL": True,
     "HALO_MODE": "materialize"},
    {"BLOCK_H": 32, "BLOCK_W": 128, "SUB_H": 2, "UNROLL": False,
     "HALO_MODE": "materialize"},
    {"BLOCK_H": 8, "BLOCK_W": 256, "SUB_H": 4, "UNROLL": True,
     "HALO_MODE": "materialize"},
    {"BLOCK_H": 16, "BLOCK_W": 128, "SUB_H": 1, "UNROLL": True,
     "HALO_MODE": "xla"},
]


def conv_cases():
    """(name, config, (H, W), (Fh, Fw), weight): every case of
    tests/test_kernels_conv2d.py, plus even filters (the asymmetric pad)."""
    cases = [(f"CONFIGS[{i}] {fh}x{fw}", cfg, (64, 256), (fh, fw), 1.0)
             for i, cfg in enumerate(CONV_CONFIGS)
             for fh, fw in ((3, 3), (7, 7), (11, 11))]
    c0 = CONV_CONFIGS[0]
    return cases + [("non_divisible", c0, (50, 200), (7, 7), 1.0),
                    ("weight", c0, (32, 128), (3, 3), 2.5),
                    ("even 4x4", c0, (64, 256), (4, 4), 1.0),
                    ("even 2x5", c0, (64, 256), (2, 5), 1.0)]


def flash_cases():
    """(name, config, lead dims, Sq, Sk, D, causal, dtype): every case of
    tests/test_kernels_attention.py (its block sweep at four points), plus
    Sq > Sk causal (rows with every key masked) and bf16 inputs; then
    every float32 case again with bf16 operands (the tensor-core build)."""
    cases = [(f"CONFIGS[{i}] causal={c}", cfg, (), 256, 256, 64, c,
              "float32")
             for i, cfg in enumerate([{"BLOCK_Q": 128, "BLOCK_K": 128},
                                      {"BLOCK_Q": 64, "BLOCK_K": 256}])
             for c in (True, False)]
    cases += [
        ("prefix", {"BLOCK_Q": 64, "BLOCK_K": 128}, (), 128, 512, 64, True,
         "float32"),
        ("batched", {"BLOCK_Q": 64, "BLOCK_K": 64}, (2, 4), 128, 128, 64,
         True, "float32"),
        ("masked_rows", {"BLOCK_Q": 64, "BLOCK_K": 64}, (), 512, 128, 64,
         True, "float32"),
        ("bf16 causal", {"BLOCK_Q": 64, "BLOCK_K": 128}, (), 256, 256, 64,
         True, "bfloat16"),
        ("bf16 full", {"BLOCK_Q": 64, "BLOCK_K": 128}, (), 256, 256, 64,
         False, "bfloat16")]
    cases += [(f"sweep {bq}x{bk} D{d}", {"BLOCK_Q": bq, "BLOCK_K": bk}, (),
               256, 256, d, True, "float32")
              for bq, bk, d in ((64, 64, 64), (128, 256, 64),
                                (64, 128, 128), (128, 64, 128))]
    return cases + [(f"bf16 {name}", *rest[:-1], "bfloat16")
                    for name, *rest in cases if rest[-1] == "float32"]


def flash_twin(cfg, D, elt_bytes=4):
    """The config with BLOCK_K halved until one block's shared memory (of
    the build for ``elt_bytes``-wide inputs) fits the H100 at head width D
    (the JAX blocks were sized for TPU memory)."""
    cfg = dict(cfg)
    while (fa.smem_footprint(cfg, D, elt_bytes)
           > H100_SXM.smem_per_block_optin):
        cfg["BLOCK_K"] //= 2
    return cfg


def flash_sizes(case, big_s):
    """The case's own size and its twin at the main path's size: the longer
    of Sq and Sk at ``big_s``, the ratio kept, D = 128."""
    _, cfg, lead, sq, sk, d, causal, dtype = case
    scale = big_s // max(sq, sk)
    return [(lead, sq, sk, d), (lead, sq * scale, sk * scale, 128)]


def conv_inputs(H, W, Fh, Fw, device, seed=0):
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.normal(size=(H, W)).astype(np.float32))
    flt = torch.from_numpy(rng.normal(size=(Fh, Fw)).astype(np.float32))
    return img.to(device), flt.to(device)


def flash_inputs(lead, sq, sk, d, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    def mk(s):
        x = torch.from_numpy((rng.normal(size=lead + s) * 0.5)
                             .astype(np.float32))
        return x.to(device, getattr(torch, dtype))
    return mk((sq, d)), mk((sk, d)), mk((sk, d))


def flash_bound(q, k, v):
    """A float32 error bound from summation order, from these inputs.

    Each score is a length-D dot product: two orders of summation differ by
    at most D·u·Σ|q_i k_i|·scale <= D·u·max|q|·max|k|·scale (u = 2^-24),
    which moves a softmax weight by that factor, twice (the weight and
    the normaliser).  The output sums Sk weighted rows of v, weights
    summing to 1: at most Sk·u·max|v| apart.  Hence
    (Sk·u + 2·D·u·max|q|·max|k|·scale) · max|v|.
    """
    sk, d = k.shape[-2:]
    qn = q.float().norm(dim=-1).max().item()
    kn = k.float().norm(dim=-1).max().item()
    ds = d * U32 * qn * kn * d ** -0.5
    return (sk * U32 + 2 * ds) * v.float().abs().max().item()


def flash_bf16_agreement(out, plain):
    """How far a bfloat16 flash build's output lies from flash_plain's.

    The two round P and the output in the same places and differ before
    that only by float32 summation order and exp2 against exp, so an
    element may round the other way: one ulp, at most 2^-7 of it (rtol
    FLASH_BF16_RTOL is two).  An element whose size falls far below its
    row's (outputs of near-uniform weights cancel) is held to 2^-7 of the
    row's rms instead: a row that lost one key of 4096 moves by about
    1/64 of its rms.  Rounding flips are rare, so the share of elements
    that differ at all reads whether P was rounded where flash_plain
    rounds it: left in float32 it moves 10-45 % of them.  Returns (share
    of the bound used, share of elements that differ)."""
    x, y = out.double(), plain.double()
    rms = y.pow(2).mean(dim=-1, keepdim=True).sqrt()
    share = ((x - y).abs() / (FLASH_BF16_ROW_ATOL * rms
                              + FLASH_BF16_RTOL * y.abs())).max().item()
    return share, (x != y).double().mean().item()


def conv_bf16_agreement(out, plain):
    """How far a bfloat16 conv build's output lies from conv2d_plain's.

    Both round one float32 sum of exact products once to bfloat16, after
    ``weight``; only the order of the float32 sum differs, which moves the
    sum by far less than a bfloat16 ulp, so an element may round the other
    way: by one ulp, at most 2^-7 of its size (CONV_BF16_RTOL).  An element
    that cancels to near zero is held to 2^-12 of the output's rms instead
    (CONV_BF16_ATOL).  Such flips are rare: the share of elements that
    differ at all (CONV_BF16_DIFFER) reads whether the build sums what
    conv2d_plain sums.  Returns (share of the bound used, share of
    elements that differ)."""
    x, y = out.double(), plain.double()
    rms = y.pow(2).mean().sqrt()
    share = ((x - y).abs() / (CONV_BF16_ATOL * rms
                              + CONV_BF16_RTOL * y.abs())).max().item()
    return share, (x != y).double().mean().item()


def flash_tolerance(dtype, sq, q, k, v):
    """(atol, rtol, why) for the kernel against the oracle."""
    if dtype == "bfloat16":
        return BF16_TOL, BF16_TOL, "bf16 test tolerance"
    if max(sq, k.shape[-2]) <= 512:
        return FLASH_TOL, FLASH_TOL, "JAX attention tests"
    return flash_bound(q, k, v), 0.0, "float32 summation-order bound"


def phase_build_new(objs, device):
    """Build every conv2d and flash configuration the sweeps and the main
    paths' first calls use, one nvcc per build, all started together.
    The built threads, shared bytes and tiles must equal the models; every
    conv build's ptxas registers are printed, and each bfloat16 conv
    build must spill nothing and hold the tensor cores' HMMA."""
    todo = [f for f in objs if getattr(f, "route", "cuda") == "cuda"]
    t0 = time.perf_counter()
    record = {"conv_bf16": []}
    if device.type == "cuda":
        with ThreadPoolExecutor(len(todo)) as pool:
            addresses = set(pool.map(lambda f: f.compile(), todo))
        print(f"[build-new] {len(addresses)} libraries for {len(todo)} "
              f"kernel objects in {time.perf_counter() - t0:.2f} s")
        # the searches prune by these models: they must be what was built
        printed, bf16 = set(), {}
        for f in todo:
            if isinstance(f, cv.Conv2d):
                elt = f.dtype.itemsize
                want = (cv.block_threads(f.config, elt),
                        cv.smem_footprint(f.config, f.Fh, f.Fw, elt),
                        cv.micro_tile(f.config, f.Fh, f.Fw, elt))
                if f.address not in printed:
                    printed.add(f.address)
                    print(f"[build-new] conv2d {f.dtype} {f.Fh}x{f.Fw} "
                          f"{json.dumps(f.config)} tile {want[2]}: "
                          + "; ".join(ptxas_info(f)))
                    if f.dtype == torch.bfloat16:
                        bf16[f.address] = f
            else:
                want = (fa.block_threads(f.config, f.D, f.dtype.itemsize),
                        fa.smem_footprint(f.config, f.D, f.dtype.itemsize))
            if f.geometry() != want:
                raise AssertionError(f"{f.config}: built {f.geometry()}, "
                                     f"modelled {want}")
        with ThreadPoolExecutor(16) as pool:
            mnemonics = list(pool.map(lambda f: _sass_mnemonics(
                build.library_path(f.build_name,
                                   f.address.split(":", 1)[1])),
                bf16.values()))
        for f, sass in zip(bf16.values(), mnemonics):
            lines = ptxas_info(f)
            record["conv_bf16"].append({
                "config": f.config, "filter": [f.Fh, f.Fw],
                "registers": _registers(lines), "spill": spill_bytes(lines),
                **{m: sass.get(m, 0) for m in ("HMMA", "LDSM", "LDGSTS")}})
        bad = [r for r in record["conv_bf16"] if r["spill"] or not r["HMMA"]]
        print(f"[build-new] conv2d bf16: {len(bf16)} builds, registers "
              f"{sorted({r['registers'] for r in record['conv_bf16']})}, "
              f"spilling or without HMMA: {bad}")
        if bad:
            raise AssertionError(f"bf16 conv builds spill or hold no HMMA: "
                                 f"{bad}")
    record["seconds"] = time.perf_counter() - t0
    return record


def _registers(lines):
    """The most registers ptxas gave one kernel of a build."""
    return max(int(m) for line in lines
               for m in re.findall(r"Used (\d+) registers", line))


def phase_build_space(device, workers=16, stride=16, gemm_stride=8):
    """Build every ``stride``-th distinct float32 conv2d library of the
    extended space at 3x3, in enumeration order, and read ptxas's
    registers and spills: the register tile is capped so that none spills.
    Then every ``gemm_stride``-th bfloat16 GEMM build of the compact space
    (:func:`_build_space_gemm_bf16`), the bfloat16 flash space and every
    sixteenth bfloat16 conv build of the extended space at 11x11
    (:func:`_build_space_conv_bf16`).  The strides keep the script in its
    time limit: every one of the 372 float32 conv builds was built
    spill-free before, and that build's SASS is unchanged since."""
    shape = {"H": 4096, "W": 4096, "Fh": 3, "Fw": 3}
    distinct = {}
    for c in cv.CONV2D.make_space(shape, extended=True).enumerate():
        if c["HALO_MODE"] == "materialize":
            fn = cv.make_conv2d(4096, 4096, 3, 3, c)
            distinct.setdefault(fn.defines(), fn)
    builds = dict(list(distinct.items())[::stride])
    record = {"distinct": len(distinct), "stride": stride,
              "builds": len(builds)}
    if device.type == "cuda":
        t0 = time.perf_counter()
        with ThreadPoolExecutor(workers) as pool:
            logs = list(pool.map(
                lambda d: build.log_path(cv_kernel.BUILD_NAME, build.build(
                    cv_kernel.SOURCE, dict(d), cv_kernel.BUILD_NAME)[1]),
                builds))
        registers, spills = {}, []
        for log, fn in zip(logs, builds.values()):
            lines = ptxas_lines(log)
            regs = _registers(lines)
            registers[regs] = registers.get(regs, 0) + 1
            if spill_bytes(lines):
                spills.append({"config": fn.config, "lines": lines})
        record.update(seconds=time.perf_counter() - t0,
                      registers=dict(sorted(registers.items())),
                      spilling=spills)
    print("[build-space] " + json.dumps(record))
    if record.get("spilling"):
        raise AssertionError(f"{len(spills)} conv builds of the 3x3 space "
                             "spill")
    record["gemm_bf16"] = _build_space_gemm_bf16(device, workers,
                                                 gemm_stride)
    record["flash_bf16"] = _build_space_flash_bf16(device, workers)
    record["conv_bf16"] = _build_space_conv_bf16(device, workers)
    return record


def _sass(lib):
    """A built library's SASS (``cuobjdump -sass``)."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout


def _sass_mnemonics(lib):
    """How often each SASS mnemonic occurs in a built library."""
    counts = {}
    # "/*0150*/  @!P0 HMMA.16816.F32.BF16 ...": address, predicate, opcode
    for m in re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9]*)", _sass(lib)):
        counts[m] = counts.get(m, 0) + 1
    return counts


def sass_against(parent, source, defines_list):
    """``source`` (a path relative to each tree's root) built from this
    tree and from the ``parent`` tree at each set of ``-D`` defines, with
    the port's own flags; prints whether the two SASS instruction listings
    are the same line for line, and returns how many sets differ."""
    roots = {"change": ROOT, "parent": os.path.abspath(parent)}
    differ = 0
    for defines in defines_list:
        listings = {
            tree: [line for line in _sass(build.build(
                       os.path.join(root, source), defines,
                       f"sass-{tree}")[0]).splitlines()
                   if "/*" in line and "*/" in line]
            for tree, root in roots.items()}
        same = listings["change"] == listings["parent"]
        differ += not same
        print("[sass-against] " + json.dumps(
            {"source": source, "defines": defines, "identical": same,
             "lines": {t: len(v) for t, v in listings.items()}}))
    return differ


def _build_space_gemm_bf16(device, workers, stride, shape=(256, 256, 256)):
    """Build every ``stride``-th distinct bfloat16 GEMM library of the
    compact space (the configs the build takes: ACC_IN_OUTPUT needs a
    float32 output), none may spill; launch each once at ``shape``
    against gemm_plain (BF16_TOL), with its threads and shared bytes
    against the models; and read one library's SASS, which must hold the
    tensor cores' HMMA."""
    M, N, K = shape
    space = GEMM.make_space({"M": 2048, "N": 2048, "K": 2048,
                             "dtype": "bfloat16"})
    distinct = {}
    for c in space.enumerate():
        if not c["ACC_IN_OUTPUT"]:
            fn = make_matmul(M, N, K, c, out_dtype=torch.bfloat16)
            distinct.setdefault(
                tuple(sorted(mm_kernel._defines(fn.config, fn.dtype)
                             .items())), fn)
    fns = list(distinct.values())[::stride]
    record = {"distinct": len(distinct), "stride": stride,
              "builds": len(fns)}
    if device.type == "cuda":
        t0 = time.perf_counter()
        with ThreadPoolExecutor(workers) as pool:
            list(pool.map(lambda f: f.compile(), fns))
        record["seconds"] = time.perf_counter() - t0
    registers, spills, bad = {}, [], []
    a, b = inputs(shape, "bfloat16", False, device)
    for fn in fns:
        out = fn(a, b)
        sync(device)
        share = tol_share(out, gemm_plain(a, b, fn.config), BF16_TOL,
                          BF16_TOL)
        if not (torch.isfinite(out.float()).all() and share <= 1.0):
            bad.append({"config": fn.config, "share_plain": share})
        if device.type != "cuda":
            continue
        want = (mm_kernel.block_threads(fn.config, 2),
                smem_footprint(fn.config, 2))
        if fn.geometry() != want:
            bad.append({"config": fn.config, "built": fn.geometry(),
                        "modelled": want})
        lines = ptxas_info(fn)
        regs = _registers(lines)
        registers[regs] = registers.get(regs, 0) + 1
        if spill_bytes(lines):
            spills.append({"config": fn.config, "lines": lines})
    if device.type == "cuda":
        lib = build.library_path(mm_kernel.BUILD_NAME,
                                 fns[0].address.split(":", 1)[1])
        record["sass"] = {k: v for k, v in _sass_mnemonics(lib).items()
                          if k in ("HMMA", "LDSM", "LDGSTS", "FFMA")}
        record["sass_of"] = fns[0].config
    record.update(registers=dict(sorted(registers.items())),
                  spilling=spills, bad=bad)
    print("[build-space] gemm bf16 " + json.dumps(record))
    if spills or bad:
        raise AssertionError(f"bf16 GEMM builds: {len(spills)} spill, "
                             f"{len(bad)} disagree: {bad}")
    if device.type == "cuda" and not record["sass"].get("HMMA"):
        raise AssertionError(f"the bf16 GEMM's SASS holds no HMMA: "
                             f"{record['sass']}")
    return record


def _build_space_flash_bf16(device, workers, main=(4096, 4096, 128),
                            run=((2,), 512, 512)):
    """Build every config of the bfloat16 flash space at ``main`` (causal),
    none may spill, and each library's SASS must hold the tensor cores'
    HMMA; launch each once at ``run`` = (lead, Sq, Sk) with the same D,
    causal, against flash_plain (flash_bf16_agreement), with its threads
    and shared bytes against the models."""
    Sq, Sk, D = main
    space = fa.FLASH_ATTENTION.make_space(
        {"Sq": Sq, "Sk": Sk, "D": D, "causal": True, "dtype": "bfloat16"})
    lead, rq, rk = run
    fns = [fa.make_flash_attention(rq, rk, D, c, causal=True,
                                   dtype=torch.bfloat16)
           for c in space.enumerate()]
    record = {"configs": len(fns)}
    if device.type == "cuda":
        t0 = time.perf_counter()
        with ThreadPoolExecutor(workers) as pool:
            list(pool.map(lambda f: f.compile(), fns))
        record["seconds"] = time.perf_counter() - t0
    registers, spills, bad, sass = {}, [], [], []
    if device.type == "cuda":
        with ThreadPoolExecutor(workers) as pool:
            mnemonics = list(pool.map(
                lambda f: _sass_mnemonics(build.library_path(
                    f.build_name, f.address.split(":", 1)[1])), fns))
    q, k, v = flash_inputs(lead, rq, rk, D, "bfloat16", device)
    for i, fn in enumerate(fns):
        out = fn(q, k, v)
        sync(device)
        share, differ = flash_bf16_agreement(
            out, fa.flash_plain(q, k, v, fn.config))
        if not (torch.isfinite(out.float()).all() and share <= 1.0
                and differ <= FLASH_BF16_DIFFER):
            bad.append({"config": fn.config, "share_plain": share,
                        "differ_plain": differ})
        if device.type != "cuda":
            continue
        want = (fa.block_threads(fn.config, D, 2),
                fa.smem_footprint(fn.config, D, 2))
        if fn.geometry() != want:
            bad.append({"config": fn.config, "built": fn.geometry(),
                        "modelled": want})
        lines = ptxas_info(fn)
        regs = _registers(lines)
        registers[regs] = registers.get(regs, 0) + 1
        if spill_bytes(lines):
            spills.append({"config": fn.config, "lines": lines})
        sass.append({"config": fn.config, "registers": regs,
                     **{m: mnemonics[i].get(m, 0)
                        for m in ("HMMA", "LDSM", "LDGSTS", "FFMA")}})
    record.update(registers=dict(sorted(registers.items())),
                  spilling=spills, bad=bad, sass=sass)
    print("[build-space] flash bf16 " + json.dumps(record))
    no_hmma = [r["config"] for r in sass if not r["HMMA"]]
    if spills or bad or no_hmma:
        raise AssertionError(f"bf16 flash builds: {len(spills)} spill, "
                             f"{len(bad)} disagree: {bad}; no HMMA in "
                             f"{no_hmma}")
    return record


def _build_space_conv_bf16(device, workers, stride=16, filt=(11, 11),
                           run=(64, 512)):
    """Build every ``stride``-th distinct bfloat16 conv library of the
    extended space at ``filt`` (the widest filter of the main paths), none
    may spill and each library's SASS must hold the tensor cores' HMMA;
    launch each once at ``run`` = (H, W) against conv2d_plain
    (conv_bf16_agreement), with its threads, shared bytes and warp tile
    against the models."""
    Fh, Fw = filt
    space = cv.CONV2D.make_space({"H": 8192, "W": 4096, "Fh": Fh, "Fw": Fw,
                                  "dtype": "bfloat16"}, extended=True)
    distinct = {}
    for c in space.enumerate():
        if c["HALO_MODE"] == "materialize":
            fn = cv.make_conv2d(*run, Fh, Fw, c, dtype=torch.bfloat16)
            distinct.setdefault(fn.defines(), fn)
    fns = list(distinct.values())[::stride]
    record = {"distinct": len(distinct), "stride": stride,
              "builds": len(fns), "filter": list(filt)}
    if device.type == "cuda":
        t0 = time.perf_counter()
        with ThreadPoolExecutor(workers) as pool:
            list(pool.map(lambda f: f.compile(), fns))
            mnemonics = list(pool.map(
                lambda f: _sass_mnemonics(build.library_path(
                    f.build_name, f.address.split(":", 1)[1])), fns))
        record["seconds"] = time.perf_counter() - t0
    registers, spills, bad, no_hmma, builds = {}, [], [], [], []
    img, f = (x.bfloat16() for x in conv_inputs(*run, Fh, Fw, device))
    for i, fn in enumerate(fns):
        out = fn(img, f)
        sync(device)
        share, differ = conv_bf16_agreement(
            out, cv.conv2d_plain(img, f, fn.config))
        if not (torch.isfinite(out.float()).all() and share <= 1.0
                and differ <= CONV_BF16_DIFFER):
            bad.append({"config": fn.config, "share_plain": share,
                        "differ_plain": differ})
        if device.type != "cuda":
            continue
        want = (cv.block_threads(fn.config, 2),
                cv.smem_footprint(fn.config, Fh, Fw, 2),
                cv.micro_tile(fn.config, Fh, Fw, 2))
        if fn.geometry() != want:
            bad.append({"config": fn.config, "built": fn.geometry(),
                        "modelled": want})
        lines = ptxas_info(fn)
        regs = _registers(lines)
        registers[regs] = registers.get(regs, 0) + 1
        if spill_bytes(lines):
            spills.append({"config": fn.config, "lines": lines})
        if not mnemonics[i].get("HMMA"):
            no_hmma.append(fn.config)
        builds.append({"config": fn.config, "threads": want[0],
                       "tile": want[2], "registers": regs,
                       **{m: mnemonics[i].get(m, 0)
                          for m in ("HMMA", "LDSM", "LDGSTS")}})
    record.update(registers=dict(sorted(registers.items())),
                  spilling=spills, bad=bad, no_hmma=no_hmma, sass=builds)
    print("[build-space] conv bf16 " + json.dumps(record))
    if spills or bad or no_hmma:
        raise AssertionError(f"bf16 conv builds: {len(spills)} spill, "
                             f"{len(bad)} disagree: {bad}; no HMMA in "
                             f"{no_hmma}")
    return record


#: [ragged]: shapes at which the JAX ops compute with config=None and the
#: builds once refused the blocks the heuristics gave (GEMM (M, N, K), a
#: prime one among them; flash (S, D) with q, k and v of length S; conv
#: (H, W, Fh, Fw)), each run through the op in float32 and in bfloat16
RAGGED_GEMM = [(100, 100, 100), (36, 52, 20), (8, 8, 8), (24, 24, 24),
               (1000, 1000, 1000), (1009, 1009, 1009)]
RAGGED_FLASH = [(16, 64), (48, 64), (100, 64), (200, 64), (64, 40), (64, 80)]
RAGGED_CONV = [(50, 200, 3, 3)]
#: ... and explicit configs the JAX package takes and the builds refused
RAGGED_CONFIGS = [
    ("gemm", (64, 64, 64), {"BLOCK_M": 8, "BLOCK_N": 64, "BLOCK_K": 16}),
    ("gemm", (64, 64, 96), {"BLOCK_M": 32, "BLOCK_N": 32, "BLOCK_K": 24,
                            "INNER_STEPS": 8, "ACC_DTYPE": "bfloat16"}),
    ("flash", (128, 64), {"BLOCK_Q": 8, "BLOCK_K": 64}),
    ("flash", (128, 64), {"BLOCK_Q": 64, "BLOCK_K": 8}),
    ("flash", (256, 64), {"BLOCK_Q": 4, "BLOCK_K": 128}),
    ("flash", (256, 64), {"BLOCK_Q": 16, "BLOCK_K": 16}),
    ("conv", (64, 256, 3, 3), dict(CONV_CONFIGS[0], BLOCK_W=100)),
    ("conv", (50, 200, 7, 7), dict(CONV_CONFIGS[0], BLOCK_H=8, BLOCK_W=50)),
]


def _ragged_cases(device):
    """(kind, shape, config or None, dtype, kernel object at the config
    the op resolves) of every [ragged] case."""
    cases = []
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for shape in RAGGED_GEMM:
            cfg = lookup_config(*shape, resolve_profile(None, device),
                                dtype=dt)
            cases.append(("gemm", shape, None, dtype,
                          make_matmul(*shape, cfg, out_dtype=dt)))
        for S, D in RAGGED_FLASH:
            cfg = fa.lookup_config(S, S, D, True, resolve_profile(None,
                                                                  device),
                                   dtype=dt)
            cases.append(("flash", (S, D), None, dtype,
                          fa.make_flash_attention(S, S, D, cfg, dtype=dt)))
        for shape in RAGGED_CONV:
            cfg = cv.lookup_config(*shape, resolve_profile(None, device),
                                   dtype=dt)
            cases.append(("conv", shape, None, dtype,
                          cv.make_conv2d(*shape, cfg, dtype=dt)))
        for kind, shape, cfg in RAGGED_CONFIGS:
            if kind == "gemm":
                fn = make_matmul(*shape, cfg, out_dtype=dt)
            elif kind == "flash":
                fn = fa.make_flash_attention(shape[0], shape[0], shape[1],
                                             cfg, dtype=dt)
            else:
                fn = cv.make_conv2d(*shape, cfg, dtype=dt)
            cases.append((kind, shape, cfg, dtype, fn))
    return cases


def _ragged_run(kind, shape, cfg, dtype, fn, device):
    """One [ragged] case through its op: (inputs, op call, output, plain
    version, float32 oracle, library call)."""
    if kind == "gemm":
        a, b = inputs(shape, dtype, False, device)
        call = lambda: matmul(a, b, cfg)                        # noqa: E731
        plain = gemm_plain(a, b, fn.config)
        oracle = gemm_reference(a.float(), b.float())
        library = lambda: torch.matmul(a, b)                    # noqa: E731
    elif kind == "flash":
        S, D = shape
        q, k, v = flash_inputs((1,), S, S, D, dtype, device)
        call = lambda: fa.flash_attention(q, k, v, config=cfg)  # noqa: E731
        plain = fa.flash_plain(q, k, v, fn.config)
        oracle = fa.attention_reference(q.float(), k.float(), v.float())
        library = lambda: F.scaled_dot_product_attention(       # noqa: E731
            q, k, v, is_causal=True)
    else:
        img, f = (x.to(getattr(torch, dtype))
                  for x in conv_inputs(*shape, device))
        call = lambda: cv.conv2d(img, f, config=cfg)            # noqa: E731
        plain = cv.conv2d_plain(img, f, fn.config)
        oracle = cv.conv2d_reference(img.float(), f.float())
        library = lambda: F.conv2d(                             # noqa: E731
            img[None, None], f[None, None],
            padding=(shape[2] // 2, shape[3] // 2))
    counter = {"gemm": LAUNCHES, "flash": fa.LAUNCHES,
               "conv": cv.LAUNCHES}[kind]
    before = sum(counter.values())
    out = call()
    sync(device)
    launched = sum(counter.values()) - before
    args = {"gemm": lambda: (a, b), "flash": lambda: (q, k, v),
            "conv": lambda: (img, f)}[kind]()
    return call, out, plain, oracle, library, launched, args


def phase_ragged(device):
    """Every [ragged] case through its op (config=None, or the explicit
    config) on the hand-written kernel: one launch a call, no fallback.
    Its builds are compiled in one parallel batch, each with its threads
    and shared bytes against the models and no spill; each result is held
    to the float32 oracle (the sweep's GEMM tolerance, BF16_TOL in
    bfloat16, FLASH_TOL, CONV_TOL) and to its plain version (the sweep's
    GEMM rule, flash_bf16_agreement, conv_bf16_agreement); each
    config=None case is timed through its op (the lookup included: a
    heuristic config off its space's lists is projected on every call,
    with a warning the phase mutes) and its kernel alone, beside its
    library call."""
    t0 = time.perf_counter()
    registry_log = logging.getLogger("repro_torch.registry")
    level = registry_log.level
    registry_log.setLevel(logging.ERROR)
    try:
        return _phase_ragged(device, t0)
    finally:
        registry_log.setLevel(level)


def _phase_ragged(device, t0):
    cases = _ragged_cases(device)
    builds = {}
    for *_, fn in cases:
        builds.setdefault((fn.build_name, json.dumps(
            sorted(fn.config.items())), str(fn.dtype),
            getattr(fn, "D", None), getattr(fn, "Fw", None),
            getattr(fn, "Fh", None)), fn)
    record = {"builds": len(builds), "rows": [], "times": []}
    if device.type == "cuda":
        with ThreadPoolExecutor(len(builds)) as pool:
            list(pool.map(lambda f: f.compile(), builds.values()))
        record["build_s"] = time.perf_counter() - t0
        bad = []
        for fn in builds.values():
            elt = fn.dtype.itemsize
            if isinstance(fn, cv.Conv2d):
                want = (cv.block_threads(fn.config, elt),
                        cv.smem_footprint(fn.config, fn.Fh, fn.Fw, elt),
                        cv.micro_tile(fn.config, fn.Fh, fn.Fw, elt))
            elif isinstance(fn, fa.FlashAttention):
                want = (fa.block_threads(fn.config, fn.D, elt),
                        fa.smem_footprint(fn.config, fn.D, elt))
            else:
                want = (mm_kernel.block_threads(fn.config, elt),
                        smem_footprint(fn.config, elt))
            lines = ptxas_info(fn)
            record.setdefault("ptxas", []).append(
                [fn.build_name, str(fn.dtype), fn.config,
                 _registers(lines), spill_bytes(lines)])
            if fn.geometry() != want or spill_bytes(lines):
                bad.append({"config": fn.config, "dtype": str(fn.dtype),
                            "built": fn.geometry(), "modelled": want,
                            "ptxas": lines})
        print(f"[ragged] {len(builds)} builds in {record['build_s']:.2f} s, "
              f"registers {sorted({p[3] for p in record['ptxas']})}; "
              f"against the models or spilling: {bad}")
        if bad:
            raise AssertionError(f"[ragged] builds disagree with the models "
                                 f"or spill: {bad}")
    for kind, shape, cfg, dtype, fn in cases:
        call, out, plain, oracle, library, launched, args = _ragged_run(
            kind, shape, cfg, dtype, fn, device)
        row = {"kind": kind, "shape": list(shape), "dtype": dtype,
               "given": cfg, "config": fn.config, "launches": launched,
               "finite": bool(torch.isfinite(out.float()).all()),
               "err_plain": max_err(out, plain),
               "err_oracle": max_err(out, oracle)}
        if kind == "gemm":
            atol, rtol, why = tolerance(fn.config, dtype, shape, oracle)
            p_atol, p_rtol, bitwise = plain_tolerance(fn.config, dtype,
                                                      plain, atol, rtol, why)
            row["share_plain"] = ((0.0 if torch.equal(out, plain)
                                   else float("inf")) if bitwise else
                                  tol_share(out, plain, p_atol, p_rtol))
        elif kind == "flash":
            atol = rtol = BF16_TOL if dtype == "bfloat16" else FLASH_TOL
            why = "bf16 test tolerance" if dtype == "bfloat16" else \
                "JAX attention tests"
            if dtype == "bfloat16":
                row["share_plain"], row["differ_plain"] = \
                    flash_bf16_agreement(out, plain)
            else:
                row["share_plain"] = tol_share(out, plain, atol, rtol)
        else:
            atol = rtol = BF16_TOL if dtype == "bfloat16" else CONV_TOL
            why = "bf16 test tolerance" if dtype == "bfloat16" else \
                "JAX conv tests"
            if dtype == "bfloat16":
                row["share_plain"], row["differ_plain"] = \
                    conv_bf16_agreement(out, plain)
            else:
                row["share_plain"] = tol_share(out, plain, atol, rtol)
        row.update(share_oracle=tol_share(out, oracle, atol, rtol),
                   tol_oracle=[atol, rtol], tol_why=why)
        differ = CONV_BF16_DIFFER if kind == "conv" else FLASH_BF16_DIFFER
        if device.type == "cuda" and launched != 1:
            raise AssertionError(f"[ragged] {kind} {shape} launched "
                                 f"{launched} kernels: {row}")
        record["rows"].append(row)
        _check_row(dict(row, case=f"{kind} {shape} {dtype}"), kind,
                   tag="ragged", differ=differ)
        if cfg is None and device.type == "cuda":
            # about 20 ms a run; one call a run where a call takes longer
            # (a prime dim's blocks of 1)
            once = time_ms(call, device, iters=1)
            iters = max(1, min(50, int(20.0 / max(once, 1e-3))))
            runs = time_in_turns({"op": call, "kernel": lambda: fn(*args),
                                  "library": library}, device,
                                 rounds=2, iters=iters, warmup=1)
            rec = {"kind": kind, "shape": list(shape), "dtype": dtype,
                   "config": fn.config, "iters": iters,
                   "ms": min(runs["op"]), "kernel_ms": min(runs["kernel"]),
                   "library_ms": min(runs["library"])}
            record["times"].append(rec)
            print("[ragged-times] " + json.dumps(rec))
    record["seconds"] = time.perf_counter() - t0
    print(f"[ragged] {len(record['rows'])} cases, {record['builds']} builds, "
          f"{record['seconds']:.1f} s")
    return record


def _check_row(row, kind, tag=None, differ=FLASH_BF16_DIFFER):
    print(f"[{tag or kind + '-sweep'}] " + json.dumps(row))
    if not (row["finite"] and row["share_plain"] <= 1.0
            and row["share_oracle"] <= 1.0 and row.get("mean_v_ok", True)
            and row.get("differ_plain", 0.0) <= differ):
        raise AssertionError(f"{kind} {row['case']} disagrees: {row}")


def phase_conv_sweep(cases, fns, big, device):
    rows = []
    for name, cfg, hw, filt, weight in cases:
        for size in (hw, big):
            fn = fns[(name, size)]
            img, f = conv_inputs(*size, *filt, device)
            out = fn(img, f)
            sync(device)
            plain = cv.conv2d_plain(img, f, fn.config, weight)
            oracle = cv.conv2d_reference(img, f, weight)
            row = {"case": name, "config": fn.config, "shape": list(size),
                   "filter": list(filt), "weight": weight,
                   "route": fn.route,
                   "finite": bool(torch.isfinite(out).all()),
                   "err_plain": max_err(out, plain),
                   "err_oracle": max_err(out, oracle),
                   "share_plain": tol_share(out, plain, CONV_TOL, CONV_TOL),
                   "share_oracle": tol_share(out, oracle, CONV_TOL,
                                             CONV_TOL),
                   "tol": [CONV_TOL, CONV_TOL]}
            rows.append(row)
            _check_row(row, "conv")
    return rows


def phase_flash_sweep(cases, fns, big_s, device):
    rows = []
    for case in cases:
        name, _, _, _, _, _, causal, dtype = case
        for lead, sq, sk, d in flash_sizes(case, big_s):
            fn = fns[(name, sq, d)]
            q, k, v = flash_inputs(lead, sq, sk, d, dtype, device)
            out = fn(q, k, v)
            sync(device)
            plain = fa.flash_plain(q, k, v, fn.config, causal=causal)
            # the float32 oracle of the same (bf16) inputs
            oracle = fa.attention_reference(q.float(), k.float(), v.float(),
                                            causal=causal)
            atol, rtol, why = flash_tolerance(dtype, sq, q, k, v)
            row = {"case": name, "config": fn.config,
                   "shape": list(lead) + [sq, sk, d], "causal": causal,
                   "dtype": dtype,
                   "finite": bool(torch.isfinite(out.float()).all()),
                   "err_plain": max_err(out, plain),
                   "err_oracle": max_err(out, oracle),
                   "share_plain": tol_share(out, plain, atol, rtol),
                   "share_oracle": tol_share(out, oracle, atol, rtol),
                   "tol": [atol, rtol], "tol_why": why}
            if dtype == "bfloat16":
                # the oracle keeps BF16_TOL; the plain version rounds where
                # the build does, so it is held much closer
                row["share_plain"], row["differ_plain"] = \
                    flash_bf16_agreement(out, plain)
                row["tol_plain"] = [FLASH_BF16_ROW_ATOL, FLASH_BF16_RTOL,
                                    FLASH_BF16_DIFFER]
            if causal and sq > sk:
                # rows that see no key return the mean of v
                masked = out[..., :sq - sk, :]
                mean_v = v.float().mean(dim=-2, keepdim=True).expand_as(
                    masked)
                row["mean_v_share"] = tol_share(masked, mean_v, atol, rtol)
                row["mean_v_ok"] = row["mean_v_share"] <= 1.0
            rows.append(row)
            _check_row(row, "flash")
    return rows


def _trials(outcome):
    return [[t.config, t.time * 1e3] for t in outcome.result.trials]


def _check_tune(outcome, what):
    if outcome.result.best is None:
        raise AssertionError(f"the {what} search found no verified config")
    # a config that fails verification is a failed trial, so every timed
    # one — the winner among them — was verified against the oracle
    if not all(m.verified for m in outcome.measurements.values() if m.ok):
        raise AssertionError(f"a timed {what} config was not verified")


def phase_conv_main(main, big_shapes, device, budget):
    """tune_kernel(CONV2D) -> lookup (exact) -> conv2d(config=None); then
    conv2d(config=None) at the paper's image size (heuristic config)."""
    H, W, Fh, Fw = main
    shape = {"H": H, "W": W, "Fh": Fh, "Fw": Fw}
    profile = device_profile(device)
    cache = default_cache()            # REPRO_TUNE_CACHE: a temporary file
    evaluator = WallClockEvaluator(atol=CONV_TOL, rtol=CONV_TOL,
                                   device=device)
    # the heuristic lacks the extended space's PAD_W and PIPELINE_DEPTH,
    # so warm-start would drop it: seed it whole, so the kernel is timed
    seed = dict(cv.heuristic_config(H, W, Fh, Fw), PAD_W=0,
                PIPELINE_DEPTH=2)
    for key in cv.LAUNCHES:
        cv.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    outcome = tune_kernel(cv.CONV2D, shape, strategy="annealing",
                          budget=budget, seed=0, evaluator=evaluator,
                          profile=profile, cache=cache, seeds=[seed])
    tune_s = time.perf_counter() - t0
    _check_tune(outcome, "conv2d")
    best = outcome.result.best
    stats = outcome.engine_stats or {}
    res = lookup_resolved(cv.CONV2D, shape, profile=profile, cache=cache)
    if res.provenance != "exact" or res.config != best.config:
        raise AssertionError(f"conv2d lookup gave {res}")
    calls = []
    for size in [main] + list(big_shapes):
        s = dict(zip(("H", "W", "Fh", "Fw"), size))
        r = lookup_resolved(cv.CONV2D, s, profile=profile, cache=cache)
        img, f = conv_inputs(*size, device, seed=1)
        before = cv.LAUNCHES["conv2d"]
        out = cv.conv2d(img, f)                 # config=None: the registry
        sync(device)
        oracle = cv.conv2d_reference(img, f)
        call = {"shape": list(size), "provenance": r.provenance,
                "config": r.config,
                "route": cv.make_conv2d(*size, r.config).route,
                "launches": cv.LAUNCHES["conv2d"] - before,
                "err_oracle": max_err(out, oracle),
                "share_oracle": tol_share(out, oracle, CONV_TOL, CONV_TOL)}
        ran = (call["route"] if device.type == "cuda"
               else "plain version's")
        print(f"[conv-main] conv2d{tuple(size)} ran the {ran} route "
              f"({r.provenance} config {r.config})")
        calls.append(call)
        want = "exact" if size == main else "heuristic"
        if r.provenance != want or call["share_oracle"] > 1.0:
            raise AssertionError(f"conv2d() at {size}: {call}")
        if device.type == "cuda" and call["launches"] != (
                call["route"] == "cuda"):
            raise AssertionError(f"conv2d() at {size} launched "
                                 f"{call['launches']} kernels: {call}")
    launches = dict(cv.LAUNCHES)
    materialized = [t for t in outcome.result.trials
                    if t.config.get("HALO_MODE") == "materialize"
                    and np.isfinite(t.time)]
    record = {
        "winner": best.config, "winner_ms": best.time * 1e3,
        "best_kernel_config": min(materialized, key=lambda t: t.time).config
        if materialized else None,
        "evaluations": outcome.result.evaluations,
        "failures_by_type": outcome.failure_summary.get("by_type", {}),
        "compile_s": stats.get("compile_total_s"),
        "compile_calls": stats.get("compile_calls"),
        "tune_wall_s": tune_s, "lookup": res.provenance, "calls": calls,
        "launches": launches}
    print("[conv-main] " + json.dumps(record))
    record["trials"] = _trials(outcome)
    if device.type == "cuda" and launches["conv2d"] == 0:
        raise AssertionError("the conv2d kernel was not launched on the path")
    return record


def phase_conv_main_bf16(main, big_shapes, device, budget, f32_winner):
    """The conv main path in bfloat16 on the tensor cores:
    tune_kernel(CONV2D) at ``main`` with dtype "bfloat16" over the compact
    space (every candidate held to the float32 oracle at BF16_TOL), lookup
    (provenance "exact" under the bfloat16 key), the float32 record at the
    same shape still ``f32_winner``; conv2d(config=None) on bfloat16
    tensors at ``main`` (exact) and at each of ``big_shapes`` (heuristic),
    each one launch of the bfloat16 build, against the float32 oracle
    (BF16_TOL) and conv2d_plain (conv_bf16_agreement); then the winner
    timed beside conv2d_plain, F.conv2d in bfloat16 and its bound."""
    H, W, Fh, Fw = main
    f32_shape = {"H": H, "W": W, "Fh": Fh, "Fw": Fw}
    shape = dict(f32_shape, dtype="bfloat16")
    profile = device_profile(device)
    cache = default_cache()
    evaluator = WallClockEvaluator(atol=BF16_TOL, rtol=BF16_TOL,
                                   device=device)
    zero_counts()
    t0 = time.perf_counter()
    outcome = tune_kernel(cv.CONV2D, shape, strategy="annealing",
                          budget=budget, seed=0, evaluator=evaluator,
                          profile=profile, cache=cache, extended_space=False)
    tune_s = time.perf_counter() - t0
    _check_tune(outcome, "bf16 conv2d")
    best = outcome.result.best
    res = lookup_resolved(cv.CONV2D, shape, profile=profile, cache=cache)
    if res.provenance != "exact" or res.config != best.config:
        raise AssertionError(f"bf16 conv2d lookup gave {res}")
    f32 = lookup_resolved(cv.CONV2D, f32_shape, profile=profile, cache=cache)
    if f32.provenance != "exact" or f32.config != f32_winner:
        raise AssertionError(f"the float32 conv2d record moved: {f32}")
    calls = []
    for size in [main] + list(big_shapes):
        s = dict(zip(("H", "W", "Fh", "Fw"), size), dtype="bfloat16")
        r = lookup_resolved(cv.CONV2D, s, profile=profile, cache=cache)
        img, f = (x.bfloat16() for x in conv_inputs(*size, device, seed=1))
        before = cv.LAUNCHES["conv2d"]
        out = cv.conv2d(img, f)                 # config=None: the registry
        sync(device)
        oracle = cv.conv2d_reference(img.float(), f.float())
        call = {"shape": list(size), "provenance": r.provenance,
                "config": r.config, "key": cv.CONV2D.key_for(s),
                "route": cv.make_conv2d(*size, r.config,
                                        dtype=torch.bfloat16).route,
                "launches": cv.LAUNCHES["conv2d"] - before,
                "dtype": str(out.dtype), "err_oracle": max_err(out, oracle),
                "share_oracle": tol_share(out, oracle, BF16_TOL, BF16_TOL)}
        call["share_plain"], call["differ_plain"] = conv_bf16_agreement(
            out, cv.conv2d_plain(img, f, r.config))
        calls.append(call)
        want = "exact" if size == main else "heuristic"
        if (r.provenance != want or out.dtype != torch.bfloat16
                or call["share_oracle"] > 1.0 or call["share_plain"] > 1.0
                or call["differ_plain"] > CONV_BF16_DIFFER):
            raise AssertionError(f"bf16 conv2d() at {size}: {call}")
        if device.type == "cuda" and (call["route"] != "cuda"
                                      or call["launches"] != 1):
            raise AssertionError(f"bf16 conv2d() at {size} did not launch "
                                 f"the bf16 build once: {call}")
    launches = read_counts()
    stats_ = outcome.engine_stats or {}
    record = {
        "winner": best.config, "winner_ms": best.time * 1e3,
        "evaluations": outcome.result.evaluations,
        "failures_by_type": outcome.failure_summary.get("by_type", {}),
        "compile_s": stats_.get("compile_total_s"),
        "compile_calls": stats_.get("compile_calls"),
        "tune_wall_s": tune_s, "lookup": res.provenance,
        "key": cv.CONV2D.key_for(shape), "f32_key": cv.CONV2D.key_for(
            f32_shape), "f32_lookup": f32.config, "calls": calls,
        "launches": launches}
    if best.config["HALO_MODE"] == "materialize":
        record.update(_time_conv_bf16("conv bf16 {}x{} {}x{}".format(*main),
                                      best.config, main, device))
    print("[conv-main-bf16] " + json.dumps(
        {k: v for k, v in record.items() if not k.endswith("_runs")}))
    record["trials"] = _trials(outcome)
    if device.type == "cuda":
        _check_launched(launches, ["conv2d"], "[conv-main-bf16]")
    return record


def phase_flash_main(main, op_lead, device, budget):
    """tune_kernel(FLASH_ATTENTION) -> lookup (exact) ->
    flash_attention(config=None) on a batch of heads."""
    Sq, Sk, D = main
    shape = {"Sq": Sq, "Sk": Sk, "D": D, "causal": True}
    profile = device_profile(device)
    cache = default_cache()
    # the evaluator's own inputs (its seed is 0) set its tolerance
    tol = flash_bound(*fa.FLASH_ATTENTION.make_args(
        shape, np.random.default_rng(0)))
    evaluator = WallClockEvaluator(atol=tol, rtol=0.0, device=device)
    for key in fa.LAUNCHES:
        fa.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    outcome = tune_kernel(fa.FLASH_ATTENTION, shape, strategy="annealing",
                          budget=budget, seed=0, evaluator=evaluator,
                          profile=profile, cache=cache)
    tune_s = time.perf_counter() - t0
    _check_tune(outcome, "flash")
    best = outcome.result.best
    stats = outcome.engine_stats or {}
    res = lookup_resolved(fa.FLASH_ATTENTION, shape, profile=profile,
                          cache=cache)
    if res.provenance != "exact" or res.config != best.config:
        raise AssertionError(f"flash lookup gave {res}")
    q, k, v = flash_inputs(op_lead, Sq, Sk, D, "float32", device, seed=1)
    before = fa.LAUNCHES["flash_attention"]
    out = fa.flash_attention(q, k, v)           # config=None: the registry
    sync(device)
    op_launches = fa.LAUNCHES["flash_attention"] - before
    launches = dict(fa.LAUNCHES)
    oracle = fa.attention_reference(q, k, v, causal=True)
    op_tol = flash_bound(q, k, v)
    record = {
        "winner": best.config, "winner_ms": best.time * 1e3,
        "evaluations": outcome.result.evaluations,
        "failures_by_type": outcome.failure_summary.get("by_type", {}),
        "compile_s": stats.get("compile_total_s"),
        "compile_calls": stats.get("compile_calls"),
        "tune_wall_s": tune_s, "tune_tol": tol, "lookup": res.provenance,
        "op_shape": list(op_lead) + [Sq, Sk, D], "op_launches": op_launches,
        "op_err_oracle": max_err(out, oracle), "op_tol": op_tol,
        "op_share_oracle": tol_share(out, oracle, op_tol, 0.0),
        "launches": launches}
    print("[flash-main] " + json.dumps(record))
    record["trials"] = _trials(outcome)
    if device.type == "cuda" and op_launches != 1:
        raise AssertionError("flash_attention() did not launch the kernel "
                             "once")
    if record["op_share_oracle"] > 1.0:
        raise AssertionError(f"flash_attention() disagrees with the oracle: "
                             f"{record}")
    return record


def phase_flash_main_bf16(main, op_lead, device, budget, f32_winner):
    """The flash main path in bfloat16 on the tensor cores:
    tune_kernel(FLASH_ATTENTION) at ``main`` causal with dtype "bfloat16"
    (every candidate held to the oracle at BF16_TOL), lookup (provenance
    "exact" under the bfloat16 key), the float32 record at the same shape
    still ``f32_winner``, flash_attention(config=None) on bfloat16 heads
    ``op_lead`` in one launch against the float32 oracle (BF16_TOL) and
    flash_plain (flash_bf16_agreement); then the winner
    timed beside flash_plain, SDPA in bfloat16 and its bound."""
    Sq, Sk, D = main
    f32_shape = {"Sq": Sq, "Sk": Sk, "D": D, "causal": True}
    shape = dict(f32_shape, dtype="bfloat16")
    profile = device_profile(device)
    cache = default_cache()
    evaluator = WallClockEvaluator(atol=BF16_TOL, rtol=BF16_TOL,
                                   device=device)
    zero_counts()
    t0 = time.perf_counter()
    outcome = tune_kernel(fa.FLASH_ATTENTION, shape, strategy="annealing",
                          budget=budget, seed=0, evaluator=evaluator,
                          profile=profile, cache=cache)
    tune_s = time.perf_counter() - t0
    _check_tune(outcome, "bf16 flash")
    best = outcome.result.best
    res = lookup_resolved(fa.FLASH_ATTENTION, shape, profile=profile,
                          cache=cache)
    if res.provenance != "exact" or res.config != best.config:
        raise AssertionError(f"bf16 flash lookup gave {res}")
    f32 = lookup_resolved(fa.FLASH_ATTENTION, f32_shape, profile=profile,
                          cache=cache)
    if f32.provenance != "exact" or f32.config != f32_winner:
        raise AssertionError(f"the float32 flash record moved: {f32}")
    q, k, v = flash_inputs(op_lead, Sq, Sk, D, "bfloat16", device, seed=1)
    before = fa.LAUNCHES["flash_attention"]
    out = fa.flash_attention(q, k, v)           # config=None: the registry
    sync(device)
    op_launches = fa.LAUNCHES["flash_attention"] - before
    launches = read_counts()
    oracle = fa.attention_reference(q.float(), k.float(), v.float(),
                                    causal=True)
    op_share_plain, op_differ_plain = flash_bf16_agreement(
        out, fa.flash_plain(q, k, v, res.config, causal=True))
    stats = outcome.engine_stats or {}
    record = {
        "winner": best.config, "winner_ms": best.time * 1e3,
        "evaluations": outcome.result.evaluations,
        "failures_by_type": outcome.failure_summary.get("by_type", {}),
        "compile_s": stats.get("compile_total_s"),
        "compile_calls": stats.get("compile_calls"),
        "tune_wall_s": tune_s, "lookup": res.provenance,
        "key": fa.FLASH_ATTENTION.key_for(shape),
        "f32_key": fa.FLASH_ATTENTION.key_for(f32_shape),
        "f32_lookup": f32.config,
        "op_shape": list(op_lead) + [Sq, Sk, D], "op_launches": op_launches,
        "op_dtype": str(out.dtype), "op_err_oracle": max_err(out, oracle),
        "op_share_oracle": tol_share(out, oracle, BF16_TOL, BF16_TOL),
        "op_share_plain": op_share_plain, "op_differ_plain": op_differ_plain,
        "launches": launches}
    winner = fa.make_flash_attention(Sq, Sk, D, best.config, causal=True,
                                     dtype=torch.bfloat16)
    q, k, v = flash_inputs(op_lead, Sq, Sk, D, "bfloat16", device, seed=2)
    q4, k4, v4 = (x.reshape(-1, 1, Sq, D) for x in (q, k, v))
    rec = _time_case(
        winner, (q, k, v),
        lambda: fa.flash_plain(q, k, v, winner.config, causal=True),
        lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True),
        device, iters=10, plain_iters=2)
    heads = int(np.prod(op_lead)) if op_lead else 1
    bound_ms, bound_by = _bound(
        heads * fa.attention_flops(Sq, Sk, D, causal=True),
        2.0 * heads * 2 * (Sq + Sk) * D,
        peak=H100_SXM.peak_bf16_tensor_flops)
    record.update(rec, bound_ms=bound_ms, bound_by=bound_by)
    record["share_of_bound"] = bound_ms / record["ms"]
    record["over_library"] = record["ms"] / record["library_ms"]
    print("[flash-main-bf16] " + json.dumps(
        {k: v for k, v in record.items() if not k.endswith("_runs")}))
    record["trials"] = _trials(outcome)
    if device.type == "cuda":
        if op_launches != 1:
            raise AssertionError("flash_attention() did not launch the bf16 "
                                 "kernel once")
        _check_launched(launches, ["flash_attention"], "[flash-main-bf16]")
    if (out.dtype != torch.bfloat16 or record["op_share_oracle"] > 1.0
            or op_share_plain > 1.0 or op_differ_plain > FLASH_BF16_DIFFER):
        raise AssertionError(f"bf16 flash_attention() disagrees with the "
                             f"oracle or its plain version: {record}")
    return record


# ---------------------------------------------------------------------------
# the layers above the kernels: analyzer, cost model, predictor
# ---------------------------------------------------------------------------

#: two GEMM configs of the extended space's raw product whose shared memory
#: (PIPELINE_DEPTH stages of BLOCK_K x (BLOCK_M + BLOCK_N) floats) is over
#: one H100 block's 232,448 B: 262,144 B and 294,912 B
OVER_SMEM = [
    {"BLOCK_M": 128, "BLOCK_N": 128, "BLOCK_K": 64, "PIPELINE_DEPTH": 4},
    {"BLOCK_M": 64, "BLOCK_N": 128, "BLOCK_K": 128, "PIPELINE_DEPTH": 3}]

#: profile fields the [analyze] line prints, runtime beside datasheet
LIMITS = ("smem_per_block_optin", "max_threads_per_block", "sm_count",
          "regs_per_sm", "l2_bytes", "hbm_bytes")


def zero_counts():
    """Set every kernel's launch count to 0 (just before a path)."""
    for counts in (LAUNCHES, cv.LAUNCHES, fa.LAUNCHES):
        for key in counts:
            counts[key] = 0


def read_counts():
    """Every kernel's launch count (just after a path)."""
    return launch_counts()


def _check_launched(counts, names, what):
    """Fail on the card when none of ``names`` launched on the path."""
    if not sum(counts[n] for n in names):
        raise AssertionError(f"{what}: no launch of {names}: {counts}")


def _ok_trials(rec):
    """Distinct configs a main-path search measured as ok: (config, ms)."""
    seen = {}
    for cfg, ms in rec["trials"]:
        if np.isfinite(ms):
            seen.setdefault(json.dumps(cfg, sort_keys=True), (cfg, ms))
    return list(seen.values())


def spearman(x, y):
    """Spearman's rank correlation; None when either side is constant."""
    if len(set(x)) < 2 or len(set(y)) < 2:
        return None
    return float(stats.spearmanr(x, y).statistic)


def phase_analyze(main_path, device, main_shape, flash_main):
    """The static analyzer on the card: lint at the runtime profile, no
    measured config proven infeasible, the proof's configs refused by the
    card, and a flash search with the analyzer on."""
    profile = device_profile(device)
    zero_counts()
    report = analyze_registry(profiles=[profile])
    warnings = {}
    for f in report.warnings:
        warnings[f.rule_id] = warnings.get(f.rule_id, 0) + 1
    record = {"limits": {k: [getattr(profile, k), getattr(H100_SXM, k)]
                         for k in LIMITS},
              "profile": profile.name, "findings": report.counts(),
              "warnings_by_rule": warnings}
    # no false proofs: every config a main-path search measured ran
    false = []
    for kernel, rec, shape in main_path:
        ok = _ok_trials(rec)
        record[f"checked_{kernel.name}"] = len(ok)
        for cfg, _ in ok:
            viol = proven_violations(kernel, shape, cfg, profile)
            if viol:
                false.append({"kernel": kernel.name, "config": cfg,
                              "violations": viol})
    record["false_proofs"] = false
    # the proof holds on the card: the launch of an over-budget build fails
    M, N, K = main_shape
    gemm_shape = {"M": M, "N": N, "K": K, "dtype": "float32"}
    over = [make_matmul(M, N, K, dict(heuristic_config(M, N, K), **c))
            for c in OVER_SMEM]
    refused = []
    for fn in over:
        viol = proven_violations(GEMM, gemm_shape, fn.config, profile)
        row = {"config": {k: fn.config[k] for k in OVER_SMEM[0]},
               "smem": smem_footprint(fn.config), "proof": viol}
        if not viol or not viol[0].startswith("smem:"):
            raise AssertionError(f"the proof does not reject {row}")
        refused.append(row)
    if device.type == "cuda":
        with ThreadPoolExecutor(len(over)) as pool:
            list(pool.map(lambda f: f.compile(), over))
        a, b = inputs(main_shape, "float32", False, device)
        for fn, row in zip(over, refused):
            before = dict(LAUNCHES)
            try:
                fn(a, b)
                row["launch"] = "accepted"
            except RuntimeError as e:
                row["launch"] = str(e).split(" for ")[0]
            row["built_smem"] = fn.geometry()[1]
            if row["launch"] == "accepted" or LAUNCHES != before:
                raise AssertionError(f"the card launched {row}")
    record["over_budget"] = refused
    # a search with the analyzer on, over the flash space's every point
    Sq, Sk, D = flash_main
    shape = {"Sq": Sq, "Sk": Sk, "D": D, "causal": True}
    tol = flash_bound(*fa.FLASH_ATTENTION.make_args(
        shape, np.random.default_rng(0)))
    outcome = tune_kernel(
        fa.FLASH_ATTENTION, shape, strategy="full",
        budget=fa.FLASH_ATTENTION.make_space(shape).cardinality(), seed=0,
        evaluator=WallClockEvaluator(atol=tol, rtol=0.0, device=device),
        profile=profile, record=False, analyze=True)
    _check_tune(outcome, "analyzed flash")
    best = outcome.result.best
    q, k, v = flash_inputs((), Sq, Sk, D, "float32", device, seed=4)
    out = fa.flash_attention(q, k, v, config=best.config)
    sdpa = F.scaled_dot_product_attention(q[None, None], k[None, None],
                                          v[None, None], is_causal=True)[0, 0]
    bound = flash_bound(q, k, v)
    record.update(
        flash_analysis=outcome.analysis,
        flash_proven_pruned=outcome.engine_stats["proven_pruned"],
        flash_evaluations=outcome.result.evaluations,
        flash_winner=best.config, flash_winner_ms=best.time * 1e3,
        flash_err_sdpa=max_err(out, sdpa), flash_bound=bound,
        flash_share_sdpa=tol_share(out, sdpa, bound, 0.0),
        launches=read_counts())
    print("[analyze] " + json.dumps(record))
    if device.type == "cuda":
        _check_launched(record["launches"], ["flash_attention"], "[analyze]")
    if report.errors:
        raise AssertionError(f"the lint found errors: {report.errors}")
    if false:
        raise AssertionError(f"measured configs proven infeasible: {false}")
    if record["flash_share_sdpa"] > 1.0:
        raise AssertionError("the analyzed flash winner disagrees with SDPA")
    return record


def phase_costmodel(main_path, device, main_shape, wall_winner, tmp):
    """The cost model on the card's searches: how its prices rank the
    measured configs, then a full cost-model GEMM search, no builds, whose
    winner runs through matmul()."""
    profile = device_profile(device)
    zero_counts()
    record = {"kernels": {}}
    for kernel, rec, shape in main_path:
        tuner = Tuner.from_tunable(kernel, shape, profile=profile,
                                   evaluator=CostModelEvaluator(profile))
        ok = _ok_trials(rec)
        priced = [tuner.evaluator.measure(tuner._spec, cfg).time_s * 1e3
                  for cfg, _ in ok]
        win = tuner.evaluator.measure(tuner._spec, rec["winner"])
        record["kernels"][kernel.name] = {
            "configs": len(ok),
            "spearman": spearman(priced, [ms for _, ms in ok]),
            "winner": rec["winner"], "winner_measured_ms": rec["winner_ms"],
            "winner_priced_ms": win.time_s * 1e3,
            "winner_bound_by": ("operations" if win.detail["compute_t"]
                                >= win.detail["memory_t"] else "bytes")}
    M, N, K = main_shape
    shape = {"M": M, "N": N, "K": K}
    built = (len(os.listdir(build.BUILD_DIR))
             if os.path.isdir(build.BUILD_DIR) else 0)
    store = ArtifactStore(os.path.join(tmp, "artifacts"))
    space = GEMM.make_space(shape).cardinality()
    runs = []
    for _ in range(2):                 # the second answers from the store
        ev = CostModelEvaluator(profile)
        ev.artifact_store = store
        t0 = time.perf_counter()
        outcome = tune_kernel(GEMM, shape, strategy="full", budget=space,
                              evaluator=ev, profile=profile, record=False,
                              warm_start=False)
        runs.append((outcome, time.perf_counter() - t0))
    built = (len(os.listdir(build.BUILD_DIR))
             if os.path.isdir(build.BUILD_DIR) else 0) - built
    outcome = runs[0][0]
    best = outcome.result.best
    a, b = inputs(main_shape, "float32", False, device, seed=5)
    before = dict(LAUNCHES)
    out = matmul(a, b, config=best.config)
    sync(device)
    launched = sum(LAUNCHES.values()) - sum(before.values())
    oracle = gemm_reference(a, b)
    fns = {"costmodel": make_matmul(M, N, K, best.config),
           "wallclock": make_matmul(M, N, K, wall_winner)}
    runs_ms = time_in_turns({k: (lambda fn=fn: fn(a, b))
                             for k, fn in fns.items()}, device)
    record.update(
        search_evaluations=outcome.result.evaluations, space=space,
        search_s=[round(s, 3) for _, s in runs],
        store_hits=[o.engine_stats["artifact_hits"] for o, _ in runs],
        libraries_built_by_search=built,
        winner=best.config, winner_priced_ms=best.time * 1e3,
        launches=launched,
        err_oracle=max_err(out, oracle),
        share_oracle=tol_share(out, oracle, MAIN_TOL, MAIN_TOL),
        winner_ms=float(np.median(runs_ms["costmodel"])),
        wallclock_winner=wall_winner,
        wallclock_winner_ms=float(np.median(runs_ms["wallclock"])),
        path_launches=read_counts())
    print("[costmodel] " + json.dumps(record))
    if outcome.result.evaluations != space:
        raise AssertionError("the cost-model search did not price the space")
    if record["libraries_built_by_search"] or runs[1][0].engine_stats[
            "artifact_hits"] != space:
        raise AssertionError(f"the cost-model search built or missed: "
                             f"{record}")
    if device.type == "cuda" and record["launches"] != 1:
        raise AssertionError("matmul() did not launch the cost-model winner")
    if record["share_oracle"] > 1.0:
        raise AssertionError("the cost-model winner disagrees with "
                             "torch.matmul")
    return record


def phase_predict(main_rec, device, main_shape, new_shape, lookup_shape,
                  budget, tmp):
    """A learned predictor trained on the [main] search: two searches at a
    shape no phase tunes (predictor off / on, pruning), each winner run
    through lookup -> matmul(), and a predicted lookup run on the card."""
    profile = device_profile(device)
    zero_counts()
    M, N, K = main_shape
    model = LearnedPredictor(GEMM, profile=profile)
    pretrained = model.pretrain([{"M": M, "N": N, "K": K}], limit=256)
    rows = [{"shape": {"M": M, "N": N, "K": K}, "config": cfg,
             "time_s": t / 1e3} for cfg, t in main_rec["trials"]
            if np.isfinite(t)]
    model.finetune(rows)
    record = {"pretrained": pretrained, "finetuned": len(rows),
              "model": model.name, "searches": {}}
    shape = dict(zip(("M", "N", "K"), new_shape), dtype="float32")
    a, b = inputs(new_shape, "float32", False, device, seed=6)
    oracle = gemm_reference(a, b)
    for label, predictor in (("off", "off"), ("learned", model)):
        path = os.path.join(tmp, f"predict-{label}.json")
        shutil.copy(default_cache().path, path)     # the same warm start
        cache = TuningCache(path)
        t0 = time.perf_counter()
        outcome = tune_kernel(
            GEMM, shape, strategy="annealing", budget=budget, seed=0,
            evaluator=WallClockEvaluator(atol=MAIN_TOL, rtol=MAIN_TOL,
                                         device=device),
            profile=profile, cache=cache, predictor=predictor,
            engine={"predict_prune": True})
        wall_s = time.perf_counter() - t0
        _check_tune(outcome, f"predictor-{label} GEMM")
        stats = outcome.engine_stats
        cfg = lookup_config(*new_shape, profile=profile, cache=cache)
        if cfg != outcome.best_config:
            raise AssertionError(f"lookup gave {cfg}")
        out = matmul(a, b, config=cfg)
        sync(device)
        record["searches"][label] = {
            "predictor": outcome.predictor,
            "evaluations": outcome.result.evaluations,
            "best_ms": outcome.best_time * 1e3, "winner": cfg,
            "nvcc_s": stats.get("compile_total_s"),
            "compile_calls": stats.get("compile_calls"),
            "tune_wall_s": wall_s,
            "predictor_rank_used": stats.get("predictor_rank_used"),
            "predicted_pruned": stats.get("predicted_pruned"),
            "failures_by_type": outcome.failure_summary.get("by_type", {}),
            "err_oracle": max_err(out, oracle),
            "share_oracle": tol_share(out, oracle, MAIN_TOL, MAIN_TOL)}
    # the predicted step of the lookup chain: no transfer, the model picks
    lshape = dict(zip(("M", "N", "K"), lookup_shape), dtype="float32")
    res = lookup_resolved(GEMM, lshape, profile=profile, policy="transfer",
                          transfer=False, predictor=model,
                          cache=TuningCache(os.path.join(tmp, "empty.json")))
    a, b = inputs(lookup_shape, "float32", False, device, seed=7)
    before = dict(LAUNCHES)
    out = matmul(a, b, config=res.config)
    sync(device)
    launched = sum(LAUNCHES.values()) - sum(before.values())
    oracle = gemm_reference(a, b)
    fn = make_matmul(*lookup_shape, res.config)
    runs = time_in_turns({"predicted": lambda: fn(a, b),
                          "library": lambda: torch.matmul(a, b)}, device)
    record["lookup"] = {
        "shape": list(lookup_shape), "provenance": res.provenance,
        "predictor": res.predictor, "config": res.config,
        "launches": launched, "err_oracle": max_err(out, oracle),
        "share_oracle": tol_share(out, oracle, MAIN_TOL, MAIN_TOL),
        "ms": float(np.median(runs["predicted"])),
        "library_ms": float(np.median(runs["library"]))}
    record["launches"] = read_counts()
    print("[predict] " + json.dumps(record))
    if device.type == "cuda":
        _check_launched(record["launches"], ["gemm_scratch", "gemm_inplace"],
                        "[predict]")
    if res.provenance != "predicted":
        raise AssertionError(f"the predicted lookup gave {res}")
    shares = [r["share_oracle"] for r in record["searches"].values()]
    if max(shares + [record["lookup"]["share_oracle"]]) > 1.0:
        raise AssertionError("a [predict] config disagrees with torch.matmul")
    if device.type == "cuda" and launched != 1:
        raise AssertionError("matmul() did not launch the predicted config")
    return record


# ---------------------------------------------------------------------------
# conv2d in bfloat16, the searches' samples, the distributed tuning plane and
# online retuning
# ---------------------------------------------------------------------------

#: most a search's sample of its winner may differ from the winner's
#: back-to-back time (PERF.md section 2, set before the first run measured it)
WALLCLOCK_GAP = 0.10
#: most the 1-worker and 4-worker winners' back-to-back times may differ
DTUNE_TIE = 0.05


def phase_conv_bf16(cases, fns, big, device, timed):
    """Every conv sweep case with bfloat16 operands (the tensor-core
    build) against conv2d_plain by conv_bf16_agreement, and against the
    float32 oracle of the same (rounded) inputs at BF16_TOL; then the
    bfloat16 kernel at each ``timed`` (label, config, (H, W, Fh, Fw)) main
    shape beside conv2d_plain, ``F.conv2d`` in bfloat16 and its bound
    (:func:`conv_bf16_bound`), the versions in turns.  A case that fails
    or cannot be timed fails the phase."""
    rows = []
    for name, cfg, hw, filt, weight in cases:
        for size in (hw, big):
            fn = fns[(name, size)]
            img, f = (x.bfloat16() for x in conv_inputs(*size, *filt, device))
            out = fn(img, f)
            sync(device)
            plain = cv.conv2d_plain(img, f, fn.config, weight)
            oracle = cv.conv2d_reference(img.float(), f.float(), weight)
            row = {"case": name, "config": fn.config, "shape": list(size),
                   "filter": list(filt), "weight": weight,
                   "route": fn.route, "dtype": str(out.dtype),
                   "finite": bool(torch.isfinite(out.float()).all()),
                   "err_plain": max_err(out, plain),
                   "err_oracle": max_err(out, oracle),
                   "share_oracle": tol_share(out, oracle, BF16_TOL,
                                             BF16_TOL),
                   "tol": [BF16_TOL, BF16_TOL],
                   "tol_plain": [CONV_BF16_ATOL, CONV_BF16_RTOL,
                                 CONV_BF16_DIFFER]}
            # the oracle keeps BF16_TOL; the plain version rounds the same
            # float32 sum once, so it is held much closer
            row["share_plain"], row["differ_plain"] = conv_bf16_agreement(
                out, plain)
            if out.dtype != torch.bfloat16:
                raise AssertionError(f"conv2d returned {out.dtype}: {row}")
            rows.append(row)
            _check_row(row, "conv", tag="conv-bf16",
                       differ=CONV_BF16_DIFFER)
    times = [_time_conv_bf16(label, cfg, size, device)
             for label, cfg, size in timed]
    return {"rows": rows, "times": times}


def _time_conv_bf16(label, cfg, size, device, tag="[conv-bf16-times]"):
    """The bfloat16 kernel of ``cfg`` at ``size`` beside conv2d_plain and
    F.conv2d in bfloat16 (CUDA events, in turns) and its bound; held to
    conv2d_plain (conv_bf16_agreement) and F.conv2d (BF16_TOL).  It uses
    only what the parent tree's package has too, so ``--times-bf16`` runs
    it from a copy of this script there."""
    H, W, Fh, Fw = size
    fn = cv.make_conv2d(H, W, Fh, Fw, cfg, dtype=torch.bfloat16)
    img, f = (x.bfloat16() for x in conv_inputs(*size, device, seed=2))

    def library():
        return F.conv2d(img[None, None], f[None, None],
                        padding=(Fh // 2, Fw // 2))

    rec = _time_case(fn, (img, f), lambda: cv.conv2d_plain(img, f, fn.config),
                     library, device, iters=50, plain_iters=3)
    out, lib = fn(img, f), library()[0, 0]
    rec["bound_ms"], rec["bound_by"] = conv_bf16_bound(H, W, Fh, Fw)
    rec.update(label=label, shape=list(size),
               share_of_bound=rec["bound_ms"] / rec["ms"],
               err_library=max_err(out, lib),
               share_library=tol_share(out, lib, BF16_TOL, BF16_TOL))
    rec["share_plain"], rec["differ_plain"] = conv_bf16_agreement(
        out, cv.conv2d_plain(img, f, fn.config))
    print(f"{tag} " + json.dumps(
        {k: v for k, v in rec.items() if not k.endswith("_runs")}))
    if (out.dtype != torch.bfloat16 or not rec["share_library"] <= 1.0
            or rec["share_plain"] > 1.0
            or rec["differ_plain"] > CONV_BF16_DIFFER):
        raise AssertionError(f"bf16 conv against F.conv2d or "
                             f"conv2d_plain: {rec}")
    return rec


def conv_bf16_bound(H, W, Fh, Fw):
    """(ms, "bytes" or "operations"): the least time of a bfloat16 conv of
    an (H, W) image by an (Fh, Fw) filter: its bytes at bfloat16 width
    (image and filter read once, the output written once) over the HBM
    rate, or its footnote-2 operations at the card's bfloat16 rate, the
    larger.  The products the band's zeros add are no work of the
    function; they are a cause of the kernel's time, not a bound."""
    return _bound(cv.conv_flops(H, W, Fh, Fw), 2.0 * (2 * H * W + Fh * Fw),
                  peak=H100_SXM.peak_bf16_tensor_flops)


def phase_wallclock_gap(main_path, device):
    """Each search winner's sample in its search (the median of the
    evaluator's samples) against its back-to-back time on the same inputs
    (the evaluator's, seed 0): how far the search reads off the card."""
    rows = []
    for kernel, rec, shape in main_path:
        fn = kernel.build(shape, rec["winner"])
        args = tuple(torch.as_tensor(x).to(device) for x in
                     kernel.make_args(shape, np.random.default_rng(0)))
        runs = time_in_turns({"winner": lambda: fn(*args)}, device)["winner"]
        b2b = float(np.median(runs))
        rows.append({"kernel": kernel.name, "winner": rec["winner"],
                     "search_ms": rec["winner_ms"], "back_to_back_ms": b2b,
                     "back_to_back_runs": runs,
                     "gap": rec["winner_ms"] / b2b - 1.0})
    record = {"limit": WALLCLOCK_GAP, "rows": rows}
    print("[wallclock-gap] " + json.dumps(record))
    if device.type == "cuda":
        over = [r for r in rows if abs(r["gap"]) > WALLCLOCK_GAP]
        if over:
            raise AssertionError(f"search samples off the card: {over}")
    return record


def _strided_configs(space, shard):
    """The configs a strided shard's full search visits, in order."""
    strat = make_strategy(shard.strategy, **shard.strategy_kwargs)
    res = strat.run(space, lambda cfg: 1.0, budget=shard.budget)
    return [dict(t.config) for t in res.trials]


def _gemm_library(M, N, K, cfg):
    """The library build.build makes for a float32 GEMM config."""
    fn = make_matmul(M, N, K, cfg)
    return build.library_path(mm_kernel.BUILD_NAME, build.digest(
        mm_kernel.SOURCE, mm_kernel._defines(fn.config, fn.dtype)))


def _drop_libraries(libs):
    """Delete libraries (and their logs and locks) so they build cold."""
    dropped = 0
    for lib in set(libs):
        for path in (lib, lib[:-3] + ".log", lib[:-3] + ".lock"):
            if os.path.exists(path):
                os.unlink(path)
                dropped += path == lib
    return dropped


def _builds_since(n_before):
    """(nvcc seconds, libraries built, libraries built more than once) of
    the build log's lines after the first ``n_before``."""
    lines = build.read_build_log()[n_before:]
    names = [r["library"] for r in lines]
    twice = sorted({n for n in names if names.count(n) > 1})
    return sum(r["s"] for r in lines), len(names), twice, len(
        {r["pid"] for r in lines})


def _dtune_run(shape, n, mode, driver, budget, evaluator, profile, cache,
               device):
    n_log = len(build.read_build_log())
    t0 = time.perf_counter()
    out = tune_kernel_distributed(
        GEMM, shape, n_workers=n, mode=mode, driver=driver, budget=budget,
        evaluator=evaluator, profile=profile, cache=cache,
        device=None if device.type == "cuda" else "cpu",
        engine={"workers": 1}, timeout_s=900)
    wall = time.perf_counter() - t0
    nvcc_s, built, twice, builders = _builds_since(n_log)
    return out, {
        "workers": n, "mode": mode, "driver": driver, "budget": budget,
        "wall_s": wall, "nvcc_s": nvcc_s, "libraries_built": built,
        "built_twice": twice, "building_processes": builders,
        "evaluations": [w.evaluations for w in out.workers],
        "status": [w.status for w in out.workers],
        "failed_trials": [w.failures for w in out.workers],
        "worker_compile_s": [(w.engine_stats or {}).get("compile_total_s")
                             for w in out.workers],
        "worker_launches": [w.launches for w in out.workers],
        "winner": out.best_config, "winner_search_ms": out.best_time * 1e3}


def phase_dtune(main_shape, device, tmp, n_configs=32, fleet=4):
    """The distributed tuning plane on the card: a strided full search over
    the first ``n_configs`` points of the compact GEMM space, cold, with 1
    worker and with ``fleet`` workers (process driver), then an islands
    search on the thread driver."""
    M, N, K = main_shape
    shape = {"M": M, "N": N, "K": K}
    profile = device_profile(device)
    space = GEMM.make_space(shape)
    first = space.enumerate(n_configs)
    evaluator = {"name": "wallclock", "atol": MAIN_TOL, "rtol": MAIN_TOL}
    record = {"space": space.cardinality(), "configs": n_configs, "runs": {}}
    outs = {}
    for n in (1, fleet):
        budget = n_configs // n
        shards = shard_space(space, n, "strided", budget=budget)
        picked = [c for sh in shards for c in _strided_configs(space, sh)]
        if sorted(map(space.config_key, picked)) != sorted(
                map(space.config_key, first)):
            raise AssertionError(f"{n} strided shards do not cover the "
                                 f"first {n_configs} configs")
        dropped = _drop_libraries(_gemm_library(M, N, K, c) for c in picked)
        outs[n], rec = _dtune_run(
            shape, n, "strided", "process", budget, evaluator, profile,
            TuningCache(os.path.join(tmp, f"dtune-{n}.json")), device)
        rec["libraries_dropped"] = dropped
        record["runs"][f"{n}w"] = rec
        print(f"[dtune] {n} worker(s): " + json.dumps(rec))
    # the two winners back to back, in turns
    a, b = inputs(main_shape, "float32", False, device, seed=9)
    fns = {f"{n}w": make_matmul(M, N, K, outs[n].best_config)
           for n in (1, fleet)}
    runs = time_in_turns({k: (lambda fn=fn: fn(a, b))
                          for k, fn in fns.items()}, device)
    winner_ms = {k: float(np.median(r)) for k, r in runs.items()}
    record["winner_ms"] = winner_ms
    record["winner_ratio"] = winner_ms[f"{fleet}w"] / winner_ms["1w"]
    # islands: the whole space, configs repeat across workers; warm
    # libraries, warm start from the fleet's cache
    zero_counts()
    _, rec = _dtune_run(shape, fleet, "islands", "thread", n_configs // fleet,
                        evaluator, profile,
                        TuningCache(os.path.join(tmp, f"dtune-{fleet}.json")),
                        device)
    rec["launches"] = read_counts()
    record["runs"]["islands"] = rec
    print(f"[dtune] islands: " + json.dumps(rec))
    print("[dtune] " + json.dumps({k: v for k, v in record.items()
                                   if k != "runs"}))
    for key, r in record["runs"].items():
        if r["built_twice"]:
            raise AssertionError(f"[dtune] {key}: libraries built twice: "
                                 f"{r['built_twice']}")
        if key != "islands" and (
                set(r["status"]) != {"ok"} or any(r["failed_trials"])
                or r["evaluations"] != [r["budget"]] * r["workers"]):
            raise AssertionError(f"[dtune] {key} did not measure the "
                                 f"{n_configs} configs: {r}")
    if set(record["runs"]["islands"]["status"]) - {"ok"}:
        raise AssertionError(f"[dtune] an island failed: {record}")
    if device.type == "cuda":
        # the process runs' GEMM launches happen in the spawned workers:
        # each worker counts its own
        for key in ("1w", f"{fleet}w"):
            for i, counts in enumerate(record["runs"][key]["worker_launches"]):
                _check_launched(counts, ["gemm_scratch", "gemm_inplace"],
                                f"[dtune] {key} worker {i}")
        _check_launched(record["runs"]["islands"]["launches"],
                        ["gemm_scratch", "gemm_inplace"], "[dtune] islands")
        if abs(record["winner_ratio"] - 1.0) > DTUNE_TIE:
            raise AssertionError(f"[dtune] the winners differ by more than "
                                 f"{DTUNE_TIE:.0%}: {winner_ms}")
    return record


def phase_online(shape3, device, tmp, budget=8, timeout_s=600.0):
    """A BackgroundTuner retunes a GEMM shape no other phase tunes while
    the main thread serves matmul() calls from the ConfigSlot."""
    M, N, K = shape3
    shape = {"M": M, "N": N, "K": K, "dtype": "float32"}
    profile = device_profile(device)
    cache = TuningCache(os.path.join(tmp, "online.json"))
    res = lookup_resolved(GEMM, shape, profile=profile, cache=cache,
                          policy="transfer")
    slot = ConfigSlot({GEMM.name: res.config})
    key = GEMM.key_for(shape)

    def on_change(cache_key, entry):
        kernel, entry_key = split_key(cache_key)[:2]
        if kernel == GEMM.name and entry_key == key:
            slot.swap(GEMM.name, entry.config)

    cache.subscribe(on_change)
    dev = None if device.type == "cuda" else "cpu"
    # warm-started: the served heuristic config is the search's first
    # point, so a config swaps in only where one measured faster
    tuner = BackgroundTuner(
        cache=cache, profile=profile, config=OnlineTuneConfig(
            strategy="annealing", budget=budget, device=dev,
            evaluator_factory=lambda k, s, p: WallClockEvaluator(
                atol=MAIN_TOL, rtol=MAIN_TOL, device=device)))
    a, b = inputs(shape3, "float32", False, device, seed=8)
    oracle = gemm_reference(a, b)
    served = {0: 0}
    worst = {0: 0.0}

    def serve():
        configs, gen = slot.read()
        out = matmul(a, b, config=configs[GEMM.name])
        sync(device)
        served[gen] = served.get(gen, 0) + 1
        worst[gen] = max(worst.get(gen, 0.0),
                         tol_share(out, oracle, MAIN_TOL, MAIN_TOL))

    zero_counts()
    t0 = time.perf_counter()
    try:
        job = submit_for_resolutions(tuner, {GEMM.name: res})[GEMM.name]
        while (job.status in (JobStatus.PENDING, JobStatus.RUNNING)
               and time.perf_counter() - t0 < timeout_s):
            serve()
        while_tuning = sum(served.values())
        tuner.wait(timeout=timeout_s)
        for _ in range(5):                       # after the swap
            serve()
    finally:
        tuner.close()
        cache.unsubscribe(on_change)
    tune_s = time.perf_counter() - t0
    launches = read_counts()
    new, gen = slot.read()
    fns = {"old": make_matmul(M, N, K, res.config),
           "new": make_matmul(M, N, K, new[GEMM.name])}
    runs = time_in_turns({k: (lambda fn=fn: fn(a, b))
                          for k, fn in fns.items()}, device)
    record = {
        "shape": list(shape3), "provenance": res.provenance,
        "old_config": res.config, "new_config": new[GEMM.name],
        "generation": gen, "job_status": job.status.value,
        "job_error": job.error, "job_evaluations": job.evaluations,
        "job_best_ms": (job.best_time or math.nan) * 1e3,
        "calls_while_tuning": while_tuning, "calls_by_generation": served,
        "worst_share_by_generation": worst, "wall_s": tune_s,
        "old_ms": float(np.median(runs["old"])),
        "new_ms": float(np.median(runs["new"])), "runs": runs,
        "launches": launches}
    print("[online] " + json.dumps({k: v for k, v in record.items()
                                    if k != "runs"}))
    if res.provenance not in ("predicted", "heuristic"):
        raise AssertionError(f"[online] the lookup gave {res}")
    if job.status is not JobStatus.DONE:
        raise AssertionError(f"[online] the retune failed: {record}")
    if max(worst.values()) > 1.0:
        raise AssertionError(f"[online] a served result disagrees: {record}")
    # on the CPU the plain versions' times barely depend on the blocks, so
    # the heuristic may win and the swap be a no-op there
    if device.type == "cuda" and (gen != 1 or served.get(1, 0) == 0):
        raise AssertionError(f"[online] the retune did not swap once, or "
                             f"nothing ran after the swap: {record}")
    if device.type == "cuda":
        _check_launched(launches, ["gemm_scratch", "gemm_inplace"],
                        "[online]")
    return record


# ---------------------------------------------------------------------------
# the serve path: granite-3-2b through the models, the serve step, the
# engine and its launcher
# ---------------------------------------------------------------------------

#: float32 decode against forward: tests/test_models_math.py's bound
SERVE_PARITY_TOL = 1e-4
#: bf16 decode against float32 on the same weights, |d| / max|f32 logit|:
#: about twice the JAX package's own drift at full width and 40 layers
#: (3.3-4.0 % over 6 decode steps at 4 slots, measured on the CPU)
SERVE_BF16_TOL = 8e-2
#: the same for the SSM families (ssm, hybrid): twice the JAX package's own
#: drift at mamba2-130m's published config over the same 6 steps at 4 slots
#: (21.1 %; the port's 24.8 % on the same weights, CPU,
#: tests/test_torch_families.py::test_ssm_bf16_drift_follows_the_jax_packages):
#: bf16 rounding grows through the SSD recurrences far beyond 8e-2
SERVE_SSM_BF16_TOL = 0.42
#: the launcher's defaults (the JAX package's): requests, slots, new
#: tokens, positions
SERVE_TRAFFIC = (8, 4, 16, 256)
#: the offline engine's decode step that one torch.profiler trace covers
PROFILED_STEP = 5


def _rel_err(x, ref):
    """Largest |x - ref| / max|ref|."""
    x, ref = x.double(), ref.double()
    return ((x - ref).abs().max() / ref.abs().max()).item()


def _decode_steps(cfg, params, toks, device):
    """Logits of one decode step a column of ``toks`` (slots, n), from a
    zero cache."""
    cache = init_cache(cfg, toks.shape[0], toks.shape[1], device)
    out = []
    for pos in range(toks.shape[1]):
        lg, cache = decode_step(cfg, params, cache, toks[:, pos:pos + 1], pos)
        out.append(lg)
    return out


def _upcast_in_place(tree, device):
    """Every leaf of ``tree`` to float32, one at a time, each bf16 leaf freed
    before the next: the bf16 and float32 trees need not fit together."""
    for k in list(tree):            # keys only: no list holds the leaves
        if isinstance(tree[k], dict):
            _upcast_in_place(tree[k], device)
        elif tree[k].dtype != torch.float32:
            tree[k] = tree[k].float()
            if device.type == "cuda":
                torch.cuda.empty_cache()


def _serve_parity(cfg, params, device, rng, in_place=False):
    """bf16 decode against float32 over 6 decode steps at 4 slots, then
    float32 decode against forward (2, 32), TF32 off.  The float32 tree is
    a copy of ``params``, or with ``in_place`` ``params`` itself upcast
    leaf by leaf after the bf16 steps.  MoE models run the float32 checks
    at capacity factor 8: forward's capacity is per sequence and may drop
    tokens, one-token decode never does (tests/test_models_math.py)."""
    cfg32 = dataclasses.replace(
        cfg, param_dtype="float32",
        capacity_factor=8.0 if cfg.is_moe else cfg.capacity_factor)
    B, S = 2, 32
    full_toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)).to(device)
    slots, n = SERVE_TRAFFIC[1], 6
    step_toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (slots, n)).astype(np.int32)).to(device)
    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            lg16 = _decode_steps(cfg, params, step_toks, device)
            if in_place:
                _upcast_in_place(params, device)
                params32 = params
            else:
                params32 = tree_map(lambda t: t.float(), params)
            full, _ = forward(cfg32, params32, {"tokens": full_toks})
            parity = _rel_err(torch.stack(
                _decode_steps(cfg32, params32, full_toks, device), dim=1),
                full)
            del full
            drift, agree = [], 0
            for a, b in zip(lg16, _decode_steps(cfg32, params32, step_toks,
                                                device)):
                drift.append(_rel_err(a, b))
                agree += int((a.argmax(-1) == b.argmax(-1)).sum())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old_tf32
    return {"decode_vs_forward_f32": parity, "bf16_vs_f32_by_step": drift,
            "bf16_vs_f32": max(drift), "top1_agree": agree,
            "top1_rows": slots * n}


def _profiled_step(at, device):
    """(state, on_step): an ``on_step`` hook that traces decode step ``at``
    alone with torch.profiler (the trace lands in ``state["prof"]``)."""
    from torch.profiler import ProfilerActivity, profile
    state = {}

    def on_step(eng, step):
        if step == at:
            state["prof"] = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
            state["prof"].__enter__()
        elif step == at + 1 and "prof" in state:
            sync(device)
            state["prof"].__exit__(None, None, None)
            state["done"] = True
    return state, on_step


def _device_ops(prof):
    """(kernels, copies, device us) of the CUDA activities in a trace."""
    kernels = copies = 0
    us = 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if e.name.startswith(("Memcpy", "Memset")):
            copies += 1
        else:
            kernels += 1
        us += e.time_range.elapsed_us()
    return kernels, copies, us


def _serve_rounds(engine, cfg, rounds, on_step=None, what="[serve]"):
    """Serve the launcher's traffic ``rounds`` times; each round's outputs
    by request id."""
    n, _, new, _ = SERVE_TRAFFIC
    out = []
    for _ in range(rounds):
        for req in serve_launcher.make_requests(cfg, n, new, seed=0):
            engine.submit(req)
        done = engine.run(on_step=on_step)
        if len(done) != n or any(not r.done or len(r.output) != new
                                 for r in done):
            got = [(r.rid, r.done, len(r.output)) for r in done]
            raise AssertionError(f"{what} a request did not finish with "
                                 f"{new} tokens: {got}")
        out.append({r.rid: r.output for r in done})
    return out


def _served_model(cfg, device, what):
    """(params, record): random weights for ``cfg`` from a seeded generator
    on ``device``, their count held to the model's tree, and the time
    reading them once takes at the card's memory rate."""
    t0 = time.perf_counter()
    params = init_model(cfg, torch.Generator(device=device).manual_seed(0),
                        device)
    sync(device)
    leaves = tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    weight_bytes = sum(t.numel() * t.element_size() for t in leaves)
    if n_params != count_params(model_defs(cfg)):
        raise AssertionError(f"{what} {n_params} parameters, the model's "
                             f"tree has {count_params(model_defs(cfg))}")
    return params, {"config": cfg.name, "layers": cfg.num_layers,
                    "params": n_params, "weight_bytes": weight_bytes,
                    "dtype": cfg.param_dtype,
                    "init_s": time.perf_counter() - t0,
                    "weight_read_bound_ms":
                        weight_bytes / H100_SXM.hbm_bw * 1e3}


def _check_parity(record, bf16_limit, what):
    if record["decode_vs_forward_f32"] > SERVE_PARITY_TOL:
        raise AssertionError(f"{what} float32 decode is "
                             f"{record['decode_vs_forward_f32']:.3g} from "
                             f"forward (limit {SERVE_PARITY_TOL})")
    if record["bf16_vs_f32"] > bf16_limit:
        raise AssertionError(f"{what} bf16 decode is "
                             f"{record['bf16_vs_f32']:.3g} from float32 "
                             f"(limit {bf16_limit})")


def _timed_rounds(engine, cfg, rounds, device, bound_ms, what):
    """Serve the launcher's traffic ``rounds`` times on a fresh ``engine``:
    (outputs, record).  The step's ms from CUDA events at each step
    boundary (step PROFILED_STEP is traced, so it and the next, the
    trace's start and end, are not timed), tokens/s on the host clock, the
    share of the weight-read bound, and from the traced step the device
    kernels and the card's busy share."""
    events = []
    state, profile_step = _profiled_step(PROFILED_STEP, device)

    def on_step(eng, step):
        if device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((step, ev))
            profile_step(eng, step)
        else:
            events.append((step, time.perf_counter()))

    sync(device)
    t0 = time.perf_counter()
    out = _serve_rounds(engine, cfg, rounds, on_step, what)
    sync(device)
    wall = time.perf_counter() - t0
    steps = engine.steps_total
    if device.type == "cuda":
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        end.synchronize()
        events.append((steps, end))
        elapsed = lambda a, b: a.elapsed_time(b)  # noqa: E731
    else:
        events.append((steps, time.perf_counter()))
        elapsed = lambda a, b: (b - a) * 1e3  # noqa: E731
    step_ms = [elapsed(a, b) for (i, a), (j, b) in zip(events, events[1:])
               if j == i + 1 and i not in (PROFILED_STEP, PROFILED_STEP + 1)]
    tokens = sum(len(o) for r in out for o in r.values())
    med = float(np.median(step_ms))
    record = {"offline_steps": steps, "tokens": tokens, "wall_s": wall,
              "tokens_per_s": tokens / wall, "step_ms_median": med,
              "step_ms_p10_p90": [float(np.percentile(step_ms, 10)),
                                  float(np.percentile(step_ms, 90))],
              "bound_share": bound_ms / med}
    if device.type == "cuda":
        if not state.get("done"):
            raise AssertionError(f"{what} the profiled step did not end")
        kernels, copies, us = _device_ops(state["prof"])
        if not kernels:
            raise AssertionError(f"{what} the profiled step shows no "
                                 f"device kernel")
        record.update({"kernels_per_step": kernels,
                       "copies_per_step": copies,
                       "device_ms_per_step": us / 1e3,
                       "device_busy_share": us / 1e3 / med,
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
    return out, record


def phase_serve(device, tmp, full, timeout_s=600.0):
    """granite-3-2b on the serve path: parity of decode with forward and of
    bf16 with float32, the launcher, an engine's step time, and an engine
    whose flash config is retuned on the card while it serves."""
    cfg = get_model_config("granite-3-2b", smoke=not full)
    n_req, slots, new, max_len = SERVE_TRAFFIC
    params, record = _served_model(cfg, device, "[serve]")
    bound_ms = record["weight_read_bound_ms"]

    record.update(_serve_parity(cfg, params, device,
                                np.random.default_rng(0)))
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    launched = serve_launcher.main(
        (["--full"] if full else []) + [
            "--requests", str(n_req), "--slots", str(slots),
            "--max-new-tokens", str(new), "--max-len", str(max_len),
            "--device", device.type])
    record["launcher_s"] = time.perf_counter() - t0
    record["launcher_tokens"] = [len(r.output) for r in launched]
    if len(launched) != n_req or any(len(r.output) != new or not r.done
                                     for r in launched):
        raise AssertionError(f"[serve] the launcher served {record}")
    del launched
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # online: the engine's flash config is retuned on the card (wall clock)
    # while it serves; the gemm job has no feasible point at (slots, V, d).
    # The flash job measures the first four points of its space in order,
    # none of them the served heuristic, so its winner always swaps in:
    # this checks the swap, not the search (warm-started annealing kept
    # the heuristic on the card, so its swap was a no-op)
    def evaluator(k, shape, profile):
        tol = FLASH_TOL if k.name == fa.FLASH_ATTENTION.name else MAIN_TOL
        return WallClockEvaluator(atol=tol, rtol=tol, device=device)

    knobs = OnlineTuneConfig(strategy="full", budget=4, warm_start=False,
                             evaluator_factory=evaluator)
    zero_counts()
    t0 = time.perf_counter()
    with ServeEngine(cfg, params, slots=slots, max_len=max_len,
                     cache=TuningCache(os.path.join(tmp, "serve.json")),
                     online_tune=knobs) as online:
        resolutions = {n: {"key": r.key, "provenance": r.provenance,
                           "config": r.config}
                       for n, r in online.kernel_resolutions.items()}
        online_out = []
        while (any(j.status in (JobStatus.PENDING, JobStatus.RUNNING)
                   for j in online.tune_jobs.values())
               and time.perf_counter() - t0 < timeout_s):
            online_out += _serve_rounds(online, cfg, 1)
        online_out += _serve_rounds(online, cfg, 1)   # after the last swap
        jobs = {n: {"status": j.status.value, "error": j.error,
                    "config": j.config, "evaluations": j.evaluations}
                for n, j in online.tune_jobs.items()}
        swaps = list(online.swap_events)
        online_steps = online.steps_total
    launches = read_counts()
    record.update({"online_s": time.perf_counter() - t0,
                   "online_rounds": len(online_out),
                   "online_steps": online_steps, "resolutions": resolutions,
                   "jobs": jobs, "swap_events": swaps,
                   "launches": launches})

    # the same traffic on an offline engine: the tokens to hold the online
    # engine to, and the step time
    with ServeEngine(cfg, params, slots=slots, max_len=max_len,
                     cache=TuningCache(os.path.join(tmp, "serve0.json")),
                     online_tune=False) as offline:
        offline_out, timed = _timed_rounds(offline, cfg, len(online_out),
                                           device, bound_ms, "[serve]")
    record.update(timed)
    record["tokens_equal"] = offline_out == online_out
    print("[serve] " + json.dumps(record))

    _check_parity(record, SERVE_BF16_TOL, "[serve]")
    if not record["tokens_equal"]:
        raise AssertionError("[serve] the online engine's tokens differ "
                             "from the offline engine's")
    gemm = jobs.get("gemm", {})
    if gemm.get("status") != JobStatus.FAILED.value \
            or "no feasible" not in (gemm.get("error") or ""):
        raise AssertionError(f"[serve] the gemm job at (slots, vocab, "
                             f"d_model) did not fail as the JAX package's "
                             f"does: {gemm}")
    if jobs.get("flash_attention", {}).get("status") != JobStatus.DONE.value:
        raise AssertionError(f"[serve] the flash retune did not finish: "
                             f"{jobs}")
    # on the CPU the plain version's time barely depends on the blocks, so
    # the heuristic may win there and the swap be a no-op
    if device.type == "cuda":
        if not any("flash_attention" in ev["kernels"]
                   and ev["sources"].get("flash_attention") == "tuned"
                   for ev in swaps):
            raise AssertionError(f"[serve] no tuned flash swap: {swaps}")
        _check_launched(launches, ["flash_attention"], "[serve]")
    return record


#: [serve-families]: (architecture, changes to its config, served through
#: the launcher).  deepseek-v3 keeps its published widths and is cut in
#: depth, 61 -> 2 layers (one dense, one MoE: one layer of 256 experts is
#: 22.5 GB in bf16), and loses its MTP block, which only the loss reads
#: (11.6 G parameters); the launcher's --full would build all 671 B
#: parameters, so the engine serves it directly
SERVE_FAMILIES = (
    ("mamba2-130m", {}, True),
    ("zamba2-7b", {}, True),
    ("deepseek-v3-671b", {"num_layers": 2, "moe_first_dense": 1,
                          "mtp_depth": 0}, False))


def _serve_family(arch, changes, via_launcher, device, full):
    """One model of [serve-families]: random bf16 weights from a seeded
    generator on the card; the launcher's traffic through the launcher
    (where it can build the model) and through a ServeEngine, timed and
    traced; the engine's resolutions; then bf16 against float32 and
    float32 decode against forward on the same weights, upcast in place."""
    what = f"[serve-families] {arch}:"
    cfg = dataclasses.replace(get_model_config(arch, smoke=not full),
                              **changes)
    n_req, slots, new, max_len = SERVE_TRAFFIC
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    params, record = _served_model(cfg, device, what)
    record["changes"] = changes
    bound_ms = record["weight_read_bound_ms"]

    launched = None
    if via_launcher:
        t0 = time.perf_counter()
        done = serve_launcher.main(
            ["--arch", arch] + (["--full"] if full else []) + [
                "--requests", str(n_req), "--slots", str(slots),
                "--max-new-tokens", str(new), "--max-len", str(max_len),
                "--device", device.type])
        record["launcher_s"] = time.perf_counter() - t0
        launched = {r.rid: r.output for r in done if r.done}
        if len(launched) != n_req or any(len(o) != new
                                         for o in launched.values()):
            raise AssertionError(f"{what} the launcher served {launched}")
        del done
        if device.type == "cuda":
            torch.cuda.empty_cache()

    # the launcher's tuning cache, so both engines resolve alike
    with ServeEngine(cfg, params, slots=slots, max_len=max_len,
                     online_tune=False) as engine:
        record["resolutions"] = {
            n: {"key": r.key, "provenance": r.provenance,
                "config": r.config}
            for n, r in engine.kernel_resolutions.items()}
        record["head_chunk"] = apply_kernel_configs(cfg, RunConfig(), {
            n: r["config"] for n, r in record["resolutions"].items()
        }).head_chunk
        out, timed = _timed_rounds(engine, cfg, 1, device, bound_ms, what)
    del engine
    record.update(timed)
    record["served"] = {rid: len(o) for rid, o in out[0].items()}
    if launched is not None:
        record["tokens_equal_launcher"] = out[0] == launched

    record.update(_serve_parity(cfg, params, device,
                                np.random.default_rng(0), in_place=True))
    del params
    if device.type == "cuda":
        torch.cuda.empty_cache()
        record["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print("[serve-families] " + json.dumps(record))

    want = {"gemm"} | ({"flash_attention"} if cfg.num_heads else set())
    if set(record["resolutions"]) != want:
        raise AssertionError(f"{what} resolved {sorted(record['resolutions'])}"
                             f", the JAX engine resolves {sorted(want)}")
    _check_parity(record, SERVE_SSM_BF16_TOL if cfg.family in (
        "ssm", "hybrid") else SERVE_BF16_TOL, what)
    if launched is not None and not record["tokens_equal_launcher"]:
        raise AssertionError(f"{what} the engine's tokens differ from the "
                             f"launcher's on the same seeded weights")
    return record


def phase_serve_families(device, full):
    """mamba2-130m and zamba2-7b at their published configs and deepseek-v3
    at full width on the serve path, one after the other."""
    return [_serve_family(arch, changes, via_launcher, device, full)
            for arch, changes, via_launcher in SERVE_FAMILIES]


# ---------------------------------------------------------------------------
# [train]: the training path (loss_fn -> make_train_step -> Trainer)
# ---------------------------------------------------------------------------

#: part 2: the launcher's data (seq_len, global_batch), AdamW and steps
TRAIN_DATA = (256, 8)
TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=20)
TRAIN_STEPS = 20
#: part 2: the loss over its 20 steps must fall by at least this much
#: (nats; set before the first run on the card, PERF.md §6)
TRAIN_LOSS_DROP = 2.0
#: part 1, float32 with TF32 off: the loss's relative error and each
#: gradient leaf's error over its largest |value|, card against CPU
TRAIN_LOSS_TOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
#: part 3: each variant's loss against the default's, relative
#: (tests/test_models_smoke.py::test_run_config_variants)
TRAIN_VARIANT_TOL = 2e-3
#: part 4: resumed losses and parameters against the uninterrupted run's,
#: relative (tests/test_fault_tolerance.py)
TRAIN_RESUME_RTOL = 1e-5


def _grads(cfg, params, batch, run=None):
    """(loss, metrics, grads) of ``loss_fn`` on ``params``' leaves."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, metrics = loss_fn(cfg, live, batch, run or RunConfig())
    grads = torch.autograd.grad(loss, tree_leaves(live), allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), {k: v.item() for k, v in metrics.items()}, grads


def _train_batch(cfg, shape, device, seed):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)
                                .astype(np.int32)).to(device)
            for k in ("tokens", "labels")}


def _train_parity(device, full):
    """Part 1: loss_fn and its gradients on the card and on the CPU, the
    same float32 weights carried over by params_from_numpy, TF32 off."""
    cfg = dataclasses.replace(get_model_config("granite-3-2b",
                                               smoke=not full),
                              num_layers=2, param_dtype="float32")
    cpu = init_model(cfg, 0, "cpu")
    dev = params_from_numpy(tree_map(lambda t: t.numpy(), cpu), device)
    batch = _train_batch(cfg, (2, 64), "cpu", seed=0)
    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        l_cpu, _, g_cpu = _grads(cfg, cpu, batch)
        l_dev, _, g_dev = _grads(cfg, dev, {k: v.to(device)
                                            for k, v in batch.items()})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old_tf32
    rec = {"config": cfg.name, "layers": cfg.num_layers, "batch": [2, 64],
           "dtype": "float32", "loss_cpu": l_cpu.item(),
           "loss_card": l_dev.item(),
           "loss_rel_err": abs(l_dev.item() - l_cpu.item()) / abs(
               l_cpu.item()),
           "grad_rel_err": max(_rel_err(a.cpu(), b)
                               for a, b in zip(g_dev, g_cpu))}
    del cpu, dev, g_cpu, g_dev
    if rec["loss_rel_err"] > TRAIN_LOSS_TOL \
            or rec["grad_rel_err"] > TRAIN_GRAD_TOL:
        raise AssertionError(f"[train] card against CPU: {rec}")
    return rec


def train_bound_ms(cfg, tokens, seq_len, batch):
    """The least time one AdamW train step of ``cfg`` could take on the
    card: 6 FLOP a product's weight a token (not the embedding's gather,
    not the norm scales) plus attention's
    unmasked S^2 products (forward and backward) at the bf16 tensor-core
    rate, then the optimizer's bytes (bf16 parameters read and written,
    float32 moments read and written, bf16 gradients read twice: 24 B a
    parameter) at the memory rate.  ``(compute ms, optimizer ms)``."""
    n = count_params(model_defs(cfg))
    # the weights of products: every leaf of two or more dims besides the
    # stacked layer dim (norm scales and biases are not), but the
    # embedding, which is a gather
    matmul_params = sum(
        math.prod(d.shape) for d in tree_paths(model_defs(cfg)).values()
        if sum(a != "layers" for a in d.axes) >= 2) \
        - cfg.vocab_size * cfg.d_model
    attn = 12 * batch * cfg.num_heads * seq_len ** 2 \
        * cfg.resolved_head_dim * cfg.num_layers
    flops = 6 * matmul_params * tokens + attn
    opt_bytes = 24 * n
    return (flops / H100_SXM.peak_bf16_tensor_flops * 1e3,
            opt_bytes / H100_SXM.hbm_bw * 1e3)


def step_traffic(cfg, seq_len, batch):
    """What one eager train step of ``cfg`` asks of the card, counted on
    the ``meta`` device (no storage, no card): the operations that launch
    a kernel (views excluded) and the bytes they read and write, for the
    model's forward and backward and for the AdamW update."""
    from torch.utils._python_dispatch import TorchDispatchMode
    views = {"view", "_unsafe_view", "unbind", "t", "transpose", "expand",
             "slice", "select", "permute", "detach", "alias", "unsqueeze",
             "squeeze", "as_strided", "split", "lift_fresh"}

    def nbytes(x):
        if isinstance(x, torch.Tensor):
            return x.numel() * x.element_size()
        if isinstance(x, (list, tuple)):
            return sum(nbytes(y) for y in x)
        return 0

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = self.bytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket.__name__ not in views:
                self.ops += 1
                self.bytes += nbytes(args) + nbytes(out)
            return out

    params = abstract_model(cfg)
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    state = lambda: OptState(*abstract_state(OptimConfig(), params)[:2],
                             count=meta((), torch.int32))
    whole, opt = Count(), Count()
    with whole:
        make_train_step(cfg, opt_cfg=OptimConfig())(
            params, state(), {k: meta((batch, seq_len), torch.int32)
                              for k in ("tokens", "labels")})
    with opt:
        adamw_update_(OptimConfig(), tree_map(
            lambda p: meta(p.shape, p.dtype), params), state(), params)
    model = Count()
    model.ops, model.bytes = whole.ops - opt.ops, whole.bytes - opt.bytes
    return {"model_ops": model.ops, "model_gb": model.bytes / 1e9,
            "optimizer_ops": opt.ops, "optimizer_gb": opt.bytes / 1e9}


def _trainer(cfg, device, ckpt_dir, seq_len, batch, steps, ckpt_every,
             ckpt_async=True, seed=0, lr=TRAIN_OPT["lr"]):
    return Trainer(cfg, DataConfig(seq_len=seq_len, global_batch=batch,
                                   vocab_size=cfg.vocab_size, seed=seed),
                   TrainerConfig(total_steps=steps, ckpt_every=ckpt_every,
                                 ckpt_dir=ckpt_dir, ckpt_async=ckpt_async,
                                 log_every=10 ** 9),
                   opt_cfg=OptimConfig(**dict(TRAIN_OPT, total_steps=steps,
                                               lr=lr)),
                   device=device)


def _timed_steps(trainer, steps, device, profile_last):
    """Drive ``trainer`` one step at a time: the step's ms from CUDA events
    at each step boundary (host clock on the CPU), the last step traced by
    torch.profiler when ``profile_last``.  Returns (ms by step, trace)."""
    from torch.profiler import ProfilerActivity, profile
    ms, prof = [], None
    for i in range(steps):
        if profile_last and i == steps - 1 and device.type == "cuda":
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                trainer.train(steps=1)
                sync(device)
            continue
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            trainer.train(steps=1)          # ends in a host read
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            trainer.train(steps=1)
            ms.append((time.perf_counter() - t0) * 1e3)
    return ms, prof


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _train_full(device, tmp, full, ckpt_full):
    """Part 2: granite-3-2b at full depth, bf16, through Trainer; an async
    checkpoint at the last step when ``ckpt_full``.  Returns (trainer,
    record): the trainer is part 3's model."""
    cfg = get_model_config("granite-3-2b", smoke=not full)
    seq, gb = TRAIN_DATA if full else (32, 2)
    ckpt_dir = os.path.join(tmp, "train-full")
    trainer = _trainer(cfg, device, ckpt_dir, seq, gb, TRAIN_STEPS,
                       ckpt_every=10 ** 9)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    trainer.init_state()
    sync(device)
    resident = (torch.cuda.memory_allocated() if device.type == "cuda"
                else 0)
    t0 = time.perf_counter()
    ms, prof = _timed_steps(trainer, TRAIN_STEPS, device, profile_last=True)
    wall = time.perf_counter() - t0
    losses = [h["loss"] for h in trainer.history]
    med = float(np.median(ms[1:]))              # the first step warms up
    compute_ms, opt_ms = train_bound_ms(cfg, seq * gb, seq, gb)
    rec = {"config": cfg.name, "layers": cfg.num_layers,
           "params": count_params(model_defs(cfg)), "dtype": cfg.param_dtype,
           "seq_len": seq, "global_batch": gb, "steps": TRAIN_STEPS,
           "losses": losses, "step_ms": ms, "step_ms_median": med,
           "first_step_ms": ms[0], "wall_s": wall,
           "tokens_per_s": seq * gb / med * 1e3,
           "bound_ms": compute_ms + opt_ms, "bound_compute_ms": compute_ms,
           "bound_optimizer_ms": opt_ms,
           "bound_share": (compute_ms + opt_ms) / med,
           "resident_gib": resident / 2 ** 30,
           "traffic": step_traffic(cfg, seq, gb)}
    if device.type == "cuda":
        rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        kernels, copies, us = _device_ops(prof)
        rec.update({"kernels_per_step": kernels, "copies_per_step": copies,
                    "device_ms_per_step": us / 1e3,
                    "device_busy_share": us / 1e3 / med})
    if ckpt_full:
        t0 = time.perf_counter()
        trainer.save(block=False)
        rec["ckpt_host_s"] = time.perf_counter() - t0
        trainer.ckpt.wait()
        rec["ckpt_s"] = time.perf_counter() - t0
        rec["ckpt_bytes"] = _dir_bytes(trainer.ckpt._path(TRAIN_STEPS))
        t0 = time.perf_counter()
        rec["ckpt_verify"] = trainer.ckpt.verify(TRAIN_STEPS)
        rec["ckpt_verify_s"] = time.perf_counter() - t0
        rec["ckpt_step"] = trainer.ckpt.latest_step()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"[train] a loss is not finite: {losses}")
    # the margin is for the published config; a rehearsal's smoke config
    # need only fall
    min_drop = TRAIN_LOSS_DROP if full else 0.0
    if not losses[0] - losses[-1] > min_drop:
        raise AssertionError(f"[train] the loss fell {losses[0]:.4f} -> "
                             f"{losses[-1]:.4f}, not more than {min_drop}")
    if ckpt_full and not (rec["ckpt_verify"]
                          and rec["ckpt_step"] == TRAIN_STEPS):
        raise AssertionError(f"[train] the step-{TRAIN_STEPS} checkpoint "
                             f"did not verify: {rec}")
    return trainer, rec


def _peak(device):
    return (torch.cuda.max_memory_allocated() / 2 ** 30
            if device.type == "cuda" else None)


def _elapsed_ms(fn, device):
    """(fn's result, its ms): CUDA events on the card, else the host
    clock."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def _train_variants(trainer, device):
    """Part 3: on the first batch, loss_fn and its gradients under each
    RunConfig variant against the default: each variant's loss, peak
    memory and the memory held between its forward and backward passes
    (first call), and its ms (second call);
    then one microbatch=2 step through make_train_step, and the AdamW
    update alone (both update the trainer's state in place, so they come
    last)."""
    cfg = trainer.cfg
    batch = to_device(trainer.source.batch(0), device)
    out = {}
    for name, run in (("none", RunConfig()), ("full", RunConfig(remat="full")),
                      ("dots", RunConfig(remat="dots")),
                      ("ce_chunk=64", RunConfig(ce_chunk=64))):
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        live = tree_map(lambda t: t.detach().requires_grad_(True),
                         trainer.params)
        saved = {}

        def fwd_bwd():
            loss, _ = loss_fn(cfg, live, batch, run)
            # what the backward pass will read: the saved activations
            saved.setdefault("gib", torch.cuda.memory_allocated() / 2 ** 30
                             if device.type == "cuda" else 0.0)
            torch.autograd.grad(loss, tree_leaves(live), allow_unused=True,
                                materialize_grads=True)
            return loss.detach()

        loss = fwd_bwd()            # memory from a cold allocator cache
        peak = _peak(device)
        _, ms = _elapsed_ms(fwd_bwd, device)          # time warm
        del live
        out[name] = {"loss": loss.item(), "ms": ms, "peak_gib": peak,
                     "after_forward_gib": saved["gib"]}
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    (_, _, met), ms = _elapsed_ms(lambda: make_train_step(
        cfg, RunConfig(microbatch=2), trainer.opt_cfg)(
        trainer.params, trainer.opt_state, batch), device)
    out["microbatch=2"] = {"loss": met["loss"].item(), "ms": ms,
                           "peak_gib": _peak(device)}
    base = out["none"]["loss"]
    for name, v in out.items():
        v["rel_err"] = abs(v["loss"] - base) / abs(base)
    # the update alone, on zero gradients of the parameters' dtypes
    zeros = tree_map(torch.zeros_like, trainer.params)
    opt_ms = [_elapsed_ms(lambda: adamw_update_(
        trainer.opt_cfg, zeros, trainer.opt_state, trainer.params),
        device)[1] for _ in range(3)]
    del zeros
    rec = {"variants": out, "optimizer_ms": opt_ms}
    bad = {k: v for k, v in out.items() if v["rel_err"] > TRAIN_VARIANT_TOL}
    if bad:
        raise AssertionError(f"[train] variants off the default's loss "
                             f"(limit {TRAIN_VARIANT_TOL}): {bad}")
    if device.type == "cuda" and not (out["full"]["peak_gib"]
                                      < out["none"]["peak_gib"]):
        raise AssertionError(f"[train] remat='full' does not peak lower "
                             f"than 'none': {out}")
    return rec


def _train_resume_deterministic(device, tmp, full):
    """:func:`_train_resume` in a spawned process: deterministic cuBLAS is
    read when the process first calls it, so it is set before."""
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    return _train_resume(device, tmp, full)


def _train_resume(device, tmp, full):
    """Part 4: 8 steps at full width cut to 2 layers, checkpoints every 4,
    a crash at step 5, a fresh Trainer restores step 4 and resumes: its
    losses and final parameters against an uninterrupted run's, under
    torch.use_deterministic_algorithms."""
    cfg = dataclasses.replace(get_model_config("granite-3-2b",
                                               smoke=not full),
                              num_layers=2)
    seq, gb = TRAIN_DATA if full else (32, 2)
    mk = lambda tag: _trainer(cfg, device, os.path.join(tmp, tag), seq, gb,
                              8, ckpt_every=4, ckpt_async=False, seed=3)
    torch.use_deterministic_algorithms(True)
    try:
        ref = mk("train-ref")
        ref.init_state()
        ref.train()
        crash = mk("train-crash")
        crash.init_state()
        try:
            crash.train(simulate_failure_at=5)
            raise AssertionError("[train] the simulated failure did not "
                                 "happen")
        except RuntimeError as e:
            if "simulated node failure" not in str(e):
                raise
        del crash
        ckpt_bytes = _dir_bytes(os.path.join(tmp, "train-crash",
                                             "step_000004"))
        recov = mk("train-crash")
        t0 = time.perf_counter()
        restored = recov.try_restore()
        restore_s = time.perf_counter() - t0
        step = recov.step
        recov.train()
    finally:
        torch.use_deterministic_algorithms(False)
    ref_losses = [h["loss"] for h in ref.history][4:]
    rec_losses = [h["loss"] for h in recov.history]
    p_err = max(_rel_err(a, b) for a, b in zip(tree_leaves(recov.params),
                                              tree_leaves(ref.params)))
    rec = {"config": cfg.name, "layers": cfg.num_layers,
           "restored": restored, "restored_step": step,
           "ckpt_bytes": ckpt_bytes, "restore_s": restore_s,
           "losses_ref": ref_losses, "losses_resumed": rec_losses,
           "losses_equal": ref_losses == rec_losses,
           "params_rel_err": p_err,
           "params_bit_equal": all(torch.equal(a, b) for a, b in zip(
               tree_leaves(recov.params), tree_leaves(ref.params)))}
    for tag in ("train-ref", "train-crash"):
        shutil.rmtree(os.path.join(tmp, tag), ignore_errors=True)
    if not restored or step != 4 or len(rec_losses) != 4 \
            or not np.allclose(rec_losses, ref_losses,
                               rtol=TRAIN_RESUME_RTOL, atol=0) \
            or p_err > TRAIN_RESUME_RTOL:
        raise AssertionError(f"[train] the resumed run differs from the "
                             f"uninterrupted one: {rec}")
    return rec


def _train_launcher_and_mamba(device, tmp, full):
    """Part 5: the launcher trains granite-3-2b (--full on the card) 4
    steps; mamba2-130m at its published config trains 10 steps through
    Trainer."""
    args = ["--arch", "granite-3-2b", "--steps", "4", "--ckpt-every", "100",
            "--ckpt-dir", os.path.join(tmp, "train-launcher"),
            "--device", device.type] + (["--full"] if full else [
                "--seq-len", "32", "--global-batch", "2"])
    t0 = time.perf_counter()
    out = train_launcher.main(args)
    rec = {"launcher_s": time.perf_counter() - t0,
           "launcher_losses": [h["loss"] for h in out["history"]]}
    del out
    if device.type == "cuda":
        torch.cuda.empty_cache()
    cfg = get_model_config("mamba2-130m", smoke=not full)
    seq, gb = TRAIN_DATA if full else (32, 2)
    # the smoke config of a rehearsal learns nothing in 10 steps at 3e-4
    trainer = _trainer(cfg, device, os.path.join(tmp, "train-mamba"), seq,
                       gb, 10, ckpt_every=10 ** 9,
                       lr=TRAIN_OPT["lr"] if full else 1e-2)
    trainer.init_state()
    ms, _ = _timed_steps(trainer, 10, device, profile_last=False)
    losses = [h["loss"] for h in trainer.history]
    rec["mamba2"] = {"config": cfg.name, "layers": cfg.num_layers,
                     "seq_len": seq, "global_batch": gb, "losses": losses,
                     "step_ms": ms, "step_ms_median": float(np.median(ms[1:])),
                     "tokens_per_s": seq * gb / float(np.median(ms[1:]))
                     * 1e3}
    for tag in ("train-launcher", "train-mamba"):
        shutil.rmtree(os.path.join(tmp, tag), ignore_errors=True)
    if len(rec["launcher_losses"]) != 4 \
            or not all(np.isfinite(rec["launcher_losses"])):
        raise AssertionError(f"[train] the launcher's losses: {rec}")
    if not all(np.isfinite(losses)) \
            or not np.mean(losses[-3:]) < np.mean(losses[:3]):
        raise AssertionError(f"[train] mamba2-130m did not train: {losses}")
    return rec


def phase_train(device, tmp, full, ckpt_full=True):
    """The training path, five parts (PERF.md §6): card against CPU,
    granite-3-2b at full depth through Trainer, the RunConfig variants,
    crash and restore, the launcher and mamba2-130m.  No kernel of the
    four runs on it: their counts are read around the whole phase."""
    zero_counts()
    record = {}
    t0 = time.perf_counter()
    record["parity"] = _train_parity(device, full)
    print("[train] parity " + json.dumps(record["parity"]))
    trainer, record["full_depth"] = _train_full(device, tmp, full, ckpt_full)
    print("[train] full_depth " + json.dumps(record["full_depth"]))
    record["variants"] = _train_variants(trainer, device)
    print("[train] variants " + json.dumps(record["variants"]))
    del trainer
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # in a process of its own: deterministic cuBLAS caps its workspace,
    # which would slow every torch.matmul yardstick of this one
    record["resume"] = in_process(_train_resume_deterministic, device, tmp,
                                  full)
    print("[train] resume " + json.dumps(record["resume"]))
    record["launcher"] = _train_launcher_and_mamba(device, tmp, full)
    print("[train] launcher " + json.dumps(record["launcher"]))
    record["launches"] = read_counts()
    record["phase_s"] = time.perf_counter() - t0
    print("[train] " + json.dumps({k: record[k] for k in ("launches",
                                                          "phase_s")}))
    return record


def _bound(ops, nbytes, peak=H100_SXM.peak_f32_flops):
    t_ops = ops / peak
    t_bytes = nbytes / H100_SXM.hbm_bw
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _time_case(fn, args, plain, library, device, iters, plain_iters,
               extras=None):
    """Times of the kernel, its plain version, the library call and any
    ``extras`` (name -> call), each the median of its runs."""
    runs = time_in_turns({"kernel": lambda: fn(*args), "library": library,
                          **(extras or {})}, device, iters=iters)
    runs["plain"] = time_in_turns({"plain": plain}, device, rounds=3,
                                  iters=plain_iters)["plain"]
    rec = {"config": fn.config, "ptxas": ptxas_info(fn),
           "max_abs_err": max_err(fn(*args), plain())}
    for name, r in runs.items():
        key = "ms" if name == "kernel" else f"{name}_ms"
        rec[key], rec[key + "_runs"] = float(np.median(r)), r
    return rec


def phase_sdpa_route(S, D, device, dtype="float32"):
    """Names the CUDA kernels one F.scaled_dot_product_attention call (the
    flash yardstick, causal) in ``dtype`` launches, from one torch.profiler
    trace: which of PyTorch's routes the library time measures."""
    q, k, v = (x[None, None] for x in flash_inputs((), S, S, D, dtype,
                                                    device, seed=3))
    F.scaled_dot_product_attention(q, k, v, is_causal=True)   # warm-up
    sync(device)
    if device.type != "cuda":
        print("[sdpa-route] no card (rehearsal)")
        return []
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        F.scaled_dot_product_attention(q, k, v, is_causal=True)
        sync(device)
    # the device's own activities, as [serve] reads them: key_averages()
    # reads no device time under the card's PyTorch
    us = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not e.name.startswith(("Memcpy", "Memset")):
            us[e.name] = us.get(e.name, 0.0) + e.time_range.elapsed_us()
    kernels = [{"kernel": name, "device_us": t} for name, t in us.items()]
    print(f"[sdpa-route] F.scaled_dot_product_attention {dtype} "
          f"(1, 1, {S}, {D}) causal launched: " + json.dumps(kernels))
    if not any(t > 0 for t in us.values()):
        raise AssertionError("[sdpa-route] the trace holds no device time")
    return kernels


def conv_bf16_timed(main, big_shapes, winner):
    """(label, config, shape) of the bfloat16 conv's timed shapes: the
    bfloat16 search's ``winner`` at ``main``, the heuristic at each of
    ``big_shapes`` (what conv2d(config=None) resolves there)."""
    return ([("conv bf16 {}x{} {}x{}".format(*main), winner, main)]
            + [("conv bf16 {}x{} {}x{}".format(*size),
                cv.heuristic_config(*size), size) for size in big_shapes])


def conv_large_configs():
    """The [conv-large] sweep: SUB_H x BLOCK_H at BLOCK_W 256; the first
    is the heuristic config (SUB_H 1, 16 x 256)."""
    return [dict(cv.heuristic_config(8192, 4096, 11, 11), SUB_H=sub,
                 BLOCK_H=bh) for sub in (1, 2, 4, 8) for bh in (16, 32)]


def phase_conv_large(fns, size, device):
    """Each [conv-large] config against the oracle (CONV_TOL) and timed,
    the configs taking turns; the heuristic config is one of them."""
    H, W, Fh, Fw = size
    img, f = conv_inputs(*size, device, seed=2)
    oracle = cv.conv2d_reference(img, f)
    runs = time_in_turns({i: (lambda fn=fn: fn(img, f))
                          for i, fn in enumerate(fns)}, device, rounds=3,
                         iters=20)
    bound_ms, bound_by = _bound(cv.conv_flops(H, W, Fh, Fw),
                                4.0 * (2 * H * W + Fh * Fw))
    rows = []
    for i, fn in enumerate(fns):
        out = fn(img, f)
        sync(device)
        row = {"config": fn.config,
               "finite": bool(torch.isfinite(out).all()),
               "micro_tile": cv.micro_tile(fn.config, Fh, Fw),
               "threads": cv.block_threads(fn.config),
               "ms": float(np.median(runs[i])), "ms_runs": runs[i],
               "err_oracle": max_err(out, oracle),
               "share_oracle": tol_share(out, oracle, CONV_TOL, CONV_TOL),
               "ptxas": ptxas_info(fn)}
        row["share_of_bound"] = bound_ms / row["ms"]
        rows.append(row)
    best = min(rows, key=lambda r: r["ms"])
    heur_ms = rows[0]["ms"]
    record = {"shape": list(size), "bound_ms": bound_ms,
              "bound_by": bound_by, "best": best["config"],
              "best_ms": best["ms"], "heuristic_ms": heur_ms,
              "heuristic_over_best": heur_ms / best["ms"], "rows": rows}
    print("[conv-large] " + json.dumps(
        {**record, "rows": [{k: v for k, v in r.items() if k != "ms_runs"}
                            for r in rows]}))
    bad = [r for r in rows if not (r["finite"] and r["share_oracle"] <= 1.0)]
    if bad:
        raise AssertionError(f"conv-large configs disagree: {bad}")
    return record


def phase_times_new(conv_cases_t, flash_cases_t, device):
    """CUDA events over runs of back-to-back launches, the versions taking
    turns: each kernel, its plain version and one library call."""
    out = {}
    for label, cfg, size in conv_cases_t:
        H, W, Fh, Fw = size
        fn = cv.make_conv2d(H, W, Fh, Fw, cfg)
        img, f = conv_inputs(*size, device, seed=2)
        # odd filters: symmetric padding, one library call
        rec = _time_case(
            fn, (img, f), lambda: cv.conv2d_plain(img, f, fn.config),
            lambda: F.conv2d(img[None, None], f[None, None],
                             padding=(Fh // 2, Fw // 2)),
            device, iters=50, plain_iters=3,
            # the oracle's explicit pad, then the library conv: the route
            # HALO_MODE="xla" takes
            extras={"xla_route": lambda: cv.conv2d_reference(img, f)})
        rec["bound_ms"], rec["bound_by"] = _bound(
            cv.conv_flops(H, W, Fh, Fw), 4.0 * (2 * H * W + Fh * Fw))
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        out[label] = rec
        print(f"[times] {label}: " + json.dumps(
            {k: v for k, v in rec.items() if not k.endswith("_runs")}))
    for label, cfg, (lead, S, D), iters in flash_cases_t:
        fn = fa.make_flash_attention(S, S, D, cfg, causal=True)
        # the same library without the mask: it visits every KV block, so
        # full_ms / ms is what the causal skipping saves
        full = fa.make_flash_attention(S, S, D, cfg, causal=False)
        # the heuristic config (built in build_new) beside the search's
        # winner: whether the one-head search ranks well for many heads
        heur = fa.make_flash_attention(
            S, S, D, fa.heuristic_config(S, S, D), causal=True)
        q, k, v = flash_inputs(lead, S, S, D, "float32", device, seed=2)
        q4, k4, v4 = (x.reshape(-1, 1, S, D) for x in (q, k, v))
        rec = _time_case(
            fn, (q, k, v),
            lambda: fa.flash_plain(q, k, v, fn.config, causal=True),
            lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                   is_causal=True),
            device, iters=iters, plain_iters=2,
            extras={"full": lambda: full(q, k, v),
                    "heuristic": lambda: heur(q, k, v)})
        rec["heuristic"] = heur.config
        heads = int(np.prod(lead)) if lead else 1
        rec["bound_ms"], rec["bound_by"] = _bound(
            heads * fa.attention_flops(S, S, D, causal=True),
            4.0 * heads * 4 * S * D)
        # the bound counts the causal half; the kernel visits the causal
        # blocks only (flash.py::kv_steps), the diagonal ones whole
        rec["visited_share"] = (fa.kv_steps(fn.config, S, S, causal=True)
                                / fa.kv_steps(fn.config, S, S, causal=False))
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        out[label] = rec
        print(f"[times] {label}: " + json.dumps(
            {k: v for k, v in rec.items() if not k.endswith("_runs")}))
    return out


# ---------------------------------------------------------------------------
# the distribution layer: [dist], [dryrun], [sharding-tune].  Each runs in a
# spawned process of its own: the card's NCCL world of one and the dry-run's
# fake world are each a process's one default process group.
# ---------------------------------------------------------------------------

DIST_STEPS = 4
#: relative bound on a mesh trainer's loss against the meshless trainer's
DIST_LOSS_TOL = 1e-3
#: the dry-run's per-rank peak against the card's measured peak
DRYRUN_PEAK_TOL = 0.25
#: the dry-run cells of [dryrun]: (arch, shape, multi_pod, layers or None
#: for all, rules override).  deepseek-v3 keeps its width and is cut to
#: its 3 dense and 2 MoE layers: its 61 take ~200 s to trace (``--all``
#: traces them all).  granite-3-2b's decode splits its KV cache along time
#: over "model" (the tuner's starting point for decode cells)
DRYRUN_CELLS = [("granite-3-2b", "train_4k", False, None, None),
                ("mamba2-130m", "decode_32k", False, None, None),
                ("granite-3-2b", "decode_32k", False, None,
                 {"seq_kv": "model"}),
                ("deepseek-v3-671b", "train_4k", True, 5, None)]


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _child(queue, fn, args):
    """Run ``fn(*args)`` in this (spawned) process; hand back its result,
    or its traceback, and the seconds it took."""
    import traceback
    t0 = time.perf_counter()
    try:
        queue.put(("ok", fn(*args), time.perf_counter() - t0))
    except BaseException:  # noqa: BLE001 — re-raised in the parent
        queue.put(("error", traceback.format_exc(), time.perf_counter() - t0))
        raise


#: spawned processes not yet collected; the script stops them on its way out
_SPAWNED = []


class Spawned:
    """``fn(*args)`` started at once in a spawned process.  ``result()``
    waits for it (``timeout_s`` from the start) and returns its value, or
    raises with the child's traceback; ``seconds`` is then the child's own
    time.  The process is joined, or killed past the limit."""

    def __init__(self, fn, *args, timeout_s=900):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.what = (args[0] if fn is counted else fn).__name__
        self.deadline = time.monotonic() + timeout_s
        self.seconds = None
        self.queue = ctx.Queue()
        self.proc = ctx.Process(target=_child, args=(self.queue, fn, args))
        self.proc.start()
        _SPAWNED.append(self)

    def stop(self, grace=0.0):
        self.proc.join(timeout=grace)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join()
        if self in _SPAWNED:
            _SPAWNED.remove(self)

    def result(self):
        try:
            status, value, self.seconds = self.queue.get(
                timeout=max(1.0, self.deadline - time.monotonic()))
        finally:
            self.stop(grace=60)
        if status != "ok":
            raise AssertionError(f"{self.what} failed in its process:\n"
                                 f"{value}")
        return value


def in_process(fn, *args, timeout_s=900):
    """``fn(*args)`` in a spawned process, waited for: its result, or a
    raise with the child's traceback."""
    return Spawned(fn, *args, timeout_s=timeout_s).result()


def counted(fn, *args):
    """``fn(*args)`` (a dict) with the launch counts of this process, set
    to 0 just before it and read just after, under "launches": a spawned
    phase's kernels count in its own process."""
    zero_counts()
    rec = fn(*args)
    rec["launches"] = read_counts()
    return rec


def _dist_trainer(cfg, device, mesh, ckpt_dir, steps, seq, gb):
    return Trainer(cfg, DataConfig(seq_len=seq, global_batch=gb,
                                   vocab_size=cfg.vocab_size, seed=0),
                   TrainerConfig(total_steps=steps, ckpt_every=10 ** 9,
                                 ckpt_dir=ckpt_dir, ckpt_async=False,
                                 log_every=10 ** 9),
                   opt_cfg=OptimConfig(**dict(TRAIN_OPT, total_steps=steps)),
                   mesh=mesh, device=device)


def dist_main(full):
    """[dist], in its own process: a world of one rank (NCCL on the card,
    gloo in a rehearsal), ``make_host_mesh()`` -> a 1x1 ("data", "model")
    mesh, granite-3-2b trained DIST_STEPS steps through ``Trainer`` with
    and without it (the same seed; losses within DIST_LOSS_TOL), step ms
    from CUDA events and the peak; a 2-layer checkpoint of the mesh run
    restored onto the mesh with ``shardings=`` bit for bit; the elastic
    mesh and the batch check on the card's world."""
    import torch.distributed as dist
    from repro_torch.dist import partition
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.params import tree_leaves
    from repro_torch.runtime import make_elastic_mesh, validate_batch
    cuda = full
    device = torch.device("cuda" if cuda else "cpu")
    if cuda:
        torch.cuda.set_device(0)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    tmp = tempfile.mkdtemp(prefix="chip_smoke-dist-")
    try:
        mesh = make_host_mesh(device_type=device.type)
        cfg = get_model_config("granite-3-2b", smoke=not full)
        seq, gb = TRAIN_DATA if full else (32, 2)
        rec = {"mesh_shape": dict(zip(mesh.mesh_dim_names,
                                      tuple(mesh.shape))),
               "device_type": mesh.device_type, "config": cfg.name,
               "layers": cfg.num_layers, "seq_len": seq, "global_batch": gb,
               "steps": DIST_STEPS}
        for name, m in (("meshless", None), ("mesh", mesh)):
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            tr = _dist_trainer(cfg, device, m, os.path.join(tmp, name),
                               DIST_STEPS, seq, gb)
            tr.init_state()
            ms, _ = _timed_steps(tr, DIST_STEPS, device, profile_last=False)
            leaf = tree_leaves(tr.params)[0]
            rec[name] = {"losses": [h["loss"] for h in tr.history],
                         "step_ms": ms,
                         "step_ms_median": float(np.median(ms[1:])),
                         "peak_gib": _peak(device),
                         "peak_bytes": (torch.cuda.max_memory_allocated()
                                        if cuda else None),
                         "leaf_type": type(leaf).__name__}
            del tr, leaf
            if cuda:
                torch.cuda.empty_cache()
        diffs = [abs(a - b) / abs(b) for a, b in zip(
            rec["mesh"]["losses"], rec["meshless"]["losses"])]
        rec["max_loss_rel_diff"] = max(diffs)
        if rec["mesh"]["leaf_type"] != "DTensor":
            raise AssertionError(f"[dist] the mesh trainer holds "
                                 f"{rec['mesh']['leaf_type']}, not DTensor")
        if not rec["max_loss_rel_diff"] <= DIST_LOSS_TOL:
            raise AssertionError(f"[dist] mesh losses differ: {rec}")
        # save on the mesh, restore onto it (shardings=): bit for bit
        small = dataclasses.replace(cfg, num_layers=2) if full else cfg
        d = os.path.join(tmp, "ckpt")
        a = _dist_trainer(small, device, mesh, d, 1, seq, gb)
        a.train()
        a.save(block=True)
        b = _dist_trainer(small, device, mesh, d, 1, seq, gb)
        if not b.try_restore():
            raise AssertionError("[dist] no checkpoint to restore")
        pairs = list(zip(tree_leaves(partition.gather(a._tree())),
                         tree_leaves(partition.gather(b._tree()))))
        rec["restore"] = {
            "layers": small.num_layers, "leaves": len(pairs),
            "bit_equal": all(torch.equal(x, y) for x, y in pairs),
            "step": b.step,
            "dtensor": all(type(t).__name__ == "DTensor"
                           for t in tree_leaves(b.params))}
        del a, b, pairs
        if not (rec["restore"]["bit_equal"] and rec["restore"]["dtensor"]
                and rec["restore"]["step"] == 1):
            raise AssertionError(f"[dist] restore(shardings=): {rec}")
        em, decision = make_elastic_mesh(model_parallel=1,
                                         device_type=device.type)
        rec["elastic"] = {"mesh_shape": list(decision.mesh_shape),
                          "axis_names": list(decision.axis_names),
                          "dropped": decision.dropped, "note": decision.note,
                          "validate_batch": validate_batch(gb, em)}
        if not (tuple(em.shape) == (1, 1) and rec["elastic"]
                ["validate_batch"]):
            raise AssertionError(f"[dist] elastic mesh: {rec['elastic']}")
        return rec
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def _cell_line(rec):
    r = rec["roofline"]
    return {"arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
            "lower_s": rec["lower_s"], "measure_s": rec["measure_s"],
            "flops_per_chip": rec["flops_per_chip"],
            "bytes_per_chip": rec["bytes_per_chip"],
            "collective_by_op": rec["collective_by_op"],
            "memory_gib": rec["memory"]["total_bytes_per_device"] / 2 ** 30,
            "compute_ms": r["compute_t"] * 1e3,
            "memory_ms": r["memory_t"] * 1e3,
            "collective_ms": r["collective_t"] * 1e3,
            "dominant": r["dominant"], "step_ms": r["step_t"] * 1e3,
            "useful_flops_ratio": rec["useful_flops_ratio"]}


def dryrun_main(full):
    """[dryrun], in its own process, on the CPU alone: ``analyze_cell`` on
    fake worlds for DRYRUN_CELLS (the card's ``cuda`` mesh type; meta
    shards), then a 1x1 fake world at [train]'s 8 x 256: its ops and
    bytes against ``step_traffic`` (differences listed op by op), its
    FLOPs against ``train_bound_ms``'s count.  Prints nothing: the parent
    prints its lines and holds its peak to [dist]'s."""
    from repro_torch.dist import sharding
    from repro_torch.launch import dryrun
    from repro_torch.models.config import ShapeConfig
    device_type = "cuda" if full else "cpu"
    rec = {"cells": []}
    for arch, shape, multi, layers, rules in DRYRUN_CELLS:
        if rules:
            rules = dict(dryrun.default_rules_override(arch), **rules)
        if full:
            cfg = get_model_config(arch)
            if layers:
                cfg = dataclasses.replace(cfg, num_layers=layers)
            out = dryrun.analyze_cell(arch, shape, multi_pod=multi,
                                      device_type=device_type, cfg=cfg,
                                      rules_override=rules)
        else:                                # a rehearsal: smoke, 2x4
            small = ShapeConfig(shape, 32, 16, SHAPES[shape].kind)
            out = dryrun.analyze_cell(
                arch, small, mesh_shape=(2, 4), device_type=device_type,
                cfg=get_model_config(arch, smoke=True), rules_override=rules,
                run=dataclasses.replace(dryrun.default_run_config(
                    arch, shape), microbatch=1))
        rec["cells"].append(dict(_cell_line(out), layers=(
            layers if full and layers else None), rules=rules))
    deepseek = next(c for c in rec["cells"]
                    if c["arch"] == "deepseek-v3-671b")
    if full and not deepseek["collective_by_op"]["all-to-all"] > 0:
        raise AssertionError(f"[dryrun] deepseek-v3 moved no all-to-all "
                             f"bytes: {deepseek}")
    # the 1x1 count at [train]'s shape against step_traffic
    cfg = get_model_config("granite-3-2b", smoke=not full)
    seq, gb = TRAIN_DATA if full else (32, 2)
    with dryrun.fake_world(1):
        mesh = dryrun._mesh((1, 1), device_type)
        t0 = time.perf_counter()
        trace = dryrun._traced_step(
            cfg, ShapeConfig("train", seq, gb, "train"), RunConfig(), mesh,
            dict(sharding.DEFAULT_RULES), OptimConfig(**TRAIN_OPT))
        traced_s = time.perf_counter() - t0
    traffic = step_traffic(cfg, seq, gb)
    meta_ops = traffic["model_ops"] + traffic["optimizer_ops"]
    meta_gb = traffic["model_gb"] + traffic["optimizer_gb"]
    plain = step_traffic_by_op(cfg, seq, gb)
    diff = {k: {"1x1": trace.by_op.get(k, [0, 0])[:2],
                "meshless": plain.get(k, [0, 0])[:2]}
            for k in set(trace.by_op) | set(plain)
            if trace.by_op.get(k, [0, 0])[:2] != plain.get(k, [0, 0])[:2]}
    compute_ms, _ = train_bound_ms(cfg, seq * gb, seq, gb)
    bound_flops = compute_ms / 1e3 * H100_SXM.peak_bf16_tensor_flops
    rec["one_by_one"] = {
        "traced_s": traced_s, "ops": trace.ops, "gb": trace.bytes / 1e9,
        "step_traffic_ops": meta_ops, "step_traffic_gb": meta_gb,
        "differences": diff, "flops": trace.flops,
        "bound_flops": bound_flops,
        "flops_over_bound": trace.flops / bound_flops,
        "peak_bytes": trace.peak, "peak_gib": trace.peak / 2 ** 30}
    one = rec["one_by_one"]
    if diff:
        raise AssertionError(f"[dryrun] the 1x1 count differs from the "
                             f"meshless count: {diff}")
    # step_traffic's count also holds its inputs' allocations: the same
    # calls, counted alone
    from repro_torch.core.cost import OpTrace
    params = abstract_model(cfg)
    alloc = OpTrace()
    with alloc:
        OptState(*abstract_state(OptimConfig(), params)[:2],
                 count=torch.empty((), dtype=torch.int32, device="meta"))
        {k: torch.empty((gb, seq), dtype=torch.int32, device="meta")
         for k in ("tokens", "labels")}
    empty = alloc.ops
    one["step_traffic_input_allocations"] = empty
    if one["step_traffic_ops"] != trace.ops + empty:
        raise AssertionError(f"[dryrun] step_traffic counts "
                             f"{one['step_traffic_ops']} ops, the 1x1 "
                             f"{trace.ops} and {empty} input allocations")
    if not one["flops_over_bound"] >= 1.0:
        raise AssertionError(f"[dryrun] the 1x1 FLOPs fall below "
                             f"train_bound_ms's count: {one}")
    return rec


def step_traffic_by_op(cfg, seq_len, batch):
    """``step_traffic``'s meta-device step, counted op by op by the port's
    recorder ({op: [count, bytes, flops]}), its inputs made before the
    count starts (``step_traffic`` makes the optimizer state and the
    batch inside its count: ``aten.empty`` ops of their size)."""
    from repro_torch.core.cost import OpTrace
    params = abstract_model(cfg)
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    state = OptState(*abstract_state(OptimConfig(), params)[:2],
                     count=meta((), torch.int32))
    inputs = {k: meta((batch, seq_len), torch.int32)
              for k in ("tokens", "labels")}
    trace = OpTrace()
    with trace:
        make_train_step(cfg, opt_cfg=OptimConfig(**TRAIN_OPT))(
            params, state, inputs)
    return trace.by_op


def sharding_tune_main(full):
    """[sharding-tune], in its own process: ``tune_cell`` (greedy, budget
    4) over granite-3-2b train_4k's distributed-config space against the
    fake-world roofline; the winner is recorded and ``lookup`` answers
    with "exact".  A rehearsal tunes mamba2-130m decode_32k (budget 2) on
    a cpu mesh."""
    from repro_torch.core.registry import lookup_resolved
    from repro_torch.tune import sharding_autotune
    arch, shape, budget = (("granite-3-2b", "train_4k", 4) if full else
                           ("mamba2-130m", "decode_32k", 2))
    if not full:
        sharding_autotune._cell_objectives[(arch, shape, False)] = \
            sharding_autotune.CellObjective(arch, shape, device_type="cpu")
    t0 = time.perf_counter()
    out = sharding_autotune.tune_cell(arch, shape, strategy="greedy",
                                      budget=budget)
    wall = time.perf_counter() - t0
    res = lookup_resolved("sharding_cell", {"arch": arch, "shape": shape,
                                            "multi_pod": False},
                          profile=H100_SXM)
    rec = {"arch": arch, "shape": shape, "budget": budget, "wall_s": wall,
           "best_config": out["best_config"],
           "best_step_ms": out["best_step_t"] * 1e3,
           "evaluations": [{"config": e["config"],
                            "step_ms": (e["score"] * 1e3
                                        if e.get("score") is not None
                                        else None),
                            "eval_s": e.get("eval_s"),
                            "error": e.get("error")} for e in out["log"]],
           "lookup": {"provenance": res.provenance, "config": res.config}}
    if res.provenance != "exact" or res.config != out["best_config"]:
        raise AssertionError(f"[sharding-tune] lookup: {rec['lookup']}")
    if not math.isfinite(out["best_step_t"]):
        raise AssertionError(f"[sharding-tune] no feasible config: {rec}")
    return rec


def collect_background(background):
    """The results of the processes ``background`` (name -> Spawned)
    started, waited for: each record, the seconds its process took and the
    seconds this one waited for it."""
    out = {}
    for name, spawned in background.items():
        t0 = time.perf_counter()
        out[name] = spawned.result()
        out[name + "_s"] = spawned.seconds
        out[name + "_wait_s"] = time.perf_counter() - t0
    print("[background] " + json.dumps(
        {k: v for k, v in out.items() if k.endswith("_s")}), flush=True)
    return out


def phase_distribution(device, full, train_rec, collected):
    """[dist] in a spawned process; then the lines of [dryrun] and
    [sharding-tune], whose processes started with the script (neither
    touches the card) and were ``collected`` (collect_background) before
    the conv search.  No kernel of the four runs on them (each process
    reads its own counts around its phase, ``counted``)."""
    record = dict(collected)
    t0 = time.perf_counter()
    record["dist"] = in_process(counted, dist_main, full)
    meshless_ms = (train_rec or {}).get("full_depth", {}).get(
        "step_ms_median")
    print("[dist] " + json.dumps(dict(record["dist"],
                                      train_meshless_ms=meshless_ms)),
          flush=True)
    record["dist_s"] = time.perf_counter() - t0
    for line in record["dryrun"]["cells"]:
        print("[dryrun] cell " + json.dumps(line), flush=True)
    one = record["dryrun"]["one_by_one"]
    card_peak = record["dist"]["mesh"]["peak_bytes"]
    one["card_peak_gib"] = card_peak / 2 ** 30 if card_peak else None
    if card_peak:
        one["peak_rel_diff"] = abs(one["peak_bytes"] - card_peak) / card_peak
    print("[dryrun] 1x1 " + json.dumps(one), flush=True)
    if card_peak and not one["peak_rel_diff"] <= DRYRUN_PEAK_TOL:
        raise AssertionError(f"[dryrun] 1x1 peak {one['peak_gib']:.2f} GiB "
                             f"against the card's "
                             f"{one['card_peak_gib']:.2f} GiB")
    print("[sharding-tune] " + json.dumps(record["sharding_tune"]),
          flush=True)
    record["launches"] = {k: record[k]["launches"]
                          for k in ("dist", "dryrun", "sharding_tune")}
    print("[distribution] " + json.dumps(
        {k: record[k] for k in ("dist_s", "dryrun_s", "dryrun_wait_s",
                                "sharding_tune_s", "sharding_tune_wait_s",
                                "launches")}), flush=True)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="run the control flow on the CPU at tiny shapes "
                         "with the plain versions; prints no result")
    ap.add_argument("--times-bf16", nargs="+",
                    metavar="GEMM_CONFIG FLASH_CONFIG [CONV_CONFIG]",
                    help="run [times-bf16] alone, with these winners "
                         "(JSON: the float32 GEMM's, flash's, and the "
                         "bfloat16 conv's, timed at 4096^2 3x3 beside the "
                         "heuristic at 8192x4096 7x7 and 11x11), and print "
                         "no result: run from a copy of this script in "
                         "another tree, it times that tree's builds")
    ap.add_argument("--sass-against", nargs="+",
                    metavar="PARENT_ROOT SOURCE DEFINES",
                    help="build SOURCE (relative to each tree's root) "
                         "from this tree and from PARENT_ROOT at each "
                         "DEFINES (a JSON object of -D defines; one or "
                         "more), compare the SASS line for line, print no "
                         "result and exit 1 if any set differs")
    args = ap.parse_args(argv)
    if args.sass_against is not None and len(args.sass_against) < 3:
        ap.error("--sass-against takes PARENT_ROOT SOURCE DEFINES...")
    if args.times_bf16 is not None and len(args.times_bf16) not in (2, 3):
        ap.error("--times-bf16 takes GEMM_CONFIG FLASH_CONFIG "
                 "[CONV_CONFIG]")
    t_main = time.perf_counter()
    if args.rehearse:
        device, main_shape, budget = torch.device("cpu"), (256, 256, 256), 6
        big, conv_main, conv_big = (128, 256), (64, 256, 3, 3), [
            (128, 256, 7, 7), (128, 256, 11, 11)]
        big_s, flash_main, flash_lead = 512, (256, 256, 64), (2, 2)
        conv_budget, flash_budget, flash_bf16_budget = 6, 4, 4
        conv_bf16_budget = 4
        predict_shape, lookup_shape = (512, 512, 128), (128, 512, 512)
        online_shape = (64, 512, 256)
        bf16_shapes, bf16_budget = ((256,) * 3, (512,) * 3), 4
    else:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device is available", file=sys.stderr)
            return 2
        device, main_shape, budget = torch.device("cuda"), (2048,) * 3, 16
        # the paper's conv sizes (section V) and the flash declaration's
        # default shape; the searches' budgets are cut for the time limit
        big, conv_main, conv_big = (4096, 4096), (4096, 4096, 3, 3), [
            (8192, 4096, 7, 7), (8192, 4096, 11, 11)]
        big_s, flash_main, flash_lead = 4096, (4096, 4096, 128), (2, 8)
        conv_budget, flash_budget, flash_bf16_budget = 24, 24, 24
        conv_bf16_budget = 16
        # shapes no other phase tunes
        predict_shape, lookup_shape = (4096, 4096, 1024), (1024, 4096, 4096)
        # M = 256: the heuristic's 128 x 128 tiles fill 64 of 132 SMs
        online_shape = (256, 4096, 2048)
        # the main path's shape and the next power of two
        bf16_shapes, bf16_budget = ((2048,) * 3, (4096,) * 3), 16
    tmp = tempfile.mkdtemp(prefix="chip_smoke-")
    os.environ["REPRO_TUNE_CACHE"] = os.path.join(tmp, "tuned_configs.json")

    smi, _ = phase_environment(device)
    if args.sass_against:
        parent, source, *defines = args.sass_against
        return 1 if sass_against(parent, source,
                                 [json.loads(d) for d in defines]) else 0
    if args.times_bf16:
        gemm_cfg, flash_cfg, *conv_cfg = (json.loads(c)
                                          for c in args.times_bf16)
        phase_sdpa_route(flash_main[0], flash_main[2], device,
                         dtype="bfloat16")
        phase_times_bf16({"f32_winner": gemm_cfg,
                          "heuristic": heuristic_config(*main_shape)},
                         {"given": flash_cfg},
                         (flash_lead, flash_main[0], flash_main[2]),
                         bf16_shapes, device,
                         conv=conv_bf16_timed(conv_main, conv_big,
                                              conv_cfg[0])
                         if conv_cfg else ())
        return 0
    # the fake-world dry-runs and the sharding search need no card: they
    # run beside the phases below from here (the GEMM search builds one
    # config at a time), and are collected before the conv search, whose
    # 0.05 ms kernels they might disturb; [distribution] prints them
    background = {name: Spawned(counted, fn, not args.rehearse)
                  for name, fn in (("dryrun", dryrun_main),
                                   ("sharding_tune", sharding_tune_main))}
    cases = [(name, h100_twin(cfg), shape, dtype)
             for name, cfg, shape, dtype in REFERENCE_CASES]
    fns, heur = phase_build(cases, main_shape, device)
    sweep = phase_sweep(cases, fns, main_shape, device)
    main_rec = phase_main_path(main_shape, device, budget)
    times = phase_times(main_shape, main_rec["winner"], heur, device)
    # before the phases below: after them one SDPA call's trace came back
    # without device activities on the card (a trace of many kernels, as
    # [serve] takes, did not)
    sdpa_route = phase_sdpa_route(flash_main[0], flash_main[2], device)
    sdpa_route_bf16 = phase_sdpa_route(flash_main[0], flash_main[2], device,
                                       dtype="bfloat16")

    ccases, fcases = conv_cases(), flash_cases()
    conv_fns = {(name, size): cv.make_conv2d(*size, *filt, cfg, weight)
                for name, cfg, hw, filt, weight in ccases
                for size in (hw, big)}
    conv_bf16_fns = {key: cv.make_conv2d(fn.H, fn.W, fn.Fh, fn.Fw, fn.config,
                                         fn.weight, dtype=torch.bfloat16)
                     for key, fn in conv_fns.items()}
    flash_fns = {}
    for case in fcases:
        name, cfg, _, _, _, _, causal, dtype = case
        for _, sq, sk, d in flash_sizes(case, big_s):
            dt = getattr(torch, dtype)
            flash_fns[(name, sq, d)] = fa.make_flash_attention(
                sq, sk, d, flash_twin(cfg, d, dt.itemsize), causal=causal,
                dtype=dt)
    conv_heur = [cv.make_conv2d(*s, cv.heuristic_config(*s), dtype=dt)
                 for s in [conv_main] + conv_big
                 for dt in (torch.float32, torch.bfloat16)]
    # the bfloat16 conv search's whole space, built with the rest at once
    conv_space_bf16 = [
        cv.make_conv2d(*conv_main, c, dtype=torch.bfloat16)
        for c in cv.CONV2D.make_space(dict(
            zip(("H", "W", "Fh", "Fw"), conv_main), dtype="bfloat16")
        ).enumerate() if c["HALO_MODE"] == "materialize"]
    conv_large = [cv.make_conv2d(*conv_big[-1], cfg)
                  for cfg in conv_large_configs()]
    flash_heur = fa.make_flash_attention(
        *flash_main, fa.heuristic_config(*flash_main))
    # both flash searches' whole spaces, built with the rest at once
    flash_spaces = [
        fa.make_flash_attention(*flash_main, c, causal=True,
                                dtype=getattr(torch, dtype))
        for dtype in ("float32", "bfloat16")
        for c in fa.FLASH_ATTENTION.make_space(dict(
            zip(("Sq", "Sk", "D"), flash_main), causal=True,
            dtype=dtype)).enumerate()]
    new = {"sdpa_route": sdpa_route, "sdpa_route_bf16": sdpa_route_bf16}

    def conv_timed():
        """(label, config, shape) of the conv main shapes: the 3x3
        search's best kernel config, the heuristic's at the large ones."""
        rec = new["conv_main"]
        return ([("conv {}x{} {}x{}".format(*conv_main),
                  rec["best_kernel_config"], conv_main)]
                + [("conv {}x{} {}x{}".format(*size), call["config"], size)
                   for size, call in zip(conv_big, rec["calls"][1:])])

    def main_path():
        """(declaration, main-path record, shape) of each search."""
        M, N, K = main_shape
        return [(GEMM, main_rec, {"M": M, "N": N, "K": K}),
                (cv.CONV2D, new["conv_main"],
                 dict(zip(("H", "W", "Fh", "Fw"), conv_main))),
                (fa.FLASH_ATTENTION, new["flash_main"],
                 dict(zip(("Sq", "Sk", "D"), flash_main), causal=True))]

    for phase, run in [
            ("build_new", lambda: phase_build_new(
                list(conv_fns.values()) + list(conv_bf16_fns.values())
                + conv_heur + conv_space_bf16 + conv_large
                + list(flash_fns.values()) + [flash_heur] + flash_spaces,
                device)),
            ("conv_sweep", lambda: phase_conv_sweep(ccases, conv_fns, big,
                                                    device)),
            ("flash_sweep", lambda: phase_flash_sweep(fcases, flash_fns,
                                                      big_s, device)),
            ("background", lambda: collect_background(background)),
            ("ragged", lambda: phase_ragged(device)),
            ("conv_main", lambda: phase_conv_main(conv_main, conv_big, device,
                                                  conv_budget)),
            ("conv_main_bf16", lambda: phase_conv_main_bf16(
                conv_main, conv_big, device, conv_bf16_budget,
                new["conv_main"]["winner"])),
            # after the bfloat16 search: timed at its winner
            ("conv_bf16", lambda: phase_conv_bf16(
                ccases, conv_bf16_fns, big, device, conv_bf16_timed(
                    conv_main, conv_big, new["conv_main_bf16"]["winner"]))),
            ("flash_main", lambda: phase_flash_main(flash_main, flash_lead,
                                                    device, flash_budget)),
            ("flash_main_bf16", lambda: phase_flash_main_bf16(
                flash_main, flash_lead, device, flash_bf16_budget,
                new["flash_main"]["winner"])),
            # the GEMM float32 search's winner and heuristic config, built
            # in bfloat16; flash with the bfloat16 and float32 winners
            # (the bf16 conv is timed in [conv-bf16])
            ("times_bf16", lambda: phase_times_bf16(
                {"f32_winner": main_rec["winner"],
                 "heuristic": heuristic_config(*main_shape)},
                {"bf16_winner": new["flash_main_bf16"]["winner"],
                 "f32_winner": new["flash_main"]["winner"]},
                (flash_lead, flash_main[0], flash_main[2]), bf16_shapes,
                device)),
            ("main_bf16", lambda: phase_main_bf16(main_shape, device,
                                                  bf16_budget)),
            ("wallclock_gap", lambda: phase_wallclock_gap(main_path(),
                                                          device)),
            ("analyze", lambda: phase_analyze(main_path(), device, main_shape,
                                              flash_main)),
            ("costmodel", lambda: phase_costmodel(
                main_path(), device, main_shape, main_rec["winner"], tmp)),
            ("predict", lambda: phase_predict(
                main_rec, device, main_shape, predict_shape, lookup_shape,
                16, tmp)),
            ("dtune", lambda: phase_dtune(main_shape, device, tmp)),
            ("online", lambda: phase_online(online_shape, device, tmp)),
            ("serve", lambda: phase_serve(device, tmp,
                                          full=not args.rehearse)),
            ("serve_families", lambda: phase_serve_families(
                device, full=not args.rehearse)),
            ("train", lambda: phase_train(device, tmp,
                                          full=not args.rehearse)),
            ("distribution", lambda: phase_distribution(
                device, not args.rehearse, new.get("train"),
                new["background"])),
            # after the searches, which build their own configurations
            ("build_space", lambda: phase_build_space(device))]:
        t0 = time.perf_counter()
        new[phase] = run()
        print(f"[phase] {phase}: {time.perf_counter() - t0:.1f} s")
    conv_rec, flash_rec = new["conv_main"], new["flash_main"]
    if conv_rec["best_kernel_config"] is None:
        raise AssertionError("the conv2d search timed no kernel config")
    S, D = flash_main[0], flash_main[2]
    conv_label = "conv {}x{} {}x{}".format(*conv_main)
    flash_label = "flash {}x{}x{}x{}".format(*flash_lead, S, D)
    t0 = time.perf_counter()
    new["times_new"] = phase_times_new(
        conv_timed(),
        [(f"flash {S}x{D}", flash_rec["winner"], ((), S, D), 50),
         (flash_label, flash_rec["winner"], (flash_lead, S, D), 10)],
        device)
    print(f"[phase] times_new: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    new["conv_large"] = phase_conv_large(conv_large, conv_big[-1], device)
    print(f"[phase] conv_large: {time.perf_counter() - t0:.1f} s")
    # the heuristic builds and the 3x3 search's best kernel spill nothing
    for fn in conv_heur + [cv.make_conv2d(*conv_main,
                                          conv_rec["best_kernel_config"])]:
        if device.type == "cuda":
            fn.compile()
        if spill_bytes(ptxas_info(fn)):
            raise AssertionError(f"conv2d {fn.config} at {fn.Fh}x{fn.Fw} "
                                 f"spills: {ptxas_info(fn)}")

    line = {"kernels": []}
    for variant in ("gemm_scratch", "gemm_inplace"):
        k = times["kernels"][variant]
        line["kernels"].append({
            "name": variant, "route": "cuda", "source": SOURCES[variant],
            "replaces": REPLACES[variant],
            "launches": main_rec["launches"][variant],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": times["bound_ms"],
            "bound_by": times["bound_by"],
            "library_ms": times["library_ms"]})
    bf16 = new["main_bf16"]
    line["kernels"].append({
        "name": "gemm_bf16", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES["gemm_scratch"],
        "launches": bf16["launches"]["gemm_scratch"],
        "max_abs_err": bf16["max_abs_err"], "ms": bf16["ms"],
        "plain_ms": bf16["plain_ms"], "bound_ms": bf16["bound_ms"],
        "bound_by": bf16["bound_by"], "library_ms": bf16["library_ms"]})
    fb = new["flash_main_bf16"]
    line["kernels"].append({
        "name": "flash_bf16", "route": "cuda",
        "source": SOURCES["flash_attention"],
        "replaces": REPLACES["flash_attention"],
        "launches": fb["launches"]["flash_attention"],
        "max_abs_err": fb["max_abs_err"], "ms": fb["ms"],
        "plain_ms": fb["plain_ms"], "bound_ms": fb["bound_ms"],
        "bound_by": fb["bound_by"], "library_ms": fb["library_ms"]})
    cb = new["conv_main_bf16"]
    line["kernels"].append({
        "name": "conv2d_bf16", "route": "cuda", "source": SOURCES["conv2d"],
        "replaces": REPLACES["conv2d"],
        "launches": cb["launches"]["conv2d"],
        "max_abs_err": cb["max_abs_err"], "ms": cb["ms"],
        "plain_ms": cb["plain_ms"], "bound_ms": cb["bound_ms"],
        "bound_by": cb["bound_by"], "library_ms": cb["library_ms"]})
    for name, rec, label in (("conv2d", conv_rec, conv_label),
                             ("flash_attention", flash_rec, flash_label)):
        k = new["times_new"][label]
        line["kernels"].append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": rec["launches"][name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"]})
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "device": str(device), "sweep": sweep,
                   "main": main_rec, "times": times, **new, **line}, f,
                  indent=1)
    print(f"[total] {time.perf_counter() - t_main:.1f} s")
    print(json.dumps(line))
    if args.rehearse:
        print("[rehearsal] done; no result line on the CPU")
        return 0
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    finally:
        for spawned in list(_SPAWNED):
            spawned.stop()
    sys.exit(code)
