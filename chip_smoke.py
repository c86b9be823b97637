"""GPU smoke test of the PyTorch / CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py               # on the machine with the card
    python3 chip_smoke.py --rehearse    # the same control flow on the CPU,
                                        # plain versions only, tiny shapes

It drives the port's three main paths — tune -> record -> lookup -> run —
through the entry points a user calls, and holds every CUDA kernel on
them against its plain PyTorch version and the PyTorch oracle.  Phases,
each printing its own lines:

  1. environment: the card, its power limit, versions, the device profile
  2. build: every GEMM configuration of phase 3, all nvcc runs at once;
     the built threads and shared bytes must equal matmul.py's models
  3. GEMM kernel vs plain version vs oracle, for an H100 twin of every
     config the JAX package's GEMM tests sweep, at their shapes and 2048^3
  4. the GEMM main path at M = N = K = 2048 float32: tune_kernel with the
     wall-clock evaluator, lookup (provenance "exact"), matmul(config=None)
  5. GEMM times at 2048^3: tuned kernel, heuristic config, plain version,
     torch.matmul as the library yardstick, and the FLOP bound
  6. build_new: every conv2d and flash configuration of phases 7-10 and
     13, all nvcc runs at once; built threads and shared bytes (and each
     conv build's register micro-tile) against the models; ptxas's
     registers and spills of each conv build
  7. conv sweep: every case of the JAX package's conv2d tests, plus even
     filters, at its shape and at 4096^2, against conv2d_plain and the
     oracle (tolerance 1e-4, the JAX tests'); then conv-bf16: every case
     again with bfloat16 operands (the IN_BF16 builds), against
     conv2d_plain and the float32 oracle of the same inputs (3e-2)
  8. flash sweep: every case of the JAX package's attention tests, plus
     Sq > Sk causal (rows that see no key must return the mean of v) and
     bf16 inputs, at its shape and at the 4096 twin (D = 128), against
     flash_plain and the oracle (2e-5 and 3e-2 as in the JAX tests; at 4096
     a float32 bound derived from summation order, flash_bound)
  9. conv main path: tune_kernel(CONV2D) at 4096^2 3x3 (annealing, the
     extended space, budget 48), lookup "exact", conv2d(config=None); then
     conv2d(config=None) at 8192x4096 with 7x7 and 11x11 (heuristic)
 10. flash main path: tune_kernel(FLASH_ATTENTION) at (4096, 4096, 128)
     causal (budget 24), lookup "exact", flash_attention(config=None) on
     (2, 8, 4096, 128) float32: one launch for all 16 heads; then
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
     build_space: every fourth distinct conv build of the extended space
     at 3x3 (93 of its 372), 16 nvcc at a time, with ptxas's
     registers and spills (none may spill; after the searches, so their
     nvcc time stays their own)
 11. the CUDA kernels one float32 F.scaled_dot_product_attention call
     launches (one torch.profiler trace): the flash yardstick's route
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
searches' budgets (GEMM 32, conv 48, flash 24) are cut from the
declarations' defaults for the time limit: a search is bound by nvcc,
about 3.6 s per configuration.  The dtune workers are spawned, so this
script imports without side effects: its work is under __main__.

The line before the last is the card's name and power limit as nvidia-smi
gives them; the last is {"ok": true, "device": {...}}.  Any failure raises
and exits non-zero before that line.  The full record is also written to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import importlib
import json
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
from repro_torch.core import (H100_SXM, ArtifactStore,  # noqa: E402
                              CostModelEvaluator, LearnedPredictor, Tuner,
                              TuningCache, WallClockEvaluator, default_cache,
                              device_profile, lookup_resolved, make_strategy,
                              split_key)
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
                                        micro_tile, smem_footprint)
from repro_torch.serve import (BackgroundTuner, ConfigSlot,  # noqa: E402
                               JobStatus, OnlineTuneConfig,
                               submit_for_resolutions)
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


def time_in_turns(fns, device, rounds=5, iters=50):
    """Per-name lists of ``rounds`` timed runs, the names taking turns
    (in reversed order every other round) so drift hits all alike."""
    for fn in fns.values():
        for _ in range(3):
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
            want = (micro_tile(f.config)[2],
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
            # the plain version shares the kernel's rounding points, so it
            # is held to the tolerance of the result dtype
            p_atol, p_rtol = ((BF16_TOL, BF16_TOL) if
                              "bf16" in why else (atol, rtol))
            row = {"case": name, "config": cfg, "shape": list(s),
                   "dtype": dtype, "variant": fn.variant,
                   "finite": bool(torch.isfinite(out.float()).all()),
                   "err_plain": max_err(out, plain),
                   "err_oracle": max_err(out, oracle),
                   "share_plain": tol_share(out, plain, p_atol, p_rtol),
                   "share_oracle": tol_share(out, oracle, atol, rtol),
                   "tol_plain": [p_atol, p_rtol], "tol_oracle": [atol, rtol],
                   "tol_why": why}
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
    Sq > Sk causal (rows with every key masked) and bf16 inputs."""
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
    return cases


def flash_twin(cfg, D):
    """The config with BLOCK_K halved until one block's shared memory fits
    the H100 at head width D (the JAX blocks were sized for TPU memory)."""
    cfg = dict(cfg)
    while fa.smem_footprint(cfg, D) > H100_SXM.smem_per_block_optin:
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


def flash_tolerance(dtype, sq, q, k, v):
    """(atol, rtol, why) for the kernel against the oracle."""
    if dtype == "bfloat16":
        return BF16_TOL, BF16_TOL, "bf16 test tolerance"
    if max(sq, k.shape[-2]) <= 512:
        return FLASH_TOL, FLASH_TOL, "JAX attention tests"
    return flash_bound(q, k, v), 0.0, "float32 summation-order bound"


def phase_build_new(objs, device):
    """Build every conv2d and flash configuration the sweeps and the main
    paths' first calls use, one nvcc per build, all started together."""
    todo = [f for f in objs if getattr(f, "route", "cuda") == "cuda"]
    t0 = time.perf_counter()
    if device.type == "cuda":
        with ThreadPoolExecutor(len(todo)) as pool:
            addresses = set(pool.map(lambda f: f.compile(), todo))
        print(f"[build-new] {len(addresses)} libraries for {len(todo)} "
              f"kernel objects in {time.perf_counter() - t0:.2f} s")
        # the searches prune by these models: they must be what was built
        printed = set()
        for f in todo:
            if isinstance(f, cv.Conv2d):
                want = (cv.block_threads(f.config),
                        cv.smem_footprint(f.config, f.Fh, f.Fw),
                        cv.micro_tile(f.config, f.Fh, f.Fw))
                if f.address not in printed:
                    printed.add(f.address)
                    print(f"[build-new] conv2d {f.Fh}x{f.Fw} "
                          f"{json.dumps(f.config)} micro-tile {want[2]}: "
                          + "; ".join(ptxas_info(f)))
            else:
                want = (fa.block_threads(f.config, f.D),
                        fa.smem_footprint(f.config, f.D, f.dtype.itemsize))
            if f.geometry() != want:
                raise AssertionError(f"{f.config}: built {f.geometry()}, "
                                     f"modelled {want}")
    return time.perf_counter() - t0


def phase_build_space(device, workers=16, stride=4):
    """Build every ``stride``-th distinct conv2d library of the extended
    space at 3x3, in enumeration order, and read ptxas's registers and
    spills: the register tile is capped so that none spills.  (Every one of
    the 372 was built spill-free before; the stride keeps the script in its
    time limit.)"""
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
            regs = [int(m) for line in lines
                    for m in re.findall(r"Used (\d+) registers", line)]
            registers[max(regs)] = registers.get(max(regs), 0) + 1
            if spill_bytes(lines):
                spills.append({"config": fn.config, "lines": lines})
        record.update(seconds=time.perf_counter() - t0,
                      registers=dict(sorted(registers.items())),
                      spilling=spills)
    print("[build-space] " + json.dumps(record))
    if record.get("spilling"):
        raise AssertionError(f"{len(spills)} conv builds of the 3x3 space "
                             "spill")
    return record


def _check_row(row, kind, tag=None):
    print(f"[{tag or kind + '-sweep'}] " + json.dumps(row))
    if not (row["finite"] and row["share_plain"] <= 1.0
            and row["share_oracle"] <= 1.0 and row.get("mean_v_ok", True)):
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
            oracle = fa.attention_reference(q, k, v, causal=causal)
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


def phase_conv_bf16(cases, fns, big, device):
    """Every conv sweep case with bfloat16 operands against conv2d_plain
    and the float32 oracle of the same (rounded) inputs, at 3e-2."""
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
                   "share_plain": tol_share(out, plain, BF16_TOL, BF16_TOL),
                   "share_oracle": tol_share(out, oracle, BF16_TOL,
                                             BF16_TOL),
                   "tol": [BF16_TOL, BF16_TOL]}
            if out.dtype != torch.bfloat16:
                raise AssertionError(f"conv2d returned {out.dtype}: {row}")
            rows.append(row)
            _check_row(row, "conv", tag="conv-bf16")
    return rows


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


def _bound(ops, nbytes):
    t_ops = ops / H100_SXM.peak_f32_flops
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


def phase_sdpa_route(S, D, device):
    """Names the CUDA kernels one float32 F.scaled_dot_product_attention
    call (the flash yardstick, causal) launches, from one torch.profiler
    trace: which of PyTorch's routes the library time measures."""
    q, k, v = (x[None, None] for x in flash_inputs((), S, S, D, "float32",
                                                    device, seed=3))
    F.scaled_dot_product_attention(q, k, v, is_causal=True)   # warm-up
    sync(device)
    if device.type != "cuda":
        print("[sdpa-route] no card (rehearsal)")
        return []
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            F.scaled_dot_product_attention(q, k, v, is_causal=True)
            sync(device)
        events = prof.key_averages()
    except RuntimeError as e:          # the trace is a record, not a check
        print(f"[sdpa-route] not traced: {e}")
        return []
    kernels = []
    for e in events:
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        # device time that is not an operator's total or a profiler marker
        if us > 0 and not e.key.startswith(("aten::", "Activity ")):
            kernels.append({"kernel": e.key, "device_us": us})
    print(f"[sdpa-route] F.scaled_dot_product_attention float32 "
          f"(1, 1, {S}, {D}) causal launched: " + (json.dumps(kernels)
          if kernels else "no device time in the trace"))
    return kernels


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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="run the control flow on the CPU at tiny shapes "
                         "with the plain versions; prints no result")
    args = ap.parse_args(argv)
    if args.rehearse:
        device, main_shape, budget = torch.device("cpu"), (256, 256, 256), 6
        big, conv_main, conv_big = (128, 256), (64, 256, 3, 3), [
            (128, 256, 7, 7), (128, 256, 11, 11)]
        big_s, flash_main, flash_lead = 512, (256, 256, 64), (2, 2)
        conv_budget, flash_budget = 6, 4
        predict_shape, lookup_shape = (512, 512, 128), (128, 512, 512)
        online_shape = (64, 512, 256)
    else:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device is available", file=sys.stderr)
            return 2
        device, main_shape, budget = torch.device("cuda"), (2048,) * 3, 32
        # the paper's conv sizes (section V) and the flash declaration's
        # default shape; the searches' budgets are cut for the time limit
        big, conv_main, conv_big = (4096, 4096), (4096, 4096, 3, 3), [
            (8192, 4096, 7, 7), (8192, 4096, 11, 11)]
        big_s, flash_main, flash_lead = 4096, (4096, 4096, 128), (2, 8)
        conv_budget, flash_budget = 48, 24
        # shapes no other phase tunes
        predict_shape, lookup_shape = (4096, 4096, 1024), (1024, 4096, 4096)
        # M = 256: the heuristic's 128 x 128 tiles fill 64 of 132 SMs
        online_shape = (256, 4096, 2048)
    tmp = tempfile.mkdtemp(prefix="chip_smoke-")
    os.environ["REPRO_TUNE_CACHE"] = os.path.join(tmp, "tuned_configs.json")

    smi, _ = phase_environment(device)
    cases = [(name, h100_twin(cfg), shape, dtype)
             for name, cfg, shape, dtype in REFERENCE_CASES]
    fns, heur = phase_build(cases, main_shape, device)
    sweep = phase_sweep(cases, fns, main_shape, device)
    main_rec = phase_main_path(main_shape, device, budget)
    times = phase_times(main_shape, main_rec["winner"], heur, device)

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
            flash_fns[(name, sq, d)] = fa.make_flash_attention(
                sq, sk, d, flash_twin(cfg, d), causal=causal,
                dtype=getattr(torch, dtype))
    conv_heur = [cv.make_conv2d(*s, cv.heuristic_config(*s))
                 for s in [conv_main] + conv_big]
    conv_large = [cv.make_conv2d(*conv_big[-1], cfg)
                  for cfg in conv_large_configs()]
    flash_heur = fa.make_flash_attention(
        *flash_main, fa.heuristic_config(*flash_main))
    new = {}

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
                + conv_heur + conv_large + list(flash_fns.values())
                + [flash_heur], device)),
            ("conv_sweep", lambda: phase_conv_sweep(ccases, conv_fns, big,
                                                    device)),
            ("conv_bf16", lambda: phase_conv_bf16(ccases, conv_bf16_fns, big,
                                                  device)),
            ("flash_sweep", lambda: phase_flash_sweep(fcases, flash_fns,
                                                      big_s, device)),
            ("conv_main", lambda: phase_conv_main(conv_main, conv_big, device,
                                                  conv_budget)),
            ("flash_main", lambda: phase_flash_main(flash_main, flash_lead,
                                                    device, flash_budget)),
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
    new["sdpa_route"] = phase_sdpa_route(S, D, device)
    t0 = time.perf_counter()
    new["times_new"] = phase_times_new(
        [(conv_label, conv_rec["best_kernel_config"], conv_main)]
        + [("conv {}x{} {}x{}".format(*size), call["config"], size)
           for size, call in zip(conv_big, conv_rec["calls"][1:])],
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
    sys.exit(main())
