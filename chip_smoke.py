"""GPU smoke test of the PyTorch / CUDA port on one NVIDIA card (H100).

    python3 chip_smoke.py               # on the machine with the card
    python3 chip_smoke.py --rehearse    # the same control flow on the CPU,
                                        # plain versions only, tiny shapes

It drives the port's main path — the paper's GEMM case study: tune ->
record -> lookup -> run — through the entry points a user calls, and holds
every CUDA kernel on that path against its plain PyTorch version and the
PyTorch oracle.  Phases, each printing its own lines:

  1. environment: the card, its power limit, versions, the device profile
  2. build: every GEMM configuration of phase 3, all nvcc runs at once
  3. kernel vs plain version vs oracle, for an H100 twin of every config the
     JAX package's GEMM tests sweep, at their shapes and at 2048^3
  4. the main path at M = N = K = 2048 float32: tune_kernel with the
     wall-clock evaluator, lookup (provenance "exact"), matmul(config=None);
     the launch counters are zeroed just before and read just after
  5. times at 2048^3 (CUDA events over runs of back-to-back launches, the
     versions taking turns; median and every run): tuned kernel, heuristic
     config, plain version, torch.matmul as the library yardstick, and the
     FLOP bound
  6. one JSON line listing every ported kernel

The line before the last is the card's name and power limit as nvidia-smi
gives them; the last is {"ok": true, "device": {...}}.  Any failure raises
and exits non-zero before that line.  The full record is also written to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import (H100_SXM, WallClockEvaluator,  # noqa: E402
                              default_cache, device_profile, lookup_resolved)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.matmul import (GEMM, LAUNCHES, gemm_plain,  # noqa: E402
                                        gemm_reference, heuristic_config,
                                        make_matmul, matmul, smem_footprint)
from repro_torch.tune import tune_kernel  # noqa: E402

SOURCE = "src/repro_torch/kernels/matmul/csrc/gemm.cu"
#: the TPU kernel bodies the CUDA kernel replaces (JAX package)
REPLACES = {"gemm_scratch": "src/repro/kernels/matmul/matmul.py:54",
            "gemm_inplace": "src/repro/kernels/matmul/matmul.py:84"}

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
    if fn.address is None:
        return []
    log = os.path.join(build.BUILD_DIR,
                       f"gemm-{fn.address.split(':')[1]}.log")
    with open(log) as f:
        return [" ".join(line.split()) for line in f
                if "registers" in line or "spill" in line]


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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse", action="store_true",
                    help="run the control flow on the CPU at tiny shapes "
                         "with the plain versions; prints no result")
    args = ap.parse_args(argv)
    if args.rehearse:
        device, main_shape, budget = torch.device("cpu"), (256, 256, 256), 6
    else:
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device is available", file=sys.stderr)
            return 2
        device, main_shape, budget = torch.device("cuda"), (2048,) * 3, 32
    tmp = tempfile.mkdtemp(prefix="chip_smoke-")
    os.environ["REPRO_TUNE_CACHE"] = os.path.join(tmp, "tuned_configs.json")

    smi, _ = phase_environment(device)
    cases = [(name, h100_twin(cfg), shape, dtype)
             for name, cfg, shape, dtype in REFERENCE_CASES]
    fns, heur = phase_build(cases, main_shape, device)
    sweep = phase_sweep(cases, fns, main_shape, device)
    main_rec = phase_main_path(main_shape, device, budget)
    times = phase_times(main_shape, main_rec["winner"], heur, device)

    line = {"kernels": []}
    for variant in ("gemm_scratch", "gemm_inplace"):
        k = times["kernels"][variant]
        line["kernels"].append({
            "name": variant, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[variant],
            "launches": main_rec["launches"][variant],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": times["bound_ms"],
            "bound_by": times["bound_by"],
            "library_ms": times["library_ms"]})
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "device": str(device), "sweep": sweep,
                   "main": main_rec, "times": times, **line}, f, indent=1)
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
