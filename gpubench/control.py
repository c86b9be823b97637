"""Readings that set a cell's limits, on the card at the cell's own size,
in one process: the numbers compared of sound runs of the program over
many seeds (the lower readings), and of the control, the reference put in
the program's place and computed in the precision below the one the
configuration states (the upper readings); also of the reference with
each fault its driver's ``REFERENCE_FAULTS`` names.

    python gpubench/control.py --workload <cell> --seeds 1 2 3 ... \\
        --control-seeds 7 8 9 [--seconds 2] [--out FILE]

The benchmark's own runs never run this.
"""

import argparse
import gc
import json
import os
import shutil
import sys
import tempfile
import time

sys.path[:0] = [os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"),
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

#: the precision the control computes in, by the configuration's type
BELOW = {"bfloat16": "float8_e4m3fn"}


def readings(name, seeds, control_seeds, seconds, device, tmpdir):
    import torch

    from gpubench import harness
    entry, work, cfg = harness.cell_files(name)
    driver = harness.load_module("drivers", work["driver"])
    below = BELOW[cfg["torch_dtype"]]
    out = {"cell": name, "program": {}, "control": {}, "faults": {},
           "control_precision": below}

    os.environ["REPRO_TUNE_CACHE"] = os.path.join(tmpdir, "tuned.json")

    def new_run(seed):
        # one record for all seeds: the first searches, the rest look up
        # its winners (the numbers compared follow the output's rounding,
        # not the blocks)
        return harness.Run(name, work, cfg, seed, seconds, False, device,
                           tmpdir)

    def free():
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    for seed in seeds:
        run = new_run(seed)
        cell = driver.Cell(run)
        if hasattr(cell, "samples_per_tag"):
            cell.window(time.perf_counter() + seconds)
        cell.release()
        free()
        out["program"][seed] = cell.check()
        del cell
        free()
        print("program", seed, json.dumps(out["program"][seed]), flush=True)
    for seed in control_seeds:
        out["control"][seed] = driver.control(new_run(seed), below)
        free()
        print("control", below, seed, json.dumps(out["control"][seed]),
              flush=True)
        for fault in getattr(driver, "REFERENCE_FAULTS", ()):
            out["faults"].setdefault(fault, {})[seed] = driver.control(
                new_run(seed), "float32", fault)
            free()
            print("fault", fault, seed,
                  json.dumps(out["faults"][fault][seed]), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("the control reads the card; no CUDA device", file=sys.stderr)
        return 2
    tmpdir = tempfile.mkdtemp(prefix="gpubench-control-")
    try:
        out = readings(args.workload, args.seeds, args.control_seeds,
                       args.seconds, torch.device("cuda", 0), tmpdir)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    for key in ("program", "control"):
        if out[key]:
            worst = {k: max(v[k] for v in out[key].values())
                     for k in next(iter(out[key].values()))}
            least = {k: min(v[k] for v in out[key].values())
                     for k in next(iter(out[key].values()))}
            print(key, "largest", json.dumps(worst), "least",
                  json.dumps(least))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
