"""Run one cell of the benchmark once and print its result line.

    python gpubench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its
limit, which are also the last lines of standard error).  Without a CUDA
card, or with fewer cards than the cell asks for, it exits with 2 and
prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def prepare_environment() -> str:
    """Caches at fixed paths inside the checkout, a fresh tuning record in
    a new directory under TMPDIR (every run tunes from an empty record),
    and libraries kept from loading JAX.  Returns that directory."""
    build = os.path.join(ROOT, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    tmpdir = tempfile.mkdtemp(prefix="gpubench-")
    os.environ["REPRO_TUNE_CACHE"] = os.path.join(tmpdir, "tuned_configs.json")
    for path in (os.path.join(ROOT, "src"), ROOT):
        if path not in sys.path:
            sys.path.insert(0, path)
    return tmpdir


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    tmpdir = prepare_environment()
    try:
        import torch

        from gpubench import harness
        entry = harness.cell_files(args.workload)[0]
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < entry["chips"]:
            print(f"{args.workload} needs {entry['chips']} CUDA card(s); "
                  f"this host has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), torch.device("cuda", 0),
                                  tmpdir, T_START, chips=entry["chips"])
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
