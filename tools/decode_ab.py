"""Meshless decode steps of two trees of the port, timed in turns on one card.

    python3 tools/decode_ab.py --tree parent=DIR/src --tree change=src \
        --order parent,change,change,parent

Each entry of ``--order`` runs in a process of its own that imports
``repro_torch`` from that tree's ``src`` directory and times
``make_serve_step(cfg, greedy=True)`` on seeded random weights at full
width: granite-3-2b, mamba2-130m, zamba2-7b and deepseek-v3 cut to 2
layers (the serve phases' models).  A step feeds its tokens to the next,
so the host never waits for the card; CUDA events at every step boundary
give each step's time.  Prints one JSON line per run and, last, the
card's name and power limit; ``chiprun_out/decode_ab.json`` holds them
all.  ``--rehearse`` runs the same control flow on the CPU at the smoke
configs (host clock; no result worth keeping).
"""

import argparse
import json
import os
import subprocess
import sys
import time

#: (arch, config changes) of the timed models
MODELS = (("granite-3-2b", {}),
          ("mamba2-130m", {}),
          ("zamba2-7b", {}),
          ("deepseek-v3-671b", {"num_layers": 2, "moe_first_dense": 1,
                                "mtp_depth": 0}))


def run_one(steps, warmup, batch, max_len, rehearse=False):
    """Time every model's decode step with the ``repro_torch`` on the
    path; one record per model."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist.step import make_serve_step
    from repro_torch.models.model import init_cache, init_model

    device = torch.device("cpu" if rehearse else "cuda")
    out = {}
    for arch, changes in MODELS:
        cfg = dataclasses.replace(get_config(arch, smoke=rehearse),
                                  **({} if rehearse else changes))
        params = init_model(cfg, torch.Generator(device=device).manual_seed(0),
                            device)
        cache = init_cache(cfg, batch, max_len, device)
        step = make_serve_step(cfg, greedy=True)
        tok = torch.zeros((batch, 1), dtype=torch.int64, device=device)
        for pos in range(warmup):
            nxt, cache = step(params, cache, tok, pos)
            tok = nxt[:, None].long()
        if rehearse:
            stamps = [time.perf_counter()]
            for i in range(steps):
                nxt, cache = step(params, cache, tok, warmup + i)
                tok = nxt[:, None].long()
                stamps.append(time.perf_counter())
            ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
        else:
            torch.cuda.synchronize()
            events = [torch.cuda.Event(enable_timing=True)
                      for _ in range(steps + 1)]
            events[0].record()
            for i in range(steps):
                nxt, cache = step(params, cache, tok, warmup + i)
                tok = nxt[:, None].long()
                events[i + 1].record()
            events[-1].synchronize()
            ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        out[arch] = {"step_ms_median": float(np.median(ms)),
                     "step_ms_p10_p90": [float(np.percentile(ms, 10)),
                                         float(np.percentile(ms, 90))],
                     "steps": steps, "layers": cfg.num_layers}
        del params, cache, step
        if not rehearse:
            torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="NAME=SRC_DIR (repeat)")
    ap.add_argument("--order", required=True,
                    help="comma-separated tree names, one process each")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--rehearse", action="store_true")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(run_one(args.steps, args.warmup, args.batch,
                                 args.max_len, args.rehearse)))
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    runs = []
    for name in args.order.split(","):
        env = dict(os.environ,
                   PYTHONPATH=os.path.abspath(trees[name]))
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", name,
             "--tree", args.tree[0], "--order", name,
             "--steps", str(args.steps), "--warmup", str(args.warmup),
             "--batch", str(args.batch), "--max-len", str(args.max_len)]
            + (["--rehearse"] if args.rehearse else []),
            env=env, capture_output=True, text=True, check=False)
        if res.returncode:
            sys.stderr.write(res.stderr[-4000:])
            return res.returncode
        rec = {"tree": name, "src": trees[name],
               "models": json.loads(res.stdout.strip().splitlines()[-1])}
        print(json.dumps(rec), flush=True)
        runs.append(rec)
    smi = "cpu" if args.rehearse else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "decode_ab.json"), "w") as f:
        json.dump({"card": smi, "runs": runs}, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
