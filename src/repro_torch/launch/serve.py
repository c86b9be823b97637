"""Serving launcher: batched greedy decoding with continuous batching.

``python -m repro_torch.launch.serve --arch granite-3-2b --requests 8``
serves on the card; ``--device cpu`` serves on the CPU, and ``--full``
builds the architecture's published config instead of its smoke config.
The weights are random, drawn from a ``torch.Generator`` seeded with
``--seed`` on the serving device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from ..configs import get_config
from ..models.model import init_model
from ..models.params import make_generator, resolve_device
from ..serve import Request, ServeEngine


def make_requests(cfg, n: int, max_new_tokens: int, seed: int = 0):
    """``n`` requests with random prompts of 4 to 11 tokens, drawn from
    ``np.random.default_rng(seed)`` as the JAX package's launcher draws
    them."""
    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(n):
        prompt = rng.integers(1, cfg.vocab_size,
                              size=int(rng.integers(4, 12))).tolist()
        reqs.append(Request(rid=rid, prompt=prompt,
                            max_new_tokens=max_new_tokens))
    return reqs


def main(argv=None):
    """Serve ``--requests`` random prompts; returns the finished requests."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="the device to serve on (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=not args.full)
    params = init_model(cfg, make_generator(args.seed, device), device)
    with ServeEngine(cfg, params, slots=args.slots,
                     max_len=args.max_len) as engine:
        for req in make_requests(cfg, args.requests, args.max_new_tokens,
                                 args.seed):
            engine.submit(req)
        t0 = time.perf_counter()
        done = engine.run()     # each step ends in a device -> host read
        dt = time.perf_counter() - t0
    total_tokens = sum(len(r.output) for r in done)
    print(f"served {len(done)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens / dt:.1f} tok/s)")
    for r in done[:3]:
        print(f"  req {r.rid}: prompt={r.prompt[:6]}... -> "
              f"output={r.output[:8]}...")
    return done


if __name__ == "__main__":
    main()
