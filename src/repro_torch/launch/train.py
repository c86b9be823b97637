"""Training launcher: ``python -m repro_torch.launch.train --arch granite-3-2b``.

Trains the architecture's smoke config on the card by default,
``--device cpu`` on the CPU, and the full published config with
``--full``.  Wires the whole path: the deterministic data stream, the
train step, checkpoints, the straggler monitor, resume.  The weights are
random, drawn from a ``torch.Generator`` seeded with
``TrainerConfig.seed`` on the training device.
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile

from ..configs import get_config
from ..data import DataConfig
from ..models.model import RunConfig
from ..optim import adamw
from ..train import Trainer, TrainerConfig


def main(argv=None):
    """Train ``--steps`` steps; returns the trainer's result (its loss
    history)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--full", action="store_true",
                    help="use the full published config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--remat", default="none",
                    choices=["none", "full", "dots"])
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="the device to train on (default: the card)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    cfg = get_config(args.arch, smoke=not args.full)
    data_cfg = DataConfig(seq_len=args.seq_len,
                          global_batch=args.global_batch,
                          vocab_size=cfg.vocab_size)
    trainer = Trainer(
        cfg, data_cfg,
        TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir, log_every=args.log_every),
        run=RunConfig(remat=args.remat, microbatch=args.microbatch),
        opt_cfg=adamw.OptimConfig(lr=args.lr, total_steps=args.steps),
        device=args.device)
    if not args.resume:
        trainer.init_state()
    out = trainer.train()
    first = out["history"][0]["loss"] if out["history"] else float("nan")
    last = out["history"][-1]["loss"] if out["history"] else float("nan")
    print(f"trained {args.arch} ({cfg.name}) to step {out['final_step']}: "
          f"loss {first:.4f} -> {last:.4f}")
    return out


if __name__ == "__main__":
    main()
