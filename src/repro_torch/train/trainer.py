"""Training driver: data + step + checkpointing + fault tolerance.

The loop is deliberately small — every capability lives in a substrate
module (data.pipeline, ckpt.checkpoint, runtime.straggler, dist.step) and
the trainer only composes them.  Fault-tolerance contract (the JAX
package's):

  * checkpoint every ``ckpt_every`` steps (async, atomic, retained);
  * on (re)start, restore the latest complete checkpoint and resume the
    deterministic data stream at the restored step — equal to a run that
    never died (tests/test_torch_train.py);
  * a straggler monitor watches step times and fires a mitigation callback;
  * ``simulate_failure_at`` kills the run mid-way in tests.

The trainer runs on one device (default: the card; asking for the card
on a host without one raises).  Each step updates the parameters and the
optimizer state in place and ends in one host read of its metrics — the
counterpart of the JAX trainer's ``block_until_ready``.

With a ``mesh`` (a ``DeviceMesh``; every rank of it runs the same
trainer) the parameters, the optimizer state and each batch are
DTensors on the layouts of ``repro_torch.dist.partition`` under
``rules``, the step runs under ``use_sharding(mesh, rules)`` with the
gradients laid out as the parameters, and checkpoints hold global
tensors: each rank gathers, rank 0 writes, and a restore lays every leaf
out on the trainer's mesh — which need not be the one that saved.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import tempfile
from typing import Any, Callable, Dict, Optional

import torch

from ..ckpt import CheckpointManager
from ..core import trace
from ..data import DataConfig, TokenSource, to_device
from ..dist import partition
from ..dist.sharding import use_sharding
from ..dist.step import make_train_step
from ..models.config import ModelConfig, ShapeConfig
from ..models.model import RunConfig, init_model
from ..models.params import make_generator, resolve_device
from ..optim import adamw
from ..runtime import StragglerConfig, StragglerMonitor

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_keep: int = 3
    ckpt_async: bool = True
    log_every: int = 10
    seed: int = 0


class Trainer:
    def __init__(self, cfg: ModelConfig, data_cfg: DataConfig,
                 trainer_cfg: Optional[TrainerConfig] = None,
                 run: RunConfig = RunConfig(),
                 opt_cfg: adamw.OptimConfig = adamw.OptimConfig(),
                 mesh=None, rules=None,
                 on_straggler: Optional[Callable] = None,
                 device: "torch.device | str | None" = None):
        self.device = resolve_device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh for a trainer on "
                             f"{self.device}")
        trainer_cfg = trainer_cfg or TrainerConfig()
        self.cfg = cfg
        self.data_cfg = data_cfg
        self.tc = trainer_cfg
        self.run = run
        self.opt_cfg = opt_cfg
        self.mesh = mesh
        self.rules = rules
        self.source = TokenSource(data_cfg)
        self.ckpt = CheckpointManager(trainer_cfg.ckpt_dir,
                                      keep=trainer_cfg.ckpt_keep,
                                      async_save=trainer_cfg.ckpt_async)
        self.monitor = StragglerMonitor(StragglerConfig(),
                                        on_straggler=on_straggler)
        self.step = 0
        self.params = None
        self.opt_state = None
        self.history: list = []

    # -- state ------------------------------------------------------------------
    def init_state(self):
        """Random weights from a generator seeded with ``seed`` on the
        trainer's device, and a zero optimizer state."""
        self.params = init_model(self.cfg,
                                 make_generator(self.tc.seed, self.device),
                                 self.device)
        self.opt_state = adamw.init(self.opt_cfg, self.params)
        if self.mesh is not None:
            self.params = partition.distribute(self.params,
                                               self.param_shardings())
            self.opt_state = partition.distribute(self.opt_state,
                                                  self.opt_shardings())
        self.step = 0

    def param_shardings(self):
        return partition.model_shardings(self.cfg, self.mesh, self.rules)

    def opt_shardings(self):
        return partition.opt_shardings(self.param_shardings(), self.mesh)

    def _shardings(self):
        """The layout tree of :meth:`_tree` (None without a mesh)."""
        if self.mesh is None:
            return None
        opt = self.opt_shardings()
        return {"params": self.param_shardings(),
                "opt": {"m": opt.m, "v": opt.v, "count": opt.count}}

    def _batch(self, step: int):
        batch = to_device(self.source.batch(step), self.device)
        if self.mesh is None:
            return batch
        shape = ShapeConfig("trainer", self.data_cfg.seq_len,
                            self.data_cfg.global_batch, "train")
        layouts = partition.batch_shardings(self.cfg, shape, self.mesh,
                                            self.rules)
        return partition.distribute(batch, {k: layouts[k] for k in batch})

    def _tree(self) -> Dict[str, Any]:
        return {"params": self.params,
                "opt": {"m": self.opt_state.m, "v": self.opt_state.v,
                        "count": self.opt_state.count}}

    def try_restore(self) -> bool:
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        if self.params is None:
            self.init_state()     # build templates for structure
        out = self.ckpt.restore(latest, template=self._tree(),
                                shardings=self._shardings())
        tree = out["tree"]
        self.params = tree["params"]
        self.opt_state = adamw.OptState(
            m=tree["opt"]["m"], v=tree["opt"]["v"],
            count=tree["opt"]["count"])
        self.step = out["step"]
        log.info("restored checkpoint at step %d", self.step)
        return True

    def save(self, block: bool = False):
        self.ckpt.save(self.step, self._tree(),
                       extra={"data_seed": self.data_cfg.seed,
                              "model": self.cfg.name},
                       block=block)

    # -- loop --------------------------------------------------------------------
    def train(self, steps: Optional[int] = None,
              simulate_failure_at: Optional[int] = None) -> Dict[str, Any]:
        if self.params is None and not self.try_restore():
            self.init_state()
        grad_shardings = (self.param_shardings() if self.mesh is not None
                          else None)
        step_fn = make_train_step(self.cfg, self.run, self.opt_cfg,
                                  grad_shardings=grad_shardings)
        scope = (lambda: use_sharding(self.mesh, self.rules)
                 if self.mesh is not None else contextlib.nullcontext())
        target = self.tc.total_steps if steps is None else self.step + steps
        while self.step < target:
            with trace.span("train.step"):
                batch = self._batch(self.step)
                self.monitor.step_start()
                with scope():
                    self.params, self.opt_state, metrics = step_fn(
                        self.params, self.opt_state, batch)
                # the step's end: one host read of every metric
                with trace.span("train.host_read"):
                    values = torch.stack([v.float() for v in
                                          partition.gather(metrics).values()])
                    m = dict(zip(metrics, values.tolist()))
                self.monitor.step_end()
                self.step += 1
                self.history.append({"step": self.step, **m})
                if self.step % self.tc.log_every == 0:
                    log.info("step %d loss %.4f", self.step, m["loss"])
                if self.step % self.tc.ckpt_every == 0:
                    self.save()
                if simulate_failure_at is not None \
                        and self.step >= simulate_failure_at:
                    raise RuntimeError(
                        f"simulated node failure at step {self.step}")
        self.ckpt.wait()
        return {"final_step": self.step, "history": self.history,
                "straggler_events": self.monitor.events}
