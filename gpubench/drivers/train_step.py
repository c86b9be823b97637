"""The train step that ``Trainer.train`` runs (``dist/step.py``
``make_train_step`` -> ``models/model.py`` ``loss_fn`` -> ``optim/adamw.py``
``update_``), closed loop: each step starts when the previous one's host
read of its metrics returned.

Set-up makes the weights and token batches from the seed, hands the
weights to one ``Trainer`` and drives it through its first steps on rows
that all differ; those steps warm up every shape and are the ones the
reference follows.  After each, what the comparison needs is read from
the trainer's own state: the step's loss, after the first the norm of
each leaf's gradient as AdamW took it (its first moment over 1 - beta1),
and after the last the norm of each leaf's change.  The window then goes
on with the same trainer, the same call and the same feed.

For the CPU tests it declares ``tiny`` (the size a test holds) and
``FAULTS`` (faults planted in the timed path, each of which must make a
run not correct), and ``REFERENCE_FAULTS``, the faults ``control`` can
plant in the reference.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch

from gpubench import checks, roofline, traffic
from gpubench.reference import dense_lm


class _Feed:
    """The trainer's data source: the seeded batches, in turn."""

    def __init__(self, batches):
        self.batches = batches

    def batch(self, step: int):
        return self.batches[step % len(self.batches)]


def model_config(cfg: Dict):
    """The port's ModelConfig of a configuration file."""
    from repro_torch.models.config import ModelConfig
    return ModelConfig(
        name=cfg["name"], family="dense",
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["intermediate_size"],
        mlp_variant="swiglu" if roofline.gated(cfg) else "gelu",
        vocab_size=cfg["vocab_size"], rope_theta=cfg.get("rope_theta", 1e4),
        param_dtype=cfg["torch_dtype"], norm_eps=cfg.get("rms_norm_eps", 1e-6),
        tie_embeddings=cfg.get("tie_word_embeddings", False))


def _norms(tree: Dict[str, torch.Tensor], scale: float = 1.0
           ) -> Dict[str, float]:
    values = torch.stack([t.float().norm() for t in tree.values()]) * scale
    return dict(zip(tree, values.tolist()))


class Cell:
    def __init__(self, run):
        from repro_torch.data import DataConfig
        from repro_torch.models.params import tree_leaves
        from repro_torch.optim import adamw
        from repro_torch.train.trainer import Trainer, TrainerConfig
        self.run, t, cfg = run, run.traffic, run.cfg
        self.batch_shape = (t["batch"], t["seq_len"])
        with run.phase("load"):
            self.batches = traffic.zipf_batches(
                run.seed, t["batches"], t["batch"], t["seq_len"],
                cfg["vocab_size"], t["zipf_a"])
            flat = traffic.dense_lm(cfg, run.seed, run.device)
            self.paths = list(dense_lm.flatten(traffic.nest(flat)))
            self.opt_cfg = adamw.OptimConfig(**t["optimizer"])
            self.trainer = Trainer(
                model_config(cfg),
                DataConfig(seq_len=t["seq_len"], global_batch=t["batch"],
                           vocab_size=cfg["vocab_size"], seed=run.seed),
                TrainerConfig(total_steps=10 ** 9, ckpt_every=10 ** 9,
                              ckpt_dir=run.tmpdir + "/ckpt",
                              log_every=10 ** 9, seed=run.seed),
                opt_cfg=self.opt_cfg, device=run.device)
            self.trainer.source = _Feed(self.batches)
            self.trainer.params = traffic.nest(flat)
            self.trainer.opt_state = adamw.init(self.opt_cfg,
                                                self.trainer.params)
            del flat
        with run.phase("warm-up"):
            self.losses: List[float] = []
            for step in range(t["setup_steps"]):
                self.trainer.train(steps=1)
                self.losses.append(self.trainer.history[-1]["loss"])
                if step == 0:
                    m = dict(zip(self.paths,
                                 tree_leaves(self.trainer.opt_state.m)))
                    self.grad = _norms(m, 1 / (1 - self.opt_cfg.betas[0]))
            now = dict(zip(self.paths, tree_leaves(self.trainer.params)))
            self.change = {p: float((now[p].float() - traffic.dense_lm_leaf(
                cfg, p, run.seed, run.device).float()).norm())
                for p in self.paths}
        run.counters["step_flops"] = roofline.train_step_flops(
            cfg, *self.batch_shape)

    def window(self, deadline: float) -> Dict:
        step_s = []
        t0 = now = time.perf_counter()
        while now < deadline:
            self.trainer.train(steps=1)
            after = time.perf_counter()
            step_s.append(after - now)
            now = after
        self.run.sync()
        elapsed = time.perf_counter() - t0
        steps = len(step_s)
        tokens = steps * self.batch_shape[0] * self.batch_shape[1]
        return {"attempted": steps, "steps": steps, "seconds": elapsed,
                "step_s": step_s,
                "end_to_end": {"train_tokens_per_s": tokens / elapsed}}

    def segment(self) -> None:
        self.trainer.train(steps=self.run.traffic["trace_steps"])

    def extra(self) -> None:
        """adamw_ms: CUDA-event time of one ``update_`` over the whole
        state, with gradients of the parameters' shapes and types."""
        from repro_torch.models.params import tree_map
        from repro_torch.optim import adamw
        tr = self.trainer
        grads = tree_map(torch.zeros_like, tr.params)
        adamw.update_(self.opt_cfg, grads, tr.opt_state, tr.params)
        ms = []
        for _ in range(self.run.traffic["adamw_calls"]):
            if self.run.device.type == "cuda":
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                adamw.update_(self.opt_cfg, grads, tr.opt_state, tr.params)
                b.record()
                b.synchronize()
                ms.append(a.elapsed_time(b))
            else:
                t0 = time.perf_counter()
                adamw.update_(self.opt_cfg, grads, tr.opt_state, tr.params)
                ms.append((time.perf_counter() - t0) * 1e3)
        self.run.spans["adamw_ms"] = ms
        del grads

    def release(self) -> None:
        self.trainer = None
        gc.collect()

    def check(self) -> Dict[str, float]:
        run, t = self.run, self.run.traffic
        n = t["setup_steps"]
        params = traffic.dense_lm(run.cfg, run.seed, run.device)
        batches = [{k: torch.from_numpy(v).to(run.device) for k, v in b.items()}
                   for b in self.batches[:n]]
        ref = dense_lm.train_readings(run.cfg, params, batches,
                                      t["optimizer"])
        del params
        return readings_gaps(self.losses, self.grad, self.change, ref)


def readings_gaps(losses, grad, change, ref) -> Dict[str, float]:
    """The three numbers compared: the worst step's loss gap, the worst
    leaf's gap of the first gradient's norm, and the worst moving leaf's
    gap of the change's norm."""
    return {"loss_gap": checks.loss_gap(losses, ref["loss"]),
            "grad_gap": checks.leaf_gap(grad, ref["grad"]),
            "update_gap": checks.leaf_gap(
                change, ref["change"], checks.moving_leaves(ref["grad"]))}


def tiny(cfg: Dict, t: Dict):
    """A size a CPU test holds: a small dense decoder, 4 x 16 tokens a
    step, 4 batches."""
    cfg.update(traffic.TINY_LM)
    t.update(batch=4, seq_len=16, batches=4)
    return cfg, t


def _state_unchanged(monkeypatch) -> None:
    """AdamW's update returns the parameters and state as they were."""
    from repro_torch.optim import adamw

    def update_(cfg, grads, state, params):
        return params, state, {"grad_norm": torch.zeros(()),
                               "lr": torch.zeros(())}
    monkeypatch.setattr(adamw, "update_", update_)


def _half_batch(monkeypatch) -> None:
    """The loss is the mean over the first half of the batch's rows."""
    from repro_torch.dist import step
    loss_fn = step.loss_fn

    def half(cfg, params, batch, run=None, **kw):
        rows = next(iter(batch.values())).shape[0] // 2
        return loss_fn(cfg, params, {k: v[:rows] for k, v in batch.items()},
                       run, **kw)
    monkeypatch.setattr(step, "loss_fn", half)


def _gradient_altered(monkeypatch) -> None:
    """The query projection's gradient reaches AdamW doubled."""
    from repro_torch.optim import adamw
    update_ = adamw.update_

    def altered(cfg, grads, state, params):
        grads["blocks"]["attn"]["wq"] = grads["blocks"]["attn"]["wq"] * 2
        return update_(cfg, grads, state, params)
    monkeypatch.setattr(adamw, "update_", altered)


#: plant(monkeypatch) of each fault the timed path can have
FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "gradient_altered": _gradient_altered}
#: the faults ``control`` plants in the reference (``dense_lm``)
REFERENCE_FAULTS = ("half_batch", "grad_double")


def control(run, precision: str = "float32", fault=None) -> Dict[str, float]:
    """The numbers compared where the reference, computed in ``precision``
    or with ``fault`` planted, stands in the program's place."""
    t = run.traffic
    params = traffic.dense_lm(run.cfg, run.seed, run.device)
    batches = [{k: torch.from_numpy(v).to(run.device) for k, v in b.items()}
               for b in traffic.zipf_batches(run.seed, t["setup_steps"],
                                             t["batch"], t["seq_len"],
                                             run.cfg["vocab_size"],
                                             t["zipf_a"])]
    ref = dense_lm.train_readings(run.cfg, params, batches, t["optimizer"])
    other = dense_lm.train_readings(run.cfg, params, batches, t["optimizer"],
                                    precision, fault)
    return readings_gaps(other["loss"], other["grad"], other["change"], ref)
