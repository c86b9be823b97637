"""AdamW with decoupled weight decay, global-norm clipping and schedules.

The JAX package's optimizer, leaf for leaf: the first/second-moment trees
mirror the parameter tree, and every value is computed as there — the
schedule, the bias corrections ``1 - b**count`` and the clip scale in
float32 tensors (Python floats are float64 and would move the last bits),
each leaf's step in float32, cast back to the parameter and moment dtypes.

``update`` returns new trees, as the JAX function does.  ``update_``
writes the same values into the given tensors under ``torch.no_grad()``
and returns them: the port's counterpart of the JAX trainer's donated
buffers, so a train step never holds two copies of the parameters and
moments.  It takes one of two paths, chosen by where the leaves are and
counted by ``core/trace.py``:

- ``optim.adamw.leafwise``: no leaf on a CUDA device (CPU leaves, or
  ``meta`` leaves that trace shapes; plain or DTensor): ``_leaf`` a leaf
  in PyTorch operations;
- ``optim.adamw.fused``: any other tree, plain or DTensor leaves on one
  CUDA device: two hand-written CUDA passes (``fused.py``,
  ``csrc/adamw.cu``), the norm and then each leaf's step in one read and
  one write, bit for bit ``_leaf``'s given the same scalars, with no host
  synchronisation.  What the passes do not take (another dtype, a
  non-contiguous parameter or moment, leaves on two devices) raises
  ``ValueError``.

``moment_dtype='bfloat16'`` halves optimizer memory (the giant-MoE
configs use it).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from . import fused
from ..core import trace
from ..models.params import torch_dtype, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    schedule: str = "cosine"            # cosine | linear | constant
    moment_dtype: str = "float32"       # float32 | bfloat16 (compressed)


class OptState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor


def schedule_lr(cfg: OptimConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), a float32 tensor."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        decay = 1.0
    else:
        t = torch.clamp((step - cfg.warmup_steps)
                        / max(cfg.total_steps - cfg.warmup_steps, 1),
                        0.0, 1.0)
        if cfg.schedule == "cosine":
            decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) \
                * 0.5 * (1 + torch.cos(math.pi * t))
        elif cfg.schedule == "linear":
            decay = 1.0 - (1 - cfg.min_lr_ratio) * t
        else:
            raise ValueError(cfg.schedule)
    return cfg.lr * warm * decay


def init(cfg: OptimConfig, params: Any) -> OptState:
    """Zero moments in ``cfg.moment_dtype`` beside each parameter, and a
    zero int32 step count on the parameters' device."""
    dt = torch_dtype(cfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    device = tree_leaves(params)[0].device
    return OptState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                    count=torch.zeros((), dtype=torch.int32, device=device))


def abstract_state(cfg: OptimConfig, abstract_p: Any) -> OptState:
    """The state's shapes and dtypes on the ``meta`` device."""
    dt = torch_dtype(cfg.moment_dtype)
    mk = lambda p: torch.empty(p.shape, dtype=dt, device="meta")
    return OptState(m=tree_map(mk, abstract_p), v=tree_map(mk, abstract_p),
                    count=torch.empty((), dtype=torch.int32, device="meta"))


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32, the leaves
    added in the JAX package's order."""
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in tree_leaves(tree)))


def _scalars(cfg: OptimConfig, gnorm: torch.Tensor, count: torch.Tensor):
    """(clip scale, lr, c1, c2) for the step that makes the count
    ``count`` with the gradients' global norm ``gnorm``; float32
    tensors."""
    if cfg.clip_norm:
        scale = torch.where(gnorm > cfg.clip_norm, cfg.clip_norm / gnorm,
                            torch.ones_like(gnorm))
    else:
        scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
    lr = schedule_lr(cfg, count)
    b1, b2 = cfg.betas
    c1 = 1.0 - b1 ** count.to(torch.float32)
    c2 = 1.0 - b2 ** count.to(torch.float32)
    return scale, lr, c1, c2


def _leaf(cfg: OptimConfig, p, g, m, v, scale, lr, c1, c2):
    """One leaf's step in float32: (new p, new m, new v) in the parameter
    and moment dtypes."""
    b1, b2 = cfg.betas
    mdt = torch_dtype(cfg.moment_dtype)
    g = g.float() * scale
    m32 = b1 * m.float() + (1 - b1) * g
    v32 = b2 * v.float() + (1 - b2) * g * g
    upd = (m32 / c1) / (torch.sqrt(v32 / c2) + cfg.eps)
    p32 = p.float()
    new_p = p32 - lr * (upd + cfg.weight_decay * p32)
    return new_p.to(p.dtype), m32.to(mdt), v32.to(mdt)


def update(cfg: OptimConfig, grads: Any, state: OptState, params: Any
           ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (new_params, new_state, metrics); the
    arguments are left as they were."""
    with torch.no_grad():
        count = state.count + 1
        gnorm = global_norm(grads)
        k = _scalars(cfg, gnorm, count)
        out = tree_map(lambda p, g, m, v: _leaf(cfg, p, g, m, v, *k),
                       params, grads, state.m, state.v)
        pick = lambda i: tree_map(lambda o: o[i], out)
        new = OptState(pick(1), pick(2), count)
    return pick(0), new, {"grad_norm": gnorm, "lr": k[1]}


def update_(cfg: OptimConfig, grads: Any, state: OptState, params: Any
            ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """``update``'s values written into ``params``, ``state.m``,
    ``state.v`` and ``state.count``, by the fused passes or one leaf at a
    time (the module's note says which); returns (params, state,
    metrics), the same objects."""
    with torch.no_grad():
        state.count.add_(1)
        leaves = [tree_leaves(t) for t in (params, grads, state.m, state.v)]
        if any(t.device.type == "cuda" for ts in leaves for t in ts):
            plan = fused.Leaves(torch_dtype(cfg.moment_dtype), *leaves)
            trace.count("optim.adamw.fused")
            gnorm = plan.norm()
            k = _scalars(cfg, gnorm, fused.local(state.count))
            plan.update(cfg, *k)
            return params, state, {"grad_norm": gnorm, "lr": k[1]}
        trace.count("optim.adamw.leafwise")
        gnorm = global_norm(grads)
        k = _scalars(cfg, gnorm, state.count)
        for p, g, m, v in zip(*leaves):
            new_p, new_m, new_v = _leaf(cfg, p, g, m, v, *k)
            p.copy_(new_p)
            m.copy_(new_m)
            v.copy_(new_v)
            del new_p, new_m, new_v
    return params, state, {"grad_norm": gnorm, "lr": k[1]}
