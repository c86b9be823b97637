"""Step-function factories shared by the trainer and the serving engine.

Each factory closes over static configuration and returns a function of
tensors.  Where the JAX package jits the step, the port calls it eagerly;
the serve step runs under ``torch.inference_mode()``.  The train step
takes its gradients with ``torch.autograd.grad`` and updates the
parameters and optimizer state in place (``adamw.update_``): the JAX
trainer donates both to its jitted step, so neither package holds two
copies of them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import torch

from ..models.model import (DEFAULT_RUN, RunConfig, decode_step, forward,
                            loss_fn)
from ..models.params import (resolve_device, torch_dtype, tree_leaves,
                             tree_map)
from ..optim import adamw


def make_train_step(cfg, run: RunConfig = DEFAULT_RUN,
                    opt_cfg: Optional[adamw.OptimConfig] = None,
                    grad_shardings: Any = None):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``run.microbatch > 1`` splits the batch on its leading axis and
    accumulates gradients in ``run.accum_dtype`` (bfloat16 halves the
    accumulator memory), then divides and casts to float32 as the JAX
    package does.  The parameters and the optimizer state are updated in
    place and returned.  ``grad_shardings`` (a layout for the gradient
    tree) comes with the DTensor slice; until then it must be None.
    """
    if grad_shardings is not None:
        raise NotImplementedError(
            "grad_shardings needs the DTensor slice (ROADMAP.md, Queue 1)")
    opt_cfg = opt_cfg or adamw.OptimConfig()

    def grads_of(params, batch):
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        leaves = tree_leaves(live)
        with torch.enable_grad():
            loss, metrics = loss_fn(cfg, live, batch, run)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        grad_of = dict(zip(map(id, leaves), grads))
        return (tree_map(lambda t: grad_of[id(t)], live),
                {k: v.detach() for k, v in metrics.items()})

    def step(params, opt, batch):
        # parameters on the card of a host without one: raise, never
        # fall back to the CPU
        resolve_device(tree_leaves(params)[0].device)
        mb = max(1, int(run.microbatch))
        if mb == 1:
            grads, metrics = grads_of(params, batch)
        else:
            acc_dt = torch_dtype(run.accum_dtype)
            grads = metrics = None
            for i in range(mb):
                one = {k: t.reshape((mb, t.shape[0] // mb) + t.shape[1:])[i]
                       for k, t in batch.items()}
                g, m = grads_of(params, one)
                g = tree_map(lambda a: a.to(acc_dt), g)
                grads = g if grads is None else tree_map(torch.add, grads, g)
                metrics = m if metrics is None else {
                    k: metrics[k] + m[k] for k in metrics}
                del g
            grads = tree_map(lambda a: (a / mb).float(), grads)
            metrics = {k: v / mb for k, v in metrics.items()}
        params, opt, opt_metrics = adamw.update_(opt_cfg, grads, opt, params)
        return params, opt, {**metrics, **opt_metrics}

    return step


def make_prefill_step(cfg, run: RunConfig = DEFAULT_RUN):
    """(params, batch) -> logits (B, S, V); the cache-less prompt pass."""

    def step(params, batch):
        with torch.inference_mode():
            logits, _ = forward(cfg, params, batch, run)
        return logits

    return step


def apply_kernel_configs(cfg, run: RunConfig,
                         kernel_configs: Optional[Mapping[str, Mapping[str, Any]]]
                         ) -> RunConfig:
    """Fold registry-resolved kernel configs into the execution knobs.

    The serve-path gemm is the LM-head matmul; its tuned ``BLOCK_N``
    becomes the head's vocab tile (:attr:`RunConfig.head_chunk`) when it
    divides the vocab — so a tuned (or hot-swapped) winner changes the
    step, not just bookkeeping.  An explicit ``head_chunk`` on ``run``
    always wins; infeasible tiles fall back to the unchunked head.
    """
    if not kernel_configs or run.head_chunk:
        return run
    gemm = kernel_configs.get("gemm") or {}
    try:
        block_n = int(gemm.get("BLOCK_N", 0) or 0)
    except (TypeError, ValueError):
        return run
    V = cfg.vocab_size
    if 0 < block_n < V and V % block_n == 0:
        return dataclasses.replace(run, head_chunk=block_n)
    return run


def make_serve_step(cfg, run: RunConfig = DEFAULT_RUN, greedy: bool = False,
                    kernel_configs: Optional[Mapping[str, Mapping[str, Any]]]
                    = None):
    """(params, cache, tokens, pos) -> (next, cache) for one decode step.

    ``greedy=True`` returns argmax token ids (B,) int32; otherwise the raw
    logits (B, V) so samplers can be applied outside the step.  The cache
    is updated in place and returned.

    ``kernel_configs`` is the ``{kernel: config}`` map the serving engine
    resolved (and hot-swaps) for this geometry; it is folded into ``run``
    via :func:`apply_kernel_configs`.
    """
    run = apply_kernel_configs(cfg, run, kernel_configs)

    def step(params, cache, tokens, pos):
        with torch.inference_mode():
            logits, new_cache = decode_step(cfg, params, cache, tokens, pos,
                                            run)
            if greedy:
                return logits.argmax(dim=-1).to(torch.int32), new_cache
            return logits, new_cache

    return step
