"""Step-function factories shared by the trainer and the serving engine.

Each factory closes over static configuration and returns a function of
tensors.  Where the JAX package jits the step, the port calls it eagerly;
the serve step runs under ``torch.inference_mode()`` (``no_grad()`` on
a mesh).  The train step
takes its gradients with ``torch.autograd.grad`` and updates the
parameters and optimizer state in place (``adamw.update_``): the JAX
trainer donates both to its jitted step, so neither package holds two
copies of them.

On a mesh the trees hold DTensors (``repro_torch.dist.partition``) and
each step runs under ``implicit_replication()``: the plain tensors the
models make (positions, masks, zeros) meet DTensors as replicated
values, as constants do in a GSPMD program.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Mapping, Optional

import torch

from .sharding import _is_dtensor, per_batch
from ..core import trace
from ..kernels.matmul.ops import tuning_space as gemm_space
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
    place and returned.  ``grad_shardings`` (a layout tree,
    ``partition.model_shardings``) redistributes the gradient tree to
    those layouts before the optimizer update; without it, on a mesh,
    each gradient takes its parameter's layout (the update is in
    place).
    """
    opt_cfg = opt_cfg or adamw.OptimConfig()

    def grads_of(params, batch):
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        leaves = tree_leaves(live)
        with torch.enable_grad():
            with trace.span("train.forward"):
                loss, metrics = loss_fn(cfg, live, batch, run)
            with trace.span("train.backward"):
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
        grad_of = dict(zip(map(id, leaves), grads))
        return (tree_map(lambda t: grad_of[id(t)], live),
                {k: v.detach() for k, v in metrics.items()})

    def step(params, opt, batch):
        # parameters on the card of a host without one: raise, never
        # fall back to the CPU
        resolve_device(tree_leaves(params)[0].device)
        with _mesh_context(params):
            return update(params, opt, batch)

    def laid_out(grads, params):
        """Each gradient in its final layout: ``grad_shardings``', or on a
        mesh its parameter's, which the in-place update needs (autograd
        may leave a gradient partial or sharded otherwise)."""
        if grad_shardings is not None:
            from .partition import distribute
            return distribute(grads, grad_shardings)
        if _on_mesh(params):
            return tree_map(
                lambda g, p: g if tuple(g.placements) == tuple(p.placements)
                else g.redistribute(p.device_mesh, p.placements),
                grads, params)
        return grads

    def update(params, opt, batch):
        mb = max(1, int(run.microbatch))
        if mb == 1:
            grads, metrics = grads_of(params, batch)
            grads = laid_out(grads, params)
        else:
            acc_dt = torch_dtype(run.accum_dtype)
            grads = metrics = None
            for i in range(mb):
                one = {k: _microbatch(t, mb, i) for k, t in batch.items()}
                g, m = grads_of(params, one)
                # each microbatch's gradient is laid out before it is
                # added: a partial sum over the batch ranks holds the
                # whole gradient on every rank, the accumulator its shard
                g = tree_map(lambda a: a.to(acc_dt), laid_out(g, params))
                grads = g if grads is None else tree_map(torch.add, grads, g)
                metrics = m if metrics is None else {
                    k: metrics[k] + m[k] for k in metrics}
                del g
            grads = tree_map(lambda a: (a / mb).float(), grads)
            metrics = {k: v / mb for k, v in metrics.items()}
        with trace.span("train.update"):
            params, opt, opt_metrics = adamw.update_(opt_cfg, grads, opt,
                                                     params)
        return params, opt, {**metrics, **opt_metrics}

    return step


def _microbatch(t: torch.Tensor, mb: int, i: int) -> torch.Tensor:
    """Microbatch ``i`` of ``mb``: the i-th of ``mb`` equal row blocks.
    On a mesh each rank takes the i-th block of its own rows (DTensor
    cannot split a sharded dim in place), so a microbatch holds other
    rows than off a mesh; the accumulated gradient and the averaged
    metrics are the same sums."""
    def block(x):
        if x.shape[0] % mb:
            raise ValueError(f"microbatch {mb} does not divide the "
                             f"{x.shape[0]} rows of a batch shard")
        return x.reshape((mb, x.shape[0] // mb) + x.shape[1:])[i]
    return per_batch(block, t)


def _on_mesh(params) -> bool:
    """Whether ``params`` hold DTensors: its first leaf, reached without
    walking the tree (a step asks twice)."""
    while isinstance(params, Mapping):
        params = params[min(params)]
    return _is_dtensor(params)


def _mesh_context(params):
    """``implicit_replication()`` when ``params`` are DTensors."""
    if _on_mesh(params):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        return implicit_replication()
    return contextlib.nullcontext()


def _no_grad(params):
    """``inference_mode()``; ``no_grad()`` for DTensors, whose views
    inference mode refuses (a DTensor made outside it cannot be viewed
    inside it)."""
    if _on_mesh(params):
        return torch.no_grad()
    return torch.inference_mode()


def make_prefill_step(cfg, run: RunConfig = DEFAULT_RUN):
    """(params, batch) -> logits (B, S, V); the cache-less prompt pass."""

    def step(params, batch):
        with _no_grad(params), _mesh_context(params):
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
    always wins; infeasible tiles fall back to the unchunked head, and so
    does a block that is no tile of the GEMM's spaces: the heuristic's
    divisor of a vocab no listed tile divides (113 of 49,155), where the
    JAX package's heuristic takes the whole vocab and chunks nothing.
    """
    if not kernel_configs or run.head_chunk:
        return run
    gemm = kernel_configs.get("gemm") or {}
    try:
        block_n = int(gemm.get("BLOCK_N", 0) or 0)
    except (TypeError, ValueError):
        return run
    V = cfg.vocab_size
    tiles = gemm_space(extended=True)[0]["BLOCK_N"]
    if 0 < block_n < V and V % block_n == 0 and block_n in tiles:
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
        with _no_grad(params), _mesh_context(params):
            logits, new_cache = decode_step(cfg, params, cache, tokens, pos,
                                            run)
            if greedy:
                return logits.argmax(dim=-1).to(torch.int32), new_cache
            return logits, new_cache

    return step
