"""Step-function factories shared by the serving engine and (later) the
trainer.

Each factory closes over static configuration and returns a function of
tensors.  Where the JAX package jits the step, the port calls it eagerly;
the serve step runs under ``torch.inference_mode()``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import torch

from ..models.model import DEFAULT_RUN, RunConfig, decode_step, forward


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
