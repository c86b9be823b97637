"""Decoder assembly: param trees, forward, decode — dense, VLM and audio.

The layer stack keeps the JAX package's stacked ``(L, ...)`` parameters
and runs a Python loop over their layers where JAX has ``lax.scan``.
``RunConfig`` carries the execution knobs of the JAX package field for
field, so derived configs and memo keys match; ``scan_blocks`` and
``remat`` change no value here (``remat`` gets its meaning with training).

The families with experts, latent attention (MLA) or state-space blocks
(``moe``, ``ssm``, ``hybrid``, ``use_mla``) are later slices: every entry
point raises ``NotImplementedError`` for them rather than run them as
dense.  The loss (``loss_fn``/``cross_entropy``) comes with training.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from .config import ModelConfig
from .layers import (apply_attention, apply_mlp, attention_cache_defs,
                     attention_defs, mlp_defs, norm_defs, rms_norm)
from .params import (ParamDef, abstract_params, init_params, stack_defs,
                     torch_dtype)

_REMAT = ("none", "full", "dots")


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Execution knobs (a point in the sharding tuner's space)."""

    remat: str = "none"              # none | full | dots
    moe_impl: str = "scatter"        # scatter | onehot
    attn_chunk: int = 0              # 0 = unchunked; else KV chunk length
    #: attention layout: grouped | expanded (see layers.apply_attention)
    attn_mode: str = "grouped"
    scan_blocks: bool = True         # scan over layers vs unroll (JAX only)
    microbatch: int = 1              # gradient-accumulation splits
    #: gradient-accumulation dtype (training)
    accum_dtype: str = "float32"
    #: sequence-chunked cross-entropy (training)
    ce_chunk: int = 0
    #: vocab-chunked LM head: the (d, V) head matmul is issued as V/chunk
    #: column tiles (the serve path derives this from the tuned gemm
    #: BLOCK_N, so a hot-swapped winner changes the step).  0 = one
    #: whole-vocab product; ignored unless it divides the vocab exactly.
    head_chunk: int = 0

    def remat_policy(self) -> Optional[str]:
        """The recomputation policy's name (None for ``"none"``); unknown
        names raise, as in the JAX package."""
        if self.remat not in _REMAT:
            raise ValueError(f"unknown remat {self.remat!r}")
        return None if self.remat == "none" else self.remat


DEFAULT_RUN = RunConfig()


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "vlm", "audio") or cfg.is_moe \
            or cfg.use_mla:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r}"
            f"{' with experts' if cfg.is_moe else ''}"
            f"{' with MLA' if cfg.use_mla else ''} is not ported yet "
            f"(ROADMAP.md, Queue 1: models/moe.py, mla.py, ssm.py)")


# ---------------------------------------------------------------------------
# parameter trees
# ---------------------------------------------------------------------------

def _attn_block_defs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    return {"ln1": norm_defs(d), "ln2": norm_defs(d),
            "attn": attention_defs(cfg), "mlp": mlp_defs(cfg)}


def model_defs(cfg: ModelConfig) -> Dict[str, Any]:
    _check_ported(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    defs: Dict[str, Any] = {
        "embed": ParamDef((V, d), ("vocab", "embed"), init="normal",
                          scale=0.02),
        "final_norm": norm_defs(d),
        "blocks": stack_defs(_attn_block_defs(cfg), cfg.num_layers),
    }
    if not cfg.tie_embeddings:
        defs["head"] = ParamDef((d, V), ("embed", "vocab"))
    return defs


def init_model(cfg: ModelConfig,
               generator: "torch.Generator | int | None" = 0,
               device: "torch.device | str | None" = None):
    """Random weights on ``device`` (default: the card) from a
    ``torch.Generator`` or a seed."""
    return init_params(model_defs(cfg), generator, cfg.param_dtype, device)


def abstract_model(cfg: ModelConfig):
    return abstract_params(model_defs(cfg), cfg.param_dtype)


def _layers(stacked: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
    """Per-layer views of a stacked ``(L, ...)`` tree, one unbind a leaf."""
    if isinstance(stacked, torch.Tensor):
        return list(stacked.unbind(0))
    per = {k: _layers(v, n) for k, v in stacked.items()}
    return [{k: v[i] for k, v in per.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# block body
# ---------------------------------------------------------------------------

def _attn_block(cfg: ModelConfig, run: RunConfig, p, x, positions,
                cache=None, cache_pos=None):
    """Returns (x, cache)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, new_cache = apply_attention(cfg, p["attn"], h, positions,
                                   cache=cache, cache_pos=cache_pos,
                                   attn_chunk=run.attn_chunk,
                                   mode=run.attn_mode)
    x = x + a
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + apply_mlp(p["mlp"], h), new_cache


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def embed_inputs(cfg: ModelConfig, params, batch
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    if cfg.input_mode == "embeddings":
        x = batch["embeds"].to(torch_dtype(cfg.param_dtype))
    else:
        x = params["embed"][batch["tokens"]]
    B, S = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
    return x, positions


def _head_logits(cfg: ModelConfig, params, x_normed,
                 run: RunConfig = DEFAULT_RUN) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    V = cfg.vocab_size
    hc = int(run.head_chunk)
    if 0 < hc < V and V % hc == 0:
        # column-tiled head: the same values as the single product, issued
        # as V / hc products of the tuned tile width
        logits = torch.cat([torch.matmul(x_normed, head[:, i:i + hc])
                            for i in range(0, V, hc)], dim=-1)
    else:
        logits = torch.matmul(x_normed, head)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _logits(cfg: ModelConfig, params, x,
            run: RunConfig = DEFAULT_RUN) -> torch.Tensor:
    return _head_logits(cfg, params,
                        rms_norm(x, params["final_norm"], cfg.norm_eps), run)


def forward_hidden(cfg: ModelConfig, params, batch,
                   run: RunConfig = DEFAULT_RUN
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backbone forward up to (but excluding) the LM head.

    Returns (hidden (B,S,d) after final norm, aux_loss scalar)."""
    _check_ported(cfg)
    run.remat_policy()
    x, positions = embed_inputs(cfg, params, batch)
    for p in _layers(params["blocks"], cfg.num_layers):
        x, _ = _attn_block(cfg, run, p, x, positions)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def forward(cfg: ModelConfig, params, batch,
            run: RunConfig = DEFAULT_RUN
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits (B,S,V), aux_loss scalar)."""
    x, aux = forward_hidden(cfg, params, batch, run)
    return _head_logits(cfg, params, x, run), aux


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------

def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> Dict[str, Any]:
    _check_ported(cfg)
    return {"blocks": stack_defs(attention_cache_defs(cfg, batch, max_len),
                                 cfg.num_layers)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: "torch.device | str | None" = None):
    """A zero KV cache on ``device`` (default: the card)."""
    return init_params(cache_defs(cfg, batch, max_len), 0, cfg.param_dtype,
                       device)


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int):
    return abstract_params(cache_defs(cfg, batch, max_len), cfg.param_dtype)


def decode_step(cfg: ModelConfig, params, cache, tokens_or_embeds,
                pos: int, run: RunConfig = DEFAULT_RUN
                ) -> Tuple[torch.Tensor, Any]:
    """One decode step.  tokens: (B, 1) int (or (B, 1, d) embeds);
    pos: the current position.  Returns (logits (B, V), cache); the cache
    is updated in place, so a second call on the same inputs gives the
    same answer."""
    _check_ported(cfg)
    if cfg.input_mode == "embeddings":
        x = tokens_or_embeds.to(torch_dtype(cfg.param_dtype))
    else:
        x = params["embed"][tokens_or_embeds]
    B = x.shape[0]
    pos = int(pos)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    L = cfg.num_layers
    for p, c in zip(_layers(params["blocks"], L),
                    _layers(cache["blocks"], L)):
        x, _ = _attn_block(cfg, run, p, x, positions, cache=c, cache_pos=pos)
    logits = _logits(cfg, params, x, run)[:, 0]
    return logits, cache

