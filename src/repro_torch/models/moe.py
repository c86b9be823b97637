"""Capacity-based top-k Mixture-of-Experts (DeepSeek-V3 / Kimi-K2 style).

Dispatch is per sequence: each (token, choice) slot gets its position in
its expert from an exclusive cumsum over the sequence (slots in
sequence-major, choice-minor order), and slots at or past the capacity C
are dropped.  Three dispatches give the same values, selected by
``RunConfig.moe_impl`` as in the JAX package: ``scatter`` pushes token
activations into a (B, E, C, d) buffer, ``gather`` scatters a slot -> token
index table and pulls the activations through it, ``onehot`` is the
classic einsum dispatch (the small-E oracle).

Ties among router scores go to the lower expert index, as ``lax.top_k``
orders them (``torch.topk`` promises no order among ties on CUDA, and a
bf16 router over 256 experts does produce equal scores).  Each (expert,
position) receives at most one token, so the scatter is a plain write; the
dropped slots land in a spare row C that is sliced off.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import _proj, apply_mlp, mlp_defs
from .params import ParamDef


def moe_defs(cfg: ModelConfig) -> Dict[str, Any]:
    d, E, m = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    defs: Dict[str, Any] = {
        "router": ParamDef((d, E), ("embed", "experts"), scale=0.1),
        "wg": ParamDef((E, d, m), ("experts", "embed", "expert_mlp")),
        "wi": ParamDef((E, d, m), ("experts", "embed", "expert_mlp")),
        "wo": ParamDef((E, m, d), ("experts", "expert_mlp", "embed")),
    }
    if cfg.num_shared_experts:
        defs["shared"] = mlp_defs(
            cfg, d_ff=cfg.moe_d_ff * cfg.num_shared_experts)
    return defs


def capacity(cfg: ModelConfig, seq_len: int) -> int:
    c = int(cfg.experts_per_token * seq_len * cfg.capacity_factor
            / cfg.num_experts)
    return max(4, -(-c // 4) * 4)         # round up to a multiple of 4


def _top_k(scores: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest scores and their indices, the lower index first among
    equal scores (``lax.top_k``'s order): a stable descending sort."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(cfg: ModelConfig, p, x):
    """Return (weights, indices, logits): (B, S, k) routing weights and
    expert ids, and the float32 router logits."""
    logits = _proj(x, p["router"], 1).float()
    if cfg.router_impl == "sigmoid":       # DeepSeek-V3 style
        scores = torch.sigmoid(logits)
        topv, topi = _top_k(scores, cfg.experts_per_token)
        topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        topv, topi = _top_k(probs, cfg.experts_per_token)
    return topv, topi, logits


def _aux_loss(cfg: ModelConfig, logits, topi) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss."""
    E = cfg.num_experts
    probs = torch.softmax(logits, dim=-1)              # (B, S, E)
    me = probs.mean(dim=(0, 1))                        # mean router prob
    ce = F.one_hot(topi, E).float().mean(dim=(0, 1, 2))
    return E * torch.sum(me * ce)


def _expert_ffn(p, h):
    """h: (B, E, C, d) -> (B, E, C, d); stacked-expert SwiGLU."""
    gate = F.silu(torch.einsum("becd,edm->becm", h, p["wg"]))
    up = torch.einsum("becd,edm->becm", h, p["wi"])
    return torch.einsum("becm,emd->becd", gate * up, p["wo"])


def _positions(cfg: ModelConfig, topi, C: int):
    """(flat_e, pos, rows): each slot's expert and position in it, (B, S*k),
    overflow mapped to C; ``rows`` indexes the batch alongside them."""
    B, S, k = topi.shape
    flat_e = topi.reshape(B, S * k)
    onehot = F.one_hot(flat_e, cfg.num_experts)              # (B, S*k, E)
    pos_all = torch.cumsum(onehot, dim=1) - onehot           # pos in expert
    pos = torch.gather(pos_all, -1, flat_e[..., None])[..., 0]
    pos = torch.where(pos < C, pos, torch.full_like(pos, C))
    rows = torch.arange(B, device=topi.device)[:, None].expand(B, S * k)
    return flat_e, pos, rows


def _combine(out_buf, flat_e, pos, rows, topv, x):
    """Gather each slot's expert output (zero for a dropped slot) and sum
    the k choices with the routing weights, cast to ``x``'s dtype."""
    B, S, d = x.shape
    C = out_buf.shape[2]
    vals = out_buf[rows, flat_e, torch.clamp(pos, max=C - 1)]  # (B, S*k, d)
    vals = torch.where((pos < C)[..., None], vals, torch.zeros_like(vals))
    gathered = vals.reshape(B, S, -1, d)
    return torch.einsum("bskd,bsk->bsd", gathered, topv.to(x.dtype))


def _dispatch_scatter(cfg: ModelConfig, p, x, topv, topi):
    """Scatter-based dispatch/combine (production path)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    C = capacity(cfg, S)
    flat_e, pos, rows = _positions(cfg, topi, C)
    xk = torch.repeat_interleave(x, k, dim=1)                # (B, S*k, d)
    buf = torch.zeros((B, E, C + 1, d), dtype=x.dtype, device=x.device)
    buf[rows, flat_e, pos] = xk                              # row C: dropped
    out_buf = _expert_ffn(p, buf[:, :, :C])
    return _combine(out_buf, flat_e, pos, rows, topv, x)


def _dispatch_gather(cfg: ModelConfig, p, x, topv, topi):
    """Pull-based dispatch: a (B, E, C) slot -> token index table is
    scattered (sentinel T points at a zero row), and the activations are
    gathered through it."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    C = capacity(cfg, S)
    T = S * k
    flat_e, pos, rows = _positions(cfg, topi, C)
    tbl = torch.full((B, E, C + 1), T, dtype=torch.long, device=x.device)
    tbl[rows, flat_e, pos] = torch.arange(T, device=x.device).expand(B, T)
    slot_tok = tbl[:, :, :C]                                 # (B, E, C)
    xk = torch.repeat_interleave(x, k, dim=1)                # (B, T, d)
    xk = torch.cat([xk, torch.zeros((B, 1, d), dtype=x.dtype,
                                    device=x.device)], dim=1)
    buf = xk[torch.arange(B, device=x.device)[:, None, None], slot_tok]
    out_buf = _expert_ffn(p, buf)
    return _combine(out_buf, flat_e, pos, rows, topv, x)


def _dispatch_onehot(cfg: ModelConfig, p, x, topv, topi):
    """Classic einsum dispatch — O(S*E*C) mask; small-E oracle path."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    C = capacity(cfg, S)
    flat = F.one_hot(topi, E).reshape(B, S * k, E)           # (B, S*k, E)
    pos = torch.cumsum(flat, dim=1) - flat
    in_cap = (pos < C) & (flat > 0)
    # index C (out of capacity) is an all-zero row, as jax.nn.one_hot gives
    cap_oh = F.one_hot(torch.where(in_cap, pos, torch.full_like(pos, C)),
                       C + 1)[..., :C].to(x.dtype)           # (B,S*k,E,C)
    disp = cap_oh * flat.to(x.dtype)[..., None]
    xk = torch.repeat_interleave(x, k, dim=1)
    buf = torch.einsum("btec,btd->becd", disp, xk)
    out_buf = _expert_ffn(p, buf)
    gathered = torch.einsum("btec,becd->btd", disp, out_buf)
    gathered = gathered.reshape(B, S, k, d)
    return torch.einsum("bskd,bsk->bsd", gathered, topv.to(x.dtype))


_DISPATCH = {"scatter": _dispatch_scatter, "gather": _dispatch_gather,
             "onehot": _dispatch_onehot}


def apply_moe(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
              impl: str = "scatter") -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss)."""
    if impl not in _DISPATCH:
        raise ValueError(f"unknown MoE impl {impl!r}")
    topv, topi, logits = _router(cfg, p, x)
    routed = _DISPATCH[impl](cfg, p, x, topv, topi)
    if cfg.num_shared_experts:
        routed = routed + apply_mlp(p["shared"], x)
    return routed, _aux_loss(cfg, logits, topi)
