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

On a mesh (``repro_torch.dist.sharding``) the routing is computed on each
rank's batch rows (``per_batch``), and the dispatched (B, E, C, d) buffer
is built capacity-chunked over the mesh axes that hold the experts: every
rank holds its batch rows' tokens, so it scatters the slots of its own
capacity chunk, and the ``shard`` to the expert layout is an all-to-all.
The combine runs the other way — an all-to-all back to capacity chunks,
each rank summing its chunk's slots, and an all-reduce of those partial
sums.  Off a mesh the chunk is the whole capacity and the code is the
single-device dispatch.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..dist.sharding import (per_batch, rank_slice, replicate, reshape,
                             run_local, shard)
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
        topv, topi = per_batch(lambda s: _top_k(s, cfg.experts_per_token),
                               scores, outs=2)
        topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        topv, topi = per_batch(lambda s: _top_k(s, cfg.experts_per_token),
                               probs, outs=2)
    return topv, topi, logits


def _aux_loss(cfg: ModelConfig, logits, topi) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss."""
    E = cfg.num_experts
    probs = torch.softmax(logits, dim=-1)              # (B, S, E)
    me = replicate(probs.mean(dim=(0, 1)))             # mean router prob
    ce = replicate(per_batch(lambda t: F.one_hot(t, E).float(), topi).mean(
        dim=(0, 1, 2)))
    return E * torch.sum(me * ce)


def _expert_ffn(p, h):
    """h: (B, E, C, d) -> (B, E, C, d); stacked-expert SwiGLU, one
    batched product over the experts per weight (the products
    ``einsum("becd,edm->becm")`` makes, laid out so that DTensor's views
    see contiguous shards)."""
    B, E, C, d = h.shape
    he = reshape(h.transpose(0, 1).contiguous(), (E, B * C, d))
    gate = F.silu(torch.bmm(he, p["wg"]))
    up = torch.bmm(he, p["wi"])
    out = torch.bmm(gate * up, p["wo"])
    return reshape(out, (E, B, C, d)).transpose(0, 1)


def _positions(cfg: ModelConfig, topi, C: int, lo: int = 0,
               hi: Optional[int] = None):
    """(flat_e, pos, rows): each slot's expert and position in the
    capacity chunk ``[lo, hi)``, (B, S*k), a slot outside it (past the
    capacity C among them) mapped to ``hi - lo``; ``rows`` indexes the
    batch alongside them."""
    hi = C if hi is None else hi
    B, S, k = topi.shape
    flat_e = topi.reshape(B, S * k)
    onehot = F.one_hot(flat_e, cfg.num_experts)              # (B, S*k, E)
    pos_all = torch.cumsum(onehot, dim=1) - onehot           # pos in expert
    pos = torch.gather(pos_all, -1, flat_e[..., None])[..., 0]
    inside = (pos >= lo) & (pos < hi) if lo else pos < hi
    pos = torch.where(inside, pos - lo if lo else pos,
                      torch.full_like(pos, hi - lo))
    rows = torch.arange(B, device=topi.device)[:, None].expand(B, S * k)
    return flat_e, pos, rows


def _dispatch(cfg: ModelConfig, p, x, topv, topi, fill):
    """Dispatch -> expert FFN -> combine, around ``fill(x, slots, n)``,
    which builds a (B, E, n, d) buffer of one capacity chunk (the whole
    capacity off a mesh; the module docstring has the layout on one) from
    the slots (flat_e, pos, rows) of :func:`_positions`.  The slots are
    computed once: the combine runs on the same batch rows and chunk."""
    C = capacity(cfg, x.shape[1])
    # the capacity is chunked over the mesh axes that hold the experts
    like = ((C,), ("experts",))
    lo, hi = rank_slice(*like, 0)
    slots = []

    def build(x, topi):
        slots.extend(_positions(cfg, topi, C, lo, hi))
        return fill(x, slots, hi - lo)

    buf = run_local(build, (x, topi), (("batch",), ("batch",)),
                    (("batch", None, "experts"),), like=like)
    buf = shard(buf, "batch", "experts", "expert_cap", "embed")
    out_buf = _expert_ffn(p, buf)
    out_buf = shard(out_buf, "batch", "experts", "expert_cap", "embed")

    def combine(out_buf, topv):
        """Gather each slot's expert output (zero for a dropped slot) and
        sum the k choices with the routing weights, in ``x``'s dtype."""
        flat_e, pos, rows = slots
        B, S, k = topv.shape
        n = hi - lo
        vals = out_buf[rows, flat_e, torch.clamp(pos, max=n - 1)]
        vals = torch.where((pos < n)[..., None], vals, torch.zeros_like(vals))
        gathered = vals.reshape(B, S, k, -1)
        return torch.einsum("bskd,bsk->bsd", gathered, topv.to(x.dtype))

    out = run_local(combine, (out_buf, topv),
                    (("batch", None, "experts"), ("batch",)), (("batch",),),
                    partial=("experts",), like=like)
    return shard(out, "batch", "seq", "embed")              # all-reduce


def _dispatch_scatter(cfg: ModelConfig, p, x, topv, topi):
    """Scatter-based dispatch/combine (production path)."""
    E, k, d = cfg.num_experts, cfg.experts_per_token, x.shape[2]

    def fill(x, slots, n):
        flat_e, pos, rows = slots
        xk = torch.repeat_interleave(x, k, dim=1)            # (B, S*k, d)
        buf = torch.zeros((x.shape[0], E, n + 1, d), dtype=x.dtype,
                          device=x.device)
        buf[rows, flat_e, pos] = xk                   # last row: dropped
        return buf[:, :, :n]

    return _dispatch(cfg, p, x, topv, topi, fill)


def _dispatch_gather(cfg: ModelConfig, p, x, topv, topi):
    """Pull-based dispatch: a (B, E, C) slot -> token index table is
    scattered (sentinel T points at a zero row), and the activations are
    gathered through it."""
    E, k, d = cfg.num_experts, cfg.experts_per_token, x.shape[2]
    T = x.shape[1] * k

    def fill(x, slots, n):
        flat_e, pos, rows = slots
        Bl = x.shape[0]
        tbl = torch.full((Bl, E, n + 1), T, dtype=torch.long,
                         device=x.device)
        tbl[rows, flat_e, pos] = torch.arange(T, device=x.device).expand(
            Bl, T)
        slot_tok = tbl[:, :, :n]                             # (B, E, C)
        xk = torch.repeat_interleave(x, k, dim=1)            # (B, T, d)
        xk = torch.cat([xk, torch.zeros((Bl, 1, d), dtype=x.dtype,
                                        device=x.device)], dim=1)
        return xk[torch.arange(Bl, device=x.device)[:, None, None], slot_tok]

    return _dispatch(cfg, p, x, topv, topi, fill)


def _dispatch_onehot(cfg: ModelConfig, p, x, topv, topi):
    """Classic einsum dispatch — O(S*E*C) mask; small-E oracle path."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    C = capacity(cfg, S)

    def masks(topi, x):
        flat = F.one_hot(topi, E).reshape(x.shape[0], S * k, E)
        pos = torch.cumsum(flat, dim=1) - flat
        in_cap = (pos < C) & (flat > 0)
        # index C (out of capacity) is an all-zero row, as jax.nn.one_hot
        # gives
        cap_oh = F.one_hot(torch.where(in_cap, pos, torch.full_like(pos, C)),
                           C + 1)[..., :C].to(x.dtype)       # (B,S*k,E,C)
        return (cap_oh * flat.to(x.dtype)[..., None],
                torch.repeat_interleave(x, k, dim=1))

    disp, xk = per_batch(masks, topi, x, outs=2)
    buf = torch.einsum("btec,btd->becd", disp, xk)
    out_buf = _expert_ffn(p, buf)
    gathered = torch.einsum("btec,becd->btd", disp, out_buf)
    gathered = reshape(gathered, (B, S, k, d))
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
    return shard(routed, "batch", "seq", "embed"), _aux_loss(cfg, logits,
                                                             topi)
