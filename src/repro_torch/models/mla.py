"""Multi-head Latent Attention (DeepSeek-V2/V3).

Queries and keys/values are projected through low-rank latents; only the
compressed KV latent (kv_lora_rank) plus a shared rotary key (qk_rope_dim)
is cached at decode time.  Decode uses the absorbed-weight trick: scores are
computed in latent space, so per-step cost is O(S * (kv_lora + rope)) per
head instead of re-expanding the full K/V.

The casts are the JAX package's: prefill scores, softmax and P.V in
float32; decode absorbs ``wk_b`` into the query in the parameter dtype
before upcasting, and casts the attended latent back to it before
``wv_b``.  The latent cache is written in place at a clamped start
(``layers.write_clamped``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..dist.sharding import is_cut, rank_slice, run_local, shard
from .config import ModelConfig
from .layers import (_proj, apply_rope, merge_chunks, norm_defs, rms_norm,
                     write_clamped)
from .params import ParamDef

_NEG = -1e30


def mla_defs(cfg: ModelConfig) -> Dict[str, Any]:
    d, H = cfg.d_model, cfg.num_heads
    nope, rope_d = cfg.qk_nope_dim, cfg.qk_rope_dim
    vdim, kvr, qr = cfg.v_head_dim, cfg.kv_lora_rank, cfg.q_lora_rank
    defs: Dict[str, Any] = {
        # KV path: down-projection to latent + shared rotary key
        "wkv_a": ParamDef((d, kvr + rope_d), ("embed", "kv_lora")),
        "kv_norm": norm_defs(kvr),
        "wk_b": ParamDef((kvr, H, nope), ("kv_lora", "heads", "head_dim")),
        "wv_b": ParamDef((kvr, H, vdim), ("kv_lora", "heads", "head_dim")),
        "wo": ParamDef((H, vdim, d), ("heads", "head_dim", "embed")),
    }
    if qr:
        defs["wq_a"] = ParamDef((d, qr), ("embed", "q_lora"))
        defs["q_norm"] = norm_defs(qr)
        defs["wq_b"] = ParamDef((qr, H, nope + rope_d),
                                ("q_lora", "heads", "head_dim"))
    else:
        defs["wq"] = ParamDef((d, H, nope + rope_d),
                              ("embed", "heads", "head_dim"))
    return defs


def _project_q(cfg: ModelConfig, p, x):
    """The query projection (B, S, H, nope + rope), before its rotary
    half is rotated (the attention core does that on each rank)."""
    if cfg.q_lora_rank:
        ql = rms_norm(_proj(x, p["wq_a"], 1), p["q_norm"], cfg.norm_eps)
        q = _proj(ql, p["wq_b"], 1)
    else:
        q = _proj(x, p["wq"], 1)
    return shard(q, "batch", "seq", "heads", None)


def _rope_q(cfg: ModelConfig, q, positions):
    nope = cfg.qk_nope_dim
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _project_latent(cfg: ModelConfig, p, x):
    """(normalised latent c_kv, the shared rotary key before rotation)."""
    kvr = cfg.kv_lora_rank
    kv = _proj(x, p["wkv_a"], 1)
    c_kv, k_rope = kv[..., :kvr], kv[..., kvr:]
    c_kv = rms_norm(c_kv, p["kv_norm"], cfg.norm_eps)
    return c_kv, k_rope


def apply_mla(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
              positions: torch.Tensor,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              cache_pos: Optional[int] = None
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x: (B, S, d).  With ``cache`` (decode): writes the latent and the
    rotary key at ``cache_pos`` in place and attends over the whole
    buffer, the rows up to each query's position valid; returns the cache.

    The attention (rotary halves, scores, softmax, values) runs on each
    rank's batch rows and heads (``run_local``); the projections are
    DTensor products."""
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5
    theta = cfg.rope_theta

    q = _project_q(cfg, p, x)
    c_kv, k_rope = _project_latent(cfg, p, x)
    qaxes = ("batch", "seq", "heads", None)
    heads = ("batch", None, "heads")

    if cache is None:
        # train/prefill: expand K and V per head
        k_nope = _proj(c_kv, p["wk_b"], 1)                   # (B, T, H, k)
        v = _proj(c_kv, p["wv_b"], 1)

        def core(q, k_rope, k_nope, v, qpos, kpos):
            q_nope, q_rope = _rope_q(cfg, q, qpos)
            k_rope = apply_rope(k_rope, kpos, theta)          # shared head
            s = (torch.einsum("bshk,bthk->bhst", q_nope.float(),
                              k_nope.float())
                 + torch.einsum("bshk,btk->bhst", q_rope.float(),
                                k_rope.float())) * scale
            mask = qpos[:, None, :, None] >= kpos[:, None, None, :]
            s = torch.where(mask, s, _NEG)
            probs = torch.softmax(s, dim=-1)
            return torch.einsum("bhst,bthk->bshk", probs, v.float())

        out = run_local(core, (q, k_rope, k_nope, v, positions, positions),
                        (qaxes, ("batch",), heads, heads, ("batch", "seq"),
                         ("batch", None)), (qaxes,))
        new_cache = None
    else:
        # decode: absorbed-weight attention over the latent cache, written
        # in place.  Where the rules split its time dim (seq_kv), each rank
        # attends over its chunk [lo, hi) and the chunks are merged by
        # their log-sum-exp
        pos = int(cache_pos)
        dtype = x.dtype
        T = cache["c_kv"].shape[1]
        lo, hi = rank_slice(cache["c_kv"].shape, LATENT_AXES, 1)
        at = min(max(pos, 0), T - 1)

        def attend(q, c_kv, k_rope, qpos, cc, cr, wk_b):
            """(o_lat (B, S, H, kvr) float32, masked scores (B, H, S, T))
            over this rank's chunk of the cache."""
            q_nope, q_rope = _rope_q(cfg, q, qpos)
            k_rope = apply_rope(k_rope, qpos, theta)
            if lo <= at < hi:
                write_clamped(cc, c_kv, at - lo)
                write_clamped(cr, k_rope, at - lo)
            # absorb wk_b into q: q_lat (B, S, H, kvr), in the param dtype
            q_lat = torch.einsum("bshk,rhk->bshr", q_nope, wk_b)
            s = (torch.einsum("bshr,btr->bhst", q_lat.float(), cc.float())
                 + torch.einsum("bshk,btk->bhst", q_rope.float(),
                                cr.float())) * scale
            valid = torch.arange(lo, hi, device=q.device)[
                None, None, None, :] <= qpos[:, None, :, None]
            s = torch.where(valid, s, _NEG)
            probs = torch.softmax(s, dim=-1)
            return torch.einsum("bhst,btr->bshr", probs, cc.float()), s

        args = (q, c_kv, k_rope, positions, cache["c_kv"], cache["k_rope"],
                p["wk_b"])
        if not is_cut(cache["c_kv"].shape, LATENT_AXES, 1):
            def core(*a):
                o_lat, _ = attend(*a[:-1])
                return torch.einsum("bshr,rhk->bshk", o_lat.to(dtype), a[-1])

            out = run_local(
                core, args + (p["wv_b"],),
                (qaxes, ("batch",), ("batch",), ("batch", "seq"), None, None,
                 (None, "heads"), (None, "heads")), (qaxes,))
        else:
            # the time dim's layout is resolved first (``like``): the heads
            # stay split only over mesh axes the time dim is not
            like = (cache["c_kv"].shape, LATENT_AXES)

            def part(*a):
                o_lat, s = attend(*a)
                return o_lat[None], torch.logsumexp(s, dim=-1)[None]

            parts, lse = run_local(
                part, args, (heads, ("batch",), ("batch",), ("batch", None),
                             None, None, (None, "heads")),
                (("seq_kv",) + heads, ("seq_kv", "batch", "heads")),
                like=like)
            o_lat = run_local(lambda o, l: merge_chunks(o, l, "bhs,bshr"),
                              (parts, lse), ((None,) + heads,
                                             (None, "batch", "heads")),
                              (heads,), like=like)
            out = run_local(
                lambda o, w: torch.einsum("bshr,rhk->bshk", o.to(dtype), w),
                (o_lat, p["wv_b"]), (heads, (None, "heads")), (heads,),
                like=like)
        new_cache = cache

    return shard(_proj(out.to(x.dtype), p["wo"], 2), "batch", "seq",
                 "embed"), new_cache


#: the logical axes of a latent cache leaf (B, T, r)
LATENT_AXES = ("batch", "seq_kv", None)


def mla_cache_defs(cfg: ModelConfig, batch: int, max_len: int
                   ) -> Dict[str, ParamDef]:
    return {
        "c_kv": ParamDef((batch, max_len, cfg.kv_lora_rank), LATENT_AXES,
                         init="zeros"),
        "k_rope": ParamDef((batch, max_len, cfg.qk_rope_dim), LATENT_AXES,
                           init="zeros"),
    }
