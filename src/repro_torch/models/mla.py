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

from .config import ModelConfig
from .layers import _proj, apply_rope, norm_defs, rms_norm, write_clamped
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


def _project_q(cfg: ModelConfig, p, x, positions):
    nope = cfg.qk_nope_dim
    if cfg.q_lora_rank:
        ql = rms_norm(_proj(x, p["wq_a"], 1), p["q_norm"], cfg.norm_eps)
        q = _proj(ql, p["wq_b"], 1)
    else:
        q = _proj(x, p["wq"], 1)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _project_latent(cfg: ModelConfig, p, x, positions):
    kvr = cfg.kv_lora_rank
    kv = _proj(x, p["wkv_a"], 1)
    c_kv, k_rope = kv[..., :kvr], kv[..., kvr:]
    c_kv = rms_norm(c_kv, p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)   # shared head
    return c_kv, k_rope


def apply_mla(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
              positions: torch.Tensor,
              cache: Optional[Dict[str, torch.Tensor]] = None,
              cache_pos: Optional[int] = None
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x: (B, S, d).  With ``cache`` (decode): writes the latent and the
    rotary key at ``cache_pos`` in place and attends over the whole
    buffer, the rows up to each query's position valid; returns the cache."""
    scale = (cfg.qk_nope_dim + cfg.qk_rope_dim) ** -0.5

    q_nope, q_rope = _project_q(cfg, p, x, positions)
    c_kv, k_rope = _project_latent(cfg, p, x, positions)

    if cache is None:
        # train/prefill: expand K and V per head
        k_nope = _proj(c_kv, p["wk_b"], 1)                   # (B, T, H, k)
        v = _proj(c_kv, p["wv_b"], 1)
        s = (torch.einsum("bshk,bthk->bhst", q_nope.float(), k_nope.float())
             + torch.einsum("bshk,btk->bhst", q_rope.float(),
                            k_rope.float())) * scale
        mask = positions[:, None, :, None] >= positions[:, None, None, :]
        s = torch.where(mask, s, _NEG)
        probs = torch.softmax(s, dim=-1)
        out = torch.einsum("bhst,bthk->bshk", probs, v.float())
        new_cache = None
    else:
        # decode: absorbed-weight attention over the latent cache
        cc = write_clamped(cache["c_kv"], c_kv, cache_pos)
        cr = write_clamped(cache["k_rope"], k_rope, cache_pos)
        T = cc.shape[1]
        # absorb wk_b into q: q_lat (B, S, H, kvr), in the param dtype
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["wk_b"])
        s = (torch.einsum("bshr,btr->bhst", q_lat.float(), cc.float())
             + torch.einsum("bshk,btk->bhst", q_rope.float(),
                            cr.float())) * scale
        valid = torch.arange(T, device=x.device)[None, None, None, :] <= \
            positions[:, None, :, None]
        s = torch.where(valid, s, _NEG)
        probs = torch.softmax(s, dim=-1)
        o_lat = torch.einsum("bhst,btr->bshr", probs, cc.float())
        out = torch.einsum("bshr,rhk->bshk", o_lat.to(x.dtype), p["wv_b"])
        new_cache = cache

    return _proj(out.to(x.dtype), p["wo"], 2), new_cache


def mla_cache_defs(cfg: ModelConfig, batch: int, max_len: int
                   ) -> Dict[str, ParamDef]:
    return {
        "c_kv": ParamDef((batch, max_len, cfg.kv_lora_rank),
                         ("batch", "seq_kv", None), init="zeros"),
        "k_rope": ParamDef((batch, max_len, cfg.qk_rope_dim),
                           ("batch", "seq_kv", None), init="zeros"),
    }
