"""Core decoder layers: RMSNorm, rotary embedding, GQA attention, SwiGLU MLP.

All layers are functional: ``*_defs(cfg)`` returns the ParamDef tree,
``apply_*`` consumes the matching params.  The weight layouts are the JAX
package's (``wq`` is (d, H, hd), ``wo`` is (H, hd, d)), so a carried-over
tree is a copy, and so are its numerics: norms, rotary embedding and the
attention scores, softmax and P.V are computed in float32 and cast back;
the projections and the MLP stay in the parameter dtype.  Every product
here is a plain matmul (the JAX models call no Pallas kernel either).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .params import ParamDef

_NEG = -1e30


def _proj(x: torch.Tensor, w: torch.Tensor, n_in: int) -> torch.Tensor:
    """Contract the last ``n_in`` dims of ``x`` with the first ``n_in`` of
    ``w`` (one matmul; e.g. ``bsd,dhk->bshk`` with n_in = 1)."""
    lead, k = x.shape[:x.dim() - n_in], w.shape[:n_in]
    out = x.reshape(*lead, -1) @ w.reshape(math.prod(k), -1)
    return out.reshape(*lead, *w.shape[n_in:])


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def norm_defs(d: int) -> ParamDef:
    return ParamDef((d,), (None,), init="ones", dtype="float32")


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device: "torch.device | str | None" = None
                     ) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, ..., head_dim); positions: (B, S) int32.  Split halves
    (not interleaved), computed in float32 and cast back."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)              # (hd/2,)
    angles = positions.float()[..., None] * freqs              # (B, S, hd/2)
    # broadcast across any head dims between seq and head_dim
    for _ in range(x.dim() - angles.dim()):
        angles = angles[..., None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention (MHA when KV == H, MQA when KV == 1)
# ---------------------------------------------------------------------------

def attention_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    defs = {
        "wq": ParamDef((d, H, hd), ("embed", "heads", "head_dim")),
        "wk": ParamDef((d, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((d, KV, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((H, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((H, hd), ("heads", "head_dim"), init="zeros")
        defs["bk"] = ParamDef((KV, hd), ("kv_heads", "head_dim"), init="zeros")
        defs["bv"] = ParamDef((KV, hd), ("kv_heads", "head_dim"), init="zeros")
    return defs


def _grouped_attention(q, k, v, *, q_positions, k_positions,
                       k_valid_len=None) -> torch.Tensor:
    """q: (B,S,KV,G,hd); k/v: (B,T,KV,hd) -> (B,S,KV,G,hd), float32.

    Causal mask via explicit positions; ``k_valid_len`` additionally masks
    cache slots beyond the current decode position.
    """
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bskgh,btkh->bkgst", q.float(), k.float()) * scale
    mask = q_positions[:, None, None, :, None] >= \
        k_positions[:, None, None, None, :]
    if k_valid_len is not None:
        t = torch.arange(k.shape[1], device=k.device)
        mask = mask & (t[None, :] < k_valid_len[:, None]
                       )[:, None, None, None, :]
    s = torch.where(mask, s, _NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgst,btkh->bskgh", p, v.float())


def _chunked_attention(q, k, v, *, q_positions, k_positions,
                       chunk: int) -> torch.Tensor:
    """Online softmax over KV chunks — peak memory O(S * chunk) instead of
    O(S * T), the plain analogue of the flash kernel."""
    B, T, KV, hd = k.shape
    S, G = q.shape[1], q.shape[3]
    scale = q.shape[-1] ** -0.5
    qf = q.float()
    m = torch.full((B, KV, G, S, 1), _NEG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, S, KV, G, hd), dtype=torch.float32, device=q.device)
    for c0 in range(0, T, chunk):
        kb, vb = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        kp = k_positions[:, c0:c0 + chunk]
        s = torch.einsum("bskgh,btkh->bkgst", qf, kb.float()) * scale
        mask = q_positions[:, None, None, :, None] >= kp[:, None, None, None]
        s = torch.where(mask, s, _NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bkgst,btkh->bskgh", p, vb.float())
        acc = acc * alpha[..., 0].permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
    denom = torch.clamp(l[..., 0], min=1e-30).permute(0, 3, 1, 2)[..., None]
    return acc / denom


def write_clamped(buf: torch.Tensor, val: torch.Tensor,
                  start: int) -> torch.Tensor:
    """Write ``val`` into ``buf`` along dim 1 at ``start``, in place, and
    return ``buf``.  Like ``lax.dynamic_update_slice`` the start clamps to
    the buffer: a write past the end lands on the last rows."""
    at = min(max(int(start), 0), buf.shape[1] - val.shape[1])
    buf[:, at:at + val.shape[1]] = val.to(buf.dtype)
    return buf


def apply_attention(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                    x: torch.Tensor, positions: torch.Tensor,
                    cache: Optional[Dict[str, torch.Tensor]] = None,
                    cache_pos: Optional[int] = None,
                    attn_chunk: int = 0,
                    mode: str = "grouped"
                    ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x: (B, S, d).  With ``cache`` (decode): writes k/v at ``cache_pos``
    and attends over the whole cache buffer; returns the cache.

    The cache is updated in place.  Like ``lax.dynamic_update_slice`` the
    write index clamps to the buffer (a write at ``cache_pos >= max_len``
    lands at ``max_len - 1``), while every row's valid length stays
    ``cache_pos + 1``.

    ``mode`` is the full-sequence path's head layout: ``'grouped'`` (GQA
    over (KV, G) heads) or ``'expanded'`` (K/V repeated to all H heads);
    they give the same values.  Decode always uses the grouped path.
    """
    B, S, _ = x.shape
    H, KV = cfg.num_heads, cfg.num_kv_heads
    G = H // KV
    hd = cfg.resolved_head_dim

    q = _proj(x, p["wq"], 1)
    k = _proj(x, p["wk"], 1)
    v = _proj(x, p["wv"], 1)
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]

    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None and mode == "expanded" and G > 1:
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)
        KV_eff, G_eff = H, 1
    else:
        KV_eff, G_eff = KV, G
    q = q.reshape(B, S, KV_eff, G_eff, hd)

    if cache is None:
        if attn_chunk and k.shape[1] % attn_chunk == 0 \
                and k.shape[1] > attn_chunk:
            out = _chunked_attention(q, k, v, q_positions=positions,
                                     k_positions=positions,
                                     chunk=attn_chunk)
        else:
            out = _grouped_attention(q, k, v, q_positions=positions,
                                     k_positions=positions)
        new_cache = None
    else:
        # decode: S == 1; insert k/v at cache_pos, attend over the buffer
        ck = write_clamped(cache["k"], k, cache_pos)
        cv = write_clamped(cache["v"], v, cache_pos)
        T = ck.shape[1]
        k_positions = torch.arange(T, dtype=torch.int32,
                                   device=x.device).expand(B, T)
        valid = torch.full((B,), int(cache_pos) + 1, dtype=torch.int32,
                           device=x.device)
        out = _grouped_attention(q, ck, cv, q_positions=positions,
                                 k_positions=k_positions, k_valid_len=valid)
        new_cache = cache

    out = out.reshape(B, S, H, hd).to(x.dtype)
    return _proj(out, p["wo"], 2), new_cache


def attention_cache_defs(cfg: ModelConfig, batch: int, max_len: int
                         ) -> Dict[str, ParamDef]:
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (batch, max_len, KV, hd)
    axes = ("batch", "seq_kv", "kv_heads", "head_dim")
    return {"k": ParamDef(shape, axes, init="zeros"),
            "v": ParamDef(shape, axes, init="zeros")}


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_defs(cfg: ModelConfig, d_ff: Optional[int] = None,
             variant: Optional[str] = None) -> Dict[str, ParamDef]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    variant = variant or cfg.mlp_variant
    defs = {
        "wi": ParamDef((d, f), ("embed", "mlp")),
        "wo": ParamDef((f, d), ("mlp", "embed")),
    }
    if variant == "swiglu":
        defs["wg"] = ParamDef((d, f), ("embed", "mlp"))
    return defs


def apply_mlp(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    up = x @ p["wi"]
    if "wg" in p:           # SwiGLU
        h = F.silu(x @ p["wg"]) * up
    else:                   # classic 2-matrix GELU MLP (jax.nn.gelu's tanh form)
        h = F.gelu(up, approximate="tanh")
    return h @ p["wo"]
