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

from ..dist.sharding import (is_cut, is_split, matmul, mean_over,
                             project_heads, rank_slice, reshape, run_local,
                             shard)
from .config import ModelConfig
from .params import ParamDef

_NEG = -1e30


def _proj(x: torch.Tensor, w: torch.Tensor, n_in: int) -> torch.Tensor:
    """Contract the last ``n_in`` dims of ``x`` with the first ``n_in`` of
    ``w`` (one matmul; e.g. ``bsd,dhk->bshk`` with n_in = 1)."""
    lead, k = x.shape[:x.dim() - n_in], w.shape[:n_in]
    # folded to one 2-D product, as matmul folds it; on a mesh the fold
    # goes through ``reshape``, which first gathers a lead dim that DTensor
    # cannot fold while it is split (the sequence of sequence-parallel
    # attention's output), and the product runs on local shards in
    # GSPMD's layout (``sharding.matmul``)
    out = matmul(reshape(x, (math.prod(lead), math.prod(k))),
                 reshape(w, (math.prod(k), -1)))
    return reshape(out, (*lead, *w.shape[n_in:]))


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def norm_defs(d: int) -> ParamDef:
    return ParamDef((d,), (None,), init="ones", dtype="float32")


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = mean_over(xf * xf, (-1,))
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
                       k_valid_len=None, with_lse: bool = False):
    """q: (B,S,KV,G,hd); k/v: (B,T,KV,hd) -> (B,S,KV,G,hd), float32.

    Causal mask via explicit positions; ``k_valid_len`` additionally masks
    cache slots beyond the current decode position.  ``with_lse`` also
    returns the scores' log-sum-exp (B,KV,G,S), for :func:`merge_chunks`.
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
    out = torch.einsum("bkgst,btkh->bskgh", p, v.float())
    return (out, torch.logsumexp(s, dim=-1)) if with_lse else out


def merge_chunks(parts: torch.Tensor, lse: torch.Tensor,
                 spec: str) -> torch.Tensor:
    """Attention over R chunks of the keys, merged into attention over
    them all: ``parts`` (R, ...) is each chunk's output, normalised over
    its own keys, ``lse`` (R, ...) its scores' log-sum-exp, and ``spec``
    the einsum subscripts of the two without R (``"bkgs,bskgh"``; ``z``
    is R's).  A
    chunk whose keys are all masked has an lse of about ``_NEG`` and
    weight 0."""
    w = torch.softmax(lse, dim=0)
    lhs, rhs = spec.split(",")
    return torch.einsum(f"z{lhs},z{rhs}->{rhs}", w, parts)


def effective_chunk(chunk: int, length: int) -> int:
    """The chunk a sequence of ``length`` is cut into: ``chunk`` where it
    splits the sequence (divides it, and is shorter), else 0 (no chunks).
    The rule of the chunked attention and the chunked cross-entropy."""
    return chunk if chunk and length % chunk == 0 and length > chunk else 0


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

    names = ("wq", "wk", "wv") + (("bq", "bk", "bv") if cfg.qkv_bias else ())
    expand = cache is None and mode == "expanded" and G > 1
    # expanded K/V whose KV heads cannot follow the query heads' split:
    # each rank projects only the KV heads its query heads use
    # (``sharding.project_heads``), already repeated to those heads
    by_heads = expand and is_split((B, S, H, 1, hd), Q_AXES, 2) and \
        not is_split((B, S, KV, G, hd), Q_AXES, 2)
    if cache is None and is_split((B, S), ("batch", "seq_attn"), 1):
        # sequence-parallel attention: each rank projects its own
        # positions (GSPMD cuts the products along the sequence that q's
        # layout splits); K and V are gathered along it below
        def qkv(x, *w):
            out = [torch.matmul(x, t.reshape(t.shape[0], -1)).reshape(
                x.shape[:2] + t.shape[1:]) for t in w[:3]]
            return tuple(o + b for o, b in zip(out, w[3:])) \
                if cfg.qkv_bias else tuple(out)

        q, k, v = run_local(qkv, (x,) + tuple(p[n] for n in names),
                            (("batch", "seq_attn"),) + ((),) * len(names),
                            (("batch", "seq_attn", None, None),) * 3)
    elif by_heads:
        q = _proj(x, p["wq"], 1)
        k, v = (project_heads(x, p[w], G, KV_BY_HEADS_AXES, p.get(b))
                for w, b in (("wk", "bk"), ("wv", "bv")))
        if cfg.qkv_bias:
            q = q + p["bq"]
    else:
        q = _proj(x, p["wq"], 1)
        k = _proj(x, p["wk"], 1)
        v = _proj(x, p["wv"], 1)
        if cfg.qkv_bias:
            q = q + p["bq"]
            k = k + p["bk"]
            v = v + p["bv"]

    if cache is not None and _decode_by_query_heads(q.shape, KV, cache):
        return _decode_by_heads(cfg, p, q, k, v, positions, cache,
                                int(cache_pos), x.dtype)
    KV_eff, G_eff = (H, 1) if expand else (KV, G)
    q = reshape(q, (B, S, KV_eff, G_eff, hd))
    q = shard(q, *Q_AXES)
    if cache is None:
        k = shard(k, "batch", None, "kv_heads", None)
        v = shard(v, "batch", None, "kv_heads", None)

    # the attention itself (rotary embedding, K/V expansion, scores,
    # softmax, P.V) runs on each rank's batch rows and heads: q's layout
    # decides them, K/V and the positions follow (run_local)
    theta = cfg.rope_theta
    if cache is None:
        # expanded K/V are repeated on each rank, then cut to q's heads
        # (``project_heads`` has cut them already)
        lo, hi = rank_slice(q.shape, Q_AXES, 2)
        repeat = expand and not by_heads
        kaxes = ("batch", None, None if repeat else "kv_heads")

        def core(q, k, v, qpos, kpos):
            q = apply_rope(q, qpos, theta)
            k = apply_rope(k, kpos, theta)
            if repeat:
                k = torch.repeat_interleave(k, G, dim=2)[:, :, lo:hi]
                v = torch.repeat_interleave(v, G, dim=2)[:, :, lo:hi]
            if effective_chunk(attn_chunk, k.shape[1]):
                return _chunked_attention(q, k, v, q_positions=qpos,
                                          k_positions=kpos, chunk=attn_chunk)
            return _grouped_attention(q, k, v, q_positions=qpos,
                                      k_positions=kpos)

        out = run_local(core, (q, k, v, positions, positions),
                        (Q_AXES, kaxes, kaxes, ("batch", "seq_attn"),
                         ("batch", None)), (Q_AXES,))
        new_cache = None
    else:
        # decode: S == 1; insert k/v at cache_pos, attend over the buffer.
        # The cache keeps its layout (written in place)
        pos = int(cache_pos)
        new_cache = cache
        if _time_split(cache["k"]):
            out = _decode_time_split(q, k, v, positions, cache, pos, theta)
        else:
            def core(q, k, v, qpos, ck, cv):
                q = apply_rope(q, qpos, theta)
                k = apply_rope(k, qpos, theta)
                ck = write_clamped(ck, k, pos)
                cv = write_clamped(cv, v, pos)
                Bl, T = ck.shape[:2]
                k_positions = torch.arange(T, dtype=torch.int32,
                                           device=q.device).expand(Bl, T)
                valid = torch.full((Bl,), pos + 1, dtype=torch.int32,
                                   device=q.device)
                return _grouped_attention(q, ck, cv, q_positions=qpos,
                                          k_positions=k_positions,
                                          k_valid_len=valid)

            kaxes = ("batch", None, "kv_heads")
            out = run_local(core, (q, k, v, positions, cache["k"],
                                   cache["v"]),
                            (Q_AXES, kaxes, kaxes, ("batch", "seq_attn"),
                             None, None), (Q_AXES,))

    out = reshape(out, (B, S, H, hd)).to(x.dtype)
    return shard(_proj(out, p["wo"], 2), "batch", "seq", "embed"), new_cache


#: the logical axes of the query before grouping, (B, S, H, hd)
HEAD_AXES = ("batch", "seq_attn", "heads", None)


def _time_split(ck: torch.Tensor) -> bool:
    """Whether the rules split a KV cache leaf's time dim over the mesh."""
    return is_cut(ck.shape, CACHE_AXES, 1)


def _decode_by_query_heads(qshape, KV: int, cache) -> bool:
    """Whether a decode step splits its attention by query heads: the
    rules leave the KV heads (and the cache's time) whole on the mesh
    axes that split the query heads.  Grouped by KV heads, every rank
    would attend for all heads; the JAX package's compiled step splits
    the query heads there."""
    B, S, H, hd = qshape
    if _time_split(cache["k"]):
        return False
    return H != KV and not is_split((B, S, KV, hd), CACHE_AXES, 2) and \
        is_split(qshape, HEAD_AXES, 2)


def _decode_by_heads(cfg, p, q, k, v, positions, cache, pos: int, dtype):
    """Decode attention on each rank's query heads ``[lo, hi)`` of H.  The
    KV cache is whole on the heads' mesh axes: every rank writes the new
    k/v into its copy and attends each of its heads over its KV head (the
    head's index over G).  Returns the block's output, as
    :func:`apply_attention` does."""
    G = q.shape[2] // cfg.num_kv_heads
    theta = cfg.rope_theta
    q = shard(q, *HEAD_AXES)
    lo, hi = rank_slice(q.shape, HEAD_AXES, 2)

    def core(q, k, v, qpos, ck, cv):
        q = apply_rope(q, qpos, theta)
        k = apply_rope(k, qpos, theta)
        ck = write_clamped(ck, k, pos)
        cv = write_clamped(cv, v, pos)
        Bl, T = ck.shape[:2]
        heads = torch.arange(lo, hi, device=q.device) // G
        k_positions = torch.arange(T, dtype=torch.int32,
                                   device=q.device).expand(Bl, T)
        valid = torch.full((Bl,), pos + 1, dtype=torch.int32,
                           device=q.device)
        out = _grouped_attention(q[..., None, :], ck[:, :, heads],
                                 cv[:, :, heads], q_positions=qpos,
                                 k_positions=k_positions, k_valid_len=valid)
        return out[..., 0, :]

    kaxes = ("batch", None, None)
    out = run_local(core, (q, k, v, positions, cache["k"], cache["v"]),
                    (HEAD_AXES, kaxes, kaxes, ("batch", "seq_attn"), None,
                     None), (HEAD_AXES,)).to(dtype)
    return shard(_proj(out, p["wo"], 2), "batch", "seq", "embed"), cache


def _decode_time_split(q, k, v, positions, cache, pos: int, theta: float):
    """Decode attention over a KV cache whose time dim the rules split
    over mesh axes (``seq_kv``).  Each rank holds a chunk ``[lo, hi)`` of
    the time steps: the rank whose chunk holds the (clamped) write index
    writes k/v there, every rank attends over its own chunk, and the
    chunks' outputs are merged by their log-sum-exp (an all-gather of one
    query's outputs over the time axes).  Returns (B, 1, KV, G, hd)."""
    like = (cache["k"].shape, CACHE_AXES)
    lo, hi = rank_slice(cache["k"].shape, CACHE_AXES, 1)
    at = min(max(pos, 0), cache["k"].shape[1] - 1)    # write_clamped's index

    def core(q, k, v, qpos, ck, cv):
        q = apply_rope(q, qpos, theta)
        k = apply_rope(k, qpos, theta)
        if lo <= at < hi:
            write_clamped(ck, k, at - lo)
            write_clamped(cv, v, at - lo)
        kpos = torch.arange(lo, hi, dtype=torch.int32,
                            device=q.device).expand(ck.shape[0], hi - lo)
        # the causal mask (time <= pos) is the valid length pos + 1
        out, lse = _grouped_attention(q, ck, cv, q_positions=qpos,
                                      k_positions=kpos, with_lse=True)
        return out[None], lse[None]

    heads = ("batch", None, "kv_heads")
    parts, lse = run_local(core, (q, k, v, positions, cache["k"], cache["v"]),
                           (heads, heads, heads, ("batch", None), None,
                            None),
                           (("seq_kv",) + heads,
                            ("seq_kv", "batch", "kv_heads")), like=like)
    return run_local(lambda o, l: merge_chunks(o, l, "bkgs,bskgh"),
                     (parts, lse), ((None,) + heads,
                                    (None, "batch", "kv_heads")),
                     (heads,), like=like)


#: the logical axes of a KV cache leaf (B, T, KV, hd), of the grouped
#: query (B, S, KV, G, hd) and of keys or values repeated to the query
#: heads (B, T, H, hd)
CACHE_AXES = ("batch", "seq_kv", "kv_heads", "head_dim")
Q_AXES = ("batch", "seq_attn", "kv_heads", None, None)
KV_BY_HEADS_AXES = ("batch", None, "kv_heads", None)


def attention_cache_defs(cfg: ModelConfig, batch: int, max_len: int
                         ) -> Dict[str, ParamDef]:
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    shape = (batch, max_len, KV, hd)
    return {"k": ParamDef(shape, CACHE_AXES, init="zeros"),
            "v": ParamDef(shape, CACHE_AXES, init="zeros")}


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
    up = _proj(x, p["wi"], 1)
    if "wg" in p:           # SwiGLU
        h = F.silu(_proj(x, p["wg"], 1)) * up
    else:                   # classic 2-matrix GELU MLP (jax.nn.gelu's tanh form)
        h = F.gelu(up, approximate="tanh")
    h = shard(h, "batch", "seq", "mlp")
    # the product's partial sums over the "mlp" shards are added up here,
    # in the parameter dtype, where GSPMD adds them: left partial, the
    # residual stream would carry them into the next norm, whose output
    # DTensor then keeps partial by gathering whole weights for every
    # projection after it
    return shard(_proj(h, p["wo"], 1), "batch", "seq", "embed")
