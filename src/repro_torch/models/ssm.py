"""Mamba2 / SSD (state-space duality) blocks — arXiv:2405.21060.

Chunked SSD: within chunks of length Q the recurrence is computed as a
masked quadratic form (the "attention dual"); across chunks a linear scan
carries the (H, P, N) state.  Decode is the pure recurrence (O(1) state).

Activations keep the (heads H, head-channels P) axes separate, as the JAX
package does.  Single B/C group (G=1): both SSM configs use one group; the
group dimension is elided.

The dtypes are the JAX package's: the scan, the state ``h`` and ``dt``
(softplus after adding ``dt_bias``) in float32, the convolutions in the
parameter dtype, the gated norm's scale in float32.  Decode returns new
state tensors and leaves the ones it was given as they were: the
recurrence is not idempotent, so a repeated step must start from the same
state.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..dist.sharding import mean_over, run_local, shard
from .config import ModelConfig
from .layers import _proj
from .params import ParamDef


def mamba_defs(cfg: ModelConfig) -> Dict[str, Any]:
    d = cfg.d_model
    H, P = cfg.ssm_num_heads, cfg.ssm_head_dim
    N, W = cfg.ssm_state, cfg.ssm_conv_width
    return {
        "wz": ParamDef((d, H, P), ("embed", "ssm_heads", "ssm_pdim")),
        "wx": ParamDef((d, H, P), ("embed", "ssm_heads", "ssm_pdim")),
        "wB": ParamDef((d, N), ("embed", "ssm_state")),
        "wC": ParamDef((d, N), ("embed", "ssm_state")),
        "wdt": ParamDef((d, H), ("embed", "ssm_heads")),
        "dt_bias": ParamDef((H,), ("ssm_heads",), init="zeros"),
        "A_log": ParamDef((H,), ("ssm_heads",), init="zeros"),
        "D": ParamDef((H,), ("ssm_heads",), init="ones"),
        "conv_x": ParamDef((W, H, P), (None, "ssm_heads", "ssm_pdim"),
                           init="normal", scale=0.5),
        "conv_B": ParamDef((W, N), (None, "ssm_state"),
                           init="normal", scale=0.5),
        "conv_C": ParamDef((W, N), (None, "ssm_state"),
                           init="normal", scale=0.5),
        "norm": ParamDef((H, P), ("ssm_heads", "ssm_pdim"), init="ones",
                         dtype="float32"),
        "wo": ParamDef((H, P, d), ("ssm_heads", "ssm_pdim", "embed")),
    }


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the JAX package computes it on the CPU:
    ``x * (1 / (1 + exp(-x)))``, each operation rounded to ``x``'s dtype
    (``F.silu`` rounds once, which moves a bf16 result by an ulp)."""
    return x * (1 / (1 + torch.exp(-x)))


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, L, ...) ; w: (W, ...) broadcastable — causal depthwise conv."""
    W, L = w.shape[0], x.shape[1]
    pad = torch.zeros((x.shape[0], W - 1) + tuple(x.shape[2:]),
                      dtype=x.dtype, device=x.device)
    xp = torch.cat([pad, x], dim=1)
    out = torch.zeros_like(x)
    for i in range(W):                     # W is 4: unrolled shifts
        out = out + w[i] * xp[:, i:i + L]
    return out


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    """Mamba2's gated RMSNorm over the (H, P) channels."""
    g = y * F.silu(z.float())
    var = mean_over(g * g, (-2, -1))
    return g * torch.rsqrt(var + eps) * scale


def _project(cfg: ModelConfig, p, x):
    """x: (B, L, d) -> z, xin, B, C, dt (pre-conv, pre-activation)."""
    z = _proj(x, p["wz"], 1)
    xin = _proj(x, p["wx"], 1)
    Bm = _proj(x, p["wB"], 1)
    Cm = _proj(x, p["wC"], 1)
    dt = F.softplus(_proj(x, p["wdt"], 1).float() + p["dt_bias"].float())
    return z, xin, Bm, Cm, dt


def ssd_chunked(xin, Bm, Cm, dt, A, D, chunk: int,
                h0: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    xin: (B, L, H, P) f32; Bm/Cm: (B, L, N) f32; dt: (B, L, H) f32;
    A: (H,) f32 negative; returns y: (B, L, H, P) and final state
    (B, H, P, N).  ``L`` must be a multiple of ``min(chunk, L)``.
    """
    Bsz, L, H, P = xin.shape
    N = Bm.shape[-1]
    Q = min(chunk, L)
    if L % Q:
        raise AssertionError(f"seq {L} % chunk {Q}")
    Cn = L // Q

    def r(t, tail):
        return t.reshape((Bsz, Cn, Q) + tail)

    xc, bc, cc, dtc = (r(xin, (H, P)), r(Bm, (N,)), r(Cm, (N,)),
                       r(dt, (H,)))

    dA = dtc * A                                        # (B,Cn,Q,H), negative
    la = torch.cumsum(dA, dim=2)                        # within-chunk log decay

    # intra-chunk (attention dual): scores masked by inter-position decay
    scores = torch.einsum("bcqn,bckn->bcqk", cc, bc)    # (B,Cn,Q,Q)
    dmat = la[:, :, :, None, :] - la[:, :, None, :, :]  # (B,Cn,Q,Q,H) q vs k
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=xin.device))
    # masked before exp, not after: above the diagonal dmat is a positive
    # sum of decays that overflows exp past ~88, and exp's gradient there
    # (inf times the masked zero) would be NaN.  The JAX package masks
    # after exp; the values are the same, the gradients the same wherever
    # the JAX package's are finite
    decay = torch.exp(dmat.masked_fill(~mask[None, None, :, :, None],
                                       float("-inf")))
    m = scores[..., None] * decay                       # (B,Cn,Q,Q,H)
    y_intra = torch.einsum("bcqkh,bckh,bckhp->bcqhp", m, dtc, xc)

    # chunk summaries: state contribution of each chunk
    decay_end = torch.exp(la[:, :, -1:, :] - la)        # (B,Cn,Q,H)
    S = torch.einsum("bcqh,bcqn,bcqhp->bchpn", decay_end * dtc, bc, xc)

    # inter-chunk linear scan, emitting the state BEFORE each chunk
    chunk_decay = torch.exp(la[:, :, -1, :])            # (B,Cn,H)
    h = (torch.zeros((Bsz, H, P, N), dtype=xin.dtype, device=xin.device)
         if h0 is None else h0)
    h_prev = []
    for c in range(Cn):
        h_prev.append(h)
        h = chunk_decay[:, c, :, None, None] * h + S[:, c]
    h_prev = torch.stack(h_prev, dim=1)                 # (B,Cn,H,P,N)

    y_inter = torch.einsum("bcqn,bcqh,bchpn->bcqhp", cc, torch.exp(la),
                           h_prev)
    y = (y_intra + y_inter).reshape(Bsz, L, H, P) + D[:, None] * xin
    return y, h


def apply_mamba(cfg: ModelConfig, p: Dict[str, Any], x: torch.Tensor,
                state: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x: (B, L, d).  With ``state`` (decode, L == 1): pure recurrence,
    returning a new state."""
    A = -torch.exp(p["A_log"].float())
    D = p["D"].float()
    z, xin, Bm, Cm, dt = _project(cfg, p, x)
    # the convolutions and the scan run on each rank's batch rows and
    # heads (run_local); the sequence is never split
    xin = shard(xin, "batch", "seq", "ssm_heads", "ssm_pdim")
    xaxes = ("batch", None, "ssm_heads")
    convs = (p["conv_x"], p["conv_B"], p["conv_C"])
    conv_axes = ((None, "ssm_heads"), (), ())
    ins = (xaxes, ("batch",), ("batch",), xaxes, ("ssm_heads",),
           ("ssm_heads",)) + conv_axes

    if state is None:
        def mix(xin, Bm, Cm, dt, A, D, wx, wB, wC):
            xin = _silu(_causal_conv(xin, wx))
            Bm = _silu(_causal_conv(Bm, wB))
            Cm = _silu(_causal_conv(Cm, wC))
            return ssd_chunked(xin.float(), Bm.float(), Cm.float(), dt, A, D,
                               cfg.ssm_chunk)[0]

        y = run_local(mix, (xin, Bm, Cm, dt, A, D) + convs, ins, (xaxes,))
        new_state = None
    else:
        # decode: roll conv windows, single-step recurrence
        def roll(buf, new):                              # (B,W,...) <- (B,1,...)
            return torch.cat([buf[:, 1:], new.to(buf.dtype)], dim=1)

        def conv(buf, w):                                # in the param dtype
            return torch.einsum("bw...,w...->b...", buf, w)

        def step(xin, Bm, Cm, dt, A, D, wx, wB, wC, sx, sB, sC, sh):
            cx = roll(sx, xin)
            cB = roll(sB, Bm)
            cC = roll(sC, Cm)
            xt = _silu(conv(cx, wx))                     # (B,H,P)
            bt = _silu(conv(cB, wB))                     # (B,N)
            ct = _silu(conv(cC, wC))                     # (B,N)
            dtt = dt[:, 0]                               # (B,H)
            dA = torch.exp(dtt * A)                      # (B,H)
            hn = dA[:, :, None, None] * sh + torch.einsum(
                "bh,bn,bhp->bhpn", dtt, bt.float(), xt.float())
            yt = torch.einsum("bn,bhpn->bhp", ct.float(), hn) \
                + D[:, None] * xt.float()
            return yt[:, None], cx, cB, cC, hn           # y: (B,1,H,P)

        saxes = {"conv_x": xaxes, "conv_B": ("batch",),
                 "conv_C": ("batch",), "h": ("batch", "ssm_heads")}
        names = ("conv_x", "conv_B", "conv_C", "h")
        y, *new = run_local(
            step, (xin, Bm, Cm, dt, A, D) + convs
            + tuple(state[k] for k in names),
            ins + tuple(saxes[k] for k in names),
            (xaxes,) + tuple(saxes[k] for k in names))
        new_state = dict(zip(names, new))

    y = _gated_norm(y, z, p["norm"], cfg.norm_eps).to(x.dtype)
    return shard(_proj(y, p["wo"], 2), "batch", "seq", "embed"), new_state


def mamba_state_defs(cfg: ModelConfig, batch: int) -> Dict[str, ParamDef]:
    H, P = cfg.ssm_num_heads, cfg.ssm_head_dim
    N, W = cfg.ssm_state, cfg.ssm_conv_width
    return {
        "h": ParamDef((batch, H, P, N),
                      ("batch", "ssm_heads", "ssm_pdim", "ssm_state"),
                      init="zeros", dtype="float32"),
        "conv_x": ParamDef((batch, W, H, P),
                           ("batch", None, "ssm_heads", "ssm_pdim"),
                           init="zeros"),
        "conv_B": ParamDef((batch, W, N), ("batch", None, "ssm_state"),
                           init="zeros"),
        "conv_C": ParamDef((batch, W, N), ("batch", None, "ssm_state"),
                           init="zeros"),
    }
