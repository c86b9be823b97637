"""PyTorch oracle for chunked (flash-style) attention.

Scores are an explicit float32 ``q @ k.T``.  A float32 product on the card
must run in full float32 (TF32 keeps about three digits); importing this
module sets that explicitly (``torch.backends.cuda.matmul.allow_tf32 =
False``) for the oracle and the plain version alike.

The causal mask is aligned bottom-right (query i sees keys up to
i + Sk - Sq, a KV prefix) and masks with the finite -1e30, not -inf: a row
with every key masked (causal with Sk < Sq) then returns the mean of v,
where -inf would give NaN.  ``F.scaled_dot_product_attention`` aligns its
causal mask top-left and is no oracle for Sq != Sk.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False

#: the mask value of the JAX package's kernel and oracle
NEG = -1e30


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        scale: float | None = None) -> torch.Tensor:
    """q: (..., Sq, D), k/v: (..., Sk, D) -> (..., Sq, D) in q's dtype."""
    sq, d = q.shape[-2:]
    sk = k.shape[-2]
    scale = (d ** -0.5) if scale is None else scale
    s = (q.to(torch.float32) @ k.to(torch.float32).transpose(-1, -2)) * scale
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        kj = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(qi >= kj, s, torch.full_like(s, NEG))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return (p @ v.to(torch.float32)).to(q.dtype)


def attention_flops(Sq: int, Sk: int, D: int, causal: bool = True) -> float:
    f = 4.0 * Sq * Sk * D          # QK^T and PV matmuls
    return f / 2 if causal else f
