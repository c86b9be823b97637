"""Plain references of the op cells' calls, in float32 (TF32 off): a
product ``a @ b`` and causal (or full) scaled dot-product attention over
heads, the latter a few heads at a time so that the scores fit."""

from __future__ import annotations

import torch

from .precision import full_float32, product


def matmul(a: torch.Tensor, b: torch.Tensor,
           precision: str = "float32") -> torch.Tensor:
    """(M, K) @ (K, N) -> (M, N) float32."""
    full_float32()
    return product(precision)(a.float(), b.float())


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, precision: str = "float32",
              heads_per_block: int = 4) -> torch.Tensor:
    """q, k, v: (heads, S, D) -> (heads, S, D) float32; each query attends
    to the keys at or before its position where ``causal``."""
    full_float32()
    mm = product(precision)
    H, S, D = q.shape
    out = torch.empty(H, S, D, dtype=torch.float32, device=q.device)
    keep = (torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
            if causal else None)
    for h0 in range(0, H, heads_per_block):
        sl = slice(h0, h0 + heads_per_block)
        s = mm(q[sl].float(), k[sl].float().mT) * D ** -0.5
        if keep is not None:
            s = s.masked_fill_(~keep, float("-inf"))
        p = s.softmax(-1)
        del s
        out[sl] = mm(p, v[sl].float())
        del p
    return out
