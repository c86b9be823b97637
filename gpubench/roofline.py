"""The yardstick's arithmetic: the card's peaks and each op's useful
operations and bytes, counted from shapes alone.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity, at the
700 W power limit).  Each input byte is counted once and each output byte
once, whatever a kernel reads again; operations are the useful ones only
(a causal mask's kept pairs, not S^2).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

#: bf16 tensor-core peak, FLOP/s
PEAK_BF16_FLOPS = 989e12
#: float32 peak outside the tensor cores, FLOP/s
PEAK_F32_FLOPS = 67e12
#: HBM3 bandwidth, bytes/s
PEAK_HBM_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float,
            peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time the card could take: operations at the peak rate or
    bytes at the memory rate, the larger."""
    return max(flops / peak_flops, nbytes / PEAK_HBM_BYTES)


def gemm_flops(M: int, N: int, K: int) -> float:
    return 2.0 * M * N * K


def gemm_bytes(M: int, N: int, K: int, elt: int = 2) -> float:
    """A and B read once, C written once."""
    return float(elt) * (M * K + K * N + M * N)


def causal_pairs(S: int) -> int:
    """Query-key pairs a causal mask keeps in one sequence of S."""
    return S * (S + 1) // 2


def flash_flops(heads: int, S: int, D: int) -> float:
    """Causal self-attention: QK^T and PV, 2 products of 2 D operations
    each for every kept pair."""
    return 4.0 * D * heads * causal_pairs(S)


def flash_bytes(heads: int, S: int, D: int, elt: int = 2) -> float:
    """q, k, v read once and the output written once."""
    return float(elt) * 4 * heads * S * D


def gated(cfg: Dict) -> bool:
    """Whether the feed-forward is gated (SwiGLU: gate, up and down) rather
    than a two-matrix GELU MLP."""
    return cfg["hidden_act"] == "silu"


def dense_products(cfg: Dict) -> List[Tuple[str, int, int]]:
    """(name, K, N) of one dense decoder layer's weight products, in layer
    order: x @ W with W (K, N)."""
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    KV, hd = cfg["num_key_value_heads"], cfg["head_dim"]
    ff = cfg["intermediate_size"]
    out = [("q", d, H * hd), ("k", d, KV * hd), ("v", d, KV * hd),
           ("o", H * hd, d)]
    if gated(cfg):
        out.append(("gate", d, ff))
    out += [("up", d, ff), ("down", ff, d)]
    return out


def layer_gemm_flops(cfg: Dict, M: int) -> float:
    return sum(gemm_flops(M, N, K) for _, K, N in dense_products(cfg))


def product_params(cfg: Dict) -> int:
    """Parameters that enter a product: every layer's projections and the
    LM head (the embedding is a gather, the norms elementwise)."""
    per_layer = sum(K * N for _, K, N in dense_products(cfg))
    return cfg["num_hidden_layers"] * per_layer \
        + cfg["hidden_size"] * cfg["vocab_size"]


def train_step_flops(cfg: Dict, batch: int, seq: int) -> float:
    """Model operations of one training step: 6 per product parameter and
    token (forward 2, backward 4), plus causal attention's score and value
    products, 3 x 4 H Dh for every pair the mask keeps."""
    tokens = batch * seq
    attn = 3 * 4 * cfg["num_attention_heads"] * cfg["head_dim"] * batch \
        * causal_pairs(seq) * cfg["num_hidden_layers"]
    return 6.0 * product_params(cfg) * tokens + attn
