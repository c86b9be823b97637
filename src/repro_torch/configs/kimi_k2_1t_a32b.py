"""kimi-k2-1t-a32b [moe] — Kimi K2 trillion-param MoE (paper-table config).

61L, d_model 7168, 64 heads (GQA kv=8 per the assignment table), per-expert
d_ff 2048, vocab 163840, 384 routed experts top-8 + 1 shared, 1 leading
dense layer.
"""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    num_layers=61,
    d_model=7_168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=18_432,                 # leading dense layer FFN
    vocab_size=163_840,
    num_experts=384,
    experts_per_token=8,
    moe_d_ff=2_048,
    num_shared_experts=1,
    moe_first_dense=1,
    router_impl="sigmoid",
)

SMOKE = ModelConfig(
    name="kimi-k2-1t-a32b-smoke",
    family="moe",
    num_layers=3,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    num_experts=8,
    experts_per_token=2,
    moe_d_ff=64,
    num_shared_experts=1,
    moe_first_dense=1,
    router_impl="sigmoid",
)

SKIP_SHAPES = {"long_500k"}
NOTES = ("assignment table specifies GQA kv=8 (not MLA) — implemented as "
         "given; 384 experts = 24 per model shard.")
