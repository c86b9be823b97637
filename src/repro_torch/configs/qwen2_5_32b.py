"""qwen2.5-32b [dense] — hf:Qwen/Qwen2.5-32B (family config per hf card).

64L, d_model 5120, 40 heads (GQA kv=8), d_ff 27648, vocab 152064, QKV bias.
"""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5_120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=27_648,
    vocab_size=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen2.5-32b-smoke",
    family="dense",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    qkv_bias=True,
)

SKIP_SHAPES = {"long_500k"}
NOTES = ("40 heads indivisible by model=16: attention stays head-replicated "
         "under default rules; the sharding tuner explores seq-sharded "
         "attention for this arch (EXPERIMENTS.md §Perf).")
