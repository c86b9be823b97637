"""musicgen-medium [audio] — arXiv:2306.05284: decoder over EnCodec tokens.

48L, d_model 1536, 24 heads (kv=24), d_ff 6144, vocab 2048 (EnCodec
codebook).  The EnCodec frontend is a stub: input_specs() supplies
precomputed frame embeddings per the brief.
"""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1_536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6_144,
    mlp_variant="gelu",
    vocab_size=2_048,
    input_mode="embeddings",
)

SMOKE = ModelConfig(
    name="musicgen-medium-smoke",
    family="audio",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    head_dim=32,
    d_ff=256,
    mlp_variant="gelu",
    vocab_size=128,
    input_mode="embeddings",
)

SKIP_SHAPES = {"long_500k"}
NOTES = ("decoder-only over EnCodec tokens; frontend stubbed to frame "
         "embeddings; 24 heads indivisible by 16 -> head-replicated "
         "attention under default rules.")
