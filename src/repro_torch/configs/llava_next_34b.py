"""llava-next-34b [vlm] — backbone only; anyres vision frontend is a stub.

60L, d_model 7168, 56 heads (GQA kv=8), d_ff 20480, vocab 64000.
``input_specs`` provides precomputed patch embeddings per the brief.
"""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7_168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20_480,
    vocab_size=64_000,
    input_mode="embeddings",
)

SMOKE = ModelConfig(
    name="llava-next-34b-smoke",
    family="vlm",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    input_mode="embeddings",
)

SKIP_SHAPES = {"long_500k"}
NOTES = ("modality frontend stubbed: input_specs() supplies (B, S, d) patch "
         "embeddings; 56 heads indivisible by 16 -> head-replicated "
         "attention under default rules (tuner cell).")
