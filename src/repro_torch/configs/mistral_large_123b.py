"""mistral-large-123b [dense] — hf:mistralai/Mistral-Large-Instruct-2407.

88L, d_model 12288, 96 heads (GQA kv=8), d_ff 28672, vocab 32768.
"""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12_288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28_672,
    vocab_size=32_768,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="mistral-large-123b-smoke",
    family="dense",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
)

#: pure full-attention arch: long_500k would be quadratic — skipped (brief).
SKIP_SHAPES = {"long_500k"}
NOTES = "96 q-heads shard 16-way; 8 kv-heads replicated (KV < TP)."
