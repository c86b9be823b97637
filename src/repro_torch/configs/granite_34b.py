"""granite-34b [dense, MQA] — arXiv:2405.04324 (Granite Code 34B).

88L, d_model 6144, 48 heads (MQA kv=1), d_ff 24576, vocab 49152.
"""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6_144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24_576,
    mlp_variant="gelu",
    vocab_size=49_152,
)

SMOKE = ModelConfig(
    name="granite-34b-smoke",
    family="dense",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=1,
    head_dim=32,
    d_ff=256,
    mlp_variant="gelu",
    vocab_size=512,
)

SKIP_SHAPES = {"long_500k"}
NOTES = "MQA: single KV head replicated; tiny KV cache at decode."
