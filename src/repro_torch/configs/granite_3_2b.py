"""granite-3-2b [dense] — hf:ibm-granite/granite-3.0-2b-base.

40L, d_model 2048, 32 heads (GQA kv=8), d_ff 8192, vocab 49155.
"""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="granite-3-2b",
    family="dense",
    num_layers=40,
    d_model=2_048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8_192,
    vocab_size=49_155,
)

SMOKE = ModelConfig(
    name="granite-3-2b-smoke",
    family="dense",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=515,          # deliberately non-round, like the real 49155
)

SKIP_SHAPES = {"long_500k"}
NOTES = ("small-model regime: default rules over-shard the model axis; "
         "tuner prefers wider data parallelism (candidate hillclimb cell). "
         "vocab 49155 is not divisible by 16 -> vocab stays replicated "
         "under divisibility-safe rules.")
