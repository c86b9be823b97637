"""zamba2-7b [hybrid] — arXiv:2411.15242: Mamba2 backbone + shared attention.

81L, d_model 3584, attention 32H (kv=32), d_ff 14336, ssm_state 64,
vocab 32000.  Layout: super-blocks of 3 Mamba2 blocks + 1 *weight-shared*
full-attention block (20 super-blocks + 1 trailing Mamba block = 81).
"""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3_584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14_336,
    vocab_size=32_000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    hybrid_mamba_per_attn=3,
    hybrid_shared_attn=True,
)

SMOKE = ModelConfig(
    name="zamba2-7b-smoke",
    family="hybrid",
    num_layers=9,                # 2 super-blocks (3m+1a) + 1 tail mamba
    d_model=64,
    num_heads=2,
    num_kv_heads=2,
    head_dim=32,
    d_ff=128,
    vocab_size=512,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_expand=2,
    ssm_chunk=32,
    hybrid_mamba_per_attn=3,
    hybrid_shared_attn=True,
)

SKIP_SHAPES: set = set()        # sub-quadratic state: long_500k runs
NOTES = ("shared attention block: one parameter set reused by all 20 "
         "super-blocks (faithful to Zamba2); long_500k runs (SSM state is "
         "O(1), attention caches decode linearly).")
