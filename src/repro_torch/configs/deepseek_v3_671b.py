"""deepseek-v3-671b [moe] — arXiv:2412.19437.

61L, d_model 7168, 128 heads (MLA), per-expert d_ff 2048, vocab 129280,
256 routed experts top-8 + 1 shared, first 3 layers dense (d_ff 18432),
multi-token prediction (1 depth).
"""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7_168,
    num_heads=128,
    num_kv_heads=128,            # MLA: per-head latent KV
    d_ff=18_432,                 # dense FFN of the first 3 layers
    vocab_size=129_280,
    # MoE
    num_experts=256,
    experts_per_token=8,
    moe_d_ff=2_048,
    num_shared_experts=1,
    moe_first_dense=3,
    router_impl="sigmoid",
    # MLA
    use_mla=True,
    q_lora_rank=1_536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    # MTP
    mtp_depth=1,
)

SMOKE = ModelConfig(
    name="deepseek-v3-671b-smoke",
    family="moe",
    num_layers=3,                # 1 dense + 2 moe
    d_model=128,
    num_heads=4,
    num_kv_heads=4,
    d_ff=256,
    vocab_size=512,
    num_experts=8,
    experts_per_token=2,
    moe_d_ff=64,
    num_shared_experts=1,
    moe_first_dense=1,
    router_impl="sigmoid",
    use_mla=True,
    q_lora_rank=64,
    kv_lora_rank=32,
    qk_nope_dim=16,
    qk_rope_dim=8,
    v_head_dim=16,
    mtp_depth=1,
)

SKIP_SHAPES = {"long_500k"}
NOTES = ("MLA latent cache (512+64 per token) makes decode_32k KV tiny; "
         "256 routed experts shard 16-way over the model axis; scatter "
         "dispatch (DESIGN.md §6).")
