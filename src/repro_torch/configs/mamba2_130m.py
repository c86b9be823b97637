"""mamba2-130m [ssm] — arXiv:2405.21060 (SSD / state-space duality).

24L, d_model 768, attention-free, vocab 50280, ssm_state 128.
d_inner = 1536 (expand 2), 24 SSD heads of dim 64.
"""

from ..models.config import ModelConfig

FULL = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    vocab_size=50_280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-130m-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    vocab_size=512,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_expand=2,
    ssm_chunk=32,
    tie_embeddings=True,
)

SKIP_SHAPES: set = set()        # attention-free: long_500k runs
NOTES = ("pure SSD stack; decode state is O(1) per layer so long_500k is "
         "the cheap cell; chunk size (ssm_chunk) is a kernel-style tunable.")
