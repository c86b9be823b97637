"""Unified model configuration covering all ten assigned architectures.

One dataclass describes dense / MoE / MLA / SSM / hybrid / VLM / audio
decoder-only models; the per-arch files in ``repro_torch/configs`` fill it with
the exact published numbers.  Pure Python: the same dataclasses as the JAX
package's ``models/config.py``, field for field.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | vlm | hybrid | audio | ssm
    num_layers: int
    d_model: int
    vocab_size: int

    # -- attention ------------------------------------------------------------
    num_heads: int = 0                # 0 = attention-free (pure SSM)
    num_kv_heads: int = 0
    head_dim: int = 0                 # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0

    # -- dense FFN --------------------------------------------------------------
    d_ff: int = 0                     # 0 = no dense FFN (pure SSM blocks)
    mlp_variant: str = "swiglu"       # swiglu | gelu (2-matrix classic MLP)

    # -- MoE ----------------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0                 # per-expert hidden dim
    num_shared_experts: int = 0
    moe_first_dense: int = 0          # leading layers with dense FFN (DeepSeek: 3)
    capacity_factor: float = 1.25
    router_impl: str = "softmax"      # softmax | sigmoid (DeepSeek-style)

    # -- MLA (DeepSeek latent attention) -------------------------------------------
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # -- multi-token prediction -----------------------------------------------------
    mtp_depth: int = 0
    mtp_loss_weight: float = 0.3

    # -- SSM (Mamba2/SSD) -------------------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    ssm_num_groups: int = 1

    # -- hybrid layout -----------------------------------------------------------------
    #: (#mamba blocks per super-block, 1 shared-attention block); zamba2-style.
    hybrid_mamba_per_attn: int = 0
    #: attention weights shared across super-blocks (Zamba2's shared blocks)
    hybrid_shared_attn: bool = True

    # -- modality frontend (stub per brief) ----------------------------------------------
    input_mode: str = "tokens"        # tokens | embeddings (VLM/audio stubs)

    # -- numerics --------------------------------------------------------------------------
    param_dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # -- derived -----------------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.num_heads:
            return self.d_model // self.num_heads
        return 0

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def is_ssm_only(self) -> bool:
        return self.family == "ssm"

    @property
    def is_hybrid(self) -> bool:
        return self.family == "hybrid"

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def num_params(self) -> int:
        """Analytic parameter count (embeddings included once)."""
        d, L, V = self.d_model, self.num_layers, self.vocab_size
        total = V * d                                   # input embed
        if not self.tie_embeddings:
            total += V * d                              # output head
        if self.family in ("ssm", "hybrid"):
            n_mamba, n_attn, shared_attn = self.layer_plan()
            total += n_mamba * self._mamba_params()
            attn_sets = 1 if (shared_attn and n_attn) else n_attn
            total += attn_sets * (self._attn_params() + self._dense_ffn_params())
            total += (n_mamba + n_attn) * 2 * d         # norms
            return total
        per_layer = self._attn_params() + 2 * d         # attention + 2 norms
        n_moe = max(0, L - self.moe_first_dense) if self.is_moe else 0
        n_dense = L - n_moe
        total += n_dense * self._dense_ffn_params() + L * per_layer // L * 0
        total += L * per_layer
        if self.is_moe:
            total += n_moe * self._moe_params()
        if self.mtp_depth:
            total += self.mtp_depth * (self._attn_params()
                                       + self._moe_params() + 2 * d)
        return total

    def num_active_params(self) -> int:
        """Parameters touched per token (MoE: routed top-k only)."""
        if not self.is_moe:
            return self.num_params()
        d, L = self.d_model, self.num_layers
        n_moe = max(0, L - self.moe_first_dense)
        dense_moe_diff = self._moe_params() - self._moe_active_params()
        return self.num_params() - n_moe * dense_moe_diff \
            - (self.mtp_depth * dense_moe_diff if self.mtp_depth else 0)

    def layer_plan(self) -> Tuple[int, int, bool]:
        """(#mamba blocks, #attention blocks, attn-shared?) for ssm/hybrid."""
        if self.family == "ssm":
            return self.num_layers, 0, False
        if self.family == "hybrid":
            per = self.hybrid_mamba_per_attn
            unit = per + 1
            n_super = self.num_layers // unit
            rem = self.num_layers - n_super * unit
            return n_super * per + rem, n_super, self.hybrid_shared_attn
        return 0, 0, False

    # -- per-component parameter counts ----------------------------------------
    def _attn_params(self) -> int:
        d, hd = self.d_model, self.resolved_head_dim
        H, KV = self.num_heads, self.num_kv_heads
        if self.use_mla:
            q_in = self.q_lora_rank or d
            total = 0
            if self.q_lora_rank:
                total += d * self.q_lora_rank + self.q_lora_rank
            total += q_in * H * (self.qk_nope_dim + self.qk_rope_dim)
            total += d * (self.kv_lora_rank + self.qk_rope_dim)
            total += self.kv_lora_rank * H * (self.qk_nope_dim
                                              + self.v_head_dim)
            total += H * self.v_head_dim * d
            return total
        if not H:
            return 0
        total = d * H * hd + 2 * d * KV * hd + H * hd * d
        if self.qkv_bias:
            total += H * hd + 2 * KV * hd
        return total

    def _dense_ffn_params(self) -> int:
        if not self.d_ff:
            return 0
        mats = 3 if self.mlp_variant == "swiglu" else 2
        return mats * self.d_model * self.d_ff

    def _moe_params(self) -> int:
        d, E, m = self.d_model, self.num_experts, self.moe_d_ff
        total = d * E                                   # router
        total += E * 3 * d * m                          # routed experts
        total += self.num_shared_experts * 3 * d * m    # shared experts
        return total

    def _moe_active_params(self) -> int:
        d, k, m = self.d_model, self.experts_per_token, self.moe_d_ff
        total = d * self.num_experts
        total += k * 3 * d * m
        total += self.num_shared_experts * 3 * d * m
        return total

    def _mamba_params(self) -> int:
        d, di = self.d_model, self.ssm_d_inner
        N, G, H = self.ssm_state, self.ssm_num_groups, self.ssm_num_heads
        conv_dim = di + 2 * G * N
        total = d * (2 * di + 2 * G * N + H)            # in_proj
        total += conv_dim * self.ssm_conv_width          # depthwise conv
        total += 3 * H                                   # A_log, D, dt_bias
        total += di * d                                  # out_proj
        return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell from the assignment."""

    name: str                          # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                          # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
