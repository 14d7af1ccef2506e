"""LLM configuration, re-declared from llamole_tpu/models/gllm/config.py
(that package's __init__ imports JAX). The fields and their defaults are
the JAX declaration's, kept equal by tests/test_torch_configs.py, so one
config describes a model in both packages. The port runs the
RoPE + GQA + RMSNorm + SwiGLU families (llama / qwen2 / mistral); the
other families' fields are declared, and model.check_supported refuses
configs that set them.
"""

from dataclasses import dataclass
from typing import Optional


@dataclass
class LLMConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: Optional[int] = None          # default hidden/num_heads
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    attention_bias: bool = False            # qwen2: True
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 131072
    rope_scaling: Optional[str] = None      # None | "llama3" | "linear" | "dynamic"
    rope_scaling_factor: float = 8.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192
    # training-only / TPU-only knobs of the JAX package (ignored here)
    remat: bool = False
    use_flash: bool = False
    flash_min_seq: int = 1024
    shift_attn: bool = False
    group_size_ratio: float = 0.25
    # "compute" (model dtype) or "int8" (not ported yet)
    kv_cache_dtype: str = "compute"
    # sparse MoE (not ported yet)
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_loss_coef: float = 0.02
    # gemma / qwen3 family knobs (not ported yet)
    hidden_act: str = "silu"
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    sandwich_norms: bool = False
    rms_norm_unit_offset: bool = False
    scale_embeddings: bool = False
    query_scale: Optional[float] = None
    qk_norm: bool = False
    sliding_window: Optional[int] = None
    sliding_window_pattern: int = 2
    rope_local_base_freq: Optional[float] = None

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @classmethod
    def llama3_8b(cls) -> "LLMConfig":
        return cls(rope_scaling="llama3")

    @classmethod
    def qwen2_7b(cls) -> "LLMConfig":
        return cls(
            vocab_size=152064, hidden_size=3584, intermediate_size=18944,
            num_layers=28, num_heads=28, num_kv_heads=4,
            rope_theta=1e6, rms_norm_eps=1e-6, attention_bias=True)

    @classmethod
    def mistral_7b(cls) -> "LLMConfig":
        return cls(
            vocab_size=32768, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8, rope_theta=1e6)

    @classmethod
    def tiny(cls, vocab_size: int = 512) -> "LLMConfig":
        """Toy config for tests / smoke runs."""
        return cls(
            vocab_size=vocab_size, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, rope_theta=10000.0,
            max_position_embeddings=2048, rope_scaling=None)
