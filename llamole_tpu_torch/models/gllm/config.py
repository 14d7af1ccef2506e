"""LLM configuration, re-declared from llamole_tpu/models/gllm/config.py
(that package's __init__ imports JAX). The fields and their defaults are
the JAX declaration's, kept equal by tests/test_torch_configs.py, so one
config describes a model in both packages. The port runs every family
the JAX package builds: llama / qwen2 / mistral, qwen3 (q/k norms),
gemma-1 / 2 / 3 (GeGLU, unit-offset norms, sandwich norms, softcaps,
alternating sliding windows, gemma-3's dual rope) and the Mixtral sparse
MoE, with LongLoRA's S²-attn in training (shift_attn, group_size_ratio).
from_hf_config is the JAX package's, copied whole (an HF config.json
dict -> LLMConfig, every family it knows).
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
    # recompute each decoder layer in the backward pass (training)
    remat: bool = False
    # use_flash: no-cache forwards on the card with S >= flash_min_seq,
    # S % 128 == 0 and head_dim 128 or 256 run kernel E (model.flash_ok,
    # ops/flash_attention.py), where the JAX package runs its TPU flash
    # kernel; and S²-attn (shift_attn: training forwards attend within
    # groups of int(S * group_size_ratio) tokens, model.s2_attention)
    use_flash: bool = False
    flash_min_seq: int = 1024
    shift_attn: bool = False
    group_size_ratio: float = 0.25
    # "compute" (model dtype) or "int8" (per-(token, head) scales)
    kv_cache_dtype: str = "compute"
    # Mixtral sparse MoE: num_experts > 0 routes each token to its top-k
    # experts through a static capacity (model.moe_mlp)
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_loss_coef: float = 0.02
    # gemma / qwen3 family knobs (HF Gemma2Config semantics)
    hidden_act: str = "silu"              # "gelu_tanh" = GeGLU (gemma)
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

    def is_global_layer(self, i: int) -> bool:
        """Whether layer i uses full (global) attention: every layer
        without a sliding window, else the last of each
        sliding_window_pattern layers."""
        if self.sliding_window is None:
            return True
        return i % self.sliding_window_pattern == \
            self.sliding_window_pattern - 1

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
    def qwen3_8b(cls) -> "LLMConfig":
        return cls(
            vocab_size=151936, hidden_size=4096, intermediate_size=12288,
            num_layers=36, num_heads=32, num_kv_heads=8, head_dim=128,
            rope_theta=1e6, rms_norm_eps=1e-6, attention_bias=False,
            max_position_embeddings=40960, qk_norm=True)

    @classmethod
    def gemma2_9b(cls) -> "LLMConfig":
        return cls(
            vocab_size=256000, hidden_size=3584, intermediate_size=14336,
            num_layers=42, num_heads=16, num_kv_heads=8, head_dim=256,
            rope_theta=10000.0, rms_norm_eps=1e-6,
            max_position_embeddings=8192, tie_word_embeddings=True,
            hidden_act="gelu_tanh", attn_logit_softcap=50.0,
            final_logit_softcap=30.0, sandwich_norms=True,
            rms_norm_unit_offset=True, scale_embeddings=True,
            query_scale=256.0, sliding_window=4096)

    @classmethod
    def gemma3_12b(cls) -> "LLMConfig":
        return cls(
            vocab_size=262208, hidden_size=3840, intermediate_size=15360,
            num_layers=48, num_heads=16, num_kv_heads=8, head_dim=256,
            rope_theta=1e6, rms_norm_eps=1e-6,
            max_position_embeddings=131072, tie_word_embeddings=True,
            hidden_act="gelu_tanh", sandwich_norms=True,
            rms_norm_unit_offset=True, scale_embeddings=True,
            query_scale=256.0, qk_norm=True,
            sliding_window=1024, sliding_window_pattern=6,
            rope_local_base_freq=10000.0,
            rope_scaling="linear", rope_scaling_factor=8.0)

    @classmethod
    def tiny(cls, vocab_size: int = 512) -> "LLMConfig":
        """Toy config for tests / smoke runs."""
        return cls(
            vocab_size=vocab_size, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, rope_theta=10000.0,
            max_position_embeddings=2048, rope_scaling=None)

    @classmethod
    def tiny_moe(cls, vocab_size: int = 512, num_experts: int = 4,
                 top_k: int = 2) -> "LLMConfig":
        cfg = cls.tiny(vocab_size)
        cfg.num_experts = num_experts
        cfg.num_experts_per_tok = top_k
        return cfg

    @classmethod
    def mixtral_8x7b(cls) -> "LLMConfig":
        return cls(
            vocab_size=32000, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8, rope_theta=1e6,
            max_position_embeddings=32768,
            num_experts=8, num_experts_per_tok=2)

    @classmethod
    def from_hf_config(cls, raw: dict) -> "LLMConfig":
        """Build from an HF config.json dict (no transformers dependency)."""
        # multimodal gemma-3 checkpoints nest the LM under text_config;
        # the vision tower is out of scope (text-only loading, like the
        # reference's AutoModelForCausalLM surface, loader.py:148-220)
        if (str(raw.get("model_type", "")).startswith("gemma3")
                and isinstance(raw.get("text_config"), dict)):
            inner = dict(raw["text_config"])
            inner.setdefault("model_type", "gemma3_text")
            raw = inner
        rope_scaling = raw.get("rope_scaling") or {}
        model_type = str(raw.get("model_type", ""))
        # gemma-1 ("gemma"): GeGLU + unit-offset norms + scaled embeds,
        # two norms per block, no softcaps/sliding. gemma-2 adds the
        # sandwich norms, softcaps and alternating local attention.
        # gemma-3: sandwich norms, NO softcaps, per-head unit-offset q/k
        # norms, 5:1 local:global attention, dual-frequency rope (local
        # layers use rope_local_base_freq, unscaled).
        gemma2 = model_type == "gemma2"
        gemma1 = model_type == "gemma"
        gemma3 = model_type in ("gemma3", "gemma3_text")
        if model_type.startswith("gemma") and not (gemma1 or gemma2
                                                   or gemma3):
            raise ValueError(
                f"unsupported gemma variant {model_type!r} "
                "(supported: gemma, gemma2, gemma3/gemma3_text)")
        gemma = gemma1 or gemma2 or gemma3
        swp = raw.get("sliding_window_pattern")
        if gemma3 and swp is None:
            swp = _pattern_from_layer_types(raw.get("layer_types"),
                                            raw["num_hidden_layers"])
        act = raw.get("hidden_activation") or raw.get("hidden_act") or "silu"
        return cls(
            vocab_size=raw["vocab_size"],
            hidden_size=raw["hidden_size"],
            intermediate_size=raw["intermediate_size"],
            num_layers=raw["num_hidden_layers"],
            num_heads=raw["num_attention_heads"],
            num_kv_heads=raw.get("num_key_value_heads", raw["num_attention_heads"]),
            head_dim=raw.get("head_dim"),
            rope_theta=raw.get("rope_theta", 10000.0),
            rms_norm_eps=raw.get("rms_norm_eps", 1e-5),
            attention_bias=raw.get("attention_bias",
                                   model_type == "qwen2"),
            # HF save_pretrained omits defaults; gemma's default is tied
            tie_word_embeddings=raw.get("tie_word_embeddings", gemma),
            max_position_embeddings=raw.get("max_position_embeddings", 8192),
            rope_scaling=(rope_scaling.get("rope_type")
                          if isinstance(rope_scaling, dict) else None),
            rope_scaling_factor=(rope_scaling.get("factor", 8.0)
                                 if isinstance(rope_scaling, dict) else 8.0),
            rope_low_freq_factor=(rope_scaling.get("low_freq_factor", 1.0)
                                  if isinstance(rope_scaling, dict) else 1.0),
            rope_high_freq_factor=(rope_scaling.get("high_freq_factor", 4.0)
                                   if isinstance(rope_scaling, dict) else 4.0),
            rope_original_max_position=(
                rope_scaling.get("original_max_position_embeddings", 8192)
                if isinstance(rope_scaling, dict) else 8192),
            num_experts=raw.get("num_local_experts", 0),
            num_experts_per_tok=raw.get("num_experts_per_tok", 2),
            # honor the checkpoint's router loss weight (Mixtral HF
            # default 0.001) like the reference does via the HF config
            # (model_utils/moe.py:69-71); ModelArguments.moe_aux_loss_coef
            # overrides it downstream
            moe_aux_loss_coef=raw.get("router_aux_loss_coef", 0.02),
            hidden_act=("gelu_tanh" if "gelu" in act else "silu"),
            attn_logit_softcap=(raw.get("attn_logit_softcapping")
                                if gemma2 else None),
            final_logit_softcap=(raw.get("final_logit_softcapping")
                                 if gemma2 else None),
            sandwich_norms=gemma2 or gemma3,
            rms_norm_unit_offset=gemma,
            scale_embeddings=gemma,
            query_scale=(raw.get("query_pre_attn_scalar")
                         if gemma2 or gemma3 else None),
            sliding_window=(raw.get("sliding_window")
                            if gemma2 or gemma3 else None),
            sliding_window_pattern=(swp if swp is not None
                                    else raw.get("sliding_window_pattern",
                                                 2)),
            # qwen3 and gemma3 apply per-head RMSNorm to q/k after
            # projection (gemma3's is the unit-offset variant, selected
            # by rms_norm_unit_offset above)
            qk_norm=model_type.startswith("qwen3") or gemma3,
            rope_local_base_freq=(raw.get("rope_local_base_freq", 10000.0)
                                  if gemma3 else None),
        )


def _pattern_from_layer_types(layer_types, num_layers: int) -> int:
    """Derive sliding_window_pattern from an HF gemma-3 layer_types list
    (['sliding_attention' x5, 'full_attention', ...]). Only the regular
    modular pattern is supported; irregular lists raise."""
    if not layer_types:
        return 6  # gemma-3 default: every 6th layer global
    try:
        p = layer_types.index("full_attention") + 1
    except ValueError:
        p = num_layers + 1  # all layers sliding
    for i, lt in enumerate(layer_types):
        want = ("full_attention" if (i + 1) % p == 0
                else "sliding_attention")
        if lt != want:
            raise ValueError(
                "irregular gemma-3 layer_types (not a modular "
                f"local/global pattern): {layer_types!r}")
    return p
