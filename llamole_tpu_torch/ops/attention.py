"""Masked multi-head attention (counterpart of llamole_tpu/ops/attention.py).

Masking is on the key side only: padded query rows produce values that
the denoiser's output mask discards, exactly as in the JAX package.
Logits and softmax run in f32 (inputs are upcast, so a bf16 product is
exact and summed in f32, as `preferred_element_type=f32` does in JAX).
"""

import math
from typing import Optional

import torch

_NEG_INF = -1e30


def masked_attention(
    q: torch.Tensor,   # [B, H, N, Dh]
    k: torch.Tensor,   # [B, H, N, Dh]
    v: torch.Tensor,   # [B, H, N, Dh]
    key_mask: Optional[torch.Tensor] = None,  # [B, N] bool
) -> torch.Tensor:
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if key_mask is not None:
        logits = torch.where(key_mask[:, None, None, :], logits, _NEG_INF)
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(weights, v)
