"""Masked multi-head attention over pre-split graph heads.

`graph_attention(q, k, v, key_mask)`: q, k, v [B, H, N, Dh] in one dtype,
key_mask [B, N] bool (None = every key kept) -> [B, H, N, Dh]. Logits in
f32 scaled by 1/sqrt(Dh), masked keys at -1e30, softmax, probabilities
cast to v's dtype before the value product (f32 sums), the output in q's
dtype.

On a CUDA tensor it launches kernel D (csrc/fused_attention.cu built with
kQkNorm = false, the port of llamole_tpu/ops/pallas/graph_attention.py
`_attn_kernel`) or raises, through the body that
fused_attention.attention_body picks (bf16 "mma", f32 "tf32x3" within
the tensor-core limits, else "fma"; launches counted per body as for
kernel A); on a CPU tensor it runs the plain version,
ops.attention.masked_attention, which the tests and chip_smoke.py also
compare the kernel against. Like the TPU kernel it has no backward: on the
card it refuses inputs that would record an autograd graph.
"""

from typing import Optional

import torch

from .attention import masked_attention
from .cuda_lib import launch
from .fused_attention import (attention_body, check_body, count_launch,
                              kernel_entry, reset_launches)


def graph_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    if q.device.type == "cpu":
        return masked_attention(q, k, v, key_mask=key_mask)
    if q.device.type != "cuda":
        raise ValueError(f"graph_attention: unsupported device {q.device}")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, N, Dh], got {tuple(q.shape)}")
    b, heads, n, dh = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q dtype {q.dtype}: the kernel takes float32 or "
                        "bfloat16")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {tuple(q.shape)} "
                             f"{q.dtype} tensor on q's device")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError("graph_attention on the card has no backward; "
                           "run it under torch.no_grad()")
    if key_mask is None:
        key_mask = torch.ones((b, n), dtype=torch.bool, device=q.device)
    if (key_mask.dtype != torch.bool or tuple(key_mask.shape) != (b, n)
            or key_mask.device != q.device or not key_mask.is_contiguous()):
        raise ValueError("key_mask must be a contiguous bool [B, N] tensor "
                         "on q's device")
    if n < 1:
        raise ValueError("q holds no node")
    body = attention_body(n, dh, q.dtype)
    check_body(body, n, dh, (q, k, v))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    launch(kernel_entry("graph", body, q.dtype), q.device,
           "graph_attention launch", q.data_ptr(), k.data_ptr(),
           v.data_ptr(), key_mask.data_ptr(), out.data_ptr(), b, heads, n, dh)
    count_launch(graph_attention, body)
    return out


reset_launches(graph_attention)
