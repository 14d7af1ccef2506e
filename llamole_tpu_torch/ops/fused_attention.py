"""Fused qk-norm + masked MHA for the GraphDiT denoiser.

`fused_block_attention` consumes the RAW [B, N, 3H] qkv projection,
LayerNorms each head's q and k over dh (one [dh] scale/bias shared by
all heads, f32, eps 1e-5), runs the key-masked softmax attention of
every head and returns the head-concatenated [B, N, H] tensor.

On a CUDA tensor it launches the hand-written kernel
(csrc/fused_attention.cu, the port of llamole_tpu/ops/pallas/
fused_attention.py `_kernel`) or raises; on a CPU tensor it runs
`fused_attention_reference`, the plain PyTorch version of the same
function (counterpart of `_fused_attention_reference`), which the tests
and chip_smoke.py also compare the kernel against.
"""

import torch

from . import cuda_lib
from .attention import masked_attention
from .nn import layer_norm

# one [B, heads] grid of blocks, each holding q/k/v [N, dh+1] and the
# [N, N+1] logits in f32 shared memory (csrc/fused_attention.cu)
MAX_SHARED_BYTES = 232_448   # what one H100 block may opt into


def shared_bytes(n: int, dh: int) -> int:
    return (3 * n * (dh + 1) + n * (n + 1)) * 4


def fused_attention_reference(qkv, node_mask, q_scale, q_bias, k_scale,
                              k_bias, num_heads: int) -> torch.Tensor:
    """Plain PyTorch composition with the kernel's semantics."""
    b, n, three_h = qkv.shape
    h_total = three_h // 3
    dh = h_total // num_heads
    q, k, v = qkv.reshape(b, n, 3, num_heads, dh).permute(2, 0, 3, 1, 4)
    q = layer_norm(q, q_scale, q_bias)
    k = layer_norm(k, k_scale, k_bias)
    attn = masked_attention(q, k, v, key_mask=node_mask)
    return attn.transpose(1, 2).reshape(b, n, h_total)


def fused_block_attention(qkv, node_mask, q_scale, q_bias, k_scale, k_bias,
                          num_heads: int) -> torch.Tensor:
    """qk-norm + masked MHA, head-concatenated output [B, N, H]."""
    if qkv.device.type == "cpu":
        return fused_attention_reference(qkv, node_mask, q_scale, q_bias,
                                         k_scale, k_bias, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_block_attention: unsupported device "
                         f"{qkv.device}")
    if qkv.dim() != 3 or qkv.shape[2] % 3:
        raise ValueError(f"qkv must be [B, N, 3H], got {tuple(qkv.shape)}")
    b, n, three_h = qkv.shape
    h_total = three_h // 3
    if h_total % num_heads:
        raise ValueError(f"H={h_total} is not a multiple of {num_heads} heads")
    dh = h_total // num_heads
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"qkv dtype {qkv.dtype}: the kernel takes float32 "
                        "or bfloat16")
    if not qkv.is_contiguous():
        raise ValueError("qkv must be contiguous")
    if (node_mask.dtype != torch.bool or tuple(node_mask.shape) != (b, n)
            or node_mask.device != qkv.device
            or not node_mask.is_contiguous()):
        raise ValueError("node_mask must be a contiguous bool [B, N] tensor "
                         "on qkv's device")
    for name, t in (("q_scale", q_scale), ("q_bias", q_bias),
                    ("k_scale", k_scale), ("k_bias", k_bias)):
        if (tuple(t.shape) != (dh,) or t.dtype != qkv.dtype
                or t.device != qkv.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous [{dh}] "
                             f"{qkv.dtype} tensor on qkv's device")
    if n < 1 or shared_bytes(n, dh) > MAX_SHARED_BYTES:
        raise ValueError(f"N={n}, dh={dh} needs {shared_bytes(n, dh)} bytes "
                         f"of shared memory; the kernel holds at most "
                         f"{MAX_SHARED_BYTES}")
    lib = cuda_lib.library()
    fn = (lib.cdll.llamole_fused_attention_bf16
          if qkv.dtype == torch.bfloat16
          else lib.cdll.llamole_fused_attention_f32)
    out = torch.empty((b, n, h_total), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):   # the C launch uses the current one
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(qkv.data_ptr(), node_mask.data_ptr(), q_scale.data_ptr(),
                  q_bias.data_ptr(), k_scale.data_ptr(), k_bias.data_ptr(),
                  out.data_ptr(), b, n, h_total, num_heads, stream)
    lib.check(code, "fused_block_attention launch")
    fused_block_attention.launches += 1
    return out


fused_block_attention.launches = 0
