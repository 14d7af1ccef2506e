"""Fused qk-norm + masked MHA for the GraphDiT denoiser.

`fused_block_attention` consumes the RAW [B, N, 3H] qkv projection,
LayerNorms each head's q and k over dh (one [dh] scale/bias shared by
all heads, f32, eps 1e-5), runs the key-masked softmax attention of
every head and returns the head-concatenated [B, N, H] tensor.

On a CUDA tensor it launches the hand-written kernel
(csrc/fused_attention.cu, the port of llamole_tpu/ops/pallas/
fused_attention.py `_kernel`) or raises. `attention_body(N, dh, dtype)`
picks one of its three bodies:

- "mma": bf16 on the tensor cores, for N <= 64 and dh in MMA_HEAD_DIMS
  (the denoiser built with random weights in bf16);
- "tf32x3": f32 on the tensor cores within the same limits (the f32
  denoiser that every model loaded from a checkpoint builds). TF32 keeps
  11 significant bits, and one pass errs by ~1e-3 where f32's contract
  is 1e-4, so each operand is split into a TF32 hi and lo part and each
  product is taken in three passes (lo.hi + hi.lo + hi.hi). Its device
  memory traffic bounds it, the three passes notwithstanding;
- "fma": plain FMA loops, for f32 or bf16 outside those limits.

The wrapper counts the launches of each (`launches_mma`,
`launches_tf32x3`, `launches_fma`; `launches` is their sum). On a CPU
tensor it runs `fused_attention_reference`, the plain PyTorch version
of the same function (counterpart of `_fused_attention_reference`),
which the tests and chip_smoke.py also compare the kernel against. The
kernel has no backward (nor has the TPU one): on the card it refuses
inputs that would record an autograd graph. The denoiser's training
path (Denoiser(train=True)) runs the plain attention instead, as the JAX
package does.
"""

import torch

from . import cuda_lib
from .attention import masked_attention
from .cuda_lib import MAX_SHARED_BYTES, launch
from .nn import layer_norm

# the tensor-core bodies: four warps of 16 query rows, mma.sync over dh
# in steps of 16 (bf16, attention_mma_kernel) or 8 (f32 split into TF32
# parts, attention_tf32x3_kernel; csrc/fused_attention.cu)
MMA_MAX_NODES = 64
MMA_HEAD_DIMS = (16, 32, 64, 128)
BODIES = ("mma", "tf32x3", "fma")


def attention_body(n: int, dh: int, dtype: torch.dtype) -> str:
    """The body a kernel A or D call launches on the card: with N <= 64
    and dh in MMA_HEAD_DIMS, "mma" (bf16 tensor cores) for bf16 and
    "tf32x3" (f32 in three TF32 tensor-core passes) for f32; else "fma"
    (plain FMA loops)."""
    if 1 <= n <= MMA_MAX_NODES and dh in MMA_HEAD_DIMS:
        if dtype == torch.bfloat16:
            return "mma"
        if dtype == torch.float32:
            return "tf32x3"
    return "fma"


def shared_bytes(n: int, dh: int, body: str) -> int:
    """Dynamic shared memory of one (graph, head) block. mma: q, k, v as
    [N rounded up to 16, dh + 8] bf16 tiles and an f32 key-mask row;
    tf32x3: the same as [N rounded up to 16, dh + 4] f32 tiles; fma: q,
    k, v as [N, dh + 1] and the [N, N + 1] logits, all f32."""
    rows = -(-n // 16) * 16
    if body == "mma":
        return 3 * rows * (dh + 8) * 2 + rows * 4
    if body == "tf32x3":
        return 3 * rows * (dh + 4) * 4 + rows * 4
    return (3 * n * (dh + 1) + n * (n + 1)) * 4


def kernel_entry(kind: str, body: str, dtype: torch.dtype):
    """The C entry point of kernel A (kind "fused") or D ("graph") for a
    body and dtype."""
    return cuda_lib.entry(f"llamole_{kind}_attention_{body}_"
                          f"{cuda_lib.dtype_suffix(dtype)}")


def check_body(body: str, n: int, dh: int, tensors) -> None:
    """Refuse what the chosen body cannot take: its shared memory, and for
    the tensor-core bodies rows that are not 16-byte aligned."""
    need = shared_bytes(n, dh, body)
    if need > MAX_SHARED_BYTES:
        raise ValueError(f"N={n}, dh={dh} needs {need} bytes of shared "
                         f"memory; the kernel holds at most "
                         f"{MAX_SHARED_BYTES}")
    if body != "fma" and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"the tensor-core body ({body}) copies 16-byte "
                         "rows: its inputs must start 16-byte aligned")


def count_launch(wrapper, body: str) -> None:
    wrapper.launches += 1
    setattr(wrapper, f"launches_{body}", getattr(wrapper,
                                                 f"launches_{body}") + 1)


def reset_launches(wrapper) -> None:
    wrapper.launches = 0
    for body in BODIES:
        setattr(wrapper, f"launches_{body}", 0)


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
    norms = (q_scale, q_bias, k_scale, k_bias)
    if torch.is_grad_enabled() and (qkv.requires_grad or any(
            t.requires_grad for t in norms)):
        raise RuntimeError("fused_block_attention on the card has no "
                           "backward; run it under torch.no_grad() (the "
                           "denoiser trains with train=True)")
    if (node_mask.dtype != torch.bool or tuple(node_mask.shape) != (b, n)
            or node_mask.device != qkv.device
            or not node_mask.is_contiguous()):
        raise ValueError("node_mask must be a contiguous bool [B, N] tensor "
                         "on qkv's device")
    for name, t in zip(("q_scale", "q_bias", "k_scale", "k_bias"), norms):
        if (tuple(t.shape) != (dh,) or t.dtype != qkv.dtype
                or t.device != qkv.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous [{dh}] "
                             f"{qkv.dtype} tensor on qkv's device")
    if n < 1:
        raise ValueError("qkv holds no node")
    body = attention_body(n, dh, qkv.dtype)
    check_body(body, n, dh, (qkv,))
    out = torch.empty((b, n, h_total), dtype=qkv.dtype, device=qkv.device)
    launch(kernel_entry("fused", body, qkv.dtype), qkv.device,
           "fused_block_attention launch", qkv.data_ptr(),
           node_mask.data_ptr(), q_scale.data_ptr(), q_bias.data_ptr(),
           k_scale.data_ptr(), k_bias.data_ptr(), out.data_ptr(), b, n,
           h_total, num_heads)
    count_launch(fused_block_attention, body)
    return out


reset_launches(fused_block_attention)
