"""GIN message aggregation for dense padded graph batches.

`gin_aggregate(x, edge_classes, adj, table)` computes

    out[b, i] = sum_j adj[b, i, j] * gelu(x[b, j] + table[edge[b, i, j]])

with the exact GELU, f32 accumulation and the output in x's dtype, never
forming the [B, N, N, H] messages on the card. x [B, N, H], edge_classes
[B, N, N] int (classes 0-4, 0 = no bond), adj [B, N, N] 0/1 in x's dtype,
table [5, H].

On a CUDA tensor it launches the hand-written kernel (csrc/gin_aggregate.cu,
the port of llamole_tpu/ops/pallas/gin_aggregate.py `_gin_kernel`) or
raises; on a CPU tensor it runs `gin_aggregate_reference`, the plain
PyTorch version (the torch form of `_gin_reference`, computed in f32 and
rounded once to x's dtype, as the kernel does), which the tests and
chip_smoke.py also compare the kernel against. The card path is forward
only: its backward is a later kernel, so it refuses inputs that would
record an autograd graph.
"""

import torch
import torch.nn.functional as F

from . import cuda_lib

NUM_EDGE_CLASSES = 5


def gin_aggregate_reference(x, edge_classes, adj, table) -> torch.Tensor:
    """Plain PyTorch composition with the kernel's semantics."""
    bond = table.float()[edge_classes.long()]                 # [B, N, N, H]
    msg = F.gelu(x.float()[:, None, :, :] + bond, approximate="none")
    return torch.einsum("bijh,bij->bih", msg, adj.float()).to(x.dtype)


def gin_aggregate(x, edge_classes, adj, table) -> torch.Tensor:
    """sum_j adj[., i, j] * gelu(x_j + table[edge_ij]) -> [B, N, H]."""
    if x.device.type == "cpu":
        return gin_aggregate_reference(x, edge_classes, adj, table)
    if x.device.type != "cuda":
        raise ValueError(f"gin_aggregate: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"x must be [B, N, H], got {tuple(x.shape)}")
    b, n, h = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x dtype {x.dtype}: the kernel takes float32 or "
                        "bfloat16")
    if torch.is_grad_enabled() and (x.requires_grad or table.requires_grad):
        raise RuntimeError("gin_aggregate on the card has no backward yet "
                           "(ROADMAP.md); run it under torch.no_grad()")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if (edge_classes.dtype != torch.int32
            or tuple(edge_classes.shape) != (b, n, n)
            or edge_classes.device != x.device
            or not edge_classes.is_contiguous()):
        raise ValueError("edge_classes must be a contiguous int32 [B, N, N] "
                         "tensor on x's device (convert once per forward, "
                         "not per layer)")
    if (adj.dtype != x.dtype or tuple(adj.shape) != (b, n, n)
            or adj.device != x.device or not adj.is_contiguous()):
        raise ValueError(f"adj must be a contiguous [B, N, N] {x.dtype} "
                         "tensor on x's device")
    if (tuple(table.shape) != (NUM_EDGE_CLASSES, h) or table.dtype != x.dtype
            or table.device != x.device or not table.is_contiguous()):
        raise ValueError(f"table must be a contiguous [{NUM_EDGE_CLASSES}, "
                         f"{h}] {x.dtype} tensor on x's device")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = cuda_lib.library()
    fn = (lib.cdll.llamole_gin_aggregate_bf16 if x.dtype == torch.bfloat16
          else lib.cdll.llamole_gin_aggregate_f32)
    with torch.cuda.device(x.device):   # the C launch uses the current one
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), edge_classes.data_ptr(), adj.data_ptr(),
                  table.data_ptr(), out.data_ptr(), b, n, h, stream)
    lib.check(code, "gin_aggregate launch")
    gin_aggregate.launches += 1
    return out


gin_aggregate.launches = 0
