"""GIN message aggregation for dense padded graph batches, with its
backward.

`gin_aggregate(x, edge_classes, adj, table)` computes

    out[b, i] = sum_j adj[b, i, j] * gelu(x[b, j] + table[edge[b, i, j]])

with the exact GELU, f32 accumulation and the output in x's dtype, never
forming the [B, N, N, H] messages on the card. x [B, N, H], edge_classes
[B, N, N] int (classes 0-4, 0 = no bond), adj [B, N, N] 0/1 in x's dtype,
table [5, H]. It is a torch.autograd.Function: gradients flow to x and to
the table, as the JAX custom_vjp gives them.

On a CUDA tensor the forward launches kernel B (csrc/gin_aggregate.cu,
the port of llamole_tpu/ops/pallas/gin_aggregate.py `_gin_kernel`) and
the backward kernel C (`gin_aggregate_backward`, the port of
`_gin_bwd_kernel`, on one of two bodies by N: `gin_backward_body`), or
they raise; on a CPU tensor both directions run
their plain PyTorch versions, `gin_aggregate_reference` (the torch form of
`_gin_reference`) and `gin_aggregate_backward_reference` (of
`_gin_bwd_jnp`), which the tests and chip_smoke.py also compare the
kernels against. The plain versions compute in f32 (f64 for f64 inputs)
and round once to the input dtype, as the kernels do.
"""

import torch
import torch.nn.functional as F

from . import cuda_lib
from .cuda_lib import MAX_SHARED_BYTES, launch

NUM_EDGE_CLASSES = 5


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def gin_aggregate_reference(x, edge_classes, adj, table) -> torch.Tensor:
    """Plain PyTorch composition with the kernel's semantics."""
    acc = _acc_dtype(x)
    bond = table.to(acc)[edge_classes.long()]                 # [B, N, N, H]
    msg = F.gelu(x.to(acc)[:, None, :, :] + bond, approximate="none")
    return torch.einsum("bijh,bij->bih", msg, adj.to(acc)).to(x.dtype)


def gin_aggregate_backward_reference(x, edge_classes, adj, table, g):
    """Plain backward: (dx in x's dtype, dtable in table's dtype) from the
    output gradient g [B, N, H] (the torch form of `_gin_bwd_jnp`)."""
    acc = _acc_dtype(x)
    e = edge_classes.long()
    pre = x.to(acc)[:, None, :, :] + table.to(acc)[e]         # [B, N, N, H]
    cdf = 0.5 * (1.0 + torch.erf(pre * 0.7071067811865475))
    pdf = torch.exp(-0.5 * pre * pre) * 0.3989422804014327
    w = g.to(acc)[:, :, None, :] * adj.to(acc)[..., None] * (cdf + pre * pdf)
    dx = w.sum(dim=1)                                          # over i
    dtable = torch.zeros((table.shape[0], x.shape[-1]), dtype=acc,
                         device=x.device)
    dtable.index_add_(0, e.reshape(-1), w.reshape(-1, w.shape[-1]))
    return dx.to(x.dtype), dtable.to(table.dtype)


def _check(x, edge_classes, adj, table) -> None:
    """What the kernels take: contiguous f32 / bf16 x, adj and table of
    one dtype, int32 edge classes, all on x's card."""
    if x.dim() != 3:
        raise ValueError(f"x must be [B, N, H], got {tuple(x.shape)}")
    b, n, h = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x dtype {x.dtype}: the kernel takes float32 or "
                        "bfloat16")
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


def _on_card(x, what: str) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return True


def _forward(x, edge_classes, adj, table) -> torch.Tensor:
    """Kernel B on the card, the plain version on the CPU."""
    if not _on_card(x, "gin_aggregate"):
        return gin_aggregate_reference(x, edge_classes, adj, table)
    _check(x, edge_classes, adj, table)
    b, n, h = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    launch(cuda_lib.entry(f"llamole_gin_aggregate_"
                          f"{cuda_lib.dtype_suffix(x.dtype)}"), x.device,
           "gin_aggregate launch", x.data_ptr(), edge_classes.data_ptr(),
           adj.data_ptr(), table.data_ptr(), out.data_ptr(), b, n, h)
    gin_aggregate.launches += 1
    return out


def gin_backward_shared_bytes(n: int, body: str = "smem") -> int:
    """Dynamic shared memory of one kernel-C block (csrc/gin_aggregate.cu
    backward_smem_bytes): a bitmask of each column's rows and the 8 warps'
    [5, 128] f32 dtable rows, plus, in the "smem" body, adj's non-zero
    values and classes at [i, j] (8 N^2 bytes). H does not enter it."""
    staged = 2 * n * n if body == "smem" else 0
    return 4 * (staged + n * -(-n // 32) + 8 * 5 * 128)


def _largest_n(body: str) -> int:
    """The largest N whose block fits the shared memory a block may opt
    into."""
    return max(n for n in range(1, 4096)
               if gin_backward_shared_bytes(n, body) <= MAX_SHARED_BYTES)


# 161: the staged body; 1292: the body that keeps only the masks
GIN_BWD_SMEM_MAX_NODES = _largest_n("smem")
GIN_BWD_MAX_NODES = _largest_n("global")


def gin_backward_body(n: int) -> str:
    """Kernel C's body for graphs of n nodes: "smem" (the pair values and
    classes staged in shared memory) up to GIN_BWD_SMEM_MAX_NODES, else
    "global" (read at the pairs from device memory)."""
    return "smem" if n <= GIN_BWD_SMEM_MAX_NODES else "global"


def _launch_backward(x, edge_classes, adj, table, g, body: str):
    """Kernel C on the card on `body`, launched and not counted: (dx,
    dtable). The caller has checked the inputs and that N fits the
    body."""
    b, n, h = x.shape
    dx = torch.empty_like(x)
    # one dtable partial per graph; the kernel writes every element of both
    part = torch.empty((b, NUM_EDGE_CLASSES, h), dtype=torch.float32,
                       device=x.device)
    launch(cuda_lib.entry("llamole_gin_backward_"
                          + cuda_lib.dtype_suffix(x.dtype)), x.device,
           "gin_aggregate_backward launch", x.data_ptr(),
           edge_classes.data_ptr(), adj.data_ptr(), table.data_ptr(),
           g.data_ptr(), dx.data_ptr(), part.data_ptr(), b, n, h,
           int(body == "smem"))
    # the partials summed in a fixed order: no atomics, the same bits on
    # every run
    return dx, part.sum(dim=0).to(table.dtype)


def gin_aggregate_backward(x, edge_classes, adj, table, g):
    """(dx, dtable) of gin_aggregate for the output gradient g [B, N, H]:
    kernel C on the card (f32 sums, rounded to x's / table's dtype), on
    the body gin_backward_body(N) picks; the plain version on the CPU."""
    if not _on_card(x, "gin_aggregate_backward"):
        return gin_aggregate_backward_reference(x, edge_classes, adj, table,
                                                g)
    _check(x, edge_classes, adj, table)
    if (g.dtype != x.dtype or g.shape != x.shape or g.device != x.device
            or not g.is_contiguous()):
        raise ValueError(f"g must be a contiguous {tuple(x.shape)} "
                         f"{x.dtype} tensor on x's device")
    n = x.shape[1]
    if n > GIN_BWD_MAX_NODES:
        raise ValueError(
            f"N={n} needs {gin_backward_shared_bytes(n, 'global')} bytes of "
            f"shared memory for its column masks; kernel C holds at most "
            f"{MAX_SHARED_BYTES} (N <= {GIN_BWD_MAX_NODES})")
    if not x.numel():
        return torch.empty_like(x), torch.zeros_like(table)
    body = gin_backward_body(n)
    out = _launch_backward(x, edge_classes, adj, table, g, body)
    gin_aggregate_backward.launches += 1
    if body == "smem":
        gin_aggregate_backward.launches_smem += 1
    else:
        gin_aggregate_backward.launches_global += 1
    return out


class _GinAggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, edge_classes, adj, table):
        ctx.save_for_backward(x, edge_classes, adj, table)
        return _forward(x, edge_classes, adj, table)

    @staticmethod
    def backward(ctx, g):
        x, edge_classes, adj, table = ctx.saved_tensors
        dx, dtable = gin_aggregate_backward(x, edge_classes, adj, table,
                                            g.contiguous())
        return (dx if ctx.needs_input_grad[0] else None, None, None,
                dtable if ctx.needs_input_grad[3] else None)


def gin_aggregate(x, edge_classes, adj, table) -> torch.Tensor:
    """sum_j adj[., i, j] * gelu(x_j + table[edge_ij]) -> [B, N, H],
    differentiable in x and table."""
    return _GinAggregate.apply(x, edge_classes, adj, table)


gin_aggregate.launches = 0
# launches per body beside the total, as fused_block_attention counts them
gin_aggregate_backward.launches = 0
gin_aggregate_backward.launches_smem = 0
gin_aggregate_backward.launches_global = 0
