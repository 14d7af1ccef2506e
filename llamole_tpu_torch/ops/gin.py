"""Dense GIN message passing for padded graph batches (counterpart of
llamole_tpu/ops/gin.py).

Graphs are [B, N] atom codes + [B, N, N] edge classes (0 = no bond) with a
node mask. A GIN layer is

    out = MLP((1 + eps) * x + sum_j adj_ij * gelu(x_j + bond_emb(e_ij)))

where the sum is kernel B (ops/gin_aggregate.py) and the MLP is
fc1 -> LayerNorm(4H) -> exact GELU -> fc2, in full f32 (TF32 off, as the
JAX package pins default_matmul_precision("float32")).
"""

import contextlib

import torch
from torch import nn

from .gin_aggregate import NUM_EDGE_CLASSES, gin_aggregate
from .nn import LayerNorm, gelu, init_dense_


@contextlib.contextmanager
def full_f32_matmuls():
    """Matmuls in full f32 inside the block (TF32 off), restored after."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


class NormMLP(nn.Module):
    """fc1 -> affine LayerNorm -> exact GELU -> fc2: the JAX package's
    {"fc1", "norm", "fc2"} MLPs (GIN update, virtual-node feedback,
    projection head, predictor decoder)."""

    def __init__(self, in_dim: int, hidden_dim: int, out_dim: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden_dim, dtype=dtype, device=device)
        self.norm = LayerNorm(hidden_dim, dtype=dtype, device=device)
        self.fc2 = nn.Linear(hidden_dim, out_dim, dtype=dtype, device=device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_dense_(self.fc1, generator)
        self.norm.reset_parameters()
        init_dense_(self.fc2, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.norm(self.fc1(x))))


class GINConv(nn.Module):
    def __init__(self, hidden: int, dtype=torch.float32, device=None):
        super().__init__()
        self.bond_embedding = nn.Parameter(torch.empty(
            NUM_EDGE_CLASSES, hidden, dtype=dtype, device=device))
        self.eps = nn.Parameter(torch.empty((), dtype=dtype, device=device))
        self.mlp = NormMLP(hidden, 4 * hidden, hidden, dtype, device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """JAX gin_conv_init: N(0, 1) bond table, eps 0, xavier MLP."""
        self.bond_embedding.normal_(generator=generator)
        self.eps.zero_()
        self.mlp.reset_parameters(generator)

    def forward(self, x: torch.Tensor, edge_classes: torch.Tensor,
                adj: torch.Tensor) -> torch.Tensor:
        """x [B, N, H]; edge_classes [B, N, N] int32; adj [B, N, N] 0/1
        in x's dtype."""
        agg = gin_aggregate(x, edge_classes, adj, self.bond_embedding)
        with full_f32_matmuls():
            return self.mlp((1.0 + self.eps) * x + agg)


def masked_add_pool(x: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """Sum over valid nodes -> [B, H] (PyG global_add_pool)."""
    return torch.einsum("bnh,bn->bh", x, node_mask.to(x.dtype))


def masked_max_pool(x: torch.Tensor, node_mask: torch.Tensor) -> torch.Tensor:
    """Max over valid nodes -> [B, H] (PyG global_max_pool)."""
    neg = torch.tensor(-1e30, dtype=x.dtype, device=x.device)
    return torch.where(node_mask[..., None], x, neg).amax(dim=1)


def dense_graph_inputs(edge_classes: torch.Tensor, node_mask: torch.Tensor,
                       dtype) -> tuple:
    """(edge_classes as int32, adjacency 0/1 in `dtype`): the per-forward
    conversion every GIN layer then shares. A pair is an edge when its
    class is > 0 and both nodes are valid."""
    pair = node_mask[:, :, None] & node_mask[:, None, :]
    adj = ((edge_classes > 0) & pair).to(dtype)
    return edge_classes.to(torch.int32).contiguous(), adj
