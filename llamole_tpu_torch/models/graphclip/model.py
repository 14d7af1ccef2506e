"""GraphCLIP molecule encoder (counterpart of
llamole_tpu/models/graphclip/model.py): GIN with a virtual node and a
projection head, L2-normalised graph embeddings.

Atom Embedding(118, H); per layer GINConv (kernel B) + affine LayerNorm +
GELU (not on the last layer) + residual; virtual-node max-pool feedback
MLP between layers; global add pool; projection head fc -> LN -> GELU ->
fc; unit-norm output. Runs in f32 with full-f32 matmuls.
"""

from dataclasses import dataclass

import torch
from torch import nn

from ...ops.gin import (GINConv, NormMLP, dense_graph_inputs,
                        full_f32_matmuls, masked_add_pool, masked_max_pool)
from ...ops.nn import LayerNorm, gelu

NUM_ATOM_CODES = 118


@dataclass
class GraphCLIPConfig:
    num_layer: int = 5
    hidden_size: int = 300
    dropout: float = 0.0


class GraphCLIP(nn.Module):
    """Parameters are uninitialised until `reset_parameters(generator)` or
    `load_state_dict` (weights.state_dict_of on the JAX params) fills
    them."""

    def __init__(self, cfg: GraphCLIPConfig, dtype=torch.float32,
                 device=None):
        super().__init__()
        if cfg.num_layer < 2:
            raise ValueError("Number of GNN layers must be greater than 1.")
        self.cfg = cfg
        self.hidden_size = h = cfg.hidden_size
        meta = torch.device("meta")
        self.atom_encoder = nn.Parameter(torch.empty(
            NUM_ATOM_CODES, h, dtype=dtype, device=meta))
        self.virtualnode = nn.Parameter(torch.empty(h, dtype=dtype,
                                                    device=meta))
        self.convs = nn.ModuleList(GINConv(h, dtype, meta)
                                   for _ in range(cfg.num_layer))
        self.norms = nn.ModuleList(LayerNorm(h, dtype, meta)
                                   for _ in range(cfg.num_layer))
        self.vn_mlps = nn.ModuleList(NormMLP(h, 4 * h, h, dtype, meta)
                                     for _ in range(cfg.num_layer - 1))
        self.projection = NormMLP(h, h, h, dtype, meta)
        self.to_empty(device=device or torch.device("cpu"))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX init: N(0, 1) atom embedding, zero virtual node, GIN
        and MLP inits, unit norms."""
        self.atom_encoder.normal_(generator=generator)
        self.virtualnode.zero_()
        for conv in self.convs:
            conv.reset_parameters(generator)
        for norm in self.norms:
            norm.reset_parameters()
        for mlp in self.vn_mlps:
            mlp.reset_parameters(generator)
        self.projection.reset_parameters(generator)

    def encode(self, atom_codes, edge_classes, node_mask) -> torch.Tensor:
        """[B, N] codes + [B, N, N] edge classes -> [B, H] graph features
        (pre-projection)."""
        dtype = self.atom_encoder.dtype
        mask_f = node_mask.to(dtype)[..., None]
        edges, adj = dense_graph_inputs(edge_classes, node_mask, dtype)
        h_prev = self.atom_encoder[atom_codes.long()] * mask_f
        vn = self.virtualnode[None, :].expand(h_prev.shape[0], -1)
        last = self.cfg.num_layer - 1
        for layer, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            h_in = h_prev + vn[:, None, :] * mask_f
            h = norm(conv(h_in, edges, adj))
            if layer < last:
                h = gelu(h)
            h = h + h_in
            if layer < last:
                vn = vn + self.vn_mlps[layer](masked_max_pool(h_in,
                                                              node_mask))
            h_prev = h
        return masked_add_pool(h_prev * mask_f, node_mask)

    def forward(self, atom_codes, edge_classes, node_mask) -> torch.Tensor:
        """L2-normalised molecule embeddings [B, H]."""
        with full_f32_matmuls():
            x = self.projection(self.encode(atom_codes, edge_classes,
                                            node_mask))
        norm = x.float().norm(dim=-1, keepdim=True)
        return (x.float() / norm.clamp_min(1e-12)).to(x.dtype)

    @classmethod
    def from_pretrained(cls, model_dir: str, **kwargs):
        raise NotImplementedError(
            f"loading GraphCLIP from {model_dir} is not ported to "
            "llamole_tpu_torch yet (ROADMAP.md: checkpoint files)")
