"""The GraphDiT denoiser: an AdaLN-modulated transformer over joint
node||edge-row tokens (llamole_tpu/models/graphdit/denoiser.py
apply_denoiser).

  token_i = [X_i || E_i,1..n] -> Linear -> LN        (x_embedder)
  c = t_emb + y_emb + txt_emb                        (conditioning)
  depth x Block: x += gate * mod(LN(attn(x)), s, b)  (post-attn LN, AdaLN
                 x += gate * mod(LN(mlp(x)), s, b)    with softsign output)
  OutputLayer: residual atom/bond logits, masked + symmetrized

Matmuls run in the parameters' dtype (bf16 on the card) with f32 layer
norms and f32 attention logits. With train=False (sampling) every block's
attention goes through ops.fused_attention.fused_block_attention: the
CUDA kernel (A) on a CUDA tensor, the plain version on a CPU tensor.
With train=True the blocks run the JAX package's training path inline
(qk LayerNorm + masked_attention in plain PyTorch, so autograd reaches
every block), properties and text are dropped to their null embeddings
with probability cfg.drop_condition, and every property embedding gets
N(0, 1) noise, the draws taken from an explicit torch.Generator.

`quantize_denoiser_params` turns the large dense layers int8 in place
(JAX quantize_denoiser_params; ops.nn.Int8Dense): serving only, a forward
under autograd then raises.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import masked_attention
from ...ops.fused_attention import fused_block_attention
from ...ops.nn import (MLP, Int8Dense, LayerNorm, init_dense_, layer_norm,
                       quantize_dense, softsign)
from .config import GraphDiTConfig


def _timestep_embedding(t: torch.Tensor, dim: int = 256,
                        max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding of (possibly fractional) timesteps [B]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _modulate(x, shift, scale):
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


class _XEmbedder(nn.Module):
    def __init__(self, in_dim, h, dtype, device):
        super().__init__()
        self.linear = nn.Linear(in_dim, h, bias=False, dtype=dtype,
                                device=device)
        self.norm = LayerNorm(h, dtype, device)


class _TimestepEmbedder(nn.Module):
    def __init__(self, h, dtype, device):
        super().__init__()
        self.fc1 = nn.Linear(256, h, dtype=dtype, device=device)
        self.fc2 = nn.Linear(h, h, dtype=dtype, device=device)

    def forward(self, t, dtype):
        emb = _timestep_embedding(t.reshape(-1)).to(dtype)
        return self.fc2(F.silu(self.fc1(emb)))


class _PropertyMLP(nn.Module):
    def __init__(self, h, dtype, device):
        super().__init__()
        self.fc1 = nn.Linear(1, h, dtype=dtype, device=device)
        self.fc2 = nn.Linear(h, h, bias=False, dtype=dtype, device=device)


class ConditionEmbedder(nn.Module):
    """Per-property MLPs; NaN (absent) or unconditioned channels take a
    learned null embedding. The softmax runs over the HIDDEN axis, as the
    reference's torch Softmax(dim=1) does (llamole_tpu denoiser.py:176)."""

    def __init__(self, ydim, h, dtype, device):
        super().__init__()
        self.mlps = nn.ModuleList(_PropertyMLP(h, dtype, device)
                                  for _ in range(ydim))
        self.null_embedding = nn.Parameter(
            torch.empty(ydim, h, dtype=dtype, device=device))

    def forward(self, y, unconditioned: bool, dtype, train: bool = False,
                drop_prob: float = 0.0, generator=None, rows=None):
        """train: each channel drops with probability drop_prob and every
        channel's embedding gets N(0, 1) noise (dropped ones too). rows:
        see _draw."""
        total = None
        for d, p in enumerate(self.mlps):
            label = y[:, d:d + 1].to(dtype)
            nan = torch.isnan(label)                   # [B, 1]
            drop = torch.ones_like(nan) if unconditioned else nan
            if train and not unconditioned and drop_prob > 0:
                drop = drop | _bernoulli(label.shape, drop_prob, generator,
                                         y.device, rows)
            # resolve NaN before any matmul: NaN * 0 would poison rows
            safe = torch.where(nan, torch.zeros_like(label), label)
            hid = torch.softmax(p.fc1(safe).float(), dim=1).to(dtype)
            emb = torch.where(drop, self.null_embedding[d][None, :],
                              p.fc2(hid))
            if train:
                emb = emb + _draw(lambda shape: torch.randn(
                    shape, generator=generator, device=emb.device),
                    emb.shape, rows).to(dtype)
            total = emb if total is None else total + emb
        return total


def _draw(fn, shape, rows):
    """fn(shape); with rows = (offset, total), a window of a batch's rows
    (data parallelism): fn over the whole batch's rows, this window's
    kept, so every rank draws what the mesh-less run draws."""
    if rows is None:
        return fn(shape)
    off, total = rows
    return fn((total, *shape[1:]))[off:off + shape[0]]


def _bernoulli(shape, prob: float, generator, device,
               rows=None) -> torch.Tensor:
    """True with probability prob (the JAX uniform < prob)."""
    return _draw(lambda sh: torch.rand(sh, generator=generator,
                                       device=device), shape, rows) < prob


class _TextEmbedder(nn.Module):
    def __init__(self, text_dim, h, dtype, device):
        super().__init__()
        self.linear = nn.Linear(text_dim, h, dtype=dtype, device=device)
        self.null_embedding = nn.Parameter(
            torch.empty(1, h, dtype=dtype, device=device))

    def forward(self, txt, unconditioned: bool, dtype, train: bool = False,
                drop_prob: float = 0.0, generator=None, rows=None):
        nan = torch.isnan(txt)
        drop = torch.isnan(txt.float().sum(dim=1, keepdim=True))   # [B, 1]
        if unconditioned:
            drop = torch.ones_like(drop)
        elif train and drop_prob > 0:
            drop = drop | _bernoulli(drop.shape, drop_prob, generator,
                                     txt.device, rows)
        safe = torch.where(nan, torch.zeros_like(txt), txt).to(dtype)
        return torch.where(drop, self.null_embedding[0][None, :],
                           self.linear(safe))


class _Attention(nn.Module):
    def __init__(self, h, num_heads, dtype, device):
        super().__init__()
        dh = h // num_heads
        self.num_heads = num_heads
        self.qkv = nn.Linear(h, 3 * h, bias=False, dtype=dtype, device=device)
        self.q_norm = LayerNorm(dh, dtype, device)
        self.k_norm = LayerNorm(dh, dtype, device)
        self.proj = nn.Linear(h, h, dtype=dtype, device=device)

    def forward(self, x, node_mask, train: bool = False):
        qkv = self.qkv(x)
        if not train:
            attn = fused_block_attention(
                qkv, node_mask, self.q_norm.weight, self.q_norm.bias,
                self.k_norm.weight, self.k_norm.bias, self.num_heads)
            return self.proj(attn)
        # the JAX training path (denoiser.py _block_apply, unfused):
        # split heads -> qk LayerNorm -> masked attention -> merge heads
        b, n, h = x.shape
        q, k, v = qkv.reshape(b, n, 3, self.num_heads, h // self.num_heads
                              ).permute(2, 0, 3, 1, 4)
        q = layer_norm(q, self.q_norm.weight, self.q_norm.bias)
        k = layer_norm(k, self.k_norm.weight, self.k_norm.bias)
        attn = masked_attention(q, k, v, key_mask=node_mask)
        return self.proj(attn.transpose(1, 2).reshape(b, n, h))


class Block(nn.Module):
    def __init__(self, h, cfg: GraphDiTConfig, dtype, device):
        super().__init__()
        self.attn = _Attention(h, cfg.num_heads, dtype, device)
        self.mlp = MLP(h, int(h * cfg.mlp_ratio), h, dtype, device)
        self.ada_fc1 = nn.Linear(h, h, dtype=dtype, device=device)
        self.ada_fc2 = nn.Linear(h, 6 * h, dtype=dtype, device=device)

    def forward(self, x, c, node_mask, train: bool = False):
        mods = softsign(self.ada_fc2(F.silu(self.ada_fc1(c))))
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = mods.chunk(6, dim=-1)
        x = x + g_a[:, None, :] * _modulate(
            layer_norm(self.attn(x, node_mask, train)), sh_a, sc_a)
        x = x + g_m[:, None, :] * _modulate(
            layer_norm(self.mlp(x)), sh_m, sc_m)
        return x


class _OutputLayer(nn.Module):
    def __init__(self, h, final_dim, dtype, device):
        super().__init__()
        self.decoder = MLP(h, h, final_dim, dtype, device)
        self.ada_fc1 = nn.Linear(h, h, dtype=dtype, device=device)
        self.ada_fc2 = nn.Linear(h, 2 * final_dim, dtype=dtype,
                                 device=device)


class Denoiser(nn.Module):
    """Parameters are uninitialised until `reset_parameters(generator)`
    or `load_state_dict` (weights.state_dict_of) fills them."""

    def __init__(self, cfg: GraphDiTConfig, dtype=torch.float32,
                 device=None):
        super().__init__()
        n, h = cfg.max_n_nodes, cfg.hidden_size
        in_dim = cfg.Xdim + n * cfg.Edim
        self.cfg = cfg
        meta = torch.device("meta")   # allocate once, uninitialised, below
        self.x_embedder = _XEmbedder(in_dim, h, dtype, meta)
        self.t_embedder = _TimestepEmbedder(h, dtype, meta)
        self.y_embedder = ConditionEmbedder(cfg.ydim, h, dtype, meta)
        self.txt_embedder = _TextEmbedder(cfg.text_dim, h, dtype, meta)
        self.blocks = nn.ModuleList(Block(h, cfg, dtype, meta)
                                    for _ in range(cfg.depth))
        self.output_layer = _OutputLayer(h, in_dim, dtype, meta)
        self.to_empty(device=device or torch.device("cpu"))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX init_denoiser scheme: xavier Linear, zero bias, unit
        LayerNorm, N(0, 1) null embeddings, zero AdaLN first layers
        (gates start at 0) and a zero output AdaLN."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                init_dense_(m, generator)
            elif isinstance(m, LayerNorm):
                m.reset_parameters()
        self.y_embedder.null_embedding.normal_(generator=generator)
        self.txt_embedder.null_embedding.normal_(generator=generator)
        for blk in self.blocks:
            blk.ada_fc1.weight.zero_()
            blk.ada_fc1.bias.zero_()
        self.output_layer.ada_fc2.weight.zero_()
        self.output_layer.ada_fc2.bias.zero_()

    def forward(self, X_in, E_in, node_mask, y, txt, t,
                unconditioned: bool = False, train: bool = False,
                generator=None, rows=None):
        """X_in [B,N,Xdim], E_in [B,N,N,Edim] one-hot; node_mask [B,N]
        bool; y [B,ydim] (NaN = unconditioned channel); txt [B,text_dim];
        t [B] normalized timestep -> (X_logits, E_logits), masked.
        train: the training path (plain attention, condition dropout and
        property noise drawn from `generator`). rows = (offset, total):
        the batch is rows offset.. of a batch of total (data
        parallelism), whose draws are the whole batch's."""
        emb = self.x_embedder
        dtype = (emb.norm.weight.dtype if isinstance(emb.linear, Int8Dense)
                 else emb.linear.weight.dtype)
        b, n, dx = X_in.shape
        de = E_in.shape[-1]
        X_in = X_in.to(dtype)
        E_in = E_in.to(dtype)

        tokens = torch.cat([X_in, E_in.reshape(b, n, n * de)], dim=-1)
        x = self.x_embedder.norm(self.x_embedder.linear(tokens))
        c = self.t_embedder(t, dtype)
        p = self.cfg.drop_condition
        c = c + self.y_embedder(y, unconditioned, dtype, train, p, generator,
                                rows)
        c = c + self.txt_embedder(txt, unconditioned, dtype, train, p,
                                  generator, rows)
        for blk in self.blocks:
            x = blk(x, c, node_mask, train)

        op = self.output_layer
        x_all = op.decoder(x)
        shift, scale = op.ada_fc2(F.silu(op.ada_fc1(c))).chunk(2, dim=-1)
        x_all = _modulate(layer_norm(x_all), shift, scale)

        atom_out = X_in + x_all[:, :, :dx]
        bond_out = E_in + x_all[:, :, dx:].reshape(b, n, n, de)
        pair = (node_mask[:, :, None] & node_mask[:, None, :])[..., None]
        eye = torch.eye(n, dtype=torch.bool, device=X_in.device)[None, :, :,
                                                                  None]
        bond_out = torch.where(pair & ~eye, bond_out, 0.0)
        bond_out = 0.5 * (bond_out + bond_out.transpose(1, 2))
        atom_out = torch.where(node_mask[:, :, None], atom_out, 0.0)
        return atom_out, bond_out


@torch.no_grad()
def quantize_denoiser_params(denoiser: Denoiser) -> Denoiser:
    """int8-quantize the denoiser's large dense layers in place (JAX
    quantize_denoiser_params): the x_embedder's linear, every block's qkv,
    proj, fc1 and fc2, and the output decoder's fc1 and fc2, each an
    ops.nn.Int8Dense (per-output-channel weight scales, per-row dynamic
    activation scales). Serving only: not differentiable. Returns the
    denoiser."""
    emb = denoiser.x_embedder
    emb.linear = quantize_dense(emb.linear)
    for blk in denoiser.blocks:
        blk.attn.qkv = quantize_dense(blk.attn.qkv)
        blk.attn.proj = quantize_dense(blk.attn.proj)
        blk.mlp.fc1 = quantize_dense(blk.mlp.fc1)
        blk.mlp.fc2 = quantize_dense(blk.mlp.fc2)
    dec = denoiser.output_layer.decoder
    dec.fc1 = quantize_dense(dec.fc1)
    dec.fc2 = quantize_dense(dec.fc2)
    return denoiser
