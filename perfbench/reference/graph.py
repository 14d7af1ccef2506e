"""The plain reference of Llamole's graph modules, in float32 with TF32 off
(`tf32=True` runs the matrix products in TF32: the control's precision
for a float32 module):

  * GIN convolution:  out_i = MLP((1 + eps) x_i + sum_j a_ij gelu(x_j +
    bond[e_ij])), MLP = fc1 -> LayerNorm -> gelu -> fc2
  * GraphCLIP: atom embedding, GIN layers with LayerNorm, gelu (not on the
    last), residuals and a virtual node (max-pool feedback MLP), add pool,
    projection MLP, unit norm
  * the template predictor: the same GIN with an AdaLN adapter per layer
    (non-affine LayerNorm, scale / shift / gate from SiLU(text)), add pool,
    decoder MLP
  * the GraphDiT denoiser: tokens [X_i || E_i,:] -> linear -> LayerNorm;
    c = t_emb + property embeddings + text embedding; blocks of
    x += gate * modulate(LN(attn(x))) and the same for the MLP, attention
    with LayerNorm on q and k and a key mask; an AdaLN output layer added
    to the input one-hots, masked and symmetrised
  * the diffusion CE: lambda-weighted masked node and edge cross-entropy
  * the cosine schedule's alpha_bar (the training cell's noise)

Weights come as {state-dict name: tensor} (perfbench/weights.py).
"""

import contextlib
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

W = Dict[str, torch.Tensor]


@contextlib.contextmanager
def precision(tf32: bool):
    """Matrix products in full float32, or in TF32 when `tf32`."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def linear(w: W, name: str, x):
    y = x @ w[f"{name}.weight"].t()
    b = w.get(f"{name}.bias")
    return y if b is None else y + b


def layer_norm(x, weight=None, bias=None, eps=1e-5):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    y = (x - mean) / torch.sqrt(var + eps)
    return y if weight is None else y * weight + bias


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def norm_mlp(w: W, name: str, x):
    h = linear(w, f"{name}.fc1", x)
    h = layer_norm(h, w[f"{name}.norm.weight"], w[f"{name}.norm.bias"])
    return linear(w, f"{name}.fc2", gelu(h))


def gin_conv(w: W, name: str, x, edges, adj):
    """x [B, N, H], edges [B, N, N] classes, adj [B, N, N] 0 / 1."""
    bond = w[f"{name}.bond_embedding"][edges.long()]          # [B, N, N, H]
    msg = gelu(x[:, None, :, :] + bond)
    agg = (msg * adj[..., None]).sum(dim=2)
    return norm_mlp(w, f"{name}.mlp", (1.0 + w[f"{name}.eps"]) * x + agg)


def _graph_inputs(atoms, edges, mask):
    pair = mask[:, :, None] & mask[:, None, :]
    adj = ((edges > 0) & pair).float()
    return adj, mask.float()[..., None]


def _max_pool(x, mask):
    return torch.where(mask[..., None], x, torch.full_like(x, -1e30)).amax(1)


def graphclip(w: W, atoms, edges, mask, layers: int, p="graph_encoder"):
    """Unit-norm molecule embeddings [B, H]."""
    adj, mf = _graph_inputs(atoms, edges, mask)
    h_prev = w[f"{p}.atom_encoder"][atoms.long()] * mf
    vn = w[f"{p}.virtualnode"][None].expand(h_prev.shape[0], -1)
    for l in range(layers):
        h_in = h_prev + vn[:, None, :] * mf
        h = gin_conv(w, f"{p}.convs.{l}", h_in, edges, adj)
        h = layer_norm(h, w[f"{p}.norms.{l}.weight"], w[f"{p}.norms.{l}.bias"])
        if l < layers - 1:
            h = gelu(h)
        h = h + h_in
        if l < layers - 1:
            vn = vn + norm_mlp(w, f"{p}.vn_mlps.{l}", _max_pool(h_in, mask))
        h_prev = h
    g = (h_prev * mf).sum(1)
    x = norm_mlp(w, f"{p}.projection", g)
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def predictor(w: W, atoms, edges, mask, cond, layers: int,
              p="graph_predictor"):
    """Template logits [B, out] under the text condition cond [B, T]."""
    adj, mf = _graph_inputs(atoms, edges, mask)
    c = F.silu(cond)
    h_prev = w[f"{p}.atom_encoder"][atoms.long()] * mf
    vn = w[f"{p}.virtualnode"][None].expand(h_prev.shape[0], -1)
    for l in range(layers):
        h_in = h_prev + vn[:, None, :] * mf
        shift, scale, gate = linear(w, f"{p}.adapters.{l}", c).chunk(3, -1)
        h = layer_norm(gin_conv(w, f"{p}.convs.{l}", h_in, edges, adj))
        h = h * (1.0 + scale[:, None]) + shift[:, None]
        if l < layers - 1:
            h = gelu(h)
        h = gate[:, None] * h + h_in
        if l < layers - 1:
            vn = vn + norm_mlp(w, f"{p}.vn_mlps.{l}", _max_pool(h_in, mask))
        h_prev = h
    return norm_mlp(w, f"{p}.decoder", (h_prev * mf).sum(1))


def _softsign(x):
    return x / (1.0 + x.abs())


def _modulate(x, shift, scale):
    return x * (1.0 + scale[:, None]) + shift[:, None]


def timestep_embedding(t, dim=256, max_period=10000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def condition(w: W, y, txt, t, draws=None, drop_prob=0.0,
              p="graph_decoder.denoiser"):
    """c = t_emb + sum_d property_d + text. y [B, ydim] (NaN = absent),
    txt [B, T] (NaN rows = dropped). draws: the training draws, a
    callable draws(kind, shape) giving uniform ("rand") or normal
    ("randn") samples in the program's order: per property a drop test
    and a noise vector, then the text's drop test."""
    te = timestep_embedding(t)
    c = linear(w, f"{p}.t_embedder.fc2",
               F.silu(linear(w, f"{p}.t_embedder.fc1", te)))
    null = w[f"{p}.y_embedder.null_embedding"]
    for d in range(y.shape[1]):
        label = y[:, d:d + 1]
        nan = torch.isnan(label)
        drop = nan
        if draws is not None:
            drop = drop | (draws("rand", label.shape) < drop_prob)
        safe = torch.where(nan, torch.zeros_like(label), label)
        hid = torch.softmax(linear(w, f"{p}.y_embedder.mlps.{d}.fc1", safe),
                            dim=1)
        emb = torch.where(drop, null[d][None],
                          linear(w, f"{p}.y_embedder.mlps.{d}.fc2", hid))
        if draws is not None:
            emb = emb + draws("randn", emb.shape)
        c = c + emb
    tdrop = torch.isnan(txt.sum(dim=1, keepdim=True))
    if draws is not None:
        tdrop = tdrop | (draws("rand", tdrop.shape) < drop_prob)
    safe = torch.where(torch.isnan(txt), torch.zeros_like(txt), txt)
    return c + torch.where(tdrop, w[f"{p}.txt_embedder.null_embedding"],
                           linear(w, f"{p}.txt_embedder.linear", safe))


def denoiser(w: W, X, E, mask, y, txt, t, cfg: dict, draws=None,
             p="graph_decoder.denoiser"):
    """(atom logits [B, N, dx], bond logits [B, N, N, de]) of one-hot X, E
    at normalised time t."""
    b, n, dx = X.shape
    de = E.shape[-1]
    heads = cfg["num_heads"]
    tokens = torch.cat([X, E.reshape(b, n, n * de)], dim=-1)
    x = layer_norm(linear(w, f"{p}.x_embedder.linear", tokens),
                   w[f"{p}.x_embedder.norm.weight"],
                   w[f"{p}.x_embedder.norm.bias"])
    c = condition(w, y, txt, t, draws, cfg["drop_condition"], p)
    h = x.shape[-1]
    dh = h // heads
    for j in range(cfg["depth"]):
        bp = f"{p}.blocks.{j}"
        mods = _softsign(linear(w, f"{bp}.ada_fc2",
                                F.silu(linear(w, f"{bp}.ada_fc1", c))))
        sh_a, sc_a, g_a, sh_m, sc_m, g_m = mods.chunk(6, dim=-1)
        qkv = linear(w, f"{bp}.attn.qkv", x)
        q, k, v = qkv.reshape(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4)
        q = layer_norm(q, w[f"{bp}.attn.q_norm.weight"],
                       w[f"{bp}.attn.q_norm.bias"])
        k = layer_norm(k, w[f"{bp}.attn.k_norm.weight"],
                       w[f"{bp}.attn.k_norm.bias"])
        logits = (q @ k.transpose(-1, -2)) / math.sqrt(dh)
        logits = logits.masked_fill(~mask[:, None, None, :], -1e30)
        attn = (torch.softmax(logits, -1) @ v).transpose(1, 2).reshape(b, n,
                                                                       h)
        attn = linear(w, f"{bp}.attn.proj", attn)
        x = x + g_a[:, None] * _modulate(layer_norm(attn), sh_a, sc_a)
        m = linear(w, f"{bp}.mlp.fc2", gelu(linear(w, f"{bp}.mlp.fc1", x)))
        x = x + g_m[:, None] * _modulate(layer_norm(m), sh_m, sc_m)
    o = f"{p}.output_layer"
    x_all = linear(w, f"{o}.decoder.fc2",
                   gelu(linear(w, f"{o}.decoder.fc1", x)))
    shift, scale = linear(w, f"{o}.ada_fc2",
                          F.silu(linear(w, f"{o}.ada_fc1", c))).chunk(2, -1)
    x_all = _modulate(layer_norm(x_all), shift, scale)
    atom = X + x_all[:, :, :dx]
    bond = E + x_all[:, :, dx:].reshape(b, n, n, de)
    pair = mask[:, :, None] & mask[:, None, :]
    eye = torch.eye(n, dtype=torch.bool, device=X.device)[None]
    bond = torch.where((pair & ~eye)[..., None], bond, 0.0)
    bond = 0.5 * (bond + bond.transpose(1, 2))
    atom = torch.where(mask[..., None], atom, 0.0)
    return atom, bond


def masked_ce(pred, true):
    """Mean cross-entropy over the rows with any one-hot mass."""
    pred = pred.reshape(-1, pred.shape[-1])
    true = true.reshape(-1, true.shape[-1])
    keep = (true != 0).any(-1)
    nll = -torch.log_softmax(pred, -1).gather(1, true.argmax(-1)[:, None])[:,
                                                                           0]
    return torch.where(keep, nll, 0.0).sum() / keep.sum().clamp_min(1)


def diffusion_ce(pred_x, pred_e, true_x, true_e, lambdas):
    return (lambdas[0] * masked_ce(pred_x, true_x)
            + lambdas[1] * masked_ce(pred_e, true_e))


def alphas_bar(T: int):
    """alpha_bar(t), t = 0..T, of the cosine schedule (s = 0.008), in
    float64."""
    steps = T + 2
    x = np.linspace(0, steps, steps)
    ac = np.cos(0.5 * np.pi * ((x / steps) + 0.008) / 1.008) ** 2
    ac = ac / ac[0]
    betas = np.clip(1.0 - ac[1:] / ac[:-1], 0.0, 1.0)
    return np.exp(np.cumsum(np.log(np.clip(1.0 - betas, 1e-30, None))))


def one_hot_graph(atoms_active, edges, mask, dx: int, de: int):
    """One-hot X [B, N, dx] (rows outside the active set or masked all 0)
    and E [B, N, N, de] over valid pairs."""
    X = (F.one_hot(atoms_active.clamp_min(0).long(), dx).float()
         * ((atoms_active >= 0) & mask).float()[..., None])
    pair = (mask[:, :, None] & mask[:, None, :]).float()[..., None]
    E = F.one_hot(edges.long(), de).float() * pair
    return X, E


def generator_draws(generator: Optional[torch.Generator], device):
    """draws(kind, shape) from a torch.Generator, in call order."""
    def draws(kind, shape):
        fn = torch.rand if kind == "rand" else torch.randn
        return fn(shape, generator=generator, device=device)
    return draws
