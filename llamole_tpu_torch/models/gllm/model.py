"""Decoder-only LLM in PyTorch (counterpart of
llamole_tpu/models/gllm/model.py): the llama / qwen2 / mistral, qwen3,
gemma-1 / 2 / 3 and Mixtral sparse-MoE families, as LLMConfig selects.

RMSNorm (gemma: stored zero-centred, y = x̂ · (1 + w)) + RoPE (llama3.1 /
linear / dynamic scaling; gemma-3 spins its sliding layers on a second,
unscaled table) + GQA (qwen3 / gemma-3: per-head q/k RMSNorm before rope;
gemma: query_scale and the attention logit softcap, applied after the
scale and before the mask; gemma-2/3: alternating sliding-window layers)
+ SwiGLU, GeGLU with tanh GELU (gemma) or the sparse MoE (`moe_mlp`:
top-k routing in f32, a static capacity, the router's aux loss), the
sandwich norms (gemma-2/3), embeddings scaled by sqrt(hidden) in the model
dtype and the final logit softcap (gemma-2). An optional LoRA overlay on
every attention and dense-MLP projection, dense or quantized projections
(int8, W8A8 or int4: gllm/quantize.py, gllm/lora.py), a preallocated KV
cache written in place (in the compute dtype, or int8 with per-(token,
head) scales when cfg.kv_cache_dtype is 'int8'), and `generate`: prefill,
then a per-token decode loop that exits once every row has stopped (on the
card its step replays a CUDA graph: `_decode_graph`), or
prompt-lookup speculative decoding (`_speculative_loop`: K drafts from the
latest n-gram match in the history verified in one forward, delta-draft
rejection sampling, an acceptance guard that falls back to the per-token
loop), with temperature / top-k / top-p sampling over a bounded candidate
set and repetition penalty. Matmuls run in the parameters' dtype; norms,
rope, the router, attention logits and softmax in f32. Training is
`forward` with autograd on plus `lm_loss` (and, for MoE, the aux loss of
`forward(return_moe_aux=True)`); cfg.remat recomputes each decoder layer
in the backward pass (torch.utils.checkpoint) instead of keeping its
activations. With cfg.shift_attn, a training forward (`train=True`, no
cache) of plain causal attention (no softcap, query scale or sliding
window) whose length divides into groups of int(S * group_size_ratio) >=
2 tokens runs LongLoRA's S²-attn (`s2_attention`); any other length
falls back to full attention without a word, as in the JAX package
(`s2_attention.calls` counts the S² calls). With cfg.use_flash, any other
no-cache forward of plain causal attention on a CUDA device with
S >= cfg.flash_min_seq, S % 128 == 0 and head_dim 128 or 256
(`flash_ok`, JAX's `_flash_ok` with its TPU clause read as CUDA) runs
kernel E (ops/flash_attention.py) with the attention mask as segment ids,
as JAX's route runs jaxlib's Pallas flash kernel: a pad query attends the
pad keys before it, where the masked path attends only real keys.
"""

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.flash_attention import flash_attention
from ...utils import profiling
from .config import LLMConfig
from .lora import LoRALinear, adapters_off, lora_targets
from .quantize import empty_quantized_, projections

_NEG = -1e30
_TOP_P_CANDIDATES = 256  # top-p nucleus cap; see _warped_candidates


def check_supported(cfg: LLMConfig) -> None:
    """Refuse a config value the model does not know."""
    if cfg.kv_cache_dtype not in ("compute", "int8"):
        raise ValueError(f"kv_cache_dtype must be 'compute' or 'int8', "
                         f"got {cfg.kv_cache_dtype!r}")


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             unit_offset: bool = False):
    """RMSNorm in f32; unit_offset: the weight is stored zero-centred and
    scales by (1 + w) (gemma)."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    w = weight.float()
    if unit_offset:
        w = 1.0 + w
    return (x32 * torch.rsqrt(var + eps) * w).to(x.dtype)


class RMSNorm(nn.Module):
    # a per-head q / k norm under tensor parallelism (parallel/sharding.py
    # shard_llm): every rank's heads use its one scale, which enters
    # through to_tp so that its gradient is summed over the ranks
    tp = None

    def __init__(self, dim: int, eps: float, dtype, device,
                 unit_offset: bool = False):
        super().__init__()
        self.eps = eps
        self.unit_offset = unit_offset
        self.weight = nn.Parameter(torch.empty(dim, dtype=dtype,
                                               device=device))

    def forward(self, x):
        w = self.weight
        if self.tp is not None:
            from ...parallel.comm import to_tp
            w = to_tp(w, self.tp.group)
        return rms_norm(x, w, self.eps, self.unit_offset)


def rope_frequencies(cfg: LLMConfig) -> np.ndarray:
    """Inverse frequencies [head_dim / 2] (f64) with optional llama3.1 /
    linear / dynamic scaling, exactly as the JAX package computes them."""
    hd = cfg.head_dim_
    inv = 1.0 / (cfg.rope_theta ** (np.arange(0, hd, 2, dtype=np.float64)
                                    / hd))
    if cfg.rope_scaling == "llama3":
        low = cfg.rope_original_max_position / cfg.rope_low_freq_factor
        high = cfg.rope_original_max_position / cfg.rope_high_freq_factor
        wavelen = 2 * np.pi / inv
        smooth = np.clip(
            (cfg.rope_original_max_position / wavelen
             - cfg.rope_low_freq_factor)
            / (cfg.rope_high_freq_factor - cfg.rope_low_freq_factor),
            0.0, 1.0)
        inv = np.where(
            wavelen > low, inv / cfg.rope_scaling_factor,
            np.where(wavelen < high, inv,
                     (1 - smooth) * inv / cfg.rope_scaling_factor
                     + smooth * inv))
    elif cfg.rope_scaling == "linear":
        inv = inv / cfg.rope_scaling_factor
    elif cfg.rope_scaling == "dynamic":
        ratio = max(cfg.max_position_embeddings
                    / max(cfg.rope_original_max_position, 1), 1.0)
        alpha = (cfg.rope_scaling_factor * ratio
                 - (cfg.rope_scaling_factor - 1.0))
        theta = cfg.rope_theta * alpha ** (hd / max(hd - 2, 1))
        inv = 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float64) / hd))
    return inv


def rope_frequencies_local(cfg: LLMConfig) -> Optional[np.ndarray]:
    """gemma-3's table for its sliding layers: plain inverse frequencies
    at rope_local_base_freq, unscaled (the scaling applies to the global
    table only); None when the config has one rope."""
    if cfg.rope_local_base_freq is None:
        return None
    hd = cfg.head_dim_
    return 1.0 / (cfg.rope_local_base_freq
                  ** (np.arange(0, hd, 2, dtype=np.float64) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, Dh]; positions [B, S]; inv_freq [Dh/2] f32."""
    angles = positions.float()[..., None] * inv_freq[None, None, :]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def attention(q, k, v, mask_bst, scale: Optional[float] = None,
              softcap: Optional[float] = None):
    """GQA attention. q [B,S,H,D], k/v [B,T,KV,D], mask [B,S,T] bool.
    Logits in f32 (inputs upcast), times `scale` (default 1/sqrt(D)),
    soft-capped (cap * tanh(logits / cap)) when `softcap` is set, masked
    to -1e30; probs cast to v's dtype before the value product."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    q = q.reshape(b, s, kv, h // kv, d)
    logits = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float())
    logits = logits * (scale if scale is not None else 1.0 / math.sqrt(d))
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    logits = torch.where(mask_bst[:, None, None], logits, _NEG)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h * d)


def s2_attention(q, k, v, attention_mask, group_size: int,
                 head_offset: int = 0, num_heads: Optional[int] = None):
    """LongLoRA S²-attn (JAX _s2_attention), training only: KV heads
    expand to the query heads, the second half of the heads rolls by
    -group_size // 2 along the sequence, attention runs causally within
    groups of group_size tokens, and the outputs roll back. Each group's
    key validity comes from attention_mask, rolled with the keys for the
    shifted half (JAX's documented divergence from the reference, which
    reuses the first group's mask). q [B, S, H, D], k / v [B, S, KV, D],
    attention_mask [B, S] -> [B, S, H * D]. Under tensor parallelism q /
    k / v hold this rank's heads: head_offset is the global index of its
    first query head and num_heads the model's count, so the heads whose
    global index is num_heads // 2 or more are the shifted ones."""
    s2_attention.calls += 1
    b, s, h, d = q.shape
    kv = k.shape[2]
    if kv != h:
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
    ng, shift = s // group_size, group_size // 2
    # this rank's first shifted head
    half = min(max((num_heads or h) // 2 - head_offset, 0), h)

    def roll_half(x, amount):
        return torch.cat([x[:, :, :half],
                          torch.roll(x[:, :, half:], amount, dims=1)], dim=2)

    def group(x):
        return x.reshape(b * ng, group_size, h, d)

    qg, kg, vg = (group(roll_half(t, -shift)) for t in (q, k, v))
    causal = torch.ones((group_size, group_size), dtype=torch.bool,
                        device=q.device).tril()
    key_valid = attention_mask > 0
    parts = []
    if half:
        m_plain = causal[None] & key_valid.reshape(b * ng,
                                                   group_size)[:, None]
        parts.append(attention(qg[:, :, :half], kg[:, :, :half],
                               vg[:, :, :half], m_plain)
                     .reshape(b * ng, group_size, half, d))
    if half < h:
        m_shift = causal[None] & torch.roll(key_valid, -shift, dims=1
                                            ).reshape(b * ng,
                                                      group_size)[:, None]
        parts.append(attention(qg[:, :, half:], kg[:, :, half:],
                               vg[:, :, half:], m_shift)
                     .reshape(b * ng, group_size, h - half, d))
    out = torch.cat(parts, dim=2).reshape(b, s, h, d)
    return roll_half(out, shift).reshape(b, s, h * d)


s2_attention.calls = 0


KVCache = List[Dict[str, torch.Tensor]]


def make_kv_cache(cfg: LLMConfig, batch: int, total: int, dtype,
                  device, tp: int = 1) -> KVCache:
    """Per-layer {"k", "v"} of [B, T, KV, D] in the compute dtype, or, when
    cfg.kv_cache_dtype is 'int8', int8 {"k", "v"} plus f32 {"k_scale",
    "v_scale"} of [B, T, KV] (JAX make_kv_cache). tp: the tensor-parallel
    degree of the LLM, whose rank holds KV / tp heads."""
    shape = (batch, total, cfg.num_kv_heads // tp, cfg.head_dim_)
    int8 = cfg.kv_cache_dtype == "int8"

    def entry():
        e = {k: torch.zeros(shape, dtype=torch.int8 if int8 else dtype,
                            device=device) for k in ("k", "v")}
        if int8:
            e.update({k: torch.zeros(shape[:3], dtype=torch.float32,
                                     device=device)
                      for k in ("k_scale", "v_scale")})
        return e

    return [entry() for _ in range(cfg.num_layers)]


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, S, KV, D] -> (int8 values, f32 per-(token, head) scales
    [B, S, KV]): amax / 127 floored at 1e-8, round half-to-even, clip
    +-127 (JAX _quantize_kv)."""
    x32 = x.float()
    scale = (x32.abs().amax(dim=-1) / 127.0).clamp_min(1e-8)
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def cache_append(entry, k, v, cache_index) -> None:
    """Write k/v [B, S, KV, D] at cache_index IN PLACE (the JAX version
    returns an updated copy; writing in place saves a cache-sized copy
    per layer and step), quantized first when the cache is int8.
    cache_index: an int shared by all rows, or a [B] tensor of per-row
    offsets (the design-query extension, the slot pool); per-row writes
    past the cache's end are dropped, as JAX's mode="drop" drops them
    (a finished slot's offset can reach it)."""
    vals = {"k": k, "v": v}
    if entry["k"].dtype == torch.int8:
        vals["k"], vals["k_scale"] = quantize_kv(k)
        vals["v"], vals["v_scale"] = quantize_kv(v)
    if isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1:
        b, s = k.shape[:2]
        t = entry["k"].shape[1]
        rows = torch.arange(b, device=k.device)[:, None].expand(b, s)
        cols = cache_index[:, None] + torch.arange(s, device=k.device)[None]
        keep = cols < t
        if s > 1:    # the extension's write: a mask (and a host sync)
            rows, cols = rows[keep], cols[keep]
            for name, val in vals.items():
                entry[name][rows, cols] = val[keep].to(entry[name].dtype)
            return
        # one column a row (a decode step, no sync): a row past the end
        # writes its last slot's own contents back
        cols = cols.clamp_max(t - 1)
        for name, val in vals.items():
            buf = entry[name]
            old = buf[rows, cols]
            mask = keep.view(b, 1, *[1] * (old.dim() - 2))
            buf[rows, cols] = torch.where(mask, val.to(buf.dtype), old)
    else:
        i = int(cache_index)
        s = k.shape[1]
        for name, val in vals.items():
            entry[name][:, i:i + s] = val


def cache_read(entry, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """k, v in `dtype`; an int8 cache is dequantized (values and scales
    cast to `dtype`, then multiplied: JAX _cache_read)."""
    if entry["k"].dtype == torch.int8:
        return tuple(entry[n].to(dtype) * entry[f"{n}_scale"][..., None]
                     .to(dtype) for n in ("k", "v"))
    return entry["k"].to(dtype), entry["v"].to(dtype)


# ---------------------------------------------------------------------------
# the sparse MoE MLP
# ---------------------------------------------------------------------------

class Experts(nn.Module):
    """E SwiGLU experts, each leaf [E, in, out] as the JAX package stores
    them (gate, up [E, H, I]; down [E, I, H])."""

    def __init__(self, cfg: LLMConfig, dtype, device):
        super().__init__()
        e, h, inter = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size

        def leaf(*shape):
            return nn.Parameter(torch.empty(*shape, dtype=dtype,
                                            device=device))

        self.gate = leaf(e, h, inter)
        self.up = leaf(e, h, inter)
        self.down = leaf(e, inter, h)


@dataclass
class MoEMesh:
    """An MoE layer's place on a mesh (parallel/sharding.py shard_llm):
    the data group (dcn x dp) its routing spans and the ep group its
    experts split over (this rank computes experts [ep_rank E/ep,
    (ep_rank + 1) E/ep)). split_rows: the data ranks hold consecutive
    equal blocks of the batch's rows (False: every rank holds all of
    them; GraphLM.loss sets it from the batch's row shard)."""
    data_group: Any
    data: int
    data_rank: int
    ep_group: Any
    ep: int
    ep_rank: int
    split_rows: bool = True


class MoEMLP(nn.Module):
    """Mixtral's block: the router ([E, H], no bias, never adapted nor
    quantized) and the experts. drop_count: set it to a scalar tensor and
    each forward adds the valid (token, slot) units it dropped for
    capacity, on the device (no sync). mesh: its MoEMesh on a mesh."""

    def __init__(self, cfg: LLMConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.router = nn.Linear(cfg.hidden_size, cfg.num_experts,
                                bias=False, dtype=dtype, device=device)
        self.experts = Experts(cfg, dtype, device)
        self.drop_count: Optional[torch.Tensor] = None
        self.mesh: Optional[MoEMesh] = None

    def forward(self, x, token_valid=None):
        y, aux, dropped = moe_mlp(self, x, self.cfg, token_valid)
        if self.drop_count is not None:
            self.drop_count += dropped
        return y, aux


def moe_dispatch(top_idx: torch.Tensor, valid: torch.Tensor, num_experts: int,
                 capacity_factor: float, before: Optional[torch.Tensor] = None,
                 units_total: Optional[int] = None,
                 experts: Optional[Tuple[int, int]] = None):
    """The static-capacity assignment of JAX _moe_mlp. top_idx [T, k]
    expert per (token, slot) unit, valid [T] f32 (1 = a real token).
    Units sort stably by expert id (invalid units to a virtual expert E
    past every real one), so an expert's units keep their arrival order
    and the first C = max(ceil(factor * U / E), 1) of them are kept, U =
    T*k. On a mesh these T rows are one data rank's block of the batch:
    units_total is the whole batch's U, and before [E] the valid units of
    each expert on the earlier blocks, which come first in the arrival
    order (JAX's one stable sort over the concatenated batch keeps the
    same units). experts (first, count): the experts whose buffer rows
    this rank holds (all of them by default). Returns (order [U] the
    sort, slot [U] each sorted unit's row of the [count*C (+1 junk)]
    buffer, the junk row for a unit dropped or of another rank's expert,
    keep [U] sorted units kept, C)."""
    t, k = top_idx.shape
    units = t * k
    cap = max(int(math.ceil(capacity_factor * (units_total or units)
                            / num_experts)), 1)
    unit_valid = (valid[:, None] > 0).expand(t, k).reshape(units)
    sort_key = torch.where(unit_valid, top_idx.reshape(units), num_experts)
    order = torch.argsort(sort_key, stable=True)
    sorted_e = sort_key[order]
    counts = torch.zeros(num_experts + 1, dtype=torch.long,
                         device=top_idx.device).scatter_add_(
        0, sort_key, torch.ones_like(sort_key))   # bincount syncs on CUDA
    starts = torch.cumsum(counts, 0) - counts
    if before is not None:
        starts = starts - torch.cat([before, before.new_zeros(1)])
    rank = torch.arange(units, device=top_idx.device) - starts[sorted_e]
    keep = (rank < cap) & (sorted_e < num_experts)
    first, count = experts or (0, num_experts)
    mine = keep & (sorted_e >= first) & (sorted_e < first + count)
    slot = torch.where(mine, (sorted_e - first) * cap + rank.clamp(0, cap - 1),
                       count * cap)
    return order, slot, keep, cap


def expert_counts(top_idx: torch.Tensor, valid: torch.Tensor,
                  num_experts: int) -> torch.Tensor:
    """[E] valid units routed to each expert."""
    unit_valid = (valid[:, None] > 0).expand_as(top_idx)
    return torch.zeros(num_experts, dtype=torch.long,
                       device=top_idx.device).scatter_add_(
        0, top_idx[unit_valid], torch.ones_like(top_idx[unit_valid]))


def moe_mlp(mlp: MoEMLP, x: torch.Tensor, cfg: LLMConfig, token_valid=None):
    """Sparse-MoE SwiGLU with static-capacity dispatch (JAX _moe_mlp):
    returns (y [B, S, H], aux, dropped units). The router runs in the
    model dtype and its softmax in f32; top-k weights are renormalised;
    units over an expert's capacity drop with weight 0 (moe_dispatch);
    token_valid [B*S] keeps pad tokens from taking capacity or counting
    in the aux loss, HF's magnitude (about top_k at uniform routing):
        aux = E * sum_e (sum_slots mean_valid mask_e) * mean_valid P_e.
    Dispatch and combine go through an [E*C + 1, H] buffer (the last row
    takes the dropped units and is never read); the products over the
    experts are batched matmuls.

    On a mesh (mlp.mesh) it keeps JAX's global semantics over the data
    ranks' blocks of the batch: C from the whole batch's units, each
    unit's place in its expert after the earlier blocks' units (their
    per-expert counts all-gathered), the aux loss from the means over
    the whole batch (its sums all-reduced, differentiably) and returned
    as this rank's share 1/data (the ranks' losses sum to the loss), and
    dropped counting the whole batch's units. Each ep rank computes its
    E/ep experts: the tokens reach them through to_tp and their outputs
    are summed over ep by from_tp before the routing weights multiply
    them, so the router's gradient is whole on every rank."""
    b, s, h = x.shape
    t = b * s
    k, e = cfg.num_experts_per_tok, cfg.num_experts
    mesh = mlp.mesh
    split = mesh is not None and mesh.split_rows
    xf = x.reshape(t, h)
    probs = torch.softmax(F.linear(xf, mlp.router.weight).float(), dim=-1)
    top_vals, top_idx = torch.topk(probs, k, dim=-1)
    weights = top_vals / top_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    valid = (torch.ones(t, device=x.device) if token_valid is None
             else token_valid.reshape(t).float())
    sel = F.one_hot(top_idx, e).float() * valid[:, None, None]
    sums = torch.cat([sel.sum(dim=(0, 1)), (probs * valid[:, None]).sum(0),
                      valid.sum()[None]])
    before = units_total = None
    if split:
        from ...parallel.comm import all_reduce_sum, gather_counts
        sums = all_reduce_sum(sums, mesh.data_group)
        counts = gather_counts(expert_counts(top_idx, valid, e),
                               mesh.data_rank, mesh.data, mesh.data_group)
        before = counts[:mesh.data_rank].sum(0)
        units_total = t * k * mesh.data
    n_valid = sums[-1].clamp_min(1.0)
    aux = e * ((sums[:e] / n_valid) * (sums[e:2 * e] / n_valid)).sum()
    if mesh is not None and mesh.data > 1:
        aux = aux / mesh.data

    ep = mesh.ep if mesh is not None else 1
    per = e // ep
    first = mesh.ep_rank * per if ep > 1 else 0
    order, slot, keep, cap = moe_dispatch(top_idx, valid, e,
                                          cfg.moe_capacity_factor, before,
                                          units_total, (first, per))
    if ep > 1:
        from ...parallel.comm import from_tp, to_tp
        xf = to_tp(xf, mesh.ep_group)
    from ...parallel.sharding import local
    xu = xf.repeat_interleave(k, dim=0)                      # [U, H]
    buf = x.new_zeros(per * cap + 1, h).index_put((slot,), xu[order])
    xe = buf[:per * cap].view(per, cap, h)
    ex = mlp.experts
    hidden = (F.silu(torch.bmm(xe, local(ex.gate)))
              * torch.bmm(xe, local(ex.up)))
    de = torch.bmm(hidden, local(ex.down)).reshape(per * cap, h)
    de = torch.cat([de, de.new_zeros(1, h)], dim=0)
    yu_sorted = torch.where((slot < per * cap)[:, None], de[slot],
                            0.0).to(x.dtype)
    yu = torch.empty_like(yu_sorted).index_put((order,), yu_sorted)
    if ep > 1:
        yu = from_tp(yu, mesh.ep_group)
    y = (yu * weights.reshape(-1, 1).to(x.dtype)).view(t, k, h).sum(dim=1)
    dropped = (valid > 0).sum() * k - keep.sum()
    if split:
        from ...parallel.comm import all_reduce_
        dropped = all_reduce_(dropped.clone(), mesh.data_group)
    return y.view(b, s, h), aux, dropped


def plain_sdpa(cfg: LLMConfig) -> bool:
    """Plain scaled-dot-product causal attention: no softcap, query scale
    or sliding window (JAX decoder_layer's plain_sdpa, which S²-attn and
    the flash route assume)."""
    return (cfg.attn_logit_softcap is None and cfg.query_scale is None
            and cfg.sliding_window is None)


def flash_ok(cfg: LLMConfig, s: int, device) -> bool:
    """A no-cache forward of length s takes the flash route (kernel E):
    JAX's `_flash_ok` and plain_sdpa, with "the platform is a TPU" read
    as "the tensors are on a CUDA device". The layer asks S²-attn first,
    as JAX does."""
    return (cfg.use_flash and torch.device(device).type == "cuda"
            and s >= cfg.flash_min_seq and s % 128 == 0
            and cfg.head_dim_ in (128, 256) and plain_sdpa(cfg))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: LLMConfig, dtype, device):
        super().__init__()
        hd, h = cfg.head_dim_, cfg.hidden_size
        self.cfg = cfg

        def norm(dim):
            return RMSNorm(dim, cfg.rms_norm_eps, dtype, device,
                           cfg.rms_norm_unit_offset)

        self.input_norm = norm(h)
        self.attn = nn.ModuleDict({
            "q": LoRALinear(h, cfg.num_heads * hd, cfg.attention_bias,
                            dtype, device),
            "k": LoRALinear(h, cfg.num_kv_heads * hd, cfg.attention_bias,
                            dtype, device),
            "v": LoRALinear(h, cfg.num_kv_heads * hd, cfg.attention_bias,
                            dtype, device),
            "o": LoRALinear(cfg.num_heads * hd, h, False, dtype, device),
        })
        if cfg.qk_norm:          # qwen3 / gemma-3: per-head q/k RMSNorm
            self.q_norm = norm(hd)
            self.k_norm = norm(hd)
        self.post_norm = norm(h)     # the pre-MLP norm
        if cfg.sandwich_norms:   # gemma-2/3: norms on both block outputs
            self.post_attn_norm = norm(h)
            self.post_mlp_norm = norm(h)
        self.moe = cfg.num_experts > 0
        if self.moe:
            self.mlp = MoEMLP(cfg, dtype, device)
        else:
            inter = cfg.intermediate_size
            self.mlp = nn.ModuleDict({
                "gate": LoRALinear(h, inter, False, dtype, device),
                "up": LoRALinear(h, inter, False, dtype, device),
                "down": LoRALinear(inter, h, False, dtype, device),
            })
        self.attn_scale = (cfg.query_scale ** -0.5
                           if cfg.query_scale is not None else None)

    def _s2_group(self, s: int, train: bool, cached: bool) -> int:
        """S²-attn's group size for this forward, 0 for full attention
        (JAX decoder_layer's gate)."""
        cfg = self.cfg
        groupsz = int(s * cfg.group_size_ratio)
        if (cfg.shift_attn and train and not cached and groupsz >= 2
                and s % groupsz == 0 and plain_sdpa(cfg)):
            return groupsz
        return 0

    def forward(self, x, positions, inv_freq, mask, attention_mask=None,
                cache_entry=None, cache_index=None, train=False):
        """Returns (x, the MoE aux loss; None for a dense MLP). train:
        a training forward (S²-attn may run)."""
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.head_dim_
        h = self.input_norm(x)
        # the heads this rank holds (all of them without tensor parallelism)
        q = self.attn["q"](h).reshape(b, s, -1, hd)
        k = self.attn["k"](h).reshape(b, s, -1, hd)
        v = self.attn["v"](h).reshape(b, s, -1, hd)
        if cfg.qk_norm:
            q = self.q_norm(q)
            k = self.k_norm(k)
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
        if cache_entry is not None:
            cache_append(cache_entry, k, v, cache_index)
            k, v = cache_read(cache_entry, x.dtype)
        group = self._s2_group(s, train, cache_entry is not None)
        if group:
            tp = self.attn["q"].tp
            attn = s2_attention(q, k, v, attention_mask, group,
                                0 if tp is None else tp.rank * q.shape[2],
                                cfg.num_heads)
        elif cache_entry is None and flash_ok(cfg, s, q.device):
            # under tp, q / k / v hold this rank's heads (GQA's ratio kept)
            attn = flash_attention(q, k, v, attention_mask)
        else:
            attn = attention(q, k, v, mask, self.attn_scale,
                             cfg.attn_logit_softcap)
        attn = self.attn["o"](attn)
        if cfg.sandwich_norms:
            attn = self.post_attn_norm(attn)
        x = x + attn
        h = self.post_norm(x)
        if self.moe:
            token_valid = (attention_mask.reshape(-1) > 0
                           if attention_mask is not None else None)
            out, aux = self.mlp(h, token_valid)
            return x + out, aux
        act = (F.gelu(self.mlp["gate"](h), approximate="tanh")
               if cfg.hidden_act == "gelu_tanh"
               else F.silu(self.mlp["gate"](h)))
        out = self.mlp["down"](act * self.mlp["up"](h))
        if cfg.sandwich_norms:
            out = self.post_mlp_norm(out)
        return x + out, None


class Embedding(nn.Embedding):
    """nn.Embedding; under tensor parallelism (`tp`, a vocab-sharded
    table: parallel/sharding.py) each rank looks up the ids of its rows,
    zero elsewhere, and the ranks' lookups are summed."""

    tp = None

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return super().forward(ids)
        from ...parallel.comm import from_tp
        from ...parallel.sharding import local
        w = local(self.weight)
        lo = self.tp.rank * w.shape[0]
        inside = (ids >= lo) & (ids < lo + w.shape[0])
        e = F.embedding((ids - lo).clamp(0, w.shape[0] - 1), w)
        return from_tp(e * inside[..., None].to(e.dtype), self.tp.group)


class LLM(nn.Module):
    """Parameters are uninitialised until `reset_parameters(generator)`,
    `load_state_dict` (weights.llm_state_dict) or, for a quantized LLM,
    `quantize.init_quantized_` fills them. quant=(scheme, group_size)
    (scheme 'int8', 'w8a8' or 'int4') builds the projections and the
    lm_head quantized, never allocating their dense weights;
    `quantize.quantize_llm_params` quantizes a dense LLM in place. Either
    way `self.quant` says what the projections hold (None: dense). An MoE
    LLM's router and experts stay in the compute dtype."""

    # generate's per-token decode on the card replays a CUDA graph
    # (_decode_graph); False keeps it eager. graph_replays counts replays.
    decode_graphs = True
    graph_replays = 0
    # tensor parallelism (parallel/sharding.py shard_llm): the vocab TP
    # role, whose logits are gathered over the tp ranks
    tp = None
    # an MoE LLM on a mesh: the MoEMesh its MoE layers share
    moe_mesh = None
    # ZeRO-3 of a tied head (parallel/sharding.py fsdp_llm): (dim, dp,
    # group) of the frozen embedding's dp chunks, gathered for the head
    tied_zero = None

    def __init__(self, cfg: LLMConfig, dtype=torch.bfloat16, device=None,
                 quant: Optional[Tuple[str, int]] = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.dtype = dtype
        h = cfg.hidden_size
        meta = torch.device("meta")   # allocate once, uninitialised, below
        self.embed = Embedding(cfg.vocab_size, h, dtype=dtype, device=meta)
        self.layers = nn.ModuleList(DecoderLayer(cfg, dtype, meta)
                                    for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(h, cfg.rms_norm_eps, dtype, meta,
                                  cfg.rms_norm_unit_offset)
        self.lm_head = (None if cfg.tie_word_embeddings
                        else LoRALinear(h, cfg.vocab_size, False, dtype,
                                        meta))
        self.quant = quant
        if quant is not None:
            for proj in projections(self):
                empty_quantized_(proj, *quant)
        self.to_empty(device=device or torch.device("cpu"))
        self._inv_freq = torch.tensor(rope_frequencies(cfg),
                                      dtype=torch.float32, device=self.device)
        local = rope_frequencies_local(cfg)
        self._inv_freq_local = (None if local is None else torch.tensor(
            local, dtype=torch.float32, device=self.device))
        # sqrt(hidden) rounded to the model dtype, as a Python number: a
        # tensor made on the card every forward would copy from the host
        self._embed_scale = (float(torch.tensor(h ** 0.5, dtype=dtype))
                             if cfg.scale_embeddings else None)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX init_params scheme: N(0, 1/in) projections, router and
        experts ([E, in, out]: 1/in of each leaf), N(0, 0.02) embeddings,
        norms at unit scale (stored as 0 under the unit offset), zero
        biases; drawn on the parameters' device (8B normals drawn on the
        CPU take minutes). A quantized LLM is drawn by
        quantize.init_quantized_ instead."""
        if self.quant is not None:
            raise ValueError(f"the LLM is quantized ({self.quant}): draw it "
                             "with quantize.init_quantized_")
        norm_value = 0.0 if self.cfg.rms_norm_unit_offset else 1.0
        for name, p in self.named_parameters():
            if "lora_" in name:
                continue
            if name.endswith("norm.weight"):
                p.fill_(norm_value)
            elif name.endswith("bias"):
                p.zero_()
            elif name == "embed.weight":
                _normal_(p, 0.02, generator)
            else:
                _normal_(p, p.shape[1] ** -0.5, generator)

    def add_lora(self, rank: int, scale: float) -> None:
        """Adapters on every projection (the JAX TARGET_ALL); an MoE LLM
        keeps the attention targets only (lora.lora_targets)."""
        targets = lora_targets(self.cfg)
        for layer in self.layers:
            for name in targets:
                group = layer.attn if name in layer.attn else layer.mlp
                group[name].add_lora(rank, scale)

    def reset_lora(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, LoRALinear) and m.lora_a is not None:
                m.reset_lora(generator)

    def adapter_disabled(self):
        """Run the base weights alone inside the block, on the calling
        thread only: the JAX package passes no `lora` tree there (the
        likert value scoring). A forward on another thread keeps the
        adapter."""
        return adapters_off(m for m in self.modules()
                            if isinstance(m, LoRALinear))

    def embed_tokens(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Token embeddings, times sqrt(hidden) rounded to the model dtype
        when cfg.scale_embeddings (gemma; JAX LLM.embed)."""
        e = self.embed(input_ids)
        return e if self._embed_scale is None else e * self._embed_scale

    def _masks(self, b, s, attention_mask, positions, kv_cache, cache_index,
               kv_valid, dev):
        """(global mask [B, S, T], sliding-window mask or None). Without a
        cache, queries attend causally to real keys and the window counts
        position distance; with one, to the valid cache slots at or before
        their own slot, and the window counts slot distance (left padding
        keeps slot and position distances equal for every real pair)."""
        cfg = self.cfg
        if kv_cache is None:
            causal = torch.ones((s, s), dtype=torch.bool, device=dev).tril()
            mask = causal[None] & (attention_mask[:, None, :] > 0)
            dist = positions[:, :, None] - positions[:, None, :]
        else:
            t_len = kv_cache[0]["k"].shape[1]
            key_ok = (kv_valid if kv_valid is not None
                      else torch.ones((b, t_len), dtype=torch.bool,
                                      device=dev))
            slots = torch.arange(t_len, device=dev)
            if isinstance(cache_index, torch.Tensor) and cache_index.dim():
                q_pos = cache_index[:, None] + torch.arange(s, device=dev)
                dist = q_pos[:, :, None] - slots[None, None, :]
                mask = key_ok[:, None, :] & (dist >= 0)
            else:
                q_pos = int(cache_index) + torch.arange(s, device=dev)
                dist = (q_pos[:, None] - slots[None, :])[None]
                mask = key_ok[:, None, :] & (dist >= 0)
        if cfg.sliding_window is None:
            return mask, None
        return mask, mask & (dist < cfg.sliding_window)

    def forward(self, input_ids=None, attention_mask=None, positions=None,
                kv_cache: Optional[KVCache] = None, cache_index=None,
                kv_valid=None, last_logits_only: bool = False,
                inputs_embeds: Optional[torch.Tensor] = None,
                return_moe_aux: bool = False, train: bool = False):
        """Returns (logits [B,S,V] f32, hidden [B,S,H], kv_cache) and, with
        return_moe_aux, the MoE aux loss summed over the layers and divided
        by the depth (HF's pooled magnitude; 0 for a dense LLM and on the
        cached path). input_ids [B,S], or inputs_embeds [B,S,H] (the
        multimodal splice, composite._splice_molecule_embeds;
        `embed_tokens(ids)` gives the plain token embeddings). With
        kv_cache, queries attend to the valid cache slots (kv_valid [B,T])
        at or before their own slot; the cache is written in place and
        returned. Sliding-window layers (cfg.is_global_layer) take the
        windowed mask and, on gemma-3, the local rope table. train: a
        training forward (GraphLM.loss), where cfg.shift_attn takes
        S²-attn."""
        x = (self.embed_tokens(input_ids) if inputs_embeds is None
             else inputs_embeds)
        b, s, _ = x.shape
        dev = x.device
        if attention_mask is None:
            attention_mask = torch.ones((b, s), dtype=torch.int32, device=dev)
        if positions is None:
            positions = (attention_mask.cumsum(-1) - 1).clamp_min(0)
        mask, mask_local = self._masks(b, s, attention_mask, positions,
                                       kv_cache, cache_index, kv_valid, dev)

        remat = (self.cfg.remat and kv_cache is None
                 and torch.is_grad_enabled())
        aux_total = 0.0
        for i, layer in enumerate(self.layers):
            local = not self.cfg.is_global_layer(i)
            layer_mask = mask_local if local and mask_local is not None \
                else mask
            freq = (self._inv_freq_local
                    if local and self._inv_freq_local is not None
                    else self._inv_freq)
            if remat:
                x, aux = checkpoint(layer, x, positions, freq, layer_mask,
                                    attention_mask, None, None, train,
                                    use_reentrant=False)
            else:
                x, aux = layer(x, positions, freq, layer_mask, attention_mask,
                               None if kv_cache is None else kv_cache[i],
                               cache_index, train)
            if kv_cache is None and aux is not None:
                aux_total = aux_total + aux
        logits, hidden = self.finalize_hidden(x, last_logits_only)
        if return_moe_aux:
            aux_total = torch.as_tensor(aux_total, dtype=torch.float32,
                                        device=dev)
            return (logits, hidden, kv_cache,
                    aux_total / max(self.cfg.num_layers, 1))
        return logits, hidden, kv_cache

    def finalize_hidden(self, x: torch.Tensor, last_only: bool = False):
        """Final RMSNorm + vocab head (+ gemma-2's final logit softcap) ->
        (logits f32, hidden)."""
        hidden = self.final_norm(x)
        head_in = hidden[:, -1:] if last_only else hidden
        if self.lm_head is not None:
            logits = self.lm_head(head_in)
        elif self.tp is None:
            logits = F.linear(head_in, self.embed.weight)
        else:
            from ...parallel.comm import gathered_linear, to_tp
            from ...parallel.sharding import local
            head_in = to_tp(head_in, self.tp.group)
            w = local(self.embed.weight)
            logits = (F.linear(head_in, w) if self.tied_zero is None
                      else gathered_linear(head_in, w, *self.tied_zero))
        if self.tp is not None:
            # the vocab-sharded logits, gathered once: every rank then
            # computes the same loss on the whole vocabulary
            from ...parallel.comm import gather_last
            logits = gather_last(logits, self.tp.group, self.tp.size,
                                 self.tp.rank)
        logits = logits.float()
        cap = self.cfg.final_logit_softcap
        if cap is not None:
            logits = cap * torch.tanh(logits / cap)
        return logits, hidden

    @torch.no_grad()
    def generate(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                 *, generator: Optional[torch.Generator] = None,
                 max_new_tokens: int = 128, temperature: float = 0.6,
                 top_p: float = 0.9, top_k: int = 0, do_sample: bool = True,
                 eos_ids: Sequence[int] = (), pad_id: int = 0,
                 repetition_penalty: float = 1.0,
                 return_trigger: bool = False,
                 spec_tokens: Optional[int] = None, spec_ngram: int = 2,
                 spec_probe: int = 8, spec_min_accept: float = 0.5,
                 return_spec_iters: bool = False,
                 return_decode_state: bool = False,
                 reserve_cache_slots: int = 0,
                 inputs_embeds: Optional[torch.Tensor] = None,
                 rows: Optional[Tuple[torch.Tensor, int]] = None,
                 group=None):
        """Returns (new_tokens [B, T] int64, done [B] bool), then, each when
        asked: trigger [B] (the stop token that fired, -1 if none), the
        iterations run (speculative verify steps, or per-token steps) and
        the decode state {"cache", "kv_valid"}, whose valid region per
        row is exactly prompt + emitted tokens (stop tokens are never
        written); the speculative path returns None there, as JAX does
        (callers re-forward). input_ids [B, P] are left-padded.
        reserve_cache_slots leaves zero slots after the decode region for
        a later query extension (composite._body_hidden_extend).
        inputs_embeds [B, P, H] replaces the prompt's token embeddings in
        the prefill; the repetition-penalty history then starts empty,
        as in the JAX package (the prompt ids are not read).

        spec_tokens: prompt-lookup drafts per verify step (K); None = the
        JAX auto rule, K=2 for greedy decode and 0 when sampling. Drafts
        stay off for sliding-window configs, a repetition penalty and
        max_new_tokens <= 1. spec_ngram (clipped to 1..4) is the n-gram
        matched; after spec_probe verify steps, a batch whose accepted
        drafts per live row and step fall below spec_min_accept
        finishes on the per-token loop. Greedy tokens, done and trigger
        equal the per-token loop's; sampled outputs follow its
        distribution (delta-draft rejection sampling).

        rows, group: a data-parallel rank's block of a batch (the dp legs
        of models/composite.py). rows = (idx [B], total): the batch rows
        these are (a pad row repeats the last, idx clamped), whose every
        draw is made for the whole batch of `total` rows and cut to idx,
        so each row gets the mesh-less call's noise. group: the dp group,
        over which every stop decision is taken (all rows stopped, the
        drafts' acceptance guard): the ranks decode in lockstep, as one
        program over the whole batch does, and their generators stay
        alike."""
        cfg = self.cfg
        dev = input_ids.device
        b, p = input_ids.shape
        if spec_tokens is None:
            spec_tokens = 0 if do_sample else 2
        # the speculative cache has holes where drafts were rejected, so
        # slot distance is not position distance: windows need drafts off
        use_spec = (spec_tokens > 0 and max_new_tokens > 1
                    and repetition_penalty == 1.0
                    and cfg.sliding_window is None)
        total = (p + max_new_tokens * ((spec_tokens + 1) if use_spec else 1)
                 + reserve_cache_slots)
        use_rep = repetition_penalty != 1.0
        every_row = torch.arange(b, device=dev)
        seen = None

        def pick(step_logits):
            if use_rep:
                step_logits = apply_repetition_penalty(
                    step_logits, seen, repetition_penalty)
            tok = sample_token(generator, step_logits, temperature, top_p,
                               top_k, do_sample, rows)
            if use_rep:
                seen[every_row, tok] = True
            return tok

        def all_stopped(done) -> bool:
            # the host's read of the stop flag: it waits for the step
            profiling.count("llm.stop_reads")
            with profiling.span("llm.stop_wait"):
                return everywhere(done.all(), group)

        profiling.count("llm.generate_calls")
        with profiling.span("llm.prefill", dev):
            eos = torch.tensor(list(eos_ids) or [-1], device=dev)
            positions = (attention_mask.cumsum(-1) - 1).clamp_min(0)
            cache = make_kv_cache(cfg, b, total, self.dtype, dev,
                                  self.tp.size if self.tp is not None else 1)
            kv_valid = torch.cat([attention_mask > 0,
                                  torch.zeros((b, total - p),
                                              dtype=torch.bool, device=dev)],
                                 dim=1)
            logits, _, cache = self(input_ids=input_ids,
                                    attention_mask=attention_mask,
                                    positions=positions, kv_cache=cache,
                                    cache_index=0, kv_valid=kv_valid,
                                    last_logits_only=True,
                                    inputs_embeds=inputs_embeds)
            if use_rep:
                seen = torch.zeros((b, cfg.vocab_size), dtype=torch.bool,
                                   device=dev)
                if inputs_embeds is None:
                    r, c = torch.nonzero(attention_mask > 0, as_tuple=True)
                    seen[r, input_ids[r, c]] = True
            tok = pick(logits[:, -1])
            done = torch.isin(tok, eos)
            trigger = torch.where(done, tok, -1)
            tok = torch.where(done, pad_id, tok)
            pos = positions[:, -1] + 1
            finished = not use_spec and all_stopped(done)
        sampling = dict(temperature=temperature, top_p=top_p, top_k=top_k,
                        do_sample=do_sample)

        if use_spec:
            out, done, trigger, iters = self._speculative_loop(
                cache, kv_valid, tok, pos, done, trigger, generator,
                input_ids, attention_mask, p=p, rows=rows, group=group,
                max_new_tokens=max_new_tokens, K=spec_tokens,
                ngram=max(1, min(spec_ngram, 4)), eos=eos, pad_id=pad_id,
                probe_iters=spec_probe, min_accept=spec_min_accept,
                **sampling)
            state = None         # the cache has rejected-draft holes
        else:
            out = torch.full((b, max_new_tokens), pad_id, dtype=torch.long,
                             device=dev)
            iters = 0
            graphed = (self._decode_graph(cache, kv_valid, tok, pos)
                       if self._graphs_apply(dev) else None)
            # each step ends on the host's read of the stop flag (the
            # early exit: finished rows would only emit pad); the first
            # step of a call runs eagerly and captures the graph
            for t in range(0 if finished else max_new_tokens):
                profiling.count("llm.decode_steps")
                with profiling.span("llm.step" if t else "llm.first_step"):
                    with profiling.span("llm.forward", dev):
                        out[:, t] = tok
                        kv_valid[:, p + t] = ~done
                        if graphed is None:
                            logits, _, cache = self(input_ids=tok[:, None],
                                                    positions=pos[:, None],
                                                    kv_cache=cache,
                                                    cache_index=p + t,
                                                    kv_valid=kv_valid)
                            last = logits[:, -1]
                        else:
                            last = graphed(tok, pos, p + t)
                    with profiling.span("llm.pick", dev):
                        nxt = pick(last)
                        stopped = ~done & torch.isin(nxt, eos)
                        trigger = torch.where(stopped, nxt, trigger)
                        done = done | stopped
                        tok = torch.where(done, pad_id, nxt)
                        pos = pos + 1
                    iters += 1
                    if t + 1 < max_new_tokens and all_stopped(done):
                        break
            state = {"cache": cache, "kv_valid": kv_valid}
        res = (out, done)
        if return_trigger:
            res += (trigger,)
        if return_spec_iters:
            res += (iters,)
        if return_decode_state:
            res += (state,)
        return res

    def _graphs_apply(self, dev) -> bool:
        """Whether generate's per-token steps replay a CUDA graph: on the
        card unless decode_graphs is off, for a dense MLP (MoE routing
        sizes its dispatch on the host), no W8A8 projection (its
        int8_matmul counts calls on the host, once per capture there)
        and no tensor parallelism: a tp-sharded LLM (`tp`) decodes
        eagerly by design, its step's collectives are not recorded."""
        return (self.decode_graphs and dev.type == "cuda"
                and self.cfg.num_experts == 0 and self.tp is None
                and not any(m.quant == "w8a8" for m in projections(self)))

    def _decode_graph(self, cache, kv_valid, tok, pos):
        """generate's per-token forward recorded once as a CUDA graph:
        step(tok [B], pos [B], index) -> the last logits [B, V]. The
        first call runs the forward eagerly on a side stream (its result
        is that step's, and it warms the stream for capture), then
        records it; later calls copy their inputs into the graph's and
        replay it. The cache and kv_valid are read and written where
        they lie, so the loop's in-place updates of kv_valid reach the
        graph; the cache index goes in as a [B] tensor (every row writes
        slot `index`), whose writes and masks equal the int index's.
        The step's host cost (some hundred aten calls a layer) is what
        bounds an eager decode at small batch; a replay is one launch.
        LLM.graph_replays counts the replays."""
        dev = kv_valid.device
        tok_in, pos_in = tok[:, None].clone(), pos[:, None].clone()
        idx_in = torch.zeros(tok.shape[0], dtype=torch.long, device=dev)
        state = {}

        def forward():
            logits, _, _ = self(input_ids=tok_in, positions=pos_in,
                                kv_cache=cache, cache_index=idx_in,
                                kv_valid=kv_valid)
            return logits[:, -1]

        def step(tok, pos, index):
            tok_in.copy_(tok[:, None])
            pos_in.copy_(pos[:, None])
            idx_in.fill_(index)
            if "graph" in state:
                state["graph"].replay()
                LLM.graph_replays += 1
                return state["out"]
            profiling.count("llm.graph_captures")
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                first = forward()
            torch.cuda.current_stream(dev).wait_stream(side)
            first.record_stream(torch.cuda.current_stream(dev))
            graph = torch.cuda.CUDAGraph()
            # thread_local: another thread's work on the card (the
            # continuous server's design thread) may go on meanwhile
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                state["out"] = forward()
            state["graph"] = graph
            return first

        return step

    def _speculative_loop(self, cache, kv_valid, x0, pos0, done0, trigger0,
                          generator, input_ids, attention_mask, *, p: int,
                          rows, group,
                          max_new_tokens: int, K: int, ngram: int, eos,
                          pad_id: int, temperature: float, top_p: float,
                          top_k: int, do_sample: bool, probe_iters: int,
                          min_accept: float):
        """Prompt-lookup speculative decoding (JAX _speculative_loop).
        Each iteration proposes K drafts a row (ngram_drafts), verifies
        [x, d1..dK] in one cached forward at the shared slots
        [c, c + K], c = p + it * (K + 1), accepts the longest prefix by
        delta-draft rejection sampling, emits the accepted drafts and one
        sampled token, and marks the rejected slots invalid (holes, never
        compacted). The host reads one flag an iteration (every row
        stopped, or the acceptance guard tripped). Rows left when the
        guard trips finish on the per-token loop in the cache's remaining
        slots at one shared offset: every row still running has emitted at
        least one token an iteration, so it needs at most max_new - it
        more steps, and (max_new - it) * (K + 1) slots remain (JAX
        compacts its cache there instead: its vector ops scale with the
        cache's length). One difference from JAX: a row whose verify step
        fills its budget without reaching the token after its last one
        takes one forward of the continuation for that boundary token, so
        that done and trigger are the per-token loop's (JAX's leave them
        unset there). rows, group: generate's (the draws made for the
        whole batch, the stop flag and the guard's counts summed over the
        group). Returns (out [B, max_new], done, trigger, iterations);
        self.spec_stats keeps the verify steps, the drafts accepted over
        them, the live row-steps and whether the guard tripped (this
        rank's rows)."""
        dev = x0.device
        b = x0.shape[0]
        L = p + max_new_tokens          # history width (exact positions)
        arK1 = torch.arange(K + 1, device=dev)
        s_idx = arK1[None, :]
        bidx = torch.arange(b, device=dev)[:, None]
        greedy = not do_sample or temperature <= 0

        # token history: the left-padded prompt and the generated tail,
        # contiguous from column p; column L takes the masked writes
        hist = torch.zeros((b, L + 1), dtype=torch.long, device=dev)
        hist[:, :p] = input_ids
        hvalid = torch.zeros((b, L + 1), dtype=torch.bool, device=dev)
        hvalid[:, :p] = attention_mask > 0
        hist[:, p] = x0
        hvalid[:, p] = ~done0
        out = torch.full((b, max_new_tokens + 1), pad_id, dtype=torch.long,
                         device=dev)
        out[:, 0] = x0
        gen = torch.ones(b, dtype=torch.long, device=dev)
        x, pos_x, done, trigger = x0, pos0, done0, trigger0
        full = torch.zeros_like(done0)
        boundary = torch.zeros_like(done0)
        tot_acc = torch.zeros((), dtype=torch.long, device=dev)
        tot_live = torch.zeros((), dtype=torch.long, device=dev)
        it = 0
        while it < max_new_tokens:
            running, acc, steps = (~(done | full)).sum(), tot_acc, tot_live
            if group is not None:
                counts = torch.stack([running, acc, steps])
                torch.distributed.all_reduce(counts, group=group)
                running, acc, steps = counts
            stop = running == 0
            if it >= probe_iters:   # the acceptance guard
                stop = stop | (acc.float() < min_accept * steps.float())
            if bool(stop):
                break
            live = ~(done | full)
            drafts = ngram_drafts(hist, hvalid, gen, p, L, ngram, K)
            c = p + it * (K + 1)
            block = torch.cat([x[:, None], drafts], dim=1)
            kv_valid[:, c:c + K + 1] = live[:, None]
            logits, _, cache = self(input_ids=block,
                                    positions=pos_x[:, None] + s_idx,
                                    kv_cache=cache, cache_index=c,
                                    kv_valid=kv_valid)
            vals, idxs = warped_candidates(logits.reshape(b * (K + 1), -1),
                                           temperature, top_p, top_k,
                                           do_sample)
            kk = vals.shape[-1]
            vals = vals.view(b, K + 1, kk)
            if idxs is not None:
                idxs = idxs.view(b, K + 1, kk)
            if greedy:
                # p_warped(draft) is 1 for the argmax and 0 otherwise:
                # JAX's uniform() < p_draft accepts exactly the matches,
                # and both draws return the argmax
                accept = idxs[:, :K, 0] == drafts
                fresh = idxs[:, :, 0]
                resid = idxs[:, :K, 0]
            else:
                lse = torch.logsumexp(vals, dim=-1)            # [B, K+1]
                if idxs is None:
                    dvals = torch.gather(vals[:, :K], 2,
                                         drafts[:, :, None])[..., 0]
                    p_draft = torch.exp(dvals - lse[:, :K])
                    excluded = (torch.arange(kk, device=dev)[None, None]
                                == drafts[:, :, None])
                else:
                    excluded = idxs[:, :K] == drafts[:, :, None]
                    p_draft = torch.where(
                        excluded, torch.exp(vals[:, :K] - lse[:, :K, None]),
                        0.0).sum(-1)
                u = uniform_draw(generator, (b, K), dev, rows)
                accept = u < p_draft
                fresh = candidates_draw(generator, vals, idxs,
                                        rows)  # [B, K+1]
                resid = candidates_draw(
                    generator, torch.where(excluded, _NEG, vals[:, :K]),
                    None if idxs is None else idxs[:, :K], rows)
            n_acc = torch.cumprod(accept.long(), dim=1).sum(dim=1)
            # the token at slot n_acc: the residual resample where a draft
            # was rejected, a fresh draw after K accepted drafts
            x_sel = torch.cat([resid, fresh[:, K:]], dim=1)
            x_new = torch.gather(x_sel, 1, n_acc[:, None])[:, 0]

            # emission: the accepted drafts and the sampled token; a stop
            # token landing exactly on the budget boundary still sets
            # done / trigger (as the per-token loop's last step does)
            cand = torch.cat([drafts, x_new[:, None]], dim=1)
            tok = torch.where(s_idx < n_acc[:, None], cand, x_new[:, None])
            upto = (s_idx <= n_acc[:, None]) & live[:, None]
            base = upto & ((gen[:, None] + s_idx) < max_new_tokens)
            sig = upto & ((gen[:, None] + s_idx) <= max_new_tokens)
            is_eos = torch.isin(tok, eos)
            hit = (is_eos & sig).long()
            prior = torch.cumsum(hit, dim=1) - hit
            emit = base & (prior == 0)
            hit = (hit > 0) & (prior == 0)
            eos_row = hit.any(dim=1)
            first_eos = torch.gather(tok, 1,
                                     hit.long().argmax(dim=1)[:, None])[:, 0]
            trigger = torch.where(eos_row, first_eos, trigger)
            col_o = torch.where(emit, gen[:, None] + s_idx, max_new_tokens)
            out[bidx, col_o] = torch.where(is_eos, pad_id, tok)
            col_h = torch.where(emit, p + gen[:, None] + s_idx, L)
            hist[bidx, col_h] = tok
            hvalid[bidx, col_h] = emit

            n_emit = emit.sum(dim=1)
            # a row that fills its budget with x_new has not seen the
            # token after it, which the per-token loop checks for a stop:
            # it keeps x_new for one forward of the continuation (JAX
            # retires it, leaving done / trigger unset)
            unchecked = live & ~eos_row & (n_acc < max_new_tokens - gen)
            gen = gen + n_emit
            done = done | eos_row     # a stop token fired
            filled = gen >= max_new_tokens
            boundary = boundary | (unchecked & filled)
            full = full | filled
            # slot validity from here on: x and the accepted drafts stay,
            # the rejected drafts are holes
            kv_valid[:, c] = live
            kv_valid[:, c + 1:c + K + 1] = live[:, None] & (
                arK1[None, :K] < n_acc[:, None])
            pos_x = pos_x + n_emit
            x = torch.where(done | (full & ~boundary), pad_id, x_new)
            tot_acc = tot_acc + torch.where(live, n_acc, 0).sum()
            tot_live = tot_live + live.sum()
            it += 1

        # what the drafts did, for whoever measures them (chip_smoke.py)
        self.spec_stats = {"iterations": it, "accepted": int(tot_acc),
                           "live_steps": int(tot_live),
                           "guard_tripped": bool((~(done | full)).any())}
        # the guard's continuation: the per-token loop for the rows left.
        # A row that fills its budget (here, or in a verify step that did
        # not reach the next token) runs one more forward so that the
        # never-emitted boundary token still sets done / trigger.
        c0 = p + it * (K + 1)
        every_row = bidx[:, 0]
        fin = full & ~boundary
        for j in range(max_new_tokens + 1):
            live = ~(done | fin)
            if everywhere(~live.any(), group):
                break
            at_boundary = gen >= max_new_tokens
            kv_valid[:, c0 + j] = live
            logits, _, cache = self(input_ids=x[:, None],
                                    positions=pos_x[:, None], kv_cache=cache,
                                    cache_index=c0 + j, kv_valid=kv_valid)
            nxt = sample_token(generator, logits[:, -1], temperature, top_p,
                               top_k, do_sample, rows)
            stopped = live & torch.isin(nxt, eos)
            trigger = torch.where(stopped, nxt, trigger)
            emit = live & ~stopped & ~at_boundary
            col = torch.where(emit, gen, max_new_tokens)
            out[every_row, col] = torch.where(emit, nxt, pad_id)
            gen = gen + emit.long()
            done = done | stopped
            fin = fin | (live & at_boundary)
            pos_x = pos_x + live.long()
            x = torch.where(done | fin, pad_id, nxt)
        return out[:, :max_new_tokens], done, trigger, it


def ngram_drafts(hist: torch.Tensor, hvalid: torch.Tensor, gen: torch.Tensor,
                 p: int, L: int, ngram: int, K: int) -> torch.Tensor:
    """K draft tokens a row (JAX LLM._ngram_drafts): the continuation after
    the most recent earlier occurrence of the trailing `ngram` tokens in
    the history. hist / hvalid [B, L + 1] (column L is junk); gen [B] the
    tokens generated so far (the tail ends at column p + gen - 1). A row
    without a match gets whatever its low columns hold: the verify step
    runs K + 1 positions regardless, and the drafts are then rejected."""
    b = hist.shape[0]
    dev = hist.device
    tail = p + gen[:, None] - ngram + torch.arange(ngram, device=dev)[None]
    gram = torch.gather(hist, 1, tail.clamp(0, L))
    w = L - ngram + 1
    m = torch.ones((b, w), dtype=torch.bool, device=dev)
    for s in range(ngram):
        m &= (hist[:, s:w + s] == gram[:, s:s + 1]) & hvalid[:, s:w + s]
    jpos = torch.arange(w, device=dev)
    # the tail always matches itself: the match must end before it does
    m &= (jpos[None, :] + ngram) < (p + gen)[:, None]
    j_star = torch.where(m, jpos[None, :], -1).amax(dim=1)
    cols = (j_star[:, None] + ngram
            + torch.arange(K, device=dev)[None]).clamp(0, L)
    return torch.gather(hist, 1, cols)


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            ignore_index: int = -100, count=None) -> torch.Tensor:
    """Shifted causal-LM CE: the mean over the label positions that are
    not ignore_index (0 when there is none). count: a function of the
    local count giving the normaliser (data parallelism: the count over
    every rank's rows)."""
    shift_labels = labels[:, 1:].long()
    mask = shift_labels != ignore_index
    nll = F.cross_entropy(logits[:, :-1].float().reshape(-1, logits.shape[-1]),
                          shift_labels.reshape(-1),
                          ignore_index=ignore_index, reduction="sum")
    n = mask.sum()
    return nll / (n if count is None else count(n)).clamp_min(1)


def _normal_(p: torch.Tensor, std: float, generator) -> None:
    """N(0, std) drawn in f32 then cast, like the JAX init."""
    if p.dtype == torch.float32:
        p.normal_(0.0, std, generator=generator)
    else:
        p.copy_(torch.empty(p.shape, dtype=torch.float32, device=p.device)
                .normal_(0.0, std, generator=generator))


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def apply_repetition_penalty(logits, seen_mask, penalty: float):
    """HF semantics: seen tokens' scores divide (if > 0) or multiply
    (if < 0) by the penalty."""
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen_mask, penalized, logits)


def warped_candidates(logits, temperature: float, top_p: float, top_k: int,
                      do_sample: bool):
    """The warped sampling distribution as a bounded candidate set,
    without a full-vocab sort (JAX _warped_candidates).

    Returns (vals, idxs): warped logits over candidates (filtered
    entries at -1e30) and their vocab ids, or idxs=None when vals covers
    the full vocab. top-p alone keeps at most 256 candidates, and its
    cumulative mass uses the FULL distribution's logsumexp, so the kept
    set is exact whenever the nucleus fits the cap."""
    logits = torch.nan_to_num(logits.float(), nan=0.0, posinf=1e30,
                              neginf=-1e30)
    if not do_sample or temperature <= 0:
        idx = torch.argmax(logits, dim=-1, keepdim=True)
        return torch.zeros_like(idx, dtype=torch.float32), idx
    logits = logits / max(temperature, 1e-5)
    vocab = logits.shape[-1]
    use_top_k = bool(top_k) and 0 < top_k < vocab
    use_top_p = bool(top_p) and top_p < 1.0
    if not (use_top_k or use_top_p):
        return logits, None
    kk = min(top_k if use_top_k else _TOP_P_CANDIDATES, vocab)
    vals, idxs = torch.topk(logits, kk, dim=-1)        # descending
    if use_top_p:
        # HF order: top-k filters first, top-p then measures mass on the
        # renormalized top-k distribution; pure top-p uses the full one
        lse = torch.logsumexp(vals if use_top_k else logits, dim=-1,
                              keepdim=True)
        probs = torch.exp(vals - lse)
        cum = torch.cumsum(probs, dim=-1)
        keep = (cum - probs) < top_p   # smallest set reaching top_p
        keep[:, 0] = True
        vals = torch.where(keep, vals, _NEG)
    return vals, idxs


def everywhere(flag: torch.Tensor, group=None) -> bool:
    """Whether a stop flag holds on every rank of the group (as it is
    without one): the dp ranks of a batch stop together."""
    if group is None:
        return bool(flag)
    flag = flag.to(torch.int32).reshape(1)
    torch.distributed.all_reduce(flag, torch.distributed.ReduceOp.MIN,
                                 group=group)
    return bool(flag)


def _whole_batch(x: torch.Tensor, rows, fill: float) -> torch.Tensor:
    """A rank's rows [B, ...] of a batch placed at their rows of the
    whole one [total, ...] (rows = (idx, total); the other rows `fill`;
    of repeated indices, the first row's)."""
    idx, total = rows
    first = torch.ones_like(idx, dtype=torch.bool)
    first[1:] = idx[1:] != idx[:-1]
    whole = x.new_full((total,) + tuple(x.shape[1:]), fill)
    whole[idx[first]] = x[first]
    return whole


def uniform_draw(generator, shape, device, rows=None) -> torch.Tensor:
    """U(0, 1) of the given shape; with rows, the rows of the whole
    batch's draw."""
    if rows is None:
        return torch.rand(shape, generator=generator, device=device)
    idx, total = rows
    return torch.rand((total,) + tuple(shape[1:]), generator=generator,
                      device=device)[idx]


def candidates_draw(generator, vals, idxs, rows=None) -> torch.Tensor:
    """A vocab id drawn from each row of a (vals, idxs) candidate set
    ([B, ..., kk]; idxs None: vals covers the vocabulary) -> [B, ...].
    rows (generate's): the draw is the whole batch's, its rows cut out
    (torch.multinomial draws each row of its input from that row's noise
    alone)."""
    lead, kk = vals.shape[:-1], vals.shape[-1]
    probs = torch.softmax(vals.reshape(-1, kk), dim=-1)
    if rows is not None:
        probs = _whole_batch(probs.view(lead + (kk,)), rows, 1.0 / kk)
        probs = probs.reshape(-1, kk)
    choice = torch.multinomial(probs, 1, generator=generator)
    if rows is not None:
        choice = choice.view((rows[1],) + tuple(lead[1:]))[rows[0]]
        choice = choice.reshape(-1, 1)
    if idxs is not None:
        choice = torch.gather(idxs.reshape(-1, idxs.shape[-1]), 1, choice)
    return choice[:, 0].view(lead)


def sample_token(generator, logits, temperature: float, top_p: float,
                 top_k: int, do_sample: bool, rows=None) -> torch.Tensor:
    """One token per row: greedy, or a draw from the warped candidates
    (rows: candidates_draw's)."""
    vals, idxs = warped_candidates(logits, temperature, top_p, top_k,
                                   do_sample)
    if not do_sample or temperature <= 0:
        return idxs[:, 0]
    return candidates_draw(generator, vals, idxs, rows)
