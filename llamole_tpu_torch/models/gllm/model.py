"""Decoder-only LLM (llama / qwen2 / mistral families) in PyTorch
(counterpart of llamole_tpu/models/gllm/model.py).

RMSNorm + RoPE (incl. llama3.1 scaling) + GQA + SwiGLU, an optional LoRA
overlay on every projection, a preallocated KV cache written in place,
and `generate`: prefill, then a per-token decode loop that exits once
every row has stopped, with temperature / top-k / top-p sampling over a
bounded candidate set and repetition penalty. Matmuls run in the
parameters' dtype; norms, rope, attention logits and softmax in f32.

Not ported yet (each raises, each is listed in ROADMAP.md): speculative
decoding (spec_tokens > 0; greedy output is identical without it), the
int8 KV cache, quantized weights, MoE, sliding-window, logit softcap,
qk-norm and the other gemma-family knobs.
"""

import contextlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .config import LLMConfig
from .lora import LoRALinear

_NEG = -1e30
_TOP_P_CANDIDATES = 256  # top-p nucleus cap; see _warped_candidates


def check_supported(cfg: LLMConfig) -> None:
    """Refuse the config features the port does not run yet."""
    unsupported = {
        "kv_cache_dtype='int8'": cfg.kv_cache_dtype != "compute",
        "MoE (num_experts > 0)": cfg.num_experts > 0,
        "sliding-window attention": cfg.sliding_window is not None,
        "logit softcap": (cfg.attn_logit_softcap is not None
                          or cfg.final_logit_softcap is not None),
        "qk-norm": cfg.qk_norm,
        "gemma-family knobs": (cfg.hidden_act != "silu" or cfg.sandwich_norms
                               or cfg.rms_norm_unit_offset
                               or cfg.scale_embeddings
                               or cfg.query_scale is not None
                               or cfg.rope_local_base_freq is not None),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"llamole_tpu_torch LLM does not support {', '.join(bad)} yet "
            "(ROADMAP.md, 'still to port')")


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype, device):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.empty(dim, dtype=dtype,
                                               device=device))

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


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


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, Dh]; positions [B, S]; inv_freq [Dh/2] f32."""
    angles = positions.float()[..., None] * inv_freq[None, None, :]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def attention(q, k, v, mask_bst):
    """GQA attention. q [B,S,H,D], k/v [B,T,KV,D], mask [B,S,T] bool.
    Logits in f32 (inputs upcast), masked to -1e30, probs cast to v's
    dtype before the value product."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    q = q.reshape(b, s, kv, h // kv, d)
    logits = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float())
    logits = logits * (1.0 / math.sqrt(d))
    logits = torch.where(mask_bst[:, None, None], logits, _NEG)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h * d)


KVCache = List[Dict[str, torch.Tensor]]


def make_kv_cache(cfg: LLMConfig, batch: int, total: int, dtype,
                  device) -> KVCache:
    """Per-layer {"k", "v"} of [B, T, KV, D] in the compute dtype."""
    shape = (batch, total, cfg.num_kv_heads, cfg.head_dim_)
    return [{"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
            for _ in range(cfg.num_layers)]


def cache_append(entry, k, v, cache_index) -> None:
    """Write k/v [B, S, KV, D] at cache_index IN PLACE (the JAX version
    returns an updated copy; writing in place saves a cache-sized copy
    per layer and step). cache_index: an int shared by all rows, or a
    [B] tensor of per-row offsets (the design-query extension)."""
    if isinstance(cache_index, torch.Tensor) and cache_index.dim() == 1:
        b, s = k.shape[:2]
        rows = torch.arange(b, device=k.device)[:, None]
        cols = cache_index[:, None] + torch.arange(s, device=k.device)[None]
        entry["k"][rows, cols] = k.to(entry["k"].dtype)
        entry["v"][rows, cols] = v.to(entry["v"].dtype)
    else:
        i = int(cache_index)
        s = k.shape[1]
        entry["k"][:, i:i + s] = k
        entry["v"][:, i:i + s] = v


def cache_read(entry, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    return entry["k"].to(dtype), entry["v"].to(dtype)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: LLMConfig, dtype, device):
        super().__init__()
        hd, h = cfg.head_dim_, cfg.hidden_size
        self.cfg = cfg
        self.input_norm = RMSNorm(h, cfg.rms_norm_eps, dtype, device)
        self.attn = nn.ModuleDict({
            "q": LoRALinear(h, cfg.num_heads * hd, cfg.attention_bias,
                            dtype, device),
            "k": LoRALinear(h, cfg.num_kv_heads * hd, cfg.attention_bias,
                            dtype, device),
            "v": LoRALinear(h, cfg.num_kv_heads * hd, cfg.attention_bias,
                            dtype, device),
            "o": LoRALinear(cfg.num_heads * hd, h, False, dtype, device),
        })
        self.post_norm = RMSNorm(h, cfg.rms_norm_eps, dtype, device)
        inter = cfg.intermediate_size
        self.mlp = nn.ModuleDict({
            "gate": LoRALinear(h, inter, False, dtype, device),
            "up": LoRALinear(h, inter, False, dtype, device),
            "down": LoRALinear(inter, h, False, dtype, device),
        })

    def forward(self, x, positions, inv_freq, mask, cache_entry=None,
                cache_index=None):
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.head_dim_
        h = self.input_norm(x)
        q = self.attn["q"](h).reshape(b, s, cfg.num_heads, hd)
        k = self.attn["k"](h).reshape(b, s, cfg.num_kv_heads, hd)
        v = self.attn["v"](h).reshape(b, s, cfg.num_kv_heads, hd)
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
        if cache_entry is None:
            attn = attention(q, k, v, mask)
        else:
            cache_append(cache_entry, k, v, cache_index)
            ck, cv = cache_read(cache_entry, x.dtype)
            attn = attention(q, ck, cv, mask)
        x = x + self.attn["o"](attn)
        h = self.post_norm(x)
        gated = F.silu(self.mlp["gate"](h)) * self.mlp["up"](h)
        return x + self.mlp["down"](gated)


class LLM(nn.Module):
    """Parameters are uninitialised until `reset_parameters(generator)`
    or `load_state_dict` (weights.llm_state_dict) fills them."""

    def __init__(self, cfg: LLMConfig, dtype=torch.bfloat16, device=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.dtype = dtype
        h = cfg.hidden_size
        meta = torch.device("meta")   # allocate once, uninitialised, below
        self.embed = nn.Embedding(cfg.vocab_size, h, dtype=dtype,
                                  device=meta)
        self.layers = nn.ModuleList(DecoderLayer(cfg, dtype, meta)
                                    for _ in range(cfg.num_layers))
        self.final_norm = RMSNorm(h, cfg.rms_norm_eps, dtype, meta)
        self.lm_head = (None if cfg.tie_word_embeddings
                        else nn.Linear(h, cfg.vocab_size, bias=False,
                                       dtype=dtype, device=meta))
        self.to_empty(device=device or torch.device("cpu"))
        self._inv_freq = torch.tensor(rope_frequencies(cfg),
                                      dtype=torch.float32, device=self.device)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX init_params scheme: N(0, 1/in) projections, N(0, 0.02)
        embeddings, unit norms, zero biases; drawn on the parameters'
        device (8B normals drawn on the CPU take minutes)."""
        for name, p in self.named_parameters():
            if "lora_" in name:
                continue
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            elif name.endswith("bias"):
                p.zero_()
            elif name == "embed.weight":
                _normal_(p, 0.02, generator)
            else:
                _normal_(p, p.shape[1] ** -0.5, generator)

    def add_lora(self, rank: int, scale: float) -> None:
        """Adapters on every projection (the JAX TARGET_ALL)."""
        for layer in self.layers:
            for proj in (*layer.attn.values(), *layer.mlp.values()):
                proj.add_lora(rank, scale)

    def reset_lora(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, LoRALinear) and m.lora_a is not None:
                m.reset_lora(generator)

    @contextlib.contextmanager
    def adapter_disabled(self):
        """Run the base weights alone inside the block: the JAX package
        passes no `lora` tree there (the likert value scoring)."""
        mods = [m for m in self.modules() if isinstance(m, LoRALinear)]
        for m in mods:
            m.lora_enabled = False
        try:
            yield
        finally:
            for m in mods:
                m.lora_enabled = True

    def forward(self, input_ids=None, attention_mask=None, positions=None,
                kv_cache: Optional[KVCache] = None, cache_index=None,
                kv_valid=None, last_logits_only: bool = False,
                inputs_embeds: Optional[torch.Tensor] = None):
        """Returns (logits [B,S,V] f32, hidden [B,S,H], kv_cache).
        input_ids [B,S], or inputs_embeds [B,S,H] (the multimodal splice,
        composite._splice_molecule_embeds; `self.embed(ids)` gives the
        plain token embeddings). With kv_cache, queries attend to the
        valid cache slots (kv_valid [B,T]) at or before their own slot;
        the cache is written in place and returned."""
        x = self.embed(input_ids) if inputs_embeds is None else inputs_embeds
        b, s, _ = x.shape
        dev = x.device
        if attention_mask is None:
            attention_mask = torch.ones((b, s), dtype=torch.int32, device=dev)
        if positions is None:
            positions = (attention_mask.cumsum(-1) - 1).clamp_min(0)

        if kv_cache is None:
            causal = torch.ones((s, s), dtype=torch.bool, device=dev).tril()
            mask = causal[None] & (attention_mask[:, None, :] > 0)
        else:
            t_len = kv_cache[0]["k"].shape[1]
            key_ok = (kv_valid if kv_valid is not None
                      else torch.ones((b, t_len), dtype=torch.bool,
                                      device=dev))
            slots = torch.arange(t_len, device=dev)
            if isinstance(cache_index, torch.Tensor) and cache_index.dim():
                q_pos = cache_index[:, None] + torch.arange(s, device=dev)
                causal = slots[None, None, :] <= q_pos[:, :, None]
                mask = key_ok[:, None, :] & causal
            else:
                q_pos = int(cache_index) + torch.arange(s, device=dev)
                causal = slots[None, :] <= q_pos[:, None]
                mask = key_ok[:, None, :] & causal[None]

        for i, layer in enumerate(self.layers):
            x = layer(x, positions, self._inv_freq, mask,
                      None if kv_cache is None else kv_cache[i],
                      cache_index)
        hidden = self.final_norm(x)
        head_in = hidden[:, -1:] if last_logits_only else hidden
        if self.lm_head is None:
            logits = F.linear(head_in, self.embed.weight)
        else:
            logits = self.lm_head(head_in)
        return logits.float(), hidden, kv_cache

    @torch.no_grad()
    def generate(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                 *, generator: Optional[torch.Generator] = None,
                 max_new_tokens: int = 128, temperature: float = 0.6,
                 top_p: float = 0.9, top_k: int = 0, do_sample: bool = True,
                 eos_ids: Sequence[int] = (), pad_id: int = 0,
                 repetition_penalty: float = 1.0,
                 spec_tokens: Optional[int] = None,
                 return_decode_state: bool = False,
                 reserve_cache_slots: int = 0,
                 inputs_embeds: Optional[torch.Tensor] = None):
        """Returns (new_tokens [B, T] int64, done [B] bool) and, with
        return_decode_state, a third element {"cache", "kv_valid"} whose
        valid region per row is exactly prompt + emitted tokens (stop
        tokens are never written). input_ids [B, P] are left-padded.
        reserve_cache_slots leaves zero slots after the decode region for
        a later query extension (composite._body_hidden_extend).
        inputs_embeds [B, P, H] replaces the prompt's token embeddings in
        the prefill; the repetition-penalty history then starts empty,
        as in the JAX package (the prompt ids are not read)."""
        if spec_tokens:
            raise NotImplementedError(
                "speculative decoding (spec_tokens > 0) is not ported yet "
                "(ROADMAP.md); None or 0 runs the per-token loop, whose "
                "greedy output equals the speculative one")
        cfg = self.cfg
        dev = input_ids.device
        b, p = input_ids.shape
        total = p + max_new_tokens + reserve_cache_slots
        eos = torch.tensor(list(eos_ids) or [-1], device=dev)
        positions = (attention_mask.cumsum(-1) - 1).clamp_min(0)
        cache = make_kv_cache(cfg, b, total, self.dtype, dev)
        kv_valid = torch.cat([attention_mask > 0,
                              torch.zeros((b, total - p), dtype=torch.bool,
                                          device=dev)], dim=1)
        logits, _, cache = self(input_ids=input_ids,
                                attention_mask=attention_mask,
                                positions=positions, kv_cache=cache,
                                cache_index=0, kv_valid=kv_valid,
                                last_logits_only=True,
                                inputs_embeds=inputs_embeds)

        use_rep = repetition_penalty != 1.0
        rows = torch.arange(b, device=dev)
        seen = None
        if use_rep:
            seen = torch.zeros((b, cfg.vocab_size), dtype=torch.bool,
                               device=dev)
            if inputs_embeds is None:
                r, c = torch.nonzero(attention_mask > 0, as_tuple=True)
                seen[r, input_ids[r, c]] = True

        def pick(step_logits):
            if use_rep:
                step_logits = apply_repetition_penalty(
                    step_logits, seen, repetition_penalty)
            tok = sample_token(generator, step_logits, temperature, top_p,
                               top_k, do_sample)
            if use_rep:
                seen[rows, tok] = True
            return tok

        tok = pick(logits[:, -1])
        done = torch.isin(tok, eos)
        tok = torch.where(done, pad_id, tok)
        pos = positions[:, -1] + 1
        out = torch.full((b, max_new_tokens), pad_id, dtype=torch.long,
                         device=dev)
        for t in range(max_new_tokens):
            if bool(done.all()):
                break   # early exit: finished rows would only emit pad
            out[:, t] = tok
            kv_valid[:, p + t] = ~done
            logits, _, cache = self(input_ids=tok[:, None],
                                    positions=pos[:, None], kv_cache=cache,
                                    cache_index=p + t, kv_valid=kv_valid)
            nxt = pick(logits[:, -1])
            now_done = done | torch.isin(nxt, eos)
            tok = torch.where(now_done, pad_id, nxt)
            done = now_done
            pos = pos + 1
        if return_decode_state:
            return out, done, {"cache": cache, "kv_valid": kv_valid}
        return out, done


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


def sample_token(generator, logits, temperature: float, top_p: float,
                 top_k: int, do_sample: bool) -> torch.Tensor:
    """One token per row: greedy, or a draw from the warped candidates."""
    vals, idxs = warped_candidates(logits, temperature, top_p, top_k,
                                   do_sample)
    if not do_sample or temperature <= 0:
        return idxs[:, 0]
    choice = torch.multinomial(torch.softmax(vals, dim=-1), 1,
                               generator=generator)
    if idxs is None:
        return choice[:, 0]
    return torch.gather(idxs, 1, choice)[:, 0]
