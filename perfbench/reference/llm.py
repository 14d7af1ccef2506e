"""The plain reference of the language model: a llama-family decoder as
Qwen2-7B and Mistral-7B publish it (HF Qwen2ForCausalLM,
MistralForCausalLM: RMSNorm, rotate-half rope, grouped-query attention,
SwiGLU), with a LoRA adapter on every projection, in float32 with TF32
off. One sequence at a time, unpadded, so no mask but the causal one.

    x = embed[ids]
    per layer:  h = rmsnorm(x) * g1
                q, k, v = proj(h) (+ bias) (+ s * (h A^T) B^T)
                q, k = rope(q), rope(k)
                x += o(softmax(q k^T / sqrt(d) + causal) v)
                h = rmsnorm(x) * g2
                x += down(silu(gate(h)) * up(h))
    hidden = rmsnorm(x) * g;  logits = hidden head^T

`quantize="int8"` computes every product of the base weights in int8:
each weight matrix rounded to int8 per output channel and each input
row (token) per row, symmetric at amax / 127, the products summed in
float32; the embedding table rounded alike. That is the precision below
the bfloat16 the configurations state, which the correctness control
runs.
"""

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

def fake_int8(w: torch.Tensor) -> torch.Tensor:
    """w rounded to int8 per row (output channel) and scaled back."""
    scale = w.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 127.0
    return torch.clamp(torch.round(w / scale), -127, 127) * scale


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope_tables(n: int, head_dim: int, theta: float, device):
    """cos, sin [n, head_dim / 2] of positions 0..n-1, angles in float64."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float64,
                                        device=device) / head_dim))
    ang = torch.arange(n, dtype=torch.float64, device=device)[:, None] * inv
    return ang.cos().float(), ang.sin().float()


def rope(x, cos, sin):
    """x [n, heads, d] rotated by half."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[:, None], sin[:, None]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


class Decoder:
    """The decoder over a {state-dict name: float32 tensor} of the port's
    names (perfbench/weights.py). LoRA tensors that require grad carry
    gradients through `hidden`."""

    def __init__(self, cfg: dict, w: Dict[str, torch.Tensor],
                 lora_scale: float, quantize: Optional[str] = None):
        self.cfg = cfg
        self.w = w
        self.scale = lora_scale
        self.eps = cfg["rms_norm_eps"]
        self.heads, self.kv = cfg["num_heads"], cfg["num_kv_heads"]
        self.hd = cfg.get("head_dim") or cfg["hidden_size"] // self.heads
        self.int8 = quantize == "int8"
        if quantize == "int8":
            for name, t in list(w.items()):
                if (name.startswith("llm.") and t.dim() == 2
                        and not name.endswith(("lora_a", "lora_b"))):
                    w[name] = fake_int8(t)
        elif quantize is not None:
            raise ValueError(f"unknown quantize {quantize!r}")

    def _base(self, x, weight):
        if self.int8:
            x = fake_int8(x)
        return x @ weight.t()

    def proj(self, name, x):
        w = self.w
        y = self._base(x, w[f"{name}.weight"])
        if f"{name}.bias" in w:
            y = y + w[f"{name}.bias"]
        if f"{name}.lora_a" in w:
            y = y + ((x @ w[f"{name}.lora_a"].t())
                     @ w[f"{name}.lora_b"].t()) * self.scale
        return y

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        return self.w["llm.embed.weight"][ids]

    def layer(self, i: int, x, cos, sin):
        p = f"llm.layers.{i}"
        n = x.shape[0]
        h = rms_norm(x, self.w[f"{p}.input_norm.weight"], self.eps)
        q = self.proj(f"{p}.attn.q", h).view(n, self.heads, self.hd)
        k = self.proj(f"{p}.attn.k", h).view(n, self.kv, self.hd)
        v = self.proj(f"{p}.attn.v", h).view(n, self.kv, self.hd)
        q, k = rope(q, cos, sin), rope(k, cos, sin)
        g = self.heads // self.kv
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
        logits = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(self.hd)
        causal = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~causal, float("-inf"))
        attn = torch.einsum("hqk,khd->qhd", torch.softmax(logits, -1), v)
        x = x + self.proj(f"{p}.attn.o", attn.reshape(n, -1))
        h = rms_norm(x, self.w[f"{p}.post_norm.weight"], self.eps)
        act = F.silu(self.proj(f"{p}.mlp.gate", h)) * self.proj(
            f"{p}.mlp.up", h)
        return x + self.proj(f"{p}.mlp.down", act)

    def hidden(self, x: torch.Tensor, recompute: bool = False):
        """Final-normed hidden states [n, H] of the embeddings x [n, H];
        recompute: keep only each layer's input for the backward."""
        cos, sin = rope_tables(x.shape[0], self.hd, self.cfg["rope_theta"],
                               x.device)
        for i in range(self.cfg["num_layers"]):
            if recompute:
                x = checkpoint(self.layer, i, x, cos, sin,
                               use_reentrant=False)
            else:
                x = self.layer(i, x, cos, sin)
        return rms_norm(x, self.w["llm.final_norm.weight"], self.eps)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return self._base(hidden, self.w["llm.lm_head.weight"])
